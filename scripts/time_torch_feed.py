#!/usr/bin/env python3
"""Where the training loop's host time goes on the card: the loader, the
device feed, the train step's host dispatch, and a checkpoint write in
flight.

    python3 scripts/time_torch_feed.py

Needs one CUDA card. The workload is `chip_smoke.py`'s loop phase: the
`frozen_stages=3` fine-tune (ResNet-50 NCameraCNN at full width, bf16,
frozen BN and affine, augmentation on, fuse "auto") at batch 256 over 1024
rendered 256x256 frame pairs held in memory. Prints, by host clock unless
named: `HostDataLoader` alone (ms per batch), one batch's gather, its copy
into a fresh pinned tensor (first and second time) and into a pinned
buffer that exists, the loader with the device feed, the step's host
dispatch and its time on a resident batch (CUDA events), an epoch of steps
through the feed (ms per step, three times), the same with an
`AsyncCheckpointer.save` of the whole train state in flight, and a save
with its wait alone. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_torch_feed: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.environ["WANDB_MODE"] = "disabled"
    import chip_smoke as cs
    from argus_tpu_torch.checkpoint import AsyncCheckpointer
    from argus_tpu_torch.data.dataset import HostDataLoader
    from argus_tpu_torch.data.feed import device_prefetch
    from argus_tpu_torch.data.synthetic import render_dataset_arrays
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    cs.GPU = cs.gpu_line()
    n_rows = cs.N_ROWS
    images, poses = render_dataset_arrays(cs.LOOP_TRAIN, cs.HW, cs.HW, seed=10)
    ds = cs.FramesDataset(images, poses)

    def loader():
        it = HostDataLoader(ds, batch_size=n_rows, shuffle=True, seed=0, num_workers=8)
        it.set_epoch(1)
        return it

    def per_batch(fn):
        t0 = time.perf_counter()
        n = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    for _ in range(2):
        cs.say(f"feed: HostDataLoader alone {per_batch(lambda: sum(1 for _ in loader())):.2f} ms per batch")
    idx = list(np.random.default_rng(0).permutation(len(ds))[:n_rows])
    t0 = time.perf_counter()
    batch = ds.load_images_batch(idx)
    cs.say(f"feed: one batch's gather ({batch.nbytes / 1e6:.0f} MB) {(time.perf_counter() - t0) * 1e3:.2f} ms")
    for label in ("first", "second"):
        t0 = time.perf_counter()
        torch.from_numpy(batch).pin_memory()
        cs.say(f"feed: copy into a fresh pinned tensor ({label} time) {(time.perf_counter() - t0) * 1e3:.2f} ms")
    pinned = torch.empty(batch.shape, dtype=torch.uint8, pin_memory=True)
    t0 = time.perf_counter()
    pinned.copy_(torch.from_numpy(batch))
    cs.say(f"feed: copy into a pinned buffer that exists {(time.perf_counter() - t0) * 1e3:.2f} ms")
    for _ in range(2):
        ms = per_batch(lambda: sum(1 for _ in device_prefetch(loader(), "cuda")))
        cs.say(f"feed: HostDataLoader with device_prefetch {ms:.2f} ms per batch")

    mcfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50", bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True, frozen_stages=3)
    cfg = TrainConfig(model_config=mcfg, amp=True, batch_size=n_rows, device_resident_mb=0, wandb_log=False)
    model, state = create_train_state(cfg, seed=0)
    step = make_train_step(model, cfg)
    resident = {"images": torch.from_numpy(images[:n_rows]).cuda(),
                "cube_pose": torch.from_numpy(ds.cube_poses[:n_rows]).cuda(),
                "mask": torch.ones(n_rows, device="cuda")}
    for _ in range(3):
        state, _ = step(state, resident)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, _ = step(state, resident)
        host.append((time.perf_counter() - t0) * 1e3)
    device_ms, _, state = cs._median_step_ms(step, state, resident)
    cs.say(f"feed: the step's host dispatch {[round(h, 2) for h in host]} ms; on the device {device_ms:.2f} ms "
           f"(CUDA events, resident batch)")

    def epoch():
        nonlocal state
        n = 0
        for b in device_prefetch(loader(), "cuda"):
            state, _ = step(state, b)
            n += 1
        return n

    for _ in range(3):
        cs.say(f"feed: an epoch of steps through the loader and the feed {per_batch(epoch):.2f} ms per step")
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer()

        def saving_epoch():
            ck.save(os.path.join(d, "a.ckpt"), state)
            return epoch()

        cs.say(f"feed: the same with a checkpoint write in flight {per_batch(saving_epoch):.2f} ms per step")
        ck.wait()
        t0 = time.perf_counter()
        ck.save(os.path.join(d, "b.ckpt"), state)
        ck.wait()
        cs.say(f"feed: AsyncCheckpointer.save and wait alone {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
