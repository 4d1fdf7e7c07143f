"""End-to-end training throughput of the PyTorch port: host input pipeline +
train step (the twin of `scripts/throughput.py`, on `argus_tpu_torch`).

Measures the real loop over a synthetic on-disk dataset: PNG decode (the
native loader where it builds), batching, the device feed
(`data.feed.device_prefetch`: pinned buffers, uploads on a side stream) and
the augmented train step, and reports the end-to-end rate beside the
loader-only rate, so the bottleneck shows.

    python scripts/throughput_torch.py --batch-size 64 --n-steps 20
"""

import itertools
import os
import sys
import tempfile
import time
from dataclasses import dataclass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class ThroughputConfig:
    batch_size: int = 64
    n_steps: int = 20
    n_examples: int = 256
    height: int = 256
    width: int = 256
    num_workers: int = 8
    backbone: str = "resnet50"
    dataset_path: str = ""  # empty -> synthesize a temporary dataset
    device: str = "cuda"


def main(cfg: ThroughputConfig) -> dict:
    import torch

    from argus_tpu_torch import native, resolve_device
    from argus_tpu_torch.data import CameraCubePoseDataset, CameraCubePoseDatasetConfig, HostDataLoader, \
        device_prefetch, write_synthetic_dataset
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops.augment import AugmentationConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    device = resolve_device(cfg.device)
    dataset_path = cfg.dataset_path
    if not dataset_path:
        dataset_path = tempfile.mkdtemp(prefix="argus_tpu_torch_thr_")
        print(f"synthesizing {cfg.n_examples} examples at {dataset_path} ...")
        write_synthetic_dataset(dataset_path, n_train=cfg.n_examples, n_test=4, height=cfg.height, width=cfg.width)

    ds = CameraCubePoseDataset(CameraCubePoseDatasetConfig(dataset_path, center_crop=(cfg.height, cfg.width)),
                               train=True)

    def loader():
        return HostDataLoader(ds, batch_size=cfg.batch_size, num_workers=cfg.num_workers, prefetch=4)

    print(f"native loader active: {native.available()}")

    # ── loader-only rate ──
    it = iter(loader())
    next(it)  # warm
    t0 = time.perf_counter()
    n_loader = 0
    for b in it:
        n_loader += int(b["mask"].sum())
    loader_rate = n_loader / (time.perf_counter() - t0)
    print(f"host loader: {loader_rate:.1f} examples/s ({2 * loader_rate:.1f} cam-imgs/s)")

    # ── end-to-end train loop ──
    tcfg = TrainConfig(
        model_config=NCameraCNNConfig(n_cams=2, backbone=cfg.backbone, resnet_output_dim=1024),
        augmentation_config=AugmentationConfig(), use_augmentation=True, amp=True, max_grad_norm=1.0,
        learning_rate=1e-4, batch_size=cfg.batch_size,
    )
    model, state = create_train_state(tcfg, seed=0, sample_hw=(cfg.height, cfg.width), device=device)
    step = make_train_step(model, tcfg, base_seed=0, device=device)

    warm = next(device_prefetch(iter(loader()), device))
    state, loss = step(state, warm)
    loss.item()
    batches = device_prefetch(itertools.chain.from_iterable(loader() for _ in itertools.count()), device)
    t0 = time.perf_counter()
    n_done = 0
    for batch in itertools.islice(batches, cfg.n_steps):
        state, loss = step(state, batch)
        n_done += cfg.batch_size
    loss.item()
    e2e_rate = n_done / (time.perf_counter() - t0)
    print(f"end-to-end ({device}): {e2e_rate:.1f} examples/s ({2 * e2e_rate:.1f} cam-imgs/s)")
    if device.type == "cuda":
        mb = cfg.batch_size * cfg.height * cfg.width * 6 / 1e6
        print(f"note: host->device moves {mb:.1f} MB/batch (uint8), through pinned buffers on a side stream "
              f"({torch.cuda.get_device_name(device)})")
    return {"loader_examples_per_sec": loader_rate, "e2e_examples_per_sec": e2e_rate}


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    main(cli(ThroughputConfig))
