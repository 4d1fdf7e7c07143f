#!/usr/bin/env python3
"""Host and device time of the port's augmentation at the flagship train
step's shape (batch 256 rows of two 256x256 bf16 camera frames), on one
NVIDIA GPU.

    python3 scripts/time_torch_augmentation.py [--calls 20]

For each parameter sampler, `sample_params` as a whole and
`apply_augmentation` (sampling, the layout copies and the fused kernel):
the host time to enqueue one call, the host time until the device has
finished, and the device time between CUDA events, each averaged over
`--calls` back-to-back calls after a warm-up. Sampling is ~100 small ops, so
its cost is host time: a train step that samples at its start leaves the
device idle for it (`train.make_train_step` samples the next step's
parameters while the device runs the current one). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_torch_augmentation: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke
    from argus_tpu_torch.ops import augment as TA

    chip_smoke.GPU = chip_smoke.gpu_line()
    rows, hw = chip_smoke.N_ROWS, chip_smoke.HW
    n = 2 * rows
    x = torch.rand(rows, hw, hw, 6, device="cuda").to(torch.bfloat16)
    cfg = TA.AugmentationConfig()
    g = lambda k: TA.generator(k, "cuda")  # noqa: E731
    cases = [
        ("arcs", lambda k: TA._arc_params(g(k), n, cfg.num_spaghetti, hw, hw)),
        ("planckian gains", lambda k: TA._planckian_gains(g(k), n, 0.5, torch.bfloat16)),
        ("jiggle", lambda k: TA._jiggle_params(g(k), TA.generator(k, "cpu"), rows, 2, cfg)),
        ("gaussian taps", lambda k: TA._gaussian_taps(g(k), n)),
        ("motion kernels", lambda k: TA._motion_kernel(g(k), n)),
        ("plasma", lambda k: TA._plasma_params(g(k), n, (hw, hw))),
        ("sample_params", lambda k: TA.sample_params(cfg, k, rows, 2, hw, hw, "cuda", torch.bfloat16)),
        ("apply_augmentation", lambda k: TA.apply_augmentation(cfg, k, x)),
    ]
    for _, fn in cases:  # warm-up: builds the kernel, uploads the tables
        fn(0)
    torch.cuda.synchronize()
    for label, fn in cases:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        for k in range(args.calls):
            fn(k)
        t1 = time.perf_counter()
        e1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per = 1e3 / args.calls
        chip_smoke.say(f"{label}: host enqueue {(t1 - t0) * per:.3f} ms/call, until finished {(t2 - t0) * per:.3f} "
                       f"ms/call, device (events) {e0.elapsed_time(e1) / args.calls:.3f} ms/call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
