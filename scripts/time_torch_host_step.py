#!/usr/bin/env python3
"""Time one tree's `frozen_stages=3` fine-tune step on the card as the host
sees it: per step the host's enqueue time (the `step` call, no sync) and
the step's time by CUDA events, over `--steps` steps after 3 warm-up steps,
fuse flags "on", batch 256 rows of 256x256 (`chip_smoke.flagship_train_setup`).
The step's enqueue takes about as long as its device time, so host-side
costs show in it first.

    python3 scripts/time_torch_host_step.py [--root DIR] [--steps N] [--export-first]

`--root` is a checkout of the repository (default: this one): its
`argus_tpu_torch` and `chip_smoke.py` are the ones timed. `--export-first`
exports a batch-1 ResNet-50 estimator through `torch.export` in the same
process before the steps (a tree that has `Estimator.export`), to see
whether an export leaves the eager path slower. Prints one JSON line: the
fastest and median enqueue and event times, the card's name and power
limit. Alternate trees in one call (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--export-first", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["WANDB_MODE"] = "disabled"

    import time

    import torch

    import chip_smoke
    from argus_tpu_torch.ops.kernels import _build
    from argus_tpu_torch.train import make_train_step

    if not torch.cuda.is_available():
        print("time_torch_host_step: no CUDA device", file=sys.stderr)
        return 2
    _build.build(("stem_fused", "stage_fused", "proj_fused", "block_fused", "proj_fused_bwd", "block_fused_bwd",
                  "augment_fused"))
    if args.export_first:
        from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
        from argus_tpu_torch.serve import Estimator

        est = Estimator.from_model(NCameraCNN(NCameraCNNConfig()), hw=(chip_smoke.HW, chip_smoke.HW))
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
            est.export(os.path.join(tmpdir, "b1.pt2"))
        del est
        torch.cuda.empty_cache()
    cfg, model, state, batch = chip_smoke.flagship_train_setup(frozen_stages=3)
    step = make_train_step(model, cfg)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(args.steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        host.append((time.perf_counter() - t0) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
    host.sort()
    dev.sort()
    print(json.dumps({"root": root, "export_first": args.export_first, "gpu": chip_smoke.gpu_line(),
                      "enqueue_ms": {"min": host[0], "p50": host[len(host) // 2]},
                      "step_ms": {"min": dev[0], "p50": dev[len(dev) // 2]}, "steps": args.steps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
