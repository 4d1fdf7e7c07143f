#!/usr/bin/env python3
"""Time one tree's serving estimator on the card: `Estimator.predict` at
batch 256 (the fuse flags as the tuned config sets them, "auto") and at
batch 1 (f32), host clock, uint8 numpy in and poses numpy out, on a
full-width ResNet-50 NCameraCNN with the random weights of `chip_smoke.py`
(its `_randomize_`, seed 0) at 256x256.

    python3 scripts/time_torch_serving.py [--root DIR] [--calls N]

`--root` is a checkout of the repository (default: this one): its
`argus_tpu_torch` and `chip_smoke.py` are the ones timed, its kernels built
under its own `argus_tpu_torch/_build/`. To compare two trees, alternate
them in one call (parent, change, change, parent): each run prints one JSON
line with the p50, p90 and fastest ms of each batch size, the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=200, help="timed predicts at batch 1 (batch 256 takes a tenth)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import argus_tpu_torch
    import chip_smoke
    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.ops.kernels import _build
    from argus_tpu_torch.serve import Estimator

    if not torch.cuda.is_available():
        print("time_torch_serving: no CUDA device", file=sys.stderr)
        return 2
    gpu = chip_smoke.gpu_line()
    _build.build(("stem_fused", "stage_fused", "proj_fused", "block_fused"))
    cfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50")
    model = NCameraCNN(cfg)
    chip_smoke._randomize_(model, seed=0)
    params, stats = variables_from_state_dict(model.state_dict())
    del model
    hw = chip_smoke.HW
    result = {"root": root, "package": os.path.dirname(argus_tpu_torch.__file__), "gpu": gpu}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        ckpt = os.path.join(tmpdir, "resnet50_random.ckpt")
        save_checkpoint(ckpt, {"params": params, "batch_stats": stats},
                        meta={"model_type": "pose_cnn", "model_config": dataclasses.asdict(cfg), "center_crop": [hw, hw]})
        for batch, n in ((chip_smoke.N_ROWS, max(args.calls // 10, 5)), (1, args.calls)):
            est = Estimator(ckpt, batch_size=batch)
            frames = [np.random.default_rng(s).integers(0, 256, (batch, hw, hw, 6), dtype=np.uint8) for s in range(4)]
            for f in frames:  # past any capture
                est.predict(f)
            ts = []
            for i in range(n):
                t0 = time.perf_counter()
                est.predict(frames[i % 4])
                ts.append((time.perf_counter() - t0) * 1e3)
            ts.sort()
            result[f"batch{batch}"] = {"p50": ts[len(ts) // 2], "p90": ts[int(len(ts) * 0.9)], "min": ts[0],
                                       "calls": n}
            del est
            torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
