"""Single-frame inference latency of the PyTorch port (the twin of
`scripts/timing.py`, on `argus_tpu_torch`).

Measures the images -> se(3) forward of a freshly initialised NCameraCNN at
(B, 256, 256, 6) over N trials and reports mean/p50/p95 from
`profiling.profile_fn` (each call's result synchronised). On the card the
forward is captured once as a CUDA graph and replayed (`capture.
CapturedCall`, the port's counterpart of a jitted program); the capture is
timed apart. Each trial uploads a fresh host batch, as the original's does.

    python scripts/timing_torch.py --batch-size 1
"""

import os
import sys
import time
from dataclasses import dataclass

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class TimingConfig:
    n_trials: int = 100
    batch_size: int = 2  # the reference's protocol uses batch 2
    n_cams: int = 2
    height: int = 256
    width: int = 256
    backbone: str = "resnet50"
    dtype: str = "bfloat16"
    device: str = "cuda"


def main(cfg: TimingConfig) -> dict:
    import torch

    from argus_tpu_torch import profiling, resolve_device
    from argus_tpu_torch.capture import WARMUP_STEPS, CapturedCall
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.models.pose_cnn import init_model
    from argus_tpu_torch.utils import _synchronize

    device = resolve_device(cfg.device)
    model_cfg = NCameraCNNConfig(n_cams=cfg.n_cams, resnet_output_dim=1024, backbone=cfg.backbone, dtype=cfg.dtype)
    model = init_model(model_cfg, 0, cfg.height, cfg.width, device=device).eval()

    def forward(x):
        return model(x, train=False).float().sum()

    fwd = CapturedCall(forward, device) if device.type == "cuda" else forward
    shape = (cfg.batch_size, cfg.height, cfg.width, 3 * cfg.n_cams)
    rng = np.random.default_rng(0)
    host = [rng.random(shape, np.float32) for _ in range(4)]
    calls = [0]

    def trial():
        x = torch.from_numpy(host[calls[0] % len(host)]).to(device)
        calls[0] += 1
        return fwd(x)

    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(WARMUP_STEPS + 1 if device.type == "cuda" else 1):
            _synchronize(trial())
        print(f"First calls (eager warm-up and the capture) took {time.perf_counter() - t0:.2f} seconds.")
        stats = profiling.profile_fn(trial, n_trials=cfg.n_trials, warmup=0)
    print(
        f"Forward pass over {cfg.n_trials} trials (batch {cfg.batch_size}, {device}): "
        f"mean {stats['mean_ms']:.3f} ms | p50 {stats['p50_ms']:.3f} ms | p95 {stats['p95_ms']:.3f} ms"
    )
    return stats


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    main(cli(TimingConfig))
