"""Eval-mode (frozen) BatchNorm over the last axis of NHWC activations.

Port of the running-statistics branch of `argus_tpu/ops/norm.py` BatchNorm:
the variable layout matches flax's (scale/bias params, mean/var statistics)
under torch's names (weight/bias, running_mean/running_var), and the affine
is computed in the compute dtype exactly as the reference does,
``((x - mean) * rsqrt(var + eps)) * scale + bias`` with each factor cast to
that dtype. With `frozen_affine` (argus_tpu's `bn_frozen_affine`, torch's
FrozenBatchNorm2d) scale and bias are frozen too: they take no gradient, as
argus_tpu stop-gradients them (`models/resnet.py:218-224`). Exact train-mode
BatchNorm (batch statistics) is not ported yet: ROADMAP A3.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Frozen BatchNorm over the channel (last) axis."""

    def __init__(self, features: int, eps: float = 1e-5, frozen_affine: bool = False) -> None:
        super().__init__()
        self.eps = eps
        self.frozen_affine = frozen_affine
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        scale, bias = self.weight, self.bias
        if self.frozen_affine:
            scale, bias = scale.detach(), bias.detach()
        rstd = torch.rsqrt(self.running_var + self.eps)
        return ((x - self.running_mean.to(dt)) * rstd.to(dt)) * scale.to(dt) + bias.to(dt)
