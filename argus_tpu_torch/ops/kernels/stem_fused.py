"""ResNet stem forward: conv7x7/s2/pad3 + folded frozen BN + relu +
maxpool3x3/s2/pad1, NHWC.

Port of `argus_tpu/ops/pallas/stem_fused.py` (`fused_stem_pool`, no-save
forward). The conv sums in f32, the folded bias is added in f32, relu, one
rounding to the activation dtype, then the max pool; zero padding of the
pool equals torch's -inf padding because relu output is >= 0.

On a CUDA tensor `stem_pool` launches `csrc/stem_fused.cu` (conv, bias,
relu and pool in one launch); on a CPU tensor it runs the plain version
`stem_pool_plain`. The training step runs it frozen (forward only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels._build import I, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    check_cuda,
    check_device,
    fold_affine,
    needs_grad,
)

KERNEL = Kernel("stem_fused", "argus_stem_fwd", [P] * 4 + [I] * 3 + [P])


def fold_stem_params(k7, scale, bias, mean, var, eps: float, dtype):
    """(7,7,3,64) HWIO kernel + frozen BN buffers -> (w (7,7,3,64) in dtype,
    b (1,64) f32)."""
    return fold_affine(k7, scale, bias, mean, var, eps, dtype)


def stem_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stem in plain PyTorch, with the kernel's rounding point."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=2, padding=3)
    y = torch.relu(y + b.float().reshape(1, -1, 1, 1)).to(x.dtype)
    y = F.max_pool2d(y.float(), 3, stride=2, padding=1).to(x.dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def stem_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) image -> (N, H/4, W/4, 64): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. The kernel has no backward
    yet: on the card it raises where autograd would need one."""
    if not check_device(x):
        return stem_pool_plain(x, w, b)
    if needs_grad(x, w, b):
        raise NotImplementedError(
            "the fused stem's backward kernel is not ported yet (ROADMAP B6): "
            "freeze the stem (stem_frozen) or run it without gradients"
        )
    n, h, wd, c = x.shape
    if c != 3 or h % 4 or wd % 4:
        raise ValueError(f"stem kernel takes (N, H, W, 3) with H, W % 4 == 0, got {tuple(x.shape)}")
    check_cuda("x", x, torch.bfloat16)
    check_cuda("w", w, torch.bfloat16, (7, 7, 3, 64))
    check_cuda("b", b, torch.float32, (1, 64))
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.bfloat16, device=x.device)
    KERNEL.launch(x, w, b, out, n, h, wd)
    return out


def fused_stem_pool(x, k7, scale, bias, mean, var, *, eps: float = 1e-5):
    """argus_tpu's `fused_stem_pool` signature: the (7,7,3,64) conv_init
    kernel and raw norm_init buffers, folded here in f32, then the stem."""
    w, b = fold_stem_params(k7, scale, bias, mean, var, eps, x.dtype)
    return stem_pool(x, w, b)
