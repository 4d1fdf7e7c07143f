"""Identity bottleneck block forward on folded frozen-BN weights (NHWC).

Port of `argus_tpu/ops/pallas/block_fused.py` (`fused_bottleneck_block`,
no-save forward, and `fold_bottleneck_params`):

    h1  = bf16(relu(x @ w1 + b1))            1x1, CIN -> F
    h2  = bf16(relu(conv3x3(h1) + b2))       pad 1
    out = bf16(relu(h2 @ w3 + b3 + x))       identity residual

with every sum in f32 and one rounding to the activation dtype after each
bias + relu, as the TPU kernel rounds. On a CUDA tensor `bottleneck_block`
launches `csrc/block_fused.cu`; on a CPU tensor it runs the plain PyTorch
version `bottleneck_block_plain`, which the CPU tests hold against argus_tpu
and `chip_smoke.py` holds the kernel against on the card.

Also home of the helpers the other block kernels share: the plain conv
pieces and the wrapper argument checks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels._build import I, P, Kernel

KERNEL = Kernel("block_fused", "argus_block_fwd", [P] * 10 + [I] * 5 + [P])


# ───────────────────────────── plain pieces ─────────────────────────────


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., C) @ (C, F) in f32 on the dtype-valued operands."""
    return x.float() @ w.float()


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC 3x3/pad-1 conv with an HWIO kernel, in f32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def bias_relu(acc: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    return torch.relu(acc + b.float().reshape(-1)).to(dtype)


def fold_affine(k: torch.Tensor, s, b, m, v, eps: float, dtype):
    """Frozen BN after a conv folded into it: (k * c) in `dtype`, b - m*c in f32
    as a (1, COUT) row, with c = s * rsqrt(v + eps) (argus_tpu's f32 fold)."""
    c = s.float() * torch.rsqrt(v.float() + eps)
    w = (k.float() * c).to(dtype).contiguous()
    return w, (b.float() - m.float() * c).reshape(1, -1).contiguous()


# ───────────────────────────── wrapper checks ─────────────────────────────


def check_cuda(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_channels(**dims: int) -> None:
    """The conv-GEMM kernel moves 8 channels per 16-byte vector."""
    for name, d in dims.items():
        if d % 8 != 0:
            raise ValueError(f"{name}={d} must be a multiple of 8 for the CUDA kernel")


def check_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for anything else."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


# ───────────────────────────── the block ─────────────────────────────


def fold_bottleneck_params(
    dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3, *, eps=1e-5
):
    """Fold the three frozen BN affines into the HWIO conv kernels:
    (w1 (CIN,F), b1 (1,F), w2 (3,3,F,F), b2 (1,F), w3 (F,CIN), b3 (1,CIN)),
    the operand layout of argus_tpu's fused block and stage kernels."""
    cin, f = k1.shape[-2], k1.shape[-1]
    w1, b1 = fold_affine(k1.reshape(cin, f), s1, bi1, m1, v1, eps, dtype)
    w2, b2 = fold_affine(k2, s2, bi2, m2, v2, eps, dtype)
    w3, b3 = fold_affine(k3.reshape(f, k3.shape[-1]), s3, bi3, m3, v3, eps, dtype)
    return w1, b1, w2, b2, w3, b3


def bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3):
    """The block in plain PyTorch, with the kernel's rounding points."""
    dt = x.dtype
    h1 = bias_relu(matmul_f32(x, w1), b1, dt)
    h2 = bias_relu(conv3x3_f32(h1, w2, 1), b2, dt)
    return torch.relu(matmul_f32(h2, w3) + b3.float().reshape(-1) + x.float()).to(dt)


def bottleneck_block(x, w1, b1, w2, b2, w3, b3):
    """Identity bottleneck forward: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not check_device(x):
        return bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)
    n, h, w, cin = x.shape
    f = w1.shape[1]
    check_channels(CIN=cin, F=f)
    bf = torch.bfloat16
    check_cuda("x", x, bf)
    for name, t, shape in (("w1", w1, (cin, f)), ("w2", w2, (3, 3, f, f)), ("w3", w3, (f, cin))):
        check_cuda(name, t, bf, shape)
    for name, t, c in (("b1", b1, f), ("b2", b2, f), ("b3", b3, cin)):
        check_cuda(name, t, torch.float32, (1, c))
    h1 = torch.empty((n, h, w, f), dtype=bf, device=x.device)
    h2 = torch.empty_like(h1)
    out = torch.empty_like(x)
    KERNEL.launch(x, h1, h2, out, w1, b1, w2, b2, w3, b3, n, h, w, cin, f)
    return out


def fused_bottleneck_block(
    x, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3, *, eps: float = 1e-5
):
    """argus_tpu's `fused_bottleneck_block` signature: HWIO kernels and raw
    frozen-BN buffers, folded here in f32, then the block forward."""
    folded = fold_bottleneck_params(
        x.dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3, eps=eps
    )
    return bottleneck_block(x, *folded)
