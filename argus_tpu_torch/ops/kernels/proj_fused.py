"""Projection (stage-entry) bottleneck block forward on folded frozen-BN
weights (NHWC), stride S in {1, 2} on the 3x3.

Port of `argus_tpu/ops/pallas/proj_fused.py` (`fused_projection_block`,
no-save forward, and `fold_projection_params`):

    h1  = bf16(relu(x @ w1 + b1))                       1x1, CIN -> F
    h2  = bf16(relu(conv3x3_s(h1) + b2))                stride S, pad 1
    out = bf16(relu(h2 @ w3 + x[::S, ::S] @ wsc + b3 + bsc))

On a CUDA tensor `projection_block` launches `csrc/proj_fused.cu`; on a CPU
tensor it runs the plain version `projection_block_plain`.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    bias_relu,
    check_channels,
    check_cuda,
    check_device,
    conv3x3_f32,
    fold_affine,
    matmul_f32,
)

KERNEL = Kernel("proj_fused", "argus_proj_fwd", [P] * 12 + [I] * 7 + [P])


def fold_projection_params(
    dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2,
    k3, s3, bi3, m3, v3, ksc, ssc, bisc, msc, vsc, *, eps=1e-5,
):
    """Fold the four frozen BN affines into the HWIO conv kernels:
    (w1 (CIN,F), b1, w2 (3,3,F,F), b2, w3 (F,COUT), b3, wsc (CIN,COUT), bsc),
    biases as f32 (1, C) rows."""
    cin, f, cout = k1.shape[-2], k1.shape[-1], k3.shape[-1]
    w1, b1 = fold_affine(k1.reshape(cin, f), s1, bi1, m1, v1, eps, dtype)
    w2, b2 = fold_affine(k2, s2, bi2, m2, v2, eps, dtype)
    w3, b3 = fold_affine(k3.reshape(f, cout), s3, bi3, m3, v3, eps, dtype)
    wsc, bsc = fold_affine(ksc.reshape(cin, cout), ssc, bisc, msc, vsc, eps, dtype)
    return w1, b1, w2, b2, w3, b3, wsc, bsc


def projection_block_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """The block in plain PyTorch, with the kernel's rounding points."""
    dt = x.dtype
    h1 = bias_relu(matmul_f32(x, w1), b1, dt)
    h2 = bias_relu(conv3x3_f32(h1, w2, stride), b2, dt)
    acc = matmul_f32(h2, w3) + matmul_f32(x[:, ::stride, ::stride], wsc) + b3.float().reshape(-1)
    return bias_relu(acc, bsc, dt)


def projection_block(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """Projection bottleneck forward: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not check_device(x):
        return projection_block_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
    n, h, w, cin = x.shape
    f, cout = w1.shape[1], w3.shape[1]
    if h % stride or w % stride:
        raise ValueError(f"spatial size {(h, w)} must be divisible by the stride {stride}")
    check_channels(CIN=cin, F=f, COUT=cout)
    bf = torch.bfloat16
    check_cuda("x", x, bf)
    for name, t, shape in (
        ("w1", w1, (cin, f)), ("w2", w2, (3, 3, f, f)), ("w3", w3, (f, cout)), ("wsc", wsc, (cin, cout)),
    ):
        check_cuda(name, t, bf, shape)
    for name, t, c in (("b1", b1, f), ("b2", b2, f), ("b3", b3, cout), ("bsc", bsc, cout)):
        check_cuda(name, t, torch.float32, (1, c))
    ho, wo = h // stride, w // stride
    h1 = torch.empty((n, h, w, f), dtype=bf, device=x.device)
    h2 = torch.empty((n, ho, wo, f), dtype=bf, device=x.device)
    out = torch.empty((n, ho, wo, cout), dtype=bf, device=x.device)
    KERNEL.launch(x, h1, h2, out, w1, b1, w2, b2, w3, b3, wsc, bsc, n, h, w, cin, f, cout, stride)
    return out


def fused_projection_block(
    x, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3,
    ksc, ssc, bisc, msc, vsc, *, stride: int = 2, eps: float = 1e-5,
):
    """argus_tpu's `fused_projection_block` signature: HWIO kernels and raw
    frozen-BN buffers, folded here in f32, then the block forward."""
    folded = fold_projection_params(
        x.dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2,
        k3, s3, bi3, m3, v3, ksc, ssc, bisc, msc, vsc, eps=eps,
    )
    return projection_block(x, *folded, stride)
