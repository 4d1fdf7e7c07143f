"""Identity BasicBlock (ResNet-18/34) on folded frozen-BN weights (NHWC):
forward, saving forward and one-pass backward.

Port of `argus_tpu/ops/pallas/basic_fused.py` (`fused_basic_block` through
`_basic_block`, and `fold_basic_params`):

    h1  = bf16(relu(conv3x3(x) + b1))                  pad 1, C -> C
    out = bf16(relu(f32(conv3x3(h1)) + b2 + f32(x)))   identity residual

with every sum in f32, as the TPU kernel rounds. The backward from the saved
h1:

    m2 = g * (out > 0)                                 in g's dtype
    m1 = bf16(conv3x3^T(m2)) * (h1 > 0)                dw2[ky, kx] = shift(h1)^T m2
    dx = bf16(f32(conv3x3^T(m1)) + f32(m2))            dw1[ky, kx] = shift(x)^T m1

(dw in f32; the bias cotangents are zero, the BN being frozen).

As for the bottleneck kernels (`block_fused`): the plain PyTorch versions
(`basic_fwd_plain`, `basic_bwd_plain`) are what the CPU tests hold against
argus_tpu and `chip_smoke.py` holds the kernels against on the card; the
wrappers launch `csrc/basic_fused.cu` / `csrc/basic_fused_bwd.cu` on a CUDA
tensor and run the plain version on a CPU tensor; `basic_saved` ties the
saving forward to the backward for autograd. The forward's two convs run on
the Hopper TMA engine (`csrc/conv_fwd_sm90.cuh`: A as one TMA box per tap
and 64 channels), which needs C % 64 == 0, as every BasicBlock of
ResNet-18/34 has.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    bias_relu,
    check_channels,
    check_cuda,
    check_device,
    conv3x3_f32,
    conv3x3_grads_f32,
    dgrad_w2,
    fold_affine,
    needs_grad,
    relu_mask,
    zero_grad_of,
)
from argus_tpu_torch.ops.kernels import wgrad_plan

KERNEL = Kernel("basic_fused", "argus_basic_fwd", [P] * 7 + [I] * 4 + [P])
# the training forward is the same launcher with h1 kept; its own handle
# counts its launches apart
KERNEL_SAVE = Kernel("basic_fused", "argus_basic_fwd", [P] * 7 + [I] * 4 + [P])
KERNEL_BWD = Kernel("basic_fused_bwd", "argus_basic_bwd", [P] * 12 + [L] + [I] * 4 + [P])


def fold_basic_params(dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, *, eps=1e-5):
    """Fold the two frozen BN affines into the HWIO conv kernels:
    (w1 (3,3,C,C), b1 (1,C), w2 (3,3,C,C), b2 (1,C)), the operand layout of
    argus_tpu's BasicBlock kernels."""
    w1, b1 = fold_affine(k1, s1, bi1, m1, v1, eps, dtype)
    w2, b2 = fold_affine(k2, s2, bi2, m2, v2, eps, dtype)
    return w1, b1, w2, b2


# ───────────────────────────── plain versions ─────────────────────────────


def basic_fwd_plain(x, w1, b1, w2, b2, save: bool):
    """The block in plain PyTorch, with the kernel's rounding points: out,
    or (out, h1) with `save`."""
    dt = x.dtype
    h1 = bias_relu(conv3x3_f32(x, w1, 1), b1, dt)
    out = torch.relu(conv3x3_f32(h1, w2, 1) + b2.float().reshape(-1) + x.float()).to(dt)
    return (out, h1) if save else out


def basic_bwd_plain(x, g, out, h1, w1, w2, need_dx=True):
    """The one-pass backward in plain PyTorch, with the TPU kernel's rounding
    points: (dx in x's dtype or None, dw1, dw2 in f32)."""
    dt = x.dtype
    m2 = relu_mask(g, out)
    dh1, dw2 = conv3x3_grads_f32(h1, m2, w2, 1)
    m1 = relu_mask(dh1.to(dt), h1)
    dx1, dw1 = conv3x3_grads_f32(x, m1, w1, 1)
    dx = (dx1 + m2.float()).to(dt) if need_dx else None
    return dx, dw1, dw2


# ───────────────────────────── wrappers ─────────────────────────────


def _check(x, w1, w2, biases=None):
    n, h, w, c = x.shape
    check_channels(C=c)
    bf = torch.bfloat16
    check_cuda("x", x, bf)
    for name, t in (("w1", w1), ("w2", w2)):
        check_cuda(name, t, bf, (3, 3, c, c))
    for name, t in zip(("b1", "b2"), biases or ()):
        check_cuda(name, t, torch.float32, (1, c))
    return n, h, w, c


def _forward(kernel, x, w1, b1, w2, b2):
    n, h, w, c = _check(x, w1, w2, (b1, b2))
    if c % 64 != 0:
        raise ValueError(f"C={c} must be a multiple of 64 for the forward kernel (whole 64-channel TMA boxes)")
    h1 = torch.empty_like(x)
    out = torch.empty_like(x)
    kernel.launch(x, h1, out, w1, b1, w2, b2, n, h, w, c)
    return out, h1


def basic_block(x, w1, b1, w2, b2):
    """Identity BasicBlock forward: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not check_device(x):
        return basic_fwd_plain(x, w1, b1, w2, b2, save=False)
    return _forward(KERNEL, x, w1, b1, w2, b2)[0]


def basic_block_save(x, w1, b1, w2, b2):
    """The training forward, (out, h1): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not check_device(x):
        return basic_fwd_plain(x, w1, b1, w2, b2, save=True)
    return _forward(KERNEL_SAVE, x, w1, b1, w2, b2)


def basic_bwd(x, g, out, h1, w1, w2, need_dx=True):
    """The one-pass backward from the saved h1: (dx or None, dw1, dw2 in
    f32). The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if not check_device(x):
        return basic_bwd_plain(x, g, out, h1, w1, w2, need_dx)
    n, h, w, c = _check(x, w1, w2)
    for name, t in (("g", g), ("out", out), ("h1", h1)):
        check_cuda(name, t, torch.bfloat16, (n, h, w, c))
    dev = x.device
    m1, m2 = torch.empty_like(h1), torch.empty_like(h1)
    dx = torch.empty_like(x) if need_dx else None
    dw1 = torch.empty((3, 3, c, c), dtype=torch.float32, device=dev)
    dw2 = torch.empty_like(dw1)
    ws_elems = wgrad_plan.workspace((n * h * w, c, c, 3))
    ws = torch.empty(max(ws_elems, 1), dtype=torch.float32, device=dev)
    KERNEL_BWD.launch(x, g, out, h1, dgrad_w2(w1, 1), dgrad_w2(w2, 1), dx, m1, m2, dw1, dw2,
                      ws, ws_elems, n, h, w, c)
    return dx, dw1, dw2


class _BasicSaved(torch.autograd.Function):
    """argus_tpu's `_basic_block` custom VJP: the saving forward, then the
    one-pass backward; the bias cotangents are zero (frozen BN) and each dw
    is cast to its weight's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        out, h1 = basic_block_save(x, w1, b1, w2, b2)
        ctx.save_for_backward(x, out, h1, w1, w2)
        ctx.biases = (b1, b2)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, h1, w1, w2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw1, dw2 = basic_bwd(x, g.contiguous(), out, h1, w1, w2, need[0])
        db1, db2 = (zero_grad_of(need[i], b) for i, b in zip((2, 4), ctx.biases))
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def basic_saved(x, w1, b1, w2, b2):
    """The identity BasicBlock as autograd sees it: the no-save forward when
    no input needs a gradient, else the saving forward with the kernel
    backward."""
    if needs_grad(x, w1, b1, w2, b2):
        return _BasicSaved.apply(x, w1, b1, w2, b2)
    return basic_block(x, w1, b1, w2, b2)


def fused_basic_block(x, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, *, eps: float = 1e-5):
    """argus_tpu's `fused_basic_block` signature: HWIO kernels and raw
    frozen-BN buffers, folded here in f32 (gradients flow to x and both
    kernels; the BN buffers get none), then the block."""
    return basic_saved(x, *fold_basic_params(x.dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, eps=eps))
