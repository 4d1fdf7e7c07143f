"""Projection (stage-entry) bottleneck block on folded frozen-BN weights
(NHWC), stride S in {1, 2} on the 3x3: forward, saving forward and one-pass
backward.

Port of `argus_tpu/ops/pallas/proj_fused.py` (`fused_projection_block`
through `_proj_block`, and `fold_projection_params`):

    h1  = bf16(relu(x @ w1 + b1))                       1x1, CIN -> F
    h2  = bf16(relu(conv3x3_s(h1) + b2))                stride S, pad 1
    out = bf16(relu(h2 @ w3 + x[::S, ::S] @ wsc + b3 + bsc))

and the backward from the saved h1/h2 (`_proj_bwd_kernel`):

    m3 = g * (out > 0);  m2 = bf16(m3 @ w3^T) * (h2 > 0)
    m1 = bf16(conv3x3_S^T(m2)) * (h1 > 0)
    dx = bf16(m1 @ w1^T + scatter_S(m3 @ wsc^T))
    dw1 = x^T m1, dw2 = shift_S(h1)^T m2, dw3 = h2^T m3, dwsc = x[::S, ::S]^T m3

On a CUDA tensor the wrappers launch `csrc/proj_fused.cu` (three launches
of the TMA forward engine: conv1, the 3x3 at stride S, conv3 and the
shortcut as one launch with two K segments) and `csrc/proj_fused_bwd.cu`;
on a CPU tensor they run the plain versions. The no-save forward is the op
`argus::projection_block` (`torch.library`), one node to a CUDA graph
capture and to `torch.export`.
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
    matmul_f32,
    needs_grad,
    relu_mask,
    wgrad_f32,
    zero_grad_of,
)
from argus_tpu_torch.ops.kernels import wgrad_plan

KERNEL = Kernel("proj_fused", "argus_proj_fwd", [P] * 12 + [I] * 7 + [P])
KERNEL_SAVE = Kernel("proj_fused", "argus_proj_fwd", [P] * 12 + [I] * 7 + [P])  # kept h1/h2
KERNEL_BWD = Kernel("proj_fused_bwd", "argus_proj_bwd", [P] * 18 + [L] + [I] * 7 + [P])


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


def projection_block_save_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """The saving forward in plain PyTorch: (out, h1, h2)."""
    dt = x.dtype
    h1 = bias_relu(matmul_f32(x, w1), b1, dt)
    h2 = bias_relu(conv3x3_f32(h1, w2, stride), b2, dt)
    acc = matmul_f32(h2, w3) + matmul_f32(x[:, ::stride, ::stride], wsc) + b3.float().reshape(-1)
    return bias_relu(acc, bsc, dt), h1, h2


def proj_bwd_plain(x, g, out, h1, h2, w1, w2, w3, wsc, stride, need_dx=True):
    """The one-pass backward in plain PyTorch, with the TPU kernel's rounding
    points: (dx in x's dtype or None, dw1, dw2, dw3, dwsc in f32)."""
    dt = x.dtype
    s = stride
    m3 = relu_mask(g, out)
    m2 = relu_mask((m3.float() @ w3.float().t()).to(dt), h2)
    dw3 = wgrad_f32(h2, m3)
    xs = x[:, ::s, ::s]
    dwsc = wgrad_f32(xs, m3)
    dh1, dw2 = conv3x3_grads_f32(h1, m2, w2, s)
    m1 = relu_mask(dh1.to(dt), h1)
    dw1 = wgrad_f32(x, m1)
    dx = None
    if need_dx:
        acc = m1.float() @ w1.float().t()
        acc[:, ::s, ::s] += m3.float() @ wsc.float().t()
        dx = acc.to(dt)
    return dx, dw1, dw2, dw3, dwsc


def _check_block(x, w1, w2, w3, wsc, stride, biases=None):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
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
    for name, t, c in zip(("b1", "b2", "b3", "bsc"), biases or (), (f, f, cout, cout)):
        check_cuda(name, t, torch.float32, (1, c))
    return n, h, w, cin, f, cout


def forward_launch(kernel, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """Launch a projection forward's C launcher (`kernel`, argus_proj_fwd's
    argument order) with its outputs allocated here: (out, h1, h2)."""
    n, h, w, cin, f, cout = _check_block(x, w1, w2, w3, wsc, stride, (b1, b2, b3, bsc))
    ho, wo = h // stride, w // stride
    bf = torch.bfloat16
    h1 = torch.empty((n, h, w, f), dtype=bf, device=x.device)
    h2 = torch.empty((n, ho, wo, f), dtype=bf, device=x.device)
    out = torch.empty((n, ho, wo, cout), dtype=bf, device=x.device)
    kernel.launch(x, h1, h2, out, w1, b1, w2, b2, w3, b3, wsc, bsc, n, h, w, cin, f, cout, stride)
    return out, h1, h2


@torch.library.custom_op("argus::projection_block", mutates_args=(), device_types="cuda")
def projection_block_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        w3: torch.Tensor, b3: torch.Tensor, wsc: torch.Tensor, bsc: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """The projection block's no-save forward as the op
    `argus::projection_block`: on a CUDA tensor the kernel (`KERNEL`)."""
    return forward_launch(KERNEL, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)[0]


@projection_block_op.register_kernel("cpu")
def _projection_block_cpu(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    return projection_block_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)


@projection_block_op.register_fake
def _projection_block_fake(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    n, h, w, _ = x.shape
    return x.new_empty((n, h // stride, w // stride, w3.shape[1]))


def projection_block(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """Projection bottleneck forward through `argus::projection_block`: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    check_device(x)
    return projection_block_op(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)


def projection_block_save(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """The training forward, (out, h1, h2): the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if not check_device(x):
        return projection_block_save_plain(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
    return forward_launch(KERNEL_SAVE, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)


def projection_wgrad_plans(n, h, w, cin, f, cout, stride):
    """The block's weight gradients as `wgrad_plan` takes them (rows, C,
    COUT, kernel size): dw3, dwsc, dw2, dw1 in launch order."""
    rows, rows_o = n * h * w, n * (h // stride) * (w // stride)
    return [(rows_o, f, cout, 1), (rows_o, cin, cout, 1), (rows_o, f, f, 3), (rows, cin, f, 1)]


def transposed_weights(w1, w2, w3, wsc, stride):
    """The data gradients' operands: w1^T, the 3x3's taps for the stride,
    w3^T, wsc^T."""
    return (w1.t().contiguous(), dgrad_w2(w2, stride), w3.t().contiguous(), wsc.t().contiguous())


def proj_bwd(x, g, out, h1, h2, w1, w2, w3, wsc, stride, need_dx=True):
    """The one-pass backward from the saved h1/h2: (dx or None, dw1, dw2,
    dw3, dwsc in f32). The CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    if not check_device(x):
        return proj_bwd_plain(x, g, out, h1, h2, w1, w2, w3, wsc, stride, need_dx)
    n, h, w, cin, f, cout = _check_block(x, w1, w2, w3, wsc, stride)
    ho, wo = h // stride, w // stride
    bf = torch.bfloat16
    for name, t, shape in (
        ("g", g, (n, ho, wo, cout)), ("out", out, (n, ho, wo, cout)),
        ("h1", h1, (n, h, w, f)), ("h2", h2, (n, ho, wo, f)),
    ):
        check_cuda(name, t, bf, shape)
    dev = x.device
    m1, m2, m3 = torch.empty_like(h1), torch.empty_like(h2), torch.empty_like(g)
    dx = torch.empty_like(x) if need_dx else None
    f32 = dict(dtype=torch.float32, device=dev)
    dw1, dw2 = torch.empty((cin, f), **f32), torch.empty((3, 3, f, f), **f32)
    dw3, dwsc = torch.empty((f, cout), **f32), torch.empty((cin, cout), **f32)
    ws_elems = wgrad_plan.workspace(*projection_wgrad_plans(n, h, w, cin, f, cout, stride))
    ws = torch.empty(max(ws_elems, 1), **f32)
    KERNEL_BWD.launch(
        x, g, out, h1, h2, *transposed_weights(w1, w2, w3, wsc, stride), dx, m1, m2, m3, dw1, dw2, dw3, dwsc,
        ws, ws_elems, n, h, w, cin, f, cout, stride,
    )
    return dx, dw1, dw2, dw3, dwsc


class _ProjSaved(torch.autograd.Function):
    """argus_tpu's `_proj_block` custom VJP: the saving forward, then the
    one-pass backward; zero bias cotangents, each dw in its weight's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
        out, h1, h2 = projection_block_save(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
        ctx.save_for_backward(x, out, h1, h2, w1, w2, w3, wsc)
        ctx.biases = (b1, b2, b3, bsc)
        ctx.stride = stride
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, h1, h2, w1, w2, w3, wsc = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw1, dw2, dw3, dwsc = proj_bwd(
            x, g.contiguous(), out, h1, h2, w1, w2, w3, wsc, ctx.stride, need[0]
        )
        db1, db2, db3, dbsc = (zero_grad_of(need[i], b) for i, b in zip((2, 4, 6, 8), ctx.biases))
        return (dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dw3.to(w3.dtype), db3,
                dwsc.to(wsc.dtype), dbsc, None)


def proj_saved(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """The projection block as autograd sees it: the no-save forward when no
    input needs a gradient, else the saving forward with the kernel
    backward."""
    if needs_grad(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
        return _ProjSaved.apply(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
    return projection_block(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)


class _ProjRemat(torch.autograd.Function):
    """A fused projection block under remat: the no-save forward keeping x
    only; the backward re-runs the saving forward, then the one-pass
    backward (what argus_tpu's `nn.remat` does around `_proj_block`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3, wsc, bsc)
        ctx.stride = stride
        return projection_block(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, w3, b3, wsc, bsc = ctx.saved_tensors
        need = ctx.needs_input_grad
        out, h1, h2 = projection_block_save(x, w1, b1, w2, b2, w3, b3, wsc, bsc, ctx.stride)
        dx, dw1, dw2, dw3, dwsc = proj_bwd(x, g.contiguous(), out, h1, h2, w1, w2, w3, wsc, ctx.stride, need[0])
        db1, db2, db3, dbsc = (zero_grad_of(need[i], b) for i, b in zip((2, 4, 6, 8), (b1, b2, b3, bsc)))
        return (dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dw3.to(w3.dtype), db3,
                dwsc.to(wsc.dtype), dbsc, None)


def proj_remat(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride):
    """The projection block under remat: as `proj_saved`, keeping only x
    between the forward and the backward."""
    if needs_grad(x, w1, b1, w2, b2, w3, b3, wsc, bsc):
        return _ProjRemat.apply(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
    return projection_block(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)


def fused_projection_block(
    x, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3,
    ksc, ssc, bisc, msc, vsc, *, stride: int = 2, eps: float = 1e-5,
):
    """argus_tpu's `fused_projection_block` signature: HWIO kernels and raw
    frozen-BN buffers, folded here in f32 (gradients flow to x and the four
    kernels), then the block."""
    folded = fold_projection_params(
        x.dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2,
        k3, s3, bi3, m3, v3, ksc, ssc, bisc, msc, vsc, eps=eps,
    )
    return proj_saved(x, *folded, stride)
