"""Pointwise (1x1) conv on a folded frozen-BN weight, with relu and an
optional residual (NHWC): forward and one-pass backward.

Port of `argus_tpu/ops/pallas/pointwise.py` (`pointwise_conv_frozen_bn`
through `_pw_nores` / `_pw_res`), what `fuse_pointwise` runs for Conv_0 and
Conv_2 of a bottleneck block:

    out = bf16(relu(x2 @ w_eff + b_eff [+ res2]))    x2 (M, CIN), one rounding
    m   = g * (out > 0)                              (g without relu)
    dx  = bf16(m @ w_eff^T)      dw = x2^T m in f32  (m: the residual's cotangent)

with w_eff = bf16(k * c) and b_eff = b - mean * c in f32, c = s * rsqrt(v +
eps) (`block_fused.fold_affine`). dw is cast to w_eff's dtype before the
fold's autograd, so dk = f32(bf16(dw)) * c, as argus_tpu's custom VJP
returns it.

Two implementations of the same function, as argus_tpu has them:
- "kernel" (`fuse_pointwise="on"`, argus_tpu's Pallas kernels): on a CUDA
  tensor the hand-written kernels `csrc/pointwise.cu` (the TMA forward
  engine's 1x1 mode over M images of 1 x 1 pixel) and
  `csrc/pointwise_bwd.cu` (a mask pass, then dx and dw on the Hopper
  wgmma/TMA engines), on a CPU tensor their plain versions
  (`pointwise_fwd_plain`, `pointwise_bwd_plain`), which `chip_smoke.py`
  holds the kernels against on the card;
- "dot" (`fuse_pointwise="dot"`, argus_tpu's `impl="xla"`): the same
  formulas as `torch.mm` products outside any kernel of this repository, as
  argus_tpu leaves its dots to XLA. On the card each product is cuBLAS's
  bf16 GEMM with an f32 output (`torch.mm(..., out_dtype=torch.float32)`),
  so it rounds where the kernel rounds: once, after the f32 bias, residual
  and relu (dx once after the product). On the CPU the same sums are the
  f32 product of the bf16 values.

The autograd functions take the no-save forward (no Function, no saved
tensors) when no input needs a gradient, as a frozen stage runs it.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels import wgrad_plan
from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    check_channels,
    check_cuda,
    check_device,
    fold_affine,
    kernel_dtype,
    needs_grad,
    relu_mask,
    wgrad_f32,
    zero_grad_of,
)

KERNEL = Kernel("pointwise", "argus_pointwise_fwd", [P] * 5 + [I] * 4 + [P])
KERNEL_BWD = Kernel("pointwise_bwd", "argus_pointwise_bwd", [P] * 8 + [L] + [I] * 4 + [P])

IMPLS = ("kernel", "dot")


# ───────────────────────────── plain versions ─────────────────────────────


def pointwise_fwd_plain(x2, w, b, res2=None, relu=True):
    """The forward in plain PyTorch, with the kernel's rounding point."""
    z = x2.float() @ w.float() + b.float().reshape(-1)
    if res2 is not None:
        z = z + res2.float()
    return (torch.relu(z) if relu else z).to(x2.dtype)


def pointwise_bwd_plain(g2, out2, x2, w, relu=True, emit_m=False, need_dx=True):
    """The backward in plain PyTorch: (dx in x2's dtype or None, dw in f32,
    m or None)."""
    m = relu_mask(g2, out2) if relu else g2
    dx = (m.float() @ w.float().t()).to(x2.dtype) if need_dx else None
    return dx, wgrad_f32(x2, m), m if emit_m else None


# ───────────────────────────── kernel wrappers ─────────────────────────────


def _check(x2, w):
    m, cin = x2.shape
    cout = w.shape[1]
    check_channels(CIN=cin, COUT=cout)
    check_cuda("x2", x2, kernel_dtype(x2, f32=False))  # f32: ROADMAP A14
    check_cuda("w", w, torch.bfloat16, (cin, cout))
    return m, cin, cout


def pointwise_fwd(x2, w, b, res2=None, relu=True):
    """out (M, COUT): the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor. Any M; CIN and COUT multiples of 8 on the card."""
    if not check_device(x2):
        return pointwise_fwd_plain(x2, w, b, res2, relu)
    m, cin, cout = _check(x2, w)
    check_cuda("b", b, torch.float32, (1, cout))
    if res2 is not None:
        check_cuda("res2", res2, torch.bfloat16, (m, cout))
    out = torch.empty((m, cout), dtype=torch.bfloat16, device=x2.device)
    KERNEL.launch(x2, w, b, res2, out, m, cin, cout, int(relu))
    return out


def pointwise_wgrad_plans(m: int, cin: int, cout: int):
    """The backward's weight gradient as `wgrad_plan` takes it (rows, C,
    COUT, kernel size): dw = x2^T m over M rows, one tap
    (csrc/pointwise_bwd.cu)."""
    return [(m, cin, cout, 1)]


def pointwise_bwd(g2, out2, x2, w, relu=True, emit_m=False, need_dx=True):
    """(dx or None, dw in f32, m or None): the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor. On the card, with relu, m is written
    once (the caller's m, or scratch) and both products read it."""
    if not check_device(x2):
        return pointwise_bwd_plain(g2, out2, x2, w, relu, emit_m, need_dx)
    m, cin, cout = _check(x2, w)
    for name, t in (("g2", g2), ("out2", out2)):
        check_cuda(name, t, torch.bfloat16, (m, cout))
    dev = x2.device
    dx = torch.empty_like(x2) if need_dx else None
    dw = torch.empty((cin, cout), dtype=torch.float32, device=dev)
    mm = torch.empty_like(g2) if relu else None  # m, the caller's when emitted, else scratch
    ws_elems = wgrad_plan.workspace(*pointwise_wgrad_plans(m, cin, cout))
    ws = torch.empty(max(ws_elems, 1), dtype=torch.float32, device=dev)
    KERNEL_BWD.launch(g2, out2, x2, w.t().contiguous(), dx, dw, mm, ws, ws_elems, m, cin, cout, int(relu))
    return dx, dw, (mm if relu else g2) if emit_m else None


# ───────────────────────────── the "dot" path ─────────────────────────────


def _mm_f32(a, b):
    """a @ b of bf16 operands, f32 sums, f32 result: cuBLAS's bf16 GEMM with
    an f32 output on the card, the f32 product of the values elsewhere."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def pointwise_fwd_dot(x2, w, b, res2=None, relu=True):
    z = _mm_f32(x2, w).add_(b.float().reshape(-1))
    if res2 is not None:
        z.add_(res2)
    return (z.relu_() if relu else z).to(x2.dtype)


def pointwise_bwd_dot(g2, out2, x2, w, relu=True, emit_m=False, need_dx=True):
    m = relu_mask(g2, out2) if relu else g2
    dx = _mm_f32(m, w.t()).to(x2.dtype) if need_dx else None
    return dx, _mm_f32(x2.t(), m), m if emit_m else None


_FWD = {"kernel": pointwise_fwd, "dot": pointwise_fwd_dot}
_BWD = {"kernel": pointwise_bwd, "dot": pointwise_bwd_dot}


# ───────────────────────────── autograd ─────────────────────────────


class _PwNoRes(torch.autograd.Function):
    """argus_tpu's `_pw_nores` custom VJP: zero bias cotangent, dw in w's
    dtype."""

    @staticmethod
    def forward(ctx, x2, w, b, relu: bool, impl: str):
        out = _FWD[impl](x2, w, b, None, relu)
        ctx.save_for_backward(x2, w, out)
        ctx.relu, ctx.impl, ctx.bias = relu, impl, b
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, _ = _BWD[ctx.impl](g.contiguous(), out, x2, w, ctx.relu, False, need[0])
        return dx, dw.to(w.dtype), zero_grad_of(need[2], ctx.bias), None, None


class _PwRes(torch.autograd.Function):
    """argus_tpu's `_pw_res` custom VJP: as `_PwNoRes`, and m as the
    residual's cotangent."""

    @staticmethod
    def forward(ctx, x2, w, b, res2, relu: bool, impl: str):
        out = _FWD[impl](x2, w, b, res2, relu)
        ctx.save_for_backward(x2, w, out)
        ctx.relu, ctx.impl, ctx.bias = relu, impl, b
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw, m = _BWD[ctx.impl](g.contiguous(), out, x2, w, ctx.relu, need[3], need[0])
        return dx, dw.to(w.dtype), zero_grad_of(need[2], ctx.bias), m, None, None


def pointwise_conv(x, w, b, residual=None, relu=True, impl="kernel"):
    """relu(conv1x1(x) with the folded weight w (CIN, COUT) and f32 bias b
    (1, COUT) [+ residual]) on NHWC x, in x's dtype; gradients to x, w and
    the residual. The no-save forward when nothing needs a gradient."""
    if impl not in IMPLS:
        raise ValueError(f"pointwise impl must be one of {IMPLS}, got {impl!r}")
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    x2 = x.contiguous().reshape(n * h * wd, cin)
    res2 = None if residual is None else residual.contiguous().reshape(n * h * wd, cout)
    ins = (x2, w, b) if res2 is None else (x2, w, b, res2)
    if not needs_grad(*ins):
        out = _FWD[impl](x2, w, b, res2, relu)
    elif res2 is None:
        out = _PwNoRes.apply(x2, w, b, relu, impl)
    else:
        out = _PwRes.apply(x2, w, b, res2, relu, impl)
    return out.reshape(n, h, wd, cout)


def pointwise_conv_frozen_bn(x, kernel, scale, bias, mean, var, *, eps=1e-5, relu=True, residual=None,
                             impl="kernel"):
    """argus_tpu's `pointwise_conv_frozen_bn` signature: x (N, H, W, CIN),
    kernel (1, 1, CIN, COUT) HWIO, the frozen-BN buffers (COUT,), folded here
    in f32 (gradients flow to x, kernel and the residual; the buffers get
    none), then `pointwise_conv`."""
    cin, cout = kernel.shape[-2], kernel.shape[-1]
    w, b = fold_affine(kernel.reshape(cin, cout), scale, bias, mean, var, eps, x.dtype)
    return pointwise_conv(x, w, b, residual, relu, impl)
