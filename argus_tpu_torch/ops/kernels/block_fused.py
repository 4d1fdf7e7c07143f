"""Identity bottleneck block on folded frozen-BN weights (NHWC): forward,
saving forward and one-pass backward.

Port of `argus_tpu/ops/pallas/block_fused.py` (`fused_bottleneck_block`
through `_block_saved`, and `fold_bottleneck_params`):

    h1  = bf16(relu(x @ w1 + b1))            1x1, CIN -> F
    h2  = bf16(relu(conv3x3(h1) + b2))       pad 1
    out = bf16(relu(h2 @ w3 + b3 + x))       identity residual

with every sum in f32 and one rounding to the activation dtype after each
bias + relu, as the TPU kernel rounds. The backward from the saved h1/h2:

    m3 = g * (out > 0)                       in g's dtype
    m2 = bf16(m3 @ w3^T) * (h2 > 0)          dw3 = h2^T m3
    m1 = bf16(conv3x3^T(m2)) * (h1 > 0)      dw2[ky, kx] = shift(h1)^T m2
    dx = bf16(m1 @ w1^T + m3)                dw1 = x^T m1     (dw in f32)

The backward under remat recomputes h1/h2 from x first (`_block_bwd_pallas`,
`block_bwd_recompute`, csrc/block_fused_rbwd.cu) and then takes the same
formulas; it reads only x, g, out, the folded weights and the biases.

Each function has three parts: the plain PyTorch version (`*_plain`), which
the CPU tests hold against argus_tpu and `chip_smoke.py` holds the kernel
against on the card; the wrapper, which launches the CUDA kernel on a CUDA
tensor (`csrc/block_fused.cu`, three launches of the TMA forward engine;
`csrc/block_fused_bwd.cu` and `csrc/block_fused_rbwd.cu`, the Hopper
backward compositions) and runs the plain version on a CPU tensor; and
`block_saved`, the `torch.autograd.Function` that ties the saving forward to
the backward. The no-save forward is the op `argus::bottleneck_block`
(`torch.library`: the launch on CUDA, the plain version on the CPU, a fake
for shapes), one node to a CUDA graph capture and to `torch.export`.

Also home of the helpers the other block kernels share: the plain conv
pieces and the wrapper argument checks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels import wgrad_plan
from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel

KERNEL = Kernel("block_fused", "argus_block_fwd", [P] * 10 + [I] * 5 + [P])
# the training forward is the same launcher with the buffers kept; its own
# handle counts its launches apart
KERNEL_SAVE = Kernel("block_fused", "argus_block_fwd", [P] * 10 + [I] * 5 + [P])
KERNEL_BWD = Kernel("block_fused_bwd", "argus_block_bwd", [P] * 16 + [L] + [I] * 5 + [P])
KERNEL_RBWD = Kernel("block_fused_rbwd", "argus_block_rbwd", [P] * 20 + [L] + [I] * 5 + [P])


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


def conv3x3_grads_f32(h1: torch.Tensor, m2: torch.Tensor, w: torch.Tensor, stride: int):
    """The 3x3/pad-1 conv's gradients in f32 for the output gradient m2 (NHWC):
    (dh1 (N, H, W, F), dw (3, 3, F, F) HWIO). dh1[y, x] sums m2[(y+1-ky)/s,
    (x+1-kx)/s] @ w[ky, kx]^T over the taps that land exactly."""
    h = h1.float().permute(0, 3, 1, 2)
    g = m2.float().permute(0, 3, 1, 2)
    wt = w.float().permute(3, 2, 0, 1)
    dh = torch.nn.grad.conv2d_input(h.shape, wt, g, stride=stride, padding=1)
    dw = torch.nn.grad.conv2d_weight(h, wt.shape, g, stride=stride, padding=1)
    return dh.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


def wgrad_f32(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a^T m over every pixel, in f32: (..., C), (..., COUT) -> (C, COUT)."""
    return a.reshape(-1, a.shape[-1]).float().t() @ m.reshape(-1, m.shape[-1]).float()


def relu_mask(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """v * (ref > 0) in v's dtype: the backward's relu masks."""
    return v * (ref > 0)


def identity_wgrad_plans(n, h, w, cin, f):
    """The identity block's weight gradients as `wgrad_plan` takes them
    (rows, C, COUT, kernel size): dw3, dw2, dw1 in the launch order of
    csrc/identity_bwd_sm90.cuh."""
    rows = n * h * w
    return [(rows, f, cin, 1), (rows, f, f, 3), (rows, cin, f, 1)]


def _identity_scratch(x, n, h, w, cin, f, need_dx):
    """The Hopper identity backward's outputs and scratch: dx (or None),
    m1, m2 (N, H, W, F), m3 (N, H, W, CIN), dw1-3 in f32, the workspace of
    the weight gradients' partials and its size."""
    dev, bf = x.device, torch.bfloat16
    f32 = dict(dtype=torch.float32, device=dev)
    m1, m2 = (torch.empty((n, h, w, f), dtype=bf, device=dev) for _ in range(2))
    m3 = torch.empty_like(x)
    dx = torch.empty_like(x) if need_dx else None
    dws = (torch.empty((cin, f), **f32), torch.empty((3, 3, f, f), **f32), torch.empty((f, cin), **f32))
    ws_elems = wgrad_plan.workspace(*identity_wgrad_plans(n, h, w, cin, f))
    return dx, m1, m2, m3, dws, torch.empty(max(ws_elems, 1), **f32), ws_elems


def fold_affine(k: torch.Tensor, s, b, m, v, eps: float, dtype, axis: int = -1):
    """Frozen BN after a conv folded into it: (k * c) in `dtype`, b - m*c in f32
    as a (1, COUT) row, with c = s * rsqrt(v + eps) (argus_tpu's f32 fold)
    scaling k's output-channel axis `axis` (the last of an HWIO kernel, the
    first of a torch OIHW weight). The BN buffers are frozen: a gradient
    reaches k (dk = dw * c), never s, b, m or v."""
    s, b, m, v = (t.detach() for t in (s, b, m, v))
    c = s.float() * torch.rsqrt(v.float() + eps)
    shape = [1] * k.ndim
    shape[axis] = -1
    w = (k.float() * c.reshape(shape)).to(dtype).contiguous()
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


def bottleneck_block_save_plain(x, w1, b1, w2, b2, w3, b3):
    """The saving forward in plain PyTorch: (out, h1, h2)."""
    dt = x.dtype
    h1 = bias_relu(matmul_f32(x, w1), b1, dt)
    h2 = bias_relu(conv3x3_f32(h1, w2, 1), b2, dt)
    out = torch.relu(matmul_f32(h2, w3) + b3.float().reshape(-1) + x.float()).to(dt)
    return out, h1, h2


def block_bwd_plain(x, g, out, h1, h2, w1, w2, w3, need_dx=True):
    """The one-pass backward in plain PyTorch, with the TPU kernel's rounding
    points: (dx in x's dtype or None, dw1, dw2, dw3 in f32)."""
    dt = x.dtype
    m3 = relu_mask(g, out)
    m2 = relu_mask((m3.float() @ w3.float().t()).to(dt), h2)
    dw3 = wgrad_f32(h2, m3)
    dh1, dw2 = conv3x3_grads_f32(h1, m2, w2, 1)
    m1 = relu_mask(dh1.to(dt), h1)
    dw1 = wgrad_f32(x, m1)
    dx = (m1.float() @ w1.float().t() + m3.float()).to(dt) if need_dx else None
    return dx, dw1, dw2, dw3


def _check_block(x, w1, w2, w3, biases=None):
    n, h, w, cin = x.shape
    f = w1.shape[1]
    check_channels(CIN=cin, F=f)
    bf = torch.bfloat16
    check_cuda("x", x, bf)
    for name, t, shape in (("w1", w1, (cin, f)), ("w2", w2, (3, 3, f, f)), ("w3", w3, (f, cin))):
        check_cuda(name, t, bf, shape)
    for name, t, c in zip(("b1", "b2", "b3"), biases or (), (f, f, cin)):
        check_cuda(name, t, torch.float32, (1, c))
    return n, h, w, cin, f


def _forward(kernel, x, w1, b1, w2, b2, w3, b3):
    n, h, w, cin, f = _check_block(x, w1, w2, w3, (b1, b2, b3))
    h1 = torch.empty((n, h, w, f), dtype=torch.bfloat16, device=x.device)
    h2 = torch.empty_like(h1)
    out = torch.empty_like(x)
    kernel.launch(x, h1, h2, out, w1, b1, w2, b2, w3, b3, n, h, w, cin, f)
    return out, h1, h2


@torch.library.custom_op("argus::bottleneck_block", mutates_args=(), device_types="cuda")
def bottleneck_block_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """The identity block's no-save forward as the op
    `argus::bottleneck_block`: on a CUDA tensor the kernel (`KERNEL`)."""
    return _forward(KERNEL, x, w1, b1, w2, b2, w3, b3)[0]


@bottleneck_block_op.register_kernel("cpu")
def _bottleneck_block_cpu(x, w1, b1, w2, b2, w3, b3):
    return bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)


@bottleneck_block_op.register_fake
def _bottleneck_block_fake(x, w1, b1, w2, b2, w3, b3):
    return x.new_empty(x.shape)


def bottleneck_block(x, w1, b1, w2, b2, w3, b3):
    """Identity bottleneck forward through `argus::bottleneck_block`: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor; raises
    for any other device."""
    check_device(x)
    return bottleneck_block_op(x, w1, b1, w2, b2, w3, b3)


def bottleneck_block_save(x, w1, b1, w2, b2, w3, b3):
    """The training forward, (out, h1, h2): the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if not check_device(x):
        return bottleneck_block_save_plain(x, w1, b1, w2, b2, w3, b3)
    return _forward(KERNEL_SAVE, x, w1, b1, w2, b2, w3, b3)


def dgrad_w2(w2: torch.Tensor, stride: int) -> torch.Tensor:
    """The 3x3's data-gradient taps (9, F, F) as csrc/conv_bwd.cuh takes them.
    Stride 1: the forward conv's flipped, transposed kernel, w2[2-ky, 2-kx]^T.
    Stride 2: per output parity class (0,0), (0,1), (1,0), (1,1) the taps
    that land on it, an even coordinate tap 1, an odd one taps 2 then 0
    (source offsets 0 and +1): 1 + 2 + 2 + 4 taps, each w2[ky, kx]^T."""
    f = w2.shape[-1]
    if stride == 1:
        return w2.flip(0, 1).transpose(2, 3).reshape(9, f, f).contiguous()
    def taps(t, parity, dim):  # tap 1, or taps 2 then 0 (no index tensor: no host-device copy)
        return t.narrow(dim, 1, 1) if parity == 0 else torch.stack((t.select(dim, 2), t.select(dim, 0)), dim)

    parts = [taps(taps(w2, py, 0), px, 1).transpose(2, 3).reshape(-1, f, f)
             for py in (0, 1) for px in (0, 1)]
    return torch.cat(parts).contiguous()


def transposed_weights(w1, w2, w3):
    """The data gradients' operands: w1^T, the 3x3's stride-1 taps, w3^T."""
    return w1.t().contiguous(), dgrad_w2(w2, 1), w3.t().contiguous()


def block_bwd(x, g, out, h1, h2, w1, w2, w3, need_dx=True):
    """The one-pass backward from the saved h1/h2: (dx or None, dw1, dw2, dw3
    in f32). The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if not check_device(x):
        return block_bwd_plain(x, g, out, h1, h2, w1, w2, w3, need_dx)
    n, h, w, cin, f = _check_block(x, w1, w2, w3)
    bf = torch.bfloat16
    for name, t, c in (("g", g, cin), ("out", out, cin), ("h1", h1, f), ("h2", h2, f)):
        check_cuda(name, t, bf, (n, h, w, c))
    dx, m1, m2, m3, dws, ws, ws_elems = _identity_scratch(x, n, h, w, cin, f, need_dx)
    KERNEL_BWD.launch(
        x, g, out, h1, h2, *transposed_weights(w1, w2, w3), dx, m1, m2, m3, *dws, ws, ws_elems, n, h, w, cin, f,
    )
    return (dx, *dws)


def block_bwd_recompute_plain(x, g, out, w1, b1, w2, b2, w3, b3, need_dx=True, recomputed=False):
    """The recompute backward in plain PyTorch: h1 and h2 recomputed from x
    and rounded after bias + relu as the forward rounds them, then
    `block_bwd_plain`. b3 is not read (out is given). `recomputed` appends
    h1 and h2 to the result."""
    dt = x.dtype
    h1 = bias_relu(matmul_f32(x, w1), b1, dt)
    h2 = bias_relu(conv3x3_f32(h1, w2, 1), b2, dt)
    grads = block_bwd_plain(x, g, out, h1, h2, w1, w2, w3, need_dx)
    return (*grads, h1, h2) if recomputed else grads


def block_bwd_recompute(x, g, out, w1, b1, w2, b2, w3, b3, need_dx=True, recomputed=False):
    """The identity block's backward from x, g and out alone (argus_tpu's
    `_block_bwd_pallas`): (dx or None, dw1, dw2, dw3 in f32). The CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor. The kernel writes
    the recomputed h1/h2 to a workspace of its own launch; `recomputed`
    appends them to the result (a check of the kernel reads them: where a
    recomputed sum lies within rounding of zero, the two versions' relu
    masks may differ, and the backward from there on with them)."""
    if not check_device(x):
        return block_bwd_recompute_plain(x, g, out, w1, b1, w2, b2, w3, b3, need_dx, recomputed)
    n, h, w, cin, f = _check_block(x, w1, w2, w3, (b1, b2, b3))
    bf = torch.bfloat16
    for name, t in (("g", g), ("out", out)):
        check_cuda(name, t, bf, (n, h, w, cin))
    h1, h2 = (torch.empty((n, h, w, f), dtype=bf, device=x.device) for _ in range(2))
    dx, m1, m2, m3, dws, ws, ws_elems = _identity_scratch(x, n, h, w, cin, f, need_dx)
    KERNEL_RBWD.launch(
        x, g, out, w1, b1, w2, b2, *transposed_weights(w1, w2, w3), dx, h1, h2, m1, m2, m3, *dws,
        ws, ws_elems, n, h, w, cin, f,
    )
    return (dx, *dws, h1, h2) if recomputed else (dx, *dws)


def zero_grad_of(needed: bool, t: torch.Tensor):
    """A frozen input's cotangent: zeros where autograd asks for one."""
    return torch.zeros_like(t) if needed else None


def needs_grad(*ts) -> bool:
    """Whether autograd records through these inputs: the saving forward
    then runs; otherwise the no-save forward (argus_tpu's primal)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _BlockSaved(torch.autograd.Function):
    """argus_tpu's `_block_saved` custom VJP: the saving forward, then the
    one-pass backward; the bias cotangents are zero (frozen BN) and each dw
    is cast to its weight's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        out, h1, h2 = bottleneck_block_save(x, w1, b1, w2, b2, w3, b3)
        ctx.save_for_backward(x, out, h1, h2, w1, w2, w3)
        ctx.biases = (b1, b2, b3)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, h1, h2, w1, w2, w3 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw1, dw2, dw3 = block_bwd(x, g.contiguous(), out, h1, h2, w1, w2, w3, need[0])
        db1, db2, db3 = (zero_grad_of(need[i], b) for i, b in zip((2, 4, 6), ctx.biases))
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dw3.to(w3.dtype), db3


def block_saved(x, w1, b1, w2, b2, w3, b3):
    """The identity block as autograd sees it: the no-save forward when no
    input needs a gradient, else the saving forward with the kernel
    backward."""
    if needs_grad(x, w1, b1, w2, b2, w3, b3):
        return _BlockSaved.apply(x, w1, b1, w2, b2, w3, b3)
    return bottleneck_block(x, w1, b1, w2, b2, w3, b3)


class _BlockRemat(torch.autograd.Function):
    """A fused identity block under remat (argus_tpu's `_block` custom VJP):
    the no-save forward keeping only x and out, and the backward that
    recomputes h1/h2 (`block_bwd_recompute`)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3):
        out = bottleneck_block(x, w1, b1, w2, b2, w3, b3)
        ctx.save_for_backward(x, out, w1, b1, w2, b2, w3, b3)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, w1, b1, w2, b2, w3, b3 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dw1, dw2, dw3 = block_bwd_recompute(x, g.contiguous(), out, w1, b1, w2, b2, w3, b3, need[0])
        db1, db2, db3 = (zero_grad_of(need[i], b) for i, b in zip((2, 4, 6), (b1, b2, b3)))
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, dw3.to(w3.dtype), db3


def block_remat(x, w1, b1, w2, b2, w3, b3):
    """The identity block under remat: as `block_saved`, with the recompute
    backward in place of the saved h1/h2."""
    if needs_grad(x, w1, b1, w2, b2, w3, b3):
        return _BlockRemat.apply(x, w1, b1, w2, b2, w3, b3)
    return bottleneck_block(x, w1, b1, w2, b2, w3, b3)


def fused_bottleneck_block(
    x, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3, *, eps: float = 1e-5
):
    """argus_tpu's `fused_bottleneck_block` signature: HWIO kernels and raw
    frozen-BN buffers, folded here in f32 (gradients flow to x and the three
    kernels; the BN buffers get none), then the block."""
    folded = fold_bottleneck_params(
        x.dtype, k1, s1, bi1, m1, v1, k2, s2, bi2, m2, v2, k3, s3, bi3, m3, v3, eps=eps
    )
    return block_saved(x, *folded)
