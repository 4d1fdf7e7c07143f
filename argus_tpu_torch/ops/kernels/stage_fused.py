"""Whole-stage chain on folded frozen-BN weights (NHWC): an optional
projection block, then identity blocks; forward, saving forward and
backward.

Port of `argus_tpu/ops/pallas/stage_fused.py` `fused_stage` through
`_stage_chain` (the TPU runs the no-save stage-0 forward through
`_chain_fwd_packed`, the training forward through `_chain_fwd_pallas(save=
True)` and the backward through `_chain_bwd_pallas`). The chain is the
composition of the projection and identity blocks, with the same rounding
points: the backward walks the blocks in reverse, each block's dx rounded to
the activation dtype as the next block's cotangent. The TPU's chain cap and
pair-packed layout are Mosaic constraints and are not ported.

On a CUDA tensor the wrappers launch `csrc/stage_fused.cu` (forwards) and
`csrc/stage_fused_bwd.cu`, each running the whole chain from one C call; on
a CPU tensor they run the plain versions. The forwards run the block
forwards on the TMA forward engine (three launches a block, the
projection's conv3 and shortcut one launch with two K segments). The
backward runs the Hopper compositions of the block backwards from each
block's masked cotangent m3:
the incoming g is masked once, and every other m3 is written by the dx
launch of the block after it, its epilogue applying the relu mask of that
block's input (bit-equal to the chain's rounding followed by the next
block's mask). The no-save forward counts its
launches in `KERNEL` where argus_tpu takes `_chain_fwd_packed` (stage 0,
`packed_fwd_ok`) and in `KERNEL_FROZEN` where it takes `_chain_fwd_pallas(
save=False)` (the whole-stage chains of frozen stages 1-3). `stage_chain(
..., x_packed=True)` takes the packed stem's (N, H, W/2, 128) view and reads
it back as the (N, H, W, 64) NHWC tensor it is.

In f32 the saving forward, the backward and the stage-0 no-save forward
launch `csrc/conv_f32.cu` (the same compositions on the mma.sync engines'
TF32 form, counted in the `*_F32` handles); the whole-stage no-save chains
of frozen stages 1-3 have no f32 kernel yet (ROADMAP A14) and raise
NotImplementedError on an f32 CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from argus_tpu_torch.ops.kernels import block_fused, proj_fused, wgrad_plan
from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    block_bwd_plain,
    bottleneck_block_plain,
    bottleneck_block_save_plain,
    check_channels,
    check_cuda,
    check_device,
    identity_wgrad_plans,
    kernel_dtype,
    needs_grad,
    zero_grad_of,
)
from argus_tpu_torch.ops.kernels.proj_fused import (
    proj_bwd_plain,
    projection_block_plain,
    projection_block_save_plain,
    projection_wgrad_plans,
)

KERNEL = Kernel("stage_fused", "argus_stage_fwd", [P] * 8 + [I] * 8 + [P])
KERNEL_FROZEN = Kernel("stage_fused", "argus_stage_fwd", [P] * 8 + [I] * 8 + [P])
KERNEL_SAVE = Kernel("stage_fused", "argus_stage_fwd_save", [P] * 7 + [I] * 8 + [P])
KERNEL_BWD = Kernel("stage_fused_bwd", "argus_stage_bwd", [P] * 16 + [L] + [I] * 8 + [P])
# the f32 kernels (csrc/conv_f32.cu): the stage-0 no-save forward, the saving forward, the backward
KERNEL_F32 = Kernel("conv_f32", "argus_stage_fwd_f32", [P] * 8 + [I] * 8 + [P])
KERNEL_SAVE_F32 = Kernel("conv_f32", "argus_stage_fwd_save_f32", [P] * 7 + [I] * 8 + [P])
KERNEL_BWD_F32 = Kernel("conv_f32", "argus_stage_bwd_f32", [P] * 16 + [L] + [I] * 8 + [P])


def packed_fwd_ok(F: int, S: int, W_out: int, CIN: int, COUT: int) -> bool:
    """argus_tpu's `_packed_fwd_ok`: whether its no-save chain runs the
    pair-packed form (stride 1, F < 128, lane-filling widths) rather than
    `_chain_fwd_pallas(save=False)`."""
    return S == 1 and W_out % 2 == 0 and F < 128 and (2 * F) % 128 == 0 and (2 * CIN) % 128 == 0 \
        and (2 * COUT) % 128 == 0


def stage_plain(x, proj_folded, id_folded, stride):
    """The chain in plain PyTorch."""
    cur = x
    if proj_folded is not None:
        cur = projection_block_plain(cur, *proj_folded, stride)
    for idw in id_folded:
        cur = bottleneck_block_plain(cur, *idw)
    return cur


def stage_save_plain(x, proj_folded, id_folded, stride):
    """The saving chain in plain PyTorch: (out, bnds, h1s, h2s) with bnds
    every block's output but the last's."""
    cur, outs, h1s, h2s = x, [], [], []
    if proj_folded is not None:
        cur, h1, h2 = projection_block_save_plain(cur, *proj_folded, stride)
        outs.append(cur), h1s.append(h1), h2s.append(h2)
    for idw in id_folded:
        cur, h1, h2 = bottleneck_block_save_plain(cur, *idw)
        outs.append(cur), h1s.append(h1), h2s.append(h2)
    return cur, outs[:-1], h1s, h2s


def stage_bwd_plain(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx=True):
    """The chain backward in plain PyTorch: the block backwards in reverse.
    proj_w is (w1, w2, w3, wsc) or None, id_w [(w1, w2, w3), ...]. Returns
    (dx or None, proj dws (dw1, dw2, dw3, dwsc) or None, [(dw1, dw2, dw3)])."""
    has_proj = proj_w is not None
    outs = list(bnds) + [out]
    id_dws = [None] * len(id_w)
    for j in reversed(range(len(id_w))):
        b = j + has_proj
        x_b = x if b == 0 else outs[b - 1]
        need = need_dx or b > 0
        g, *dws = block_bwd_plain(x_b, g, outs[b], h1s[b], h2s[b], *id_w[j], need_dx=need)
        id_dws[j] = tuple(dws)
    proj_dws = None
    if has_proj:
        g, *dws = proj_bwd_plain(x, g, outs[0], h1s[0], h2s[0], *proj_w, stride, need_dx)
        proj_dws = tuple(dws)
    return g, proj_dws, id_dws


def _check_weights(ws, shapes, dt) -> None:
    for i, (t, shape) in enumerate(zip(ws, shapes)):
        dtype = dt if i % 2 == 0 else torch.float32
        check_cuda(f"weight {i}", t, dtype, shape)


def _geometry(x, proj_folded, ids, stride):
    """(n, h, w, cin, f, cout, s) of a chain, its weights checked."""
    n, h, w, cin = x.shape
    s = stride if proj_folded is not None else 1
    if s not in (1, 2) or h % s or w % s:
        raise ValueError(f"stride {stride} does not fit spatial size {(h, w)}")
    f = (proj_folded[0] if proj_folded is not None else ids[0][0]).shape[1]
    cout = proj_folded[4].shape[1] if proj_folded is not None else cin
    check_channels(CIN=cin, F=f, COUT=cout)
    dt = kernel_dtype(x)
    check_cuda("x", x, dt)
    if proj_folded is not None:
        _check_weights(
            proj_folded,
            [(cin, f), (1, f), (3, 3, f, f), (1, f), (f, cout), (1, cout), (cin, cout), (1, cout)], dt,
        )
    for idw in ids:
        _check_weights(idw, [(cout, f), (1, f), (3, 3, f, f), (1, f), (f, cout), (1, cout)], dt)
    return n, h, w, cin, f, cout, s


def _ptrs(ts):
    """A host array of device pointers (None for a missing one); the caller
    keeps it alive until the launcher returns."""
    ptrs = [0 if t is None else t.data_ptr() for t in ts]
    return (ctypes.c_void_p * max(len(ptrs), 1))(*ptrs)


def chain_fwd_launch(kernel, x, proj_folded, ids, stride):
    """Launch a no-save chain's C launcher (`kernel`, argus_stage_fwd's
    argument order) with its output and scratch allocated here; None: the
    stage-0 form (`KERNEL`, in f32 `KERNEL_F32`) where argus_tpu takes
    `_chain_fwd_packed`, `KERNEL_FROZEN` elsewhere (bf16 only)."""
    n, h, w, cin, f, cout, s = _geometry(x, proj_folded, ids, stride)
    if kernel is None:
        stage0 = packed_fwd_ok(f, s, w // s, cin, cout)
        kernel_dtype(x, f32=stage0)  # the frozen stages' chains have no f32 kernel yet
        kernel = (KERNEL_F32 if x.dtype == torch.float32 else KERNEL) if stage0 else KERNEL_FROZEN
    ho, wo = h // s, w // s
    bf, dev = x.dtype, x.device
    h1 = torch.empty((n, h, w, f), dtype=bf, device=dev)
    h2 = torch.empty((n, ho, wo, f), dtype=bf, device=dev)
    n_tmp = len(ids) if proj_folded is not None else len(ids) - 1
    tmp = [torch.empty((n, ho, wo, cout), dtype=bf, device=dev) for _ in range(min(n_tmp, 2))]
    tmp += [h2] * (2 - len(tmp))  # unused slots: any valid pointer
    out = torch.empty((n, ho, wo, cout), dtype=bf, device=dev)

    # host arrays of weight pointers, alive until the launcher returns
    proj_arr = _ptrs(proj_folded) if proj_folded is not None else None
    id_arr = _ptrs([t for idw in ids for t in idw])
    kernel.launch(
        x, out, h1, h2, tmp[0], tmp[1],
        ctypes.addressof(proj_arr) if proj_arr is not None else None,
        ctypes.addressof(id_arr), len(ids), n, h, w, cin, f, cout, s,
    )
    return out


def split_flat(flat, has_proj: bool):
    """The chain's flat weights (the projection's 8, then 6 per identity
    block) as (proj_folded or None, [identity weights, ...])."""
    proj = tuple(flat[:8]) if has_proj else None
    rest = flat[8:] if has_proj else flat
    return proj, [tuple(rest[i:i + 6]) for i in range(0, len(rest), 6)]


@torch.library.custom_op("argus::stage_fwd", mutates_args=(), device_types="cuda")
def stage_fwd_op(x: torch.Tensor, weights: list[torch.Tensor], has_proj: bool, stride: int) -> torch.Tensor:
    """The chain's no-save forward as the op `argus::stage_fwd`, its weights
    flat (`split_flat`): on a CUDA tensor one launch of the chain, counted in
    `KERNEL` where argus_tpu takes `_chain_fwd_packed`, else in
    `KERNEL_FROZEN`."""
    proj, ids = split_flat(weights, has_proj)
    return chain_fwd_launch(None, x, proj, ids, stride)


@stage_fwd_op.register_kernel("cpu")
def _stage_fwd_cpu(x, weights, has_proj, stride):
    proj, ids = split_flat(weights, has_proj)
    return stage_plain(x, proj, ids, stride)


@stage_fwd_op.register_fake
def _stage_fwd_fake(x, weights, has_proj, stride):
    n, h, w, cin = x.shape
    s = stride if has_proj else 1
    return x.new_empty((n, h // s, w // s, weights[4].shape[1] if has_proj else cin))


def fused_stage(
    x: torch.Tensor,
    proj_folded: Optional[Sequence[torch.Tensor]],
    id_folded: Sequence[Sequence[torch.Tensor]],
    stride: int = 2,
) -> torch.Tensor:
    """Run a stage: `proj_folded` (w1, b1, w2, b2, w3, b3, wsc, bsc) or None,
    then each identity block of `id_folded` (w1, b1, w2, b2, w3, b3), through
    `argus::stage_fwd`: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor."""
    ids = [tuple(w) for w in id_folded]
    if proj_folded is None and not ids:
        raise ValueError("a stage needs at least one block")
    check_device(x)
    flat = list(proj_folded or ()) + [t for idw in ids for t in idw]
    return stage_fwd_op(x, flat, proj_folded is not None, stride)


def chain_fwd_save_launch(kernel, x, proj_folded, ids, stride):
    """Launch a saving chain's C launcher (`kernel`, argus_stage_fwd_save's
    argument order) with its outputs allocated here: (out, bnds, h1s,
    h2s)."""
    n, h, w, cin, f, cout, s = _geometry(x, proj_folded, ids, stride)
    ho, wo = h // s, w // s
    bf, dev = x.dtype, x.device
    has_proj = proj_folded is not None
    nblocks = has_proj + len(ids)
    bnds = [torch.empty((n, ho, wo, cout), dtype=bf, device=dev) for _ in range(nblocks - 1)]
    out = torch.empty((n, ho, wo, cout), dtype=bf, device=dev)
    h1s = [torch.empty((n, h, w, f) if has_proj and b == 0 else (n, ho, wo, f), dtype=bf, device=dev)
           for b in range(nblocks)]
    h2s = [torch.empty((n, ho, wo, f), dtype=bf, device=dev) for _ in range(nblocks)]
    arrs = [_ptrs(bnds), _ptrs(h1s), _ptrs(h2s), _ptrs(proj_folded) if has_proj else None,
            _ptrs([t for idw in ids for t in idw])]
    kernel.launch(
        x, out, *[None if a is None else ctypes.addressof(a) for a in arrs],
        len(ids), n, h, w, cin, f, cout, s,
    )
    return out, bnds, h1s, h2s


def fused_stage_save(x, proj_folded, id_folded, stride=2):
    """The training chain: (out, bnds, h1s, h2s), every block's output (the
    last is `out`), h1 and h2 kept for the backward. The CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    ids = [tuple(w) for w in id_folded]
    if proj_folded is None and not ids:
        raise ValueError("a stage needs at least one block")
    if not check_device(x):
        return stage_save_plain(x, proj_folded, ids, stride)
    return chain_fwd_save_launch(KERNEL_SAVE_F32 if x.dtype == torch.float32 else KERNEL_SAVE, x, proj_folded, ids,
                                 stride)


def chain_wgrad_plans(n, h, w, cin, f, cout, stride, k, has_proj):
    """The chain backward's weight gradients as `wgrad_plan` takes them, in
    launch order: each identity block's (from the last), then the
    projection's."""
    s = stride if has_proj else 1
    plans = k * identity_wgrad_plans(n, h // s, w // s, cout, f)
    return plans + (projection_wgrad_plans(n, h, w, cin, f, cout, s) if has_proj else [])


def _check_bwd(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride):
    """(n, h, w, cin, f, cout, s) of a chain backward, its operands checked."""
    has_proj = proj_w is not None
    n, h, w, cin = x.shape
    s = stride if has_proj else 1
    f = (proj_w[0] if has_proj else id_w[0][0]).shape[1]
    cout = proj_w[2].shape[1] if has_proj else cin
    ho, wo = h // s, w // s
    check_channels(CIN=cin, F=f, COUT=cout)
    bf = kernel_dtype(x)
    check_cuda("x", x, bf)
    for name, t in [("g", g), ("out", out)] + [(f"bnd {b}", t) for b, t in enumerate(bnds)]:
        check_cuda(name, t, bf, (n, ho, wo, cout))
    for b, (t1, t2) in enumerate(zip(h1s, h2s)):
        check_cuda(f"h1 {b}", t1, bf, (n, h, w, f) if has_proj and b == 0 else (n, ho, wo, f))
        check_cuda(f"h2 {b}", t2, bf, (n, ho, wo, f))
    if has_proj:
        for name, t, shape in zip(("w1", "w2", "w3", "wsc"), proj_w,
                                  ((cin, f), (3, 3, f, f), (f, cout), (cin, cout))):
            check_cuda(f"projection {name}", t, bf, shape)
    for j, ws_ in enumerate(id_w):
        for name, t, shape in zip(("w1", "w2", "w3"), ws_, ((cout, f), (3, 3, f, f), (f, cout))):
            check_cuda(f"identity {j} {name}", t, bf, shape)
    return n, h, w, cin, f, cout, s


def chain_bwd_launch(kernel, x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx, ws_elems):
    """Launch a chain backward's C launcher (`kernel`, argus_stage_bwd's
    argument order) with its outputs and scratch allocated
    here; `ws_elems` f32 of weight-gradient workspace. Returns (dx or None,
    proj dws or None, [identity dws])."""
    id_w = [tuple(w) for w in id_w]
    has_proj = proj_w is not None
    n, h, w, cin, f, cout, s = _check_bwd(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride)
    ho, wo = h // s, w // s
    bf, dev = x.dtype, x.device
    f32 = dict(dtype=torch.float32, device=dev)
    proj_dws, proj_t = None, []
    if has_proj:
        proj_dws = (torch.empty((cin, f), **f32), torch.empty((3, 3, f, f), **f32),
                    torch.empty((f, cout), **f32), torch.empty((cin, cout), **f32))
        proj_t = proj_fused.transposed_weights(*proj_w, s)
    id_dws = [(torch.empty((cout, f), **f32), torch.empty((3, 3, f, f), **f32),
               torch.empty((f, cout), **f32)) for _ in id_w]
    id_t = [t for ws_ in id_w for t in block_fused.transposed_weights(*ws_)]
    ws = torch.empty(max(ws_elems, 1), **f32)
    m1 = torch.empty((n, h, w, f), dtype=bf, device=dev)
    m2 = torch.empty((n, ho, wo, f), dtype=bf, device=dev)
    gtmp = [torch.empty_like(out) for _ in range(min(has_proj + len(id_w), 2))]
    gtmp += [m2] * (2 - len(gtmp))  # unused slots: any valid pointer
    dx = torch.empty_like(x) if need_dx else None
    arrs = [_ptrs(bnds), _ptrs(h1s), _ptrs(h2s), _ptrs(proj_t) if has_proj else None, _ptrs(id_t),
            _ptrs(proj_dws) if has_proj else None, _ptrs([t for d in id_dws for t in d])]
    kernel.launch(
        x, g, out, *[None if a is None else ctypes.addressof(a) for a in arrs],
        dx, m1, m2, gtmp[0], gtmp[1], ws, ws_elems, len(id_w), n, h, w, cin, f, cout, s,
    )
    return dx, proj_dws, id_dws


def stage_bwd(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride=2, need_dx=True):
    """The chain backward from the saved residuals: (dx or None, proj dws
    (dw1, dw2, dw3, dwsc) or None, [(dw1, dw2, dw3), ...]), dw in f32.
    proj_w is (w1, w2, w3, wsc) or None, id_w [(w1, w2, w3), ...]. The CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    id_w = [tuple(w) for w in id_w]
    if not check_device(x):
        return stage_bwd_plain(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx)
    n, h, w, cin = x.shape
    f = (proj_w[0] if proj_w is not None else id_w[0][0]).shape[1]
    cout = proj_w[2].shape[1] if proj_w is not None else cin
    if x.dtype == torch.float32:
        problems = wgrad_plan.chain_mma_problems(n, h, w, cin, f, cout, stride, proj_w is not None)
        return chain_bwd_launch(KERNEL_BWD_F32, x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx,
                                wgrad_plan.mma_workspace(*problems))
    plans = chain_wgrad_plans(n, h, w, cin, f, cout, stride, len(id_w), proj_w is not None)
    return chain_bwd_launch(KERNEL_BWD, x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx,
                            wgrad_plan.workspace(*plans))


class _StageChain(torch.autograd.Function):
    """argus_tpu's `_stage_chain` custom VJP: the saving chain forward, then
    the chain backward; per-block weight gradients in the weights' dtype,
    zero bias cotangents. Inputs: x, stride, has_proj, then the flat folded
    weights (the projection's 8, then 6 per identity block)."""

    @staticmethod
    def forward(ctx, x, stride, has_proj, *flat):
        out, bnds, h1s, h2s = fused_stage_save(x, *split_flat(flat, has_proj), stride)
        ctx.nb, ctx.stride, ctx.has_proj = len(bnds), stride, has_proj
        ctx.biases = flat[1::2]
        # weights the backward reads: every block's w1, w2, w3 (and wsc)
        ctx.save_for_backward(x, out, *bnds, *h1s, *h2s, *flat[0::2])
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, out = saved[:2]
        nb, nblk = ctx.nb, ctx.nb + 1
        bnds = saved[2:2 + nb]
        h1s = saved[2 + nb:2 + nb + nblk]
        h2s = saved[2 + nb + nblk:2 + nb + 2 * nblk]
        ws = list(saved[2 + nb + 2 * nblk:])
        proj_w = tuple(ws[:4]) if ctx.has_proj else None
        rest = ws[4:] if ctx.has_proj else ws
        id_w = [tuple(rest[i:i + 3]) for i in range(0, len(rest), 3)]
        need = ctx.needs_input_grad
        dx, proj_dws, id_dws = stage_bwd(
            x, g.contiguous(), out, bnds, h1s, h2s, proj_w, id_w, ctx.stride, need[0]
        )
        dws = list(proj_dws or ()) + [d for ds in id_dws for d in ds]
        grads = []  # weights at even slots, biases at odd
        for j, (dw, w, b) in enumerate(zip(dws, ws, ctx.biases)):
            grads += [dw.to(w.dtype), zero_grad_of(need[4 + 2 * j], b)]
        return (dx, None, None, *grads)


def unpacked_view(x: torch.Tensor) -> torch.Tensor:
    """The packed stem's (N, H, W/2, 2C) view back as (N, H, W, C), no copy."""
    n, h, wp, c2 = x.shape
    if c2 % 2 or not x.is_contiguous():
        raise ValueError(f"a pair-packed input is a contiguous (N, H, W/2, 2C) view, got {tuple(x.shape)}")
    out = x.view(n, h, 2 * wp, c2 // 2)
    assert out.is_contiguous()
    return out


def stage_chain(x, proj_folded, id_folded, stride=2, x_packed: bool = False):
    """The chain as autograd sees it: the no-save forward when no input needs
    a gradient, else the saving chain with the kernel backward. `x_packed`:
    x is the packed stem's view (forward only, as in argus_tpu)."""
    ids = [tuple(w) for w in id_folded]
    flat = list(proj_folded or ()) + [t for idw in ids for t in idw]
    if x_packed:
        if needs_grad(x, *flat) or (proj_folded is not None and stride != 1):
            raise ValueError("a pair-packed chain input is forward only and stride 1")
        return fused_stage(unpacked_view(x), proj_folded, ids, stride)
    if needs_grad(x, *flat):
        return _StageChain.apply(x, stride, proj_folded is not None, *flat)
    return fused_stage(x, proj_folded, ids, stride)
