"""The redesigned kernels in the form they had before their redesign
(`csrc/bwd_prev.cu`: the mma.sync conv-GEMM and weight gradient;
`csrc/bn_reduce.cu`'s `_prev` launchers: the two-launch BN reduction): the
BasicBlock, projection-block and identity-block backwards, the identity
block's recompute backward, the stage chain's backward, the BasicBlock,
identity bottleneck and projection forwards, the chain forwards, the
pointwise backward and forward, and BatchNorm's statistics (and the
backward reduction, `bn_bwd_reduce_prev`). No path of the port calls
these: `chip_smoke.py` and `scripts/time_torch_block_bwd.py` time them beside
`basic_fused.basic_bwd`, `proj_fused.proj_bwd`, `block_fused.block_bwd`,
`block_fused.block_bwd_recompute`, `stage_fused.stage_bwd`,
`basic_fused.basic_block`, `block_fused.bottleneck_block`,
`proj_fused.projection_block(_save)`, `stage_fused.fused_stage(_save)`,
`pointwise.pointwise_bwd`, `pointwise.pointwise_fwd` and
`bn_reduce.fused_stats` on the same inputs, in the same call. CUDA tensors
only; outputs as the redesigned wrappers give them.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel
from argus_tpu_torch.ops.kernels.wgrad_plan import (
    chain_mma_problems,
    identity_mma_problems,
    mma_workspace,
    projection_mma_problems,
)
from argus_tpu_torch.ops.kernels.block_fused import dgrad_w2
from argus_tpu_torch.ops.kernels.block_fused import transposed_weights as identity_transposed_weights
from argus_tpu_torch.ops.kernels.bn_reduce import visited_rows
from argus_tpu_torch.ops.kernels.proj_fused import forward_launch, transposed_weights
from argus_tpu_torch.ops.kernels.stage_fused import chain_bwd_launch, chain_fwd_launch, chain_fwd_save_launch

KERNEL_BASIC = Kernel("bwd_prev", "argus_basic_bwd_prev", [P] * 11 + [L] + [I] * 4 + [P])
KERNEL_PROJ = Kernel("bwd_prev", "argus_proj_bwd_prev", [P] * 17 + [L] + [I] * 7 + [P])
KERNEL_ID = Kernel("bwd_prev", "argus_block_bwd_prev", [P] * 15 + [L] + [I] * 5 + [P])
KERNEL_ID_R = Kernel("bwd_prev", "argus_block_rbwd_prev", [P] * 19 + [L] + [I] * 5 + [P])
KERNEL_STAGE = Kernel("bwd_prev", "argus_stage_bwd_prev", [P] * 16 + [L] + [I] * 8 + [P])
KERNEL_BASIC_FWD = Kernel("bwd_prev", "argus_basic_fwd_prev", [P] * 7 + [I] * 4 + [P])
KERNEL_BLOCK_FWD = Kernel("bwd_prev", "argus_block_fwd_prev", [P] * 10 + [I] * 5 + [P])
KERNEL_PW_BWD = Kernel("bwd_prev", "argus_pointwise_bwd_prev", [P] * 8 + [L] + [I] * 4 + [P])
KERNEL_PROJ_FWD = Kernel("bwd_prev", "argus_proj_fwd_prev", [P] * 12 + [I] * 7 + [P])
KERNEL_STAGE_FWD = Kernel("bwd_prev", "argus_stage_fwd_prev", [P] * 8 + [I] * 8 + [P])
KERNEL_STAGE_FWD_SAVE = Kernel("bwd_prev", "argus_stage_fwd_save_prev", [P] * 7 + [I] * 8 + [P])
KERNEL_PW_FWD = Kernel("bwd_prev", "argus_pointwise_fwd_prev", [P] * 5 + [I] * 4 + [P])
KERNEL_BN_STATS = Kernel("bn_reduce", "argus_bn_stats_prev", [P, P, P, L, L, L, I, I, I, P])
KERNEL_BN_BWD = Kernel("bn_reduce", "argus_bn_bwd_reduce_prev", [P] * 6 + [L, L, L, I, I, I, P])

def basic_bwd_prev(x, g, out, h1, w1, w2, need_dx=True):
    """(dx or None, dw1, dw2 in f32), as `basic_fused.basic_bwd`."""
    n, h, w, c = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    m1 = torch.empty_like(h1)
    dx = torch.empty_like(x) if need_dx else None
    dw1, dw2 = torch.empty((3, 3, c, c), **f32), torch.empty((3, 3, c, c), **f32)
    ws_elems = mma_workspace((n * h * w, c, c, 9))
    ws = torch.empty(max(ws_elems, 1), **f32)
    KERNEL_BASIC.launch(x, g, out, h1, dgrad_w2(w1, 1), dgrad_w2(w2, 1), dx, m1, dw1, dw2, ws, ws_elems, n, h, w, c)
    return dx, dw1, dw2


def proj_bwd_prev(x, g, out, h1, h2, w1, w2, w3, wsc, stride, need_dx=True):
    """(dx or None, dw1, dw2, dw3, dwsc in f32), as `proj_fused.proj_bwd`."""
    n, h, w, cin = x.shape
    f, cout = w1.shape[1], w3.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    m1, m2 = torch.empty_like(h1), torch.empty_like(h2)
    dx = torch.empty_like(x) if need_dx else None
    dw1, dw2 = torch.empty((cin, f), **f32), torch.empty((3, 3, f, f), **f32)
    dw3, dwsc = torch.empty((f, cout), **f32), torch.empty((cin, cout), **f32)
    ws_elems = mma_workspace(*projection_mma_problems(n, h, w, cin, f, cout, stride))
    ws = torch.empty(max(ws_elems, 1), **f32)
    KERNEL_PROJ.launch(x, g, out, h1, h2, *transposed_weights(w1, w2, w3, wsc, stride), dx, m1, m2, dw1, dw2, dw3,
                       dwsc, ws, ws_elems, n, h, w, cin, f, cout, stride)
    return dx, dw1, dw2, dw3, dwsc


def _identity_outputs(x, f, need_dx):
    n, h, w, cin = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    m1, m2 = (torch.empty((n, h, w, f), dtype=x.dtype, device=x.device) for _ in range(2))
    dx = torch.empty_like(x) if need_dx else None
    dws = (torch.empty((cin, f), **f32), torch.empty((3, 3, f, f), **f32), torch.empty((f, cin), **f32))
    ws_elems = mma_workspace(*identity_mma_problems(n, h, w, cin, f))
    return dx, m1, m2, dws, torch.empty(max(ws_elems, 1), **f32), ws_elems


def block_bwd_prev(x, g, out, h1, h2, w1, w2, w3, need_dx=True):
    """(dx or None, dw1, dw2, dw3 in f32), as `block_fused.block_bwd`."""
    n, h, w, cin = x.shape
    f = w1.shape[1]
    dx, m1, m2, dws, ws, ws_elems = _identity_outputs(x, f, need_dx)
    KERNEL_ID.launch(x, g, out, h1, h2, *identity_transposed_weights(w1, w2, w3), dx, m1, m2, *dws, ws, ws_elems,
                     n, h, w, cin, f)
    return (dx, *dws)


def block_bwd_recompute_prev(x, g, out, w1, b1, w2, b2, w3, b3, need_dx=True, recomputed=False):
    """(dx or None, dw1, dw2, dw3 in f32, and h1, h2 with `recomputed`), as
    `block_fused.block_bwd_recompute`."""
    n, h, w, cin = x.shape
    f = w1.shape[1]
    h1, h2 = (torch.empty((n, h, w, f), dtype=x.dtype, device=x.device) for _ in range(2))
    dx, m1, m2, dws, ws, ws_elems = _identity_outputs(x, f, need_dx)
    KERNEL_ID_R.launch(x, g, out, w1, b1, w2, b2, *identity_transposed_weights(w1, w2, w3), dx, h1, h2, m1, m2,
                       *dws, ws, ws_elems, n, h, w, cin, f)
    return (dx, *dws, h1, h2) if recomputed else (dx, *dws)


def stage_bwd_prev(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride=2, need_dx=True):
    """(dx or None, proj dws or None, [identity dws]), as `stage_fused.stage_bwd`."""
    n, h, w, cin = x.shape
    has_proj = proj_w is not None
    f = (proj_w[0] if has_proj else id_w[0][0]).shape[1]
    cout = proj_w[2].shape[1] if has_proj else cin
    ws_elems = mma_workspace(*chain_mma_problems(n, h, w, cin, f, cout, stride, has_proj))
    return chain_bwd_launch(KERNEL_STAGE, x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx, ws_elems)


def basic_fwd_prev(x, w1, b1, w2, b2, save=False):
    """out, or (out, h1) with `save`, as `basic_fused.basic_block(_save)`."""
    n, h, w, c = x.shape
    h1, out = torch.empty_like(x), torch.empty_like(x)
    KERNEL_BASIC_FWD.launch(x, h1, out, w1, b1, w2, b2, n, h, w, c)
    return (out, h1) if save else out


def block_fwd_prev(x, w1, b1, w2, b2, w3, b3, save=False):
    """out, or (out, h1, h2) with `save`, as `block_fused.bottleneck_block(_save)`."""
    n, h, w, cin = x.shape
    f = w1.shape[1]
    h1, h2 = (torch.empty((n, h, w, f), dtype=x.dtype, device=x.device) for _ in range(2))
    out = torch.empty_like(x)
    KERNEL_BLOCK_FWD.launch(x, h1, h2, out, w1, b1, w2, b2, w3, b3, n, h, w, cin, f)
    return (out, h1, h2) if save else out


def proj_fwd_prev(x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride, save=False):
    """out, or (out, h1, h2) with `save`, as `proj_fused.projection_block(_save)`."""
    got = forward_launch(KERNEL_PROJ_FWD, x, w1, b1, w2, b2, w3, b3, wsc, bsc, stride)
    return got if save else got[0]


def stage_fwd_prev(x, proj_folded, id_folded, stride=2):
    """out, as `stage_fused.fused_stage`."""
    return chain_fwd_launch(KERNEL_STAGE_FWD, x, proj_folded, [tuple(w) for w in id_folded], stride)


def stage_fwd_save_prev(x, proj_folded, id_folded, stride=2):
    """(out, bnds, h1s, h2s), as `stage_fused.fused_stage_save`."""
    return chain_fwd_save_launch(KERNEL_STAGE_FWD_SAVE, x, proj_folded, [tuple(w) for w in id_folded], stride)


def pointwise_bwd_prev(g2, out2, x2, w, relu=True, emit_m=False, need_dx=True):
    """(dx or None, dw in f32, m or None), as `pointwise.pointwise_bwd`."""
    m, cin = x2.shape
    cout = w.shape[1]
    dx = torch.empty_like(x2) if need_dx else None
    dw = torch.empty((cin, cout), dtype=torch.float32, device=x2.device)
    mm = torch.empty_like(g2) if emit_m and relu else None
    ws_elems = mma_workspace((m, cin, cout, 1))
    ws = torch.empty(max(ws_elems, 1), dtype=torch.float32, device=x2.device)
    KERNEL_PW_BWD.launch(g2, out2, x2, w.t().contiguous(), dx, dw, mm, ws, ws_elems, m, cin, cout, int(relu))
    return dx, dw, (mm if relu else g2) if emit_m else None


def pointwise_fwd_prev(x2, w, b, res2=None, relu=True):
    """out (M, COUT), as `pointwise.pointwise_fwd`."""
    m, cin = x2.shape
    cout = w.shape[1]
    out = torch.empty((m, cout), dtype=torch.bfloat16, device=x2.device)
    KERNEL_PW_FWD.launch(x2, w, b, res2, out, m, cin, cout, int(relu))
    return out


_BN_TARGET_BLOCKS, _BN_MIN_ROWS = 4 * 132, 1024  # the two-launch reduction's split rule


def _bn_prev_args(x, stride):
    C = x.shape[-1]
    R, S, n = visited_rows(x.numel() // C, C, stride)
    vec = 16 // x.element_size()
    slabs = -(-C // (32 * vec))
    splits = max(1, min(-(-n // _BN_MIN_ROWS), _BN_TARGET_BLOCKS // slabs))
    ws = torch.empty((splits, 2, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    return ws, out, (n, R, S, C, int(x.dtype == torch.float32), splits), n


def bn_stats_prev(x, stride=1):
    """(sum x, sum x^2, n_rows), as `bn_reduce.fused_stats`: the fixed grid of
    register loads, then a second launch adding the partials."""
    ws, out, ints, n = _bn_prev_args(x, stride)
    KERNEL_BN_STATS.launch(x, ws, out, *ints)
    return out[0], out[1], n


def bn_bwd_reduce_prev(x, dy, mean, rstd, stride=1):
    """(sum dy, sum dy * xhat, n_rows), as `bn_reduce.fused_bn_bwd_reduce`."""
    ws, out, ints, n = _bn_prev_args(x, stride)
    KERNEL_BN_BWD.launch(x, dy, mean, rstd, ws, out, *ints)
    return out[0], out[1], n
