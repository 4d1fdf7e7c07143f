"""The port's exact train-mode BatchNorm, its reduction kernels' plain
versions and the trained stem's plain versions against argus_tpu's, on the
CPU, with the same numpy inputs.

- `bn_reduce`: `fused_stats` / `fused_bn_bwd_reduce` against argus_tpu's
  Pallas kernels in interpret mode, C in {64, 128, 256} (lane-fold factors 2
  and 1), strides 1, 2 and 4, f32 and bf16, and the rows that do not tile
  (tests/test_norm.py's 49-row case): `n_rows` equal, the sums within 1e-5
  relative to each channel's sum of magnitudes (the same f32 sums in another
  order).
- the one-launch reduction's plan (`bn_reduce.stats_plan`, the cut
  csrc/bn_reduce.cu's `stream_kernel` walks), simulated in numpy: the
  blocks' runs of boxes, the strided box coordinates (a block of R rows
  every S), TMA's zero fill past M and past C, each consumer thread's rows
  of a box, the row groups added in order, the last block's ordered sum of
  the partials in runs; at strides 1 and 4, M that no box or block divides,
  C not a power of two, bf16 and f32, the statistics and the backward: every
  visited row read exactly once and no other, the sums bit for bit a
  scalar f32 sum in the same nested order, and within the tolerance above
  of argus_tpu's kernels in interpret mode. The plan is cached per (M, C,
  stride, dtype, streams) and visits the rows `visited_rows` gives.
- `BatchNorm` in train mode against argus_tpu's, engines "xla" and "pallas"
  (argus_tpu's kernels in interpret mode), strides (stats, grad) in {(1, 1),
  (2, 1), (1, 2), (2, 2)}, f32 and bf16: the output, the updated running
  mean and var, and dx, dscale, dbias for one cotangent. f32: 1e-5 on the
  output and the statistics, 1e-4 on the gradients, relative to the largest
  value (sums in another order). bf16: relative 2-norm 1e-2 on the output and
  dx (both round each op to bf16 at the same points, a rounding of an f32
  sum taken in another order can land one ulp, 2^-8, apart), the f32
  statistics and dscale/dbias 2e-3 (they reduce the same bf16 values).
  `_Moments` and `_Affine` give plain autograd's values and gradients bit
  for bit (in f32 dx up to the order of its three terms).
- the stem: the plain saving forward and weight gradient against
  `jax.grad` through argus_tpu's `fused_stem_pool(..., impl="pallas",
  interpret=True)`, on bf16 inputs quantised so that the conv sums are exact
  in f32 and the pool windows hold tied positive maxima (blockwise-constant
  images): `out` and `y` (argus_tpu's parity-packed `yg` unpacked) equal, dW
  within 1.6e-2 of max |dW| (argus_tpu rounds each of the four parity
  partials of dW to bf16 before the packing sums them; the port rounds the
  sum once: 4 + 1 half-ulps of 2^-8) and 5e-3 in relative 2-norm, at
  grad_stride 1 and 2; in f32 1e-5.
- `F.max_pool2d`'s backward on plateaus against flax's `nn.max_pool` (the
  unfused stem's pool): the same first-match routing, bit for bit.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from argus_tpu.models.resnet import space_to_depth
from argus_tpu.ops import norm as jnorm
from argus_tpu.ops.pallas import bn_reduce as jbr
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu_torch.ops import norm as tnorm
from argus_tpu_torch.ops.kernels import bn_reduce as tbr
from argus_tpu_torch.ops.kernels import stem_fused as ts

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dt])


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(t, torch.Tensor) else t.float().numpy()


def _sums_close(got, want, scale, rtol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=rtol * float(np.abs(scale).max()) + 1e-6)


# ─────────────────────────────── bn_reduce ───────────────────────────────


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_bn_reduce_matches_pallas(c, dt):
    rng = np.random.default_rng(c)
    shape = (4, 16, 32, c)  # 2048 rows: several row blocks of argus_tpu's grid at strides 2 and 4
    jx, tx = _pair(rng.normal(0.5, 2.0, shape), dt)
    jdy, tdy = _pair(rng.normal(0, 1, shape), dt)
    mean = rng.normal(0, 1, c).astype(np.float32)
    rstd = rng.uniform(0.5, 2, c).astype(np.float32)
    mag = np.abs(np.asarray(tx.float())).reshape(-1, c)
    for stride in (1, 2, 4):
        s, q, n = tbr.fused_stats(tx, stride)
        js_, jq, jn = jbr.fused_stats(jx, stride=stride, interpret=True)
        assert n == jn, (stride, n, jn)
        _sums_close(s, js_, mag.sum(0))
        _sums_close(q, jq, (mag * mag).sum(0))
        sd, sdx, n2 = tbr.fused_bn_bwd_reduce(tx, tdy, torch.from_numpy(mean), torch.from_numpy(rstd), stride)
        jsd, jsdx, jn2 = jbr.fused_bn_bwd_reduce(jx, jdy, jnp.asarray(mean), jnp.asarray(rstd), stride=stride,
                                                 interpret=True)
        assert n2 == jn2 == n
        dmag = np.abs(np.asarray(tdy.float())).reshape(-1, c)
        _sums_close(sd, jsd, dmag.sum(0))
        _sums_close(sdx, jsdx, (dmag * np.abs((mag + np.abs(mean)) * rstd)).sum(0))
    # a stride visits argus_tpu's row blocks, not every s-th row
    assert tbr.visited_rows(2048, c, 4)[2] < 2048


def test_bn_reduce_rows_that_do_not_tile():
    """stride 1 reads every row for any M (argus_tpu falls back to a plain
    reduction there): tests/test_norm.py's 49 rows, and an odd M with C < 128."""
    rng = np.random.default_rng(3)
    for shape in ((1, 7, 7, 128), (1, 7, 7, 64)):
        x = rng.normal(0, 1, shape).astype(np.float32)
        dy = rng.normal(0, 1, shape).astype(np.float32)
        mean = rng.normal(0, 1, shape[-1]).astype(np.float32)
        rstd = rng.uniform(0.5, 2, shape[-1]).astype(np.float32)
        s, q, n = tbr.fused_stats(torch.from_numpy(x), 1)
        sd, sdx, n2 = tbr.fused_bn_bwd_reduce(torch.from_numpy(x), torch.from_numpy(dy), torch.from_numpy(mean),
                                              torch.from_numpy(rstd), 1)
        assert n == n2 == 49
        x2, dy2 = x.reshape(-1, shape[-1]), dy.reshape(-1, shape[-1])
        np.testing.assert_allclose(s.numpy(), x2.sum(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(q.numpy(), (x2 ** 2).sum(0), rtol=1e-5)
        np.testing.assert_allclose(sd.numpy(), dy2.sum(0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sdx.numpy(), (dy2 * (x2 - mean) * rstd).sum(0), rtol=1e-4, atol=1e-4)
        if shape[-1] == 128:
            js_, jq, jn = jbr.fused_stats(jnp.asarray(x), stride=1, interpret=True)
            assert jn == 49
            np.testing.assert_allclose(s.numpy(), np.asarray(js_), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tbr.fused_stats(torch.zeros(1, 7, 7, 64), 2)  # argus_tpu cannot fold 49 rows of 64 channels


# ─────────────────────── the one-launch reduction's plan ───────────────────────

F32 = np.float32


def _stream_sums(x, plan, itemsize, bwd=None):
    """csrc/bn_reduce.cu `stream_kernel` on the plan, in numpy f32: (the two
    sums (2, C), reads per (row, channel) of x). x (M, C) float32 values;
    bwd = (dy, mean, rstd) for the backward's sums."""
    M, C = x.shape
    VR = plan.slab // (16 // itemsize)  # a box row's 16-byte vectors
    G = 256 // VR  # row groups
    reads = np.zeros((M, C), np.int64)
    partial = np.zeros((plan.grid, 2, plan.slab), F32)
    for b in range(plan.grid):
        slab, split = b % plan.nslab, b // plan.nslab
        cols = slab * plan.slab + np.arange(plan.slab)
        cin = cols < C
        mu = np.where(cin, bwd[1][np.minimum(cols, C - 1)], 0).astype(F32) if bwd else None
        rs = np.where(cin, bwd[2][np.minimum(cols, C - 1)], 0).astype(F32) if bwd else None
        s0, s1 = np.zeros((G, plan.slab), F32), np.zeros((G, plan.slab), F32)
        i0, i1 = split * plan.per, min(split * plan.per + plan.per, plan.boxes)
        blk, rb = divmod(i0, plan.bpr)  # the producer's walk: one division, then steps
        for _ in range(i0, i1):
            rows = rb * plan.box_rows + np.arange(plan.box_rows)  # rows of the visited block
            rin = (rows < plan.R) & (blk < plan.nblk)  # TMA's zero fill outside the map
            phys = blk * plan.S + rows
            box = np.zeros((plan.box_rows, plan.slab), F32)
            box[np.ix_(rin, cin)] = x[np.ix_(phys[rin], cols[cin])]
            reads[np.ix_(phys[rin], cols[cin])] += 1
            if bwd:
                dbox = np.zeros_like(box)
                dbox[np.ix_(rin, cin)] = bwd[0][np.ix_(phys[rin], cols[cin])]
            for k0 in range(0, plan.box_rows, G):  # thread g adds row k0 + g
                n = min(G, plan.box_rows - k0)
                xv = box[k0:k0 + n]
                if bwd:
                    gv = dbox[k0:k0 + n]
                    s0[:n] = s0[:n] + gv
                    s1[:n] = s1[:n] + gv * ((xv - mu) * rs)
                else:
                    s0[:n] = s0[:n] + xv
                    s1[:n] = s1[:n] + xv * xv
            rb += 1
            if rb == plan.bpr:
                rb, blk = 0, blk + 1
        for q, sq in enumerate((s0, s1)):  # the row groups in group order
            t = np.zeros(plan.slab, F32)
            for g in range(G):
                t = t + sq[g]
            partial[b, q] = t
    out = np.zeros((2, C), F32)
    L = -(-plan.splits // plan.runs)
    c = np.arange(C)
    for q in range(2):
        runs = []
        for k in range(plan.runs):
            t = np.zeros(C, F32)
            for sp in range(k * L, min((k + 1) * L, plan.splits)):
                t = t + partial[sp * plan.nslab + c // plan.slab, q, c % plan.slab]
            runs.append(t)
        t = np.zeros(C, F32)
        for r in runs:
            t = t + r
        out[q] = t
    return out, reads


def _ordered_sum(x, plan, itemsize, c, q, bwd=None):
    """Channel c's sum q as one scalar f32 sum in the kernel's nested order:
    runs of splits, row groups, then each group's rows box by box."""
    VR = plan.slab // (16 // itemsize)
    G = 256 // VR
    slab = c // plan.slab

    def term(row):
        if bwd is None:
            v = F32(x[row, c])
            return v if q == 0 else F32(v * v)
        g = F32(bwd[0][row, c])
        return g if q == 0 else F32(g * F32(F32(F32(x[row, c]) - F32(bwd[1][c])) * F32(bwd[2][c])))

    def block_sum(split):
        groups = []
        for g in range(G):
            t = F32(0)
            for i in range(split * plan.per, min(split * plan.per + plan.per, plan.boxes)):
                blk, rb = divmod(i, plan.bpr)
                for r in range(g, plan.box_rows, G):
                    row = rb * plan.box_rows + r
                    if row < plan.R:
                        t = F32(t + term(blk * plan.S + row))
                    else:
                        t = F32(t + F32(0))
            groups.append(t)
        t = F32(0)
        for v in groups:
            t = F32(t + v)
        return t

    L = -(-plan.splits // plan.runs)
    total = F32(0)
    for k in range(plan.runs):
        t = F32(0)
        for sp in range(k * L, min((k + 1) * L, plan.splits)):
            t = F32(t + block_sum(sp))
        total = F32(total + t)
    return total


# (M, C, stride): M that no box and no block divides (2500 rows), C below
# and above a 256-byte slab and not a power of two (72, 136), argus_tpu's
# row blocks at stride 4 (R = 1024 of every 4096 rows at C = 64), and C =
# 4096, where the last block's sum is one run a column (C / 2 > 256)
PLAN_CASES = [(2500, 64, 1), (2500, 256, 1), (2500, 72, 1), (2504, 136, 1), (8192, 64, 4), (4096, 256, 4),
              (520, 4096, 1), (1024, 4096, 4)]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,c,stride", PLAN_CASES)
def test_bn_stream_plan_reads_each_visited_row_once_in_a_fixed_order(m, c, stride, dt):
    rng = np.random.default_rng(m + c + stride)
    jx, tx = _pair(rng.normal(0.5, 2.0, (m, c)), dt)
    jdy, tdy = _pair(rng.normal(0, 1, (m, c)), dt)
    mean = rng.normal(0, 1, c).astype(np.float32)
    rstd = rng.uniform(0.5, 2, c).astype(np.float32)
    x, dy = tx.float().numpy(), tdy.float().numpy()
    itemsize = tx.element_size()
    R, S, n = tbr.visited_rows(m, c, stride)
    visited = np.zeros(m, bool)
    for blk in range(n // R):
        visited[blk * S: blk * S + R] = True
    mag = np.abs(x[visited])
    for tensors, bwd in ((1, None), (2, (dy, mean, rstd))):
        plan = tbr.stats_plan(m, c, stride, itemsize, tensors)
        assert (plan.R, plan.S, plan.n_rows) == (R, S, n) and plan.nblk * R == n
        assert plan.grid > 1  # several blocks, and the last one's ordered sum
        assert tensors * plan.box_rows * plan.slab * itemsize <= 16384 and plan.slab * itemsize <= 256
        got, reads = _stream_sums(x, plan, itemsize, bwd)
        assert (reads[visited] == 1).all() and (reads[~visited] == 0).all()
        for cc in sorted({0, c // 2, c - 1}):
            for q in (0, 1):
                assert got[q, cc] == _ordered_sum(x, plan, itemsize, cc, q, bwd)
        if bwd is None:
            js_, jq, jn = jbr.fused_stats(jx, stride=stride, interpret=True)
            scales = (mag.sum(0), (mag * mag).sum(0))
        else:
            js_, jq, jn = jbr.fused_bn_bwd_reduce(jx, jdy, jnp.asarray(mean), jnp.asarray(rstd), stride=stride,
                                                  interpret=True)
            dmag = np.abs(dy[visited])
            scales = (dmag.sum(0), (dmag * np.abs((mag + np.abs(mean)) * rstd)).sum(0))
        assert jn == n
        _sums_close(got[0], js_, scales[0])
        _sums_close(got[1], jq, scales[1])


def test_bn_stream_plan_is_cached_per_shape_and_visits_visited_rows():
    for m, c, stride in PLAN_CASES:
        for itemsize in (2, 4):
            plan = tbr.stats_plan(m, c, stride, itemsize)
            assert plan is tbr.stats_plan(m, c, stride, itemsize)
            assert (plan.R, plan.S, plan.n_rows) == tbr.visited_rows(m, c, stride)
            assert plan.boxes == plan.nblk * plan.bpr and (plan.splits - 1) * plan.per < plan.boxes
    # ResNet-50's largest: one block an SM, boxes of 16 KB
    plan = tbr.stats_plan(512 * 128 * 128, 64, 1, 2)
    assert (plan.grid, plan.box_rows * plan.slab * 2) == (132, 16384)
    # any width: past 512 channels the final sum is one run a column, so the
    # launcher's bound on the staged runs (2 C runs <= 4096 floats) does not
    # apply, and C = 4096 or more is planned like any other
    for c in (1024, 2048, 4096, 8192):
        for itemsize in (2, 4):
            for tensors in (1, 2):
                plan = tbr.stats_plan(8192, c, 1, itemsize, tensors)
                assert plan.runs == 1 if c > 512 else 2 * c * plan.runs <= 4096
                assert plan.nslab * plan.slab >= c and plan.slab * itemsize <= 256


@pytest.mark.parametrize("private", [True, False], ids=["private", "public"])
def test_launch_stream_lookup_uses_the_public_api_where_the_private_is_missing(monkeypatch, private):
    """Every launch (the BN reductions' tickets too) reads the current stream
    through `_build._stream_api`: torch's private calls where this torch has
    them, else `torch.cuda.current_stream` and `current_device`."""
    from argus_tpu_torch.ops.kernels import _build

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, fake in (("_cuda_getCurrentRawStream", lambda index: 5678), ("_cuda_getDevice", lambda: 0)):
        if private:
            monkeypatch.setattr(torch._C, name, fake, raising=False)
        else:
            monkeypatch.delattr(torch._C, name, raising=False)
    _build._stream_api.cache_clear()
    try:
        stream_of, device = _build._stream_api()
        assert (_build.current_stream(0), device()) == ((5678 if private else 1234), 0)
    finally:
        _build._stream_api.cache_clear()


# ─────────────────────────────── BatchNorm ───────────────────────────────

STRIDES = [(1, 1), (2, 1), (1, 2), (2, 2)]


def _jax_bn(x, g, params, stats, **kw):
    """argus_tpu's train-mode BatchNorm: (y, new stats, dx, dparams)."""
    m = jnorm.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, **kw)

    def f(p, xv):
        y, mut = m.apply({"params": p, "batch_stats": stats}, xv, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * g), (y, mut["batch_stats"])

    (_, (y, new)), (dp, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    return y, new, dx, dp


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("stats_stride,grad_stride", STRIDES)
def test_batchnorm_train_matches_argus_tpu(impl, stats_stride, grad_stride, dt):
    rng = np.random.default_rng(7)
    c = 64
    shape = (4, 16, 8, c)
    x = rng.normal(0.3, 1.5, shape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.1, c).astype(np.float32)
    rm, rv = rng.normal(0, 0.1, c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)

    jx, tx = _pair(x, dt)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}
    jy, jnew, jdx, jdp = _jax_bn(jx, jnp.asarray(g), params, stats, stats_stride=stats_stride,
                                 grad_stride=grad_stride, impl=impl)

    bn = tnorm.BatchNorm(c, momentum=0.9, stats_stride=stats_stride, grad_stride=grad_stride, impl=impl)
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, rm), (bn.running_var, rv)):
            t.copy_(torch.from_numpy(a))
    tx.requires_grad_(True)
    ty = bn(tx, batch_stats=True)
    (ty.float() * torch.from_numpy(g)).sum().backward()

    if dt == "f32":
        def close(got, want, tol):
            w = _np(want)
            np.testing.assert_allclose(_np(got), w, rtol=0, atol=tol * np.abs(w).max())
        close(ty.detach(), jy, 1e-5)
        close(bn.running_mean, jnew["mean"], 1e-5)
        close(bn.running_var, jnew["var"], 1e-5)
        close(tx.grad, jdx, 1e-4)
        close(bn.weight.grad, jdp["scale"], 1e-4)
        close(bn.bias.grad, jdp["bias"], 1e-4)
    else:
        def rel(got, want, tol):
            a, b = _np(got), _np(want)
            assert np.linalg.norm(a - b) <= tol * np.linalg.norm(b), (np.linalg.norm(a - b) / np.linalg.norm(b))
        rel(ty.detach(), jy, 1e-2)
        rel(tx.grad, jdx, 1e-2)
        rel(bn.running_mean, jnew["mean"], 2e-3)
        rel(bn.running_var, jnew["var"], 2e-3)
        # autodiff's dscale/dbias are the broadcasts' cotangents, reduced in
        # bf16: XLA's sum sits 2.6e-2 from the exact one, the port's
        # (f32-accumulated, rounded once) 1.6e-3
        autodiff = impl == "xla" and (stats_stride, grad_stride) == (1, 1)
        rel(bn.weight.grad, jdp["scale"], 4e-2 if autodiff else 2e-3)
        rel(bn.bias.grad, jdp["bias"], 4e-2 if autodiff else 2e-3)
        if autodiff:
            rel(bn.bias.grad, torch.from_numpy(g).to(torch.bfloat16).float().reshape(-1, c).sum(0), 2 ** -8)
    assert ty.dtype == TDT[dt] and tx.grad.dtype == TDT[dt]


def test_running_statistics_only_move_in_train_mode():
    """An eval forward never updates the statistics, whatever
    nn.Module.training says; a train forward updates them with flax's
    momentum and the biased variance, also under no_grad."""
    bn = tnorm.BatchNorm(8)
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0)) * 2 + 1
    bn.train()
    bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(8)) and torch.equal(bn.running_var, torch.ones(8))
    with torch.no_grad():
        bn(x, batch_stats=True)
    xf = x.reshape(-1, 8)
    var = (xf * xf).mean(0) - xf.mean(0) ** 2
    torch.testing.assert_close(bn.running_mean, 0.1 * xf.mean(0))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_memory_lean_functions_match_autograd_bit_for_bit(dt):
    """`_Moments` and `_Affine` (what the "xla" engine differentiates
    through) against autograd through the plain expressions."""
    g = torch.Generator().manual_seed(1)
    x0 = (torch.randn(2, 6, 5, 16, generator=g) * 2 + 0.5).to(dt)
    m0, r0, s0, b0 = (torch.randn(16, generator=g).to(dt) for _ in range(4))
    dy = torch.randn(2, 6, 5, 16, generator=g).to(dt)
    wm, wq = torch.randn(16, generator=g), torch.randn(16, generator=g)

    def run(moments, affine):
        x, m, r, s, b = (t.clone().requires_grad_(True) for t in (x0, m0, r0, s0, b0))
        mean, msq = moments(x)
        y = affine(x, m, r, s, b)
        torch.autograd.backward([mean, msq, y], [wm, wq, dy])
        return [mean, msq, y] + [t.grad for t in (x, m, r, s, b)]

    red = (0, 1, 2)

    def moments(x):
        x32 = x.float()
        return x32.mean(red), x32.square().mean(red)

    plain = run(moments, lambda x, m, r, s, b: ((x - m) * r) * s + b)
    lean = run(tnorm._Moments.apply, tnorm._Affine.apply)
    for i, (a, b) in enumerate(zip(lean, plain)):
        if i == 3 and dt == torch.float32:
            # x.float() is x itself in f32: autograd adds the three cotangents
            # reaching x (mean, mean of squares, affine) in its own order
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a, b), i


# ─────────────────────────────── the stem ───────────────────────────────


def _stem_inputs(dt: str, n: int = 4, hw: int = 32):
    """Blockwise-constant images with values in quarters and dyadic weights:
    the conv sums are exact in f32 (no order dependence) and the relu output
    has plateaus, so pool windows hold tied positive maxima."""
    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 5, (n, hw // 16, hw // 16, 3)) / 4.0
    x = np.repeat(np.repeat(blocks, 16, 1), 16, 2).astype(np.float32)
    k7 = (rng.integers(-4, 5, (7, 7, 3, 64)) / 32.0).astype(np.float32)
    bias = (rng.integers(0, 4, 64) / 8.0).astype(np.float32)
    g = rng.normal(0, 1, (n, hw // 4, hw // 4, 64)).astype(np.float32)
    return x, k7, bias, g


def _jax_stem(x, k7, bias, g, dt, grad_stride):
    """argus_tpu's Pallas stem (interpret mode): out, the saved yg unpacked
    to (N, H/2, W/2, 64), and dW. The BN is the identity fold (scale 1,
    mean 0, var 1, eps 0: c = 1 exactly) plus `bias`."""
    ones, zeros = jnp.ones(64), jnp.zeros(64)
    jx, jk = jnp.asarray(x, JDT[dt]), jnp.asarray(k7)

    def loss(kv):
        out = js.fused_stem_pool(jx, kv, ones, jnp.asarray(bias), zeros, ones, eps=0.0, impl="pallas",
                                 interpret=True, grad_stride=grad_stride)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g)), out

    (_, out), dw = jax.value_and_grad(loss, has_aux=True)(jk)
    w, b = js.pack_stem_weights(jk, ones, jnp.asarray(bias), zeros, ones, 0.0, JDT[dt])
    _, yg = js._stem_fwd_save_pallas(space_to_depth(jx, 4), w, b, True)
    n, u, v, _ = yg.shape
    y = yg.reshape(n, u, v, 2, 2, 64).transpose(0, 1, 3, 2, 4, 5).reshape(n, 2 * u, 2 * v, 64)
    return out, y, dw


@pytest.mark.parametrize("dt,grad_stride", [("bf16", 1), ("bf16", 2), ("f32", 1)])
def test_stem_save_and_weight_gradient_match_pallas(dt, grad_stride):
    x, k7, bias, g = _stem_inputs(dt)
    jout, jy, jdw = _jax_stem(x, k7, bias, g, dt, grad_stride)

    tx = torch.from_numpy(x).to(TDT[dt])
    w = torch.from_numpy(k7).to(TDT[dt])
    b = torch.from_numpy(bias).reshape(1, 64)
    out, y = ts.stem_fwd_save(tx, w, b)
    np.testing.assert_array_equal(_np(out), _np(jout))
    np.testing.assert_array_equal(_np(y), _np(jy))
    # the pool windows hold tied positive maxima: the routing is exercised
    yp = F.pad(y.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    win = F.unfold(yp[:, :1].contiguous(), 3, stride=2)[:, :, : out.shape[1] * out.shape[2]]
    ties = ((win == win.max(1, keepdim=True).values) & (win > 0)).sum(1)
    assert (ties > 1).float().mean() > 0.2

    # the port's trained stem: its fold (identity BN) and the kernel Function
    k = torch.from_numpy(k7).requires_grad_(True)
    ones, zeros = torch.ones(64), torch.zeros(64)
    tout = ts.fused_stem_pool(tx, k, ones, torch.from_numpy(bias), zeros, ones, eps=0.0, grad_stride=grad_stride)
    (tout.float() * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(tout, out, rtol=0, atol=0)
    got, want = k.grad.numpy(), _np(jdw)
    tol = 1.6e-2 if dt == "bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    assert np.linalg.norm(got - want) <= (5e-3 if dt == "bf16" else 1e-5) * np.linalg.norm(want)


def test_stem_grad_stride_reads_the_first_images():
    """grad_stride 2's dW is 2x the first half's and does not read the
    second half; a stride that does not divide the batch falls back to 1."""
    x, k7, bias, g = _stem_inputs("f32")
    tx, w, b = torch.from_numpy(x), torch.from_numpy(k7), torch.from_numpy(bias).reshape(1, 64)
    out, y = ts.stem_fwd_save(tx, w, b)
    tg = torch.from_numpy(g)
    half = ts.stem_bwd(tx, tg, out, y, 2)
    junk = [t.clone() for t in (tx, tg, out, y)]
    for t in junk:
        t[2:] = float("nan")
    torch.testing.assert_close(ts.stem_bwd(*junk, 2), half, rtol=0, atol=0)
    w.requires_grad_(True)
    (ts.stem_pool(tx[:3], w, b, grad_stride=2).float() * tg[:3]).sum().backward()
    torch.testing.assert_close(w.grad, ts.stem_bwd(tx[:3], tg[:3], out[:3], y[:3], 3))


def test_max_pool_ties_route_like_flax():
    """The unfused stem's `F.max_pool2d` (NHWC viewed channels-last) sends a
    plateau's cotangent to the first maximum in row-major order, as the
    gradient of flax's `nn.max_pool` does."""
    rng = np.random.default_rng(5)
    x = np.repeat(np.repeat(rng.integers(0, 3, (2, 4, 4, 8)), 4, 1), 4, 2).astype(np.float32)
    g = rng.normal(0, 1, (2, 8, 8, 8)).astype(np.float32)

    def jloss(xv):
        return jnp.sum(fnn.max_pool(xv, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))) * g)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = F.max_pool2d(tx.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), want)
    assert (want != 0).sum() < (g != 0).sum() * 1.01  # one winner per window: no tie was split
