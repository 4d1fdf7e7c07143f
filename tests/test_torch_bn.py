"""The port's exact train-mode BatchNorm, its reduction kernels' plain
versions and the trained stem's plain versions against argus_tpu's, on the
CPU, with the same numpy inputs.

- `bn_reduce`: `fused_stats` / `fused_bn_bwd_reduce` against argus_tpu's
  Pallas kernels in interpret mode, C in {64, 128, 256} (lane-fold factors 2
  and 1), strides 1, 2 and 4, f32 and bf16, and the rows that do not tile
  (tests/test_norm.py's 49-row case): `n_rows` equal, the sums within 1e-5
  relative to each channel's sum of magnitudes (the same f32 sums in another
  order).
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
