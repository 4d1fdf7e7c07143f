"""The port's four kernel functions (argus_tpu_torch.ops.kernels) against the
argus_tpu Pallas kernels they replace, run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests pin the arithmetic and the rounding points that the CUDA kernels are
then held to on the card (`chip_smoke.py`, tests/test_torch_cuda.py). Inputs
are made with numpy from a seed and fed to both packages. Every BN buffer is
perturbed, so a broken conv3 path cannot hide behind the identity.

Tolerances: f32 at rtol 2e-4 / atol 1e-4 (the same sums in another order:
the TPU kernels' tap-by-tap dots and packed layouts vs PyTorch's convs);
bf16 at 2e-2 (one bf16 ulp is 2^-8 relative, and the two sides may round a
value on either side of a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import block_fused as jb
from argus_tpu.ops.pallas import proj_fused as jp
from argus_tpu.ops.pallas import stage_fused as jst
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu_torch.ops import kernels
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import proj_fused as tp
from argus_tpu_torch.ops.kernels import stage_fused as tst
from argus_tpu_torch.ops.kernels import stem_fused as ts

F32_TOL = dict(rtol=2e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bn(rng, c):
    """Perturbed frozen-BN buffers (scale, bias, mean, var)."""
    return [
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        rng.normal(0, 0.1, c).astype(np.float32),
        rng.normal(0, 0.1, c).astype(np.float32),
        rng.uniform(0.5, 1.5, c).astype(np.float32),
    ]


def _kernel(rng, *shape):
    return (rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)


def _conv_bn(rng, *shape):
    return [_kernel(rng, *shape), *_bn(rng, shape[-1])]


def _j(a, dt=jnp.float32):
    return jnp.asarray(a).astype(dt)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.array(a)).to(dt)


def _check(got: torch.Tensor, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _block_args(rng, cin, f, cout, projection):
    args = _conv_bn(rng, 1, 1, cin, f) + _conv_bn(rng, 3, 3, f, f) + _conv_bn(rng, 1, 1, f, cout)
    if projection:
        args += _conv_bn(rng, 1, 1, cin, cout)
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    args = _conv_bn(rng, 7, 7, 3, 64)
    want = js.fused_stem_pool(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True)
    got = ts.fused_stem_pool(_t(x, tdt), *map(_t, args))
    assert got.dtype == tdt
    _check(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_block_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    args = _block_args(rng, 64, 16, 64, projection=False)
    want = jb.fused_bottleneck_block(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True)
    got = tb.fused_bottleneck_block(_t(x, tdt), *map(_t, args))
    _check(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_matches_pallas(stride):
    rng = np.random.default_rng(2 + stride)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    args = _block_args(rng, 32, 16, 64, projection=True)
    want = jp.fused_projection_block(
        _j(x), *map(_j, args), stride=stride, impl="pallas", interpret=True
    )
    got = tp.fused_projection_block(_t(x), *map(_t, args), stride=stride)
    assert tuple(got.shape) == (2, 8 // stride, 8 // stride, 64)
    _check(got, want, F32_TOL)


def test_stage0_chain_matches_packed_pallas(monkeypatch):
    """Stage-0 geometry (cin = f = 64, cout = 256, stride 1): argus_tpu routes
    it through the pair-packed `_chain_fwd_packed`, the kernel the port's
    chain replaces."""
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    proj_raw = _block_args(rng, 64, 64, 256, projection=True)
    ids_raw = [_block_args(rng, 256, 64, 256, projection=False) for _ in range(2)]
    jproj = jp.fold_projection_params(jnp.float32, *map(_j, proj_raw))
    jids = [jb.fold_bottleneck_params(jnp.float32, *map(_j, r)) for r in ids_raw]
    hits = []
    orig = jst._chain_fwd_packed
    monkeypatch.setattr(
        jst, "_chain_fwd_packed", lambda *a, **k: (hits.append(1), orig(*a, **k))[1]
    )
    want = jst.fused_stage(_j(x), jproj, jids, stride=1, impl="pallas", interpret=True)
    assert hits, "argus_tpu did not take the packed stage-0 chain"

    tproj = tp.fold_projection_params(torch.float32, *map(_t, proj_raw))
    tids = [tb.fold_bottleneck_params(torch.float32, *map(_t, r)) for r in ids_raw]
    for a, b in zip(jproj + tuple(w for ws in jids for w in ws), list(tproj) + [w for ws in tids for w in ws]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    got = tst.fused_stage(_t(x), tproj, tids, stride=1)
    _check(got, want, F32_TOL)


def test_stride2_chain_matches_pallas():
    """A stride-2 stage entry with identity blocks (the stage 1-3 geometry)."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    proj_raw = _block_args(rng, 32, 16, 64, projection=True)
    ids_raw = [_block_args(rng, 64, 16, 64, projection=False)]
    jproj = jp.fold_projection_params(jnp.float32, *map(_j, proj_raw))
    jids = [jb.fold_bottleneck_params(jnp.float32, *map(_j, r)) for r in ids_raw]
    want = jst.fused_stage(_j(x), jproj, jids, stride=2, impl="pallas", interpret=True)
    tproj = tp.fold_projection_params(torch.float32, *map(_t, proj_raw))
    tids = [tb.fold_bottleneck_params(torch.float32, *map(_t, r)) for r in ids_raw]
    _check(tst.fused_stage(_t(x), tproj, tids, stride=2), want, F32_TOL)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run their plain versions: no kernel launch
    is counted, and none is built."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(6)
    x = _t(np.abs(rng.normal(0, 1, (1, 8, 8, 64))).astype(np.float32))
    tb.fused_bottleneck_block(x, *map(_t, _block_args(rng, 64, 16, 64, projection=False)))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 8, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tb.bottleneck_block(x, *[None] * 6)


# ─────────────── saving forwards and one-pass backwards ───────────────
#
# Each backward in isolation takes identical (x, g, out, h1, h2, w...) on
# both sides, the residuals from argus_tpu's own saving forward; each
# Function end to end is `torch.autograd.grad` against `jax.vjp` of the
# public op on raw HWIO kernels and BN buffers. Tolerances as above: f32 at
# rtol 2e-4 / atol 1e-4 relative to each output's largest magnitude (sums in
# another order); bf16 at 2e-2 of it (one ulp of a rounding that either side
# may take the other way, in m1/m2 and dx).


def _scaled_close(got, want, rel):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _rel(dtype):
    return 2e-4 if dtype == "float32" else 2e-2


def _folded(rng, cin, f, cout, projection, jdt):
    raw = _block_args(rng, cin, f, cout, projection)
    fold = jp.fold_projection_params if projection else jb.fold_bottleneck_params
    return raw, fold(jdt, *map(_j, raw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_block_save_and_backward_match_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    _, (w1, b1, w2, b2, w3, b3) = _folded(rng, 64, 16, 64, False, jdt)
    xj = _j(x, jdt)
    saved = jb._block_fwd_save_pallas(xj, w1, b1, w2, b2, w3, b3, interpret=True)
    tw = [_t(np.asarray(a.astype(jnp.float32)), tdt) if a.dtype == jdt else _t(np.asarray(a))
          for a in (w1, b1, w2, b2, w3, b3)]
    for got, want in zip(tb.bottleneck_block_save(_t(x, tdt), *tw), saved):
        _scaled_close(got, want, _rel(dtype))
    out, h1, h2 = saved
    g = _j(rng.normal(0, 1, out.shape), jdt)
    want = jb._block_bwd_saved_pallas(xj, g, out, h1, h2, w1, w2, w3, interpret=True)
    tt = lambda a: _t(np.asarray(a.astype(jnp.float32)), tdt)  # noqa: E731
    got = tb.block_bwd(tt(xj), tt(g), tt(out), tt(h1), tt(h2), tw[0], tw[2], tw[4])
    assert got[0].dtype == tdt and all(d.dtype == torch.float32 for d in got[1:])
    for a, b in zip(got, want):
        _scaled_close(a, b, _rel(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_save_and_backward_match_pallas(stride, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11 + stride)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    _, ws = _folded(rng, 32, 16, 64, True, jdt)
    xj = _j(x, jdt)
    saved = jp._proj_fwd_pallas(xj, *ws, stride, True, save=True)
    tt = lambda a: _t(np.asarray(jnp.asarray(a).astype(jnp.float32)), tdt)  # noqa: E731
    tw = [tt(a) if i % 2 == 0 else _t(np.asarray(a)) for i, a in enumerate(ws)]
    for got, want in zip(tp.projection_block_save(tt(xj), *tw, stride), saved):
        _scaled_close(got, want, _rel(dtype))
    out, h1, h2 = saved
    g = _j(rng.normal(0, 1, out.shape), jdt)
    want = jp._proj_bwd_pallas(xj, g, out, h1, h2, ws[0], ws[2], ws[4], ws[6], stride, True)
    got = tp.proj_bwd(tt(xj), tt(g), tt(out), tt(h1), tt(h2), tw[0], tw[2], tw[4], tw[6], stride)
    for a, b in zip(got, want):
        _scaled_close(a, b, _rel(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,cin,f,cout", [(1, 64, 64, 256), (2, 32, 16, 64)])
def test_chain_save_and_backward_match_pallas(stride, cin, f, cout, dtype):
    """The stage-0 geometry (stride 1, F = 64) and a stride-2 entry, each a
    projection plus two identity blocks."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(13 + stride)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, cin))).astype(np.float32)
    _, pw = _folded(rng, cin, f, cout, True, jdt)
    ids = [_folded(rng, cout, f, cout, False, jdt)[1] for _ in range(2)]
    xj = _j(x, jdt)
    outs = jst._chain_fwd_pallas(xj, pw, ids, stride, True, 1, save=True)
    out, bnds, hs = outs[0], list(outs[1:3]), outs[3:]
    h1s, h2s = list(hs[0::2]), list(hs[1::2])
    tt = lambda a: _t(np.asarray(jnp.asarray(a).astype(jnp.float32)), tdt)  # noqa: E731
    tpw = [tt(a) if i % 2 == 0 else _t(np.asarray(a)) for i, a in enumerate(pw)]
    tids = [[tt(a) if i % 2 == 0 else _t(np.asarray(a)) for i, a in enumerate(w)] for w in ids]
    t_out, t_bnds, t_h1s, t_h2s = tst.fused_stage_save(tt(xj), tpw, tids, stride)
    for a, b in zip([t_out, *t_bnds, *t_h1s, *t_h2s], [out, *bnds, *h1s, *h2s]):
        _scaled_close(a, b, _rel(dtype))
    g = _j(rng.normal(0, 1, out.shape), jdt)
    want = jst._chain_bwd_pallas(
        xj, g, out, bnds, h1s, h2s, (pw[0], pw[2], pw[4], pw[6]), [(w[0], w[2], w[4]) for w in ids],
        stride, True, 1,
    )
    dx, pd, idd = tst.stage_bwd(
        tt(xj), tt(g), tt(out), [tt(b) for b in bnds], [tt(h) for h in h1s], [tt(h) for h in h2s],
        (tpw[0], tpw[2], tpw[4], tpw[6]), [(w[0], w[2], w[4]) for w in tids], stride,
    )
    for a, b in zip([dx, *pd, *[d for ds in idd for d in ds]], want):
        _scaled_close(a, b, _rel(dtype))


def _vjp_check(jfn, tfn, x, raw, g, dtype):
    """dx and every kernel's gradient of the port's op against jax.vjp of
    argus_tpu's; the BN buffers get no gradient in the port."""
    jdt, tdt = DTYPES[dtype]
    kidx = list(range(0, len(raw), 5))  # the HWIO kernels among the raw args
    jraw = [_j(a) for a in raw]

    def f(xv, *ks):
        args = list(jraw)
        for i, k in zip(kidx, ks):
            args[i] = k
        return jfn(xv, *args)

    out, vjp = jax.vjp(f, _j(x, jdt), *[jraw[i] for i in kidx])
    want = vjp(_j(g, jdt).astype(out.dtype))
    tx = _t(x, tdt).requires_grad_()
    traw = [_t(a).requires_grad_() for a in raw]
    tout = tfn(tx, *traw)
    _scaled_close(tout, out, _rel(dtype))
    got = torch.autograd.grad(tout, [tx] + [traw[i] for i in kidx], _t(g, tdt), allow_unused=True)
    for a, b in zip(got, want):
        _scaled_close(a, b, _rel(dtype))
    others = [t for i, t in enumerate(traw) if i not in kidx]
    assert all(d is None for d in torch.autograd.grad(tout.sum(), others, allow_unused=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_block_function_gradients_match_jax_vjp(dtype):
    rng = np.random.default_rng(20)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    raw = _block_args(rng, 64, 16, 64, projection=False)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    _vjp_check(
        lambda xv, *a: jb.fused_bottleneck_block(xv, *a, impl="pallas", interpret=True),
        tb.fused_bottleneck_block, x, raw, g, dtype,
    )


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_function_gradients_match_jax_vjp(stride):
    rng = np.random.default_rng(21 + stride)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    raw = _block_args(rng, 32, 16, 64, projection=True)
    g = rng.normal(0, 1, (2, 8 // stride, 8 // stride, 64)).astype(np.float32)
    _vjp_check(
        lambda xv, *a: jp.fused_projection_block(xv, *a, stride=stride, impl="pallas", interpret=True),
        lambda xv, *a: tp.fused_projection_block(xv, *a, stride=stride), x, raw, g, "float32",
    )


def test_stage_function_gradients_match_jax_vjp():
    """The chain as the model calls it: the f32 fold of raw kernels, then the
    Function; dx is checked too though the frozen stem leaves it unused."""
    rng = np.random.default_rng(24)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    raw = _block_args(rng, 64, 64, 256, True) + sum(
        (_block_args(rng, 256, 64, 256, False) for _ in range(2)), []
    )
    g = rng.normal(0, 1, (2, 8, 8, 256)).astype(np.float32)

    def jfn(xv, *a):
        pw = jp.fold_projection_params(xv.dtype, *a[:20])
        ids = [jb.fold_bottleneck_params(xv.dtype, *a[20 + 15 * j: 35 + 15 * j]) for j in range(2)]
        return jst.fused_stage(xv, pw, ids, stride=1, impl="pallas", interpret=True)

    def tfn(xv, *a):
        pw = tp.fold_projection_params(xv.dtype, *a[:20])
        ids = [tb.fold_bottleneck_params(xv.dtype, *a[20 + 15 * j: 35 + 15 * j]) for j in range(2)]
        return tst.stage_chain(xv, pw, ids, 1)

    _vjp_check(jfn, tfn, x, raw, g, "float32")


def test_functions_pick_the_no_save_forward_without_gradients():
    """With no input needing a gradient the blocks run their no-save
    forwards (argus_tpu's primal), under grad mode or not."""
    rng = np.random.default_rng(25)
    x = _t(np.abs(rng.normal(0, 1, (1, 8, 8, 64))).astype(np.float32))
    ws = tb.fold_bottleneck_params(torch.float32, *map(_t, _block_args(rng, 64, 16, 64, False)))
    out = tb.block_saved(x, *ws)
    assert out.grad_fn is None
    out = tb.block_saved(x.requires_grad_(), *ws)
    assert type(out.grad_fn).__name__ == "_BlockSavedBackward"


@pytest.mark.parametrize("stride", [1, 2])
def test_dgrad_taps_reproduce_the_transposed_conv(stride):
    """The 3x3 data-gradient taps the CUDA backward takes (`dgrad_w2`),
    applied the way csrc/conv_bwd.cuh applies them (stride 1: one forward
    conv at pad 1; stride 2: per output parity class a kh x kw conv over m2
    at source offsets 0 and +1, written to that class's pixels) give the
    transposed conv exactly."""
    import torch.nn.functional as F

    rng = np.random.default_rng(30 + stride)
    n, h, w, f = 2, 8, 6, 8
    ho, wo = h // stride, w // stride
    w2 = _t(rng.normal(0, 1, (3, 3, f, f)).astype(np.float32))
    m2 = _t(rng.normal(0, 1, (n, ho, wo, f)).astype(np.float32))
    want, _ = tb.conv3x3_grads_f32(torch.zeros(n, h, w, f), m2, w2, stride)
    taps = tb.dgrad_w2(w2, stride)
    assert taps.shape == (9, f, f)
    nchw = m2.permute(0, 3, 1, 2)
    if stride == 1:
        k = taps.reshape(3, 3, f, f).permute(3, 2, 0, 1)
        got = F.conv2d(nchw, k, padding=1).permute(0, 2, 3, 1)
    else:
        got = torch.zeros(n, h, w, f)
        start = 0
        for py in (0, 1):
            for px in (0, 1):
                kh, kw = py + 1, px + 1
                k = taps[start:start + kh * kw].reshape(kh, kw, f, f).permute(3, 2, 0, 1)
                start += kh * kw
                src = F.pad(nchw, (0, 1, 0, 1))  # offset +1 past the edge reads zero
                cls = F.conv2d(src, k)[:, :, :ho, :wo]
                got[:, py::2, px::2] = cls.permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
