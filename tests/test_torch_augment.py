"""The port's augmentation stack (argus_tpu_torch.ops.augment and its two
kernels' plain versions) against argus_tpu's, and the port's own samplers.

Parity: parameters come from argus_tpu's samplers (same JAX keys as its
`apply_augmentation`), converted with numpy and fed to both sides; images
are seeded numpy arrays. Pallas kernels run in interpret mode.

Tolerances:
- f32: max abs 2e-6 (the same f32 ops, some sums in another order; measured
  4.2e-7 at most, on the per-op stack with erasing and salt & pepper).
- bf16: max abs 1.6e-2 and mean abs 1e-3. Both sides round each op to bf16,
  but XLA:CPU may keep a bf16 elementwise chain in f32 inside a fusion where
  torch rounds after every op, and the sums (luma, contrast mean) are taken
  in other orders; a difference is a bf16 ulp or two (2^-8 in [0.5, 1)) at a
  few pixels (measured: max 7.8e-3, mean 2.2e-4, in the colour jiggle).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from argus_tpu.ops import augment as JA
from argus_tpu.ops.pallas import augment_fused as jaf
from argus_tpu.ops.pallas import blur as jblur
from argus_tpu_torch.ops import augment as TA
from argus_tpu_torch.ops.kernels import augment_fused as taf
from argus_tpu_torch.ops.kernels import blur as tblur

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
B, NC, H, W = 2, 2, 24, 32
N = B * NC


def t(a, dtype=None):
    """A JAX array as a torch tensor (bf16 through f32, exactly)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.from_numpy(a.copy())
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    out = torch.from_numpy(a.astype(np.float32))
    return out if dtype is None else out.to(dtype)


def close(got, want, dt, what=""):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    if dt == "f32":
        assert err.max() <= 2e-6, (what, err.max())
    else:
        assert err.max() <= 1.6e-2 and err.mean() <= 1e-3, (what, err.max(), err.mean())


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 1, (N, 3, H, W)).astype(np.float32)


def both(images, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(images).astype(jd), torch.from_numpy(images).to(td)


def jax_params(cfg, key, b, n_cams, h, w, jdtype):
    """argus_tpu's parameters for `apply_augmentation(cfg, key, ...)` (its
    key slots and samplers), as the port's `AugmentParams`."""
    keys = jax.random.split(key, 9)
    n = b * n_cams
    td = torch.bfloat16 if jdtype == jnp.bfloat16 else torch.float32
    p = TA.AugmentParams()
    if cfg.num_spaghetti > 0:
        p.arcs = t(JA._arc_params(keys[0], n, cfg.num_spaghetti, h, w))
    if cfg.random_erasing:
        p.erase = tuple(_jax_erasing(keys[i], n, h, w, *sr) for i, sr in
                        ((1, ((0.02, 0.1), (2.0, 3.0))), (2, ((0.02, 0.05), (0.8, 1.2)))))
    if cfg.planckian_jitter:
        p.gains = t(JA._planckian_gains(keys[3], n, 0.5, jdtype), td)
    if cfg.color_jiggle:
        jig, order = JA._jiggle_params(keys[4], b, n_cams, cfg, jnp.float32)
        p.jiggle, p.order = t(jig), t(order)
    if cfg.blur:
        p.gauss = tuple(t(a) for a in JA._gaussian_taps(keys[5], n))
    if cfg.motion_blur:
        p.motion = tuple(t(a) for a in JA._motion_kernel(keys[6], n))
    if cfg.plasma_shadow:
        p.plasma = tuple(t(a) for a in JA._plasma_params(keys[7], n, (h, w)))
    if cfg.salt_and_pepper:
        ka, ks, ku, kg = jax.random.split(keys[8], 4)
        p.salt = (t(JA._uniform(ka, (n, 1, 1), 0.01, 0.06)), t(JA._uniform(ks, (n, 1, 1), 0.4, 0.6)),
                  t(jax.random.uniform(ku, (n, h, w))), t(jax.random.bernoulli(kg, 0.7, (n, 1, 1))))
    return p


def _jax_erasing(key, n, h, w, scale, ratio):
    """The draws of argus_tpu's `random_erasing` (its key splits)."""
    ks, kr, kx, ky, kg = jax.random.split(key, 5)
    area = JA._uniform(ks, (n,), *scale) * h * w
    aspect = JA._uniform(kr, (n,), *ratio)
    rh, rw = jnp.sqrt(area * aspect), jnp.sqrt(area / aspect)
    cy = JA._uniform(ky, (n,), 0.0, 1.0) * (h - rh)
    cx = JA._uniform(kx, (n,), 0.0, 1.0) * (w - rw)
    return t(rh), t(rw), t(cy), t(cx), t(jax.random.bernoulli(kg, 0.5, (n, 1, 1, 1)).reshape(n))


# ───────────────────────── (a) the per-op transforms ─────────────────────────

TRANSFORMS = ["arcs", "erasing", "planckian", "jiggle", "gaussian", "motion", "plasma", "salt_and_pepper"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_argus_tpu(images, dt, name):
    jx, tx = both(images, dt)
    key = jax.random.PRNGKey(TRANSFORMS.index(name))
    cfg = JA.AugmentationConfig()
    if name == "arcs":
        want = JA.spaghetti_arcs(key, jx, 10)
        got = TA.spaghetti_arcs(tx, t(JA._arc_params(key, N, 10, H, W)))
    elif name == "erasing":
        want = JA.random_erasing(key, jx, value=1.0)
        got = TA.random_erasing(tx, _jax_erasing(key, N, H, W, (0.02, 0.1), (2.0, 3.0)), 1.0)
    elif name == "planckian":
        want = JA.planckian_jitter(key, jx)
        got = TA.planckian_jitter(tx, t(JA._planckian_gains(key, N, 0.5, jx.dtype), tx.dtype))
    elif name == "jiggle":
        want = JA.color_jiggle(key, jx, cfg, n_cams=NC)
        jig, order = JA._jiggle_params(key, B, NC, cfg, jnp.float32)
        got = TA.color_jiggle(tx, t(jig), t(order))
    elif name == "gaussian":
        want = JA.gaussian_blur(key, jx, p=0.5)
        got = TA.gaussian_blur(tx, *(t(a) for a in JA._gaussian_taps(key, N)))
    elif name == "motion":
        want = JA.motion_blur(key, jx)
        got = TA.motion_blur(tx, *(t(a) for a in JA._motion_kernel(key, N)))
    elif name == "plasma":
        want = JA.plasma_shadow(key, jx)
        got = TA.plasma_shadow(tx, *(t(a) for a in JA._plasma_params(key, N, (H, W))))
    else:
        want = JA.salt_and_pepper(key, jx)
        ka, ks, ku, kg = jax.random.split(key, 4)
        got = TA.salt_and_pepper(tx, (t(JA._uniform(ka, (N, 1, 1), 0.01, 0.06)),
                                      t(JA._uniform(ks, (N, 1, 1), 0.4, 0.6)),
                                      t(jax.random.uniform(ku, (N, H, W))),
                                      t(jax.random.bernoulli(kg, 0.7, (N, 1, 1)))))
    assert got.dtype == tx.dtype
    close(got, want, dt, name)


PER_OP = {
    "default": dict(pallas_fused=False, pallas_blur=False),
    "erasing_salt": dict(pallas_fused=False, pallas_blur=False, random_erasing=True, salt_and_pepper=True),
    "no_arcs_no_jiggle": dict(pallas_fused=False, pallas_blur=False, num_spaghetti=0, color_jiggle=False),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(PER_OP))
def test_per_op_stack_matches_argus_tpu(images, monkeypatch, dt, case):
    """`apply_augmentation` on NHWC images, per-op path, argus_tpu's
    parameters fed to the port through its sampler."""
    kw = PER_OP[case]
    key = jax.random.PRNGKey(21)
    nhwc = images.reshape(B, NC, 3, H, W).transpose(0, 3, 4, 1, 2).reshape(B, H, W, 3 * NC)
    jx, tx = both(np.ascontiguousarray(nhwc), dt)
    want = JA.apply_augmentation(JA.AugmentationConfig(**kw), key, jx, n_cams=NC)
    p = jax_params(JA.AugmentationConfig(**kw), key, B, NC, H, W, jx.dtype)
    monkeypatch.setattr(TA, "sample_params", lambda *a, **k: p)
    got = TA.apply_augmentation(TA.AugmentationConfig(**kw), 0, tx, n_cams=NC)
    close(got, want, dt, case)


# ───────────────────────── (b) the blur kernel's plain version ─────────────────────────


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_blur_plain_matches_pallas(images, dt):
    jx, tx = both(images, dt)
    gw, _ = JA._gaussian_taps(jax.random.PRNGKey(1), N)
    mk, _ = JA._motion_kernel(jax.random.PRNGKey(2), N)
    gates = np.array([[1, 1], [1, 0], [0, 1], [0, 0]], np.float32)
    want = jblur.fused_random_blur(jx, gw, mk, jnp.asarray(gates), interpret=True)
    got = tblur.fused_random_blur(tx, t(gw), t(mk), torch.from_numpy(gates))
    assert got.dtype == tx.dtype
    close(got, want, dt, "blur")


# ───────────────────────── (c) the fused kernel's plain version ─────────────────────────

FH, FW = 16, 32  # interpret-mode Pallas runs one grid step per image; keep it small


@pytest.fixture(scope="module")
def fused_inputs():
    """Per n_arcs: images (N, 3, FH, FW) and argus_tpu's packed parameters,
    as `_apply_fused` builds them."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (N, 3, FH, FW)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 9)
    cfg = JA.AugmentationConfig()
    out = {}
    for n_arcs in (0, 10):
        arcs = (JA._arc_params(keys[0], N, n_arcs, FH, FW).reshape(N, -1) if n_arcs
                else jnp.zeros((N, 0), jnp.float32))
        gains = JA._planckian_gains(keys[3], N, 0.5, jnp.float32)
        jig, _ = JA._jiggle_params(keys[4], B, NC, cfg, jnp.float32)
        gw, gg = JA._gaussian_taps(keys[5], N, p=0.7)
        mk, mg = JA._motion_kernel(keys[6], N)
        field, inten, qty = JA._plasma_params(keys[7], N, (FH, FW))
        packed = jnp.concatenate([arcs, gains, jig, gw, mk.reshape(N, 9), gg[:, None].astype(jnp.float32),
                                  mg[:, None].astype(jnp.float32), inten[:, None], qty[:, None]], 1)
        S = field.shape[-1]
        mh = jnp.asarray(JA._resize_matrix(FH, S))
        mwt = jnp.asarray(JA._resize_matrix(FW, S)).T
        out[n_arcs] = (img, field, mh, mwt, packed)
    return out


def _fused_pair(fused_inputs, n_arcs, perm, dt):
    img, field, mh, mwt, packed = fused_inputs[n_arcs]
    jx, tx = both(img, dt)
    order = jnp.asarray(perm, jnp.int32)[None]
    want = jaf.fused_augment(jx, field, mh, mwt, packed, order, n_arcs=n_arcs, interpret=True)
    got = taf.fused_augment(tx, t(field), t(mh), t(mwt), t(packed), torch.tensor([perm], dtype=torch.int32),
                            n_arcs)
    return got, want


ORDERS = list(itertools.permutations(range(4)))


@pytest.mark.parametrize("perm", ORDERS, ids=["".join(map(str, p)) for p in ORDERS])
def test_fused_plain_matches_pallas_every_order(fused_inputs, perm):
    """f32, every jiggle order, with 0 and 10 arcs."""
    for n_arcs in (0, 10):
        got, want = _fused_pair(fused_inputs, n_arcs, perm, "f32")
        close(got, want, "f32", f"order {perm}, {n_arcs} arcs")


@pytest.mark.parametrize("hue_pos", range(4))
def test_fused_plain_matches_pallas_bf16(fused_inputs, hue_pos):
    """bf16 at each hue position (the TPU kernel's four variants)."""
    perm = [1, 0, 2]
    perm.insert(hue_pos, 3)
    for n_arcs in (0, 10):
        got, want = _fused_pair(fused_inputs, n_arcs, tuple(perm), "bf16")
        assert got.dtype == torch.bfloat16
        close(got, want, "bf16", f"order {perm}, {n_arcs} arcs")


def test_fused_path_matches_per_op_interior(images):
    """The port's own two paths on the same parameters: equal away from the
    2 px border where edge clamp and reflect differ (argus_tpu's
    test_fused_matches_per_op_interior, on the port)."""
    nhwc = torch.from_numpy(np.ascontiguousarray(
        images.reshape(B, NC, 3, H, W).transpose(0, 3, 4, 1, 2).reshape(B, H, W, 3 * NC)))
    fused = TA.apply_augmentation(TA.AugmentationConfig(pallas_fused=True), 9, nhwc)
    per_op = TA.apply_augmentation(TA.AugmentationConfig(pallas_fused=False, pallas_blur=False), 9, nhwc)
    m = 4
    err = (fused - per_op)[:, m:-m, m:-m].abs()
    assert err.max() <= 1e-5, err.max()
    edge = TA.apply_augmentation(TA.AugmentationConfig(pallas_fused=False, pallas_blur=True), 9, nhwc)
    assert (fused - edge).abs().max() <= 1e-5


# ───────────────────────── (d) jiggle_plan, (e) the blackbody table ─────────────────────────


def test_jiggle_plan_matches_argus_tpu():
    for perm in ORDERS:
        hp, aff = jaf.jiggle_plan(jnp.asarray(perm, jnp.int32))
        thp, taff = taf.jiggle_plan(torch.tensor(perm))
        assert int(thp) == int(hp) == perm.index(3)
        assert taff.tolist() == np.asarray(aff).tolist() == [[v for v in perm if v != 3]]
        assert thp.dtype == taff.dtype == torch.int32


def test_blackbody_table_matches_argus_tpu():
    np.testing.assert_allclose(TA._PLANCKIAN_TABLE, JA._PLANCKIAN_TABLE, rtol=0, atol=1e-6)
    assert TA._PLANCKIAN_TABLE.dtype == np.float32
    for out_size, in_size in ((256, 64), (24, 32), (7, 3)):
        np.testing.assert_array_equal(TA._resize_matrix(out_size, in_size), JA._resize_matrix(out_size, in_size))
        np.testing.assert_array_equal(TA._resize_matrix_corner(out_size, in_size),
                                      JA._resize_matrix_corner(out_size, in_size))


# ───────────────────────── the port's own samplers ─────────────────────────

NS = 4096


def _rate_ok(gate, p):
    """Gate rate within 4 sigma of p over the draws."""
    rate = gate.float().mean().item()
    assert abs(rate - p) <= 4 * (p * (1 - p) / gate.numel()) ** 0.5 + 1e-12, (rate, p)


def test_sampler_ranges_and_gate_rates():
    g = lambda s: TA.generator(s, "cpu")  # noqa: E731
    cfg = TA.AugmentationConfig()
    gains = TA._planckian_gains(g(1), NS, 0.5, torch.float32)
    table = torch.from_numpy(TA._PLANCKIAN_TABLE)
    on = ~(gains == 1).all(1)
    _rate_ok(on, 0.5)
    assert ((gains[on][:, None] - table[None]).abs().sum(-1).min(1).values == 0).all()
    taps, gg = TA._gaussian_taps(g(2), NS)
    _rate_ok(gg, 0.5)
    torch.testing.assert_close(taps.sum(1), torch.ones(NS))
    assert (taps > 0).all() and torch.equal(taps, taps.flip(1))
    kern, mg = TA._motion_kernel(g(3), NS)
    _rate_ok(mg, 0.7)
    torch.testing.assert_close(kern.sum((1, 2)), torch.ones(NS))
    assert kern.min() >= 0 and kern[:, 1].sum(1).mean() > 0.7  # the angle stays within +-35 degrees
    field, inten, qty = TA._plasma_params(g(4), NS, (8, 8))
    assert field.shape == (NS, 8, 8)
    assert (inten <= 0).all() and (inten >= -0.6).all() and (qty >= 0).all() and (qty <= 0.5).all()
    assert (inten < 0).all()  # p = 1: every image shaded
    jig, order = TA._jiggle_params(g(5), TA.generator(5, "cpu"), NS // 2, 2, cfg)
    for k, (lo, hi) in enumerate([(0.8, 1.0), (0.5, 1.2), (0.25, 1.2), (-0.1, 0.1)]):
        assert jig[:, k].min() >= lo and jig[:, k].max() <= hi, k
    assert torch.equal(jig[0::2], jig[1::2])  # shared across one example's cameras
    assert sorted(order.tolist()) == [0, 1, 2, 3]
    arcs = TA._arc_params(g(6), 64, 10, 24, 32)
    assert arcs.shape == (64, 10, 10)
    assert (arcs[..., 0] >= 0).all() and (arcs[..., 0] <= 32).all() and (arcs[..., 1] <= 24).all()
    assert (arcs[..., 2] <= 1e3).all() and (arcs[..., 4] > 0).all()
    torch.testing.assert_close(arcs[..., 5] ** 2 + arcs[..., 6] ** 2, torch.ones(64, 10))
    assert set(arcs[..., 9].unique().tolist()) <= {0.0, 1.0}


def test_sampler_distributions_match_argus_tpu():
    """Two-sample KS against argus_tpu's samplers. Gains (R channel, 4096
    draws each): statistic <= 0.05 (the 0.1% critical value is 0.043).
    Plasma base fields at 64x64 (256 fields each), per field the std and the
    share below 0.3 after min-max normalisation: statistic <= 0.2 (0.1%
    critical value 0.172)."""
    got = TA._planckian_gains(TA.generator(11, "cpu"), NS, 0.5, torch.float32)[:, 0].numpy()
    want = np.asarray(JA._planckian_gains(jax.random.PRNGKey(11), NS, 0.5, jnp.float32))[:, 0]
    assert ks_2samp(got, want).statistic <= 0.05
    n = 256
    ours = TA._plasma_base_field(TA.generator(12, "cpu"), n, (64, 64),
                                 TA._uniform(TA.generator(13, "cpu"), (n, 1, 1), 0.1, 0.4)).numpy()
    theirs = np.asarray(JA._plasma_base_field(jax.random.PRNGKey(12), n, (64, 64),
                                              JA._uniform(jax.random.PRNGKey(13), (n, 1, 1), 0.1, 0.4)))
    for f in (ours, theirs):
        assert f.shape == (n, 64, 64)

    def stats(f):
        lo, hi = f.min((1, 2), keepdims=True), f.max((1, 2), keepdims=True)
        return f.std((1, 2)), ((f - lo) / (hi - lo) < 0.3).mean((1, 2))

    for a, b in zip(stats(ours), stats(theirs)):
        assert ks_2samp(a, b).statistic <= 0.2


def test_sampling_is_seeded_and_slots_are_independent():
    x = torch.rand(2, 24, 32, 6, generator=torch.Generator().manual_seed(3))
    cfg = TA.AugmentationConfig()
    a = TA.apply_augmentation(cfg, 5, x)
    assert a.is_contiguous()  # the NHWC model's kernels take contiguous images
    assert torch.equal(a, TA.apply_augmentation(cfg, 5, x))
    assert not torch.equal(a, TA.apply_augmentation(cfg, 6, x))
    full = TA.sample_params(cfg, 5, 2, 2, 24, 32, "cpu", torch.float32)
    part = TA.sample_params(TA.AugmentationConfig(plasma_shadow=False), 5, 2, 2, 24, 32, "cpu", torch.float32)
    assert part.plasma is None
    for name in ("arcs", "gains", "jiggle", "order"):
        assert torch.equal(getattr(full, name), getattr(part, name)), name
    for name in ("gauss", "motion"):
        for u, v in zip(getattr(full, name), getattr(part, name)):
            assert torch.equal(u, v), name
    assert TA.fold_in(0, 0) != TA.fold_in(0, 1) and len(set(TA.split(7, 9))) == 9
    assert torch.equal(TA.apply_augmentation(cfg, 5, x, train=False), x)
