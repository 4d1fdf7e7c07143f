"""The Hopper augmentation kernel's decomposition on the CPU
(`argus_tpu_torch/csrc/augment_fused.cu`).

(a) Its premise: an image-dtype op of two bf16 operands computed as one
correctly rounded bf16x2 instruction has the bits of the f32 op followed by
one rounding to bf16 (the plain version's and argus_tpu's rounding points).
The exact result is taken in float64 (exact for these operands) and rounded
to the bf16 grid half to even.

(b) The hue's floor modulus by 1 as a - floor(a), against argus_tpu's `% 1.0`
over the hue's range.

(c) The band walk in plain torch against `fused_augment_plain`: a cluster of
blocks an image, each a band of R rows with a recomputed 3-row halo each
side, the partial luma sums added in rank order, the field's min and max from
the bands, the blurs clamped at the image's border only. Every op but the
mean is the plain version's own, so the outputs agree to the bit except
where the mean's summation order moves an f32 ulp (f32 images: within 1e-5;
bf16: a bf16 ulp at rare pixels, the card gate `AUG_TOL`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu_torch.ops import augment as TA
from argus_tpu_torch.ops.kernels import augment_fused as taf
from argus_tpu_torch.ops.kernels.augment_common import adjust_hue, arc_mask
from argus_tpu_torch.ops.kernels.blur import clamp_shift

# ───────────────────────── (a) the bf16x2 premise ─────────────────────────


def bf16_bits_of_f32(v: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits, round half to even (finite values)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def round_exact_to_bf16(x: np.ndarray) -> np.ndarray:
    """The float64 values (exact sums and products) rounded to the bf16 grid,
    half to even: 8 significant bits, subnormal spacing 2^-133 below 2^-126."""
    _, e = np.frexp(x)
    step = np.ldexp(1.0, np.maximum(e, -125) - 8)
    r = np.rint(x / step) * step
    return bf16_bits_of_f32(r.astype(np.float32))  # exact: r is on the bf16 grid


def random_bf16(rng, n: int, lo_exp: int, hi_exp: int) -> np.ndarray:
    """bf16 bit patterns with random sign, exponent in [lo_exp, hi_exp] and
    7 random mantissa bits."""
    sign = rng.integers(0, 2, n).astype(np.uint16) << 15
    exp = (rng.integers(lo_exp, hi_exp + 1, n) + 127).astype(np.uint16) << 7
    return sign | exp | rng.integers(0, 128, n).astype(np.uint16)


def edge_pairs() -> tuple:
    """Zeros of both signs, equal magnitudes of opposite sign, the smallest
    normals, ones and values around them."""
    vals = [0.0, -0.0, 1.0, -1.0, 2.0 ** -126, -(2.0 ** -126), 2.0 ** -125, 0.5, 0.99609375, 1.0078125,
            0.333984375, 2.0 ** -30, 3.0 * 2.0 ** -30]
    bits = bf16_bits_of_f32(np.array(vals, np.float32))
    a, b = np.meshgrid(bits, bits)
    a, b = a.ravel(), b.ravel()
    neg = bits ^ np.uint16(0x8000)  # equal magnitudes of opposite sign
    return np.concatenate([a, bits]), np.concatenate([b, neg])


def pixel_scalar_pairs(rng, n: int) -> tuple:
    """Pixel values in [0, 1] against the jiggle's factors and the blur's
    taps and gates, and sums of such products, all rounded to bf16."""
    px = bf16_bits_of_f32(rng.uniform(0.0, 1.0, n).astype(np.float32))
    sc = bf16_bits_of_f32(rng.uniform(0.0, 1.5, n).astype(np.float32))
    sums = bf16_bits_of_f32(rng.uniform(0.0, 2.0, n).astype(np.float32))
    return np.concatenate([px, px, sums]), np.concatenate([sc, px[::-1].copy(), px])


@pytest.mark.parametrize("op", ["add", "mul"])
def test_bf16x2_op_is_the_f32_op_rounded_once(op):
    rng = np.random.default_rng(0 if op == "add" else 1)
    n = 3_000_000
    a = np.concatenate([random_bf16(rng, n, -30, 2), *edge_pairs()[:1], pixel_scalar_pairs(rng, 500_000)[0]])
    b = np.concatenate([random_bf16(rng, n, -30, 2), *edge_pairs()[1:], pixel_scalar_pairs(rng, 500_000)[1]])
    fa, fb = bf16_to_f64(a), bf16_to_f64(b)
    exact = fa + fb if op == "add" else fa * fb  # exact in float64: 8-bit significands, exponents within 2^-60..2^4
    f32 = (fa.astype(np.float32) + fb.astype(np.float32) if op == "add"
           else fa.astype(np.float32) * fb.astype(np.float32))
    got, want = bf16_bits_of_f32(f32), round_exact_to_bf16(exact)
    same = (got == want) | ((bf16_to_f64(got) == 0) & (bf16_to_f64(want) == 0))  # a zero's sign aside
    assert same.all(), (op, int((~same).sum()), a[~same][:5], b[~same][:5])


# ───────────────────────── (b) the hue's floor modulus ─────────────────────────


def test_hue_floor_modulus_is_a_minus_floor():
    """The kernel's `frac1(a) = a - floor(a)` (f32) equals argus_tpu's
    `a % 1.0` over the hue's range: h / 6 in [-1/6, 5/6] and h + shift in
    [-0.1, 1.1], plus values at and beside integers."""
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(-0.2, 1.2, 2_000_000), rng.uniform(-1.0 / 6, 5.0 / 6, 1_000_000)])
    edges = np.array([0.0, -0.0, 1.0, -1e-9, 1e-9, 1 - 1e-8, -1 + 1e-8, 0.5, -0.5, 1.1, -0.1], np.float64)
    a = np.concatenate([a, edges, np.nextafter(edges, 2.0), np.nextafter(edges, -2.0)]).astype(np.float32)
    want = np.asarray(jnp.asarray(a) % jnp.float32(1.0))
    got = (a - np.floor(a)).astype(np.float32)
    assert got.dtype == np.float32 and np.array_equal(got, want), np.abs(got - want).max()
    i = np.floor(got * np.float32(6.0))  # the sextant: 0..6, 6 where the modulus rounds up to 1
    assert set(np.unique(i)) <= set(range(7))
    assert np.array_equal(i.astype(np.int64) % 6, np.asarray(jnp.asarray(i) % 6.0).astype(np.int64))


# ───────────────────────── (c) the band walk ─────────────────────────


def band_walk(images, field, mh, mwt, packed, order, n_arcs: int, R: int, rc: int | None = None) -> torch.Tensor:
    """`fused_augment_plain`'s function as the kernel walks it: bands of R
    rows, the pointwise ops on each band's own rows, the partials added in
    rank order, then each band's halo (3 rows each side, clipped to the
    image) taken from the bands that own those rows, and the blurs over the
    band and its halo, clamped at the image's border only. With rc < R, the
    streamed form: each band walks its rows in chunks of rc for the partials,
    then each chunk again from the image with its halo, every pointwise op
    recomputed on all those rows (no row taken from another band), and the
    blurs over the chunk."""
    N, _, H, W = images.shape
    dt = images.dtype
    A = 10 * n_arcs
    PO, JO, GO, MO, BO, QO = A, A + 3, A + 7, A + 12, A + 21, A + 23
    vec = lambda s: s.to(dt)[:, None, None, None]  # noqa: E731
    c = lambda v: torch.tensor(v, dtype=dt)  # noqa: E731
    luma = lambda x: c(0.299) * x[:, 0] + c(0.587) * x[:, 1] + c(0.114) * x[:, 2]  # noqa: E731
    occ = arc_mask(packed[:, :A].reshape(N, n_arcs, 10), H, W) if n_arcs else None
    up = taf.upsample(field, mh, mwt)
    hue_pos, aff = taf.jiggle_plan(order[0])
    seq = []
    for r in range(3):
        if r == int(hue_pos):
            seq.append(3)
        seq.append(int(aff[0, r]))
    if int(hue_pos) == 3:
        seq.append(3)
    cpos = seq.index(1)
    stream = rc is not None and rc < R
    out = torch.empty_like(images)
    for n in range(N):
        k = packed[n:n + 1]
        bf, cf, sf, hf = (k[:, JO + i] for i in range(4))

        def op(x, o, m32):
            if o == 3:
                return adjust_hue(x.float(), hf[:, None, None, None]).to(dt)
            a = [bf, cf, sf][o]
            b_ = 1.0 - sf if o == 2 else torch.zeros_like(sf)
            g_ = (1.0 - cf) * m32 if o == 1 else torch.zeros_like(cf)
            return torch.clamp(vec(a) * x + vec(b_) * luma(x)[:, None] + vec(g_), 0.0, 1.0)

        def pre(r0, r1):  # arcs, gains and the ops before the contrast on image rows [r0, r1)
            x = images[n:n + 1, :, r0:r1]
            if occ is not None:
                x = torch.where(occ[n:n + 1, None, r0:r1], torch.zeros((), dtype=dt), x)
            x = torch.clamp(x * k[:, PO:PO + 3].to(dt)[:, :, None, None], 0.0, 1.0)
            for o in seq[:cpos]:
                x = op(x, o, None)
            return x

        def post(x, m32):  # the contrast and the ops after it
            for o in seq[cpos:]:
                x = op(x, o, m32)
            return x

        bands = [(r0, min(H, r0 + R)) for r0 in range(0, H, R)]
        chunks = [[(c0, min(r1, c0 + (rc if stream else R))) for c0 in range(r0, r1, rc if stream else R)]
                  for r0, r1 in bands]
        held, sums, mins, maxs = [], [], [], []
        for (r0, r1), cs in zip(bands, chunks):  # pass 2 per block, its own rows chunk by chunk
            xs = [pre(c0, c1) for c0, c1 in cs]
            total = luma(xs[0]).float().sum()
            for x in xs[1:]:
                total = total + luma(x).float().sum()
            sums.append(total)
            mins.append(up[n, r0:r1].min())
            maxs.append(up[n, r0:r1].max())
            held.append(None if stream else xs[0])
        total = sums[0]
        for s in sums[1:]:  # rank order
            total = total + s
        m32 = (total / (H * W)).reshape(1)
        fmin, fmax = torch.stack(mins).min(), torch.stack(maxs).max()
        gw = [vec(k[:, GO + i]) for i in range(5)]
        mk = [vec(k[:, MO + i]) for i in range(9)]
        gg, mg = k[:, BO], k[:, BO + 1]

        def blurred(x, l0, r0, r1):  # own rows [r0, r1) of x, which holds image rows [l0, l0 + rows)
            rows = lambda r: min(max(r, 0), H - 1) - l0  # noqa: E731  the band row of image row r, clamped
            g0, g1 = max(0, r0 - 1), min(H, r1 + 1)
            xs = lambda rr: x[:, :, [rows(r) for r in rr]]  # noqa: E731
            g = sum(gw[i] * xs(range(g0 + i - 2, g1 + i - 2)) for i in range(5))
            gp = clamp_shift(g, 3, 2)
            g2 = sum(gw[i] * gp[:, :, :, i:i + W] for i in range(5))
            g2 = vec(gg) * g2 + vec(1.0 - gg) * xs(range(g0, g1))
            grow = lambda rr: g2[:, :, [min(max(r, 0), H - 1) - g0 for r in rr]]  # noqa: E731
            mp = clamp_shift(torch.cat([grow(range(r0 - 1 + ky, r1 - 1 + ky)) for ky in range(3)], 1), 3, 1)
            m = sum(mk[3 * ky + kx] * mp[:, 3 * ky:3 * ky + 3, :, kx:kx + W] for ky in range(3) for kx in range(3))
            mix = vec(mg) * m + vec(1.0 - mg) * grow(range(r0, r1))
            plasma = (up[n:n + 1, r0:r1] - fmin) / torch.clamp(fmax - fmin, min=1e-6)
            shade = (plasma < k[:, QO + 1, None, None]).float() * k[:, QO, None, None]
            out[n:n + 1, :, r0:r1] = torch.clamp(mix + shade[:, None].to(dt), 0.0, 1.0)

        if stream:  # each chunk again from the image, with its halo recomputed
            for cs in chunks:
                for c0, c1 in cs:
                    h0, h1 = max(0, c0 - 3), min(H, c1 + 3)
                    blurred(post(pre(h0, h1), m32), h0, c0, c1)
            continue
        for b, x in enumerate(held):  # pass 4 per block, its own rows
            held[b] = post(x, m32)
        for b, (r0, r1) in enumerate(bands):  # the halo from its owners, then the blurs
            l0, l1 = max(0, r0 - 3), min(H, r1 + 3)
            x = torch.cat([held[r // R][:, :, r - (r // R) * R:r - (r // R) * R + 1] for r in range(l0, l1)], 2)
            assert torch.equal(x[:, :, r0 - l0:r1 - l0], held[b])
            blurred(x, l0, r0, r1)
    return out


def _inputs(n, h, w, dt, n_arcs, perm, seed):
    x = torch.rand(n, 3, h, w, generator=torch.Generator().manual_seed(seed)).to(dt)
    p = TA.sample_params(TA.AugmentationConfig(), seed, n, 1, h, w, "cpu", dt)
    q = p if n_arcs else TA.AugmentParams(**{**vars(p), "arcs": None})
    field, mh, mwt, packed, _ = TA.pack_fused(q, n, h, w, n_arcs, "cpu")
    return x, field, mh, mwt, packed, torch.tensor([perm], dtype=torch.int32)


@pytest.mark.parametrize("hue_pos", range(4))
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_band_walk_matches_plain(hue_pos, dt):
    """Several band heights, an H the band height does not divide (17 rows:
    bands of 3, 5 and 8, the last one short), an odd W, with and without arcs,
    every hue position; the streamed form in chunks of 3 and 7 of 8-row
    bands and of 1 of 5-row bands."""
    perm = [1, 0, 2]
    perm.insert(hue_pos, 3)
    for n_arcs, (h, w) in ((10, (17, 13)), (0, (24, 20))):
        args = _inputs(2, h, w, dt, n_arcs, perm, 5 + hue_pos)
        want = taf.fused_augment_plain(*args, n_arcs)
        for R, rc in ((3, None), (5, None), (8, None), (taf.band_rows(h), None), (8, 3), (5, 1), (8, 7)):
            got = band_walk(*args, n_arcs, R, rc)
            err = (got.float() - want.float()).abs()
            if dt == torch.float32:  # the mean's last bits reach every pixel after the contrast
                assert err.max() <= 1e-5, (R, rc, err.max())
            else:  # a rounding moved by the mean's order: a bf16 ulp at rare pixels
                assert err.max() <= 1.6e-2 and err.mean() <= 1e-3, (R, rc, err.max(), err.mean())
                assert (err == 0).float().mean() >= 0.99, (R, rc, (err == 0).float().mean())


def test_band_layout_fits_and_mirrors_the_kernel():
    """`smem_bytes` at the flagship's shape fits two blocks an SM in bf16 and
    one in f32; a band of ceil(H / 8) rows covers every image height; the
    band stays whole at the flagship's shape, and larger crops take the most
    rows a chunk that fit."""
    assert 2 * (taf.smem_bytes(256, 256, 64, 10, 2) + 1024) <= 233472
    assert taf.smem_bytes(256, 256, 64, 10, 4) <= taf.SMEM_LIMIT
    for h in (1, 7, 8, 17, 200, 256):
        r = taf.band_rows(h)
        assert taf.CLUSTER * r >= h > taf.CLUSTER * (r - 1)
    assert taf.chunk_rows(256, 256, 64, 10, 2) == taf.chunk_rows(256, 256, 64, 10, 4) == taf.band_rows(256)
    # larger crops stream their bands in chunks that fit
    for h, w, itemsize in ((512, 512, 2), (512, 512, 4), (1024, 1024, 4), (720, 1280, 2), (720, 1280, 4),
                           (128, 1920, 4)):
        rc = taf.chunk_rows(h, w, 64, 10, itemsize)
        assert 1 <= rc < taf.band_rows(h), (h, w, itemsize, rc)
        assert taf.smem_bytes(h, w, 64, 10, itemsize, rc) <= taf.SMEM_LIMIT
        assert taf.smem_bytes(h, w, 64, 10, itemsize, rc + 1) > taf.SMEM_LIMIT
