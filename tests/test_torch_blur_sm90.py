"""The Hopper blur kernel's decomposition on the CPU (`argus_tpu_torch/csrc/blur.cu`):
its band walk, modelled on pairs of pixels, against `fused_random_blur_plain`.

The model follows the kernel: blocks of R rows (and, where a band would not
fit, of CW columns) from `band_plan`; each holds its rows and a 3-row halo
each side, clipped to the image (a column tile a 4-column halo), as pairs of
pixels, an odd width repeating column W - 1 in a pad pixel; per channel the
5-tap vertical gaussian over the rows it needs, the horizontal 5 taps with
the image-border clamp as the kernel's dup_lo / dup_hi and the gaussian's
gate, the pad set again from column W - 1, then the 3x3 motion kernel and
its gate over the own pixels. Every op runs in the image dtype (bf16 or
f32), sums from 0 in tap order: the output must equal the plain version's
bit for bit. A value the model reads that no earlier stage of the block
computed is NaN, and fails the comparison.
"""

import pytest
import torch

from argus_tpu_torch.ops.kernels import blur as kb

HALO = kb.HALO


def tap5(w, a, b, c, d, e):
    """w[0] a + ... + w[4] e from 0, each op in the dtype"""
    acc = torch.zeros_like(a) + w[0] * a
    for wk, v in zip(w[1:], (b, c, d, e)):
        acc = acc + wk * v
    return acc


def lo(v):
    return v[..., 0:1]


def hi(v):
    return v[..., 1:2]


def shift(a, b):
    """(a.hi, b.lo): the pair one pixel right of a"""
    return torch.cat([hi(a), lo(b)], -1)


def neighbours(arr, q0, q1, a, W):
    """(lf, cc, rt) of pairs [q0, q1) of `arr` (..., pairs, 2): the pairs
    either side, as P::dup_lo / P::dup_hi of the centre at the image's border;
    any other neighbour must be held."""
    pr = arr.shape[-2]
    cc = arr[..., q0:q1, :]
    if a + 2 * q0 == 0:
        lf = torch.cat([torch.cat([lo(cc[..., :1, :])] * 2, -1), arr[..., q0:q1 - 1, :]], -2)
    else:
        assert q0 >= 1
        lf = arr[..., q0 - 1:q1 - 1, :]
    if a + 2 * (q1 - 1) + 2 >= W:
        rt = torch.cat([arr[..., q0 + 1:q1, :], torch.cat([hi(cc[..., -1:, :])] * 2, -1)], -2)
    else:
        assert q1 + 1 <= pr
        rt = arr[..., q0 + 1:q1 + 1, :]
    return lf, cc, rt


def blur_walk(images, gauss_w, motion_k, gates, plan=None):
    N, C, H, W = images.shape
    dt = images.dtype
    R, CW = plan or kb.band_plan(H, W, images.element_size())
    assert CW % 2 == 0
    out = torch.full_like(images, float("nan"))
    count = torch.zeros(images.shape, dtype=torch.int32)
    one = torch.ones((), dtype=dt)
    for n in range(N):
        w5 = list(gauss_w[n].to(dt))
        m9 = list(motion_k[n].reshape(9).to(dt))
        gg, mg = gates[n, 0].to(dt), gates[n, 1].to(dt)
        gg1, mg1 = one - gg, one - mg
        for r0 in range(0, H, R):
            r1 = min(H, r0 + R)
            l0, l1 = max(0, r0 - HALO), min(H, r1 + HALO)
            for x0 in range(0, W, CW):
                x1 = min(W, x0 + CW)
                a, b = max(0, x0 - 4), min(W, x1 + 4)
                cols = list(range(a, b)) + ([W - 1] if (b - a) % 2 else [])  # the pad repeats column W - 1
                pr = len(cols) // 2
                X = images[n][:, l0:l1][:, :, cols].reshape(C, l1 - l0, pr, 2).clone()

                def at(r):
                    r = min(max(r, 0), H - 1)
                    assert l0 <= r < l1
                    return r - l0

                g0, g1 = max(0, r0 - 1), min(H, r1 + 1)
                # vertical: rows [g0, g1), every held pair
                G = torch.full((C, g1 - g0, pr, 2), float("nan"), dtype=dt)
                for r in range(g0, g1):
                    G[:, r - g0] = tap5(w5, *[X[:, at(r + d)] for d in range(-2, 3)])
                # horizontal and the gate: pairs covering columns x0 - 2 .. x1 + 1, in place
                hq0, hq1 = (max(0, x0 - 2) - a) // 2, (min(W, x1 + 2) - a + 1) // 2
                lf, cc, rt = neighbours(G, hq0, hq1, a, W)
                v = gg * tap5(w5, lf, shift(lf, cc), cc, shift(cc, rt), rt) + gg1 * X[:, g0 - l0:g1 - l0, hq0:hq1]
                if W % 2 and a + 2 * hq1 - 1 == W:  # the pad repeats column W - 1
                    v[..., -1, 1] = v[..., -1, 0]
                X2 = torch.full_like(X, float("nan"))
                X2[:, g0 - l0:g1 - l0, hq0:hq1] = v
                # motion and its gate over the own pixels
                mq0, mq1 = (x0 - a) // 2, (x1 - a + 1) // 2
                rows = [X2[:, [at(r + ky - 1) for r in range(r0, r1)]] for ky in range(3)]
                lf, cc, rt = zip(*(neighbours(rw, mq0, mq1, a, W) for rw in rows))
                acc = torch.zeros_like(cc[0]) + m9[0] * shift(lf[0], cc[0])
                acc = acc + m9[1] * cc[0]
                acc = acc + m9[2] * shift(cc[0], rt[0])
                for ky in (1, 2):
                    acc = acc + m9[3 * ky] * shift(lf[ky], cc[ky])
                    acc = acc + m9[3 * ky + 1] * cc[ky]
                    acc = acc + m9[3 * ky + 2] * shift(cc[ky], rt[ky])
                v = (mg * acc + mg1 * cc[1]).reshape(C, r1 - r0, -1)[..., :x1 - x0]
                out[n, :, r0:r1, x0:x1] = v
                count[n, :, r0:r1, x0:x1] += 1
    assert bool((count == 1).all())
    return out


def _inputs(n, h, w, dt, seed):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(n, 3, h, w, generator=g).to(dt)
    gw = torch.softmax(torch.randn(n, 5, generator=g), 1)
    mk = torch.softmax(torch.randn(n, 9, generator=g), 1).reshape(n, 3, 3)
    gates = torch.tensor([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]])[torch.arange(n) % 3]
    return images, gw, mk, gates


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,plan", [((3, 40, 72), None), ((2, 17, 33), None), ((2, 70, 600), None),
                                        ((2, 17, 33), (4, 8)), ((3, 20, 40), (2, 12))],
                         ids=["40x72", "17x33-odd", "band-boundaries-70x600", "17x33-tiles", "20x40-tiles"])
def test_band_walk_matches_plain(shape, plan, dt):
    n, h, w = shape
    args = _inputs(n, h, w, dt, h * w)
    want = kb.fused_random_blur_plain(*args)
    got = blur_walk(*args, plan=plan)
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(256, 256), (17, 33), (70, 600), (128, 1920), (64, 20000), (1, 1)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_fits(h, w, itemsize):
    """A block's shared memory within the budget (one row of any width: a
    column tile), tiles of even width, bands covering the image evenly."""
    rows, cw = kb.band_plan(h, w, itemsize)
    tiles = -(-w // cw)
    pitch = (w + 1) // 2 if tiles == 1 else cw // 2 + 4
    assert cw % 2 == 0 and 1 <= rows <= h and kb.smem_bytes(rows, pitch, itemsize) <= kb.SMEM_BUDGET
    bands = -(-h // rows)
    assert (bands - 1) * rows < h <= bands * rows
