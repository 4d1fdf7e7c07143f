"""The Hopper stem weight-gradient kernel's decomposition on the CPU
(`argus_tpu_torch/csrc/stem_fused_bwd.cu`): the walk over 16x16 conv-pixel
tiles through zero-filled boxes, as the kernel stages them, against
`stem_bwd_plain`.

Per tile: y as a 19 x 19 box from conv row and column (i0 - 1, j0 - 1), out
and g as 9 x 9 boxes of the windows from (i0 / 2, j0 / 2), x as 37 rows x
128 elements of the (N, H, W * 3) view from input row 2 i0 - 3 and column
2 j0 - 8 (or, where W % 8 != 0, 4-byte words from that column), all zero
outside their tensors. The first-match search compares y with out as bits,
the cotangent passes where out > 0, each pixel's dacc sums its windows in
argus_tpu's order in f32 and rounds once, and the product takes
A[tap][pixel] from the patch at the kernel's offsets.

The inputs make ties: y takes a few levels (relu zeros among them), so out
equals y at several cells of most windows; the images' edges cut tiles.
dacc from the walk, put through the plain version's own weight-gradient
call, gives the plain version's bits; the walk's own product (float64)
agrees within f32 rounding.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels import stem_fused as ts
from argus_tpu_torch.ops.kernels._build import TICKET_WORDS

T = 16  # conv pixels a tile edge


def box(a: torch.Tensor, r0: int, c0: int, rows: int, cols: int) -> torch.Tensor:
    """a[r0 : r0 + rows, c0 : c0 + cols] of a 2-D-leading tensor, zero
    outside it (a TMA box's fill)."""
    out = torch.zeros((rows, cols) + a.shape[2:], dtype=a.dtype)
    rs, re = max(r0, 0), min(r0 + rows, a.shape[0])
    cs, ce = max(c0, 0), min(c0 + cols, a.shape[1])
    if rs < re and cs < ce:
        out[rs - r0:re - r0, cs - c0:ce - c0] = a[rs:re, cs:ce]
    return out


def patch_by_words(xv: torch.Tensor, r0: int, e0: int, W: int) -> torch.Tensor:
    """The cp.async form of the patch: 63 4-byte words a row from element e0
    (even), a word zero where its first element's column lies outside the
    image; it must equal the element-wise box over the words' 42 columns."""
    out = torch.zeros((37, 128), dtype=xv.dtype)
    for r in range(37):
        iy = r0 + r
        for wd in range(63):
            ix = (e0 + 2 * wd) // 3
            if 0 <= iy < xv.shape[0] and 0 <= ix < W:
                out[r, 2 * wd:2 * wd + 2] = xv[iy, e0 + 2 * wd:e0 + 2 * wd + 2]
    return out


def tile_walk(x, g, out, y, n_images: int):
    """(dacc (n_images, Hc, Wc, 64) bf16, dW (7, 7, 3, 64) float64) as the
    kernel's tiles compute them."""
    N, H, W, _ = x.shape
    Hc, Wc = y.shape[1:3]
    ty, tx = -(-Hc // T), -(-Wc // T)
    dacc = torch.zeros((n_images, ty * T, tx * T, 64), dtype=torch.bfloat16)
    dw = torch.zeros((147, 64), dtype=torch.float64)
    taps = [(ky, kx, ci) for ky in range(7) for kx in range(7) for ci in range(3)]
    tap_off = torch.tensor([ky * 128 + (kx + 5) * 3 + ci for ky, kx, ci in taps])
    pix = torch.tensor([2 * li * 128 + 6 * lj for li in range(T) for lj in range(T)])
    for n in range(n_images):
        xv = x[n].reshape(H, W * 3)
        for a in range(ty):
            for b in range(tx):
                i0, j0 = a * T, b * T
                yb = box(y[n], i0 - 1, j0 - 1, 19, 19).view(torch.int16)
                ob = box(out[n], i0 // 2, j0 // 2, 9, 9)
                gb = box(g[n], i0 // 2, j0 // 2, 9, 9)
                patch = box(xv, 2 * i0 - 3, 3 * (2 * j0 - 8), 37, 128)
                if W % 8:  # the 42 columns the words copy, of which the taps read 37
                    words = patch_by_words(xv, 2 * i0 - 3, 3 * (2 * j0 - 8), W)
                    assert torch.equal(words[:, :126], patch[:, :126])
                    patch = words
                # each window's first maximum: scanned backwards, the last match kept
                win = torch.full((9, 9, 64), 9)
                for kk in range(8, -1, -1):
                    yk = yb[kk // 3:kk // 3 + 17:2, kk % 3:kk % 3 + 17:2]
                    win = torch.where(yk == ob.view(torch.int16), kk, win)
                gated = torch.where(ob.float() > 0, gb.float(), 0.0)

                def take(du, dv, kk):  # the windows (a' + du, b' + dv) of every cell, where k wins
                    w, gg = win[du:du + 8, dv:dv + 8], gated[du:du + 8, dv:dv + 8]
                    return torch.where(w == kk, gg, 0.0)

                d = torch.zeros((T, T, 64))
                d[0::2, 0::2] = 0.0 + take(0, 0, 4)
                d[0::2, 1::2] = (0.0 + take(0, 1, 3)) + take(0, 0, 5)
                d[1::2, 0::2] = (0.0 + take(1, 0, 1)) + take(0, 0, 7)
                d[1::2, 1::2] = (((0.0 + take(1, 1, 0)) + take(1, 0, 2)) + take(0, 1, 6)) + take(0, 0, 8)
                li, lj = torch.arange(T)[:, None], torch.arange(T)[None, :]
                d = torch.where(((i0 + li < Hc) & (j0 + lj < Wc))[..., None], d, 0.0).to(torch.bfloat16)
                dacc[n, i0:i0 + T, j0:j0 + T] = d
                A = patch.reshape(-1)[pix[None, :] + tap_off[:, None]].double()  # (147, 256)
                dw += A @ d.reshape(T * T, 64).double()
    return dacc[:, :Hc, :Wc], dw.reshape(7, 7, 3, 64)


def plain_dw_of(x, dacc):
    """The plain version's weight-gradient call on a given dacc."""
    n = dacc.shape[0]
    dw = torch.nn.grad.conv2d_weight(x[:n].float().permute(0, 3, 1, 2), (64, 3, 7, 7),
                                     dacc.float().permute(0, 3, 1, 2), stride=2, padding=3)
    return dw.permute(2, 3, 1, 0).contiguous()


def _inputs(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, h, w, 3, generator=g).to(torch.bfloat16)
    levels = torch.randint(-2, 3, (n, h // 2, w // 2, 64), generator=g).float() / 4
    y = torch.relu(levels).to(torch.bfloat16)  # ties and relu zeros
    out = F.max_pool2d(y.float().permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    gr = torch.randn(out.shape, generator=g).to(torch.bfloat16)
    return x, gr, out, y


@pytest.mark.parametrize("n,h,w", [(4, 40, 72), (4, 36, 44)], ids=["w%8=0", "w%8=4"])
def test_tile_walk_matches_plain(n, h, w):
    x, gr, out, y = _inputs(n, h, w, 3 + w)
    for n_images in (n, n // 4):
        want = ts.stem_bwd_plain(x, gr, out, y, n_images)
        dacc, dw = tile_walk(x, gr, out, y, n_images)
        assert torch.equal(plain_dw_of(x, dacc), want), n_images  # the same dacc, bit for bit
        tol = 1e-5 * want.abs().max().item()
        assert (dw.float() - want).abs().max().item() <= tol, n_images
        assert int((dacc != 0).sum()) > 0


def test_ties_reach_several_cells():
    """The inputs hold windows where out equals y at two or more cells."""
    _, _, out, y = _inputs(1, 40, 72, 0)
    yp = F.pad(y.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    cols = F.unfold(yp, 3, stride=2).reshape(1, 64, 9, -1)
    ties = (cols == out.float().permute(0, 3, 1, 2).reshape(1, 64, 1, -1)).sum(2)
    assert int(((ties >= 2) & (out.float().permute(0, 3, 1, 2).reshape(1, 64, -1) > 0)).sum()) > 100


@pytest.mark.parametrize("tiles,sms", [(32768, 132), (8192, 132), (6, 132), (1, 132), (500, 114)])
def test_grid_and_groups(tiles, sms):
    """One block an SM at most one a tile; groups of about sqrt(blocks) and
    the tickets (groups + 1) within the host's counters."""
    blocks, gsize = ts.bwd_grid(tiles, sms)
    assert blocks == min(tiles, sms) and gsize >= 1
    per = -(-tiles // blocks)
    used = -(-tiles // per)  # the kernel's grid: every block has a tile
    groups = -(-used // gsize)
    assert groups + 1 <= TICKET_WORDS and used <= blocks and (used - 1) * per < tiles <= used * per
    assert np.isclose(gsize, blocks ** 0.5, atol=0.5)

