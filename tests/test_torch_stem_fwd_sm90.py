"""The Hopper stem forward's decomposition on the CPU
(`argus_tpu_torch/csrc/stem_fused.cu`): its walk, modelled step by step,
against `stem_fwd_save_plain`.

The model follows the kernel: pooled rows (image, 64-column segment, row)
split into the streams of persistent blocks (three a block), each stream's
runs of rows into jobs that walk their conv rows in order (row 2 pa - 1
computed for the carry, none at the top); each input row staged as TMA
one bulk copy of x viewed as (N, H, 3W) from element 6 (2 px0 - 3) - 6, its
part inside the row (or 4-byte words, zero outside, where W % 8 != 0), then
staged by the consumer into 139 pair slots of 8 bf16 (two columns, two
zeros; zeros outside the image) in a ring of 10 rows; the
product D = A (64 channels x K) B (K x 136 positions) in 14 k16 steps, B
read through the K-major no-swizzle descriptor (slot t + 2 (ks % 2) + k / 8,
element k % 8 of the input row 2c - 3 + ks / 2) and A the folded weights in
the kernel's K order; the epilogue on the wgmma accumulator fragment of
each of the 128 threads (the quad shuffle for the horizontal max, conv
column -1 as -inf), bias, relu and one rounding, the vertical max over
conv rows with the carried row, and the own y columns of each row.

The products run in float64 (exact for these bf16 operands) and match
the plain version's float64 conv; the outputs (f32 sums rounded to bf16)
lie within one bf16 ulp of the plain version, and out equals the window
max of y as bits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels import stem_fused as ts

SEG_P, POS, PAIRS, KSTEPS, STREAMS, RING = 64, 136, 139, 14, 3, 10
RAW_ELEMS = 1024


def streams_of(units: int, sms: int):
    """The kernel's split: [(first unit, end)] of each stream, blocks =
    min(SMs, ceil(units / 2))."""
    blocks = max(1, min(sms, -(-units // STREAMS)))
    per = -(-units // (STREAMS * blocks))
    return [(s * per, min(units, s * per + per)) for s in range(STREAMS * blocks)]


def jobs_of(u, ue, hp, segs):
    """A stream's jobs (n, s, pa, pb): runs of pooled rows of one image and segment."""
    while u < ue:
        ns, pa = divmod(u, hp)
        pb = min(hp, pa + (ue - u))
        n, s = divmod(ns, segs)
        yield n, s, pa, pb
        u += pb - pa


def first_conv(pa):
    return 0 if pa == 0 else 2 * pa - 1


def raw_row(xv, n, row, s, W, bulk: bool):
    """Raw row: elements 768 s - 24 .. + 1023 of x[n] viewed as (H, 3W): one
    bulk copy of those inside the row (16-byte multiples at W % 8 == 0; the
    rest of the slot holds stale data, here NaN), or the cp.async words 3 ..
    419, zero outside the image (a word's two elements share a column: its
    start is even, and so are 0 and 3W)."""
    H = xv.shape[1]
    e0 = 12 * SEG_P * s - 24
    out = torch.full((RAW_ELEMS,), float("nan"), dtype=xv.dtype)
    if bulk:
        lo, hi = max(0, e0), min(3 * W, e0 + RAW_ELEMS)
        assert lo % 8 == 0 and hi % 8 == 0 and (lo - e0) % 8 == 0
        if 0 <= row < H:
            out[lo - e0:hi - e0] = xv[n, row, lo:hi]
        return out
    for wd in range(3, 3 + 3 * PAIRS):
        e = e0 + 2 * wd
        ok = 0 <= row < H and 0 <= e < 3 * W
        if ok:
            assert e + 1 < 3 * W and (e // 3 == (e + 1) // 3 or (e + 1) % 3 == 0)
        out[2 * wd:2 * wd + 2] = xv[n, row, e:e + 2] if ok else 0.0
    return out


def pair_slots(raw, row, s, H, W):
    """The 139 pair slots the consumer stages from a raw row: elements
    6q + 6 .. 6q + 11 (pair 2 px0 - 3 + q), then two zeros; zero where the row
    or the pair lies outside the image."""
    slots = torch.zeros((PAIRS, 8), dtype=raw.dtype)
    for q in range(PAIRS):
        pr = 2 * SEG_P * s - 3 + q
        if 0 <= row < H and 0 <= pr and 2 * pr < W:
            slots[q, :6] = raw[6 * q + 6:6 * q + 12]
    assert not bool(slots.isnan().any())
    return slots


def fold_w(w, ch, ks, k):
    """The kernel's K order: kernel row ks / 2, pair b = 2 (ks % 2) + k / 8,
    element e = k % 8 (column e / 3, channel e % 3; 6, 7 zero), kernel column
    2b + e / 3 - 1."""
    ky, b, e = ks >> 1, 2 * (ks & 1) + (k >> 3), k & 7
    kx = 2 * b + e // 3 - 1
    if e >= 6 or kx < 0:
        return 0.0
    return float(w[ky, kx, e % 3, ch])


def a_matrix(w):
    """(14, 64, 16) float64 of the folded weights, as the A fragments hold them."""
    a = np.zeros((KSTEPS, 64, 16))
    for ks in range(KSTEPS):
        for k in range(16):
            for ch in range(64):
                a[ks, ch, k] = fold_w(w, ch, ks, k)
    return a


def b_matrix(slot_rows, ks):
    """(16, 136) of k-step ks through the descriptor: position t, k at slot
    t + 2 (ks % 2) + k / 8 (LBO 16 bytes, SBO 128), element k % 8."""
    rows = slot_rows[ks >> 1]
    t = np.arange(POS)[None, :]
    k = np.arange(16)[:, None]
    return rows[t + 2 * (ks & 1) + (k >> 3), k & 7]


def epilogue_hmax(d, px0):
    """The horizontal max on the accumulator fragments: thread (warp w, lane
    4g + q) holds d[4jj + e] = D[16w + g + 8 (e // 2), 8jj + 2q + e % 2]; pooled
    column 4jj + q takes its own two and the value its quad neighbour sends
    (lane q + 1, which sends group jj + 1's first for q' = 0). (64, 64) f32."""
    hm = np.zeros((64, SEG_P), np.float32)
    for w4 in range(4):
        frag = np.zeros((32, 4 * (POS // 8)), np.float32)
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for jj in range(POS // 8):
                for e in range(4):
                    frag[lane, 4 * jj + e] = d[16 * w4 + g + 8 * (e // 2), 8 * jj + 2 * q + e % 2]
        for jj in range(16):
            for hh in range(2):
                send = np.array([frag[l, 4 * jj + 4 + 2 * hh] if l & 3 == 0 else frag[l, 4 * jj + 2 * hh]
                                 for l in range(32)])
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    v0 = frag[lane, 4 * jj + 2 * hh]
                    if jj == 0 and q == 0 and px0 == 0:
                        v0 = -np.inf
                    nxt = send[(lane & ~3) | ((lane + 1) & 3)]
                    hm[16 * w4 + g + 8 * hh, 4 * jj + q] = max(v0, frag[lane, 4 * jj + 2 * hh + 1], nxt)
    return hm


def f_of(v, b):
    """bias, relu, one rounding: f32 -> bf16"""
    return torch.relu(torch.from_numpy(np.asarray(v, np.float32)) + b).to(torch.bfloat16)


def stem_walk(x, w, b, sms, check_rows=None):
    """(out, y, conv sums float64 (N, Hc, Wc, 64)) as the kernel's streams
    compute them; every pooled row once, every y position once."""
    N, H, W, _ = x.shape
    Hc, Wc, Hp, Wp = H // 2, W // 2, H // 4, W // 4
    segs = -(-Wp // SEG_P)
    units = N * segs * Hp
    xv = x.reshape(N, H, 3 * W)
    bulk = W % 8 == 0
    a = a_matrix(w)
    bias = b.reshape(64).float()
    out = torch.zeros((N, Hp, Wp, 64), dtype=torch.bfloat16)
    y = torch.zeros((N, Hc, Wc, 64), dtype=torch.bfloat16)
    sums = np.full((N, Hc, Wc, 64), np.nan)
    out_n = torch.zeros((N, Hp, Wp), dtype=torch.int32)
    y_n = torch.zeros((N, Hc, Wc), dtype=torch.int32)
    for u0, ue in streams_of(units, sms):
        rb = staged = 0
        for n, s, pa, pb in jobs_of(u0, ue, Hp, segs):
            px0 = SEG_P * s
            cs, ce = first_conv(pa), 2 * pb
            rows_in = list(range(2 * cs - 3, 4 * pb + 2))  # the producer's rows of the job
            slots = {rb + i: pair_slots(raw_row(xv, n, r, s, W, bulk), r, s, H, W).double().numpy()
                     for i, r in enumerate(rows_in)}
            carry = torch.zeros((64, SEG_P), dtype=torch.bfloat16)
            run = carry
            for c in range(cs, ce):
                r0 = rb + 2 * (c - cs)
                assert [rows_in[r - rb] for r in range(r0, r0 + 7)] == [2 * c - 3 + ky for ky in range(7)]
                # the consumer stages the rows it reads first into ring slots
                # r % RING; the row a slot held must not be read by this conv
                # row, nor, but at a job's first (a barrier there), the last
                for r in range(staged, r0 + 7):
                    assert r - RING < (r0 if c == cs else r0 - 2)
                staged = r0 + 7
                d = sum(a[ks] @ b_matrix([slots[r0 + ky] for ky in range(7)], ks) for ks in range(KSTEPS))
                cols = 2 * px0 - 1 + np.arange(POS)
                ok = (cols >= 0) & (cols < Wc)
                sums[n, c, cols[ok]] = d[:, ok].T
                d32 = d.astype(np.float32)
                h = f_of(epilogue_hmax(d32, px0), bias[:, None])
                carry_row = c == cs and pa > 0
                if c % 2 == 0:
                    run = torch.maximum(carry, h)
                else:
                    if not carry_row:
                        o = torch.maximum(run, h)
                        k = min(SEG_P, Wp - px0)
                        out[n, (c - 1) // 2, px0:px0 + k] = o[:, :k].T
                        out_n[n, (c - 1) // 2, px0:px0 + k] += 1
                    carry = h
                if not carry_row:  # y's own columns: positions 1 .. 128
                    own = (np.arange(POS) >= 1) & (np.arange(POS) <= 128) & ok
                    yv = f_of(d32[:, own], bias[:, None])
                    y[n, c, cols[own]] = yv.T
                    y_n[n, c, cols[own]] += 1
            rb += len(rows_in)
    assert bool((out_n == 1).all()) and bool((y_n == 1).all())
    return out, y, sums


def ulp_close(got, want):
    a, b = got.float(), want.float()
    return bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6 * b.abs().max()).all())


def _inputs(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, h, w, 3, generator=g).to(torch.bfloat16)
    wt = (torch.randn(7, 7, 3, 64, generator=g) / 147 ** 0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn(1, 64, generator=g)
    return x, wt, b


@pytest.mark.parametrize("n,h,w,sms", [(2, 40, 72, 132), (2, 36, 44, 3), (1, 16, 520, 2), (1, 200, 136, 5)],
                         ids=["w%8=0", "w%8=4-cp.async", "three-segments", "ragged-200x136"])
def test_walk_matches_plain(n, h, w, sms):
    x, wt, b = _inputs(n, h, w, 5 + w)
    out, y, sums = stem_walk(x, wt, b, sms)
    pout, py = ts.stem_fwd_save_plain(x, wt, b)
    conv = F.conv2d(x.double().permute(0, 3, 1, 2), wt.double().permute(3, 2, 0, 1), stride=2, padding=3)
    assert np.allclose(sums, conv.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-12)
    assert ulp_close(y, py) and ulp_close(out, pout)
    # out is the window max of y, bit for bit (the backward's first-match search relies on it)
    yp = F.pad(y.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    want = F.max_pool2d(yp, 3, 2).to(torch.bfloat16).permute(0, 2, 3, 1)
    assert torch.equal(out.view(torch.int16), want.contiguous().view(torch.int16))


def test_k_order_covers_each_tap_once():
    """The 14 x 16 k of the A fragments hold each of the 147 taps once (the
    rest zeros), and the B descriptor's element is that tap's input."""
    w = torch.arange(1, 7 * 7 * 3 * 64 + 1, dtype=torch.float64).reshape(7, 7, 3, 64)
    a = a_matrix(w)
    seen = sorted(int(v) for v in a[:, 0, :].ravel() if v)
    assert seen == sorted(int(w[ky, kx, c, 0]) for ky in range(7) for kx in range(7) for c in range(3))
    # B: k-step (ky, bb), position t reads pair t + 2bb + k // 8 - 3 relative to
    # 2 px0 - 3, element (column (k % 8) // 3, channel (k % 8) % 3)
    for ks in range(KSTEPS):
        for k in range(16):
            e = k & 7
            if e >= 6:
                continue
            kx = 2 * (2 * (ks & 1) + (k >> 3)) + e // 3 - 1
            if kx < 0:
                continue
            t = 5  # conv column 2 px0 - 1 + t reads input column 2 (2 px0 - 1 + t) - 3 + kx
            pair = t + 2 * (ks & 1) + (k >> 3)  # slot: pair 2 px0 - 3 + slot
            col = 2 * (pair - 3) + e // 3  # relative to 2 px0
            assert col == 2 * (t - 1) - 3 + kx


def test_streams_cover_every_unit_once():
    for units in (1, 7, 263, 264, 32768):
        for sms in (1, 132):
            spans = streams_of(units, sms)
            covered = np.zeros(units, int)
            for u, ue in spans:
                covered[u:ue] += 1
            assert (covered == 1).all() and len(spans) <= STREAMS * sms
