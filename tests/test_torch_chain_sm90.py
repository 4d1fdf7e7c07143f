"""The stage chain's backward and the BasicBlock forward as their Hopper
kernels compute them, on the CPU.

- The chain backward (`csrc/stage_fused_bwd.cu`) runs each block from its
  masked cotangent m3: the incoming g is masked once, and every other m3 is
  written by the dx launch of the block after it, whose epilogue applies the
  relu mask of that block's input. A plain twin of that decomposition, in
  the kernel's launch order and rounding points, is bit-equal to
  `stage_fused.stage_bwd_plain` (a 0/1 mask after a rounding is exact) and
  within the chain's tolerance of argus_tpu's `_chain_bwd_pallas` in
  interpret mode.
- The chain's weight-gradient workspace (`stage_fused.chain_wgrad_plans`,
  sized with `wgrad_plan`) lists the `wgrad_sm90(` launches of the two
  compositions (read from `identity_bwd_sm90.cuh` and `proj_bwd_sm90.cuh`,
  in the chain's order from `stage_fused_bwd.cu`) and holds each one's
  partials.
- The TMA forward engine's residual epilogue (bias, then the f32 residual,
  then relu, then one rounding) over an f32 accumulator is bit-equal to
  `basic_fused.basic_fwd_plain`; the identity bottleneck forward's three
  launches of that engine (read from `csrc/block_fused.cu`), each with its
  epilogue, are bit-equal to `block_fused.bottleneck_block_save_plain`.
- That engine's operands (`csrc/conv_fwd_sm90.cuh`): per tile, tap and 64
  channels, one TMA box of A in the launcher's box shape and boxes of the
  3-D weight map, both zero-filled outside their tensors (past C too),
  compute the padded 3x3 conv and the 1x1, each output pixel once, at any
  C and COUT that are multiples of 8.

Inputs are made with numpy from a seed; the chain is held to argus_tpu as
tests/test_torch_kernels.py holds it: within 2e-4 (f32) or 2e-2 (bf16) of
each output's largest magnitude.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import stage_fused as jst
from argus_tpu_torch.ops.kernels import basic_fused as tbf
from argus_tpu_torch.ops.kernels import block_fused as tbk
from argus_tpu_torch.ops.kernels import stage_fused as tst
from argus_tpu_torch.ops.kernels import wgrad_plan
from argus_tpu_torch.ops.kernels.block_fused import conv3x3_f32, conv3x3_grads_f32, matmul_f32, relu_mask, wgrad_f32

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 2e-4, "bfloat16": 2e-2}
CSRC = Path(tst.__file__).resolve().parents[2] / "csrc"


# ───────────────────── the chain's decomposition, in plain torch ─────────────────────


def _identity_from_m3(x, m3, h1, h2, w1, w2, w3, dx_mask, need_dx):
    """identity_block_bwd_m3_sm90's launches: m2, dw3, m1, dw2, dx (masked
    by dx_mask after its one rounding), dw1."""
    dt = x.dtype
    m2 = relu_mask((m3.float() @ w3.float().t()).to(dt), h2)
    dw3 = wgrad_f32(h2, m3)
    dh1, dw2 = conv3x3_grads_f32(h1, m2, w2, 1)
    m1 = relu_mask(dh1.to(dt), h1)
    dx = None
    if need_dx:
        dx = (m1.float() @ w1.float().t() + m3.float()).to(dt)
        if dx_mask is not None:
            dx = relu_mask(dx, dx_mask)
    dw1 = wgrad_f32(x, m1)
    return dx, dw1, dw2, dw3


def _projection_from_m3(x, m3, h1, h2, w1, w2, w3, wsc, s, need_dx):
    """projection_block_bwd_m3_sm90's launches (no dx mask: the chain's own
    dx is written unmasked)."""
    dt = x.dtype
    m2 = relu_mask((m3.float() @ w3.float().t()).to(dt), h2)
    dw3 = wgrad_f32(h2, m3)
    dwsc = wgrad_f32(x[:, ::s, ::s], m3)
    dh1, dw2 = conv3x3_grads_f32(h1, m2, w2, s)
    m1 = relu_mask(dh1.to(dt), h1)
    dx = None
    if need_dx:
        acc = m1.float() @ w1.float().t()
        acc[:, ::s, ::s] += m3.float() @ wsc.float().t()
        dx = acc.to(dt)
    dw1 = wgrad_f32(x, m1)
    return dx, dw1, dw2, dw3, dwsc


def chain_bwd_twin(x, g, out, bnds, h1s, h2s, proj_w, id_w, stride, need_dx):
    """argus_stage_bwd's decomposition: g masked once, each identity block
    from its m3 with its dx masked by the block before's output, the chain's
    dx unmasked."""
    has_proj = proj_w is not None
    m3 = relu_mask(g, out)
    id_dws = [None] * len(id_w)
    for j in reversed(range(len(id_w))):
        b = j + has_proj
        x_b = x if b == 0 else bnds[b - 1]
        dmask = bnds[b - 1] if b > 0 else None
        m3, *dws = _identity_from_m3(x_b, m3, h1s[b], h2s[b], *id_w[j], dmask, need_dx or b > 0)
        id_dws[j] = tuple(dws)
    proj_dws = None
    if has_proj:
        m3, *dws = _projection_from_m3(x, m3, h1s[0], h2s[0], *proj_w, stride, need_dx)
        proj_dws = tuple(dws)
    return m3, proj_dws, id_dws


# chains (stride, with the projection, identity blocks): the stage-0 form, a
# stride-2 entry, identity blocks alone
CHAINS = [(1, True, 2), (2, True, 2), (1, False, 3)]


def _folded(rng, cin, f, cout, projection):
    def w(*shape):
        return (rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    def b(c):
        return rng.normal(0, 0.1, (1, c)).astype(np.float32)

    ws = [w(cin, f), b(f), w(3, 3, f, f), b(f), w(f, cout), b(cout)]
    return ws + ([w(cin, cout), b(cout)] if projection else [])


@functools.lru_cache(maxsize=None)
def _chain_case(stride, with_proj, k, dtype):
    """The chain's inputs and saved residuals (from argus_tpu's saving
    forward) as torch tensors, and argus_tpu's backward (dx and every dw)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(20 + stride + 2 * with_proj)
    cin, f, cout = (32, 16, 64) if with_proj else (64, 16, 64)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, cin))).astype(np.float32)
    pw = [jnp.asarray(a).astype(jdt) if i % 2 == 0 else jnp.asarray(a)
          for i, a in enumerate(_folded(rng, cin, f, cout, True))] if with_proj else None
    ids = [[jnp.asarray(a).astype(jdt) if i % 2 == 0 else jnp.asarray(a)
            for i, a in enumerate(_folded(rng, cout, f, cout, False))] for _ in range(k)]
    xj = jnp.asarray(x).astype(jdt)
    outs = jst._chain_fwd_pallas(xj, pw, ids, stride, True, 1, save=True)
    nb = (1 if with_proj else 0) + k
    out, bnds, hs = outs[0], list(outs[1:nb]), outs[nb:]
    h1s, h2s = list(hs[0::2]), list(hs[1::2])
    g = jnp.asarray(rng.normal(0, 1, out.shape)).astype(jdt)
    jpw = (pw[0], pw[2], pw[4], pw[6]) if with_proj else None
    jids = [(w[0], w[2], w[4]) for w in ids]
    want = jst._chain_bwd_pallas(xj, g, out, bnds, h1s, h2s, jpw, jids, stride, True, 1)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(tdt)

    args = (t(xj), t(g), t(out), [t(a) for a in bnds], [t(a) for a in h1s], [t(a) for a in h2s],
            tuple(t(a) for a in jpw) if with_proj else None, [tuple(t(a) for a in w) for w in jids], stride)
    return args, [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in want]


def _flat(res):
    dx, pd, idd = res
    return [dx, *(pd or ()), *[d for ds in idd for d in ds]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("stride,with_proj,k", CHAINS)
def test_chain_decomposition_matches_the_plain_chain_and_pallas(stride, with_proj, k, need_dx, dtype):
    args, want = _chain_case(stride, with_proj, k, dtype)
    twin = _flat(chain_bwd_twin(*args, need_dx))
    plain = _flat(tst.stage_bwd_plain(*args, need_dx=need_dx))
    assert (twin[0] is None) == (not need_dx) and (plain[0] is None) == (not need_dx)
    for a, b in zip(twin, plain):
        assert (a is None and b is None) or torch.equal(a, b)
    # argus_tpu's chain always returns dx: held to the twin's where it is asked for
    for a, b in zip(twin, want):
        if a is not None:
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=REL[dtype] * max(np.abs(b).max(), 1e-12))


# ───────────────────── the chain's weight-gradient workspace ─────────────────────

N_IMG = 512
# chains (n, h, w, cin, f, cout, stride, identity blocks, with the projection):
# ResNet-50's stage-0 chain and its whole-stage stride-2 chains at N = 512,
# 256x256 frames, a chain of identity blocks alone, and card-test shapes
WS_CHAINS = [
    (N_IMG, 64, 64, 64, 64, 256, 1, 2, True),
    (N_IMG, 64, 64, 256, 128, 512, 2, 3, True),
    (N_IMG, 32, 32, 512, 256, 1024, 2, 5, True),
    (N_IMG, 16, 16, 1024, 512, 2048, 2, 2, True),
    (N_IMG, 32, 32, 512, 128, 512, 1, 3, False),
    (3, 9, 13, 64, 64, 256, 1, 2, True),
    (3, 18, 26, 64, 64, 256, 2, 3, True),
    (4, 32, 32, 64, 64, 256, 1, 2, True),
]


def _wgrad_launches(header: str, function: str, dims: dict):
    """(rows, C, COUT, kernel size) of each `wgrad_sm90(a, H, W, C, ks,
    stride, pad, b, COUT, N, Ho, Wo, ...)` call in `function`'s body."""
    src = (CSRC / header).read_text()
    start = src.index(f"inline cudaError_t {function}(")
    body = src[start:src.index("\n}\n", start)]
    launches = []
    for args in re.findall(r"wgrad_sm90\(([^;]*)\);", body):
        a = [t.strip() for t in args.split(",")]
        launches.append((dims[a[9]] * dims[a[10]] * dims[a[11]], dims[a[3]], dims[a[8]], int(a[4])))
    return launches


def _call_dims(function: str):
    """The geometry arguments stage_fused_bwd.cu passes `function` (the
    names before the stream)."""
    src = (CSRC / "stage_fused_bwd.cu").read_text()
    args = src[src.index(f"{function}("):].split(";")[0]
    names = [t.strip() for t in args[args.index("(") + 1:args.rindex(")")].split(",")]
    return names[:-1]


@pytest.mark.parametrize("n,h,w,cin,f,cout,s,k,with_proj", WS_CHAINS)
def test_chain_workspace_holds_every_hopper_weight_gradient(n, h, w, cin, f, cout, s, k, with_proj):
    plans = tst.chain_wgrad_plans(n, h, w, cin, f, cout, s, k, with_proj)
    ho, wo = h // s, w // s
    chain = {"N": n, "H": h, "W": w, "Ho": ho, "Wo": wo, "CIN": cin, "F": f, "COUT": cout, "S": s}
    # the identity blocks run at (Ho, Wo) with CIN = COUT, the projection at the stage input
    id_geom = dict(zip(("N", "H", "W", "CIN", "F"), (chain[d] for d in _call_dims("identity_block_bwd_m3_sm90")[-5:])))
    launches = k * _wgrad_launches("identity_bwd_sm90.cuh", "identity_block_bwd_m3_sm90", id_geom)
    if with_proj:
        pr = dict(zip(("N", "H", "W", "CIN", "F", "COUT", "S"),
                      (chain[d] for d in _call_dims("projection_block_bwd_m3_sm90")[-7:])))
        pr.update(Ho=pr["H"] // pr["S"], Wo=pr["W"] // pr["S"])
        launches += _wgrad_launches("proj_bwd_sm90.cuh", "projection_block_bwd_m3_sm90", pr)
    assert plans == launches
    ws = wgrad_plan.workspace(*plans)
    for prob in launches:
        assert wgrad_plan.plan(*prob).partial_elems <= ws
    assert ws * 4 < 256 * 2**20


# ───────────────────── the forward's residual epilogue ─────────────────────


def _epilogue(acc, bias, residual, dtype, residual_first=False):
    """The TMA forward engine's epilogue on an f32 accumulator: + bias, then +
    f32(residual) where there is one, relu, one rounding (or the residual
    first, to show the order matters)."""
    b = bias.float().reshape(-1)
    if residual is None:
        return torch.clamp_min(acc + b, 0.0).to(dtype)
    r = residual.float()
    v = (acc + r) + b if residual_first else (acc + b) + r
    return torch.clamp_min(v, 0.0).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_residual_epilogue_matches_the_plain_forward(dtype):
    rng = np.random.default_rng(30)
    c = 64
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, c)).astype(np.float32)).to(dtype)
    w1, w2 = (torch.from_numpy((rng.normal(0, 1, (3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)).to(dtype)
              for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.normal(0, 0.1, (1, c)).astype(np.float32)) for _ in range(2))
    out, h1 = tbf.basic_fwd_plain(x, w1, b1, w2, b2, save=True)
    # conv1's epilogue (bias, relu, one rounding) and conv2's over their f32 accumulators
    assert torch.equal(torch.clamp_min(conv3x3_f32(x, w1, 1) + b1.reshape(-1), 0.0).to(dtype), h1)
    acc = conv3x3_f32(h1, w2, 1)
    assert torch.equal(_epilogue(acc, b2, x, dtype), out)
    if dtype == torch.float32:  # the order is visible in f32: the residual first gives other bits
        assert not torch.equal(_epilogue(acc, b2, x, dtype, residual_first=True), out)


# ───────────────────── the identity forward's three launches ─────────────────────


def _fwd_launches():
    """(KS, src, w, bias, residual, out, C, COUT) of each
    `launch_conv_fwd_tma<KS>(src, w, bias, residual, out, N, H, W, C, COUT,
    stream)` call of csrc/block_fused.cu, in order."""
    src = (CSRC / "block_fused.cu").read_text()
    calls = re.findall(r"launch_conv_fwd_tma<(\d)>\(([^;]*)\);", src)
    return [(int(ks), *[t.strip() for t in args.split(",")][:5], *[t.strip() for t in args.split(",")][8:10])
            for ks, args in calls]


# (n, h, w, cin, f): a main-path width at a small size, F below 64, and
# CIN 72 with F 24 (no launch in whole 64-channel steps)
ID_FWD_CASES = [(2, 8, 8, 256, 64), (2, 9, 7, 64, 16), (2, 6, 5, 72, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,f", ID_FWD_CASES)
def test_identity_forward_launches_match_the_plain_block(n, h, w, cin, f, dtype):
    """The launches of argus_block_fwd as the engine computes them: a conv of
    kernel size KS over src into an f32 accumulator, then its epilogue
    (bias, the residual, relu, one rounding), h1 and h2 through memory; bit
    for bit the plain saving forward (out, h1, h2)."""
    rng = np.random.default_rng(32)
    ws = _folded(rng, cin, f, cin, False)
    names = ("w1", "bias1", "w2", "bias2", "w3", "bias3")  # block_fused.cu's names
    t = {name: torch.from_numpy(a).to(dtype) if i % 2 == 0 else torch.from_numpy(a)
         for i, (name, a) in enumerate(zip(names, ws))}
    t["x"] = torch.from_numpy(np.abs(rng.normal(0, 1, (n, h, w, cin))).astype(np.float32)).to(dtype)
    dims = {"CIN": cin, "F": f}
    launches = _fwd_launches()
    assert [(ks, a[-2], a[-1]) for ks, *a in launches] == [(1, "CIN", "F"), (3, "F", "F"), (1, "F", "CIN")]
    for ks, src, wname, bias, res, out, c, cout in launches:
        a, wt = t[src], t[wname]
        assert a.shape[-1] == dims[c] and wt.shape[-1] == dims[cout]
        acc = conv3x3_f32(a, wt, 1) if ks == 3 else matmul_f32(a, wt)
        resid = None if res == "nullptr" else t[res]
        t[out] = _epilogue(acc, t[bias], resid, dtype)
    want = tbk.bottleneck_block_save_plain(t["x"], *(t[k] for k in names))
    for got, ref in zip((t["out"], t["h1"], t["h2"]), want):
        assert torch.equal(got, ref)


# ───────────────────── the forward's operands as TMA boxes ─────────────────────

FWD_SRC = (CSRC / "conv_fwd_sm90.cuh").read_text()


def _launcher_box(h: int, w: int):
    """(bw, bh, bn) of a tile as csrc/conv_fwd_sm90.cuh's launcher picks it:
    W and H rounded up to powers of two under the caps read from the
    header, bn = 128 / (bw * bh)."""
    caps = {d: int(re.search(rf"p\.b{d} = pow2\({d.upper()}, (\d+)\);", FWD_SRC).group(1)) for d in ("w", "h")}

    def pow2(v, cap):
        b = 1
        while b < v and b < cap:
            b *= 2
        return b

    bw, bh = pow2(w, caps["w"]), pow2(h, caps["h"])
    assert 128 % (bw * bh) == 0
    return bw, bh, 128 // (bw * bh)


def _c_expr(pattern: str):
    """The C++ integer expression(s) the pattern captures in the engine's
    header, as Python functions of their variables (/ is integer division
    of non-negative ints here, `p.` dropped)."""
    m = re.search(pattern, FWD_SRC)
    assert m, pattern
    return [eval("lambda **v: " + re.sub(r"\b([A-Za-z_]\w*)\b", r"v['\1']", e.strip().replace("p.", "").replace("/", "//")))
            for e in m.groups()]


def _engine_steps(ks: int, c: int):
    """The producer's walk of one tile, read from the header: for each step
    (tap, 64-channel block), the A box's offsets from the tile's corner
    (channel, column, row, image) and the weight box's (gradient channel
    offset from n0, channel, tap) as functions of the block b of 64
    gradient channels."""
    (cb_of,) = _c_expr(r"const int CB = ([^;]*);")
    (t_of,) = _c_expr(r"const int T = ([^;]*);")
    (pad,) = _c_expr(r"constexpr int kPad = ([^;]*);")
    (tap_of,), (cbk_of,) = _c_expr(r"const int tap = ([^;]*);"), _c_expr(r"const int cb = ([^;]*);")
    ky_of, kx_of = _c_expr(r"const int ky = ([^,]*), kx = ([^;]*);")
    a_box = _c_expr(r"tma_load_4d\(sA\(st\), &p\.amap, &full\[st\], ([^,]*), ([^,]*), ([^,]*), ([^;]*)\);")
    b_box = _c_expr(r"tma_load_3d\(sB\(st\) \+ b \* 8192, &p\.wmap, &full\[st\], ([^,]*), ([^,]*), ([^;]*)\);")
    (taps,) = _c_expr(r"make_tmap_wrows\(&p\.wmap, w, ([^,]*), C, COUT\)")
    assert taps(KS=ks) == ks * ks
    cbs = cb_of(C=c)
    kpad = pad(KS=ks)
    for ts in range(t_of(KS=ks, CB=cbs)):
        tap = tap_of(ts=ts, CB=cbs)
        cb = cbk_of(ts=ts, tap=tap, CB=cbs)
        ky = ky_of(tap=tap, KS=ks)
        kx = kx_of(tap=tap, KS=ks, ky=ky)
        env = dict(cb=cb, kx=kx, ky=ky, kPad=kpad, tap=tap, ow0=0, oh0=0, n0=0)
        yield ([f(**env) for f in a_box], lambda b, env=env: [f(**env, c0=0, b=b) for f in b_box])


def _tma_box(t, start, box):
    """A tiled TMA box of tensor t (dims outermost first) at `start` with
    extents `box`: the elements inside t, zeros where the box runs past it
    on any side."""
    out = torch.zeros(*box, dtype=t.dtype)
    src, dst = [], []
    for o, b, d in zip(start, box, t.shape):
        lo, hi = max(o, 0), min(o + b, d)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - o, hi - o))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _engine_conv(x, wt, ks: int, bn: int = 128):
    """The TMA forward engine's decomposition of a KS x KS "same" conv: per
    tile of 128 output pixels (the launcher's box) and `bn` gradient
    channels, per step of the header's walk, A is one box of the NHWC source
    at the tile's corner plus the step's offsets, B the bn/64 boxes of the
    (taps, C, COUT) weight map; the rows inside the tensor, each written
    once, are the output. Returns (out, writes per output pixel)."""
    n, h, w, c = x.shape
    cout = wt.shape[-1]
    wmap = wt.reshape(ks * ks, c, cout)
    bw, bh, bnimg = _launcher_box(h, w)
    steps = list(_engine_steps(ks, c))
    out = torch.zeros(n, h, w, cout)
    hits = torch.zeros(n, h, w, cout, dtype=torch.int64)
    r = torch.arange(128)
    ni, hi, wi = r // (bw * bh), (r % (bw * bh)) // bw, r % bw
    for n0 in range(0, n, bnimg):
        for oh0 in range(0, h, bh):
            for ow0 in range(0, w, bw):
                for c0 in range(0, cout, bn):
                    acc = torch.zeros(128, bn)
                    for (ca, da, dh, dn), b_of in steps:
                        a = _tma_box(x, (n0 + dn, oh0 + dh, ow0 + da, ca), (bnimg, bh, bw, 64)).reshape(128, 64)
                        b = torch.cat([_tma_box(wmap, (tap, cw, c0 + nb), (1, 64, 64))[0]
                                       for nb, cw, tap in (b_of(j) for j in range(bn // 64))], dim=1)
                        acc += a.float() @ b.float()
                    keep = (n0 + ni < n) & (oh0 + hi < h) & (ow0 + wi < w)
                    idx = (n0 + ni[keep], oh0 + hi[keep], ow0 + wi[keep])
                    cols = slice(c0, min(c0 + bn, cout))
                    out[idx + (cols,)] = acc[keep][:, :cols.stop - c0]
                    hits[idx + (cols,)] += 1
    return out, hits


# (n, h, w, c, cout): ResNet-18's stage-3 tile (two 8 x 8 images) and
# ragged and small images, boxes overrunning the tensor on every side
TMA_CASES = [(3, 8, 8, 64, 64), (1, 5, 7, 128, 64), (3, 5, 11, 64, 72), (2, 9, 13, 64, 64), (2, 2, 2, 128, 64),
             (1, 1, 3, 64, 64), (1, 12, 30, 64, 64)]


@pytest.mark.parametrize("n,h,w,c,cout", TMA_CASES)
def test_tma_box_tiles_compute_the_padded_conv(n, h, w, c, cout):
    """The TMA forward engine's decomposition of the 3x3: per tile of 128
    output pixels (the launcher's box), per tap (ky, kx) and 64 channels, A
    is one box at (c0, ow0 + kx - 1, oh0 + ky - 1, n0) whose out-of-bounds
    zero fill is the padding; the rows inside the tensor, each written once,
    are the 3x3 same conv. Small integers make every f32 sum exact."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.integers(-2, 3, (n, h, w, c)).astype(np.float32))
    wt = torch.from_numpy(rng.integers(-1, 2, (3, 3, c, cout)).astype(np.float32))
    out, hits = _engine_conv(x, wt, 3)
    assert bool((hits == 1).all())
    assert torch.equal(out, conv3x3_f32(x, wt, 1))


# (ks, n, h, w, c, cout): the 1x1 mode at a main-path tile and at ragged
# images down to 1 x 3, and channel counts that are not whole 64-channel
# steps (16, 24, 72, 136) in both modes: the last step's A and B boxes
# zero-fill past C, the last tile's columns past COUT
ENGINE_CASES = [(1, 3, 8, 8, 128, 64), (1, 1, 5, 7, 64, 200), (1, 1, 1, 3, 72, 64), (1, 2, 9, 13, 136, 24),
                (1, 3, 2, 2, 16, 16), (3, 1, 1, 3, 16, 16), (3, 2, 6, 5, 24, 24), (3, 3, 5, 11, 72, 64),
                (3, 1, 9, 7, 136, 72)]


@pytest.mark.parametrize("ks,n,h,w,c,cout", ENGINE_CASES)
def test_tma_engine_computes_the_1x1_and_ragged_channels(ks, n, h, w, c, cout):
    """As above, for the engine's 1x1 mode (one tap at offset (0, 0)) and
    for C and COUT that are multiples of 8 but not of 64: a short last
    channel step reads zeros past C from both the source and the 3-D
    weight map (not the next tap's weight rows), and each output pixel and
    channel is written once."""
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.integers(-2, 3, (n, h, w, c)).astype(np.float32))
    wt = torch.from_numpy(rng.integers(-1, 2, (ks, ks, c, cout)).astype(np.float32))
    out, hits = _engine_conv(x, wt, ks)
    assert bool((hits == 1).all())
    assert torch.equal(out, conv3x3_f32(x, wt, 1) if ks == 3 else matmul_f32(x, wt[0, 0]))
