"""The stage chain's backward, the block forwards and the TMA forward engine
as their Hopper kernels compute them, on the CPU.

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
  `basic_fused.basic_fwd_plain`. The block forwards' launches of that
  engine (read from `csrc/bottleneck_fwd_sm90.cuh`), each with its
  epilogue, are bit-equal to the plain saving forwards: the identity
  block's three, and the projection block's conv1, 3x3 at stride S and
  two-segment conv3 + shortcut (b3, then bsc). The saving chain as
  `stage_fused.cu` walks it (`stage_fwd.cuh`) is bit-equal to
  `stage_fused.stage_save_plain` and within the chain's tolerance of
  argus_tpu's `_chain_fwd_pallas(save=True)` in interpret mode.
- That engine's operands (`csrc/conv_fwd_sm90.cuh`, evaluated from the
  header's own expressions and `sm90.cuh`'s tensor-map box): per tile of
  the output, step and 64 channels, one TMA box of A from the step's
  segment's map (its traversal stride: every other pixel at stride 2) and
  boxes of the 3-D weight map, both zero-filled outside their tensors (past
  C too), compute the padded 3x3 and the 1x1 at strides 1 and 2, and the
  two-segment h2 @ w3 + x[::S, ::S] @ wsc, each output pixel once, at any
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
from argus_tpu_torch.ops.kernels import proj_fused as tpf
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
    forward) as torch tensors, argus_tpu's backward (dx and every dw), and
    the forward's folded weights as torch tensors with argus_tpu's saving
    forward (out, bnds, h1s, h2s)."""
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

    def folded(ws):  # weights in the chain's dtype, biases f32
        return tuple(t(a) if i % 2 == 0 else torch.from_numpy(np.array(a)) for i, a in enumerate(ws))

    args = (t(xj), t(g), t(out), [t(a) for a in bnds], [t(a) for a in h1s], [t(a) for a in h2s],
            tuple(t(a) for a in jpw) if with_proj else None, [tuple(t(a) for a in w) for w in jids], stride)
    fwd = (folded(pw) if with_proj else None, [folded(w) for w in ids],
           [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in [out, *bnds, *h1s, *h2s]])
    return args, [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in want], fwd


def _flat(res):
    dx, pd, idd = res
    return [dx, *(pd or ()), *[d for ds in idd for d in ds]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("stride,with_proj,k", CHAINS)
def test_chain_decomposition_matches_the_plain_chain_and_pallas(stride, with_proj, k, need_dx, dtype):
    args, want, _ = _chain_case(stride, with_proj, k, dtype)
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


# ───────────────────── the forward's operands as TMA boxes ─────────────────────

FWD_SRC = (CSRC / "conv_fwd_sm90.cuh").read_text()
SM90_SRC = (CSRC / "sm90.cuh").read_text()


def _lam(expr: str):
    """A C++ integer expression as a Python function of its variables (/ is
    integer division of non-negative ints here, `p.` and casts dropped)."""
    e = re.sub(r"static_cast<\w+>\((.*)\)", r"\1", expr.strip()).replace("p.", "").replace("/", "//")
    return eval("lambda **v: " + re.sub(r"\b([A-Za-z_]\w*)\b", r"v['\1']", e))


def _c_expr(pattern: str, src: str = FWD_SRC):
    """The C++ integer expression(s) the pattern captures in a header, as
    Python functions of their variables."""
    m = re.search(pattern, src)
    assert m, pattern
    return [_lam(e) for e in m.groups()]


def _body(src: str, signature: str) -> str:
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def _args(text: str):
    return [t.strip() for t in text.split(",")]


def _launcher_box(ho: int, wo: int):
    """(bw, bh, bn) of a tile as csrc/conv_fwd_sm90.cuh's `conv_fwd_tiles`
    picks it: the OUTPUT's Wo and Ho rounded up to powers of two under the
    caps read from the header, bn = 128 / (bw * bh)."""
    body = _body(FWD_SRC, "inline void conv_fwd_tiles(")
    caps = {d: int(re.search(rf"p\.b{d} = pow2\({d.upper()}o, (\d+)\);", body).group(1)) for d in ("w", "h")}

    def pow2(v, cap):
        b = 1
        while b < v and b < cap:
            b *= 2
        return b

    bw, bh = pow2(wo, caps["w"]), pow2(ho, caps["h"])
    assert 128 % (bw * bh) == 0
    return bw, bh, 128 // (bw * bh)


def _nhwc_map():
    """sm90.cuh `make_tmap_nhwc`'s box and traversal strides (innermost
    first), as functions of (S, bw, bh, bn): the elements a box lands along
    each dimension are ceil(box / stride), every stride-th from its start."""
    body = _body(SM90_SRC, "inline cudaError_t make_tmap_nhwc(")
    box = [_lam(e) for e in _args(re.search(r"const cuuint32_t box\[4\] = \{([^}]*)\};", body).group(1))]
    estr = [_lam(e) for e in _args(re.search(r"const cuuint32_t estr\[4\] = \{([^}]*)\};", body).group(1))]
    return box, estr


def _launcher(signature: str):
    """A launcher of csrc/conv_fwd_sm90.cuh read from its body: its local
    (Ho, Wo) where it declares them, the output's (Ho, Wo), the kernel's
    stride fields, second segment's channels and flag (kSc), and
    each tensor map's (source, H, W, C, traversal stride) or (weights, taps,
    C, COUT), as functions of the launcher's parameters."""
    body = _body(FWD_SRC, signature)
    local = re.search(r"const int Ho = ([^,]*), Wo = ([^;]*);", body)
    local = [_lam(e) for e in local.groups()] if local else None
    ho, wo = _c_expr(r"conv_fwd_tiles\(p, N, ([^,]*), ([^,]*), COUT\);", body)
    fields = {f: _lam(m.group(1)) for f in ("stride", "C", "C2", "stride2")
              if (m := re.search(rf"\bp\.{f} = ([^;]*);", body))}
    ksc = re.search(r"launch_conv_fwd_tiles<\w+, (true|false)(?:, \w+)*>\(p, stream\)", body).group(1) == "true"
    fields["kSc"] = lambda **v: ksc
    amaps = {name: (a[0], *[_lam(e) for e in a[2:6]])
             for name, rest in re.findall(r"make_tmap_nhwc\(&p\.(\w+), ([^;]*)\);", body)
             for a in [_args(rest)]}
    wmaps = {name: (a[0], *[_lam(e) for e in a[1:4]])
             for name, rest in re.findall(r"make_tmap_wrows\(&p\.(\w+), ([^;]*)\);", body)
             for a in [_args(rest)]}
    return local, ho, wo, fields, amaps, wmaps


def _producer():
    """The producer's walk of one tile, read from the kernel: the step count
    and decode, and each segment's A box start (channel, column, row,
    image) and weight box start (gradient channel, channel, tap) per step,
    as functions of the kernel's variables; segment 0 while the branch's
    condition holds, 1 after."""
    exprs = {k: _c_expr(rf"const int {k} = ([^;]*);")[0] for k in ("CB", "T1", "T", "tap", "cb", "cb2")}
    (exprs["kPad"],) = _c_expr(r"constexpr int kPad = ([^;]*);")
    exprs["ky"], exprs["kx"] = _c_expr(r"const int ky = ([^,]*), kx = ([^;]*);")
    (first,) = _c_expr(r"if \(([^)]*)\) \{  // the first segment")
    a_box = {m: [_lam(e) for e in _args(rest)]
             for m, rest in re.findall(r"tma_load_4d\(sA\(st\), &p\.(\w+), &full\[st\],([^;]*)\);", FWD_SRC)}
    b_box = {m: [_lam(e) for e in _args(rest)] for m, rest in
             re.findall(r"tma_load_3d\(sB\(st\) \+ b \* 8192, &p\.(\w+), &full\[st\],([^;]*)\);", FWD_SRC)}
    assert list(a_box) == ["amap", "amap2"] and list(b_box) == ["wmap", "wmap2"]
    return exprs, first, list(zip(a_box.values(), b_box.values()))


def _tma_box(t, start, box, step=None):
    """A tiled TMA box of tensor t (dims outermost first) at `start`,
    `box` elements along each dimension, every `step`-th (default 1): the
    elements inside t, zeros where the box runs past it on any side."""
    step = step or [1] * len(box)
    out = torch.zeros(*box, dtype=t.dtype)
    src, dst = [], []
    for o, b, s, d in zip(start, box, step, t.shape):
        idx = [o + s * i for i in range(b)]
        keep = [i for i, v in enumerate(idx) if 0 <= v < d]
        if not keep:
            return out
        src.append(torch.tensor([idx[i] for i in keep]))
        dst.append(torch.tensor(keep))
    out[torch.meshgrid(*dst, indexing="ij")] = t[torch.meshgrid(*src, indexing="ij")]
    return out


def _engine_launch(signature: str, ks: int, tensors: dict, dims: dict, bn: int = 128):
    """The TMA forward engine's decomposition of one launch of the launcher
    `signature` (read from the header) on `tensors` and `dims` (its
    parameters by name): per tile of 128 output pixels (the launcher's box)
    and `bn` gradient channels, per step of the kernel's walk, A is one box
    of the step's segment's source map (its traversal stride, its zero
    fill) at the step's start, B the bn/64 boxes of its weight map (taps, C,
    COUT); the rows inside the output, each written once, are the output.
    Returns (the f32 accumulator (N, Ho, Wo, COUT), writes per element)."""
    local, ho_of, wo_of, fields, amaps, wmaps = _launcher(signature)
    box_of, estr_of = _nhwc_map()
    exprs, first, segs = _producer()
    if local:
        dims = dict(dims, Ho=local[0](**dims), Wo=local[1](**dims))
    n, cout = dims["N"], dims["COUT"]
    ho, wo = ho_of(**dims), wo_of(**dims)
    bw, bh, bnimg = _launcher_box(ho, wo)
    kv = {f: e(**dims) for f, e in fields.items()}
    kv.setdefault("C2", 0)
    kv.setdefault("stride2", 1)
    kv.update(KS=ks, kPad=exprs["kPad"](KS=ks))
    kv["CB"] = exprs["CB"](**kv)
    kv["T1"] = exprs["T1"](**kv)
    steps = exprs["T"](**kv)
    srcs = []
    for (a_name, h_of, w_of, c_of, s_of), (w_name, taps_of, cw_of, co_of) in zip(amaps.values(), wmaps.values()):
        a, wt = tensors[a_name], tensors[w_name]
        assert tuple(a.shape) == (n, h_of(**dims), w_of(**dims), c_of(**dims))
        taps, cw, co = taps_of(**dims, KS=ks), cw_of(**dims), co_of(**dims)
        env = dict(S=s_of(**dims), bw=bw, bh=bh, bn=bnimg)
        count = [-(-bx(**env) // es(**env)) for bx, es in zip(box_of, estr_of)]
        assert count == [64, bw, bh, bnimg]  # the box lands the tile's pixels at any stride
        srcs.append((a, [es(**env) for es in estr_of], wt.reshape(taps, cw, co)))
    out = torch.zeros(n, ho, wo, cout)
    hits = torch.zeros(n, ho, wo, cout, dtype=torch.int64)
    r = torch.arange(128)
    ni, hi, wi = r // (bw * bh), (r % (bw * bh)) // bw, r % bw
    for n0 in range(0, n, bnimg):
        for oh0 in range(0, ho, bh):
            for ow0 in range(0, wo, bw):
                for c0 in range(0, cout, bn):
                    acc = torch.zeros(128, bn)
                    for ts in range(steps):
                        v = dict(kv, ts=ts, n0=n0, oh0=oh0, ow0=ow0, c0=c0)
                        seg = 0 if first(**v) else 1
                        if seg == 0:
                            v["tap"] = exprs["tap"](**v)
                            v["cb"] = exprs["cb"](**v)
                            v["ky"] = exprs["ky"](**v)
                            v["kx"] = exprs["kx"](**v)
                        else:
                            v["cb2"] = exprs["cb2"](**v)
                        (a_exprs, b_exprs), (src, estr, wmap) = segs[seg], srcs[seg]
                        ca, cw_, ch, cn = (f(**v) for f in a_exprs)
                        a = _tma_box(src, (cn, ch, cw_, ca), (bnimg, bh, bw, 64), estr[::-1]).reshape(128, 64)
                        b = torch.cat([_tma_box(wmap, (tap, cw, co), (1, 64, 64))[0] for co, cw, tap in
                                       ([f(**v, b=j) for f in b_exprs] for j in range(bn // 64))], dim=1)
                        acc += a.float() @ b.float()
                    keep = (n0 + ni < n) & (oh0 + hi < ho) & (ow0 + wi < wo)
                    idx = (n0 + ni[keep], oh0 + hi[keep], ow0 + wi[keep])
                    cols = slice(c0, min(c0 + bn, cout))
                    out[idx + (cols,)] = acc[keep][:, :cols.stop - c0]
                    hits[idx + (cols,)] += 1
    return out, hits


ONE_SEG = "inline cudaError_t launch_conv_fwd_tma("
TWO_SEG = "inline cudaError_t launch_conv_fwd_tma_sc("


def _engine_conv(x, wt, ks: int, stride: int = 1):
    """The one-segment launch: a KS x KS conv at `stride`, padding KS/2."""
    n, h, w, c = x.shape
    dims = dict(N=n, H=h, W=w, C=c, COUT=wt.shape[-1], S=stride)
    return _engine_launch(ONE_SEG, ks, {"src": x, "w": wt}, dims)


def _ints(rng, *shape, lo=-2, hi=3):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


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
    x, wt = _ints(rng, n, h, w, c), _ints(rng, 3, 3, c, cout, lo=-1, hi=2)
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
    x, wt = _ints(rng, n, h, w, c), _ints(rng, ks, ks, c, cout, lo=-1, hi=2)
    out, hits = _engine_conv(x, wt, ks)
    assert bool((hits == 1).all())
    assert torch.equal(out, conv3x3_f32(x, wt, 1) if ks == 3 else matmul_f32(x, wt[0, 0]))


# (ks, n, h, w, c, cout) at stride 2, input sizes: outputs of 1 x 1, 1 x 3,
# 2 x 2, 5 x 7, 9 x 17 and 10 x 3 (boxes past the output's edge, Ho and Wo
# not powers of two, a second tile along W and along H), two 8 x 8 images
# in one box, C and COUT not multiples of 64 (72, 24, 136), and the 1x1 at
# stride 2 (the shortcut's operand)
STRIDE2_CASES = [(3, 2, 2, 2, 72, 24), (3, 1, 2, 6, 64, 64), (3, 2, 4, 4, 136, 72), (3, 3, 10, 14, 72, 24),
                 (3, 2, 16, 16, 64, 64), (3, 1, 18, 34, 24, 72), (3, 1, 20, 6, 72, 24), (1, 2, 10, 14, 72, 24),
                 (1, 1, 2, 2, 64, 64), (1, 1, 20, 34, 16, 24)]


@pytest.mark.parametrize("ks,n,h,w,c,cout", STRIDE2_CASES)
def test_tma_engine_computes_the_stride2_3x3(ks, n, h, w, c, cout):
    """The engine at stride 2: the tile is a box of the OUTPUT, and its A
    box for tap (ky, kx) starts at (c0, 2 ow0 + kx - 1, 2 oh0 + ky - 1, n0)
    of a map that traverses the source at stride 2 (`make_tmap_nhwc`'s
    element strides, its box 2 bw x 2 bh landing bw x bh pixels); TMA's zero
    fill at -1 is the padding. Each output written once, exact integers."""
    rng = np.random.default_rng(34)
    x, wt = _ints(rng, n, h, w, c), _ints(rng, ks, ks, c, cout, lo=-1, hi=2)
    out, hits = _engine_conv(x, wt, ks, 2)
    assert bool((hits == 1).all())
    want = conv3x3_f32(x, wt, 2) if ks == 3 else matmul_f32(x[:, ::2, ::2], wt[0, 0])
    assert torch.equal(out, want)


# (n, ho, wo, f, cin, cout, s): conv3 (K = F) and the shortcut (K = CIN) at
# strides 1 and 2, CIN != F, channels not whole 64-channel steps in either
# segment, ragged outputs down to 1 x 1, a second tile along H and along W
TWO_SEG_CASES = [(2, 4, 4, 64, 128, 256, 2), (1, 5, 7, 24, 72, 64, 2), (2, 1, 1, 16, 40, 128, 2),
                 (1, 10, 3, 24, 40, 64, 2), (1, 3, 17, 16, 24, 64, 2), (2, 3, 5, 64, 32, 128, 1),
                 (1, 9, 6, 72, 136, 64, 1)]


@pytest.mark.parametrize("n,ho,wo,f,cin,cout,s", TWO_SEG_CASES)
def test_tma_engine_two_segments_compute_conv3_and_the_shortcut(n, ho, wo, f, cin, cout, s):
    """`launch_conv_fwd_tma_sc`: steps 0..T1-1 read h2 (a 1x1 at stride 1)
    against w3, steps T1.. read x through its stride-S map (a 1x1 at (0, 0),
    no padding) against wsc, into one accumulator: h2 @ w3 + x[::S, ::S] @
    wsc, each output written once, exact integers."""
    rng = np.random.default_rng(35)
    h2, x = _ints(rng, n, ho, wo, f), _ints(rng, n, s * ho, s * wo, cin)
    w3, wsc = _ints(rng, f, cout, lo=-1, hi=2), _ints(rng, cin, cout, lo=-1, hi=2)
    dims = dict(N=n, H=s * ho, W=s * wo, C=f, C2=cin, COUT=cout, S=s)
    out, hits = _engine_launch(TWO_SEG, 1, {"src": h2, "w": w3, "src2": x, "w2": wsc}, dims)
    assert bool((hits == 1).all())
    assert torch.equal(out, matmul_f32(h2, w3) + matmul_f32(x[:, ::s, ::s], wsc))


# ───────────────────── the block forwards' launches ─────────────────────

BLOCK_SRC = (CSRC / "bottleneck_fwd_sm90.cuh").read_text()


def _block_launches(function: str):
    """Each launch of `function` in csrc/bottleneck_fwd_sm90.cuh, in order:
    ("conv", KS, src, w, bias, residual, out, C, COUT, S) for
    `launch_conv_fwd_tma<KS>(src, w, bias, residual, out, N, H, W, C, COUT,
    S, stream)`, ("sc", src, w, bias, src2, w2, bias2, out, C, C2, COUT, S)
    for `launch_conv_fwd_tma_sc(src, w, bias, src2, w2, bias2, out, N, H, W,
    C, C2, COUT, S, stream)`."""
    body = _body(BLOCK_SRC, f"inline cudaError_t {function}(")
    launches = []
    for ks, sc, args in re.findall(r"launch_conv_fwd_tma(?:<(\d)>|(_sc))\(([^;]*)\);", body):
        a = _args(args)
        launches.append(("conv", int(ks), *a[:5], *a[8:11]) if ks else ("sc", *a[:7], *a[10:14]))
    return launches


def _epilogue2(acc, bias, bias2, residual, dtype):
    """The engine's epilogue (conv_fwd_sm90.cuh): + bias, + bias2 (the
    second segment's), + f32(residual), each where there is one, relu, one
    rounding."""
    v = acc + bias.float().reshape(-1)
    if bias2 is not None:
        v = v + bias2.float().reshape(-1)
    if residual is not None:
        v = v + residual.float()
    return torch.clamp_min(v, 0.0).to(dtype)


def _run_launches(launches, t: dict, dims: dict, dtype):
    """The launches on the engine's arithmetic: each conv (its stride) or
    the two segments into an f32 accumulator, then the epilogue; outputs
    through `t` by name."""
    for kind, *a in launches:
        if kind == "conv":
            ks, src, wname, bias, res, out, c, cout, s = a
            stride = dims[s] if s in dims else int(s)
            assert t[src].shape[-1] == dims[c] and t[wname].shape[-1] == dims[cout]
            x = t[src]
            acc = conv3x3_f32(x, t[wname], stride) if ks == 3 else matmul_f32(x[:, ::stride, ::stride], t[wname])
            t[out] = _epilogue2(acc, t[bias], None, None if res == "nullptr" else t[res], dtype)
        else:
            src, wname, bias, src2, w2, bias2, out, c, c2, cout, s = a
            stride = dims[s]
            assert t[src].shape[-1] == dims[c] and t[src2].shape[-1] == dims[c2]
            assert t[wname].shape[-1] == t[w2].shape[-1] == dims[cout]
            acc = matmul_f32(t[src], t[wname]) + matmul_f32(t[src2][:, ::stride, ::stride], t[w2])
            t[out] = _epilogue2(acc, t[bias], t[bias2], None, dtype)


ID_NAMES = ("w1", "bias1", "w2", "bias2", "w3", "bias3")  # the compositions' names
PROJ_NAMES = ID_NAMES + ("wsc", "biassc")


def _identity_twin(x, ws, dtype):
    """identity_block_fwd_sm90's launches: (out, h1, h2)."""
    t = dict(zip(ID_NAMES, ws), x=x)
    _run_launches(_block_launches("identity_block_fwd_sm90"), t, {"CIN": x.shape[-1], "F": ws[0].shape[1]}, dtype)
    return t["out"], t["h1"], t["h2"]


def _projection_twin(x, ws, stride, dtype):
    """projection_block_fwd_sm90's launches: (out, h1, h2)."""
    t = dict(zip(PROJ_NAMES, ws), x=x)
    dims = {"CIN": x.shape[-1], "F": ws[0].shape[1], "COUT": ws[4].shape[1], "S": stride}
    _run_launches(_block_launches("projection_block_fwd_sm90"), t, dims, dtype)
    return t["out"], t["h1"], t["h2"]


def _torch_ws(ws, dtype):
    return [torch.from_numpy(a).to(dtype) if i % 2 == 0 else torch.from_numpy(a) for i, a in enumerate(ws)]


# (n, h, w, cin, f): a main-path width at a small size, F below 64, and
# CIN 72 with F 24 (no launch in whole 64-channel steps)
ID_FWD_CASES = [(2, 8, 8, 256, 64), (2, 9, 7, 64, 16), (2, 6, 5, 72, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,f", ID_FWD_CASES)
def test_identity_forward_launches_match_the_plain_block(n, h, w, cin, f, dtype):
    """The launches of the identity forward (`identity_block_fwd_sm90`, which
    block_fused.cu runs) as the engine computes them: a conv of kernel size
    KS over src into an f32 accumulator, then its epilogue (bias, the
    residual, relu, one rounding), h1 and h2 through memory; bit for bit
    the plain saving forward (out, h1, h2)."""
    assert "argus::identity_block_fwd_sm90(" in (CSRC / "block_fused.cu").read_text()
    launches = _block_launches("identity_block_fwd_sm90")
    assert [(a[1], a[-3], a[-2], a[-1]) for a in launches] == [(1, "CIN", "F", "1"), (3, "F", "F", "1"),
                                                                  (1, "F", "CIN", "1")]
    rng = np.random.default_rng(32)
    ws = _torch_ws(_folded(rng, cin, f, cin, False), dtype)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (n, h, w, cin))).astype(np.float32)).to(dtype)
    want = tbk.bottleneck_block_save_plain(x, *ws)
    for got, ref in zip(_identity_twin(x, ws, dtype), want):
        assert torch.equal(got, ref)


# (n, h, w, cin, f, cout, stride): stage 0's widths (stride 1), a stride-2
# entry at a ResNet-50 ratio, ragged images, CIN != F and channels that are
# not whole 64-channel steps
PROJ_FWD_CASES = [(2, 8, 8, 64, 64, 256, 1), (2, 8, 8, 256, 128, 512, 2), (2, 6, 10, 72, 24, 64, 2),
                  (1, 9, 7, 32, 16, 64, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,cin,f,cout,stride", PROJ_FWD_CASES)
def test_projection_forward_launches_match_the_plain_block(n, h, w, cin, f, cout, stride, dtype):
    """The launches of the projection forward (`projection_block_fwd_sm90`,
    which proj_fused.cu runs): conv1 at stride 1, the 3x3 at stride S, conv3
    and the shortcut as one two-segment launch (h2 @ w3 + x[::S, ::S] @ wsc
    in one accumulator, then b3, then bsc, relu, one rounding); bit for bit
    the plain saving forward (out, h1, h2)."""
    assert "argus::projection_block_fwd_sm90(" in (CSRC / "proj_fused.cu").read_text()
    launches = _block_launches("projection_block_fwd_sm90")
    assert [a[0] for a in launches] == ["conv", "conv", "sc"] and [a[1] for a in launches[:2]] == [1, 3]
    rng = np.random.default_rng(36)
    ws = _torch_ws(_folded(rng, cin, f, cout, True), dtype)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (n, h, w, cin))).astype(np.float32)).to(dtype)
    want = tpf.projection_block_save_plain(x, *ws, stride)
    for got, ref in zip(_projection_twin(x, ws, stride, dtype), want):
        assert got.shape == ref.shape and torch.equal(got, ref)


# ───────────────────── the chain forward's launches ─────────────────────


def _chain_calls():
    """The block-forward calls of stage_fwd.cuh's `stage_fwd_save` (the walk
    stage_fused.cu runs over the TMA engine's compositions): the first four
    arguments (source, h1, h2, destination) and the geometry (the names
    before the stream) of `proj_fwd(` and of `id_fwd(`."""
    src = (CSRC / "stage_fused.cu").read_text()
    assert "argus::stage_fwd_save(argus::projection_block_fwd_sm90, argus::identity_block_fwd_sm90," in src
    assert "argus::stage_fwd(argus::projection_block_fwd_sm90, argus::identity_block_fwd_sm90," in src
    body = _body((CSRC / "stage_fwd.cuh").read_text(), "inline cudaError_t stage_fwd_save(")
    calls = {}
    for fn in ("proj_fwd", "id_fwd"):
        a = _args(re.search(rf"{fn}\(([^;]*)\);", body).group(1))
        calls[fn] = (a[:4], a[-6:-1] if fn == "id_fwd" else a[-8:-1])
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,with_proj,k", CHAINS)
def test_chain_forward_launches_match_the_plain_chain_and_pallas(stride, with_proj, k, dtype):
    """The saving chain as stage_fused.cu runs it: the projection block's
    launches at the chain's input (CIN, F, COUT, S), then each identity
    block's at (Ho, Wo) with CIN = COUT, every block's output, h1 and h2
    kept; bit for bit `stage_save_plain`, and within the chain's tolerance
    of argus_tpu's `_chain_fwd_pallas(save=True)` in interpret mode."""
    calls = _chain_calls()
    assert calls["proj_fwd"] == (["x", "h1s[0]", "h2s[0]", "dst"], ["N", "H", "W", "CIN", "F", "COUT", "S"])
    assert calls["id_fwd"] == (["cur", "h1s[b]", "h2s[b]", "dst"], ["N", "Ho", "Wo", "COUT", "F"])
    args, _, (proj, ids, want) = _chain_case(stride, with_proj, k, dtype)
    x, tdt = args[0], DTYPES[dtype][1]
    cur, outs, h1s, h2s = x, [], [], []
    if with_proj:
        cur, h1, h2 = _projection_twin(cur, proj, stride, tdt)
        outs.append(cur), h1s.append(h1), h2s.append(h2)
    for idw in ids:
        cur, h1, h2 = _identity_twin(cur, idw, tdt)
        outs.append(cur), h1s.append(h1), h2s.append(h2)
    got = [cur, *outs[:-1], *h1s, *h2s]
    p_out, p_bnds, p_h1s, p_h2s = tst.stage_save_plain(x, proj, ids, stride)
    for a, b in zip(got, [p_out, *p_bnds, *p_h1s, *p_h2s], strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    for a, b in zip(got, want, strict=True):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, rtol=0, atol=REL[dtype] * max(np.abs(b).max(), 1e-12))
