"""The pointwise forward as the TMA forward engine computes it
(`csrc/pointwise.cu` over `csrc/conv_fwd_sm90.cuh`), on the CPU.

- `argus_pointwise_fwd` is one launch of the engine's 1x1 (`launch_conv_fwd_tma<1>`,
  and `<1, false>` with relu off) over the (M, CIN) rows as M images of
  1 x 1 pixel: read from pointwise.cu and evaluated with the header's own
  expressions (tests/test_torch_chain_sm90.py's simulation), a tile is a box
  of 128 consecutive rows of the (M, 1, 1, CIN) map, zero-filled past M and
  past CIN, against boxes of the (1, CIN, COUT) weight map; each output row
  and channel is written once, and small integers make the f32 sums exact.
- Its epilogue over an f32 accumulator (bias, then the f32 residual, relu or
  not, one rounding) is bit-equal to `pointwise_fwd_plain` given the same
  accumulator, relu on and off, with and without the residual; the whole
  form on bf16 inputs is within the op's tolerance (2e-2 of the largest
  value) of argus_tpu's `_pw_fwd_pallas` in interpret mode. M = 49 (1 x 7 x
  7) and 300 (no tile divides them), CIN and COUT 8, 72 and 136.
- The residual 1x1's TMA epilogue: the residual tile lands in shared memory
  by TMA in the 128-byte swizzle (chunk k of row p at chunk k ^ (p % 8)), a
  consumer thread's word (read from the kernel's address expression, its row
  and column from the kernel's) holds its pair of residual values, the
  rounded output written over it, and the TMA store of the same boxes
  writes every row inside M and every column inside COUT once.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import pointwise as jpw
from argus_tpu_torch.ops.kernels import pointwise as tpw

from test_torch_chain_sm90 import CSRC, FWD_SRC, ONE_SEG, SM90_SRC, _args, _body, _engine_launch, _ints, _lam

PW_SRC = (CSRC / "pointwise.cu").read_text()
BF16_TOL = 2e-2  # relative to the largest value of the reference (tests/test_torch_pointwise.py)

# (M, CIN, COUT): M = 1 x 7 x 7 and 300 rows (no 128-row tile divides them),
# channel counts that are not whole 64-channel steps
CASES = [(49, 8, 8), (49, 72, 136), (300, 136, 72), (300, 8, 136)]


def _pointwise_launches():
    """{relu: the launcher's parameters by name (N, H, W, C, COUT, S) as
    pointwise.cu binds them} for `launch_conv_fwd_tma<1>` (relu on) and
    `launch_conv_fwd_tma<1, false>` (relu off)."""
    sig = _body(FWD_SRC, ONE_SEG)
    params = [a.split()[-1].lstrip("*") for a in _args(sig[sig.index("(") + 1:sig.index(")")])]
    launches = {}
    for flags, args in re.findall(r"launch_conv_fwd_tma<1(, false)?>\(([^;]*?, st)\)", PW_SRC):
        launches[flags == ""] = dict(zip(params, _args(args)))
    assert set(launches) == {True, False}
    return launches


def _dims(binding: dict, m: int, cin: int, cout: int) -> dict:
    names = {"M": m, "CIN": cin, "COUT": cout}
    return {k: names[v] if v in names else int(v) for k, v in binding.items() if k in ("N", "H", "W", "C", "COUT", "S")}


def _engine_rows(x2, w, binding):
    """The engine's f32 accumulator (M, COUT) of one pointwise launch, and
    the writes per element."""
    m, cin = x2.shape
    cout = w.shape[1]
    dims = _dims(binding, m, cin, cout)
    assert (dims["N"], dims["H"], dims["W"], dims["S"]) == (m, 1, 1, 1)
    acc, hits = _engine_launch(ONE_SEG, 1, {"src": x2.reshape(m, 1, 1, cin), "w": w}, dims)
    return acc.reshape(m, cout), hits.reshape(m, cout)


def _epilogue(acc, bias, res, relu, dtype):
    """The engine's epilogue: + bias, + f32(residual), relu where kRelu, one
    rounding."""
    v = acc + bias.float().reshape(-1)
    if res is not None:
        v = v + res.float()
    return (torch.clamp_min(v, 0.0) if relu else v).to(dtype)


def test_both_epilogues_gate_the_relu_on_the_template_flag():
    """The register and the TMA epilogue each relu only under kRelu, and
    pointwise.cu binds the same arguments with relu on and off."""
    assert FWD_SRC.count("kRelu ? fmaxf(vx, 0.f) : vx") == 2 and FWD_SRC.count("kRelu ? fmaxf(vy, 0.f) : vy") == 2
    launches = _pointwise_launches()
    assert launches[True] == launches[False]
    assert [launches[True][k] for k in ("src", "w", "residual", "out")] == ["x", "w", "res", "out"]


@pytest.mark.parametrize("m,cin,cout", CASES)
def test_pointwise_launch_computes_the_rows(m, cin, cout):
    """Tiles of 128 consecutive rows of the (M, 1, 1, CIN) map and 64-channel
    boxes of the weight map, zero-filled past M and past CIN: each output
    written once, the exact product of small integers."""
    rng = np.random.default_rng(40 + m + cin)
    x2, w = _ints(rng, m, cin), _ints(rng, cin, cout, lo=-1, hi=2)
    for relu, binding in _pointwise_launches().items():
        acc, hits = _engine_rows(x2, w, binding)
        assert bool((hits == 1).all())
        assert torch.equal(acc, x2 @ w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,cin,cout", CASES)
def test_pointwise_epilogue_matches_the_plain_forward(m, cin, cout, dtype):
    """Given the plain version's f32 accumulator, the engine's epilogue is
    `pointwise_fwd_plain` bit for bit: relu on and off, residual on and off."""
    rng = np.random.default_rng(41 + m)
    x2 = torch.from_numpy(rng.normal(0, 1, (m, cin)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(0, 1, (cin, cout)) / np.sqrt(cin)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(0, 0.3, (1, cout)).astype(np.float32))
    res = torch.from_numpy(rng.normal(0, 1, (m, cout)).astype(np.float32)).to(dtype)
    acc = x2.float() @ w.float()
    for r in (None, res):
        for relu in (True, False):
            assert torch.equal(_epilogue(acc, b, r, relu, dtype), tpw.pointwise_fwd_plain(x2, w, b, r, relu))


@pytest.mark.parametrize("m,cin,cout", CASES[:3])
def test_pointwise_engine_form_matches_pallas(m, cin, cout):
    """The whole form (the engine's blocked f32 sums, then its epilogue) on
    bf16 inputs against argus_tpu's `_pw_fwd_pallas` in interpret mode,
    relu on and off, with and without the residual."""
    rng = np.random.default_rng(42 + m)
    xn = rng.normal(0, 1, (m, cin)).astype(np.float32)
    wn = (rng.normal(0, 1, (cin, cout)) / np.sqrt(cin)).astype(np.float32)
    bn = rng.normal(0, 0.3, (1, cout)).astype(np.float32)
    rn = rng.normal(0, 1, (m, cout)).astype(np.float32)
    x2, w, res = (torch.from_numpy(a).to(torch.bfloat16) for a in (xn, wn, rn))
    b = torch.from_numpy(bn)
    jx, jw, jr = (jnp.asarray(a).astype(jnp.bfloat16) for a in (xn, wn, rn))
    launches = _pointwise_launches()
    for relu in (True, False):
        acc, _ = _engine_rows(x2, w, launches[relu])
        for r, jres in ((None, None), (res, jr)):
            got = _epilogue(acc, b, r, relu, torch.bfloat16).float().numpy()
            want = np.asarray(jpw._pw_fwd_pallas(jx, jw, jnp.asarray(bn), jres, relu, True).astype(jnp.float32))
            np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * max(np.abs(want).max(), 1e-12))


# ───────────────────── the residual 1x1's TMA epilogue ─────────────────────


def _tma_epilogue_exprs():
    """From the kernel's TMA epilogue: a consumer thread's tile row, its
    pair's column and its word's byte offset in the epilogue buffer, the
    box start of the residual load and of the output store (per 64-column
    box b), as functions of their variables."""
    body = FWD_SRC[FWD_SRC.index("if constexpr (kTma) {"):]
    body = body[:body.index("} else {")]
    (row,) = [_lam(e) for e in re.search(r"const int r = ([^;]*);", body).groups()]
    (col,) = [_lam(e) for e in re.search(r"const int n = ([^;]*);", body).groups()]
    word = _lam(re.search(r"reinterpret_cast<uint32_t\*>\(eb \+ ([^;]*)\);", body).group(1))
    load = re.search(r"tma_load_4d\(eb \+ b \* kBox, &p\.rmap, &efull\[lt & 1\], ([^;]*)\);", FWD_SRC).group(1)
    store = re.search(r"tma_store_4d\(&p\.omap, eb \+ b \* kBox, ([^;]*)\);", body).group(1)
    swz_e = re.search(r"uint32_t swz\(int r, int j\) \{\s*return static_cast<uint32_t>\((.*)\);", SM90_SRC).group(1)
    swz_f = _lam(swz_e)
    (kbox,) = re.search(r"constexpr int kBox = ([^;]*);", FWD_SRC).groups()
    kbox = eval(kbox.replace("kFwBM", "128"))
    return row, col, word, [_lam(e) for e in _args(load)], [_lam(e) for e in _args(store)], \
        (lambda r, j: swz_f(r=r, j=j)), kbox


def _swizzled(p: int, c: int) -> int:
    """CU_TENSOR_MAP_SWIZZLE_128B: the byte of element (row p, column c) of a
    box of 128-byte rows (64 bf16), 16-byte chunk c // 8 of row p stored at
    chunk (c // 8) ^ (p % 8)."""
    return p * 128 + (((c // 8) ^ (p % 8)) << 4) + (c % 8) * 2


@pytest.mark.parametrize("m,cout", [(300, 136), (49, 256), (128, 64)])
def test_tma_epilogue_stages_the_residual_and_output_tiles(m, cout):
    """Per tile of 128 rows and BN columns (the launcher's: 64 for COUT <=
    64, else 128), the residual's BN/64 boxes land swizzled in the buffer;
    each consumer thread (256: two warpgroups of four warps) reads its pair
    of columns of its two rows from the word the kernel addresses, writes
    the rounded output over it, and the store of the same boxes (clipped to
    the tensor) writes every output element once, equal to the plain
    epilogue."""
    row, col, word, load, store, swz, kbox = _tma_epilogue_exprs()
    rng = np.random.default_rng(43)
    acc = torch.from_numpy(rng.normal(0, 2, (m, cout)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, (1, cout)).astype(np.float32))
    res = torch.from_numpy(rng.normal(0, 1, (m, cout)).astype(np.float32)).to(torch.bfloat16)
    bn = 64 if cout <= 64 else 128
    out = torch.zeros(m, cout, dtype=torch.bfloat16)
    hits = torch.zeros(m, cout, dtype=torch.int64)
    ref = _epilogue(acc, bias, res, True, torch.bfloat16)
    for n0 in range(0, m, 128):
        for c0 in range(0, cout, bn):
            v = dict(c0=c0, n0=n0, ow0=0, oh0=0)
            buf = torch.zeros(bn // 64 * kbox // 2, dtype=torch.bfloat16)  # the epilogue buffer, bf16 elements
            for b in range(bn // 64):
                c, ow, oh, n = (f(**v, b=b) for f in load)
                assert (ow, oh, n) == (0, 0, n0)
                for p in range(128):
                    for cc in range(64):
                        if n + p < m and c + cc < cout:  # TMA's zero fill elsewhere
                            buf[(b * kbox + _swizzled(p, cc)) // 2] = res[n + p, c + cc]
            seen = set()
            for tid in range(256):
                warp, lane = tid >> 5, tid & 31
                for i in range(2):
                    r = row(wg=warp >> 2, warp=warp, lane=lane, i=i)
                    for j in range(bn // 8):
                        nn = col(c0=c0, j=j, lane=lane)
                        at = word(j=j, r=r, lane=lane, kBox=kbox, swz=swz)
                        assert at % 4 == 0 and (r, nn) not in seen
                        seen.add((r, nn))
                        pair = buf[at // 2: at // 2 + 2]
                        inside = [n0 + r < m and nn + k < cout for k in (0, 1)]
                        want = [res[n0 + r, nn + k] if inside[k] else torch.tensor(0, dtype=torch.bfloat16)
                                for k in (0, 1)]
                        assert torch.equal(pair, torch.stack(want))
                        a = torch.tensor([acc[n0 + r, nn + k] if inside[k] else 0.0 for k in (0, 1)])
                        bb = torch.tensor([bias[0, nn + k] if nn + k < cout else 0.0 for k in (0, 1)])
                        buf[at // 2: at // 2 + 2] = _epilogue(a, bb, pair, True, torch.bfloat16)
            assert len(seen) == 128 * bn // 2  # each thread word: a pair of columns
            for b in range(bn // 64):
                c, ow, oh, n = (f(**v, b=b) for f in store)
                for p in range(128):
                    for cc in range(64):
                        if n + p < m and c + cc < cout:  # the store writes nothing outside the tensor
                            out[n + p, c + cc] = buf[(b * kbox + _swizzled(p, cc)) // 2]
                            hits[n + p, c + cc] += 1
    assert bool((hits == 1).all())
    assert torch.equal(out, ref)
