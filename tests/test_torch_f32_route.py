"""The port at argus_tpu's default compute dtype, f32, on the CPU.

argus_tpu's Pallas kernels compute in the model's dtype (f32 by default),
so a fused function on the card needs an f32 kernel (TF32 products) for
each of its rows, or the model must not take it. These tests hold, with no
card:

- the fuse flags' choice for a CUDA tensor as a pure function of (flag,
  function, mode, dtype) (`resnet.fuse_choice`), for each of the 24 TPU
  kernel rows (PERF.md's table) in bf16 and f32: "auto" takes a kernel only
  where `AUTO_FUSE` has its entry in that dtype, "on" raises
  NotImplementedError naming ROADMAP A14 for an f32 row with no kernel yet,
  the CPU runs every plain version; and the model's own use of it
  (`ResNet._fuse`, the stem's packed view, remat);
- the f32 wrappers' dtype rule (`kernel_dtype`);
- the host-side operands the f32 launchers receive (the transposed and
  tap-reordered weights of the data gradients) as exact rearrangements of
  the fold (`fold_affine`, `fold_bottleneck_params`,
  `fold_projection_params`), bit for bit;
- the premise of chip_smoke.py's f32 gate: the identity block and the stem
  with every conv operand rounded to TF32 as the kernels round it
  (cvt.rna) stay within 2.5e-3 * max|plain| + 1.25e-3 of the f32 plain
  versions, and farther than f32 rounding (so the card's check can tell).
"""

import numpy as np
import pytest
import torch

from _torch_threads import _two_threads  # noqa: F401
from argus_tpu_torch.models import resnet
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import proj_fused as tp
from argus_tpu_torch.ops.kernels import stem_fused as ts

BF, F32 = torch.bfloat16, torch.float32
F32_GATE = (2.5e-3, 1.25e-3)  # chip_smoke.py's f32 kernel gate

# every function that reaches `pl.pallas_call` in argus_tpu (PERF.md's kernel
# table): (row, fuse function, mode, the variant keying its f32 kernel, has an
# f32 kernel on the card); the augmentation, blur and BN rows have no fuse
# flag (`use_augmentation`, `bn_impl`) and take f32 on the card already
ROWS = [
    ("stem_fused._stem_fwd_pallas:244", "stem", "forward", None, True),
    ("stem_fused._stem_fwd_packed_pallas:262", "stem", "forward", "stem_packed", False),
    ("stem_fused._stem_fwd_save_pallas:280", "stem", "train", None, False),
    ("stem_fused._stem_bwd_pallas:304", "stem", "train", None, False),
    ("stage_fused._chain_fwd_pallas:364/no-save", "stage_chain", "forward", None, False),
    ("stage_fused._chain_fwd_pallas:364/save", "stage_chain", "train", None, True),
    ("stage_fused._chain_fwd_packed:527", "stage_chain_packed", "forward", None, True),
    ("stage_fused._chain_bwd_pallas:586", "stage_chain", "train", None, True),
    ("proj_fused._proj_fwd_pallas:205/no-save", "projection", "forward", None, True),
    ("proj_fused._proj_fwd_pallas:205/save", "projection", "train", None, True),
    ("proj_fused._proj_bwd_pallas:363", "projection", "train", None, True),
    ("block_fused._block_fwd_pallas:270", "identity", "forward", None, True),
    ("block_fused._block_fwd_save_pallas:314", "identity", "train", None, True),
    ("block_fused._block_bwd_saved_pallas:394", "identity", "train", None, True),
    ("block_fused._block_bwd_pallas:519", "identity", "train", "identity_remat", False),
    ("basic_fused._fwd_pallas:87/no-save", "basic", "forward", None, False),
    ("basic_fused._fwd_pallas:87/save", "basic", "train", None, False),
    ("basic_fused._bwd_pallas:167", "basic", "train", None, False),
    ("pointwise._pw_fwd_pallas:93", "pointwise", "forward", None, False),
    ("pointwise._pw_bwd_pallas:157", "pointwise", "train", None, False),
    ("augment_fused.fused_augment:278", None, None, None, True),
    ("blur.fused_random_blur:81", None, None, None, True),
    ("bn_reduce.fused_stats:74", None, None, None, True),
    ("bn_reduce.fused_bn_bwd_reduce:149", None, None, None, True),
]


@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_choice_for_each_row(row, dtype):
    name, fn, mode, variant, ported = row
    if fn is None:  # no fuse flag reaches it
        assert all(k[0] != name.split(".")[0] for k in resnet.AUTO_FUSE)
        return
    key = variant or fn
    assert ((key, mode) in resnet.F32_TO_PORT) is not ported
    choose = lambda flag, cuda=True: resnet.fuse_choice(flag, fn, mode, dtype, cuda, variant)  # noqa: E731
    entry = (fn, mode, "bfloat16" if dtype == BF else "float32")
    # the CPU: the plain versions, in either dtype, under "on" only
    assert choose("on", cuda=False) is True and choose("auto", cuda=False) is False
    assert choose("off") is False and choose("off", cuda=False) is False
    auto = choose("auto")
    if auto:  # "auto" takes a kernel only where the table has its entry in this dtype
        assert resnet.AUTO_FUSE[entry] is True
    if dtype == BF or ported:
        assert choose("on") is True
        assert auto is resnet.AUTO_FUSE.get(entry, False)
    else:
        with pytest.raises(NotImplementedError, match="A14"):
            choose("on")
        assert auto is False


def test_f32_table_names_only_ported_functions():
    """Every f32 entry of `AUTO_FUSE` is a function with an f32 kernel in
    its mode, and every bf16 function has its entry."""
    for (fn, mode, dt), _ in resnet.AUTO_FUSE.items():
        if dt == "float32":
            assert (fn, mode) not in resnet.F32_TO_PORT
    bf16 = {(fn, mode) for fn, mode, dt in resnet.AUTO_FUSE if dt == "bfloat16"}
    assert {(r[1], r[2]) for r in ROWS if r[1] is not None} == bf16
    with pytest.raises(ValueError):
        resnet.fuse_choice("yes", "stem", "forward", F32, True)


class _OnCard:
    """Stands in for a CUDA activation: the choice reads only `is_cuda`."""

    is_cuda = True


def _frozen_resnet50(**kw):
    return resnet.resnet50(bn_frozen=True, bn_frozen_affine=True, **kw)


def test_model_in_f32_on_the_card():
    """The f32 model's per-stage choice: "on" takes every ported function
    (the flagship's stage-0 chain and blocks, both modes) and raises for the
    remat and frozen-stage rows; "auto" follows the f32 entries."""
    f32t = {(f, m): v for (f, m, d), v in resnet.AUTO_FUSE.items() if d == "float32"}
    on = _frozen_resnet50(fuse_block="on", fuse_proj="on", fuse_stage="on", fuse_stem="on")
    auto = _frozen_resnet50()
    for mode in ("forward", "train"):
        for i in range(4):
            assert on._fuse(_OnCard(), mode, i, 64 >> i) == (True, True, i == 0)
            chain = "stage_chain_packed" if i == 0 and mode == "forward" else "stage_chain"
            assert auto._fuse(_OnCard(), mode, i, 64 >> i) == (
                f32t.get(("identity", mode), False), f32t.get(("projection", mode), False),
                i == 0 and f32t.get((chain, mode), False))
    on.remat = True  # the recompute backward has no f32 kernel
    with pytest.raises(NotImplementedError, match="A14"):
        on._fuse(_OnCard(), "train", 1, 32)
    assert on._fuse(_OnCard(), "forward", 1, 32) == (True, True, False)
    on.remat, on.frozen_stages = False, 2  # the whole-stage no-save chains of frozen stages
    with pytest.raises(NotImplementedError, match="A14"):
        on._fuse(_OnCard(), "forward", 1, 32)
    auto.frozen_stages = 2
    assert auto._fuse(_OnCard(), "forward", 1, 32)[2] is False
    # bf16 keeps its table, remat and frozen chains included
    bf = _frozen_resnet50(dtype="bfloat16", fuse_block="on", fuse_proj="on", fuse_stage="on", remat=True,
                          frozen_stages=2)
    assert bf._fuse(_OnCard(), "forward", 1, 32) == (True, True, True)
    assert bf._fuse(_OnCard(), "train", 3, 8) == (True, True, False)


def test_packed_stem_and_pointwise_choice_in_f32():
    """The stem's packed view (frozen stages) and the pointwise op have no
    f32 kernel: "on" raises, "auto" takes the plain stem view and cuDNN."""
    with pytest.raises(NotImplementedError, match="A14"):
        resnet.flag_on("on", _OnCard(), "stem", "forward", F32, row="stem_packed")
    assert resnet.flag_on("auto", _OnCard(), "stem", "forward", F32, row="stem_packed") is False
    assert resnet.flag_on("auto", _OnCard(), "stem", "forward", F32) is resnet.AUTO_FUSE[("stem", "forward", "float32")]
    m = _frozen_resnet50(fuse_pointwise="on")
    with pytest.raises(NotImplementedError, match="A14"):
        m._pointwise(_OnCard(), "train")
    m.fuse_pointwise = "auto"
    assert m._pointwise(_OnCard(), "forward") is None
    m.fuse_pointwise = "dot"  # the matmul form: no kernel
    assert m._pointwise(_OnCard(), "train") == "dot"


def test_kernel_dtype_rule():
    x32, xbf = torch.zeros(1, 2, 2, 8), torch.zeros(1, 2, 2, 8, dtype=BF)
    assert tb.kernel_dtype(x32) is F32 and tb.kernel_dtype(xbf) is BF
    assert tb.kernel_dtype(xbf, f32=False) is BF
    with pytest.raises(NotImplementedError, match="A14"):
        tb.kernel_dtype(x32, f32=False)
    with pytest.raises(TypeError):
        tb.kernel_dtype(x32.half())


def _bn(rng, c):
    return [torch.from_numpy(a) for a in (rng.uniform(0.5, 1.5, c), rng.normal(0, 0.1, c), rng.normal(0, 0.1, c),
                                          rng.uniform(0.5, 1.5, c))]


def _raw(rng, *shape):
    k = torch.from_numpy((rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32))
    return [k, *(t.float() for t in _bn(rng, shape[-1]))]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("stride", [1, 2])
def test_f32_operand_layouts_are_the_fold_rearranged(stride):
    """The data gradients' operands of the f32 launchers (w1^T, the 3x3's
    taps, w3^T, wsc^T) hold the folded f32 weights' bits, each in its
    place: the 3x3 at stride 1 as w2[2-ky, 2-kx]^T, at stride 2 by output
    parity class (an even coordinate tap 1, an odd one taps 2 then 0)."""
    rng = np.random.default_rng(40 + stride)
    cin, f, cout = 16, 8, 32
    raw = _raw(rng, 1, 1, cin, f) + _raw(rng, 3, 3, f, f) + _raw(rng, 1, 1, f, cout) + _raw(rng, 1, 1, cin, cout)
    w1, b1, w2, b2, w3, b3, wsc, bsc = tp.fold_projection_params(F32, *raw)
    k1, s1, bi1, m1, v1 = raw[:5]
    want1, wantb1 = tb.fold_affine(k1.reshape(cin, f), s1, bi1, m1, v1, 1e-5, F32)
    assert torch.equal(_bits(w1), _bits(want1)) and torch.equal(_bits(b1), _bits(wantb1))
    w1t, w2d, w3t, wsct = tp.transposed_weights(w1, w2, w3, wsc, stride)
    assert all(t.dtype == F32 and t.is_contiguous() for t in (w1t, w2d, w3t, wsct))
    for got, want in ((w1t, w1.t()), (w3t, w3.t()), (wsct, wsc.t())):
        assert torch.equal(_bits(got), _bits(want))
    if stride == 1:
        taps = [(2 - ky, 2 - kx) for ky in range(3) for kx in range(3)]
    else:
        by_parity = {0: [1], 1: [2, 0]}
        taps = [(ky, kx) for py in (0, 1) for px in (0, 1) for ky in by_parity[py] for kx in by_parity[px]]
    assert w2d.shape == (len(taps), f, f)
    for t, (ky, kx) in enumerate(taps):
        assert torch.equal(_bits(w2d[t]), _bits(w2[ky, kx].t()))
    # the identity block's operands: the same rule at stride 1
    ids = tb.fold_bottleneck_params(F32, *_raw(rng, 1, 1, cout, f), *_raw(rng, 3, 3, f, f), *_raw(rng, 1, 1, f, cout))
    i1t, i2d, i3t = tb.transposed_weights(ids[0], ids[2], ids[4])
    assert torch.equal(_bits(i1t), _bits(ids[0].t())) and torch.equal(_bits(i3t), _bits(ids[4].t()))
    assert torch.equal(_bits(i2d), _bits(ids[2].flip(0, 1).transpose(2, 3).reshape(9, f, f)))


def tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as cvt.rna rounds it: 10 mantissa bits, to
    nearest, ties away from zero (the sign is apart from the magnitude)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _within_gate(got, want):
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    return err, F32_GATE[0] * ref + F32_GATE[1]


def test_tf32_rounding_is_cvt_rna():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -(1.0 + 2**-11), 1.0 + 2**-12, 3.0])
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 1.0, 3.0]


def test_tf32_products_stay_within_the_f32_gate():
    """The identity block forward and backward and the stem with every conv
    operand rounded to TF32 (the kernels' arithmetic: the products of
    TF32-rounded values summed in f32) against the f32 plain versions: within
    chip_smoke.py's f32 gate, and farther than f32 summation order alone."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32))
    ws = tb.fold_bottleneck_params(F32, *_raw(rng, 1, 1, 64, 16), *_raw(rng, 3, 3, 16, 16), *_raw(rng, 1, 1, 16, 64))
    r = [tf32(t) if i % 2 == 0 else t for i, t in enumerate(ws)]
    # the forward, each conv's operands rounded: h1 and h2 are rounded again where they feed the next conv
    h1 = tb.bias_relu(tb.matmul_f32(tf32(x), r[0]), ws[1], F32)
    h2 = tb.bias_relu(tb.conv3x3_f32(tf32(h1), r[2], 1), ws[3], F32)
    out = torch.relu(tb.matmul_f32(tf32(h2), r[4]) + ws[5].reshape(-1) + x)
    want, wh1, wh2 = tb.bottleneck_block_save_plain(x, *ws)
    for got, ref in ((out, want), (h1, wh1), (h2, wh2)):
        err, gate = _within_gate(got, ref)
        assert 0 < err <= gate, (err, gate)
    # the backward from the plain forward's residuals, every product's operands rounded
    g = torch.from_numpy(rng.normal(0, 1, x.shape).astype(np.float32))
    m3 = tb.relu_mask(g, want)
    m2 = tb.relu_mask(tf32(m3) @ r[4].t(), wh2)
    dh1, dw2 = tb.conv3x3_grads_f32(tf32(wh1), tf32(m2), r[2], 1)
    m1 = tb.relu_mask(dh1, wh1)
    got = (tf32(m1) @ r[0].t() + m3, tb.wgrad_f32(tf32(x), tf32(m1)), dw2, tb.wgrad_f32(tf32(wh2), tf32(m3)))
    ref = tb.block_bwd_plain(x, g, want, wh1, wh2, ws[0], ws[2], ws[4])
    for a, b in zip(got, ref):
        err, gate = _within_gate(a, b)
        assert err <= gate, (err, gate)
    # the stem: conv7x7/s2 of TF32 operands, then the pool
    img = torch.from_numpy(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
    w7, b7 = ts.fold_stem_params(*_raw(rng, 7, 7, 3, 64), 1e-5, F32)
    err, gate = _within_gate(ts.stem_pool_plain(tf32(img), tf32(w7), b7), ts.stem_pool_plain(img, w7, b7))
    assert 0 < err <= gate, (err, gate)
