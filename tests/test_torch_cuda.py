"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forwards, the saving forwards and the one-pass backwards (bottleneck and
BasicBlock; the projection and chain forwards at their main-path widths), the two augmentation kernels, the trained stem's saving
forward and weight gradient, BatchNorm's two reductions, the packed stem
and the frozen stages' no-save chains, the pointwise forward and backward
and the identity block's recompute backward, the f32 kernels (TF32
products: the stem's no-save forward, the identity and projection blocks
and the stage-0 chain, and the A14 rows raising), and the training steps
(fused, trained stem, exact BN, frozen stages, `fuse_pointwise`, remat)
against their CPU runs; the device feed's batches; the launches of "auto"
against `AUTO_FUSE`.

These need an NVIDIA Hopper GPU and nvcc: they carry the `cuda` marker and
skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``. `chip_smoke.py` makes the
same comparison at the full serving shapes.

Tolerance (bf16 outputs and f32 weight gradients): max |kernel - plain| <=
2e-2 * max |plain| + 1e-2; both sides sum the same bf16 operands in f32 in
different orders, and round the bf16 outputs (and the m1/m2 masks of the
backward) once. The augmentation kernels round every op as their plain
versions do: the blur is held bit-exact, the whole stack to one bf16 rounding
step (1.6e-2, the contrast mean and the hue's divisions differ by an f32 ulp)
and 1e-5 in f32.
"""

import pytest
import torch

import numpy as np

from argus_tpu_torch.ops import kernels
from argus_tpu_torch.ops import augment as TA
from argus_tpu_torch.ops.kernels import augment_fused as taf
from argus_tpu_torch.ops.kernels import basic_fused as tbf
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import blur as tbl
from argus_tpu_torch.ops.kernels import bn_reduce as tbn
from argus_tpu_torch.ops.kernels import proj_fused as tp
from argus_tpu_torch.ops.kernels import stage_fused as tst
from argus_tpu_torch.ops.kernels import stem_fused as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item() + 1e-2, err


def _device_kernels(fn, calls: int = 1):
    """[(device kernel name, launches)] of `calls` calls of `fn`, from
    torch.profiler (the attribute of a record's device time differs between
    PyTorch versions). A profiled window now and then loses records, a
    launch or all of them: a window with none is read again, up to three
    times, and a count may fall short of the launches."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        t = getattr(e, "self_device_time_total", None)
        return getattr(e, "self_cuda_time_total", 0.0) if t is None else t

    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages() if device_us(e) > 0]
        if kernels:
            break
    return kernels


def _w(g, *shape, dev):
    return (torch.randn(*shape, generator=g) / shape[-2] ** 0.5).to(dev, torch.bfloat16)


def _b(g, c, dev):
    return (0.1 * torch.randn(1, c, generator=g)).to(dev)


def _id(g, c, f, dev):
    return (_w(g, c, f, dev=dev), _b(g, f, dev), _w(g, 3, 3, f, f, dev=dev), _b(g, f, dev),
            _w(g, f, c, dev=dev), _b(g, c, dev))


def _proj(g, cin, f, cout, dev):
    return (_w(g, cin, f, dev=dev), _b(g, f, dev), _w(g, 3, 3, f, f, dev=dev), _b(g, f, dev),
            _w(g, f, cout, dev=dev), _b(g, cout, dev), _w(g, cin, cout, dev=dev), _b(g, cout, dev))


def test_stem_kernel(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(3, 72, 40, 3, generator=g).to(dev, torch.bfloat16)
    w = (0.2 * torch.randn(7, 7, 3, 64, generator=g)).to(dev, torch.bfloat16)
    b = _b(g, 64, dev)
    before = ts.KERNEL.launches
    _close(ts.stem_pool(x, w, b), ts.stem_pool_plain(x, w, b))
    assert ts.KERNEL.launches == before + 1


@pytest.mark.parametrize("cin,f", [(64, 16), (256, 64)])
def test_identity_block_kernel(dev, cin, f):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 9, 7, cin, generator=g).to(dev, torch.bfloat16)
    ws = _id(g, cin, f, dev)
    _close(tb.bottleneck_block(x, *ws), tb.bottleneck_block_plain(x, *ws))


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_kernel(dev, stride):
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 10, 6, 64, generator=g).to(dev, torch.bfloat16)
    ws = _proj(g, 64, 32, 128, dev)
    _close(tp.projection_block(x, *ws, stride), tp.projection_block_plain(x, *ws, stride))


@pytest.mark.parametrize("with_proj", [True, False])
def test_stage_kernel(dev, with_proj):
    g = torch.Generator().manual_seed(3)
    cin = 64 if with_proj else 256
    x = torch.rand(2, 8, 8, cin, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, cin, 64, 256, dev) if with_proj else None
    ids = [_id(g, 256, 64, dev) for _ in range(2)]
    _close(tst.fused_stage(x, proj, ids, 1), tst.stage_plain(x, proj, ids, 1))


def test_wrappers_check_arguments(dev):
    x = torch.zeros(1, 8, 8, 64, device=dev)  # f32 activations with bf16 weights
    ws = _id(torch.Generator().manual_seed(4), 64, 16, dev)
    with pytest.raises(TypeError):
        tb.bottleneck_block(x, *ws)
    with pytest.raises(ValueError):
        tb.bottleneck_block(x.to(torch.bfloat16)[..., :60], *ws)
    assert set(kernels.KERNELS) == {
        "stem_fused", "stage_fused", "proj_fused", "block_fused",
        "stage_fused_save", "stage_fused_bwd", "proj_fused_save", "proj_fused_bwd",
        "block_fused_save", "block_fused_bwd", "augment_fused", "blur",
        "basic_fused", "basic_fused_save", "basic_fused_bwd",
        "stem_fused_save", "stem_fused_bwd", "bn_stats", "bn_bwd_reduce",
        "stem_fused_packed", "stage_fused_frozen", "pointwise", "pointwise_bwd", "block_fused_rbwd",
        "stem_fused_f32", "stage_fused_f32", "stage_fused_save_f32", "stage_fused_bwd_f32", "proj_fused_f32",
        "proj_fused_save_f32", "proj_fused_bwd_f32", "block_fused_f32", "block_fused_save_f32", "block_fused_bwd_f32",
    }


def _grad(g, shape, dev):
    return torch.randn(*shape, generator=g).to(dev, torch.bfloat16)


def _all_close(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item() + 1e-2, err


# the identity block's card cases (n, h, w, cin, f): F = 16 below the 64-wide
# tiles (zero-filled past F), odd H and W, F = 32, CIN 2048 with F 512 at a
# small N, shapes whose weight gradients split (4608 and 4096 rows), and CIN
# 72 with F 24 (no launch in whole 64-channel steps)
IDENTITY_CASES = [(2, 9, 7, 64, 16), (2, 48, 48, 64, 16), (1, 8, 8, 256, 64), (3, 5, 11, 128, 32),
                  (1, 5, 7, 2048, 512), (4, 32, 32, 256, 64), (2, 6, 5, 72, 24)]


@pytest.mark.parametrize("n,h,w,cin,f", IDENTITY_CASES)
def test_identity_block_save_and_backward_kernels(dev, n, h, w, cin, f):
    """The saving forward and the one-pass backward (on the Hopper engines),
    with and without dx."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    ws = _id(g, cin, f, dev)
    saved = tb.bottleneck_block_save(x, *ws)
    _all_close(saved, tb.bottleneck_block_save_plain(x, *ws))
    out, h1, h2 = saved
    gr = _grad(g, out.shape, dev)
    args = (x, gr, out, h1, h2, ws[0], ws[2], ws[4])
    before = tb.KERNEL_BWD.launches
    _all_close(tb.block_bwd(*args), tb.block_bwd_plain(*args))
    assert tb.KERNEL_BWD.launches == before + 1
    got = tb.block_bwd(*args, need_dx=False)
    assert got[0] is None
    _all_close(got[1:], tb.block_bwd_plain(*args)[1:])


# the identity bottleneck's three main-path widths of stages 1-3 (CIN, F) at a
# small N: conv1 over 8-32 k-steps, the 3x3 at F = 128-512, conv3 on
# 128-wide tiles with the residual
IDENTITY_MAIN_CASES = [(2, 32, 32, 512, 128), (2, 16, 16, 1024, 256), (2, 8, 8, 2048, 512)]


@pytest.mark.parametrize("n,h,w,cin,f", IDENTITY_MAIN_CASES)
def test_identity_block_forward_at_main_path_widths(dev, n, h, w, cin, f):
    """Both variants of the identity forward (the TMA engine's three
    launches) against the plain version; two calls give the same bits."""
    g = torch.Generator().manual_seed(16)
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    ws = _id(g, cin, f, dev)
    before = (tb.KERNEL.launches, tb.KERNEL_SAVE.launches)
    out = tb.bottleneck_block(x, *ws)
    _close(out, tb.bottleneck_block_plain(x, *ws))
    saved = tb.bottleneck_block_save(x, *ws)
    _all_close(saved, tb.bottleneck_block_save_plain(x, *ws))
    assert torch.equal(saved[0], out) and torch.equal(tb.bottleneck_block(x, *ws), out)
    assert (tb.KERNEL.launches, tb.KERNEL_SAVE.launches) == (before[0] + 2, before[1] + 1)


# the projection forward's card cases (n, h, w, cin, f, cout, stride): the
# stride-2 entries of ResNet-50's stages 1-3 and stage 0's stride-1 block at
# their main-path widths and input sizes (small N), then the engine's
# stride-2 edges: outputs of 1 x 1, 2 x 2, 5 x 7 and 9 x 17 (not powers of
# two), channels that are not whole 64-channel steps
PROJ_MAIN_CASES = [(2, 64, 64, 256, 128, 512, 2), (2, 32, 32, 512, 256, 1024, 2), (2, 16, 16, 1024, 512, 2048, 2),
                   (2, 64, 64, 64, 64, 256, 1), (3, 2, 2, 1024, 512, 2048, 2), (2, 4, 4, 512, 256, 1024, 2),
                   (3, 10, 14, 256, 128, 512, 2), (2, 18, 34, 72, 24, 64, 2)]


@pytest.mark.parametrize("n,h,w,cin,f,cout,stride", PROJ_MAIN_CASES)
def test_projection_block_forward_at_main_path_widths(dev, n, h, w, cin, f, cout, stride):
    """Both variants of the projection forward (the TMA engine's three
    launches: conv1, the 3x3 at stride S through a strided tensor map, conv3
    and the shortcut as two K segments) against the plain version; two
    calls give the same bits."""
    g = torch.Generator().manual_seed(17)
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    ws = _proj(g, cin, f, cout, dev)
    before = (tp.KERNEL.launches, tp.KERNEL_SAVE.launches)
    out = tp.projection_block(x, *ws, stride)
    _close(out, tp.projection_block_plain(x, *ws, stride))
    saved = tp.projection_block_save(x, *ws, stride)
    _all_close(saved, tp.projection_block_save_plain(x, *ws, stride))
    assert torch.equal(saved[0], out) and torch.equal(tp.projection_block(x, *ws, stride), out)
    assert (tp.KERNEL.launches, tp.KERNEL_SAVE.launches) == (before[0] + 2, before[1] + 1)


# the three chain forms at their main-path shapes (small N): stage 0 (x of
# 64x64x64, the projection at stride 1 + 2 identity blocks, F = 64) and the
# frozen stages' whole-stage chains 1 (64x64x256, F = 128, stride 2, 3
# identity blocks) and 2 (32x32x512, F = 256, stride 2, 5)
CHAIN_MAIN_CASES = [(64, 64, 64, 256, 1, 2), (64, 256, 128, 512, 2, 3), (32, 512, 256, 1024, 2, 5)]


@pytest.mark.parametrize("h,cin,f,cout,stride,k", CHAIN_MAIN_CASES)
def test_stage_chain_forwards_at_main_path_widths(dev, h, cin, f, cout, stride, k):
    """The no-save chain (counted as `stage_fused` at stage 0 and as
    `stage_fused_frozen` for the whole-stage chains) and the saving chain
    against their plain versions; two calls give the same bits."""
    g = torch.Generator().manual_seed(18)
    x = torch.rand(2, h, h, cin, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, cin, f, cout, dev)
    ids = [_id(g, cout, f, dev) for _ in range(k)]
    counts = (tst.KERNEL, tst.KERNEL_FROZEN, tst.KERNEL_SAVE)
    before = [c.launches for c in counts]
    out = tst.fused_stage(x, proj, ids, stride)
    _close(out, tst.stage_plain(x, proj, ids, stride))
    saved = tst.fused_stage_save(x, proj, ids, stride)
    got, want = saved, tst.stage_save_plain(x, proj, ids, stride)
    _all_close([got[0], *got[1], *got[2], *got[3]], [want[0], *want[1], *want[2], *want[3]])
    assert torch.equal(saved[0], out) and torch.equal(tst.fused_stage(x, proj, ids, stride), out)
    packed = stride == 1
    assert [c.launches - b for c, b in zip(counts, before)] == [2 * packed, 2 * (not packed), 1]


@pytest.mark.parametrize("n,h,w", [(2, 10, 6), (4, 32, 32)])
@pytest.mark.parametrize("cin,f,cout", [(64, 32, 128), (256, 64, 256), (256, 128, 512)])
@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_save_and_backward_kernels(dev, stride, cin, f, cout, n, h, w):
    """The saving forward and the one-pass backward at the Hopper engines'
    edges: F = 32 and 64 (narrower than one 64- or 128-wide tile), ragged
    spatial sizes, and (4, 32, 32) whose weight gradients split their rows;
    without dx too."""
    g = torch.Generator().manual_seed(6)
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    ws = _proj(g, cin, f, cout, dev)
    saved = tp.projection_block_save(x, *ws, stride)
    _all_close(saved, tp.projection_block_save_plain(x, *ws, stride))
    out, h1, h2 = saved
    args = (x, _grad(g, out.shape, dev), out, h1, h2, ws[0], ws[2], ws[4], ws[6], stride)
    count = tp.KERNEL_BWD.launches
    _all_close(tp.proj_bwd(*args), tp.proj_bwd_plain(*args))
    got = tp.proj_bwd(*args, need_dx=False)
    assert got[0] is None and tp.KERNEL_BWD.launches == count + 2
    _all_close(got[1:], tp.proj_bwd_plain(*args)[1:])


@pytest.mark.parametrize("with_proj,stride", [(True, 1), (True, 2), (False, 1)])
def test_stage_save_and_backward_kernels(dev, with_proj, stride):
    g = torch.Generator().manual_seed(7)
    cin = 64 if with_proj else 256
    x = torch.rand(2, 8, 8, cin, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, cin, 64, 256, dev) if with_proj else None
    ids = [_id(g, 256, 64, dev) for _ in range(2)]
    out, bnds, h1s, h2s = tst.fused_stage_save(x, proj, ids, stride)
    p_out, p_bnds, p_h1s, p_h2s = tst.stage_save_plain(x, proj, ids, stride)
    _all_close([out, *bnds, *h1s, *h2s], [p_out, *p_bnds, *p_h1s, *p_h2s])
    pw = (proj[0], proj[2], proj[4], proj[6]) if with_proj else None
    iw = [(w[0], w[2], w[4]) for w in ids]
    args = (x, _grad(g, out.shape, dev), out, bnds, h1s, h2s, pw, iw, stride)
    dx, pd, idd = tst.stage_bwd(*args)
    rdx, rpd, ridd = tst.stage_bwd_plain(*args)
    _all_close([dx, *(pd or ()), *[d for ds in idd for d in ds]],
               [rdx, *(rpd or ()), *[d for ds in ridd for d in ds]])


def test_block_function_gradients_match_plain(dev):
    """autograd through the kernel Function on the card against the same
    Function on a CPU copy (its plain versions)."""
    g = torch.Generator().manual_seed(8)
    x = torch.rand(2, 8, 8, 64, generator=g).to(torch.bfloat16)
    ws = [t.cpu() for t in _id(g, 64, 16, dev)]
    gr = torch.randn(2, 8, 8, 64, generator=g).to(torch.bfloat16)
    grads = []
    for d in ("cpu", dev):
        xs = x.to(d).requires_grad_()
        wd = [t.to(d).requires_grad_(i % 2 == 0) for i, t in enumerate(ws)]
        out = tb.block_saved(xs, *wd)
        grads.append([t.cpu() for t in torch.autograd.grad(out, [xs, wd[0], wd[2], wd[4]], gr.to(d))])
    _all_close(grads[1], grads[0])


def test_train_step_on_card_matches_cpu(dev):
    """A ResNet-50 train step (bf16, frozen BN and stem, fused) on the card
    and on the CPU from the same state: losses within bf16 tolerance, and
    the launch counts of the training path (the no-save forwards stay
    unused)."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    mcfg = NCameraCNNConfig(
        n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True,
        bn_frozen_affine=True, stem_frozen=True, fuse_block="on", fuse_proj="on",
        fuse_stem="on", fuse_stage="on",
    )
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=False, learning_rate=1e-3)
    rng = np.random.default_rng(0)
    batch = {
        "images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
        "cube_pose": np.tile(np.array([0.1, 0, 0.2, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
        "mask": np.ones(2, np.float32),
    }
    losses = {}
    for d in ("cpu", "cuda"):
        model, state = create_train_state(cfg, seed=0, device=d)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("BatchNorm_2.weight"):
                    p.fill_(0.2)
        kernels.reset_launch_counts()
        step = make_train_step(model, cfg, device=d)
        state, loss = step(state, batch)
        losses[d] = float(loss)
        counts = kernels.launch_counts()
    assert counts == {
        "stem_fused": 1, "stage_fused": 0, "proj_fused": 0, "block_fused": 0,
        "stage_fused_save": 1, "stage_fused_bwd": 1, "proj_fused_save": 3, "proj_fused_bwd": 3,
        "block_fused_save": 10, "block_fused_bwd": 10, "augment_fused": 0, "blur": 0,
        "basic_fused": 0, "basic_fused_save": 0, "basic_fused_bwd": 0,
        "stem_fused_save": 0, "stem_fused_bwd": 0, "bn_stats": 0, "bn_bwd_reduce": 0,
        "stem_fused_packed": 0, "stage_fused_frozen": 0, "pointwise": 0, "pointwise_bwd": 0,
        "block_fused_rbwd": 0, **{name: 0 for name in kernels.KERNELS if name.endswith("_f32")},
    }, counts
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"]) + 1e-3, losses


def _basic(g, c, dev):
    return _w(g, 3, 3, c, c, dev=dev), _b(g, c, dev), _w(g, 3, 3, c, c, dev=dev), _b(g, c, dev)


@pytest.mark.parametrize("n,h,w,c", [
    (2, 9, 7, 64), (2, 48, 48, 64), (1, 8, 8, 256), (3, 5, 11, 128), (2, 7, 9, 256), (1, 5, 7, 512),
    (4, 32, 32, 128),
])
def test_basic_block_kernels(dev, n, h, w, c):
    """The no-save and saving forwards and the one-pass backward of the
    identity BasicBlock at C = 64 to 512; ragged spatial sizes put image
    edges inside the 128-row GEMM tiles, and (2, 48, 48, 64) and (4, 32, 32,
    128) have 4608 and 4096 rows: the weight gradients split and sum
    partials."""
    g = torch.Generator().manual_seed(11)
    x = torch.rand(n, h, w, c, generator=g).to(dev, torch.bfloat16)
    ws = _basic(g, c, dev)
    counts = [k.launches for k in (tbf.KERNEL, tbf.KERNEL_SAVE, tbf.KERNEL_BWD)]
    _close(tbf.basic_block(x, *ws), tbf.basic_fwd_plain(x, *ws, save=False))
    saved = tbf.basic_block_save(x, *ws)
    _all_close(saved, tbf.basic_fwd_plain(x, *ws, save=True))
    out, h1 = saved
    args = (x, _grad(g, out.shape, dev), out, h1, ws[0], ws[2])
    _all_close(tbf.basic_bwd(*args), tbf.basic_bwd_plain(*args))
    assert [k.launches for k in (tbf.KERNEL, tbf.KERNEL_SAVE, tbf.KERNEL_BWD)] == [c_ + 1 for c_ in counts]
    got = tbf.basic_bwd(*args, need_dx=False)
    assert got[0] is None
    _all_close(got[1:], tbf.basic_bwd_plain(*args)[1:])


# the chain backward's card cases (n, h, w, stride, identity blocks, with the
# projection): ragged 9 x 13 blocks (the stride-2 entry halves 18 x 26), one
# to three identity blocks, and a chain of identity blocks alone
CHAIN_CASES = [(3, 9, 13, 1, 2, True), (3, 18, 26, 2, 1, True), (3, 18, 26, 2, 3, True), (3, 9, 13, 1, 1, False),
               (3, 9, 13, 1, 3, False), (2, 8, 8, 1, 0, True)]


def _chain_args(g, n, h, w, stride, k, with_proj, dev):
    cin = 64 if with_proj else 256
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, cin, 64, 256, dev) if with_proj else None
    ids = [_id(g, 256, 64, dev) for _ in range(k)]
    out, bnds, h1s, h2s = tst.fused_stage_save(x, proj, ids, stride)
    pw = (proj[0], proj[2], proj[4], proj[6]) if with_proj else None
    return (x, _grad(g, out.shape, dev), out, bnds, h1s, h2s, pw, [(t[0], t[2], t[4]) for t in ids], stride)


def _chain_flat(res):
    dx, pd, idd = res
    return [dx, *(pd or ()), *[d for ds in idd for d in ds]]


def _chain_flat_fwd(res):
    out, bnds, h1s, h2s = res
    return [out, *bnds, *h1s, *h2s]


@pytest.mark.parametrize("n,h,w,stride,k,with_proj", CHAIN_CASES)
def test_stage_backward_on_hopper_compositions(dev, n, h, w, stride, k, with_proj):
    """The chain backward on the Hopper compositions (the boundary masks in
    the dx launches) against its plain version, with and without dx."""
    g = torch.Generator().manual_seed(13)
    args = _chain_args(g, n, h, w, stride, k, with_proj, dev)
    before = tst.KERNEL_BWD.launches
    got = tst.stage_bwd(*args)
    _all_close(_chain_flat(got), _chain_flat(tst.stage_bwd_plain(*args)))
    no_dx = tst.stage_bwd(*args, need_dx=False)
    assert no_dx[0] is None and tst.KERNEL_BWD.launches == before + 2
    _all_close(_chain_flat(no_dx)[1:], _chain_flat(tst.stage_bwd_plain(*args, need_dx=False))[1:])


# the BasicBlock forward's card cases (n, h, w, c): every C of ResNet-18 with
# ragged H and W, so that the TMA boxes cross the image edge on every side
# (16-wide boxes past W, 8-row boxes past H, multi-image boxes past an odd
# N), and images smaller than 8 x 8 (boxes of their rounded-up size)
BASIC_FWD_CASES = [(3, 9, 13, 64), (2, 20, 37, 64), (3, 11, 8, 128), (2, 9, 13, 256), (3, 8, 8, 512),
                   (1, 12, 30, 512), (1, 5, 7, 512), (3, 5, 11, 128), (3, 2, 2, 64), (5, 1, 3, 256), (2, 3, 20, 64)]


@pytest.mark.parametrize("n,h,w,c", BASIC_FWD_CASES)
def test_basic_block_forward_on_tma_boxes(dev, n, h, w, c):
    """Both variants of the BasicBlock forward against the plain version;
    two calls give the same bits."""
    g = torch.Generator().manual_seed(14)
    x = torch.rand(n, h, w, c, generator=g).to(dev, torch.bfloat16)
    ws = _basic(g, c, dev)
    out = tbf.basic_block(x, *ws)
    _close(out, tbf.basic_fwd_plain(x, *ws, save=False))
    saved = tbf.basic_block_save(x, *ws)
    _all_close(saved, tbf.basic_fwd_plain(x, *ws, save=True))
    assert torch.equal(saved[0], out) and torch.equal(tbf.basic_block(x, *ws), out)


def test_basic_block_forward_needs_whole_64_channel_steps(dev):
    """The forward kernel raises at C % 64 != 0 (no fallback)."""
    g = torch.Generator().manual_seed(15)
    x = torch.rand(2, 8, 8, 72, generator=g).to(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        tbf.basic_block(x, *_basic(g, 72, dev))


@pytest.mark.parametrize("block", ["basic", "projection", "identity", "recompute", "chain", "pointwise",
                                   "identity_forward", "projection_forward", "chain_forward"])
def test_block_backward_weight_gradients_are_deterministic(dev, block):
    """Two calls of the redesigned backwards (and of the identity,
    projection and chain forwards) on the same inputs give the same bits:
    the weight gradients' split partials are added in a fixed order, with
    no atomics (shapes whose reductions split)."""
    g = torch.Generator().manual_seed(12)
    if block == "projection_forward":
        x = torch.rand(4, 32, 32, 512, generator=g).to(dev, torch.bfloat16)
        ws = _proj(g, 512, 256, 1024, dev)
        first, second = tp.projection_block_save(x, *ws, 2), tp.projection_block_save(x, *ws, 2)
    elif block == "chain_forward":
        x = torch.rand(4, 32, 32, 64, generator=g).to(dev, torch.bfloat16)
        proj, ids = _proj(g, 64, 64, 256, dev), [_id(g, 256, 64, dev) for _ in range(2)]
        first, second = (_chain_flat_fwd(tst.fused_stage_save(x, proj, ids, 1)) for _ in range(2))
    elif block == "pointwise":
        from argus_tpu_torch.ops.kernels import pointwise as tpw

        x = torch.randn(8192, 256, generator=g).to(dev, torch.bfloat16)
        w, b = _w(g, 256, 64, dev=dev), _b(g, 64, dev)
        out = tpw.pointwise_fwd(x, w, b)
        args = (_grad(g, out.shape, dev), out, x, w, True, True)
        first, second = tpw.pointwise_bwd(*args), tpw.pointwise_bwd(*args)
    elif block == "identity_forward":
        x = torch.rand(4, 16, 16, 1024, generator=g).to(dev, torch.bfloat16)
        ws = _id(g, 1024, 256, dev)
        first, second = tb.bottleneck_block_save(x, *ws), tb.bottleneck_block_save(x, *ws)
    elif block == "chain":
        args = _chain_args(g, 4, 32, 32, 1, 2, True, dev)
        first, second = _chain_flat(tst.stage_bwd(*args)), _chain_flat(tst.stage_bwd(*args))
    elif block == "basic":
        x = torch.rand(4, 32, 32, 128, generator=g).to(dev, torch.bfloat16)
        ws = _basic(g, 128, dev)
        out, h1 = tbf.basic_block_save(x, *ws)
        args = (x, _grad(g, out.shape, dev), out, h1, ws[0], ws[2])
        first, second = tbf.basic_bwd(*args), tbf.basic_bwd(*args)
    elif block == "projection":
        x = torch.rand(4, 32, 32, 64, generator=g).to(dev, torch.bfloat16)
        ws = _proj(g, 64, 32, 128, dev)
        out, h1, h2 = tp.projection_block_save(x, *ws, 2)
        args = (x, _grad(g, out.shape, dev), out, h1, h2, ws[0], ws[2], ws[4], ws[6], 2)
        first, second = tp.proj_bwd(*args), tp.proj_bwd(*args)
    else:
        x = torch.rand(4, 32, 32, 256, generator=g).to(dev, torch.bfloat16)
        ws = _id(g, 256, 64, dev)
        out, h1, h2 = tb.bottleneck_block_save(x, *ws)
        if block == "identity":
            args = (x, _grad(g, out.shape, dev), out, h1, h2, ws[0], ws[2], ws[4])
            first, second = tb.block_bwd(*args), tb.block_bwd(*args)
        else:
            args = (x, _grad(g, out.shape, dev), out, *ws)
            first = tb.block_bwd_recompute(*args, recomputed=True)
            second = tb.block_bwd_recompute(*args, recomputed=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_keypoint_train_step_on_card_matches_cpu(dev):
    """A keypoint train step (resnet18, bf16, frozen BN and stem,
    fuse_block/fuse_stem on) on the card and on the CPU from the same state:
    losses within bf16 tolerance; launches 1 stem / 5 saving forwards / 5
    backwards of the BasicBlock kernel, and the eval forward 1 stem / 5
    no-save forwards."""
    from argus_tpu_torch.models import CubeKeypointNetConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    kcfg = CubeKeypointNetConfig(head_features=32, bn_frozen=True, bn_frozen_affine=True, stem_frozen=True,
                                 fuse_block="on", fuse_stem="on")
    cfg = TrainConfig(model_type="keypoint", keypoint_config=kcfg, amp=True, use_augmentation=False,
                      learning_rate=1e-3)
    rng = np.random.default_rng(2)
    batch = {
        "images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
        "cube_pose": np.tile(np.array([0.01, 0, 0.05, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
        "mask": np.ones(2, np.float32),
    }
    losses = {}
    for d in ("cpu", "cuda"):
        model, state = create_train_state(cfg, seed=0, device=d)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("BatchNorm_1.weight"):
                    p.fill_(0.3)
        kernels.reset_launch_counts()
        state, loss = make_train_step(model, cfg, hw=(64, 64), device=d)(state, batch)
        losses[d] = float(loss)
        counts = kernels.launch_counts()
    want = {name: 0 for name in kernels.KERNELS}
    assert counts == {**want, "stem_fused": 1, "basic_fused_save": 5, "basic_fused_bwd": 5}, counts
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"]) + 1e-3, losses
    kernels.reset_launch_counts()
    with torch.no_grad():
        uv, _ = model(torch.rand(2, 64, 64, 6, device="cuda"))
    assert torch.isfinite(uv).all()
    assert kernels.launch_counts() == {**want, "stem_fused": 1, "basic_fused": 5}


# ragged shapes: tiles and image edges that do not fall on the 32-pixel grid
AUG_SHAPES = [(3, 40, 72), (2, 256, 256), (2, 17, 33)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,h,w", AUG_SHAPES)
def test_blur_kernel(dev, dtype, n, h, w):
    g = torch.Generator().manual_seed(9)
    x = torch.rand(n, 3, h, w, generator=g).to(dev, dtype)
    gw, _ = TA._gaussian_taps(TA.generator(1, "cpu"), n)
    mk, _ = TA._motion_kernel(TA.generator(2, "cpu"), n)
    gates = torch.tensor([[1, 1], [0, 1], [1, 0]][:n], dtype=torch.bool)
    args = (x, gw.to(dev), mk.to(dev), gates.to(dev))
    before = tbl.KERNEL.launches
    got = tbl.fused_random_blur(*args)
    assert tbl.KERNEL.launches == before + 1
    assert torch.equal(got, tbl.fused_random_blur_plain(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,h,w", AUG_SHAPES)
def test_augment_fused_kernel(dev, dtype, n, h, w):
    x = torch.rand(n, 3, h, w, generator=torch.Generator().manual_seed(10)).to(dev, dtype)
    p = TA.sample_params(TA.AugmentationConfig(), 3, n, 1, h, w, dev, dtype)
    for n_arcs, order in ((10, [3, 0, 1, 2]), (0, [2, 1, 3, 0]), (10, [0, 2, 1, 3])):
        q = p if n_arcs else TA.AugmentParams(**{**vars(p), "arcs": None})
        field, mh, mwt, packed, _ = TA.pack_fused(q, n, h, w, n_arcs, dev)
        order = torch.tensor([order], dtype=torch.int32, device=dev)
        args = (x, field, mh, mwt, packed, order, n_arcs)
        got, want = taf.fused_augment(*args), taf.fused_augment_plain(*args)
        assert got.shape == want.shape and got.dtype == want.dtype
        err = (got.float() - want.float()).abs()
        tol = 1.6e-2 if dtype == torch.bfloat16 else 1e-5
        assert err.max() <= tol and err.mean() <= 1e-3, (n_arcs, err.max().item(), err.mean().item())


def test_augmented_train_step_launches_the_fused_kernel(dev):
    """use_augmentation=True on the card: one augment_fused launch per step,
    no blur launch, and no kernel's count disturbed otherwise."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    mcfg = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True)
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=True, learning_rate=1e-3)
    rng = np.random.default_rng(1)
    batch = {
        "images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
        "cube_pose": np.tile(np.array([0.1, 0, 0.2, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
        "mask": np.ones(2, np.float32),
    }
    model, state = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(model, cfg, device="cuda")
    for i in range(2):
        kernels.reset_launch_counts()
        state, loss = step(state, batch)
        counts = kernels.launch_counts()
        assert counts["augment_fused"] == 1 and counts["blur"] == 0 and counts["stem_fused"] == 1, counts
        assert torch.isfinite(loss)
    assert state.step == 2 and int(state.opt_state.count) == 2


# the stem: a batch whose image edges do not fall on the kernels' tiles
@pytest.mark.parametrize("n,h,w", [(3, 36, 44), (2, 64, 64)])
def test_stem_save_and_weight_gradient_kernels(dev, n, h, w):
    g = torch.Generator().manual_seed(11)
    x = torch.rand(n, h, w, 3, generator=g).to(dev, torch.bfloat16)
    w7 = (0.2 * torch.randn(7, 7, 3, 64, generator=g)).to(dev, torch.bfloat16)
    b = _b(g, 64, dev)
    before = (ts.KERNEL_SAVE.launches, ts.KERNEL_BWD.launches)
    out, y = ts.stem_fwd_save(x, w7, b)
    pout, py = ts.stem_fwd_save_plain(x, w7, b)
    for got, want in ((out, pout), (y, py)):  # within one bf16 ulp, or of f32 rounding of zero
        assert got.shape == want.shape and got.dtype == want.dtype
        a, r = got.float(), want.float()
        assert ((a - r).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), r.abs()) + 1e-5 * r.abs().max()).all()
    assert torch.equal(ts.stem_fwd(x, w7, b), out)
    gr = _grad(g, out.shape, dev)
    for n_images in (n, 1):
        _close(ts.stem_bwd(x, gr, out, y, n_images), ts.stem_bwd_plain(x, gr, out, y, n_images))
    assert (ts.KERNEL_SAVE.launches, ts.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,c", [(1000, 64), (4 * 17 * 13, 256), (8192, 2048), (8192, 4096)])
@pytest.mark.parametrize("stride", [1, 4])
def test_bn_reduce_kernels(dev, m, c, stride, dtype):
    """Ragged row counts (no power of two), stride 1 and argus_tpu's row
    blocks at stride 4: n_rows equal, sums within 1e-4 of each channel's sum
    of magnitudes."""
    if stride > 1 and m % tbn._fold_factor(c):
        pytest.skip("argus_tpu's strided reduction needs M % f == 0")
    g = torch.Generator().manual_seed(12)
    x = (torch.randn(m, c, generator=g) * 2 + 0.5).to(dev, dtype)
    dy = torch.randn(m, c, generator=g).to(dev, dtype)
    mean = torch.randn(c, generator=g).to(dev)
    rstd = (0.5 + torch.rand(c, generator=g)).to(dev)
    before = (tbn.KERNEL_STATS.launches, tbn.KERNEL_BWD.launches)
    got = tbn.fused_stats(x, stride) + tbn.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)
    want = tbn.fused_stats_plain(x, stride) + tbn.fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride)
    assert (tbn.KERNEL_STATS.launches, tbn.KERNEL_BWD.launches) == (before[0] + 1, before[1] + 1)
    assert got[2] == want[2] == got[5] == want[5]
    R, S, n = tbn.visited_rows(m, c, stride)
    rows = lambda t: torch.cat([t[i * S: i * S + R] for i in range(n // R)]).float().abs()  # noqa: E731
    xa, da = rows(x), rows(dy)
    scales = (xa.sum(0), (xa * xa).sum(0), da.sum(0), (da * (xa + mean.abs()) * rstd).sum(0))
    for a, b, sc in zip(got[:2] + got[3:5], want[:2] + want[3:5], scales):
        assert ((a - b).abs() <= 1e-4 * sc + 1e-6).all()
    again = tbn.fused_stats(x, stride) + tbn.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)
    for a, b in zip(got[:2] + got[3:5], again[:2] + again[3:5]):  # the same bits from call to call
        assert torch.equal(a, b)


@pytest.mark.parametrize("m,c,stride", [(512 * 16 * 16, 1024, 1), (512 * 32 * 32, 128, 4), (1000, 64, 1)])
def test_bn_reduce_kernels_are_one_launch(dev, m, c, stride):
    """Each reduction is one device kernel a call (the last block adds the
    partials), and a call after it finds the ticket reset."""
    x = torch.randn(m, c, device=dev).to(torch.bfloat16)
    dy = torch.randn(m, c, device=dev).to(torch.bfloat16)
    mean, rstd = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    tbn.fused_stats(x, stride)
    torch.cuda.synchronize()
    for fn in (lambda: tbn.fused_stats(x, stride), lambda: tbn.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)):
        kernels = _device_kernels(fn)
        assert len(kernels) == 1 and kernels[0][1] == 1 and "stream_kernel" in kernels[0][0], kernels
        assert all(torch.equal(a, b) for a, b in zip(fn()[:2], fn()[:2]))


def test_bn_reduce_kernels_on_two_streams_at_once(dev):
    """Reductions launched on two streams at once each draw the last-block
    ticket of their own stream: every result is the same bits as the same
    call alone, which is within 1e-4 of each channel's sum of magnitudes of
    the plain sums."""
    g = torch.Generator().manual_seed(13)
    m, c = 512 * 32 * 32, 256
    xs = [torch.randn(m, c, generator=g).to(dev, torch.bfloat16) for _ in range(2)]
    dys = [torch.randn(m, c, generator=g).to(dev, torch.bfloat16) for _ in range(2)]
    mean, rstd = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    calls = [(lambda i=i: tbn.fused_stats(xs[i])[:2]) for i in range(2)] + \
        [(lambda i=i: tbn.fused_bn_bwd_reduce(xs[i], dys[i], mean, rstd)[:2]) for i in range(2)]
    alone = [fn() for fn in calls]
    want = [tbn.fused_stats_plain(x)[:2] for x in xs] + \
        [tbn.fused_bn_bwd_reduce_plain(x, dy, mean, rstd)[:2] for x, dy in zip(xs, dys)]
    xa, da = [x.float().abs() for x in xs], [dy.float().abs() for dy in dys]
    scales = [(a.sum(0), (a * a).sum(0)) for a in xa] + [(d.sum(0), (d * a).sum(0)) for a, d in zip(xa, da)]
    for got, w, sc in zip(alone, want, scales):
        for q in range(2):
            assert ((got[q] - w[q]).abs() <= 1e-4 * sc[q] + 1e-6).all()
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[] for _ in calls]
    for _ in range(20):
        for k, fn in enumerate(calls):  # stream k % 2: the two streams' launches overlap
            with torch.cuda.stream(streams[k % 2]):
                got[k].append(fn())
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(alone):
        for ga, gb in got[k]:
            assert torch.equal(ga, a) and torch.equal(gb, b), k


@pytest.mark.parametrize("model", ["stem", "exact"])
def test_trained_stem_and_exact_bn_steps_on_card_match_cpu(dev, model):
    """A ResNet-50 train step (bf16) with the fused stem trained, or with
    exact BN (`bn_impl="auto"`: the reduction kernels on the card, the plain
    "xla" engine on the CPU), on the card and on the CPU from the same
    state: losses within bf16 tolerance, the running statistics' change
    close, and the launch counts."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    fuse_on = dict(fuse_block="on", fuse_proj="on", fuse_stem="on", fuse_stage="on")
    kw = (dict(bn_frozen=True, bn_frozen_affine=True, stem_frozen=False, stem_grad_stride=2, **fuse_on)
          if model == "stem" else dict(bn_impl="auto"))
    mcfg = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=32, **kw)
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=False, learning_rate=1e-3)
    rng = np.random.default_rng(3)
    batch = {
        "images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
        "cube_pose": np.tile(np.array([0.1, 0, 0.2, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
        "mask": np.ones(2, np.float32),
    }
    losses, moved = {}, {}
    for d in ("cpu", "cuda"):
        m, state = create_train_state(cfg, seed=0, device=d)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("BatchNorm_2.weight"):
                    p.fill_(0.2)
        before = {k: v.clone() for k, v in state.batch_stats.items()}
        kernels.reset_launch_counts()
        state, loss = make_train_step(m, cfg, device=d)(state, batch)
        losses[d] = float(loss)
        moved[d] = torch.cat([(state.batch_stats[k] - before[k]).flatten().cpu() for k in sorted(before)])
        counts = kernels.launch_counts()
    want = {name: 0 for name in kernels.KERNELS}
    if model == "stem":
        want.update(stem_fused_save=1, stem_fused_bwd=1, stage_fused_save=1, stage_fused_bwd=1,
                    proj_fused_save=3, proj_fused_bwd=3, block_fused_save=10, block_fused_bwd=10)
        assert torch.count_nonzero(moved["cuda"]) == 0
    else:
        want.update(bn_stats=53, bn_bwd_reduce=53)
        assert (moved["cuda"] - moved["cpu"]).norm() <= 3e-2 * moved["cpu"].norm()
    assert counts == want, counts
    assert abs(losses["cuda"] - losses["cpu"]) <= 2e-2 * abs(losses["cpu"]) + 1e-3, losses


@pytest.mark.parametrize("n,h,w", [(3, 40, 72), (2, 256, 256)])
def test_packed_stem_kernel(dev, n, h, w):
    """The packed-output stem launches the stem kernel (counted apart) and
    returns the pair-packed view of its NHWC output."""
    g = torch.Generator().manual_seed(13)
    x = torch.rand(n, h, w, 3, generator=g).to(dev, torch.bfloat16)
    w7 = (0.2 * torch.randn(7, 7, 3, 64, generator=g)).to(dev, torch.bfloat16)
    b = _b(g, 64, dev)
    before = (ts.KERNEL.launches, ts.KERNEL_PACKED.launches)
    got = ts.stem_pool(x, w7, b, packed_out=True)
    assert got.shape == (n, h // 4, w // 8, 128) and got.is_contiguous()
    assert (ts.KERNEL.launches, ts.KERNEL_PACKED.launches) == (before[0], before[1] + 1)
    assert torch.equal(got.reshape(n, h // 4, w // 4, 64), ts.stem_fwd(x, w7, b))
    want = ts.stem_pool_packed_plain(x, w7, b)
    a, r = got.float(), want.float()  # within one bf16 ulp, or of f32 rounding of zero
    assert ((a - r).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), r.abs()) + 1e-5 * r.abs().max()).all()


@pytest.mark.parametrize("n_id", [3, 5])
def test_frozen_stage_chain_kernel(dev, n_id):
    """The whole-stage no-save chain of a frozen stage (stride 2, a
    projection and n_id identity blocks), counted as `stage_fused_frozen`,
    and the packed stage-0 input read as NHWC."""
    g = torch.Generator().manual_seed(14)
    x = torch.rand(2, 12, 10, 128, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, 128, 64, 256, dev)
    ids = [_id(g, 256, 64, dev) for _ in range(n_id)]
    before = (tst.KERNEL.launches, tst.KERNEL_FROZEN.launches)
    _close(tst.stage_chain(x, proj, ids, 2), tst.stage_plain(x, proj, ids, 2))
    assert (tst.KERNEL.launches, tst.KERNEL_FROZEN.launches) == (before[0], before[1] + 1)
    x0 = torch.rand(2, 8, 8, 64, generator=g).to(dev, torch.bfloat16)
    p0 = _proj(g, 64, 64, 256, dev)
    id0 = [_id(g, 256, 64, dev) for _ in range(2)]
    packed = tst.stage_chain(x0.view(2, 8, 4, 128), p0, id0, 1, x_packed=True)
    assert torch.equal(packed, tst.fused_stage(x0, p0, id0, 1))
    assert tst.KERNEL.launches == before[0] + 2


def test_feed_on_card_yields_the_cpu_batches(dev):
    from argus_tpu_torch.data.feed import device_prefetch

    rng = np.random.default_rng(5)
    batches = [{"images": rng.integers(0, 256, (4, 16, 16, 6), dtype=np.uint8),
                "cube_pose": rng.normal(size=(4, 7)).astype(np.float32),
                "mask": np.ones(4, np.float32)} for _ in range(5)]
    got = list(device_prefetch(batches, dev))
    want = list(device_prefetch(batches, "cpu"))
    assert len(got) == len(want) == 5
    for g_, w_ in zip(got, want):
        for k in w_:
            assert g_[k].is_cuda and torch.equal(g_[k].cpu(), w_[k])


@pytest.mark.parametrize("frozen_stages", [0, 3])
def test_auto_launches_what_the_table_names(dev, frozen_stages):
    """Every fuse flag "auto": a train step and an eval forward launch the
    kernels `AUTO_FUSE` names for each function and mode, and nothing else."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.models.resnet import AUTO_FUSE
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    mcfg = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True, frozen_stages=frozen_stages)
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=False, learning_rate=1e-3)
    model, state = create_train_state(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
             "cube_pose": np.tile(np.array([0.1, 0, 0.2, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
             "mask": np.ones(2, np.float32)}

    table = {(f, m): v for (f, m, d), v in AUTO_FUSE.items() if d == "bfloat16"}  # amp: the model runs in bf16

    def expect(mode_of):
        want = {name: 0 for name in kernels.KERNELS}
        packed = frozen_stages >= 1 and table[("stem", "forward")] and table[("stage_chain_packed", "forward")]
        if table[("stem", "forward")]:
            want["stem_fused_packed" if packed else "stem_fused"] += 1
        for i, n in enumerate((3, 4, 6, 3)):
            m = mode_of(i)
            if i == 0 or i < frozen_stages:
                chain = "stage_chain_packed" if i == 0 and m == "forward" else "stage_chain"
                if table[(chain, m)]:
                    key = ("stage_fused" if i == 0 else "stage_fused_frozen") if m == "forward" else "stage_fused_save"
                    want[key] += 1
                    want["stage_fused_bwd"] += m == "train"
                    continue
            for name, count, fn in (("proj_fused", 1, "projection"), ("block_fused", n - 1, "identity")):
                if table[(fn, m)]:
                    if m == "forward":
                        want[name] += count
                    else:
                        want[name + "_save"] += count
                        want[name + "_bwd"] += count
        return want

    kernels.reset_launch_counts()
    state, loss = make_train_step(model, cfg, device="cuda")(state, batch)
    assert torch.isfinite(loss)
    assert kernels.launch_counts() == expect(lambda i: "forward" if i < frozen_stages else "train")
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(torch.rand(2, 64, 64, 6, device="cuda"))
    assert kernels.launch_counts() == expect(lambda i: "forward")


@pytest.mark.parametrize("m,cin,cout", [(2 * 9 * 7, 64, 64), (4608, 256, 64), (1000, 64, 256), (49, 512, 2048),
                                         (513 * 7 * 7, 256, 64), (49, 72, 136)])
@pytest.mark.parametrize("residual", [False, True])
def test_pointwise_kernels(dev, m, cin, cout, residual):
    """The pointwise forward and backward (m emitted with a residual) against
    their plain versions; any M (4608 rows: dw splits and sums partials)."""
    from argus_tpu_torch.ops.kernels import pointwise as tpw

    g = torch.Generator().manual_seed(8)
    x = torch.randn(m, cin, generator=g).to(dev, torch.bfloat16)
    w, b = _w(g, cin, cout, dev=dev), _b(g, cout, dev)
    res = torch.randn(m, cout, generator=g).to(dev, torch.bfloat16) if residual else None
    before = (tpw.KERNEL.launches, tpw.KERNEL_BWD.launches)
    out = tpw.pointwise_fwd(x, w, b, res)
    _close(out, tpw.pointwise_fwd_plain(x, w, b, res))
    for relu in (True, False):
        _close(tpw.pointwise_fwd(x, w, b, res, relu), tpw.pointwise_fwd_plain(x, w, b, res, relu))
    gr = _grad(g, out.shape, dev)
    _all_close(tpw.pointwise_bwd(gr, out, x, w, True, residual), tpw.pointwise_bwd_plain(gr, out, x, w, True, residual))
    got = tpw.pointwise_bwd(gr, out, x, w, False, residual, need_dx=False)
    assert got[0] is None
    _all_close(got, tpw.pointwise_bwd_plain(gr, out, x, w, False, residual, need_dx=False))
    assert (tpw.KERNEL.launches, tpw.KERNEL_BWD.launches) == (before[0] + 3, before[1] + 2)


@pytest.mark.parametrize("cin,cout,residual", [(64, 64, False), (64, 256, True)])
def test_pointwise_forward_at_two_million_rows(dev, cin, cout, residual):
    """The pointwise forward on the TMA engine over M = 2,097,152 rows
    (configuration P's largest: 16384 image groups of 128 rows, up to 32768
    tiles), relu on and off, one device kernel a call, against the plain
    version."""
    from argus_tpu_torch.ops.kernels import pointwise as tpw

    g = torch.Generator().manual_seed(18)
    m = 512 * 64 * 64
    x = torch.randn(m, cin, generator=g).to(dev, torch.bfloat16)
    w, b = _w(g, cin, cout, dev=dev), _b(g, cout, dev)
    res = torch.randn(m, cout, generator=g).to(dev, torch.bfloat16) if residual else None
    for relu in (True, False):
        _close(tpw.pointwise_fwd(x, w, b, res, relu), tpw.pointwise_fwd_plain(x, w, b, res, relu))
    before, calls = tpw.KERNEL.launches, []
    kernels = _device_kernels(lambda: (calls.append(1), tpw.pointwise_fwd(x, w, b, res)), 3)
    assert len(calls) in (3, 6, 9) and tpw.KERNEL.launches == before + len(calls)  # a window read again re-runs fn
    assert len(kernels) == 1 and "conv_fwd_tma_sm90_kernel" in kernels[0][0] and 1 <= kernels[0][1] <= 3, kernels


def test_pointwise_backward_at_two_million_rows(dev):
    """The pointwise backward over M = 2,097,152 rows (configuration P's
    largest, 512 images of 64 x 64) at CIN = COUT = 64, with and without
    emitting m, against the plain version."""
    from argus_tpu_torch.ops.kernels import pointwise as tpw

    g = torch.Generator().manual_seed(17)
    m = 512 * 64 * 64
    x = torch.randn(m, 64, generator=g).to(dev, torch.bfloat16)
    w, b = _w(g, 64, 64, dev=dev), _b(g, 64, dev)
    out = tpw.pointwise_fwd(x, w, b)
    gr = _grad(g, out.shape, dev)
    for emit in (False, True):
        got = tpw.pointwise_bwd(gr, out, x, w, True, emit)
        assert (got[2] is None) == (not emit)
        _all_close(got, tpw.pointwise_bwd_plain(gr, out, x, w, True, emit))


@pytest.mark.parametrize("n,h,w,cin,f", IDENTITY_CASES)
def test_recompute_backward_kernel(dev, n, h, w, cin, f):
    """B7 against its plain version, with and without dx: the recomputed
    h1/h2 against the plain recompute, the gradients against the plain
    backward from the kernel's h1/h2 (a sum within rounding of zero may take
    a relu mask the other way in the two recomputes)."""
    g = torch.Generator().manual_seed(9)
    x = torch.rand(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
    ws = _id(g, cin, f, dev)
    out = tb.bottleneck_block(x, *ws)
    args = (x, _grad(g, out.shape, dev), out, *ws)
    before = tb.KERNEL_RBWD.launches
    *grads, h1, h2 = tb.block_bwd_recompute(*args, recomputed=True)
    _all_close((h1, h2), tb.bottleneck_block_save_plain(x, *ws)[1:])
    want = tb.block_bwd_plain(*args[:3], h1, h2, ws[0], ws[2], ws[4])
    _all_close(grads, want)
    got = tb.block_bwd_recompute(*args, need_dx=False)
    assert got[0] is None and tb.KERNEL_RBWD.launches == before + 2
    _all_close(got[1:], want[1:])


@pytest.mark.parametrize("config", ["P", "R"])
def test_pointwise_and_remat_steps_launch_their_kernels(dev, config):
    """A train step of configuration P (`fuse_pointwise="on"`, the block
    flags off) and of R (remat, the fuse flags on) launches what the
    configuration names, and its loss and gradients match the same step on
    the CPU (plain versions), bf16, within the fused steps' gates."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, _loss_and_grads_on, create_train_state, make_train_step

    fuse = dict(fuse_block="on", fuse_proj="on", fuse_stem="on", fuse_stage="on")
    extra = (dict(fuse, fuse_pointwise="on", fuse_block="off", fuse_proj="off", fuse_stage="off") if config == "P"
             else dict(fuse, remat=True))
    mcfg = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True, dtype="bfloat16", **extra)
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=False, learning_rate=1e-3)
    model, state = create_train_state(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(6)
    batch = {"images": rng.integers(0, 256, (2, 64, 64, 6), dtype=np.uint8),
             "cube_pose": np.tile(np.array([0.1, 0, 0.2, 0, 0, 0.6, 0.8], np.float32), (2, 1)),
             "mask": np.ones(2, np.float32)}
    want = {name: 0 for name in kernels.KERNELS}
    if config == "P":
        want.update(stem_fused=1, pointwise=32, pointwise_bwd=32)
    else:
        want.update(stem_fused=1, stage_fused_save=1, stage_fused_bwd=1, proj_fused=3, proj_fused_save=3,
                    proj_fused_bwd=3, block_fused=10, block_fused_rbwd=10)
    images = torch.from_numpy(batch["images"]).to(dev).float() / 255
    head = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    loss_g, grads_g = _loss_and_grads_on(model, state.params, images, head)
    cpu, cpu_state = create_train_state(cfg, seed=0, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_c, grads_c = _loss_and_grads_on(cpu, cpu_state.params, images.cpu(), {k: v.cpu() for k, v in head.items()})
    assert abs(loss_g.item() - loss_c.item()) <= 1e-2 * abs(loss_c.item())
    errs = sorted(((grads_g[k].cpu().float() - v.float()).norm() / v.float().norm()).item()
                  for k, v in grads_c.items() if v.norm() > 0)
    assert errs[-1] <= 0.1 and errs[len(errs) // 2] <= 0.05, errs[-5:]
    kernels.reset_launch_counts()
    state, loss = make_train_step(model, cfg, device="cuda")(state, batch)
    assert torch.isfinite(loss)
    assert kernels.launch_counts() == want


# ─────────────── the f32 kernels (TF32 products, f32 sums) ───────────────
#
# Against the f32 plain versions with TF32 off (the `dev` fixture), within
# chip_smoke.py's fixed f32 gate: 2.5e-3 * max |plain| + 1.25e-3 (the bf16
# gate scaled by TF32's 8x finer rounding), at ragged spatial sizes.


def _f32_close(got, want):
    got = [t for t in got if t is not None] if isinstance(got, (tuple, list)) else [got]
    want = [t for t in want if t is not None] if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        err = (a - b).abs().max().item()
        assert err <= 2.5e-3 * b.abs().max().item() + 1.25e-3, err


def _f32(ws):
    return tuple(t.float() for t in ws)


def test_f32_stem_kernel(dev):
    g = torch.Generator().manual_seed(30)
    x = torch.rand(3, 72, 40, 3, generator=g).to(dev)
    w, b = (0.2 * torch.randn(7, 7, 3, 64, generator=g)).to(dev), _b(g, 64, dev)
    before = ts.KERNEL_F32.launches
    _f32_close(ts.stem_pool(x, w, b), ts.stem_pool_plain(x, w, b))
    assert ts.KERNEL_F32.launches == before + 1
    for fn in (lambda: ts.stem_fwd_packed(x, w, b), lambda: ts.stem_fwd_save(x, w, b)):
        with pytest.raises(NotImplementedError, match="A14"):
            fn()


@pytest.mark.parametrize("cin,f", [(64, 16), (256, 64)])
def test_f32_identity_block_kernels(dev, cin, f):
    g = torch.Generator().manual_seed(31)
    x = torch.rand(2, 9, 7, cin, generator=g).to(dev)
    ws = _f32(_id(g, cin, f, dev))
    counts = [k.launches for k in (tb.KERNEL_F32, tb.KERNEL_SAVE_F32, tb.KERNEL_BWD_F32)]
    _f32_close(tb.bottleneck_block(x, *ws), tb.bottleneck_block_plain(x, *ws))
    saved = tb.bottleneck_block_save(x, *ws)
    _f32_close(saved, tb.bottleneck_block_save_plain(x, *ws))
    args = (x, torch.randn(x.shape, generator=g).to(dev), *saved, ws[0], ws[2], ws[4])
    _f32_close(tb.block_bwd(*args), tb.block_bwd_plain(*args))
    _f32_close(tb.block_bwd(*args, need_dx=False), tb.block_bwd_plain(*args, need_dx=False))
    assert [k.launches for k in (tb.KERNEL_F32, tb.KERNEL_SAVE_F32, tb.KERNEL_BWD_F32)] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 2]
    with pytest.raises(NotImplementedError, match="A14"):  # the recompute backward
        tb.block_bwd_recompute(x, args[1], saved[0], *ws)


@pytest.mark.parametrize("stride", [1, 2])
def test_f32_projection_block_kernels(dev, stride):
    g = torch.Generator().manual_seed(32 + stride)
    x = torch.rand(2, 10, 6, 64, generator=g).to(dev)
    ws = _f32(_proj(g, 64, 32, 128, dev))
    before = tp.KERNEL_BWD_F32.launches
    _f32_close(tp.projection_block(x, *ws, stride), tp.projection_block_plain(x, *ws, stride))
    saved = tp.projection_block_save(x, *ws, stride)
    _f32_close(saved, tp.projection_block_save_plain(x, *ws, stride))
    args = (x, torch.randn(saved[0].shape, generator=g).to(dev), *saved, ws[0], ws[2], ws[4], ws[6], stride)
    _f32_close(tp.proj_bwd(*args), tp.proj_bwd_plain(*args))
    assert tp.KERNEL_BWD_F32.launches == before + 1


def test_f32_stage0_chain_kernels(dev):
    """The stage-0 chain (a projection and two identity blocks, F = 64): the
    no-save forward, the saving forward and the backward; the whole-stage
    no-save chain of a frozen stage has no f32 kernel."""
    g = torch.Generator().manual_seed(34)
    x = torch.rand(2, 10, 6, 64, generator=g).to(dev)
    proj, ids = _f32(_proj(g, 64, 64, 256, dev)), [_f32(_id(g, 256, 64, dev)) for _ in range(2)]
    counts = [k.launches for k in (tst.KERNEL_F32, tst.KERNEL_SAVE_F32, tst.KERNEL_BWD_F32)]
    _f32_close(tst.fused_stage(x, proj, ids, 1), tst.stage_plain(x, proj, ids, 1))
    out, bnds, h1s, h2s = tst.fused_stage_save(x, proj, ids, 1)
    _f32_close(_chain_flat_fwd((out, bnds, h1s, h2s)), _chain_flat_fwd(tst.stage_save_plain(x, proj, ids, 1)))
    args = (x, torch.randn(out.shape, generator=g).to(dev), out, bnds, h1s, h2s, (proj[0], proj[2], proj[4], proj[6]),
            [(w[0], w[2], w[4]) for w in ids], 1)
    _f32_close(_chain_flat(tst.stage_bwd(*args)), _chain_flat(tst.stage_bwd_plain(*args)))
    assert [k.launches for k in (tst.KERNEL_F32, tst.KERNEL_SAVE_F32, tst.KERNEL_BWD_F32)] == [c + 1 for c in counts]
    x2 = torch.rand(2, 8, 8, 256, generator=g).to(dev)
    with pytest.raises(NotImplementedError, match="A14"):
        tst.fused_stage(x2, _f32(_proj(g, 256, 128, 512, dev)), [_f32(_id(g, 512, 128, dev))], 2)
