"""remat in the port's training forward (ROADMAP A10) and the identity
block's recompute backward (argus_tpu's `_block_bwd_pallas`, B7).

- The recompute backward's plain version against argus_tpu's Pallas kernel
  in interpret mode, and against the saved-residual backward fed the saving
  forward's h1/h2 (the same formulas once h1/h2 are recomputed).
- remat against no remat in the port: resnet18 under exact BN (argus_tpu's
  `tests/test_model.py::test_remat_matches_no_remat`) with every BN engine
  and stride, and a bottleneck backbone with the fused kernels on; values,
  gradients and running statistics equal, no statistic computed twice.
- `remat_stages=(1,)`: only stage 1's blocks are re-run.
- The port's remat step against argus_tpu's `remat=True` step under exact
  BN (strides 1 and 2, running statistics included), and a fused bottleneck
  backbone under remat (B7's plain version, the projection's re-run saving
  forward) against argus_tpu's remat with its Pallas kernels in interpret
  mode.

Tolerances. The recompute backward (bf16 operands): dx within 2e-2 of the
largest value, each dw within 1e-2 relative (2-norm): both recompute h1/h2
and round them and m1/m2 to bf16 after f32 sums taken in another order;
against the port's saved-residual backward it is exact (the same ops). remat
against no remat in the port: equal, bit for bit (the recompute repeats the
forward's ops on the CPU and replays its statistics). Against argus_tpu:
the step tolerances of `tests/test_torch_train_bn.py` (exact BN, f32:
`TOL_EXACT`, statistics 1e-3) and the model tolerances of argus_tpu's
fused-model test (f32, 2e-3 / 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import block_fused as jb
from argus_tpu_torch.models import resnet as tresnet
from argus_tpu_torch.models.resnet import BasicBlock, BottleneckBlock, ResNet
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import bn_reduce

from test_torch_pointwise import argus_loss_grads, assert_grads, check_step, port_loss_grads, step_pair, tiny_models
from test_torch_train import _pallas_everywhere, _randomize_
from test_torch_train_bn import STATS_TOL, TOL_EXACT
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)


def _block_inputs(dtype, n=2, h=6, w=5, cin=32, f=8, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=1.0: (rng.normal(0, 1, s) * sc).astype(np.float32)  # noqa: E731
    x = np.maximum(mk(n, h, w, cin), 0)
    ws = (mk(cin, f, sc=cin**-0.5), mk(1, f, sc=0.1), mk(3, 3, f, f, sc=(9 * f) ** -0.5), mk(1, f, sc=0.1),
          mk(f, cin, sc=f**-0.5), mk(1, cin, sc=0.1))
    g = mk(n, h, w, cin)
    t = lambda a, d=dtype: torch.from_numpy(a).to(d)  # noqa: E731
    tw = [t(a) if i % 2 == 0 else t(a, torch.float32) for i, a in enumerate(ws)]
    out = tb.bottleneck_block_plain(t(x), *tw)
    return t(x), t(g), out, tw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_recompute_backward_matches_argus_tpu_and_the_saved_backward(dtype):
    x, g, out, (w1, b1, w2, b2, w3, b3) = _block_inputs(dtype)
    got = tb.block_bwd_recompute_plain(x, g, out, w1, b1, w2, b2, w3, b3)

    # the saved-residual backward fed the saving forward's h1/h2: the same ops
    _, h1, h2 = tb.bottleneck_block_save_plain(x, w1, b1, w2, b2, w3, b3)
    for a, b in zip(got, tb.block_bwd_plain(x, g, out, h1, h2, w1, w2, w3)):
        assert torch.equal(a, b)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = lambda t, d=jdt: jnp.asarray(t.float().numpy(), d)  # noqa: E731
    want = jb._block_bwd_pallas(j(x), j(g), j(out), j(w1), j(b1, jnp.float32), j(w2), j(b2, jnp.float32), j(w3),
                                j(b3, jnp.float32), interpret=True)
    dx, *dws = (np.asarray(t.astype(jnp.float32)) for t in want)
    err = np.abs(got[0].float().numpy() - dx).max()
    assert err <= 2e-2 * np.abs(dx).max(), err
    for a, b in zip(got[1:], dws):
        assert np.linalg.norm(a.numpy() - b) <= 1e-2 * np.linalg.norm(b)
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:])


def _run(model, x):
    """(output, gradients, buffers) of sum(y**2) in train mode."""
    model.zero_grad()
    y = model(x, train=True)
    (y.float() ** 2).sum().backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return y.detach(), grads, {k: b.clone() for k, b in model.named_buffers()}


def _twins(block_cls, stage_sizes, num_filters=8, **kw):
    """Two copies of one randomised backbone: without and with remat."""
    models = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = ResNet(stage_sizes=stage_sizes, block_cls=block_cls, output_dim=8, num_filters=num_filters, remat=remat,
                   **kw)
        _randomize_(m, seed=3)
        models.append(m)
    return models


def _assert_same(a, b):
    for u, v in zip(a, b):
        if isinstance(u, dict):
            assert u.keys() == v.keys()
            for k in u:
                assert torch.equal(u[k], v[k]), k
        else:
            assert torch.equal(u, v)


EXACT = {"xla": dict(), "xla-stride2": dict(bn_stats_stride=2, bn_grad_stride=2), "pallas": dict(bn_impl="pallas"),
         "pallas-stride2": dict(bn_impl="pallas", bn_stats_stride=2)}


@pytest.mark.parametrize("bn", list(EXACT))
def test_remat_matches_no_remat_under_exact_bn(monkeypatch, bn):
    """resnet18 under exact BN: the same loss, gradients and running
    statistics with and without remat, and every BatchNorm computes its
    statistics once (the reduction kernel's plain version called as often)."""
    calls = []
    stats = bn_reduce.fused_stats
    monkeypatch.setattr(bn_reduce, "fused_stats", lambda *a: calls.append(1) or stats(*a))
    # eight images: a strided reduction needs 8 rows at stage 3 (1x1)
    x = torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    runs = []
    for model in _twins(BasicBlock, (2, 2, 2, 2), num_filters=16, **EXACT[bn]):
        before = {k: b.clone() for k, b in model.named_buffers()}
        calls.clear()
        runs.append((_run(model, x), len(calls)))
    _assert_same(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] == (20 if "pallas" in bn else 0)  # the 20 BatchNorms, once each
    assert all(not torch.equal(v, before[k]) for k, v in runs[1][0][2].items())  # moved, once


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_matches_no_remat_with_fused_kernels(monkeypatch, dtype):
    """A bottleneck backbone, frozen BN and affine, every kernel on but the
    stage chain: the identity blocks take the recompute backward, the
    projections their re-run saving forward; the same values and
    gradients as the saved-residual step."""
    calls = []
    rbwd = tb.block_bwd_recompute
    monkeypatch.setattr(tb, "block_bwd_recompute", lambda *a: calls.append(1) or rbwd(*a))
    kw = dict(bn_frozen=True, bn_frozen_affine=True, fuse_block="on", fuse_proj="on", fuse_stem="on",
              fuse_stage="off", dtype=dtype)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    a, b = (_run(m, x) for m in _twins(BottleneckBlock, (2, 2), **kw))
    _assert_same(a, b)
    assert len(calls) == 2  # the identity block of each stage


def test_remat_stages_reruns_only_those_stages(monkeypatch):
    re_run = []
    recompute = tresnet._recompute
    monkeypatch.setattr(tresnet, "_recompute", lambda blk, fn, x: re_run.append(blk) or recompute(blk, fn, x))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    plain, staged = _twins(BasicBlock, (2, 2, 2, 2))
    staged.remat, staged.remat_stages = False, (1,)
    _assert_same(_run(plain, x), _run(staged, x))
    assert re_run == staged.blocks(1)
    re_run.clear()
    with torch.no_grad():  # no gradient, nothing to recompute
        staged(x, train=True)
    assert not re_run


@pytest.mark.parametrize("bn", ["xla", "pallas-stride2"])
def test_remat_step_matches_argus_tpu_under_exact_bn(bn):
    """One step of resnet18 NCameraCNN under exact BN with remat, the port's
    against argus_tpu's (its reductions in interpret mode), f32: loss,
    moments, update and running statistics."""
    model = dict(n_cams=2, backbone="resnet18", resnet_output_dim=32, remat=True, **EXACT[bn])
    want, got = step_pair(model, False, _pallas_everywhere, hw=64 if "stride2" in bn else 32)
    check_step(want, got, TOL_EXACT, STATS_TOL[False])


def test_fused_remat_matches_argus_tpu(monkeypatch):
    """A bottleneck backbone under remat with the block and projection kernels
    on (frozen BN and affine): the port's recompute backward (its plain
    version) and re-run projections against argus_tpu's `nn.remat` over its
    Pallas kernels in interpret mode, f32 outputs and gradients."""
    _pallas_everywhere(monkeypatch)
    kw = dict(bn_frozen=True, bn_frozen_affine=True, fuse_block="on", fuse_proj="on", fuse_stage="off", remat=True)
    port, jmodel, tree = tiny_models(stage_sizes=(2, 2), **kw)
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    y_ref, g_ref, _ = argus_loss_grads(jmodel, tree, jnp.asarray(x))
    y, g = port_loss_grads(port, x)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    assert_grads(g, g_ref)
