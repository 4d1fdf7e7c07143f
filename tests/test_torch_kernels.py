"""The port's four kernel functions (argus_tpu_torch.ops.kernels) against the
argus_tpu Pallas kernels they replace, run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests pin the arithmetic and the rounding points that the CUDA kernels are
then held to on the card (`chip_smoke.py`, tests/test_torch_cuda.py). Inputs
are made with numpy from a seed and fed to both packages. Every BN buffer is
perturbed, so a broken conv3 path cannot hide behind the identity.

Tolerances: f32 at rtol 2e-4 / atol 1e-4 (the same sums in another order:
the TPU kernels' tap-by-tap dots and packed layouts vs PyTorch's convs);
bf16 at 2e-2 (one bf16 ulp is 2^-8 relative, and the two sides may round a
value on either side of a tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import block_fused as jb
from argus_tpu.ops.pallas import proj_fused as jp
from argus_tpu.ops.pallas import stage_fused as jst
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu_torch.ops import kernels
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import proj_fused as tp
from argus_tpu_torch.ops.kernels import stage_fused as tst
from argus_tpu_torch.ops.kernels import stem_fused as ts

F32_TOL = dict(rtol=2e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bn(rng, c):
    """Perturbed frozen-BN buffers (scale, bias, mean, var)."""
    return [
        rng.uniform(0.5, 1.5, c).astype(np.float32),
        rng.normal(0, 0.1, c).astype(np.float32),
        rng.normal(0, 0.1, c).astype(np.float32),
        rng.uniform(0.5, 1.5, c).astype(np.float32),
    ]


def _kernel(rng, *shape):
    return (rng.normal(0, 1, shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)


def _conv_bn(rng, *shape):
    return [_kernel(rng, *shape), *_bn(rng, shape[-1])]


def _j(a, dt=jnp.float32):
    return jnp.asarray(a).astype(dt)


def _t(a, dt=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dt)


def _check(got: torch.Tensor, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _block_args(rng, cin, f, cout, projection):
    args = _conv_bn(rng, 1, 1, cin, f) + _conv_bn(rng, 3, 3, f, f) + _conv_bn(rng, 1, 1, f, cout)
    if projection:
        args += _conv_bn(rng, 1, 1, cin, cout)
    return args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    args = _conv_bn(rng, 7, 7, 3, 64)
    want = js.fused_stem_pool(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True)
    got = ts.fused_stem_pool(_t(x, tdt), *map(_t, args))
    assert got.dtype == tdt
    _check(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_block_matches_pallas(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    args = _block_args(rng, 64, 16, 64, projection=False)
    want = jb.fused_bottleneck_block(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True)
    got = tb.fused_bottleneck_block(_t(x, tdt), *map(_t, args))
    _check(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_matches_pallas(stride):
    rng = np.random.default_rng(2 + stride)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    args = _block_args(rng, 32, 16, 64, projection=True)
    want = jp.fused_projection_block(
        _j(x), *map(_j, args), stride=stride, impl="pallas", interpret=True
    )
    got = tp.fused_projection_block(_t(x), *map(_t, args), stride=stride)
    assert tuple(got.shape) == (2, 8 // stride, 8 // stride, 64)
    _check(got, want, F32_TOL)


def test_stage0_chain_matches_packed_pallas(monkeypatch):
    """Stage-0 geometry (cin = f = 64, cout = 256, stride 1): argus_tpu routes
    it through the pair-packed `_chain_fwd_packed`, the kernel the port's
    chain replaces."""
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 64))).astype(np.float32)
    proj_raw = _block_args(rng, 64, 64, 256, projection=True)
    ids_raw = [_block_args(rng, 256, 64, 256, projection=False) for _ in range(2)]
    jproj = jp.fold_projection_params(jnp.float32, *map(_j, proj_raw))
    jids = [jb.fold_bottleneck_params(jnp.float32, *map(_j, r)) for r in ids_raw]
    hits = []
    orig = jst._chain_fwd_packed
    monkeypatch.setattr(
        jst, "_chain_fwd_packed", lambda *a, **k: (hits.append(1), orig(*a, **k))[1]
    )
    want = jst.fused_stage(_j(x), jproj, jids, stride=1, impl="pallas", interpret=True)
    assert hits, "argus_tpu did not take the packed stage-0 chain"

    tproj = tp.fold_projection_params(torch.float32, *map(_t, proj_raw))
    tids = [tb.fold_bottleneck_params(torch.float32, *map(_t, r)) for r in ids_raw]
    for a, b in zip(jproj + tuple(w for ws in jids for w in ws), list(tproj) + [w for ws in tids for w in ws]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
    got = tst.fused_stage(_t(x), tproj, tids, stride=1)
    _check(got, want, F32_TOL)


def test_stride2_chain_matches_pallas():
    """A stride-2 stage entry with identity blocks (the stage 1-3 geometry)."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.normal(0, 1, (2, 8, 8, 32))).astype(np.float32)
    proj_raw = _block_args(rng, 32, 16, 64, projection=True)
    ids_raw = [_block_args(rng, 64, 16, 64, projection=False)]
    jproj = jp.fold_projection_params(jnp.float32, *map(_j, proj_raw))
    jids = [jb.fold_bottleneck_params(jnp.float32, *map(_j, r)) for r in ids_raw]
    want = jst.fused_stage(_j(x), jproj, jids, stride=2, impl="pallas", interpret=True)
    tproj = tp.fold_projection_params(torch.float32, *map(_t, proj_raw))
    tids = [tb.fold_bottleneck_params(torch.float32, *map(_t, r)) for r in ids_raw]
    _check(tst.fused_stage(_t(x), tproj, tids, stride=2), want, F32_TOL)


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run their plain versions: no kernel launch
    is counted, and none is built."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(6)
    x = _t(np.abs(rng.normal(0, 1, (1, 8, 8, 64))).astype(np.float32))
    tb.fused_bottleneck_block(x, *map(_t, _block_args(rng, 64, 16, 64, projection=False)))
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 8, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tb.bottleneck_block(x, *[None] * 6)
