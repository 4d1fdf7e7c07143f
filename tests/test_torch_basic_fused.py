"""The port's BasicBlock kernel functions (argus_tpu_torch.ops.kernels.
basic_fused) against argus_tpu's Pallas BasicBlock kernels in interpret mode
on the CPU: the BN fold, the forward with and without h1 saved, the one-pass
backward, and autograd through fold and block.

On a CPU tensor each port wrapper runs its plain PyTorch version, so these
tests pin the arithmetic and rounding points the CUDA kernels are then held
to on the card (`chip_smoke.py`, tests/test_torch_cuda.py). Inputs come from
numpy with a seed; every BN buffer is perturbed and the cotangent is random,
so neither conv can hide behind the identity or a zero gradient. The
argus_tpu side runs `_basic_block(..., "pallas", True, g)`: the Pallas
kernels in interpret mode, with g = 1 and g = 3 images per grid step (the
backward carries its dw across the grid steps).

Tolerances: f32 at rtol 2e-4 / atol 2e-5 (argus_tpu's own
tests/test_basic_fused.py: the same f32 sums in another order, the TPU
kernel's nine shifted dots against PyTorch's convs); bf16 by the relative
2-norm of the difference, 1e-2 (one bf16 ulp is 2^-8 = 3.9e-3 relative,
and a value rounded on either side of a tie, or a relu mask flipped where
h1 or dh1 sits within an ulp of zero, moves a few elements by one ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.ops.pallas import basic_fused as jbf
from argus_tpu_torch.ops.kernels import basic_fused as tbf

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_REL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPE = (3, 8, 8, 32)


def _raw(rng, c):
    """conv kernel (3,3,C,C) + perturbed frozen-BN buffers, twice."""
    out = []
    for _ in range(2):
        out.append((rng.normal(0, 1, (3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32))
        out += [
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
        ]
    return out


def _check(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL, rel


def _inputs(dtype, seed):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(0, 1, SHAPE)).astype(np.float32)
    raw = _raw(rng, SHAPE[-1])
    g = rng.normal(0, 1, SHAPE).astype(np.float32)
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    return (jx, jg, [jnp.asarray(a) for a in raw]), (tx, tg, [torch.from_numpy(a) for a in raw])


def test_fold_matches_argus_tpu():
    (jx, _, jraw), (tx, _, traw) = _inputs("bfloat16", 0)
    want = jbf.fold_basic_params(jnp.bfloat16, *jraw)
    got = tbf.fold_basic_params(torch.bfloat16, *traw)
    # f32 folds to an f32 ulp (XLA's rsqrt and multiply-add against torch's);
    # so a bf16 weight lands at most one bf16 ulp (2^-8 to 2^-7 relative)
    # away, where its f32 product sits at a rounding tie
    for a, b, rtol in zip(got, want, (2.0**-7, 1e-6, 2.0**-7, 1e-6)):
        assert tuple(a.shape) == b.shape and a.dtype == DTYPES[str(b.dtype)][1]
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("dtype,gsz", [("float32", 1), ("bfloat16", 3)])
def test_forward_and_backward_match_pallas(dtype, gsz):
    """The plain no-save and saving forwards and the one-pass backward
    against the Pallas kernels: `_basic_block`'s primal (no save), its
    saving forward's (out, h1), and `jax.vjp` through the kernel backward
    for dx, dw1, dw2."""
    (jx, jg, jraw), (tx, tg, traw) = _inputs(dtype, 1 + gsz)
    jdt, tdt = DTYPES[dtype]
    w1, b1, w2, b2 = jbf.fold_basic_params(jdt, *jraw)
    tw = tbf.fold_basic_params(tdt, *traw)

    block = lambda x, a, b: jbf._basic_block(x, a, b1, b, b2, "pallas", True, gsz)  # noqa: E731
    out_j = block(jx, w1, w2)
    out_s, h1_s = jbf._fwd_pallas(jx, w1, b1, w2, b2, True, gsz, save=True)
    got = tbf.basic_fwd_plain(tx, *tw, save=False)
    assert got.dtype == tdt
    _check(got, out_j, dtype)
    got_out, got_h1 = tbf.basic_block_save(tx, *tw)
    _check(got_out, out_s, dtype)
    _check(got_h1, h1_s, dtype)

    _, vjp = jax.vjp(block, jx, w1, w2)
    dx_j, dw1_j, dw2_j = vjp(jg)
    dx, dw1, dw2 = tbf.basic_bwd(tx, tg, got_out, got_h1, tw[0], tw[2])
    assert dx.dtype == tdt and dw1.dtype == dw2.dtype == torch.float32
    _check(dx, dx_j, dtype)
    _check(dw1, dw1_j, dtype)
    _check(dw2, dw2_j, dtype)
    assert tbf.basic_bwd(tx, tg, got_out, got_h1, tw[0], tw[2], need_dx=False)[0] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_through_fold_matches_argus_tpu(dtype):
    """`fused_basic_block` from raw kernels and BN buffers: the output and
    the gradients of x and both conv kernels through the fold (the BN
    buffers get none), against `jax.vjp` of argus_tpu's on the Pallas
    kernels."""
    (jx, jg, jraw), (tx, tg, traw) = _inputs(dtype, 7)
    f = lambda x, k1, k2: jbf.fused_basic_block(  # noqa: E731
        x, k1, *jraw[1:5], k2, *jraw[6:10], impl="pallas", interpret=True, g=3
    )
    out_j, vjp = jax.vjp(f, jx, jraw[0], jraw[5])
    dx_j, dk1_j, dk2_j = vjp(jg)

    x = tx.clone().requires_grad_()
    k1, k2 = traw[0].clone().requires_grad_(), traw[5].clone().requires_grad_()
    s = [t.clone().requires_grad_() for t in traw[1:5]]
    out = tbf.fused_basic_block(x, k1, *s, k2, *traw[6:10])
    _check(out, out_j, dtype)
    dx, dk1, dk2 = torch.autograd.grad(out, [x, k1, k2], tg)
    for got, want in ((dx, dx_j), (dk1, dk1_j), (dk2, dk2_j)):
        _check(got, want, dtype)
    assert all(t.grad is None for t in s)
    # without a gradient to take, the no-save forward runs
    with torch.no_grad():
        _check(tbf.fused_basic_block(tx, *traw), out_j, dtype)
