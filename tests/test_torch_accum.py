"""Gradient accumulation in the port's train step (`grad_accum_steps`)
against the whole batch and against argus_tpu's `make_train_step_body`.

ResNet-18 NCameraCNN (output dim 16) at 32x32 in f32 under frozen BN (the
affine trained), 8 rows of which the last 3 are padding, so the last
microbatch holds fewer real rows than the others and the mask-count
weighting matters. BN buffers, scales and weights are randomised, the
targets are not the identity.

Tolerances. Against the whole batch (k = 2, 4): the loss within 1e-5
relative and each leaf's Adam moments (the combined, clipped gradient and
its square) within 1e-5 relative (measured 1.8e-6): the microbatch sums are
the whole batch's f32 sums split in k, so only their association differs.
Each leaf's update |p_k - p_1| / |p_1 - p_0| within 1e-3 (measured 2.2e-4):
Adam's first step divides each element by |g| + 1e-8, so an element whose
gradient is ~1e-9 (within rounding of zero) moves by a different fraction
of the learning rate when its sum is taken in another order. Against
argus_tpu: `test_torch_train.py`'s f32 tolerances after one step (loss 1e-5; Adam moments 5e-3 per leaf and in
the median; updates 2e-2 and 2e-2), for the same reasons it gives there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.models import NCameraCNN as JaxNCameraCNN
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.train import TrainConfig as JaxTrainConfig
from argus_tpu.train import TrainState as JaxTrainState
from argus_tpu.train import make_optimizer as jax_make_optimizer
from argus_tpu.train import make_train_step_body
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

from test_torch_train import _check_leaves, _randomize_

LR = 1e-3
MODEL = dict(n_cams=2, backbone="resnet18", resnet_output_dim=16, bn_frozen=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(B=8, n_real=5, hw=(32, 32)):
    rng = np.random.default_rng(5)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.3, 2.0, (B, 1))
    t = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.02, (B, 3))
    poses = np.concatenate([t, axis * np.sin(ang / 2), np.cos(ang / 2)], 1).astype(np.float32)
    return {"images": rng.integers(0, 256, (B, *hw, 6), dtype=np.uint8), "cube_pose": poses,
            "mask": (np.arange(B) < n_real).astype(np.float32)}


def _port(accum, **model):
    cfg = TrainConfig(model_config=NCameraCNNConfig(**{**MODEL, **model}), grad_accum_steps=accum,
                      use_augmentation=False, learning_rate=LR)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    _randomize_(model, seed=1)
    return cfg, model, state


def _step(accum):
    cfg, model, state = _port(accum)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss = make_train_step(model, cfg, device="cpu")(state, _batch())
    return (float(loss), p0, {k: v.detach().clone() for k, v in state.params.items()},
            (state.opt_state.mu, state.opt_state.nu))


@pytest.fixture(scope="module")
def whole_batch():
    return _step(1)


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulation_matches_the_whole_batch(whole_batch, accum):
    loss1, p0, p1, moments1 = whole_batch
    loss, p0k, pk, moments = _step(accum)
    assert all(torch.equal(p0[k], p0k[k]) for k in p0)
    assert abs(loss - loss1) <= 1e-5 * abs(loss1), (loss, loss1)
    for got, want in zip(moments, moments1):
        for k in want:
            assert (got[k] - want[k]).norm() <= 1e-5 * want[k].norm(), k
    for k in p1:
        moved = (p1[k] - p0[k]).norm()
        assert moved > 0, k
        assert (pk[k] - p1[k]).norm() <= 1e-3 * moved, (k, ((pk[k] - p1[k]).norm() / moved).item())


def test_accumulation_matches_argus_tpu():
    """One step with grad_accum_steps=2 on both sides, from one state."""
    cfg, model, state = _port(2)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params, stats = variables_from_state_dict(model.state_dict())
    jcfg = JaxTrainConfig(model_config=JaxConfig(**MODEL), grad_accum_steps=2, use_augmentation=False,
                          learning_rate=LR, wandb_log=False)
    jmodel = JaxNCameraCNN(dataclasses.replace(JaxConfig(**MODEL), dtype="float32"))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32),
    )
    jstate, jloss = jax.jit(make_train_step_body(jmodel, jcfg, 0))(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                                                                   _batch()))
    adam = jstate.opt_state[1]
    count, mu, nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    want = state_dict_from_variables(jax.device_get(jstate.params), {})

    state, loss = make_train_step(model, cfg, device="cpu")(state, _batch())
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss)), (float(loss), float(jloss))
    assert int(state.opt_state.count) == int(count) == 1
    _check_leaves(state.opt_state.mu, mu, (5e-3, 5e-3), "mu")
    _check_leaves(state.opt_state.nu, nu, (5e-3, 5e-3), "nu")
    _check_leaves(model.state_dict(), want, (2e-2, 2e-2), "update", p0)


def test_accumulation_refuses_exact_bn_and_a_ragged_split():
    with pytest.raises(ValueError, match="bn_frozen"):
        cfg, model, _ = _port(1, bn_frozen=False)
        make_train_step(model, dataclasses.replace(cfg, grad_accum_steps=2), device="cpu")
    cfg, model, state = _port(3)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, cfg, device="cpu")(state, _batch())
