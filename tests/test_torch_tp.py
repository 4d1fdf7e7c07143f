"""Tensor parallelism of the port's wide dense layers (`num_model_shards=2`)
on two gloo processes on the CPU, against the unsharded port step and
argus_tpu's step on `make_mesh(n_data=1, n_model=2)`.

ResNet-18 NCameraCNN (output dim 16) at 32x32, f32, frozen BN and affine,
the global batch of tests/test_torch_dp.py (8 rows, 3 padded) on both
ranks, the clip active (max_grad_norm 0.01, so the global norm sets every
update). Each rank holds its slices of `backbone.fc` and of `head_fc1`'s
columns (`parallel.tp`); after one step the sharded leaves are gathered
whole (`whole_state`) and compared with tests/test_torch_train.py's f32
`TOL` and `_check_leaves`. Also: the clip's global norm over the sharded
leaves (squares summed over the model group once, replicated leaves
counted once) against the norm over the whole tensors, and a checkpoint
written at k=2 (gathered, by rank 0) that restores bit-equal into each
rank's slices and into a one-process state at k=1.
"""

import dataclasses

import pytest
import torch

from argus_tpu_torch.parallel.launch import run_ranks
from test_torch_dp import B, HW, _batch, _cfg, _check, _clone, _digest, _initial

CASE = "frozen"
CLIP = 0.01


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process while the module runs (the suite's
    workers share the machine's cores with this file's rank processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tp_cfg(k: int):
    return dataclasses.replace(_cfg(CASE, False), max_grad_norm=CLIP, num_model_shards=k)


def _unsharded() -> dict:
    from argus_tpu_torch.train import make_train_step

    _, model, state = _initial(CASE, False)
    cfg = _tp_cfg(1)
    state, loss = make_train_step(model, cfg, hw=(HW, HW), device="cpu")(state, _batch())
    return dict(loss=float(loss), mu=_clone(state.opt_state.mu), nu=_clone(state.opt_state.nu),
                sd=_clone(model.state_dict()))


def _rank(rank: int, n: int, path: str) -> dict:
    """One step at k=2 (whole results on rank 0), the clip's norm over this
    rank's slices, and the checkpoint round trip."""
    import torch.distributed as dist

    from argus_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from argus_tpu_torch.parallel import make_mesh
    from argus_tpu_torch.parallel.tp import shard_state, whole_state
    from argus_tpu_torch.train import TrainStepBody, make_train_step

    mesh = make_mesh(n_model=2)
    cfg = _tp_cfg(2)
    _, model, state = _initial(CASE, False)
    whole_params = _clone(state.params)
    state = shard_state(model, state, mesh)
    body = TrainStepBody(model, cfg, hw=(HW, HW), device="cpu", mesh=mesh)
    names = list(state.params)
    norm = float(body.opt._global_norm(names, [state.params[k].detach() for k in names]))
    state, loss = make_train_step(model, cfg, hw=(HW, HW), device="cpu", mesh=mesh)(state, _batch())
    whole = whole_state(state, mesh)
    result = dict(loss=float(loss), mu=_clone(whole.opt_state.mu), nu=_clone(whole.opt_state.nu),
                  sd={**_clone(whole.params), **_clone(whole.batch_stats)})
    if rank == 0:
        save_checkpoint(path, whole)
    dist.barrier()
    _, fresh_model, fresh = _initial(CASE, False)
    fresh = shard_state(fresh_model, fresh, mesh)
    load_checkpoint(path, target=fresh)
    restored = all(torch.equal(fresh.params[k], state.params[k]) for k in names) and all(
        torch.equal(getattr(fresh.opt_state, m)[k], getattr(state.opt_state, m)[k]) for m in ("mu", "nu")
        for k in names)
    return dict(step=result if rank == 0 else None, digest=_digest(result), norm=norm, restored=restored,
                shapes={k: tuple(v.shape) for k, v in state.params.items() if k in state.shardings},
                whole_norm=float(torch.linalg.vector_norm(torch.stack([v.norm() for v in whole_params.values()]))))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tp") / "k2.ckpt")
    return run_ranks(_rank, 2, path, timeout=300), path


def test_tp_step_matches_unsharded_step(ranks):
    res, _ = ranks
    assert res[0]["digest"] == res[1]["digest"], "the ranks' gathered states differ"
    assert res[0]["shapes"] == {"backbone.fc.weight": (8, 512), "backbone.fc.bias": (8,),
                                "head_fc1.weight": (128, 16)}
    _check(res[0]["step"], _unsharded(), CASE)


def test_tp_step_matches_argus_tpu_model_mesh(ranks, tmp_path):
    """argus_tpu's step on a 1x2 (data, model) mesh, its wide layers sharded
    by its own `DEFAULT_TP_RULES`."""
    import jax
    import jax.numpy as jnp

    from argus_tpu.models import NCameraCNN as JaxNCameraCNN
    from argus_tpu.models import NCameraCNNConfig as JaxConfig
    from argus_tpu.parallel import global_batch, make_mesh, param_shardings
    from argus_tpu.train import TrainConfig as JaxTrainConfig
    from argus_tpu.train import TrainState as JaxTrainState
    from argus_tpu.train import make_optimizer, make_train_step
    from argus_tpu_torch.models.jax_import import (
        adam_moments_from_optax,
        state_dict_from_variables,
        variables_from_state_dict,
    )
    from test_torch_dp import BASE, FROZEN, LR

    res, _ = ranks
    _, model, _ = _initial(CASE, False)
    params, stats = jax.tree_util.tree_map(jnp.asarray, variables_from_state_dict(model.state_dict()))
    jm = JaxConfig(**BASE, **FROZEN)
    jcfg = JaxTrainConfig(model_config=jm, use_augmentation=False, learning_rate=LR, batch_size=B,
                          max_grad_norm=CLIP, num_model_shards=2, wandb_log=False, save_dir=str(tmp_path))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=make_optimizer(CLIP).init(params), lr=jnp.asarray(LR, jnp.float32))
    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    state = jax.device_put(state, JaxTrainState(
        **{f.name: param_shardings(getattr(state, f.name), mesh) for f in dataclasses.fields(JaxTrainState)}))
    assert not state.params["head_fc1"]["kernel"].sharding.is_fully_replicated
    state, loss = make_train_step(JaxNCameraCNN(jm), jcfg, 0, mesh=mesh, hw=(HW, HW))(state,
                                                                                      global_batch(mesh, _batch()))
    adam = state.opt_state[1]
    _, mu, nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    sd = state_dict_from_variables(jax.device_get(state.params), jax.device_get(state.batch_stats))
    _check(res[0]["step"], dict(loss=float(loss), mu=mu, nu=nu, sd=sd), CASE)


def test_clip_norm_over_sharded_leaves(ranks):
    res, _ = ranks
    for r in res:
        assert abs(r["norm"] - r["whole_norm"]) <= 1e-6 * r["whole_norm"], (r["norm"], r["whole_norm"])


def test_checkpoint_at_k2_loads_at_k2_and_k1(ranks):
    """Rank 0's file holds whole tensors: it restores bit-equal into each
    rank's slices, and into a one-process state (k=1) as the gathered
    state."""
    from argus_tpu_torch.checkpoint import load_checkpoint

    res, path = ranks
    assert res[0]["restored"] and res[1]["restored"]
    _, model, state = _initial(CASE, False)
    load_checkpoint(path, target=state)
    want = res[0]["step"]
    assert state.step == 1 and not state.shardings
    for k, v in want["sd"].items():
        assert torch.equal(model.state_dict()[k], v), k
    for m in ("mu", "nu"):
        assert all(torch.equal(getattr(state.opt_state, m)[k], v) for k, v in want[m].items()), m
