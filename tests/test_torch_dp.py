"""The port's data-parallel train step on two gloo processes on the CPU,
against argus_tpu's step on a 2-device data mesh and against the port's
one-process step on the global batch.

ResNet-18 NCameraCNN (output dim 16) at 32x32, f32, a global batch of 8
rows with 3 padded ones (mask 0) placed unevenly: rank 0 holds 4 real rows,
rank 1 one (and under accumulation a microbatch of padding alone, whose
own count is 0). BN buffers and scales randomised, non-identity targets.
The cases: frozen BN and affine; exact BN on "xla" (autodiff through the
global statistics) and on "pallas" (the reduction kernels' plain versions,
their sums over the data group); exact BN on "xla" at statistics and
gradient stride 2 (each image's row blocks, so the ranks' subsamples make
the global one); and `grad_accum_steps=2` under frozen BN. Each case runs
once in each of the two processes (`parallel.launch.run_ranks`, one spawn
for the file), with augmentation off and on, and is checked two ways:

- augmentation off, against argus_tpu's `make_train_step` on
  `make_mesh(n_data=2)` (its batch through `global_batch`), from the same
  state: loss, Adam moments, the params' update and (exact BN) the running
  statistics, with tests/test_torch_train.py's `TOL` and `_check_leaves`
  (exact BN: tests/test_torch_train_bn.py's `TOL_EXACT` and `STATS_TOL`);
- augmentation on, against the port's one-process step on the global
  batch (the same sampled parameters: each rank samples the global draw
  and keeps its rows), under the same tolerances.

Both ranks' parameters and statistics must be bit-equal. And the eval
step's (loss sum, mask sum) over the ranks, with its spaghetti arcs drawn
for the global batch, against the one-process eval step on the global
batch.
"""

import copy
import functools
import hashlib

import numpy as np
import pytest
import torch

from argus_tpu_torch.parallel.launch import run_ranks
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

HW, B, LR = 32, 8, 1e-4
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
BASE = dict(n_cams=2, backbone="resnet18", resnet_output_dim=16)
FROZEN = dict(bn_frozen=True, bn_frozen_affine=True)
CASES = {  # name: (model config fields, grad_accum_steps)
    "frozen": (FROZEN, 1),
    "exact-xla": ({}, 1),
    "exact-pallas": (dict(bn_impl="pallas"), 1),
    "exact-xla-stride2": (dict(bn_stats_stride=2, bn_grad_stride=2), 1),
    "accum2": (FROZEN, 2),
}


def _cfg(case: str, aug: bool):
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    kw, accum = CASES[case]
    return TrainConfig(model_config=NCameraCNNConfig(**BASE, **kw), use_augmentation=aug, learning_rate=LR,
                       batch_size=B, grad_accum_steps=accum)


def _batch() -> dict:
    rng = np.random.default_rng(3)
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.1, 1.0, (B, 1))
    poses = np.concatenate([rng.normal(0, 0.3, (B, 3)), axis * np.sin(angle / 2), np.cos(angle / 2)], 1)
    return {"images": rng.integers(0, 256, (B, HW, HW, 6), dtype=np.uint8),
            "cube_pose": poses.astype(np.float32), "mask": MASK.copy()}


@torch.no_grad()
def _randomize_(model, seed: int = 1) -> None:
    """Random BN buffers and scales (each block's last BN small but nonzero)
    and lecun-normal weights, from a seed."""
    from argus_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            c = mod.weight.shape[0]
            lo, hi = (0.1, 0.3) if name.endswith("BatchNorm_1") else (0.5, 1.5)
            mod.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
            mod.bias.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
        elif isinstance(getattr(mod, "weight", None), torch.nn.Parameter):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) / mod.weight[0].numel() ** 0.5)
            if getattr(mod, "bias", None) is not None:
                mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=g))


@functools.lru_cache(maxsize=None)
def _made(model_fields: tuple):
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state

    cfg = TrainConfig(model_config=NCameraCNNConfig(**BASE, **dict(model_fields)), learning_rate=LR)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    _randomize_(model)
    return model, state


def _initial(case: str, aug: bool):
    """(cfg, model, state) of the case's initial state: a copy of one made
    once a process for the case's model config (its parameters and
    moments, the state's references to the model's parameters kept)."""
    model, state = copy.deepcopy(_made(tuple(CASES[case][0].items())))
    return _cfg(case, aug), model, state


def _clone(d: dict) -> dict:
    return {k: v.detach().clone() for k, v in d.items()}


def _step(case: str, aug: bool, mesh=None) -> dict:
    """One step of the port from the case's initial state on the global
    batch, or with a mesh on this rank's rows of it."""
    from argus_tpu_torch.train import make_train_step

    cfg, model, state = _initial(case, aug)
    rows = slice(0, B) if mesh is None else mesh.local_rows(B)
    batch = {k: v[rows] for k, v in _batch().items()}
    state, loss = make_train_step(model, cfg, hw=(HW, HW), device="cpu", mesh=mesh)(state, batch)
    return dict(loss=float(loss), mu=_clone(state.opt_state.mu), nu=_clone(state.opt_state.nu),
                sd=_clone(model.state_dict()))


def _eval(mesh=None) -> tuple:
    """The eval step's sums (exact BN, augmentation on: spaghetti arcs) on the
    global batch, or with a mesh on this rank's rows, at batch index 1."""
    from argus_tpu_torch.train import make_eval_step

    cfg, model, state = _initial("exact-xla", True)
    rows = slice(0, B) if mesh is None else mesh.local_rows(B)
    batch = {k: v[rows] for k, v in _batch().items()}
    s, c = make_eval_step(model, cfg, hw=(HW, HW), device="cpu", mesh=mesh)(state, batch, 1)
    return float(s), float(c)


def _digest(result: dict) -> str:
    """A hash of a step's loss, moments and state (the ranks compared
    bitwise without sending both ranks' tensors back)."""
    h = hashlib.sha256(repr(result["loss"]).encode())
    for part in ("mu", "nu", "sd"):
        for k, v in result[part].items():
            h.update(k.encode() + v.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _rank(rank: int, n: int) -> dict:
    """Rank 0's results and both ranks' digests of them."""
    from argus_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    out = {(case, aug): _step(case, aug, mesh) for case in CASES for aug in (False, True)}
    digests = {key: _digest(r) for key, r in out.items()}
    return {"steps": out if rank == 0 else None, "digests": digests, "eval": _eval(mesh)}


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, 2, timeout=400)


def _tol(case: str):
    from test_torch_train import TOL
    from test_torch_train_bn import STATS_TOL, TOL_EXACT

    exact = case.startswith("exact")
    return (TOL_EXACT if exact else TOL[False]), (STATS_TOL[False] if exact else None)


def _check(got: dict, want: dict, case: str) -> None:
    """Loss, moments, the params' update and (exact BN) the statistics'
    change of `got` against `want` (dicts of `_step`'s keys), from the
    case's initial state."""
    from test_torch_train import _check_leaves

    tol, stats_tol = _tol(case)
    assert abs(got["loss"] - want["loss"]) <= tol["loss"] * abs(want["loss"]), (got["loss"], want["loss"])
    _check_leaves(got["mu"], want["mu"], tol["moments"][0], "mu")
    _check_leaves(got["nu"], want["nu"], tol["moments"][0], "nu")
    p0 = _initial(case, False)[1].state_dict()
    is_stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    _check_leaves({k: v for k, v in got["sd"].items() if not is_stat(k)},
                  {k: v for k, v in want["sd"].items() if not is_stat(k)}, tol["update"][0], "update", p0)
    stats = {k: v for k, v in want["sd"].items() if is_stat(k)}
    if stats_tol is not None:
        _check_leaves(got["sd"], stats, stats_tol, "batch_stats", p0)
    else:
        assert all(torch.equal(got["sd"][k], p0[k]) for k in stats)


def _argus_tpu_step(case: str, tmp_path) -> dict:
    """argus_tpu's step on a 2-device data mesh from the case's initial
    state, augmentation off."""
    import dataclasses

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

    kw, accum = CASES[case]
    _, model, _ = _initial(case, False)
    params, stats = jax.tree_util.tree_map(jnp.asarray, variables_from_state_dict(model.state_dict()))
    jm = JaxConfig(**BASE, **kw)
    jcfg = JaxTrainConfig(model_config=jm, use_augmentation=False, learning_rate=LR, batch_size=B,
                          grad_accum_steps=accum, wandb_log=False, save_dir=str(tmp_path))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                          opt_state=make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32))
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    state = jax.device_put(state, JaxTrainState(
        **{f.name: param_shardings(getattr(state, f.name), mesh) for f in dataclasses.fields(JaxTrainState)}))
    step = make_train_step(JaxNCameraCNN(jm), jcfg, 0, mesh=mesh, hw=(HW, HW))
    state, loss = step(state, global_batch(mesh, _batch()))
    adam = state.opt_state[1]
    _, mu, nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    sd = state_dict_from_variables(jax.device_get(state.params), jax.device_get(state.batch_stats))
    return dict(loss=float(loss), mu=mu, nu=nu, sd=sd)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_argus_tpu_data_mesh(ranks, case, tmp_path):
    assert ranks[0]["digests"][case, False] == ranks[1]["digests"][case, False], "the ranks' states differ"
    _check(ranks[0]["steps"][case, False], _argus_tpu_step(case, tmp_path), case)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_matches_one_process_step_augmented(ranks, case):
    assert ranks[0]["digests"][case, True] == ranks[1]["digests"][case, True], "the ranks' states differ"
    _check(ranks[0]["steps"][case, True], _step(case, True), case)


def test_eval_sums_over_ranks(ranks):
    want = _eval()
    assert want[1] == MASK.sum()
    for got in (ranks[0]["eval"], ranks[1]["eval"]):
        assert got[1] == want[1] and abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
