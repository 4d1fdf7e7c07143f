"""argus_tpu's default BatchNorm (exact, `bn_impl="xla"`, f32) one step at a
time over a resident epoch's batches, its padded last batch included, each
step of the port taken from argus_tpu's state before it.

tests/test_torch_resident.py runs both packages free for two epochs under
exact BN, and there the two drift apart step by step: each step's update
differs by f32 rounding (the same sums in another order), Adam's
normalised step turns that into differences of O(lr) in gradient elements
near zero, and the batch statistics of ResNet-18's 1x1 last stage at
32x32 (8 camera images a batch, 4 of them repeats in the padded batch)
pass them on. Those cases are held to gates measured for six free steps.
This file holds each step to the one-step gates of
tests/test_torch_train_bn.py instead: before each step argus_tpu's whole
state (params, running statistics, Adam moments and count) is written by
argus_tpu's checkpoint writer and read into the port's state by the
port's loader, then both take the step on the batch the epoch's order
gives (argus_tpu's `jax.random.permutation`, padded with its own first
entries, mask 0): the loss within TOL_EXACT's 1e-5 relative, the Adam
moments and the params' update within its gates, and the running
statistics' change within the f32 STATS_TOL (1e-3, 1e-3). The padded
batch's repeated rows enter the batch statistics in both packages
(`argus_tpu/train.py` `make_resident_epoch_step`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import argus_tpu.train as jtrain
from argus_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu_torch import checkpoint as tck
from argus_tpu_torch.data import DeviceResidentData
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models.jax_import import adam_moments_from_optax, state_dict_from_variables
from argus_tpu_torch.train import TrainConfig, create_train_state, epoch_batches, make_train_step
from test_torch_resident import BN, LR, SMALL, _is_stat, _jax_permutation, _jax_start, _port_ds, dataset  # noqa: F401
from test_torch_train import _check_leaves
from test_torch_train_bn import STATS_TOL, TOL_EXACT
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)


def test_exact_bn_steps_match_argus_tpu(dataset, tmp_path):
    bn = "exact-f32"
    model_cfg = dict(SMALL, **BN[bn])
    jcfg = jtrain.TrainConfig(model_config=JaxConfig(**model_cfg), batch_size=4, use_augmentation=False,
                              learning_rate=LR[bn], wandb_log=False, save_dir=str(tmp_path))
    cfg = TrainConfig(model_config=NCameraCNNConfig(**model_cfg), batch_size=4, use_augmentation=False,
                      learning_rate=LR[bn])
    model, state = create_train_state(cfg, seed=0, device="cpu")
    jmodel, jstate = _jax_start(jcfg, model)
    jstep = jax.jit(jtrain.make_train_step_body(jmodel, jcfg, 7, hw=(32, 32)))
    step = make_train_step(model, cfg, base_seed=7, hw=(32, 32), device="cpu")
    res = DeviceResidentData.from_dataset(_port_ds(dataset), device="cpu")
    idx, mask = epoch_batches(_jax_permutation(7, 0, res.n, "cpu"), cfg.batch_size)
    assert idx.shape == (3, 4) and mask[-1].tolist() == [1.0, 1.0, 0.0, 0.0]
    for i in range(idx.shape[0]):
        start = jax_save_checkpoint(str(tmp_path / f"step{i}.ckpt"), jstate)
        tck.load_checkpoint(start, target=state)
        assert state.step == i
        p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        batch = {"images": res.images[idx[i]], "cube_pose": res.poses[idx[i]], "mask": mask[i]}
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        state, loss = step(state, batch)
        assert abs(float(loss) - float(jloss)) <= TOL_EXACT["loss"] * abs(float(jloss)), (i, float(loss),
                                                                                          float(jloss))
        adam = jstate.opt_state[1]
        _, w_mu, w_nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
        _check_leaves(state.opt_state.mu, w_mu, TOL_EXACT["moments"][0], f"step {i} mu")
        _check_leaves(state.opt_state.nu, w_nu, TOL_EXACT["moments"][0], f"step {i} nu")
        want = state_dict_from_variables(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))
        got = model.state_dict()
        _check_leaves({k: v for k, v in got.items() if not _is_stat(k)},
                      {k: v for k, v in want.items() if not _is_stat(k)}, TOL_EXACT["update"][0], f"step {i} update",
                      p0)
        stats = {k: v for k, v in want.items() if _is_stat(k)}
        _check_leaves({k: got[k] for k in stats}, stats, STATS_TOL[False], f"step {i} running statistics", p0)
        assert stats and all(not torch.equal(got[k], p0[k]) for k in stats)
    assert int(jstate.step) == state.step == 3 and np.isfinite(float(loss))
