"""The port's device-resident data path (`data.resident`,
`train.make_resident_epoch_step`, the selection in `initialize_training`)
against the port's per-step path and against argus_tpu's.

argus_tpu's synthetic dataset, 10 train + 5 test noise frame pairs at
32x32 (noise: exact BN on flat frames divides by a near-zero variance),
batch 4, so each epoch's last batch is padded. ResNet-18 NCameraCNN
(output dim 16).

Tolerances. The footprint, the budget gate, the shard plan and the shard
order are argus_tpu's exactly. Against the port's own per-step path fed
the same order (augmentation on): losses and parameters bit-equal (the
same ops on the same tensors). Against argus_tpu (augmentation off, the
epoch order replaced by argus_tpu's `jax.random.permutation`): every
step's loss and each val loss within 1e-4 relative, the params' change
per leaf and in the median over leaves within `test_torch_train.py`'s f32
update tolerance (5e-2, 5e-2), as `test_torch_loop.py`'s two-epoch parity
holds them, for its reasons (reordered f32 sums, Adam's first steps close
to lr * sign(g)); frozen BN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argus_tpu.train as jtrain
from argus_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from argus_tpu.data import CameraCubePoseDataset as JaxDataset
from argus_tpu.data import CameraCubePoseDatasetConfig as JaxDatasetConfig
from argus_tpu.data import DeviceResidentData as JaxResident
from argus_tpu.data import ResidentShardedData as JaxSharded
from argus_tpu.data.synthetic import write_synthetic_dataset
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu_torch import checkpoint as tck
from argus_tpu_torch import logging_utils
from argus_tpu_torch import train as ttrain
from argus_tpu_torch.data import CameraCubePoseDataset, CameraCubePoseDatasetConfig, DeviceResidentData, \
    ResidentShardedData
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models import keypoint_net as kn
from argus_tpu_torch.models.jax_import import state_dict_from_variables
from argus_tpu_torch.ops.augment import AugmentationConfig
from argus_tpu_torch.train import TrainConfig, create_train_state, make_resident_epoch_step, make_train_step
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

SMALL = dict(backbone="resnet18", resnet_output_dim=16)
PER_EXAMPLE = 32 * 32 * 6 + 28


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("resident") / "ds")
    write_synthetic_dataset(d, n_train=10, n_test=5, height=32, width=32, seed=0)
    return d


def _port_ds(path):
    return CameraCubePoseDataset(CameraCubePoseDatasetConfig(path, center_crop=(32, 32)), train=True)


def _jax_ds(path):
    return JaxDataset(JaxDatasetConfig(path, center_crop=(32, 32)), train=True)


def _jax_permutation(seed, epoch, n, device):
    perm = jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), epoch), n)
    return torch.from_numpy(np.array(perm)).to(device)


# ───────────────────────────── budget and shard plan ─────────────────────────────


@pytest.mark.parametrize("budget_examples", [0, 10, 10 - 1e-6, 9, 5, 3, 1, 0.3, 1e6])
def test_budget_and_shard_plan_match_argus_tpu(dataset, budget_examples):
    """The footprint, the gate, the shard plan and four epochs' shard order
    (each shard's poses, segment and length) as argus_tpu computes them."""
    tds, jds = _port_ds(dataset), _jax_ds(dataset)
    budget_mb = budget_examples * PER_EXAMPLE / 2**20
    assert DeviceResidentData.bytes_estimate(tds) == JaxResident.bytes_estimate(jds) == 10 * PER_EXAMPLE
    assert DeviceResidentData.fits(tds, budget_mb) == JaxResident.fits(jds, budget_mb)
    assert ResidentShardedData.applicable(tds, budget_mb) == JaxSharded.applicable(jds, budget_mb)
    if not ResidentShardedData.applicable(tds, budget_mb):
        return
    ours, theirs = ResidentShardedData(tds, budget_mb, device="cpu", seed=3), JaxSharded(jds, budget_mb, seed=3)
    assert (ours.shard_size, ours.n_shards, ours.tail_size) == (theirs.shard_size, theirs.n_shards, theirs.tail_size)
    assert [a.tolist() for a in ours.index_shards] == [a.tolist() for a in theirs.index_shards]
    for epoch in range(4):
        got = [(p.numpy(), seg, n) for _, p, seg, n in ours.epoch_shards(epoch)]
        want = [(np.asarray(p), seg, n) for _, p, seg, n in theirs.epoch_shards(epoch)]
        assert [g[1:] for g in got] == [w[1:] for w in want]
        for (a, *_), (b, *_) in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ───────────────────────────── the epoch against the per-step path ─────────────────────────────


def _aug_cfg(fused, **kw):
    aug = AugmentationConfig(num_spaghetti=1, pallas_blur=False, pallas_fused=True if fused else "auto")
    return TrainConfig(model_config=NCameraCNNConfig(**SMALL), batch_size=4, learning_rate=1e-3,
                       augmentation_config=aug, **kw)


def _per_step(cfg, images, poses, orders, seed=7):
    """The per-step path fed `orders` (one (n,) order per epoch or shard,
    with its images and poses): losses and final params."""
    model, state = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(model, cfg, base_seed=seed, device="cpu")
    B, losses = cfg.batch_size, []
    for imgs, pos, perm in zip(images, poses, orders):
        n = len(perm)
        k = -(-n // B)
        perm = torch.cat([perm, perm[:k * B - n]])
        mask = (torch.arange(k * B) < n).float()
        for i in range(k):
            sel = perm[i * B:(i + 1) * B]
            state, loss = step(state, {"images": imgs[sel], "cube_pose": pos[sel], "mask": mask[i * B:(i + 1) * B]})
            losses.append(loss)
    return torch.stack(losses), state


@pytest.mark.parametrize("fused", [False, True], ids=["per-op", "fused"])
def test_resident_epoch_matches_the_per_step_path(dataset, fused):
    """Two resident epochs (augmentation on: the fused path's operands
    packed by `prepare`, applied in `compute`) against the per-step path fed
    the same orders: bit-equal."""
    cfg = _aug_cfg(fused)
    res = DeviceResidentData.from_dataset(_port_ds(dataset), device="cpu")
    model, state = create_train_state(cfg, seed=0, device="cpu")
    epoch_step, k = make_resident_epoch_step(model, cfg, base_seed=7, n_examples=res.n, device="cpu")
    assert k == 3
    got = []
    for epoch in range(2):
        state, losses = epoch_step(state, res.images, res.poses, epoch)
        assert losses.shape == (3,) and torch.isfinite(losses).all()
        got.append(losses)
    assert state.step == 6 and int(state.opt_state.count) == 6
    orders = [ttrain.epoch_permutation(7, e, 10, "cpu") for e in range(2)]
    assert not torch.equal(orders[0], orders[1])
    want, wstate = _per_step(cfg, [res.images] * 2, [res.poses] * 2, orders)
    assert torch.equal(torch.cat(got), want)
    assert all(torch.equal(state.params[k], wstate.params[k]) for k in state.params)


def test_sharded_epochs_match_the_per_step_path(dataset):
    """Two epochs of shard swaps (shards of 4, 4 and 2; one epoch step per
    length, the second lending the first's step) against the per-step path
    fed each shard's order: bit-equal."""
    cfg = _aug_cfg(False)
    ds = _port_ds(dataset)
    shards = ResidentShardedData(ds, 9 * PER_EXAMPLE / 2**20, device="cpu", seed=3)
    assert (shards.shard_size, shards.n_shards, shards.tail_size) == (4, 3, 2)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    steps = {4: make_resident_epoch_step(model, cfg, base_seed=7, n_examples=4, device="cpu")[0]}
    steps[2] = make_resident_epoch_step(model, cfg, base_seed=7, n_examples=2, device="cpu", like=steps[4])[0]
    assert steps[2].body is steps[4].body
    got, fed = [], []
    for epoch in range(2):
        for imgs, poses, seg, n_k in shards.epoch_shards(epoch):
            state, losses = steps[n_k](state, imgs, poses, seg)
            got.append(losses)
            fed.append((imgs, poses, ttrain.epoch_permutation(7, seg, n_k, "cpu")))
    assert state.step == 2 * (1 + 1 + 1)
    want, wstate = _per_step(cfg, *zip(*fed))
    assert torch.equal(torch.cat(got), want)
    assert all(torch.equal(state.params[k], wstate.params[k]) for k in state.params)


# ───────────────────────────── against argus_tpu ─────────────────────────────


def _update_errors(p0, got, want):
    errs = sorted(((got[k] - want[k]).norm() / (want[k] - p0[k]).norm()).item() for k in want
                  if (want[k] - p0[k]).norm() > 0)
    assert len(errs) == len(want)
    return errs


def test_resident_epoch_matches_argus_tpu(dataset, monkeypatch):
    """Two resident epochs of both packages from one state, augmentation
    off, the port's order argus_tpu's."""
    monkeypatch.setattr(ttrain, "epoch_permutation", _jax_permutation)
    model_cfg = dict(SMALL, bn_frozen=True)
    jcfg = jtrain.TrainConfig(model_config=JaxConfig(**model_cfg), batch_size=4, use_augmentation=False,
                              learning_rate=1e-3, wandb_log=False)
    jmodel, jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(3), (32, 32))
    cfg = TrainConfig(model_config=NCameraCNNConfig(**model_cfg), batch_size=4, use_augmentation=False,
                      learning_rate=1e-3)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    model.load_state_dict(state_dict_from_variables(jax.device_get(jstate.params),
                                                    jax.device_get(jstate.batch_stats)))
    p0 = {k: v.detach().clone() for k, v in state.params.items()}

    jres = JaxResident.from_dataset(_jax_ds(dataset))
    jepoch, jk = jtrain.make_resident_epoch_step(jmodel, jcfg, base_seed=7, n_examples=jres.n)
    res = DeviceResidentData.from_dataset(_port_ds(dataset), device="cpu")
    epoch_step, k = make_resident_epoch_step(model, cfg, base_seed=7, n_examples=res.n, device="cpu")
    assert k == jk == 3
    for epoch in range(2):
        jstate, jlosses = jepoch(jstate, jres.images, jres.poses, jnp.asarray(epoch, jnp.int32))
        state, losses = epoch_step(state, res.images, res.poses, epoch)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    assert state.step == int(jstate.step) == 6
    want = state_dict_from_variables(jax.device_get(jstate.params), {})
    errs = _update_errors(p0, {k: v.detach() for k, v in state.params.items()}, want)
    assert errs[-1] <= 5e-2 and errs[len(errs) // 2] <= 5e-2, errs[-3:]


# ───────────────────────────── the loop ─────────────────────────────


def _loop_cfg(dataset, save_dir, **kw):
    return TrainConfig(dataset_config=CameraCubePoseDatasetConfig(dataset, center_crop=(32, 32)),
                       model_config=NCameraCNNConfig(**SMALL, bn_frozen=True), batch_size=4, n_epochs=2,
                       num_workers=1, use_augmentation=False, wandb_log=False, save_dir=str(save_dir),
                       learning_rate=1e-3, **kw)


def test_initialize_training_selects_the_data_path(dataset, tmp_path):
    """argus_tpu's choice by budget: resident when the split fits (the
    default 2048 MB), shard swaps past it (one epoch step per distinct
    shard length, one step body between them), the host loader at 0;
    accumulation under frozen BN sets up."""
    setup = ttrain.initialize_training(_loop_cfg(dataset, tmp_path), device="cpu")
    assert TrainConfig().device_resident_mb == 2048.0
    assert setup["resident"].n == 10 and setup["resident"].images.shape == (10, 32, 32, 6)
    assert setup["resident_sharded"] is None and setup["shard_steps"] is None
    assert torch.equal(setup["resident"].poses, torch.from_numpy(_port_ds(dataset).cube_poses))

    setup = ttrain.initialize_training(_loop_cfg(dataset, tmp_path, device_resident_mb=9 * PER_EXAMPLE / 2**20),
                                       device="cpu")
    assert setup["resident"] is None and setup["epoch_step"] is None
    assert setup["resident_sharded"].shard_size == 4 and sorted(setup["shard_steps"]) == [2, 4]
    assert setup["shard_steps"][2].body is setup["shard_steps"][4].body

    setup = ttrain.initialize_training(_loop_cfg(dataset, tmp_path, device_resident_mb=0, grad_accum_steps=2),
                                       device="cpu")
    assert setup["resident"] is None and setup["resident_sharded"] is None
    state, loss = setup["train_step"](setup["state"], next(iter(setup["train_loader"])))
    assert torch.isfinite(loss) and state.step == 1


class _Recorder:
    runs = []

    def __init__(self, *a, **k):
        self.records = []
        _Recorder.runs.append(self)

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))

    def finish(self):
        pass


@pytest.mark.parametrize("path", ["resident", "sharded"])
def test_two_epochs_match_argus_tpu(dataset, tmp_path, monkeypatch, path):
    """train() of both packages on the resident (or sharded) path for two
    epochs from one argus_tpu checkpoint, the port's order argus_tpu's:
    every step's loss and each val loss, the step counts."""
    kw = {} if path == "resident" else dict(device_resident_mb=9 * PER_EXAMPLE / 2**20)
    jcfg = jtrain.TrainConfig(
        dataset_config=jtrain.CameraCubePoseDatasetConfig(dataset, center_crop=(32, 32)),
        model_config=JaxConfig(**SMALL, bn_frozen=True), batch_size=4, n_epochs=2, num_workers=1,
        use_augmentation=False, wandb_log=False, save_dir=str(tmp_path / "jax"), learning_rate=1e-3, **kw)
    _, jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(3), (32, 32))
    start = jax_save_checkpoint(str(tmp_path / "start.ckpt"), jstate, meta=jtrain.checkpoint_meta(jcfg, (32, 32)))
    _Recorder.runs.clear()
    monkeypatch.setattr(jtrain, "MetricsLogger", _Recorder)
    monkeypatch.setattr(logging_utils, "MetricsLogger", _Recorder)
    monkeypatch.setattr(ttrain, "epoch_permutation", _jax_permutation)
    jpath = jtrain.train(dataclasses.replace(jcfg, resume_from=start))
    tpath = ttrain.train(_loop_cfg(dataset, tmp_path / "port", resume_from=start, **kw), device="cpu")
    jrec, trec = (r.records for r in _Recorder.runs)
    # 3 batches an epoch: 10 examples at batch 4, or shards of 4, 4 and 2 at a batch each
    assert [s for s, _ in trec] == [s for s, _ in jrec] and len(trec) == 6 + 2
    for (_, a), (_, b) in zip(trec, jrec):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    jend, tend = (tck.load_checkpoint(p) for p in (jpath, tpath))
    assert int(tend["step"]) == int(jend["step"]) == 6


# ───────────────────────────── keypoint corners ─────────────────────────────


def test_keypoint_corners_are_uploaded_once_and_change_nothing(monkeypatch):
    """The keypoint loss and the pose fit read the cube's corners from a
    per-device constant (no upload a step); their values are bit-equal to
    those from corners made afresh on every call."""
    rng = np.random.default_rng(0)
    P = kn.nominal_camera_matrices(64, 64)
    poses = torch.from_numpy(np.concatenate([rng.normal(0, 0.02, (6, 3)) + [0, 0, 0.05],
                                             np.tile([0.1, 0.2, -0.1, np.sqrt(0.94)], (6, 1))], 1).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(0, 64, (6, 2, 8, 2)).astype(np.float32))
    cpu = torch.device("cpu")
    assert kn._corners_on(0.035, cpu) is kn._corners_on(0.035, cpu)
    got = (kn.keypoint_loss_fn(uv, poses, P), kn.fit_pose(P, uv))
    monkeypatch.setattr(kn, "_corners_on", lambda hw, device: kn.cube_corners(hw).to(device))
    want = (kn.keypoint_loss_fn(uv, poses, P), kn.fit_pose(P, uv))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
