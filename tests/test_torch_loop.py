"""The port's training loop against argus_tpu's: the plateau schedule, the
eval step, the train-state checkpoint both ways, the async snapshot,
preemption and resume, the CLI, the refusals, and two epochs of `train()`
from one argus_tpu checkpoint.

Tolerances. The plateau schedule, the step counts, the learning rates, the
data order and the checkpoint values are exact. The eval step: the pose
regressor's loss sum within 1e-5 relative in f32 (the same f32 ops in
another order), the keypoint family's within 1e-3 (the DLT and Procrustes
fit amplify the heatmaps' f32 rounding; argus_tpu's own eval tests hold
the fitted translations to 1e-5 m). The two-epoch parity (resnet18 at
32x32, f32, batch 4 of 10 + 5 noise frames, so the last train and val
batches are padded): every step's loss and each epoch's val loss within
1e-4 relative (measured 2e-5); the final params' change from the
checkpoint, per leaf and in the median over leaves, within
`test_torch_train.py`'s f32 update tolerance after step 2 (5e-2, 5e-2)
under frozen BN, and within `test_torch_train_bn.py`'s exact-BN tolerance
(0.25, 1e-2) under argus_tpu's default exact train-mode BN, whose backward
subtracts the cotangent's projections and so turns reordered f32 sums into
sign flips of Adam's near-zero first steps toward the stem (measured 0.068
at the worst leaf); there the running statistics' change within 2e-2 per
buffer and 1e-3 in the median (measured 4.2e-3 and 6.8e-5: f32 sums over
activations of those drifted params), and under frozen BN no change. The
frames are noise, the writer's default: on its pose-encoded frames (flat
backgrounds) exact BN divides by the square root of a near-zero batch
variance, and argus_tpu's own jitted and eager gradients of the backbone
differ by three orders of magnitude there.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import argus_tpu.train as jtrain
from argus_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from argus_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from argus_tpu.data.synthetic import write_synthetic_dataset
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.models.keypoint_net import CubeKeypointNetConfig as JaxKeypointConfig
from argus_tpu.ops import augment as JA
from argus_tpu_torch import checkpoint as tck
from argus_tpu_torch import logging_utils, preemption
from argus_tpu_torch import train as ttrain
from argus_tpu_torch.configs import cli
from argus_tpu_torch.data.dataset import CameraCubePoseDatasetConfig
from argus_tpu_torch.models import CubeKeypointNetConfig, NCameraCNNConfig
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.ops.augment import AugmentationConfig
from argus_tpu_torch.train import ReduceLROnPlateau, TrainConfig, create_train_state, make_eval_step, \
    make_train_step
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

SMALL = dict(backbone="resnet18", resnet_output_dim=16)


def test_plateau_schedule_matches_argus_tpu():
    rng = np.random.default_rng(0)
    metrics = list(np.concatenate([np.linspace(5, 1, 8), np.full(9, 1.0), 1 - 1e-5 * np.arange(7),
                                   rng.uniform(0.5, 2.0, 30), np.full(14, 0.1)]))
    for kw in ({}, dict(patience=2, factor=0.3), dict(patience=0, threshold=0.0)):
        ours, theirs = ReduceLROnPlateau(**kw), jtrain.ReduceLROnPlateau(**kw)
        lr_o = lr_t = 1e-3
        cuts = 0
        for m in metrics:
            new_o, new_t = ours.step(float(m), lr_o), theirs.step(float(m), lr_t)
            assert new_o == new_t and ours.best == theirs.best and ours.num_bad == theirs.num_bad
            cuts += new_o != lr_o
            lr_o, lr_t = new_o, new_t
        assert cuts >= 2


# ───────────────────────────── eval step ─────────────────────────────


def _padded_batch(n, hw, seed, n_real):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0.3, 2.0, (n, 1))
    t = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.02, (n, 3))
    poses = np.concatenate([t, axis * np.sin(ang / 2), np.cos(ang / 2)], 1).astype(np.float32)
    mask = (np.arange(n) < n_real).astype(np.float32)
    return {"images": rng.integers(0, 256, (n, *hw, 6), dtype=np.uint8), "cube_pose": poses, "mask": mask}


def _jax_arcs(base_seed, step, batch_idx, n, n_arcs, H, W, device):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(base_seed + 1), step), batch_idx)
    return torch.from_numpy(np.array(JA._arc_params(key, n, n_arcs, H, W))).to(device)


@pytest.mark.parametrize("family", ["pose_cnn", "keypoint"])
def test_eval_step_matches_argus_tpu(monkeypatch, family):
    """A padded batch (the last row masked) through both eval steps, with
    argus_tpu's spaghetti arcs for (step, batch index): sum and count."""
    from test_torch_keypoint import SMALL as KP_SMALL
    from test_torch_keypoint import _randomize_ as kp_randomize_
    from test_torch_train import _randomize_

    hw = (64, 64) if family == "keypoint" else (32, 32)
    if family == "keypoint":
        cfg = TrainConfig(model_type="keypoint", keypoint_config=CubeKeypointNetConfig(**KP_SMALL))
        jcfg = jtrain.TrainConfig(model_type="keypoint", keypoint_config=JaxKeypointConfig(**KP_SMALL),
                                  wandb_log=False, save_dir="outputs/models")
    else:
        cfg = TrainConfig(model_config=NCameraCNNConfig(**SMALL))
        jcfg = jtrain.TrainConfig(model_config=JaxConfig(**SMALL), wandb_log=False, save_dir="outputs/models")
    model, state = create_train_state(cfg, seed=0, device="cpu")
    (kp_randomize_ if family == "keypoint" else _randomize_)(model, 1)
    state.step = 7
    calls = []
    monkeypatch.setattr(ttrain, "eval_arc_params", lambda *a: calls.append(a[:3]) or _jax_arcs(*a))
    eval_step = make_eval_step(model, cfg, base_seed=3, hw=hw, device="cpu")
    fed = []  # the kernels on the card take contiguous frames
    model.register_forward_pre_hook(lambda m, args: fed.append(args[0].is_contiguous()))
    jmodel, _ = jtrain.build_model(jcfg)
    params, stats = variables_from_state_dict(model.state_dict())
    jstate = jtrain.TrainState(step=jnp.asarray(7, jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, params),
                               batch_stats=jax.tree_util.tree_map(jnp.asarray, stats), opt_state=None,
                               lr=jnp.asarray(1e-4, jnp.float32))
    jeval = jtrain.make_eval_step(jmodel, jcfg, base_seed=3, hw=hw)
    rtol = 1e-3 if family == "keypoint" else 1e-5
    for bi in (0, 2):
        batch = _padded_batch(3, hw, seed=bi, n_real=2)
        s, c = eval_step(state, batch, bi)
        js, jc = jeval(jstate, jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(bi, jnp.int32))
        assert float(c) == float(jc) == 2.0
        np.testing.assert_allclose(float(s), float(js), rtol=rtol)
    assert calls == [(3, 7, 0), (3, 7, 2)] and fed == [True, True]
    # the masked row changes nothing
    batch = _padded_batch(3, hw, seed=0, n_real=2)
    other = dict(batch, images=batch["images"].copy())
    other["images"][2] = 255 - other["images"][2]
    assert float(eval_step(state, other, 0)[0]) == float(eval_step(state, batch, 0)[0])


# ───────────────────────────── checkpoints ─────────────────────────────


def _stepped_port_state():
    """The port's state after one step: nonzero Adam moments and count."""
    cfg = TrainConfig(model_config=NCameraCNNConfig(**SMALL), use_augmentation=False, learning_rate=3e-4)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    state, _ = make_train_step(model, cfg, device="cpu")(state, _padded_batch(2, (32, 32), seed=1, n_real=2))
    state.lr.fill_(1.25e-4)
    return cfg, model, state


@pytest.fixture(scope="module")
def jax_state():
    """argus_tpu's (config, fresh train state) for SMALL, created once."""
    cfg = jtrain.TrainConfig(model_config=JaxConfig(**SMALL), wandb_log=False, save_dir="outputs/models")
    _, state = jtrain.create_train_state(cfg, jax.random.PRNGKey(0), (32, 32))
    return cfg, state


def _port_leaves(state):
    """(step, params+stats, count, mu, nu, lr) of a port state, as torch."""
    return (state.step, {**state.params, **state.batch_stats}, int(state.opt_state.count), state.opt_state.mu,
            state.opt_state.nu, float(state.lr))


def _jax_leaves(state):
    adam = state.opt_state[1]
    count, mu, nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    sd = state_dict_from_variables(jax.device_get(state.params), jax.device_get(state.batch_stats))
    return int(state.step), sd, int(count), mu, nu, float(state.lr)


def _assert_leaves_equal(got, want):
    assert got[0] == want[0] and got[2] == want[2] and got[5] == want[5]
    for a, b in zip(got[1::2][:2] + (got[4],), want[1::2][:2] + (want[4],)):
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(torch.as_tensor(a[k]).detach(), torch.as_tensor(b[k]).detach()), k


def test_port_checkpoint_loads_in_argus_tpu(tmp_path, jax_state):
    cfg, _, state = _stepped_port_state()
    path = tck.save_checkpoint(str(tmp_path / "port.ckpt"), state, meta=ttrain.checkpoint_meta(cfg, (32, 32)))
    restored = jax_load_checkpoint(path, target=jax_state[1])
    _assert_leaves_equal(_jax_leaves(restored), _port_leaves(state))
    assert state.step == 1 and int(state.opt_state.count) == 1


def test_argus_tpu_checkpoint_loads_in_the_port(tmp_path, jax_state):
    jcfg, jstate = jax_state
    rng = np.random.default_rng(4)
    noisy = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype), t)  # noqa: E731
    adam = jstate.opt_state[1]
    jstate = jstate.replace(step=jnp.asarray(11, jnp.int32), lr=jnp.asarray(2.5e-5, jnp.float32),
                            batch_stats=noisy(jstate.batch_stats),
                            opt_state=(jstate.opt_state[0], adam._replace(count=jnp.asarray(11, jnp.int32),
                                                                          mu=noisy(adam.mu), nu=noisy(adam.nu))))
    path = str(tmp_path / "jax.ckpt")
    jax_save_checkpoint(path, jstate, meta=jtrain.checkpoint_meta(jcfg, (32, 32)))
    _, _, state = _stepped_port_state()
    assert tck.load_checkpoint(path, target=state) is state
    _assert_leaves_equal(_port_leaves(state), _jax_leaves(jstate))
    raw, meta = tck.load_checkpoint_with_meta(path)
    assert meta["model_config"]["backbone"] == "resnet18" and int(raw["step"]) == 11


def test_load_checkpoint_raises_on_a_mismatched_tree(tmp_path):
    _, _, state = _stepped_port_state()
    tree = tck.train_state_tree(state)
    for name, edit in (
        ("missing", lambda t: t["params"]["head_out"].pop("bias")),
        ("extra", lambda t: t["batch_stats"].setdefault("extra", {"mean": np.zeros(3, np.float32)})),
        ("shape", lambda t: t["params"]["head_out"].__setitem__("bias", np.zeros(7, np.float32))),
        ("adam", lambda t: t["opt_state"]["1"]["mu"]["head_out"].pop("kernel")),
        ("top", lambda t: t.pop("lr")),
    ):
        t = tck.train_state_tree(state)
        edit(t)
        path = tck.save_checkpoint(str(tmp_path / f"{name}.ckpt"), t)
        with pytest.raises((KeyError, ValueError)):
            tck.load_checkpoint(path, target=state)
    assert tree["step"] == 1


def test_find_latest_checkpoint(tmp_path):
    assert tck.find_latest_checkpoint(str(tmp_path)) is None
    for i, name in enumerate(("b.ckpt", "a.ckpt", "c.txt")):
        p = tmp_path / name
        p.write_bytes(b"x")
        os.utime(p, (1000 + i, 1000 + i))
    assert tck.find_latest_checkpoint(str(tmp_path)) == str(tmp_path / "a.ckpt")


def test_async_snapshot_survives_a_later_in_place_step(tmp_path, monkeypatch):
    """The save returns before the file is written; the step that follows
    updates the live state in place; the file holds the state at the save."""
    cfg, model, state = _stepped_port_state()
    before = [{k: v.detach().clone() for k, v in d.items()} for d in (state.params, state.opt_state.mu)]
    write, go = tck.save_checkpoint, threading.Event()
    monkeypatch.setattr(tck, "save_checkpoint", lambda *a, **k: (go.wait(60), write(*a, **k))[1])
    ckpt = tck.AsyncCheckpointer()
    path = ckpt.save(str(tmp_path / "a.ckpt"), state)
    state, _ = make_train_step(model, cfg, device="cpu")(state, _padded_batch(2, (32, 32), seed=2, n_real=2))
    assert not os.path.exists(path)  # the writer waits for `go`: the step ran before the write
    go.set()
    ckpt.wait()
    _, fresh = create_train_state(cfg, seed=9, device="cpu")
    tck.load_checkpoint(path, target=fresh)
    assert fresh.step == 1 and state.step == 2
    for got, want in zip((fresh.params, fresh.opt_state.mu), before):
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    assert any(not torch.equal(state.params[k], before[0][k]) for k in state.params)
    monkeypatch.setattr(tck, "save_checkpoint", lambda *a, **k: 1 / 0)
    ckpt.save(str(tmp_path / "b.ckpt"), state)
    with pytest.raises(ZeroDivisionError):
        ckpt.wait()


# ───────────────────────────── the loop ─────────────────────────────


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """argus_tpu's synthetic dataset: 10 train + 5 test noise frame pairs
    at 32x32."""
    d = str(tmp_path_factory.mktemp("loop") / "ds")
    write_synthetic_dataset(d, n_train=10, n_test=5, height=32, width=32, seed=0)
    return d


def _loop_cfg(dataset, save_dir, model=SMALL, **kw):
    return TrainConfig(dataset_config=CameraCubePoseDatasetConfig(dataset, center_crop=(32, 32)),
                       model_config=NCameraCNNConfig(**model), batch_size=4, n_epochs=2, num_workers=1,
                       device_resident_mb=0, use_augmentation=False, wandb_log=False, save_dir=str(save_dir),
                       learning_rate=1e-3, **kw)


def test_unported_configurations_raise_in_initialize_training(dataset, tmp_path):
    """`multigpu` trains over the process group, so without one it raises
    and names what to start."""
    cfg = _loop_cfg(dataset, tmp_path)
    with pytest.raises(ValueError, match="initialised process group"):
        ttrain.initialize_training(dataclasses.replace(cfg, multigpu=True), device="cpu")
    assert TrainConfig().device_resident_mb == 2048.0


class _Recorder:
    """A MetricsLogger stand-in that keeps what is logged."""

    runs = []

    def __init__(self, *a, **k):
        self.records = []
        _Recorder.runs.append(self)

    def log(self, metrics, step=None):
        self.records.append((step, dict(metrics)))

    def finish(self):
        pass


def test_preemption_saves_and_resume_continues(dataset, tmp_path, monkeypatch, capsys):
    """A termination request after the second step of the first epoch: the
    loop stops, saves the state at step 2 and returns; a run resumed from
    that file continues at step 2 for a whole epoch (3 batches)."""

    class Guard(preemption.PreemptionGuard):
        polls = 0

        @property
        def requested(self):
            Guard.polls += 1
            return Guard.polls >= 2

    monkeypatch.setattr(preemption, "PreemptionGuard", Guard)
    cfg = _loop_cfg(dataset, tmp_path)
    path = ttrain.train(cfg, device="cpu")
    assert "Preempted at step 2" in capsys.readouterr().out
    assert int(tck.load_checkpoint(path)["step"]) == 2
    monkeypatch.undo()
    resumed = ttrain.train(dataclasses.replace(cfg, resume_from=path, n_epochs=1), device="cpu")
    tree = tck.load_checkpoint(resumed)
    assert int(tree["step"]) == 5 and int(tree["opt_state"]["1"]["count"]) == 5


def test_cli_builds_the_train_config(dataset):
    cfg = cli(TrainConfig, ["--dataset-config.dataset-path", dataset, "--dataset-config.center-crop", "32", "32",
                            "--batch-size", "4", "--no-wandb-log", "--device-resident-mb", "0", "--amp",
                            "--model-config.backbone", "resnet18", "--augmentation-config.num-spaghetti", "3"])
    assert cfg.dataset_config.dataset_path == dataset and cfg.dataset_config.center_crop == (32, 32)
    assert (cfg.batch_size, cfg.wandb_log, cfg.device_resident_mb, cfg.amp) == (4, False, 0.0, True)
    assert cfg.model_config.backbone == "resnet18" and isinstance(cfg.augmentation_config, AugmentationConfig)
    assert cfg.augmentation_config.num_spaghetti == 3


def test_metrics_logger_writes_jsonl(tmp_path):
    log = logging_utils.MetricsLogger("p", run_id="abc", config=TrainConfig(), log_dir=str(tmp_path))
    log.log({"loss": np.float32(1.5)}, step=3)
    log.log({"val_loss": torch.tensor(0.25)})
    log.finish()
    import json

    lines = [json.loads(x) for x in open(tmp_path / "abc.jsonl")]
    assert lines[0]["_type"] == "run_start" and lines[0]["config"]["batch_size"] == 32
    assert (lines[1]["step"], lines[1]["loss"], lines[2]["val_loss"]) == (3, 1.5, 0.25)
    assert len(logging_utils.generate_run_id()) == 8


@pytest.mark.parametrize("bn", ["exact", "frozen"])
def test_two_epochs_match_argus_tpu(dataset, tmp_path, monkeypatch, bn):
    """train() of both packages for two epochs, resumed from one argus_tpu
    checkpoint: per-step losses, val losses, learning rates, step counts and
    the final train state."""
    model = dict(SMALL, bn_frozen=bn == "frozen")
    update_tol = (0.25, 1e-2) if bn == "exact" else (5e-2, 5e-2)
    jcfg = jtrain.TrainConfig(
        dataset_config=jtrain.CameraCubePoseDatasetConfig(dataset, center_crop=(32, 32)),
        model_config=JaxConfig(**model), batch_size=4, n_epochs=2, num_workers=1, device_resident_mb=0,
        use_augmentation=False, wandb_log=False, save_dir=str(tmp_path / "jax"), learning_rate=1e-3)
    _, jstate = jtrain.create_train_state(jcfg, jax.random.PRNGKey(3), (32, 32))
    start = jax_save_checkpoint(str(tmp_path / "start.ckpt"), jstate, meta=jtrain.checkpoint_meta(jcfg, (32, 32)))
    _Recorder.runs.clear()
    monkeypatch.setattr(jtrain, "MetricsLogger", _Recorder)
    monkeypatch.setattr(logging_utils, "MetricsLogger", _Recorder)
    jpath = jtrain.train(dataclasses.replace(jcfg, resume_from=start))
    tpath = ttrain.train(_loop_cfg(dataset, tmp_path / "port", model, resume_from=start), device="cpu")
    jrec, trec = (r.records for r in _Recorder.runs)
    assert [s for s, _ in trec] == [s for s, _ in jrec] and len(trec) == 8  # 6 steps, 2 val passes
    for (_, a), (_, b) in zip(trec, jrec):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)

    s0, jend, tend = (tck.load_checkpoint(p) for p in (start, jpath, tpath))
    assert int(tend["step"]) == int(jend["step"]) == 6
    assert int(tend["opt_state"]["1"]["count"]) == int(jend["opt_state"]["1"]["count"]) == 6
    assert float(tend["lr"]) == float(jend["lr"]) == np.float32(1e-3)
    p0, pj, pt = (state_dict_from_variables(t["params"], {}) for t in (s0, jend, tend))
    errs = sorted(((pt[k] - pj[k]).norm() / (pj[k] - p0[k]).norm()).item() for k in pj if (pj[k] - p0[k]).norm() > 0)
    assert len(errs) == len(pj) and errs[-1] <= update_tol[0] and errs[len(errs) // 2] <= update_tol[1], errs[-3:]
    b0, bj, bt = (state_dict_from_variables({}, t["batch_stats"]) for t in (s0, jend, tend))
    if bn == "frozen":
        assert all(torch.equal(bt[k], b0[k]) and torch.equal(bj[k], b0[k]) for k in b0)
        return
    serr = sorted(((bt[k] - bj[k]).norm() / (bj[k] - b0[k]).norm()).item() for k in bj)
    assert serr[-1] <= 2e-2 and serr[len(serr) // 2] <= 1e-3, serr[-3:]
