"""The exported serving program on the CPU: `export_estimator` ->
`ExportedEstimator` against the port's `Estimator` and against argus_tpu's
`export_estimator` / `ExportedEstimator` on the same format-2 checkpoint
(argus_tpu's `create_train_state`, BN buffers and scales perturbed), for
both model families; the batched program's `argus::` ops; a load in a
process without the model code; and `Estimator.predict` at a second batch
shape.

Tolerances: the exported program against the estimator it came from 1e-6
(the same ops on the same inputs); against argus_tpu's exported program
1e-4, as `tests/test_torch_serve.py` holds the f32 estimators (f32 sums in
another order), the keypoint family's quaternions up to sign."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.models.keypoint_net import CubeKeypointNetConfig as JaxKeypointConfig
from argus_tpu.serve import ExportedEstimator as JaxExportedEstimator
from argus_tpu.serve import export_estimator as jax_export_estimator
from argus_tpu.train import TrainConfig, build_model, checkpoint_meta, create_train_state
from argus_tpu_torch.checkpoint import save_checkpoint
from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
from argus_tpu_torch.models.jax_import import variables_from_state_dict
from argus_tpu_torch.serve import Estimator, ExportedEstimator, export_estimator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 64
SERVING_OPS = {"argus.stem_fwd.default", "argus.stage_fwd.default", "argus.projection_block.default",
               "argus.bottleneck_block.default"}


def _perturbed(tree, rng):
    def f(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


def _pose_cnn_ckpt(path):
    cfg = TrainConfig(model_config=JaxConfig(n_cams=2, backbone="resnet18", resnet_output_dim=16), wandb_log=False)
    _, state = create_train_state(cfg, jax.random.PRNGKey(0), (HW, HW))
    rng = np.random.default_rng(0)
    state = state.replace(params=_perturbed(state.params, rng), batch_stats=_perturbed(state.batch_stats, rng))
    meta = checkpoint_meta(cfg)
    meta["center_crop"] = [HW, HW]
    jax_save_checkpoint(path, state, meta=meta)


def _keypoint_ckpt(path):
    cfg = TrainConfig(model_type="keypoint", keypoint_config=JaxKeypointConfig(head_features=16), wandb_log=False)
    model, _ = build_model(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 6), jnp.float32))
    rng = np.random.default_rng(1)
    tree = {"params": _perturbed(variables["params"], rng), "batch_stats": _perturbed(variables["batch_stats"], rng)}
    jax_save_checkpoint(path, tree, meta=checkpoint_meta(cfg, hw=(HW, HW)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs six files at once on the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{family: (checkpoint, the port's batch-1 artifact)} of both families."""
    out = {}
    for family, make in (("pose_cnn", _pose_cnn_ckpt), ("keypoint", _keypoint_ckpt)):
        d = tmp_path_factory.mktemp(family)
        ckpt, path = str(d / "model.ckpt"), str(d / "model.pt2")
        make(ckpt)
        export_estimator(ckpt, path, device="cpu")
        out[family] = (ckpt, path)
    return out


FAMILIES = ("pose_cnn", "keypoint")


def _frames(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 6), dtype=np.uint8)


def _assert_poses_close(got, want, atol):
    """Translations within atol, quaternions within atol up to sign."""
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=atol, rtol=0)
    flip = np.where(np.sum(got[:, 3:] * want[:, 3:], -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got[:, 3:], flip * want[:, 3:], atol=atol, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_batch1_export_matches_the_estimator_and_argus_tpu(artifacts, family, tmp_path):
    ckpt, path = artifacts[family]
    loaded = ExportedEstimator(path, device="cpu")
    assert (loaded.batch_size, loaded.height, loaded.width, loaded.channels) == (1, HW, HW, 6)
    est = Estimator(ckpt, batch_size=1, device="cpu")
    assert est.model_type == family
    jax_path = str(tmp_path / "jax.bin")
    jax_export_estimator(ckpt, jax_path)
    jax_loaded = JaxExportedEstimator(jax_path)
    for seed in (1, 2):
        frames = _frames(1, seed)
        got = loaded.predict(frames)
        assert got.shape == (1, 7) and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, est.predict(frames), atol=1e-6, rtol=0)
        _assert_poses_close(got, jax_loaded.predict(frames), 1e-4)
    wxyz = loaded.predict(frames, wxyz=True)
    np.testing.assert_array_equal(wxyz[:, 3], got[:, 6])
    with pytest.raises(ValueError):
        loaded.predict(_frames(2))  # the program's shape is fixed
    with pytest.raises(ValueError):
        loaded.predict(frames.astype(np.float32))


def test_batched_export_holds_the_serving_ops(tmp_path):
    """Batch 8, bf16 and folded BN, the fuse flags "on": the exported graph
    holds the four serving ops, one node each per kernel call (their plain
    versions run here), and its poses equal the estimator's."""
    cfg = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=16)
    torch.manual_seed(0)
    params, stats = variables_from_state_dict(NCameraCNN(cfg).state_dict())
    ckpt = str(tmp_path / "r50.ckpt")
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats},
                    meta={"model_type": "pose_cnn", "model_config": dataclasses.asdict(cfg), "center_crop": [HW, HW]})
    est = Estimator(ckpt, batch_size=8, device="cpu")
    assert est.cfg.dtype == "bfloat16"
    for k in ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage"):  # "auto" is off on the CPU
        setattr(est.model.backbone, k, "on")
    path = str(tmp_path / "r50.pt2")
    est.export(path)
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes if n.op == "call_function"]
    counts = {op: targets.count(op) for op in SERVING_OPS}
    # the stem, the stage-0 chain, stages 1-3's projections and 2 + 5 + 2 identity blocks
    assert counts == {"argus.stem_fwd.default": 1, "argus.stage_fwd.default": 1,
                      "argus.projection_block.default": 3, "argus.bottleneck_block.default": 10}
    frames = _frames(8, seed=3)
    got = ExportedEstimator(path, device="cpu").predict(frames)
    np.testing.assert_allclose(got, est.predict(frames), atol=1e-6, rtol=0)


_LOAD_ALONE = textwrap.dedent(
    """
    import sys
    import numpy as np
    from argus_tpu_torch.serve import ExportedEstimator

    frames = np.load(sys.argv[1])
    for path in sys.argv[2:]:
        np.save(path + ".poses.npy", ExportedEstimator(path, device="cpu").predict(frames))
    loaded = sorted(m for m in sys.modules if m.startswith(("argus_tpu_torch.models", "argus_tpu_torch.checkpoint",
                                                             "jax", "argus_tpu.")))
    assert not loaded, loaded
    """
)


def test_exported_loads_without_model_code(artifacts, tmp_path):
    """Another process loads both families' artifacts with no checkpoint
    and no module of `argus_tpu_torch.models` (nor JAX) imported, and
    predicts the same poses."""
    frames = _frames(1, seed=5)
    np.save(tmp_path / "frames.npy", frames)
    paths = [path for _, path in artifacts.values()]
    proc = subprocess.run([sys.executable, "-c", _LOAD_ALONE, str(tmp_path / "frames.npy"), *paths], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for path in paths:
        np.testing.assert_allclose(np.load(path + ".poses.npy"), ExportedEstimator(path, device="cpu").predict(frames),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_estimator_predicts_a_second_shape(artifacts, family):
    """The batch-1 estimator takes a batch of 3 too (on the card a graph of
    its own): each row's pose that of the row alone, 1e-5 (f32 convs sum a
    batch in other orders)."""
    ckpt, _ = artifacts[family]
    est = Estimator(ckpt, batch_size=1, device="cpu")
    frames = _frames(3, seed=6)
    rows = np.concatenate([est.predict(frames[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(est.predict(frames), rows, atol=1e-5, rtol=0)
