"""Validation on the CPU: the port's `validate` and `validate_real` against
argus_tpu's on the same checkpoints (argus_tpu's `create_train_state`, BN
buffers and scales perturbed) and the same data, for both model families.
Each test points both packages' `ROOT` at its temporary directory, so that
no figure lands under the repository's `outputs/`.

`validate` runs the val split with `num_spaghetti=0`: its arcs (drawn on
the val split as the dataset draws them) and the train split's
augmentation come from each package's own random numbers, so those runs
are held to finite losses and their figures. Per-example losses against
argus_tpu's: 1e-4 relative (f32 convs summed in other orders; the keypoint
fit's SVD amplifies that a little). `validate_real`'s poses come from
`make_pose_estimator` against argus_tpu's on the real-capture fixture's
noise frames: 1e-4, quaternions up to sign."""

import os

import numpy as np
import pytest

os.environ.setdefault("MUJOCO_GL", "egl")  # before mujoco's import (conftest sets it too)
mujoco = pytest.importorskip("mujoco")

import argus_tpu.validate as jax_validate  # noqa: E402
import argus_tpu.validate_real as jax_validate_real  # noqa: E402
import argus_tpu_torch.validate as port_validate  # noqa: E402
import argus_tpu_torch.validate_real as port_validate_real  # noqa: E402
from argus_tpu.data import CameraCubePoseDatasetConfig as JaxDatasetConfig  # noqa: E402
from argus_tpu.ops.augment import AugmentationConfig as JaxAugmentationConfig  # noqa: E402
from argus_tpu_torch.data import CameraCubePoseDatasetConfig  # noqa: E402
from argus_tpu_torch.ops.augment import AugmentationConfig  # noqa: E402
from _torch_threads import _two_threads  # noqa: E402, F401  (autouse, this module)
from test_torch_export import HW, _assert_poses_close, _keypoint_ckpt, _pose_cnn_ckpt  # noqa: E402

FAMILIES = {"pose_cnn": _pose_cnn_ckpt, "keypoint": _keypoint_ckpt}


@pytest.fixture(scope="module", params=list(FAMILIES))
def checkpoint(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp(request.param) / f"{request.param}.ckpt")
    FAMILIES[request.param](path)
    return request.param, path


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    from argus_tpu.data.synthetic import write_synthetic_dataset

    d = tmp_path_factory.mktemp("vds")
    write_synthetic_dataset(str(d), n_train=2, n_test=3, height=HW, width=HW, seed=0)
    return str(d)


@pytest.fixture
def roots(tmp_path, monkeypatch):
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setattr(port_validate, "ROOT", str(port))
    monkeypatch.setattr(port_validate_real, "ROOT", str(port))
    monkeypatch.setattr(jax_validate, "ROOT", str(jax_root))
    monkeypatch.setattr(jax_validate_real, "ROOT", str(jax_root))
    return port, jax_root


def test_validate_matches_argus_tpu(checkpoint, dataset_dir, roots):
    family, ckpt = checkpoint
    got = port_validate.validate(port_validate.ValConfig(
        model_path=ckpt, dataset_config=CameraCubePoseDatasetConfig(dataset_dir, center_crop=(HW, HW)),
        aug_config=AugmentationConfig(num_spaghetti=0), max_examples=3), device="cpu")
    want = jax_validate.validate(jax_validate.ValConfig(
        model_path=ckpt, dataset_config=JaxDatasetConfig(dataset_dir, center_crop=(HW, HW)),
        aug_config=JaxAugmentationConfig(num_spaghetti=0), max_examples=3))
    assert len(got["losses"]) == 3 and np.all(np.isfinite(got["losses"]))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["output_path"] == str(roots[0] / "outputs" / "validation_visuals" / family)
    for name in ("example_0.png", "example_2.png", "loss_histogram.png"):
        assert os.path.exists(os.path.join(got["output_path"], name))


@pytest.mark.parametrize("use_train", [True, False])
def test_validate_augmented_runs(checkpoint, dataset_dir, roots, use_train):
    """The train split through the whole augmentation stack, and the val
    split with argus_tpu's default 10 arcs: finite losses, figures written;
    `validation_step` gives example 1's loss again for its key."""
    from argus_tpu_torch.data import CameraCubePoseDataset
    from argus_tpu_torch.models.keypoint_net import nominal_camera_matrices
    from argus_tpu_torch.ops.augment import fold_in
    from argus_tpu_torch.serve import load_model

    family, ckpt = checkpoint
    cfg = port_validate.ValConfig(model_path=ckpt, dataset_config=CameraCubePoseDatasetConfig(dataset_dir,
                                                                                              center_crop=(HW, HW)),
                                  use_train=use_train, max_examples=2, seed=3)
    got = port_validate.validate(cfg, device="cpu")
    assert len(got["losses"]) == 2 and np.all(np.isfinite(got["losses"]))
    assert os.path.exists(os.path.join(got["output_path"], "example_1.png"))
    assert ("train_visuals" if use_train else "validation_visuals") in got["output_path"]
    example = CameraCubePoseDataset(cfg.dataset_config, train=use_train)[1]
    model, _, model_type, _ = load_model(ckpt)
    model.eval().backbone.fold_frozen_bn()
    _, _, loss = port_validate.validation_step(model, model_type, example["images"][None],
                                               example["cube_pose"][None], fold_in(3, 1), cfg.aug_config, use_train,
                                               nominal_camera_matrices(HW, HW) if family == "keypoint" else None)
    np.testing.assert_allclose(float(loss[0]), got["losses"][1], rtol=1e-6)


def test_val_config_resolves_paths_against_root(checkpoint, dataset_dir, roots, monkeypatch):
    _, ckpt = checkpoint
    monkeypatch.setattr(port_validate, "ROOT", os.path.dirname(ckpt))
    cfg = port_validate.ValConfig(model_path=os.path.basename(ckpt),
                                  dataset_config=CameraCubePoseDatasetConfig(dataset_dir))
    assert cfg.model_path == ckpt
    with pytest.raises(FileNotFoundError, match="outputs/models"):
        port_validate.ValConfig(model_path="no_such.ckpt", dataset_config=CameraCubePoseDatasetConfig(dataset_dir))


@pytest.fixture(scope="module")
def real_data_dir(tmp_path_factory):
    """Flat real-capture dataset: top-level img_stems, no train/test groups,
    no labels (a copy of tests/test_validate_real.py's fixture)."""
    import h5py
    from PIL import Image

    d = tmp_path_factory.mktemp("real")
    (d / "img").mkdir()
    rng = np.random.default_rng(0)
    stems = []
    for i in range(2):
        for sfx in ("a", "b"):
            arr = (rng.random((256, 256, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"img/img{i}_{sfx}.png")
        stems.append(f"img/img{i}")
    with h5py.File(d / f"{d.name}.hdf5", "w") as f:
        f.create_dataset("img_stems", data=np.array([s.encode() for s in stems]))
    return str(d)


def test_validate_real_matches_argus_tpu(checkpoint, real_data_dir, roots):
    import jax.numpy as jnp

    from argus_tpu.checkpoint import load_checkpoint_with_meta
    from argus_tpu.models import resolve_model
    from argus_tpu_torch.data.dataset import _center_crop_np, _decode_png
    from argus_tpu_torch.serve import load_model

    family, ckpt = checkpoint
    scene = port_validate_real.ValRealConfig.__dataclass_fields__["mujoco_xml"].default  # the repo's scene

    # the estimators on the fixture's frames, as validate_real feeds them
    raw, meta = load_checkpoint_with_meta(ckpt)
    jax_model, _, jax_type = resolve_model(meta)
    want_est = jax_validate_real.make_pose_estimator(
        jax_model, {"params": raw["params"], "batch_stats": raw["batch_stats"]}, model_type=jax_type, crop=(256, 256))
    model, _, model_type, _ = load_model(ckpt)
    got_est = port_validate_real.make_pose_estimator(model, "cpu", model_type=model_type, crop=(256, 256))
    assert got_est.batch_size == 1 and model_type == jax_type == family
    for i in range(2):
        pair = [_center_crop_np(_decode_png(f"{real_data_dir}/img/img{i}_{sfx}.png"), (256, 256)) for sfx in "ab"]
        frames = np.concatenate(pair, axis=-1)[None]
        got = got_est.predict(frames)
        assert got.shape == (1, 7) and np.all(np.isfinite(got))
        _assert_poses_close(got, np.asarray(want_est(jnp.asarray(frames))), 1e-4)

    out_dir = port_validate_real.validate_real(port_validate_real.ValRealConfig(
        model_path=ckpt, dataset_config=CameraCubePoseDatasetConfig(real_data_dir, center_crop=(256, 256)),
        mujoco_xml=scene), device="cpu")
    assert out_dir == str(roots[0] / "outputs" / "real_validation_visuals" / family)
    for name in ("example_0.png", "example_1.png", "real_validation.gif"):
        assert os.path.exists(os.path.join(out_dir, name))
