"""The port's script twins (`scripts/*_torch.py`): each keeps its
original's config fields (plus `device`) and its `main` runs on the CPU at
a tiny size; a verification golden written by `scripts/verify_torch_import.py`
checks under its twin, and one written by the twin checks under the
original."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the machine's cores; more torch threads
    each only oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

TWINS = {  # twin -> (original, config class)
    "timing_torch": ("timing", "TimingConfig"),
    "throughput_torch": ("throughput", "ThroughputConfig"),
    "rotation_overfitting_torch": ("rotation_overfitting", "OverfitConfig"),
    "view_augmentations_torch": ("view_augmentations", "ViewConfig"),
    "verify_torch_import_torch": ("verify_torch_import", "VerifyConfig"),
    "convergence_ab_torch": ("convergence_ab", "ABConfig"),
}


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twin_keeps_the_originals_config(twin):
    original, cls = TWINS[twin]
    ours, theirs = getattr(_script(twin), cls), getattr(_script(original), cls)
    fields = {f.name: f for f in dataclasses.fields(ours)}
    want = {f.name: f for f in dataclasses.fields(theirs)}
    assert list(fields) == list(want) + ["device"]
    assert fields["device"].default == "cuda"
    for name, f in want.items():
        if not dataclasses.is_dataclass(f.default_factory if f.default_factory is not dataclasses.MISSING else None):
            assert fields[name].default == f.default, name


def test_timing_twin_runs():
    mod = _script("timing_torch")
    stats = mod.main(mod.TimingConfig(n_trials=2, batch_size=1, height=32, width=32, backbone="resnet18",
                                      dtype="float32", device="cpu"))
    assert stats["n_trials"] == 2 and stats["p50_ms"] > 0


def test_rotation_overfitting_twin_runs():
    mod = _script("rotation_overfitting_torch")
    for mode, iters in (("mlp", 30), ("resnet", 2)):
        loss = mod.main(mod.OverfitConfig(mode=mode, num_examples=4, n_iters=iters, print_every=10, device="cpu"))
        assert np.isfinite(loss)
    with pytest.raises(ValueError, match="unknown mode"):
        mod.main(mod.OverfitConfig(mode="cnn", device="cpu"))


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from argus_tpu_torch.data import write_synthetic_dataset

    return write_synthetic_dataset(str(tmp_path_factory.mktemp("ds") / "tiny"), n_train=4, n_test=2, height=32,
                                   width=32, seed=0)


def test_throughput_twin_runs(tiny_dataset):
    mod = _script("throughput_torch")
    out = mod.main(mod.ThroughputConfig(batch_size=2, n_steps=2, n_examples=4, height=32, width=32, num_workers=1,
                                        backbone="resnet18", dataset_path=tiny_dataset, device="cpu"))
    assert out["loader_examples_per_sec"] > 0 and out["e2e_examples_per_sec"] > 0


def test_view_augmentations_twin_runs(tiny_dataset, tmp_path):
    from PIL import Image

    mod = _script("view_augmentations_torch")
    mod.main(mod.ViewConfig(dataset_path=tiny_dataset, n_examples=2, output_dir=str(tmp_path), device="cpu"))
    strips = sorted(os.listdir(tmp_path))
    assert strips == ["preview_0.png", "preview_1.png"]
    strip = np.asarray(Image.open(tmp_path / strips[0]))
    assert strip.shape == (32, 4 * 32, 3)
    assert not np.array_equal(strip[:, :32], strip[:, 32:64])  # the augmented panel differs from the raw one


def _abstract_init(sd, backbone, hw):
    """`verify_torch_import.translated_variables` with flax's init traced
    abstractly (zeros of its shapes) instead of run op by op (~12 s on the
    CPU): the translation replaces every leaf of a bare ResNet, so the
    variables are the same."""
    import jax
    import jax.numpy as jnp

    from argus_tpu.models import resnet as R
    from argus_tpu.models.torch_import import load_torch_resnet as jax_load

    model = getattr(R, backbone)(output_dim=None)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    new = jax_load(sd, zeros, backbone_scope="")
    n_zero = sum(not np.any(v) for v in jax.tree_util.tree_leaves(new))
    assert n_zero == 0, f"{n_zero} leaves were not imported"
    return new


def test_verify_goldens_check_across_the_two_scripts(tmp_path, monkeypatch):
    original, twin = _script("verify_torch_import"), _script("verify_torch_import_torch")
    monkeypatch.setattr(original, "translated_variables", _abstract_init)
    kw = dict(selftest=True, selftest_backbone="resnet18", height=32, width=32, batch=2)
    theirs, ours = str(tmp_path / "theirs.npz"), str(tmp_path / "ours.npz")
    assert original.main(original.VerifyConfig(golden_out=theirs, **kw))["ok"]
    assert twin.main(twin.VerifyConfig(golden_out=ours, device="cpu", **kw))["ok"]
    with np.load(theirs) as a, np.load(ours) as b:
        assert sorted(a.files) == sorted(b.files)  # one layout: the same variable paths
        np.testing.assert_array_equal(a["input"], b["input"])
        np.testing.assert_array_equal(a["var:params/conv_init/kernel"], b["var:params/conv_init/kernel"])
    assert twin.main(twin.VerifyConfig(golden_check=theirs, device="cpu"))["ok"]
    assert original.main(original.VerifyConfig(golden_check=ours))["ok"]
    # a recording that disagrees fails the check
    with np.load(ours) as z:
        bad = {k: z[k] for k in z.files}
    bad["features"] = bad["features"] + 1e-2
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(SystemExit):
        twin.main(twin.VerifyConfig(golden_check=str(tmp_path / "bad.npz"), device="cpu"))


def test_convergence_ab_twin_runs(tmp_path, monkeypatch):
    import argus_tpu_torch

    monkeypatch.setattr(argus_tpu_torch, "ROOT", str(tmp_path))  # its dataset and snapshot cache
    mod = _script("convergence_ab_torch")
    out = str(tmp_path / "acc.json")
    cfg = mod.ABConfig(out=out, pretrain_epochs=1, finetune_epochs=1, batch_size=4, n_pretrain=4, n_train=4,
                       n_eval=4, resolution=32, arm_seeds=1, arms="keypoint_frozen", device="cpu")
    result = mod.run(cfg)
    with open(out) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(result))
    assert set(saved["phases"]) == {"pretrain_exact", "pretrain_keypoint", "finetune_keypoint_frozen"}
    s = saved["phases"]["finetune_keypoint_frozen"]
    assert set(s) >= {"rot_deg", "trans_cm", "train_rot_deg", "train_trans_cm", "runs"} and len(s["runs"]) == 1
    assert np.isfinite(s["rot_deg"]["median"]) and "final_lr" in s["runs"][0]
    assert saved["backend"] == "cpu" and saved["protocol"]["scheduler"]["kind"] == "ReduceLROnPlateau"
    snapshots = sorted(os.listdir(tmp_path / "outputs" / "convergence_ab"))
    assert sum(name.endswith(".ckpt") for name in snapshots) == 2  # the two pretrains, cached for later runs
