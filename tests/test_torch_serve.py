"""The serving slice end to end on the CPU: argus_tpu's Estimator against the
port's, loading the same format-2 checkpoint (built with argus_tpu's
create_train_state and checkpoint_meta, BN buffers and scales perturbed),
for the NCameraCNN and the keypoint family."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.checkpoint import load_checkpoint_with_meta, save_checkpoint
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.models.keypoint_net import CubeKeypointNetConfig as JaxKeypointConfig
from argus_tpu.models import resolve_model as jax_resolve_model
from argus_tpu.serve import Estimator as JaxEstimator
from argus_tpu.serve import serving_tuned_config as jax_serving_tuned_config
from argus_tpu.train import TrainConfig, checkpoint_meta, create_train_state
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models.jax_import import state_dict_from_variables
from argus_tpu_torch.models.pose_cnn import NCameraCNN
from argus_tpu_torch.serve import (
    SERVING_FUSED_MIN_BATCH,
    Estimator,
    latency_tuned_config,
    serving_tuned_config,
    throughput_tuned_config,
)
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

HW = 64


def _perturbed(tree, rng):
    """Every BN scale/bias/mean/var perturbed (the zero-init last-BN scale
    would otherwise hide each block's conv3 behind its identity)."""

    def f(path, x):
        x = np.asarray(x)
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def resnet50_ckpt(tmp_path_factory):
    cfg = TrainConfig(
        model_config=JaxConfig(n_cams=2, backbone="resnet50", resnet_output_dim=32), wandb_log=False
    )
    _, state = create_train_state(cfg, jax.random.PRNGKey(0), (HW, HW))
    rng = np.random.default_rng(0)
    state = state.replace(
        params=_perturbed(state.params, rng), batch_stats=_perturbed(state.batch_stats, rng)
    )
    meta = checkpoint_meta(cfg)
    meta["center_crop"] = [HW, HW]
    path = str(tmp_path_factory.mktemp("serve") / "r50.ckpt")
    save_checkpoint(path, state, meta=meta)
    return path


def _batch(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, HW, HW, 6), dtype=np.uint8)


def test_batched_bf16_estimator_matches_argus_tpu(resnet50_ckpt):
    """Batch 8: both sides switch to bf16, folded frozen BN and every fused
    path (argus_tpu's CPU path runs the kernels' XLA reference math, the
    port's the kernels' plain versions, its flags set "on" where its
    tuned config says "auto").

    Tolerance 2e-2 on poses: the two sides round bf16 at different points
    (argus_tpu's CPU reference rounds each conv output to bf16 before the
    bias add, the port rounds once after it, as the TPU kernels do), about
    37% of a block's outputs land one bf16 ulp apart, and through ResNet-50
    and the head that measured 8.7e-3 at most on these poses, the same size
    as argus_tpu's own bf16-vs-f32 gap (9.0e-3)."""
    jax_est = JaxEstimator(resnet50_ckpt, batch_size=8)
    est = Estimator(resnet50_ckpt, batch_size=8, device="cpu")
    assert est.cfg.dtype == "bfloat16" and est.cfg.fuse_stage == "auto"
    for k in ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage"):  # "auto" is off on the CPU
        setattr(est.model.backbone, k, "on")
    assert est.hw == jax_est.hw == (HW, HW)
    batch = _batch(8)
    got, want = est.predict(batch), jax_est.predict(batch)
    assert got.shape == (8, 7) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:], axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(est.predict(batch, wxyz=True)[:, 3], got[:, 6])


@pytest.fixture(scope="module")
def latency_estimator(resnet50_ckpt):
    """The port's batch-1 Estimator on the checkpoint, made once; the cases
    that use it only predict."""
    return Estimator(resnet50_ckpt, batch_size=1, device="cpu")


def test_latency_f32_estimator_matches_argus_tpu(resnet50_ckpt, latency_estimator):
    """Batch 1: f32, every fused path off, plain convolutions on both sides."""
    jax_est = JaxEstimator(resnet50_ckpt, batch_size=1)
    est = latency_estimator
    assert est.cfg.dtype == "float32" and est.cfg.fuse_block == "off"
    batch = _batch(1, seed=2)
    np.testing.assert_allclose(est.predict(batch), jax_est.predict(batch), atol=1e-4, rtol=0)
    frames = [batch[0, ..., :3], batch[0, ..., 3:]]
    np.testing.assert_allclose(est.predict_frames(frames), jax_est.predict_frames(frames), atol=1e-4)


def test_fused_f32_model_matches_argus_tpu(resnet50_ckpt):
    """The fused wiring at f32 (stem kernel, stage-0 chain, projection and
    identity kernels, folded BN), so rounding cannot hide a wiring fault:
    both models with fuse "on", frozen BN, float32."""
    raw, meta = load_checkpoint_with_meta(resnet50_ckpt)
    model, jcfg, _ = jax_resolve_model(meta)
    jcfg = dataclasses.replace(
        jcfg, bn_frozen=True, bn_frozen_affine=True, fuse_block="on", fuse_proj="on",
        fuse_stem="on", fuse_stage="on",
    )
    images = _batch(2, seed=3).astype(np.float32) / 255.0
    want = type(model)(jcfg).apply(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]}, jnp.asarray(images), train=False
    )
    cfg = NCameraCNNConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    port = NCameraCNN(cfg)
    port.load_state_dict(state_dict_from_variables(raw["params"], raw["batch_stats"], port.state_dict()))
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def test_serving_tuned_config_matches_argus_tpu():
    """argus_tpu's serving configs, except that batched serving's fuse flags
    are "auto" where argus_tpu forces "on": the port's "auto" runs each
    kernel function where the H100 measured it faster (`AUTO_FUSE`)."""
    fuse = ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage")
    for backbone in ("resnet18", "resnet50"):
        jcfg = JaxConfig(n_cams=2, backbone=backbone, resnet_output_dim=16)
        cfg = NCameraCNNConfig(n_cams=2, backbone=backbone, resnet_output_dim=16)
        for bs in (1, SERVING_FUSED_MIN_BATCH - 1, SERVING_FUSED_MIN_BATCH, 256):
            want = dataclasses.asdict(jax_serving_tuned_config(jcfg, bs))
            want.update({k: "auto" for k in fuse if want[k] == "on"})
            assert dataclasses.asdict(serving_tuned_config(cfg, bs)) == want
    hi = throughput_tuned_config(NCameraCNNConfig())
    assert hi.fuse_stem == hi.fuse_stage == "auto" and hi.dtype == "bfloat16"
    assert latency_tuned_config(NCameraCNNConfig()).fuse_pointwise == "off"


@pytest.fixture(scope="module")
def keypoint_ckpt(tmp_path_factory):
    """A keypoint checkpoint as argus_tpu writes it, with the meta of its
    training (resnet18, head_features 32, trained at 64x64): the model's
    variables from a jitted init, every BN and LayerNorm parameter
    perturbed."""
    from argus_tpu.train import build_model

    cfg = TrainConfig(model_type="keypoint", keypoint_config=JaxKeypointConfig(head_features=32), wandb_log=False)
    model, _ = build_model(cfg)
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 6), jnp.float32))
    rng = np.random.default_rng(1)
    tree = {"params": _perturbed(variables["params"], rng), "batch_stats": _perturbed(variables["batch_stats"], rng)}
    path = str(tmp_path_factory.mktemp("serve") / "kp.ckpt")
    save_checkpoint(path, tree, meta=checkpoint_meta(cfg, hw=(HW, HW)))
    return path


@pytest.mark.parametrize("batch_size", [1, 8])
def test_keypoint_estimator_matches_argus_tpu(keypoint_ckpt, batch_size):
    """The keypoint family served: heatmaps, soft-argmax, DLT through the
    nominal cameras at the checkpoint's crop, Procrustes. Batch 1: f32,
    plain convs on both sides; batch 8: bf16 and folded frozen BN, the
    BasicBlock backbone unfused on both sides (argus_tpu's tuner).

    Tolerance on poses (translation in metres, quaternions up to sign):
    f32 1e-4 for both. bf16: translation 1e-3 (measured 6.7e-5), quaternion
    0.1 (measured 0.038). The random weights put every corner near the image
    centre, so the Procrustes rotation is ill-conditioned and amplifies the
    corners' bf16 noise: argus_tpu's own bf16 poses sit up to 9.1e-5 and
    0.074 from its f32 ones on these rows. The two sides round bf16 at the
    same points; an f32 sum taken in another order lands one ulp apart now
    and then."""
    jax_est = JaxEstimator(keypoint_ckpt, batch_size=batch_size)
    est = Estimator(keypoint_ckpt, batch_size=batch_size, device="cpu")
    assert est.model_type == jax_est.model_type == "keypoint"
    assert est.hw == jax_est.hw == (HW, HW)
    assert est.cfg.dtype == ("bfloat16" if batch_size >= SERVING_FUSED_MIN_BATCH else "float32")
    assert est.cfg.fuse_block == "off"
    batch = _batch(batch_size, seed=4)
    got, want = est.predict(batch), jax_est.predict(batch)
    assert got.shape == (batch_size, 7) and np.all(np.isfinite(got))
    atol_t, atol_q = (1e-4, 1e-4) if batch_size == 1 else (1e-3, 0.1)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=atol_t, rtol=0)
    flip = np.where(np.sum(got[:, 3:] * want[:, 3:], -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got[:, 3:], flip * want[:, 3:], atol=atol_q, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:], axis=-1), 1.0, atol=1e-5)


def test_predict_rejects_bad_input(latency_estimator):
    est = latency_estimator
    with pytest.raises(ValueError):
        est.predict(_batch(1).astype(np.float32))
