"""The keypoint family of the port (argus_tpu_torch.models.keypoint_net and
its train step) against argus_tpu's, on the CPU.

Geometry and pose fit, f32, on the same numpy inputs: `matrix_to_quat`
(including rotations within 1e-3 rad of 180 degrees), the nominal cameras,
projection, DLT triangulation, Procrustes and `fit_pose` (poses compared,
quaternions up to sign; the SVD's singular vectors may differ in sign
between LAPACK builds, the rotation does not), `keypoint_loss_fn` and its
gradient. Tolerances: 1e-5 relative where both sides do the same f32
arithmetic; 1e-4 through the 3x3 solve and SVD.

The model: `CubeKeypointNet` (resnet18, head_features 32, 64x64, 2 rows x
2 cameras, every BN buffer and scale and the head's LayerNorms randomised)
through the weight bridge: the eval forward in f32 and bf16, the port fused
(`fuse_block`/`fuse_stem` "on", frozen BN; the kernels' plain versions on
the CPU) against the port unfused, and the loss gradient against argus_tpu
in f32.

The train step: one step of the port's `make_train_step` on the fused
frozen-BN configuration of the keypoint bring-up (frozen BN + affine +
stem, `fuse_block`/`fuse_stem` "on", full backprop) against argus_tpu's
`make_train_step_body` with its BasicBlock and stem kernels in Pallas
interpret mode, in f32 and bf16 (`amp`), compared leaf by leaf as in
tests/test_torch_train.py. Tolerances there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu import geom as jgeom
from argus_tpu.models import keypoint_net as jkp
from argus_tpu.ops.pallas import basic_fused as jbf
from argus_tpu.ops.pallas import block_fused as jb
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu.train import TrainConfig as JaxTrainConfig
from argus_tpu.train import TrainState as JaxTrainState
from argus_tpu.train import make_optimizer as jax_make_optimizer
from argus_tpu.train import make_train_step_body
from argus_tpu_torch import geom
from argus_tpu_torch.models import keypoint_net as tkp
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.models.keypoint_net import CubeKeypointNet, CubeKeypointNetConfig
from argus_tpu_torch.ops.norm import BatchNorm
from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

HW = 64
LR = 1e-4
FROZEN = dict(bn_frozen=True, bn_frozen_affine=True, stem_frozen=True)
FUSED = dict(FROZEN, fuse_block="on", fuse_stem="on")
SMALL = dict(head_features=32)


# ───────────────────────────── geometry ─────────────────────────────


def _rotations(rng, n):
    """Rotation matrices at angles over [0, pi], exact identities and angles
    within 1e-3 of pi (where the trace candidate vanishes and another
    diagonal one takes over)."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0, np.pi, n)
    angle[:2] = 0.0
    angle[2:10] = np.pi - rng.uniform(0, 1e-3, 8)
    axis[2:5] = np.eye(3)  # about each axis: that diagonal entry dominates
    q = np.concatenate([axis * np.sin(angle / 2)[:, None], np.cos(angle / 2)[:, None]], axis=1)
    x, y, z, w = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    return R.astype(np.float32), q.astype(np.float32)


def _same_quat(got, want, atol):
    """xyzw quaternions equal up to sign."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert d.max() <= atol, d.max()


def test_matrix_to_quat_matches_argus_tpu():
    rng = np.random.default_rng(0)
    R, q = _rotations(rng, 64)
    want = np.asarray(jgeom.matrix_to_quat(jnp.asarray(R)))
    got = geom.matrix_to_quat(torch.from_numpy(R)).numpy()
    assert (got[:, 3] >= 0).all()
    away = np.abs(q[:, 3]) > 1e-3  # away from w = 0 the canonical sign is the same on both sides
    np.testing.assert_allclose(got[away], want[away], atol=1e-6)
    _same_quat(got, want, 1e-6)
    _same_quat(got, q, 1e-5)


def test_nominal_cameras_match_argus_tpu():
    pose = np.array([[0.1, -0.2, 0.3, 0.2, -0.1, 0.3, 0.9]])
    np.testing.assert_array_equal(geom.convert_pose_unity_to_mjpc(pose.copy()),
                                  jgeom.convert_pose_unity_to_mjpc(pose.copy()))
    for hw in ((256, 256), (64, 96)):
        got = tkp.nominal_camera_matrices(*hw)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jkp.nominal_camera_matrices(*hw)))


def _poses(rng, n):
    """Cube poses in view of the nominal cameras, non-identity rotations."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.2, 3.0, (n, 1))
    t = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.02, (n, 3))
    return np.concatenate([t, axis * np.sin(angle / 2), np.cos(angle / 2)], 1).astype(np.float32)


def test_projection_triangulation_and_fit_match_argus_tpu():
    rng = np.random.default_rng(1)
    P = np.asarray(jkp.nominal_camera_matrices(HW, HW))
    poses = _poses(rng, 16)
    corners = np.asarray(jkp.cube_corners())
    np.testing.assert_array_equal(tkp.cube_corners().numpy(), corners)
    world = np.asarray(jgeom.quat_rotate(jnp.asarray(poses[:, None, 3:]), jnp.asarray(corners[None]))) \
        + poses[:, None, :3]
    want_uv = np.asarray(jkp.project_points(jnp.asarray(P[None]), jnp.asarray(world[:, None])))
    got_uv = tkp.project_points(torch.from_numpy(P[None]), torch.from_numpy(world[:, None])).numpy()
    assert got_uv.shape == (16, 2, 8, 2)
    np.testing.assert_allclose(got_uv, want_uv, rtol=1e-5, atol=1e-4)

    uv = (want_uv + rng.normal(0, 0.5, want_uv.shape)).astype(np.float32)  # detector noise, pixels
    want_pts = np.asarray(jkp.triangulate_points(jnp.asarray(P), jnp.asarray(uv)))
    got_pts = tkp.triangulate_points(torch.from_numpy(P), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got_pts, want_pts, rtol=1e-4, atol=1e-5)

    want = np.asarray(jkp.procrustes_pose(jnp.asarray(corners), jnp.asarray(want_pts)))
    got = tkp.procrustes_pose(torch.from_numpy(corners), torch.from_numpy(want_pts)).numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-5)
    _same_quat(got[:, 3:], want[:, 3:], 1e-4)

    want = np.asarray(jkp.fit_pose(jnp.asarray(P), jnp.asarray(uv)))
    got = tkp.fit_pose(torch.from_numpy(P), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=1e-5)
    _same_quat(got[:, 3:], want[:, 3:], 1e-4)
    # noiseless corners give back the pose
    exact = tkp.fit_pose(torch.from_numpy(P), torch.from_numpy(want_uv)).numpy()
    np.testing.assert_allclose(exact[:, :3], poses[:, :3], atol=2e-4)
    _same_quat(exact[:, 3:], poses[:, 3:], 2e-3)


def test_keypoint_loss_values_and_gradients_match_argus_tpu():
    rng = np.random.default_rng(2)
    P = np.asarray(jkp.nominal_camera_matrices(HW, HW))
    poses = _poses(rng, 8)
    uv = rng.uniform(0, HW, (8, 2, 8, 2)).astype(np.float32)
    loss = lambda u: jnp.sum(jkp.keypoint_loss_fn(u, jnp.asarray(poses), jnp.asarray(P)))  # noqa: E731
    want, jgrad = jax.value_and_grad(loss)(jnp.asarray(uv))
    tuv = torch.from_numpy(uv).requires_grad_()
    got = tkp.keypoint_loss_fn(tuv, torch.from_numpy(poses), torch.from_numpy(P))
    assert got.shape == (8,) and got.dtype == torch.float32
    (tgrad,) = torch.autograd.grad(got.sum(), tuv)
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(jkp.keypoint_loss_fn(jnp.asarray(uv), jnp.asarray(poses), jnp.asarray(P))), rtol=1e-5
    )
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


# ───────────────────────────── the model ─────────────────────────────

# The heatmap conv's bias shifts every logit of a corner's map alike, which
# the spatial softmax cancels: its true gradient is zero, and what either
# side computes is rounding noise. It is held to that, not compared.
SHIFT_INVARIANT = "heatmap.bias"


def _randomize_(model, seed):
    """Random BN buffers and scales (each block's last BN, BatchNorm_1, at a
    smaller scale so the residual stack keeps activations O(1)), random
    LayerNorm scales and biases, lecun-normal conv weights, small biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                lo, hi = (0.2, 0.5) if name.endswith("BatchNorm_1") else (0.5, 1.5)
                mod.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
            elif isinstance(mod, tkp.HeadLayerNorm):
                c = mod.weight.shape[0]
                mod.weight.copy_(0.5 + torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
            elif isinstance(getattr(mod, "weight", None), torch.nn.Parameter):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=g))


def _model(dtype="float32", **kw):
    model = CubeKeypointNet(CubeKeypointNetConfig(**SMALL, dtype=dtype, **kw))
    _randomize_(model, seed=0)
    return model


def _jax_apply(model, dtype="float32", **kw):
    """argus_tpu's CubeKeypointNet with the port model's weights."""
    params, stats = variables_from_state_dict(model.state_dict())
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    return jkp.CubeKeypointNet(jkp.CubeKeypointNetConfig(**SMALL, dtype=dtype, **kw)), variables


def _images(n=2, seed=3):
    return np.random.default_rng(seed).uniform(0, 1, (n, HW, HW, 6)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_argus_tpu(dtype):
    """uv in pixels and the heatmaps. bf16: both sides round the backbone's
    and the head's convs, the LayerNorm output and the residual adds at the
    same points, but each rounding of an f32 sum taken in another order may
    land one bf16 ulp apart and the ulps accumulate through 20 layers: uv
    within 0.5 pixel (the heatmap cell is 8 pixels), heatmaps within 1e-3
    absolute (measured 0.13 px and 1.3e-4); f32: 1e-3 px and 1e-6."""
    model = _model(dtype)
    jm, variables = _jax_apply(model, dtype)
    x = _images()
    juv, jprobs = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        uv, probs = model(torch.from_numpy(x))
    assert uv.shape == (2, 2, 8, 2) and probs.shape == (4, 8, 8, 8)
    assert uv.dtype == probs.dtype == torch.float32
    tol = (1e-3, 1e-6) if dtype == "float32" else (0.5, 1e-3)
    np.testing.assert_allclose(uv.numpy(), np.asarray(juv), atol=tol[0], rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=tol[1], rtol=0)


def test_fused_model_matches_unfused_port():
    """The fused wiring (stem kernel, five identity BasicBlock kernels on
    folded weights, the strided blocks unfused) against the unfused port on
    the same weights, f32: the training forward's uv and the loss gradient
    of every conv kernel (the folded fused path differentiates through the
    fold), and the eval forward from the fold cache."""
    fused, plain = _model(**FUSED), _model(**FROZEN)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(_images())
    P = tkp.nominal_camera_matrices(HW, HW)
    poses = torch.from_numpy(_poses(np.random.default_rng(4), 2))
    grads = []
    for m in (fused, plain):
        uv, _ = m(x, train=True)
        loss = tkp.keypoint_loss_fn(uv, poses, P).mean()
        names = [k for k, p in m.named_parameters() if "Conv_" in k or "conv_proj" in k or "up" in k]
        grads.append((uv.detach(), dict(zip(names, torch.autograd.grad(loss, [dict(m.named_parameters())[k]
                                                                              for k in names], allow_unused=True)))))
    (uv_f, g_f), (uv_p, g_p) = grads
    torch.testing.assert_close(uv_f, uv_p, rtol=0, atol=1e-3)
    for k, want in g_p.items():
        got = g_f[k]
        if "conv_init" in k:  # frozen stem: no gradient on either path
            assert got is None and want is None, k
            continue
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5 * want.abs().max().item(), msg=k)
    fused.backbone.fold_frozen_bn()
    assert sorted(fused.backbone._folded) == ["stage0_block0", "stage0_block1", "stage1_block1", "stage2_block1",
                                              "stage3_block1", "stem"]
    with torch.no_grad():
        torch.testing.assert_close(fused(x)[0], uv_p, rtol=0, atol=1e-3)


def test_loss_gradients_match_argus_tpu():
    """d keypoint_loss / d params of the frozen-BN model (train=True, fuse
    off on both sides), f32, against jax.grad: every trained leaf within
    1e-3 relative (2-norm), the frozen BN affine and stem without gradient."""
    model = _model(**FROZEN)
    jm, variables = _jax_apply(model, **FROZEN)
    x = _images()
    poses = _poses(np.random.default_rng(5), 2)
    P = jkp.nominal_camera_matrices(HW, HW)

    def loss(params):
        (uv, _), _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
                              train=True, mutable=["batch_stats"])
        return jnp.mean(jkp.keypoint_loss_fn(uv, jnp.asarray(poses), P))

    want, jgrads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want_sd = state_dict_from_variables(jax.device_get(jgrads), {})
    uv, _ = model(torch.from_numpy(x), train=True)
    got = tkp.keypoint_loss_fn(uv, torch.from_numpy(poses), tkp.nominal_camera_matrices(HW, HW)).mean()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    params = dict(model.named_parameters())
    tgrads = torch.autograd.grad(got, list(params.values()), allow_unused=True)
    scale = tgrads[list(params).index("heatmap.weight")].abs().max().item()
    for (k, p), gk in zip(params.items(), tgrads):
        w = want_sd[k]
        if k == SHIFT_INVARIANT:
            assert gk.abs().max().item() <= 1e-5 * scale and w.abs().max().item() <= 1e-5 * scale
            continue
        if torch.count_nonzero(w) == 0:
            assert gk is None or torch.count_nonzero(gk) == 0, k
            continue
        assert ".BatchNorm" not in k and "norm_" not in k and "conv_init" not in k, k
        rel = ((gk - w).norm() / w.norm()).item()
        assert rel <= 1e-3, (k, rel)


# ───────────────────────────── the train step ─────────────────────────────

# per dtype (amp): loss; then (max per leaf, median over leaves) for the
# moments and for the params' update after the step.
# - f32: the same f32 sums in another order: moments 1e-3 (measured 1.0e-5);
#   updates 1e-3 in the median (measured 5.7e-5) and 0.2 per leaf (measured
#   0.080, up_norm1.bias): Adam's first step is close to lr * sign(g), and
#   much of that bias's gradient cancels in the spatial softmax like the
#   heatmap bias's, so an element whose gradient is all but zero moves by a
#   different amount.
# - bf16: each rounding of an f32 sum taken in another order may land one
#   ulp apart and the ulps accumulate through 20 layers each way: loss 1e-2
#   (measured 4.9e-4), moments 0.4 per leaf and 0.15 in the median
#   (measured 0.31 / 0.080; argus_tpu's own bf16 moments sit 0.17 / 0.097
#   from its f32 ones), updates 0.6 and 0.4 (measured 0.50 / 0.26;
#   argus_tpu's own gap 0.50 / 0.35).
TOL = {
    False: dict(loss=1e-5, moments=(1e-3, 1e-3), update=(0.2, 1e-3)),
    True: dict(loss=1e-2, moments=(0.4, 0.15), update=(0.6, 0.4)),
}


def _batch():
    rng = np.random.default_rng(6)
    return {
        "images": rng.integers(0, 256, (2, HW, HW, 6), dtype=np.uint8),
        "cube_pose": _poses(rng, 2),
        "mask": np.array([1.0, 0.0], np.float32),  # the second row is padding
    }


def _port(amp):
    cfg = TrainConfig(model_type="keypoint", keypoint_config=CubeKeypointNetConfig(**SMALL, **FUSED), amp=amp,
                      use_augmentation=False, learning_rate=LR)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    _randomize_(model, seed=1)
    return cfg, model, state


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """argus_tpu's loss, Adam state and params after one step of the
    keypoint train step (BasicBlock and stem kernels in Pallas interpret
    mode: `basic_fused` imports `_use_pallas` by name, so it is patched
    there too), from the port's initial state converted; once per dtype."""
    cache = {}

    def run(amp):
        if amp in cache:
            return cache[amp]
        cfg, model, _ = _port(amp)
        params, stats = variables_from_state_dict(model.state_dict())
        jkcfg = jkp.CubeKeypointNetConfig(**SMALL, **FUSED)
        jcfg = JaxTrainConfig(model_type="keypoint", keypoint_config=jkcfg, amp=amp, use_augmentation=False,
                              learning_rate=LR, wandb_log=False, save_dir=str(tmp_path_factory.mktemp("save")))
        jmodel = jkp.CubeKeypointNet(dataclasses.replace(jkcfg, dtype="bfloat16" if amp else "float32"))
        params = jax.tree_util.tree_map(jnp.asarray, params)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
            opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32),
        )
        hits = []
        with pytest.MonkeyPatch.context() as mp:
            for mod in (jb, jbf, js):
                mp.setattr(mod, "_use_pallas", lambda impl: impl != "xla")
            orig = jbf._fwd_pallas
            mp.setattr(jbf, "_fwd_pallas", lambda *a, **k: (hits.append(k.get("save")), orig(*a, **k))[1])
            step = jax.jit(make_train_step_body(jmodel, jcfg, 0, hw=(HW, HW)))
            state, loss = step(state, jax.tree_util.tree_map(jnp.asarray, _batch()))
        assert hits.count(True) == 5, hits  # the five identity blocks took the saving Pallas kernel
        adam = state.opt_state[1]
        cache[amp] = (float(loss), adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu)),
                      state_dict_from_variables(jax.device_get(state.params), {}))
        return cache[amp]

    return run


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_keypoint_train_step_matches_argus_tpu(reference, amp):
    from test_torch_train import _check_leaves

    w_loss, (w_count, w_mu, w_nu), w_params = reference(amp)
    cfg, model, state = _port(amp)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state, loss = make_train_step(model, cfg, hw=(HW, HW), device="cpu")(state, _batch())
    tol = TOL[amp]
    assert abs(float(loss) - w_loss) <= tol["loss"] * abs(w_loss), (float(loss), w_loss)
    assert int(state.opt_state.count) == int(w_count) == 1
    compared = lambda d: {k: v for k, v in d.items() if k != SHIFT_INVARIANT}  # noqa: E731
    _check_leaves(state.opt_state.mu, compared(w_mu), tol["moments"], "mu")
    _check_leaves(state.opt_state.nu, compared(w_nu), tol["moments"], "nu")
    _check_leaves(model.state_dict(), compared(w_params), tol["update"], "update", p0)
    for k, v in state.opt_state.mu.items():  # the frozen parts got no gradient
        if ".BatchNorm" in k or "norm_proj" in k or "norm_init" in k or "conv_init" in k:
            assert torch.count_nonzero(v) == 0, k
        elif k.startswith(("up", "heatmap")):
            assert torch.count_nonzero(v) > 0, k
