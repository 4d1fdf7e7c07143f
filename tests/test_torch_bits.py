"""Exact pieces of the port: the checkpoint codec against argus_tpu (both
directions, bit for bit), the weight bridge round trip, and se3_exp against
argus_tpu.geom."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu import checkpoint as jckpt
from argus_tpu import geom as jgeom
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.models.pose_cnn import init_model
from argus_tpu_torch import _msgpack, geom
from argus_tpu_torch import checkpoint as tckpt
from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
from argus_tpu_torch.models.jax_import import state_dict_from_variables, variables_from_state_dict


def _tree(rng):
    """A checkpoint-like tree: nested maps, every array dtype a train state
    holds, numpy scalars, Python scalars, strings, lists, None."""
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32)},
            "dense": {"kernel": rng.normal(size=(5, 2)).astype(np.float32),
                      "bias": np.zeros((2,), np.float32)},
        },
        "step": np.asarray(7, np.int32),
        "lr": np.float32(1e-4),
        "counts": rng.integers(0, 300, (17,)).astype(np.int64),
        "mask": np.array([True, False]),
        "u8": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
        "epoch": 3,
        "big": 2**40,
        "neg": -5000,
        "ratio": 0.25,
        "name": "x" * 40,
        "list": [1, 2.5, "a", None, True],
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_codec_reads_and_rewrites_flax_bytes_exactly():
    from flax import serialization

    tree = _tree(np.random.default_rng(0))
    data = serialization.msgpack_serialize(tree)
    back = _msgpack.restore(data)
    _assert_tree_equal(tree, back)
    assert _msgpack.packb(back) == data


def test_codec_bfloat16_both_ways():
    from flax import serialization

    x = jnp.asarray(np.random.default_rng(1).normal(size=(3, 5)), jnp.bfloat16)
    data = serialization.msgpack_serialize({"w": np.asarray(x)})
    got = _msgpack.restore(data)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(x, np.float32))
    # and the port's bf16 tensor reads back in flax as the same bits
    back = serialization.msgpack_restore(_msgpack.packb({"w": got}))["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32), np.asarray(x, np.float32))


def test_codec_streams_flax_bytes_from_array_views():
    """`dump` writes `packb`'s bytes run by run, the arrays' contents as
    views: empty, 0-d, strided, bool and scalar leaves included."""
    import io

    from flax import serialization

    def ordered(t):  # flax writes a dict's keys sorted, as JAX flattens it
        return {k: ordered(t[k]) for k in sorted(t)} if isinstance(t, dict) else t

    tree = ordered(dict(_tree(np.random.default_rng(2)), empty=np.zeros((0, 3), np.float32),
                        zero_d=np.asarray(2.5, np.float32), strided=np.ones((4, 6), np.float64)[:, ::2],
                        flags=np.array([True, False, True]), scalar=np.float32(1.5)))
    want = serialization.msgpack_serialize(tree)
    f = io.BytesIO()
    _msgpack.dump(tree, f)
    assert f.getvalue() == _msgpack.packb(tree) == want


def test_codec_rejects_trailing_and_truncated_data():
    data = _msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        _msgpack.unpackb(data + b"\x00")
    with pytest.raises(ValueError):
        _msgpack.unpackb(data[:-1])


def test_checkpoint_written_by_argus_tpu_reads_in_port(tmp_path):
    tree = _tree(np.random.default_rng(2))
    meta = {"model_type": "pose_cnn", "model_config": {"fuse_block_stages": (0, 1)},
            "center_crop": (64, 64)}
    path = str(tmp_path / "a.ckpt")
    jckpt.save_checkpoint(path, tree, meta=meta)
    state, got_meta = tckpt.load_checkpoint_with_meta(path)
    from flax import serialization

    # argus_tpu stores the state through flax's to_state_dict (lists become maps)
    _assert_tree_equal(serialization.to_state_dict(tree), state)
    assert got_meta == {"model_type": "pose_cnn", "model_config": {"fuse_block_stages": [0, 1]},
                        "center_crop": [64, 64]}
    # the port writes the same file back, byte for byte
    again = str(tmp_path / "b.ckpt")
    tckpt.save_checkpoint(again, state, meta=got_meta)
    assert open(again, "rb").read() == open(path, "rb").read()


def test_checkpoint_written_by_port_reads_in_argus_tpu(tmp_path):
    tree = _tree(np.random.default_rng(3))
    tree["bf16"] = torch.randn(4, 2, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    path = str(tmp_path / "t.ckpt")
    tckpt.save_checkpoint(path, tree, meta={"model_type": "pose_cnn", "center_crop": (32, 32)})
    state, meta = jckpt.load_checkpoint_with_meta(path)
    assert meta == {"model_type": "pose_cnn", "center_crop": [32, 32]}
    bf16 = state.pop("bf16")
    np.testing.assert_array_equal(np.asarray(bf16, np.float32), tree.pop("bf16").float().numpy())
    _assert_tree_equal(tree, state)


def test_legacy_bare_state_loads(tmp_path):
    from flax import serialization

    path = tmp_path / "legacy.ckpt"
    path.write_bytes(serialization.msgpack_serialize({"params": {"a": np.ones(3, np.float32)}}))
    state, meta = tckpt.load_checkpoint_with_meta(str(path))
    assert meta == {} and list(state) == ["params"]


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50", "keypoint"])
def test_weight_bridge_round_trip_exact(backbone):
    """argus_tpu variables -> the port's state_dict loads strictly into the
    port's model, and converts back to the identical variable tree. The
    keypoint case is CubeKeypointNet (resnet18): the backbone without `fc`,
    the head convs with biases, LayerNorm scale -> weight."""
    if backbone == "keypoint":
        from argus_tpu.models.keypoint_net import CubeKeypointNet as JaxKeypointNet
        from argus_tpu.models.keypoint_net import CubeKeypointNetConfig as JaxKeypointConfig
        from argus_tpu_torch.models import CubeKeypointNet, CubeKeypointNetConfig

        jmodel = JaxKeypointNet(JaxKeypointConfig(head_features=16))
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 6), jnp.float32))
        model = CubeKeypointNet(CubeKeypointNetConfig(head_features=16))
    else:
        cfg = dict(n_cams=2, backbone=backbone, resnet_output_dim=16)
        _, variables = init_model(JaxConfig(**cfg), jax.random.PRNGKey(0), 32, 32)
        model = NCameraCNN(NCameraCNNConfig(**cfg))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    sd = state_dict_from_variables(params, stats, model.state_dict())
    model.load_state_dict(sd, strict=True)
    conv = params["backbone"]["stage1_block0"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(
        model.backbone.stage1_block0.Conv_1.weight.detach().numpy(), conv.transpose(3, 2, 0, 1)
    )
    if backbone == "keypoint":
        np.testing.assert_array_equal(model.up_norm1.weight.detach().numpy(), params["up_norm1"]["scale"])
        np.testing.assert_array_equal(model.up0.bias.detach().numpy(), params["up0"]["bias"])
        np.testing.assert_array_equal(model.heatmap.weight.detach().numpy(),
                                      params["heatmap"]["kernel"].transpose(3, 2, 0, 1))
    p2, s2 = variables_from_state_dict(model.state_dict())
    _assert_tree_equal(params, p2)
    _assert_tree_equal(stats, s2)


def test_weight_bridge_rejects_drift():
    model = NCameraCNN(NCameraCNNConfig(backbone="resnet18", resnet_output_dim=16))
    ref = model.state_dict()
    with pytest.raises(KeyError):
        state_dict_from_variables({"nope": {"kernel": np.zeros((2, 2), np.float32)}}, {}, ref)
    bad = {"head_out": {"kernel": np.zeros((3, 6), np.float32)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        state_dict_from_variables(bad, {}, ref)
    with pytest.raises(KeyError):
        state_dict_from_variables({"x": {"weird": np.zeros(2, np.float32)}}, {})


def test_se3_exp_matches_argus_tpu():
    rng = np.random.default_rng(4)
    tau = rng.normal(0, 1.0, (64, 6)).astype(np.float32)
    tau[:8, 3:] *= 1e-4  # |phi|^2 < 1e-6: the Taylor branches
    tau[8:12, 3:] = 0.0
    tau[12:16, 3:] *= 3.0  # large angles
    want = np.asarray(jgeom.se3_exp(jnp.asarray(tau)))
    got = geom.se3_exp(torch.from_numpy(tau)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        geom.xyzxyzw_to_xyzwxyz_SE3(got), np.asarray(jgeom.xyzxyzw_to_xyzwxyz_SE3(want)), atol=1e-6
    )
    q = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    np.testing.assert_allclose(
        geom.quat_multiply(q, p).numpy(),
        np.asarray(jgeom.quat_multiply(jnp.asarray(q.numpy()), jnp.asarray(p.numpy()))),
        atol=1e-6,
    )


def _poses(rng, n):
    """Random SE(3) 7-vectors with rotation angles spread over [0, pi],
    including exact identities, angles near 0 (the Taylor branches) and near
    pi (where the inverse Jacobian's 1 + cos t and sin t both vanish)."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0, np.pi, n)
    angle[:4] = 0.0
    angle[4:8] = rng.uniform(1e-5, 5e-4, 4)
    angle[8:12] = np.pi - rng.uniform(1e-4, 1e-2, 4)
    q = np.concatenate([axis * np.sin(angle / 2)[:, None], np.cos(angle / 2)[:, None]], axis=1)
    q[12:14] *= -1.0  # w < 0: the same rotation the long way round
    t = rng.normal(0, 0.5, (n, 3))
    return np.concatenate([t, q], axis=1).astype(np.float32)


def test_se3_group_ops_match_argus_tpu():
    """Values in f32: Log, compose, inverse (atol 2e-5 near pi, where Log's
    2 atan2(n, w) / n loses digits on both sides alike)."""
    rng = np.random.default_rng(5)
    a, b = _poses(rng, 48), _poses(rng, 48)
    for tfn, jfn, args in (
        (geom.se3_log, jgeom.se3_log, (a,)),
        (geom.se3_multiply, jgeom.se3_multiply, (a, b)),
        (geom.se3_inverse, jgeom.se3_inverse, (a,)),
        (geom.so3_log, jgeom.so3_log, (a[:, 3:],)),
    ):
        want = np.asarray(jfn(*map(jnp.asarray, args)))
        got = tfn(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # Log inverts Exp away from the cut at pi
    tau = rng.normal(0, 0.8, (32, 6)).astype(np.float32)
    back = geom.se3_log(geom.se3_exp(torch.from_numpy(tau))).numpy()
    np.testing.assert_allclose(back, tau, atol=2e-5)


def test_geometric_loss_values_and_gradients_match_argus_tpu():
    """The loss and its gradient w.r.t. the prediction, including predictions
    at exactly zero rotation and targets at identity, near 0 and near pi:
    finite everywhere (the guarded `where` branches) and equal to JAX's."""
    from argus_tpu.train import geometric_loss_fn as jloss
    from argus_tpu_torch.train import geometric_loss_fn

    rng = np.random.default_rng(6)
    target = _poses(rng, 32)
    pred = rng.normal(0, 0.5, (32, 6)).astype(np.float32)
    pred[:6, 3:] = 0.0  # zero rotation: so3_exp's and the Jacobians' small branches
    pred[6:10, 3:] *= 1e-4
    want, jgrad = jax.value_and_grad(lambda p: jnp.sum(jloss(p, jnp.asarray(target))))(jnp.asarray(pred))
    tp_ = torch.from_numpy(pred).requires_grad_()
    got = geometric_loss_fn(tp_, torch.from_numpy(target))
    assert got.dtype == torch.float32 and got.shape == (32,)
    (tgrad,) = torch.autograd.grad(got.sum(), tp_)
    assert torch.isfinite(tgrad).all()
    np.testing.assert_allclose(got.sum().item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jloss(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-3, atol=1e-4)
    # a bf16 prediction is lifted to f32 first, as argus_tpu does
    assert geometric_loss_fn(tp_.detach().to(torch.bfloat16), torch.from_numpy(target)).dtype == torch.float32


def test_u8_to_f32_matches_argus_tpu():
    """The cast then the multiply by 1/255 rounded to the dtype: in bf16 a
    bf16 multiply, bit for bit."""
    from argus_tpu.ops.image import u8_to_f32 as ju8
    from argus_tpu_torch.ops.image import u8_to_f32

    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(ju8(jnp.asarray(u8), jdt).astype(jnp.float32))
        got = u8_to_f32(torch.from_numpy(u8), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
