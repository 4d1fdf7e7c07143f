"""The port's streaming render feed (`argus_tpu_torch.data.streaming`)
against argus_tpu's: the batch schema and the same batches from the same
seeded source, a producer's exception raised again as itself, the Unity
source through a fake env giving argus_tpu's frames and poses, and a
streamed batch driving the port's train step bit-equal to the same batch
passed as a dict."""

import sys
import types

import numpy as np
import pytest
import torch

from argus_tpu.data.streaming import StreamingRenderLoader as JaxLoader
from argus_tpu_torch.data import StreamingRenderLoader


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the machine's cores; more torch threads
    each only oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _source(seed=0, hw=32):
    rng = np.random.default_rng(seed)

    def render_fn(batch_size):
        imgs = rng.integers(0, 256, (batch_size, hw, hw, 6), dtype=np.uint8)
        poses = rng.normal(size=(batch_size, 7))  # float64: the loader casts
        poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=-1, keepdims=True)
        return imgs, poses

    return render_fn


def test_schema_and_batches_match_argus_tpu():
    ours = StreamingRenderLoader(_source(3), batch_size=4, n_batches=3, prefetch=1)
    theirs = JaxLoader(_source(3), batch_size=4, n_batches=3, prefetch=1)
    assert len(ours) == len(theirs) == 3
    ours.set_epoch(2)
    assert ours.epoch == 2
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"images", "cube_pose", "mask"}
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k])
        assert g["images"].dtype == np.uint8 and g["cube_pose"].dtype == np.float32
        np.testing.assert_array_equal(g["mask"], np.ones(4, np.float32))


@pytest.mark.parametrize("after", [0, 2])
def test_producer_error_is_raised_as_itself(after):
    raised = []

    def make():
        calls = {"n": 0}
        src = _source(0)

        def render_fn(batch_size):
            calls["n"] += 1
            if calls["n"] > after:
                e = RuntimeError("render died")
                raised.append(e)
                raise e
            return src(batch_size)

        return render_fn

    for cls in (JaxLoader, StreamingRenderLoader):
        seen = []
        with pytest.raises(RuntimeError, match="render died") as info:
            for b in cls(make(), batch_size=2, n_batches=4):
                seen.append(b)
        assert len(seen) == after  # the batches before the failure, then the error
        assert info.value is raised[-1]


def test_bad_render_output_raises():
    loader = StreamingRenderLoader(lambda b: (np.zeros((b, 8, 8, 6), np.float32), np.zeros((b, 7))), 2, 1)
    with pytest.raises(ValueError, match="uint8"):
        list(loader)


class _FakeActionTuple:
    def __init__(self, continuous=None):
        self.continuous = continuous


class _FakeEnv:
    """Renders pixels from the commanded action: the cube, light and camera
    colour slots, so every sampled value reaches the frames."""

    def __init__(self, n_agents, hw=(40, 48)):
        self.n, self.hw, self.action = n_agents, hw, None

    def reset(self):
        pass

    def set_actions(self, behavior, action):
        self.action = np.asarray(action.continuous)

    def step(self):
        pass

    def get_steps(self, behavior):
        H, W = self.hw
        a = self.action
        ramp = np.linspace(0.0, 0.4, W, dtype=np.float32)[None, None, None, :]
        obs1 = (np.abs(a[:, 20])[:, None, None, None] % 0.5 + ramp) * a[:, 7:10, None, None]
        obs2 = (np.abs(a[:, 27])[:, None, None, None] % 0.5 + ramp) * a[:, 17:20, None, None]

        class Steps:
            obs = [np.broadcast_to(obs1, (self.n, 3, H, W)).astype(np.float32),
                   np.broadcast_to(obs2, (self.n, 3, H, W)).astype(np.float32)]

        return Steps(), None


def test_unity_render_source_matches_argus_tpu(tmp_path, dummy_json_path, monkeypatch):
    from argus_tpu import datagen as jdg
    from argus_tpu.data.streaming import unity_render_source as jax_source
    from argus_tpu_torch import datagen as tdg
    from argus_tpu_torch.data.streaming import unity_render_source

    fake = types.ModuleType("mlagents_envs.base_env")
    fake.ActionTuple = _FakeActionTuple
    monkeypatch.setitem(sys.modules, "mlagents_envs", types.ModuleType("mlagents_envs"))
    monkeypatch.setitem(sys.modules, "mlagents_envs.base_env", fake)
    exe = tmp_path / "env.x86_64"
    exe.write_bytes(b"")
    out = []
    for dg, make_source in ((jdg, jax_source), (tdg, unity_render_source)):
        monkeypatch.setattr(dg, "unity_setup", lambda path, n_agents=1: (_FakeEnv(n_agents), "Cube", dg.ACTION_SIZE))
        cfg = dg.GenerateDataConfig(env_exe_path=str(exe), mjpc_data_path=dummy_json_path, seed=5)
        src = make_source(cfg, center_crop=(32, 36))
        out.append([src(4) for _ in range(3)])  # 12 rows over 10 states: the cursor wraps
    for (gi, gp), (wi, wp) in zip(out[1], out[0]):
        assert gi.shape == (4, 32, 36, 6) and gi.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        assert gp.dtype == wp.dtype == np.float32
        np.testing.assert_array_equal(gp, wp)


def test_streamed_batch_drives_the_train_step_bit_equal():
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops.augment import AugmentationConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step

    cfg = TrainConfig(model_config=NCameraCNNConfig(backbone="resnet18", resnet_output_dim=16),
                      augmentation_config=AugmentationConfig(num_spaghetti=2), learning_rate=1e-3)
    loader = StreamingRenderLoader(_source(1), batch_size=4, n_batches=2)
    src = _source(1)  # the same frames, straight from the source
    batches = [{"images": i, "cube_pose": p.astype(np.float32), "mask": np.ones(4, np.float32)}
               for i, p in (src(4), src(4))]
    runs = []
    for feed in (loader, batches):
        model, state = create_train_state(cfg, seed=0, device="cpu")
        step = make_train_step(model, cfg, base_seed=0, device="cpu")
        losses = []
        for batch in feed:
            state, loss = step(state, batch)
            losses.append(loss.item())
        runs.append((losses, {k: v.detach().clone() for k, v in state.params.items()}))
    (ls, ps), (ld, pd) = runs
    assert ls == ld and all(np.isfinite(ls))
    for k in pd:
        assert torch.equal(ps[k], pd[k]), k
