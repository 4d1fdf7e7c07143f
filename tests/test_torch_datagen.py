"""The port's datagen (`argus_tpu_torch.datagen`) against argus_tpu's: the
samplers and the action packing bit-equal from one seeded Generator, the
MJPC reader and the HDF5 writer equal, and `generate_data` through a fake
Unity env writing the same HDF5 and byte-equal PNGs."""

import os

import numpy as np
import pytest

from argus_tpu import datagen as jdg
from argus_tpu_torch import datagen as tdg


class _FakeUnityEnv:
    """A stand-in for the Unity render server: the observation's pixels are
    a function of the commanded cube pose (the cube slice of the action), so
    the action -> render wiring shows in the files (the contract is
    docs/unity_contract.md)."""

    def __init__(self, n_agents, hw=(48, 64)):
        self.n_agents = n_agents
        self.hw = hw
        self._last_action = None

    def reset(self):
        pass

    def set_actions(self, behavior, action):
        self._last_action = np.asarray(action)

    def step(self):
        pass

    def get_steps(self, behavior):
        H, W = self.hw
        cube = self._last_action[:, 20:27]
        light = self._last_action[:, 27:34]
        # a gradient across the image, so the crop's offset shows in the bytes
        ramp = np.linspace(0.0, 0.5, W, dtype=np.float32)[None, None, None, :]
        shade = (np.abs(cube[:, 0]) % 0.5)[:, None, None, None] + ramp
        obs1 = np.broadcast_to(shade, (self.n_agents, 3, H, W)).astype(np.float32)
        obs2 = (1.0 - obs1 * (np.abs(light[:, 1]) % 1.0)[:, None, None, None]).astype(np.float32)

        class Steps:
            obs = [obs1, obs2]

        return Steps(), None

    def close(self):
        pass


def test_action_layout_and_nominals_are_argus_tpus():
    assert tdg.ACTION_SIZE == jdg.ACTION_SIZE
    for name in ("_CAM1_POSE", "_CAM1_RGB", "_CAM2_POSE", "_CAM2_RGB", "_CUBE_POSE", "_LIGHT_POSE", "_HAND_Q"):
        assert getattr(tdg, name) == getattr(jdg, name), name
    np.testing.assert_array_equal(tdg.CAM1_NOMINAL, jdg.CAM1_NOMINAL)
    np.testing.assert_array_equal(tdg.CAM2_NOMINAL, jdg.CAM2_NOMINAL)
    from argus_tpu_torch.models import keypoint_net

    assert keypoint_net.CAM1_NOMINAL is tdg.CAM1_NOMINAL and keypoint_net.CAM2_NOMINAL is tdg.CAM2_NOMINAL


@pytest.mark.parametrize("seed", [0, 7])
def test_samplers_and_pack_actions_bit_equal(seed):
    outs = []
    for dg in (jdg, tdg):
        rng = np.random.default_rng(seed)
        cam1 = dg.generate_random_camera_poses(5, dg.CAM1_NOMINAL[:3], dg.CAM1_NOMINAL[3:], 0.005, 0.05, rng)
        cam2 = dg.generate_random_camera_poses(5, dg.CAM2_NOMINAL[:3], dg.CAM2_NOMINAL[3:], 0.01, 0.1, rng)
        light = dg.generate_random_light_source_poses(5, rng)
        cube, q = rng.random((5, 7)), rng.random((5, 16))
        action = dg.pack_actions(cube, q, cam1, cam2, light, (0.5, 1.0), rng, dg.ACTION_SIZE)
        outs.append((cam1, cam2, light, action, rng.random()))
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_array_equal(got, want)


def test_mjpc_reader_and_hdf5_writer_equal(tmp_path, dummy_json_path):
    import h5py

    files = []
    for dg, name in ((jdg, "jax_side"), (tdg, "port_side")):
        cube, q = dg.load_mjpc_states(dummy_json_path)
        stored = dg.convert_pose_unity_to_mjpc(dg.convert_pose_mjpc_to_unity(cube))
        out = tmp_path / name
        out.mkdir()
        stems = dg.write_dataset_hdf5(str(out), stored, q, 0.7, np.random.default_rng(3), (32, 40), (48, 64))
        files.append((cube, q, stems, out / f"{name}.hdf5"))
    (cj, qj, sj, fj), (ct, qt, st, ft) = files
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(qt, qj)
    assert st == sj
    with h5py.File(fj, "r") as a, h5py.File(ft, "r") as b:
        _assert_same_h5(a, b)


def _assert_same_h5(a, b):
    assert dict(a.attrs) == dict(b.attrs)
    assert sorted(a.keys()) == sorted(b.keys())
    for g in a:
        assert sorted(a[g].keys()) == sorted(b[g].keys())
        for d in a[g]:
            assert a[g][d].dtype == b[g][d].dtype, (g, d)
            np.testing.assert_array_equal(a[g][d][()], b[g][d][()])


def _generate(dg, monkeypatch, out, dummy_json_path, fake_exe):
    monkeypatch.setattr(dg, "unity_setup", lambda path, n_agents=1, time_scale=20.0: (
        _FakeUnityEnv(n_agents), "CubeBehavior", dg.ACTION_SIZE))
    monkeypatch.setattr(dg, "_make_action_tuple", lambda c: c)
    cfg = dg.GenerateDataConfig(env_exe_path=str(fake_exe), mjpc_data_path=dummy_json_path,
                                output_data_path=str(out), n_agents=3, center_crop=(32, 40), train_frac=0.8, seed=4)
    dg.generate_data(cfg)


def test_generate_data_writes_argus_tpus_files(tmp_path, dummy_json_path, monkeypatch):
    import h5py

    fake_exe = tmp_path / "fake_env.x86_64"
    fake_exe.write_bytes(b"")
    jout, tout = tmp_path / "jax_side", tmp_path / "port_side"
    _generate(jdg, monkeypatch, jout, dummy_json_path, fake_exe)
    _generate(tdg, monkeypatch, tout, dummy_json_path, fake_exe)
    with h5py.File(jout / "jax_side.hdf5", "r") as a, h5py.File(tout / "port_side.hdf5", "r") as b:
        _assert_same_h5(a, b)
        assert b.attrs["H"] == 32 and b.attrs["W"] == 40
    pngs = sorted(os.listdir(jout / "img"))
    assert pngs == sorted(os.listdir(tout / "img")) and len(pngs) == 2 * 9  # 10 states, 3 agents: 3 episodes
    for name in pngs:
        assert (tout / "img" / name).read_bytes() == (jout / "img" / name).read_bytes(), name


def test_unity_setup_raises_without_the_player(tmp_path):
    with pytest.raises((FileNotFoundError, ImportError)):
        tdg.unity_setup(str(tmp_path / "missing.x86_64"))


def test_config_checks_paths(tmp_path, dummy_json_path):
    with pytest.raises(FileNotFoundError):
        tdg.GenerateDataConfig(env_exe_path=str(tmp_path / "missing.x86_64"), mjpc_data_path=dummy_json_path)
    exe = tmp_path / "env.x86_64"
    exe.write_bytes(b"")
    cfg = tdg.GenerateDataConfig(env_exe_path=str(exe), mjpc_data_path=dummy_json_path)
    np.testing.assert_array_equal(cfg.cam1_nominal, jdg.CAM1_NOMINAL)
    assert cfg.cam1_nominal is not tdg.CAM1_NOMINAL
