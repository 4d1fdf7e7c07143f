"""Data generation: replay MJPC sim states through the Unity renderer to build
the HDF5 + PNG training dataset.

Port of `argus_tpu/datagen.py`, host-side by nature (Unity renders on the
host; the card never participates), with argus_tpu's numbers to the bit:
the same numpy/scipy draws from the same `np.random.Generator` in the same
order, the same HDF5 layout and the same PNG bytes.

  * Unity player boot through the ML-Agents RPC bridge (`unity_setup`,
    `time_scale=20`, `num_areas=n_agents`; `mlagents_envs` imported lazily);
  * domain randomisation: camera poses about the CAD nominals (uniform
    translation noise, tangent-space Gaussian rotation noise through the
    quaternion exp map) and overhead light poses;
  * the Unity agent's 50-float action layout: cam1 pose (7) + RGB (3), cam2
    pose (7) + RGB (3), cube pose (7), light pose (7), 16 hand joints;
  * the HDF5 writer (shuffled train/test split, cube poses in MJPC wxyz
    order, `q_leap`, `img_stems`) and center-cropped uint8 PNGs
    `img{i}_{a,b}.png`.

It keeps argus_tpu's two fixes of reference quirks: every agent's render is
saved (not agent 0's for all), and the light's z rotation is really drawn
(+-60 degrees, not a constant).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from argus_tpu_torch import ROOT
from argus_tpu_torch.geom import convert_pose_mjpc_to_unity, convert_pose_unity_to_mjpc

# the Unity agent's continuous-action layout (unity/LeapProject AgentCallback.cs)
ACTION_SIZE = 50
_CAM1_POSE = slice(0, 7)
_CAM1_RGB = slice(7, 10)
_CAM2_POSE = slice(10, 17)
_CAM2_RGB = slice(17, 20)
_CUBE_POSE = slice(20, 27)
_LIGHT_POSE = slice(27, 34)
_HAND_Q = slice(34, 50)


def unity_setup(env_exe_path: str, n_agents: int = 1, time_scale: float = 20.0):
    """Boot the Unity player and discover its behavior spec: (env,
    behavior_name, expected_action_size). Raises `ImportError` without
    `mlagents_envs` and `FileNotFoundError` without the executable."""
    try:
        from mlagents_envs.environment import UnityEnvironment
        from mlagents_envs.side_channel.engine_configuration_channel import EngineConfigurationChannel
    except ImportError as e:
        raise ImportError("data generation requires the `mlagents_envs` package") from e

    if not os.path.exists(env_exe_path):
        raise FileNotFoundError(f"The specified path does not exist: {env_exe_path}")

    engine_channel = EngineConfigurationChannel()
    engine_channel.set_configuration_parameters(time_scale=time_scale)
    env = UnityEnvironment(file_name=env_exe_path, side_channels=[engine_channel], num_areas=n_agents)
    env.reset()
    behavior_name = list(env.behavior_specs.keys())[0]
    expected_action_size = env.behavior_specs[behavior_name].action_spec.continuous_size
    return env, behavior_name, expected_action_size


def generate_random_camera_poses(
    n_agents: int,
    mu_trans: np.ndarray,
    mu_quat: np.ndarray,
    bounds_trans: float = 0.01,
    quat_stdev: float = 0.05,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random camera poses about the CAD nominal, (n_agents, 7) xyzw:
    uniform translation noise within `bounds_trans`, and the nominal
    rotation pre-multiplied by exp(omega), omega ~ N(0, quat_stdev) per
    axis."""
    from scipy.spatial.transform import Rotation as R

    rng = rng or np.random.default_rng()
    translations = mu_trans + rng.uniform(-bounds_trans, bounds_trans, size=(n_agents, 3))

    omega = rng.normal(0.0, quat_stdev, size=(n_agents, 3))
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    theta = np.where(theta < 1e-12, 1e-12, theta)
    qxyz = np.sin(theta) * omega / theta
    qw = np.cos(theta[:, 0])
    exp_omega = R.from_quat(np.concatenate([qxyz, qw[:, None]], axis=-1))
    quat = (exp_omega * R.from_quat(mu_quat)).as_quat()

    return np.concatenate([translations, quat], axis=-1)


def generate_random_light_source_poses(n_agents: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random overhead light poses in Unity's y-up frame, (n_agents, 7)
    xyzw: x, z within +-0.254 m, y 2-3 m overhead, intrinsic XYZ Euler
    angles of +-20, 0-360 and +-60 degrees."""
    from scipy.spatial.transform import Rotation as R

    rng = rng or np.random.default_rng()
    x = rng.uniform(-0.254, 0.254, size=n_agents)
    z = rng.uniform(-0.254, 0.254, size=n_agents)
    y = rng.uniform(2.0, 3.0, size=n_agents)

    rot_x = rng.uniform(-20.0, 20.0, size=n_agents)
    rot_y = rng.uniform(0.0, 360.0, size=n_agents)
    rot_z = rng.uniform(-60.0, 60.0, size=n_agents)
    quat = R.from_euler("XYZ", np.stack([rot_x, rot_y, rot_z], axis=-1), degrees=True).as_quat()

    return np.concatenate([np.stack([x, y, z], axis=-1), quat], axis=-1)


# nominal camera poses in Unity's y-up left-handed frame, xyz + xyzw
# (CAD-derived; matches mujoco/leap/task.xml's cameras)
CAM1_NOMINAL = np.array(
    [-0.14786571, 0.125994, 0.00858148, 0.35355339, -0.35355339, 0.85355339, 0.14644661]
)
CAM2_NOMINAL = np.array(
    [0.14786571, 0.125994, 0.00858148, -0.35355339, -0.35355339, 0.85355339, -0.14644661]
)


@dataclass
class GenerateDataConfig:
    """argus_tpu's datagen config: the same fields, defaults and checks.

    Fields:
        env_exe_path: Unity player executable.
        mjpc_data_path: bagged MJPC sim states (JSON with an `s` field per step).
        output_data_path: dataset output directory.
        n_agents: parallel render areas in Unity.
        cam1_nominal / cam2_nominal: nominal camera poses (Unity frame, xyzw).
        bounds_trans / quat_stdev: camera domain-randomization magnitudes.
        cam_rgb_range: camera background RGB randomization range in [0, 1].
        center_crop: (H, W) crop of the rendered images.
        train_frac: train/test split fraction.
        seed: RNG seed for the randomization and the split.
    """

    env_exe_path: str = ROOT + "/outputs/unity/leap_env.x86_64"
    mjpc_data_path: str = ROOT + "/outputs/data/sim_residuals.json"
    output_data_path: str = ROOT + "/outputs/data/cube_unity_data"
    n_agents: int = 1
    cam1_nominal: Optional[np.ndarray] = None
    cam2_nominal: Optional[np.ndarray] = None
    bounds_trans: float = 0.005
    quat_stdev: float = 0.05
    cam_rgb_range: Tuple[float, float] = (0.5, 1.0)
    center_crop: Optional[Tuple[int, int]] = (256, 256)
    train_frac: float = 0.9
    seed: int = 0

    def __post_init__(self):
        for attr in ("env_exe_path", "mjpc_data_path"):
            p = getattr(self, attr)
            if not os.path.exists(p):
                if os.path.exists(ROOT + "/" + p):
                    setattr(self, attr, ROOT + "/" + p)
                else:
                    raise FileNotFoundError(f"The specified path does not exist: {p}!")
        assert Path(self.mjpc_data_path).suffix == ".json", "mjpc data must be a json file!"
        assert Path(self.env_exe_path).suffix in (".x86_64", ".app"), "Unity env must be an executable!"
        assert not Path(self.output_data_path).suffix, "output data path must be a directory!"
        if self.cam1_nominal is None:
            self.cam1_nominal = CAM1_NOMINAL.copy()
        if self.cam2_nominal is None:
            self.cam2_nominal = CAM2_NOMINAL.copy()
        assert len(self.cam_rgb_range) == 2, "cam_rgb_range must be a 2-tuple!"
        lo, hi = self.cam_rgb_range
        assert 0 <= lo < hi <= 1, "cam_rgb_range must be a subset of [0, 1]!"


def load_mjpc_states(mjpc_data_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read the MJPC JSON: per-step state `s`, its first 7 values the cube
    pose (wxyz), the next 16 the hand joints. Returns (cube_poses_mjpc
    (N, 7), q_leap (N, 16))."""
    with open(mjpc_data_path) as f:
        all_data = json.load(f)
    q_all = np.array([d["s"] for d in all_data])[..., :23]
    return q_all[..., :7], q_all[..., 7:23]


def write_dataset_hdf5(
    output_data_path: str,
    cube_poses_mjpc: np.ndarray,
    q_leap: np.ndarray,
    train_frac: float,
    rng: np.random.Generator,
    crop_hw: Optional[Tuple[int, int]],
    render_hw: Tuple[int, int],
    n_cams: int = 2,
) -> list:
    """Write `<output_data_path>/<name>.hdf5` (a shuffled split; poses in
    MJPC wxyz order) and return the image stems in render order."""
    import h5py

    num_data = cube_poses_mjpc.shape[0]
    idxs = rng.permutation(num_data)
    split = int(train_frac * num_data)
    img_stems = np.array([f"img/img{i}" for i in range(num_data)])

    out = Path(output_data_path)
    with h5py.File(out / f"{out.stem}.hdf5", "w") as f:
        f.attrs["n_cams"] = n_cams
        f.attrs["H"] = crop_hw[0] if crop_hw else render_hw[0]
        f.attrs["W"] = crop_hw[1] if crop_hw else render_hw[1]
        for name, sel in (("train", idxs[:split]), ("test", idxs[split:])):
            g = f.create_group(name)
            g.create_dataset("cube_poses", data=cube_poses_mjpc[sel])
            g.create_dataset("q_leap", data=q_leap[sel])
            g.create_dataset("img_stems", data=np.array([s.encode() for s in img_stems[sel]]))
    return img_stems.tolist()


def pack_actions(
    cube_poses_unity: np.ndarray,
    q_leap: np.ndarray,
    cam1_poses: np.ndarray,
    cam2_poses: np.ndarray,
    light_poses: np.ndarray,
    cam_rgb_range: Tuple[float, float],
    rng: np.random.Generator,
    action_size: int = ACTION_SIZE,
) -> np.ndarray:
    """The Unity agent's action vectors, (n, action_size): the poses in
    their slots and the two cameras' background RGB drawn from
    `cam_rgb_range`."""
    n = cube_poses_unity.shape[0]
    action = np.zeros((n, action_size))
    action[:, _CAM1_POSE] = cam1_poses
    action[:, _CAM1_RGB] = rng.uniform(*cam_rgb_range, size=(n, 3))
    action[:, _CAM2_POSE] = cam2_poses
    action[:, _CAM2_RGB] = rng.uniform(*cam_rgb_range, size=(n, 3))
    action[:, _CUBE_POSE] = cube_poses_unity
    action[:, _LIGHT_POSE] = light_poses
    action[:, _HAND_Q] = q_leap
    return action


def _save_crop_png(img_chw: np.ndarray, path: Path, crop_hw: Optional[Tuple[int, int]]) -> None:
    """uint8-ify a (3, H, W) float render in [0, 1], center-crop, save as PNG."""
    from PIL import Image

    arr = (np.transpose(img_chw, (1, 2, 0)) * 255).astype(np.uint8)
    img = Image.fromarray(arr)
    if crop_hw:
        W, H = img.width, img.height
        ch, cw = crop_hw
        img = img.crop(((W - cw) / 2, (H - ch) / 2, (W + cw) / 2, (H + ch) / 2))
    img.save(path)


def _make_action_tuple(continuous: np.ndarray):
    """Wrap an action array for the ML-Agents API (replaceable in tests)."""
    from mlagents_envs.base_env import ActionTuple

    return ActionTuple(continuous=continuous)


def generate_data(cfg: GenerateDataConfig) -> None:
    """Render every MJPC state once (n_agents at a time) and write the
    dataset: the HDF5 after the first step (the render size known), the two
    cameras' PNGs of every agent."""
    from tqdm import tqdm

    rng = np.random.default_rng(cfg.seed)

    cube_poses_mjpc, q_leap_all = load_mjpc_states(cfg.mjpc_data_path)
    cube_poses_unity = convert_pose_mjpc_to_unity(cube_poses_mjpc)

    n_agents = cfg.n_agents
    n_episodes = cube_poses_unity.shape[0] // n_agents
    n_used = n_agents * n_episodes
    # store the poses round-tripped through the Unity frame: exactly what was rendered
    cube_poses_stored = convert_pose_unity_to_mjpc(cube_poses_unity[:n_used])

    env, behavior_name, action_size = unity_setup(cfg.env_exe_path, n_agents=n_agents)

    out = Path(cfg.output_data_path)
    os.makedirs(out / "img", exist_ok=True)

    img_stems = None
    img_idx = 0
    print("Rendering image data...")
    for episode in tqdm(range(n_episodes), desc="Episodes"):
        env.reset()
        sl = slice(episode * n_agents, (episode + 1) * n_agents)
        cam1_poses = generate_random_camera_poses(
            n_agents, cfg.cam1_nominal[:3], cfg.cam1_nominal[3:], cfg.bounds_trans, cfg.quat_stdev, rng
        )
        cam2_poses = generate_random_camera_poses(
            n_agents, cfg.cam2_nominal[:3], cfg.cam2_nominal[3:], cfg.bounds_trans, cfg.quat_stdev, rng
        )
        light_poses = generate_random_light_source_poses(n_agents, rng)
        action = pack_actions(
            cube_poses_unity[sl], q_leap_all[sl], cam1_poses, cam2_poses, light_poses,
            cfg.cam_rgb_range, rng, action_size,
        )

        env.set_actions(behavior_name, _make_action_tuple(action))
        env.step()
        decision_steps, _ = env.get_steps(behavior_name)
        cam1_obs = decision_steps.obs[0]  # (n_agents, 3, H, W)
        cam2_obs = decision_steps.obs[1]

        if img_stems is None:
            render_hw = cam1_obs.shape[-2:]
            img_stems = write_dataset_hdf5(
                cfg.output_data_path, cube_poses_stored, q_leap_all[:n_used],
                cfg.train_frac, rng, cfg.center_crop, render_hw,
            )

        for agent in range(n_agents):
            _save_crop_png(cam1_obs[agent], out / f"img/img{img_idx}_a.png", cfg.center_crop)
            _save_crop_png(cam2_obs[agent], out / f"img/img{img_idx}_b.png", cfg.center_crop)
            img_idx += 1

    env.close()


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    cfg = cli(GenerateDataConfig)
    start = time.time()
    generate_data(cfg)
    print(f"Data generation took {time.time() - start:.2f} seconds.")
