"""Real-camera validation: estimate the pose from real images, re-render it in
MuJoCo, and build side-by-side figures and a GIF.

Port of `argus_tpu/validate_real.py`: it reads a flat real-data HDF5
(top-level `img_stems`, no train/test groups, no labels); for each frame it
decodes both camera PNGs, centre-crops them, estimates the pose with the
single-frame estimator (`make_pose_estimator`: `serve.Estimator` at batch
1, on the card its forward replayed as a CUDA graph), writes the predicted
pose in MuJoCo's wxyz order into `qpos[:7]` (and the LEAP hand's joints:
the frame's `q_leap` when the file has it, else the scene's "home"
keyframe), runs `mj_forward`, renders `cam1`/`cam2` with every geom of the
goal body hidden, and saves a 2x2 real-vs-rendered figure; the figures make
`real_validation.gif`, under `outputs/real_validation_visuals/<checkpoint>/`
of the repository root. `mujoco`, `h5py`, `imageio` and `matplotlib` are
imported when it runs.

    python -m argus_tpu_torch.validate_real --model-path <ckpt> --dataset-config.dataset-path <dir>

runs on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from argus_tpu_torch import ROOT
from argus_tpu_torch.data import CameraCubePoseDatasetConfig
from argus_tpu_torch.data.dataset import _center_crop_np, _decode_png
from argus_tpu_torch.geom import xyzxyzw_to_xyzwxyz_SE3
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.serve import Estimator, load_model


@dataclass
class ValRealConfig:
    """argus_tpu's real-validation config: the same fields and defaults.

    Fields:
        model_path: checkpoint to validate.
        dataset_config: the real-capture dataset directory (flat HDF5).
        model_config: optional model-config override; None reads the family
            and config from the checkpoint's metadata.
        mujoco_xml: task scene with cam1/cam2 and the goal body to hide.
        pose_hand: pose the LEAP hand in the re-renders (per-frame `q_leap`,
            else the "home" keyframe) rather than leave it at its defaults.
    """

    model_path: str
    dataset_config: CameraCubePoseDatasetConfig
    model_config: Optional[NCameraCNNConfig] = None
    mujoco_xml: str = os.path.join(ROOT, "mujoco", "leap", "task.xml")
    pose_hand: bool = True


def make_pose_estimator(model, device=None, model_type: str = "pose_cnn", crop=(256, 256)) -> Estimator:
    """The single-frame estimator of `model` as it is (uint8 (1, H, W, 3 *
    n_cams) frames -> poses, `predict`), for either family, with the
    keypoint fit's cameras at `crop`: the control-loop artifact,
    `serve.Estimator.from_model` at batch 1. The model moves to `device`
    (CUDA unless given)."""
    return Estimator.from_model(model, model_type, crop, batch_size=1, device=device)


def validate_real(cfg: ValRealConfig, device=None) -> str:
    """Run real-world validation on `device` (CUDA unless given); returns the
    output directory."""
    import h5py
    import imageio.v2 as imageio
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import mujoco
    except ImportError as e:  # pragma: no cover
        raise ImportError("validate_real requires the `mujoco` package (host-side)") from e

    model, _, model_type, _ = load_model(cfg.model_path, cfg.model_config)
    crop = tuple(cfg.dataset_config.center_crop or (256, 256))
    estimator = make_pose_estimator(model, device, model_type=model_type, crop=crop)

    # the MuJoCo scene the predicted pose is rendered in
    m = mujoco.MjModel.from_xml_path(cfg.mujoco_xml)
    d = mujoco.MjData(m)
    renderer = mujoco.Renderer(m, *crop)
    # every geom of the "goal" body is hidden during renders
    goal_body = m.body("goal")
    goal_geoms = range(goal_body.geomadr[0], goal_body.geomadr[0] + goal_body.geomnum[0])
    saved_alpha = {g: float(m.geom_rgba[g, 3]) for g in goal_geoms}
    mujoco.mj_forward(m, d)

    def render(camera: str) -> np.ndarray:
        for g in goal_geoms:
            m.geom_rgba[g, 3] = 0.0
        renderer.update_scene(d, camera=camera)
        for g in goal_geoms:
            m.geom_rgba[g, 3] = saved_alpha[g]
        return renderer.render()

    dataset_path = cfg.dataset_config.dataset_path
    filename = f"{dataset_path}/{Path(dataset_path).stem}.hdf5"
    output_dir = Path(ROOT) / f"outputs/real_validation_visuals/{Path(cfg.model_path).stem}"
    os.makedirs(output_dir, exist_ok=True)

    with h5py.File(filename, "r") as f:
        img_stems = [s.decode("utf-8") for s in f["img_stems"][()]]
        q_leap = f["q_leap"][()] if "q_leap" in f else None

    # the hand's joints: per-frame q_leap, else the "home" keyframe's grasp
    n_hand = m.nq - 7
    home_hand = None
    if cfg.pose_hand and n_hand > 0:
        home_hand = np.array(m.key_qpos[0][7:7 + n_hand]) if m.nkey > 0 else np.array(d.qpos[7:7 + n_hand])

    frames = []
    for i, stem in enumerate(img_stems):
        pair = [_center_crop_np(_decode_png(f"{dataset_path}/{stem}_{sfx}.png"), crop) for sfx in ("a", "b")]
        images_u8 = np.ascontiguousarray(np.concatenate(pair, axis=-1)[None])  # (1, H, W, 6)

        pred_pose_wxyz = xyzxyzw_to_xyzwxyz_SE3(estimator.predict(images_u8)[0])
        d.qpos[:7] = pred_pose_wxyz
        if cfg.pose_hand and n_hand > 0:
            hand = q_leap[i][:n_hand] if q_leap is not None else home_hand
            d.qpos[7:7 + len(hand)] = hand
        mujoco.mj_forward(m, d)

        fig = plt.figure()
        for cam in range(2):
            plt.subplot(2, 2, 2 * cam + 1)
            plt.imshow(pair[cam])
            plt.axis("off")
            plt.subplot(2, 2, 2 * cam + 2)
            plt.imshow(render(f"cam{cam + 1}"))
            plt.axis("off")
        plt.suptitle(f"Pred pose {i}:\n{np.array2string(pred_pose_wxyz, precision=3, floatmode='fixed')}")
        fig_path = output_dir / f"example_{i}.png"
        plt.savefig(fig_path, bbox_inches="tight")
        plt.close(fig)
        frames.append(imageio.imread(fig_path))

    imageio.mimsave(output_dir / "real_validation.gif", frames)
    return str(output_dir)


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    validate_real(cli(ValRealConfig))
