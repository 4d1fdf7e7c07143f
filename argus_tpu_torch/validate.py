"""Sim-set validation: per-example pose figures and a loss histogram.

Port of `argus_tpu/validate.py`: load a checkpoint into its model (family
and config from the checkpoint's metadata unless a config overrides them),
walk the val (or train) split one example at a time in order, augment as
the split is augmented (the whole stack on the train split, with the key
`ops.augment.fold_in(seed, i)` for example i; spaghetti arcs on the val
split when `num_spaghetti > 0`, as the dataset draws them regardless of
the split), predict the pose (`se3_exp` of NCameraCNN's output, or the
keypoint family's fit through the nominal cameras at the real crop), take
the geodesic loss, and save a three-panel figure per example (the true and
predicted axis triads, both camera images) under
`outputs/{split}_visuals/<checkpoint>/example_{i}.png` of the repository
root, then the log-scale loss histogram. `validation_step` is one example's
inference on the model's device; matplotlib stays on the host.

    python -m argus_tpu_torch.validate --model-path outputs/models/<run>.ckpt \\
        --dataset-config.dataset-path <dir>

runs on the card.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from argus_tpu_torch import ROOT, resolve_device
from argus_tpu_torch.data import CameraCubePoseDataset, CameraCubePoseDatasetConfig, HostDataLoader
from argus_tpu_torch.geom import se3_exp, se3_log, se3_matrix
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models.keypoint_net import fit_pose, nominal_camera_matrices
from argus_tpu_torch.ops import augment
from argus_tpu_torch.ops.augment import AugmentationConfig, apply_augmentation, spaghetti_arcs
from argus_tpu_torch.ops.image import u8_to_f32
from argus_tpu_torch.serve import load_model
from argus_tpu_torch.train import geometric_loss_fn
from argus_tpu_torch.utils import get_tree_string


@dataclass
class ValConfig:
    """argus_tpu's validation config: the same fields and defaults.

    Fields:
        model_path: checkpoint to validate; a path that does not exist is
            taken relative to the repository root.
        dataset_config: dataset configuration.
        model_config: optional model-config override; None reads the family
            and config from the checkpoint's metadata.
        aug_config: augmentation configuration.
        use_train: validate on the training split instead of test.
        max_examples: cap on rendered examples.
        seed: the augmentation's base key.
    """

    model_path: str
    dataset_config: CameraCubePoseDatasetConfig
    model_config: Optional[NCameraCNNConfig] = None
    aug_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    use_train: bool = False
    max_examples: int = 100
    seed: int = 0

    def __post_init__(self):
        assert isinstance(self.model_path, str), "The model path must be a str!"
        if not os.path.exists(self.model_path):
            if os.path.exists(ROOT + "/" + self.model_path):
                self.model_path = ROOT + "/" + self.model_path
            else:
                raise FileNotFoundError(
                    f"The specified model path does not exist!\n"
                    f"Here is a tree of the `outputs/models` directory to help:\n"
                    f"{get_tree_string(ROOT + '/outputs/models', 'ckpt')}"
                )


def plot_axes_from_pose(pose_mat: np.ndarray, true: bool, ax):
    """Draw RGB axis triads of a 4x4 pose matrix (solid: true, dashed: predicted)."""
    origin = pose_mat[:3, -1]
    ls = "-" if true else "--"
    for axis_idx, color in enumerate("rgb"):
        ax.quiver(*origin, *pose_mat[:3, axis_idx], color=color, linestyle=ls, length=0.5)
    return ax


@torch.no_grad()  # not inference mode: the augmentation kernel's wrapper keys a cache on tensor versions
def validation_step(model: torch.nn.Module, model_type: str, images_u8, pose_true, key: int,
                    aug_config: AugmentationConfig = AugmentationConfig(), use_train: bool = False,
                    cam_P: Optional[torch.Tensor] = None):
    """One validation batch on the model's device: (images as the model saw
    them, f32 in [0, 1]; predicted (B, 7) poses; per-example geodesic
    losses (B,)). `images_u8` (B, H, W, 3 * n_cams) and `pose_true` (B, 7)
    xyzw may be numpy; `cam_P` the keypoint family's cameras at the frames'
    resolution."""
    device = next(model.parameters()).device
    n_cams = model.cfg.n_cams
    images = u8_to_f32(torch.as_tensor(images_u8).to(device))
    pose_true = torch.as_tensor(pose_true).to(device, torch.float32)
    if use_train:
        images = apply_augmentation(aug_config, key, images, n_cams=n_cams, train=True)
    elif aug_config.num_spaghetti > 0:
        B, H, W, C = images.shape
        per_cam = images.reshape(B, H, W, n_cams, 3).permute(0, 3, 4, 1, 2).reshape(B * n_cams, 3, H, W)
        arcs = augment._arc_params(augment.generator(key, device), B * n_cams, aug_config.num_spaghetti, H, W)
        per_cam = spaghetti_arcs(per_cam, arcs).reshape(B, n_cams, 3, H, W)
        images = per_cam.permute(0, 3, 4, 1, 2).reshape(B, H, W, C)
    pred = model(images)
    if model_type == "keypoint":
        # the comparable metric of the eval step: the geodesic error of the fitted pose
        pose_pred = fit_pose(cam_P, pred[0])
        loss = geometric_loss_fn(se3_log(pose_pred), pose_true)
    else:
        pose_pred = se3_exp(pred)
        loss = geometric_loss_fn(pred, pose_true)
    return images, pose_pred, loss


def validate(cfg: ValConfig, device=None) -> dict:
    """Run validation on `device` (CUDA unless given); returns {"mean_loss",
    "losses", "output_path"}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D
    from tqdm import tqdm

    device = resolve_device(device)
    ckpt_name = os.path.basename(cfg.model_path).split(".")[0]
    split = "train" if cfg.use_train else "validation"
    output_path = os.path.join(ROOT, "outputs", f"{split}_visuals", ckpt_name)
    os.makedirs(output_path, exist_ok=True)

    model, model_cfg, model_type, _ = load_model(cfg.model_path, cfg.model_config)
    model = model.to(device).eval()
    model.backbone.fold_frozen_bn()

    # one example at a time, in order
    dataset = CameraCubePoseDataset(cfg.dataset_config, train=cfg.use_train)
    loader = HostDataLoader(dataset, batch_size=1, shuffle=False, num_workers=2)
    n_cams = model_cfg.n_cams
    cam_P = None
    if model_type == "keypoint":
        # the cameras at the frames' real size: the crop, else the dataset's own resolution
        crop = tuple(cfg.dataset_config.center_crop or dataset[0]["images"].shape[:2])
        cam_P = nominal_camera_matrices(*crop).to(device)

    losses = []
    for i, batch in enumerate(tqdm(loader, total=min(len(loader), cfg.max_examples))):
        if i >= cfg.max_examples:
            break
        images, pose_pred, loss = validation_step(
            model, model_type, batch["images"], batch["cube_pose"], augment.fold_in(cfg.seed, i),
            cfg.aug_config, cfg.use_train, cam_P,
        )
        loss_val = float(loss[0])
        losses.append(loss_val)

        true_mat = se3_matrix(torch.as_tensor(batch["cube_pose"][0])).numpy()
        pred_mat = se3_matrix(pose_pred[0]).cpu().numpy()
        imgs_np = images[0].float().cpu().numpy()  # (H, W, 3 * n_cams)

        fig = plt.figure(figsize=plt.figaspect(1.0 / 3.0))
        fig.suptitle(f"Cube Pose Prediction Validation | Checkpoint: {ckpt_name}")

        ax = fig.add_subplot(131, projection="3d")
        plot_axes_from_pose(true_mat, true=True, ax=ax)
        plot_axes_from_pose(pred_mat, true=False, ax=ax)
        ax.set_title(f"Example {i} | Loss: {loss_val:.3f}")
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1, 1)
        ax.set_zlim(-1, 1)
        ax.set_aspect("equal")
        ax.legend(handles=[
            Line2D([0], [0], color="black", linestyle="-", label="true"),
            Line2D([0], [0], color="black", linestyle="--", label="pred"),
        ])

        for cam in range(min(n_cams, 2)):
            ax = fig.add_subplot(132 + cam)
            ax.imshow(np.clip(imgs_np[..., 3 * cam:3 * cam + 3], 0, 1))
            ax.set_title(f"Camera {cam + 1}")
            ax.axis("off")

        fig.savefig(os.path.join(output_path, f"example_{i}.png"), bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots()
    ax.hist(losses, bins=np.geomspace(0.001, 1e1, 20))
    ax.set_xscale("log")
    ax.set_title(f"Loss Histogram | Checkpoint: {ckpt_name}")
    ax.set_xlabel("Loss")
    ax.set_ylabel("Frequency")
    fig.savefig(os.path.join(output_path, "loss_histogram.png"), bbox_inches="tight")
    plt.close(fig)

    return {"mean_loss": float(np.mean(losses)), "losses": losses, "output_path": output_path}


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    validate(cli(ValConfig))
