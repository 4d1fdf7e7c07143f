"""Serving: uint8 camera frames -> SE(3) cube poses, as a long-lived object.

Port of `argus_tpu/serve.py` `Estimator` for both model families. The
estimator reads the model family and config from a format-2 checkpoint's
metadata (an explicit config overrides), picks the serving configuration by
batch size, loads the weights through the weight bridge, folds every frozen
BN affine into its conv once, and warms the model up. `predict` converts
uint8 frames with ``u8.float() / 255.0``, runs the model, then `se3_exp`
(NCameraCNN) or `fit_pose` through the nominal cameras at the serving
resolution (CubeKeypointNet), and returns (B, 7) xyzw poses (or MuJoCo wxyz
order) as numpy.

From batch `SERVING_FUSED_MIN_BATCH` up, `throughput_tuned_config` switches a
bottleneck backbone to bf16, frozen BN and the fused kernels under "auto":
on the card, the stem, the stage-0 chain, the stage 1-3 projection blocks
and the identity blocks run the hand-written CUDA kernels wherever
`models.resnet.AUTO_FUSE` names them. A BasicBlock backbone
(the keypoint family's ResNet-18) takes bf16 and folded BN but keeps its
convolutions unfused, as argus_tpu does. Below it the f32 model runs with
plain convolutions.

The export path (`export_estimator` / `ExportedEstimator`) is not ported yet
(ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from argus_tpu_torch import resolve_device
from argus_tpu_torch.checkpoint import load_checkpoint_with_meta
from argus_tpu_torch.geom import se3_exp, xyzxyzw_to_xyzwxyz_SE3
from argus_tpu_torch.models import resolve_model
from argus_tpu_torch.models.jax_import import state_dict_from_variables
from argus_tpu_torch.models.keypoint_net import fit_pose, nominal_camera_matrices
from argus_tpu_torch.models.resnet import BACKBONE_BLOCKS, BottleneckBlock

# fuse fields that both tuners switch, in one place
_FUSE_FIELDS = ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage")

# batch size from which batched serving takes the fused bf16 path, the
# crossover argus_tpu chose
SERVING_FUSED_MIN_BATCH = 8


def _bottleneck(cfg) -> bool:
    """Whether the config's backbone is built from bottleneck blocks, read
    from its block class rather than a list of names."""
    return BACKBONE_BLOCKS.get(getattr(cfg, "backbone", "")) is BottleneckBlock


def latency_tuned_config(cfg):
    """Single-frame serving: every fused kernel off. No-op for configs
    without fuse fields."""
    names = {f.name for f in dataclasses.fields(cfg)} & {*_FUSE_FIELDS, "fuse_pointwise"}
    if not names:
        return cfg
    return dataclasses.replace(cfg, **{name: "off" for name in names})


def throughput_tuned_config(cfg):
    """Batched serving: at eval exact BN equals frozen BN (both apply the
    running statistics), so fold BN and run bf16; the fused kernels engage
    for bottleneck backbones only, under "auto" (argus_tpu sets "on"): each
    kernel function runs where `models.resnet.AUTO_FUSE` measured it faster
    than cuDNN. BasicBlock backbones stay unfused, as in argus_tpu. No-op
    for configs without fuse fields."""
    names = {f.name for f in dataclasses.fields(cfg)} & set(_FUSE_FIELDS)
    if not names:
        return cfg
    on = "auto" if _bottleneck(cfg) else "off"
    return dataclasses.replace(
        cfg, bn_frozen=True, bn_frozen_affine=True, dtype="bfloat16", **{name: on for name in names}
    )


def serving_tuned_config(cfg, batch_size: int):
    """The serving configuration for a batch size: fused bf16 from
    `SERVING_FUSED_MIN_BATCH` up, plain f32 below."""
    if batch_size >= SERVING_FUSED_MIN_BATCH:
        return throughput_tuned_config(cfg)
    return latency_tuned_config(cfg)


class Estimator:
    """uint8 images -> SE(3) cube-pose estimator.

    `device=None` runs on CUDA and raises without a card; pass
    `device="cpu"` for the plain PyTorch path."""

    def __init__(
        self,
        checkpoint_path: str,
        model_config=None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        batch_size: int = 1,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        raw, meta = load_checkpoint_with_meta(checkpoint_path)
        _, cfg, self.model_type = resolve_model(meta, model_config)
        self.cfg = serving_tuned_config(cfg, batch_size)
        model, _, _ = resolve_model({}, self.cfg)
        # an explicit height/width wins, then the checkpoint's training crop, then 256
        if height is None or width is None:
            crop = meta.get("center_crop")
            mh, mw = (int(v) for v in crop) if crop else (256, 256)
            height = mh if height is None else height
            width = mw if width is None else width
        self.hw = (height, width)
        self.batch_size = batch_size
        self.cam_P = (nominal_camera_matrices(height, width).to(self.device)
                      if self.model_type == "keypoint" else None)

        reference = model.state_dict()
        sd = state_dict_from_variables(raw["params"], raw["batch_stats"], reference)
        model.load_state_dict(sd, strict=True)
        self.model = model.to(self.device).eval()
        self.model.backbone.fold_frozen_bn()
        # warm up so the first real call pays no first-use costs (kernel builds, cuDNN plans)
        dummy = np.zeros((batch_size, height, width, 3 * self.cfg.n_cams), np.uint8)
        self.predict(dummy)

    @torch.inference_mode()
    def _infer(self, images_u8: torch.Tensor) -> torch.Tensor:
        images = images_u8.to(self.device, non_blocking=True).float() / 255.0
        pred = self.model(images)
        if self.model_type == "keypoint":
            uv, _ = pred
            return fit_pose(self.cam_P, uv)
        return se3_exp(pred)

    def predict(self, images: np.ndarray, wxyz: bool = False) -> np.ndarray:
        """Poses for a uint8 batch (B, H, W, 3 * n_cams): (B, 7), xyzw
        quaternions, or MuJoCo's wxyz order with `wxyz=True`."""
        if not isinstance(images, np.ndarray) or images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be a uint8 numpy array of shape (B, H, W, 3 * n_cams)")
        poses = self._infer(torch.from_numpy(images)).cpu().numpy()
        return xyzxyzw_to_xyzwxyz_SE3(poses) if wxyz else poses

    def predict_frames(self, frames: Sequence[np.ndarray], wxyz: bool = False) -> np.ndarray:
        """One pose from per-camera frames [(H, W, 3), ...] (uint8)."""
        stacked = np.concatenate(frames, axis=-1)[None]
        return self.predict(stacked, wxyz=wxyz)[0]
