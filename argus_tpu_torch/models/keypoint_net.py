"""CubeKeypointNet: corner heatmaps + multi-view pose fit, in PyTorch (eval
and training forward), and the geometry around it.

Port of `argus_tpu/models/keypoint_net.py`:

1. `CubeKeypointNet`: the cameras folded into the batch so one shared ResNet
   backbone sees every view, its stride-32 feature map upsampled to the
   heatmap stride by nearest-2x + conv3x3 (with bias) + LayerNorm + relu
   stages (`up{i}`, `up_norm{i}`), a 1x1 `heatmap` conv in f32, then a
   spatial softmax and soft-argmax per corner: (uv, probs).
2. `triangulate_points`: DLT triangulation through the normal equations of
   the stacked 2C x 4 system (a batched 3x3 solve).
3. `procrustes_pose`: orthogonal Procrustes (3x3 SVD with the reflection
   fixed) -> SE(3) 7-vector.
4. `fit_pose` (images' corners -> poses) and `keypoint_loss_fn` (MSE in
   pixels^2 against the ground-truth corners projected into each camera).

The head rounds where flax rounds under `dtype`: the conv in the compute
dtype with its bias added after the rounded conv; LayerNorm statistics in
f32 as E[x^2] - E[x]^2 (flax's `use_fast_variance`), epsilon 1e-6, the
normalised value in f32 then rounded; the heatmap conv, softmax and
soft-argmax in f32. `nominal_camera_matrices` places the cameras at the
rig's CAD-nominal mounts (`datagen.CAM1_NOMINAL`, `CAM2_NOMINAL`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from argus_tpu_torch.datagen import CAM1_NOMINAL, CAM2_NOMINAL
from argus_tpu_torch.geom import convert_pose_unity_to_mjpc, matrix_to_quat, quat_rotate
from argus_tpu_torch.models.resnet import BACKBONES, DTYPES, lecun_normal_


def cube_corners(half_width: float = 0.035) -> torch.Tensor:
    """(8, 3) corner offsets in the cube frame, +/- half_width per axis."""
    signs = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    return half_width * torch.tensor(signs, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _corners_on(half_width: float, device: torch.device) -> torch.Tensor:
    """`cube_corners(half_width)` on `device`, uploaded once per device (an
    upload from host memory waits for the device, and a train step captured
    in a CUDA graph may make none). Read-only."""
    return cube_corners(half_width).to(device)


@dataclass(frozen=True)
class CubeKeypointNetConfig:
    """Same fields and defaults as `argus_tpu.models.keypoint_net.
    CubeKeypointNetConfig`, so a checkpoint's stored config loads unchanged.
    The fuse flags default to "off" as in argus_tpu; under `bn_frozen` +
    `bn_frozen_affine` with `fuse_block`/`fuse_stem` "on" the identity
    BasicBlocks and the stem run the fused kernels. `fuse_proj` and
    `fuse_stage` are bottleneck-only and change nothing here."""

    n_cams: int = 2
    n_keypoints: int = 8
    backbone: str = "resnet18"
    head_features: int = 128
    heatmap_stride: int = 8
    dtype: str = "float32"
    bn_frozen: bool = False
    bn_frozen_affine: bool = False
    stem_frozen: bool = False
    frozen_stages: int = 0
    fuse_block: str = "off"
    fuse_proj: str = "off"
    fuse_stem: str = "off"
    fuse_stage: str = "off"


class HeadConv(nn.Module):
    """flax `nn.Conv` with a bias, "SAME" padding and stride 1 on NHWC:
    input and kernel cast to `dtype`, the conv rounded, then the bias (cast
    to `dtype`) added."""

    def __init__(self, cin: int, cout: int, k: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        lecun_normal_(self.weight)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.weight.to(dtype), padding=k // 2)
        return y.permute(0, 2, 3, 1) + self.bias.to(dtype)


class HeadLayerNorm(nn.Module):
    """flax `nn.LayerNorm` over the channels: f32 statistics with
    var = max(0, E[x^2] - E[x]^2), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias in f32, rounded to `dtype`."""

    def __init__(self, c: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(dtype)


class CubeKeypointNet(nn.Module):
    """(B, H, W, 3 * n_cams) images in [0, 1] -> (uv (B, n_cams, K, 2) pixel
    coordinates (u = x, v = y), probs (B * n_cams, H/stride, W/stride, K)
    post-softmax heatmaps)."""

    def __init__(self, cfg: CubeKeypointNetConfig = CubeKeypointNetConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.backbone = BACKBONES[cfg.backbone](
            output_dim=None,
            dtype=cfg.dtype,
            bn_frozen=cfg.bn_frozen,
            bn_frozen_affine=cfg.bn_frozen_affine,
            stem_frozen=cfg.stem_frozen,
            frozen_stages=cfg.frozen_stages,
            fuse_block=cfg.fuse_block,
            fuse_proj=cfg.fuse_proj,
            fuse_stem=cfg.fuse_stem,
            fuse_stage=cfg.fuse_stage,
        )
        cin = self.backbone.num_filters * 2 ** (len(self.backbone.stage_sizes) - 1)
        cin *= self.backbone.block_cls.expansion
        stride, i = 32, 0
        while stride > cfg.heatmap_stride:
            self.add_module(f"up{i}", HeadConv(cin, cfg.head_features, 3))
            self.add_module(f"up_norm{i}", HeadLayerNorm(cfg.head_features))
            cin, stride, i = cfg.head_features, stride // 2, i + 1
        self.n_up = i
        self.heatmap = HeadConv(cin, cfg.n_keypoints, 1)

    def forward(self, x: torch.Tensor, train: bool = False):
        cfg = self.cfg
        if x.ndim != 4:
            raise ValueError("input must be (B, H, W, 3*n_cams)")
        b, h, w, c = x.shape
        if c != 3 * cfg.n_cams:
            raise ValueError(f"expected {3 * cfg.n_cams} channels, got {c}")
        x = x.reshape(b, h, w, cfg.n_cams, 3).movedim(3, 1).reshape(b * cfg.n_cams, h, w, 3)
        y = self.backbone(x, train=train, return_spatial=True).to(self.dtype)
        for i in range(self.n_up):
            # nearest 2x (jax.image.resize at exactly 2x repeats each pixel)
            y = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            y = getattr(self, f"up{i}")(y, self.dtype)
            y = torch.relu(getattr(self, f"up_norm{i}")(y, self.dtype))
        logits = self.heatmap(y.float(), torch.float32)  # (N, h, w, K)

        # spatial softmax + soft-argmax over pixel centres at input resolution
        n, hh, ww, k = logits.shape
        probs = torch.softmax(logits.reshape(n, hh * ww, k), dim=1).reshape(n, hh, ww, k)
        us = (torch.arange(ww, dtype=torch.float32, device=x.device) + 0.5) * (w / ww)
        vs = (torch.arange(hh, dtype=torch.float32, device=x.device) + 0.5) * (h / hh)
        u = torch.einsum("nhwk,w->nk", probs, us)
        v = torch.einsum("nhwk,h->nk", probs, vs)
        uv = torch.stack([u, v], dim=-1)
        return uv.reshape(b, cfg.n_cams, k, 2), probs


def nominal_camera_matrices(height: int = 256, width: int = 256, fovy_deg: float = 52.0) -> torch.Tensor:
    """(2, 3, 4) f32 projection matrices of the rig's nominal cameras: the
    nominal mounts converted to the MuJoCo world frame and turned to look at
    the cube, with a pinhole of vertical FOV `fovy_deg` (MuJoCo's: the
    camera looks along -z, so K00 = -f, K11 = +f). Computed in float64
    numpy, as argus_tpu does."""
    f = 0.5 * height / np.tan(np.deg2rad(fovy_deg) / 2.0)
    kmat = np.array([[-f, 0.0, (width - 1) / 2.0], [0.0, f, (height - 1) / 2.0], [0.0, 0.0, 1.0]])
    target = np.array([0.0, 0.0, 0.05])
    up = np.array([0.0, 0.0, 1.0])
    mats = []
    for nominal in (CAM1_NOMINAL, CAM2_NOMINAL):
        pos = convert_pose_unity_to_mjpc(nominal[None])[0, :3]
        z_cam = pos - target
        z_cam = z_cam / np.linalg.norm(z_cam)
        x_cam = np.cross(up, z_cam)
        x_cam = x_cam / np.linalg.norm(x_cam)
        y_cam = np.cross(z_cam, x_cam)
        r_wc = np.stack([x_cam, y_cam, z_cam])  # world -> camera rows
        t = -r_wc @ pos
        mats.append(kmat @ np.concatenate([r_wc, t[:, None]], axis=1))
    return torch.from_numpy(np.stack(mats).astype(np.float32))


# ───────────────────────────── multi-view pose fitting ─────────────────────────────


def project_points(P: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """World points through 3x4 camera matrices: P (..., 3, 4), pts
    (..., K, 3) -> (..., K, 2) pixel coordinates (leading dims broadcast)."""
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    proj = homo @ P.transpose(-1, -2)  # (..., K, 3)
    z = proj[..., 2:]
    return proj[..., :2] / torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)


def triangulate_points(P: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of K points seen by C calibrated cameras: P (C, 3, 4),
    uv (..., C, K, 2) -> (..., K, 3), through the normal equations of the
    stacked 2C x 4 system (rows u P3 - P1 and v P3 - P2 per camera, split
    homogeneous), 1e-8 I added before the solve."""
    p1, p2, p3 = P[..., 0, :], P[..., 1, :], P[..., 2, :]  # (C, 4)
    u, v = uv[..., 0], uv[..., 1]  # (..., C, K)
    rows_u = u[..., None] * p3[:, None, :] - p1[:, None, :]  # (..., C, K, 4)
    rows_v = v[..., None] * p3[:, None, :] - p2[:, None, :]
    a = torch.cat([rows_u, rows_v], dim=-3).movedim(-3, -2)  # (..., K, 2C, 4)
    m, rhs = a[..., :3], -a[..., 3]
    mtm = m.transpose(-1, -2) @ m + 1e-8 * torch.eye(3, dtype=m.dtype, device=m.device)
    mtb = (m.transpose(-1, -2) @ rhs[..., None])
    return torch.linalg.solve(mtm, mtb)[..., 0]


def procrustes_pose(canonical: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """Rigid fit T minimising |T(canonical) - observed|: canonical (K, 3),
    observed (..., K, 3) -> (..., 7) xyzw poses. R = U diag(1, 1, det(U V^T))
    V^T from the SVD of the (observed x canonical) covariance, which the
    singular vectors' signs do not change; t from the centroids."""
    c0 = canonical.mean(-2)
    o0 = observed.mean(-2, keepdim=True)
    cov = (observed - o0).transpose(-1, -2) @ (canonical - c0)  # (..., 3, 3)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = (u * d[..., None, :]) @ vt
    t = o0[..., 0, :] - (r @ c0[:, None])[..., 0]
    return torch.cat([t, matrix_to_quat(r)], dim=-1)


def fit_pose(P: torch.Tensor, keypoints_uv: torch.Tensor, half_width: float = 0.035) -> torch.Tensor:
    """Per-camera 2D corners (B, n_cams, 8, 2) -> triangulated corners ->
    (B, 7) xyzw poses; P (n_cams, 3, 4)."""
    pts3d = triangulate_points(P, keypoints_uv)
    return procrustes_pose(_corners_on(half_width, pts3d.device), pts3d)


def keypoint_loss_fn(
    keypoints_uv: torch.Tensor, pose_true: torch.Tensor, P: torch.Tensor, half_width: float = 0.035
) -> torch.Tensor:
    """Per-sample keypoint supervision, in f32: the mean over cameras and
    corners of the squared pixel distance between the predicted corners
    (B, n_cams, 8, 2) and the true pose's (B, 7) corners projected through
    P (n_cams, 3, 4). Returns (B,)."""
    corners = _corners_on(half_width, pose_true.device)
    world = quat_rotate(pose_true[:, None, 3:7], corners[None]) + pose_true[:, None, :3]  # (B, 8, 3)
    target_uv = project_points(P[None], world[:, None])  # (B, n_cams, 8, 2)
    return ((keypoints_uv.float() - target_uv) ** 2).sum(-1).mean(dim=(-2, -1))
