"""NCameraCNN: the N-camera cube-pose regressor, in PyTorch (eval and
training forward).

Port of `argus_tpu/models/pose_cnn.py`: the cameras are folded into the batch
so one shared ResNet backbone sees every view, the per-camera features are
concatenated, then exact GELU and a 128-128-6 head. The head's first two
layers run in the compute dtype and `head_out` in f32; casts are explicit
(no autocast) so bf16 rounds where flax rounds. The output is a raw se(3)
6-vector; `geom.se3_exp` maps it to a pose. `forward(x, train=True)` is the
training forward of the backbone (see `models.resnet`); the head
differentiates by autograd.

Under tensor parallelism (`parallel.tp.shard_model_`, `num_model_shards`
k > 1) each rank of the model group holds output features
`[m D / k, (m + 1) D / k)` of `backbone.fc` (and its bias), and the columns
of `head_fc1` that read them: each camera's block of D columns cut the
same way, not argus_tpu's contiguous block of the concatenation (GSPMD
reshards the features there; here they stay where the fc made them).
`head_fc1` is then a row-parallel product: each rank's partial product is
summed over the model group before its bias, and the gradient entering
the 2048-wide pooled features is summed over the group inside the
backbone. Both sums are of f32 partials, formed from the compute dtype's
inputs and rounded to it once after the sum, where the unsharded layer
rounds its product once: the numbers are the unsharded model's up to the
order of f32 sums; memory and work are split.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from argus_tpu_torch.models.resnet import BACKBONES, DTYPES
from argus_tpu_torch.parallel.collectives import reduce_from_model


@dataclass(frozen=True)
class NCameraCNNConfig:
    """Same fields and defaults as `argus_tpu.models.NCameraCNNConfig`, so a
    checkpoint's stored config loads unchanged, and each reaches the
    backbone as in argus_tpu: the BN mode (`bn_frozen`, `bn_frozen_affine`,
    else exact train-mode BN with `bn_stats_stride`, `bn_grad_stride` and
    the reduction engine `bn_impl`), `stem_frozen`, `stem_grad_stride` (the
    fused stem's weight gradient on 1/s of the images), `frozen_stages`,
    `fuse_pointwise` and `remat` / `remat_stages` (a block's interior
    recomputed in the backward). None of them changes eval."""

    n_cams: int = 2
    resnet_output_dim: int = 1024
    backbone: str = "resnet50"
    dtype: str = "float32"
    stem_space_to_depth: bool = False
    stem_frozen: bool = False
    stem_grad_stride: int = 1
    frozen_stages: int = 0
    bn_stats_stride: int = 1
    bn_grad_stride: int = 1
    bn_impl: str = "xla"
    bn_frozen: bool = False
    bn_frozen_affine: bool = False
    fuse_pointwise: str = "off"
    fuse_block: str = "auto"
    fuse_block_stages: tuple = (0, 1, 2, 3)
    fuse_proj: str = "auto"
    fuse_stem: str = "auto"
    fuse_stage: str = "auto"
    fuse_stage_stages: tuple = (0,)
    remat: bool = False
    remat_stages: tuple = ()


def _dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax Dense with `dtype`: input, kernel and bias cast to it, the
    product rounded before the bias add."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class NCameraCNN(nn.Module):
    """(B, H, W, 3 * n_cams) images in [0, 1] -> (B, 6) se(3) tangents."""

    model_group = None  # the tensor-parallel process group, when the wide layers are cut

    def __init__(self, cfg: NCameraCNNConfig = NCameraCNNConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        self.backbone = BACKBONES[cfg.backbone](
            output_dim=cfg.resnet_output_dim,
            dtype=cfg.dtype,
            stem_space_to_depth=cfg.stem_space_to_depth,
            stem_frozen=cfg.stem_frozen,
            stem_grad_stride=cfg.stem_grad_stride,
            frozen_stages=cfg.frozen_stages,
            bn_stats_stride=cfg.bn_stats_stride,
            bn_grad_stride=cfg.bn_grad_stride,
            bn_impl=cfg.bn_impl,
            bn_frozen=cfg.bn_frozen,
            bn_frozen_affine=cfg.bn_frozen_affine,
            fuse_pointwise=cfg.fuse_pointwise,
            fuse_block=cfg.fuse_block,
            fuse_block_stages=cfg.fuse_block_stages,
            fuse_proj=cfg.fuse_proj,
            fuse_stem=cfg.fuse_stem,
            fuse_stage=cfg.fuse_stage,
            fuse_stage_stages=cfg.fuse_stage_stages,
            remat=cfg.remat,
            remat_stages=cfg.remat_stages,
        )
        self.head_fc1 = nn.Linear(cfg.n_cams * cfg.resnet_output_dim, 128)
        self.head_fc2 = nn.Linear(128, 128)
        self.head_out = nn.Linear(128, 6)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("The input images must be of shape (B, H, W, C)! If B=1, add a dummy dimension.")
        cfg = self.cfg
        b, h, w, c = x.shape
        if c != 3 * cfg.n_cams:
            raise ValueError(f"Expected {3 * cfg.n_cams} channels (n_cams={cfg.n_cams}), got {c}.")
        # fold cameras into the batch so one backbone (shared weights) sees all views
        x = x.reshape(b, h, w, cfg.n_cams, 3).movedim(3, 1).reshape(b * cfg.n_cams, h, w, 3)
        feats = F.gelu(self.backbone(x, train=train).reshape(b, -1))
        if self.model_group is None:
            y = F.gelu(_dense(self.head_fc1, feats, self.dtype))
        else:
            # this rank's partial product in f32, summed, then rounded once as `_dense` rounds it
            part = F.linear(feats.to(self.dtype).float(), self.head_fc1.weight.to(self.dtype).float())
            y = F.gelu(reduce_from_model(part, self.model_group).to(self.dtype) + self.head_fc1.bias.to(self.dtype))
        y = F.gelu(_dense(self.head_fc2, y, self.dtype))
        return _dense(self.head_out, y, torch.float32)


def init_model(cfg: NCameraCNNConfig, seed_or_generator=0, height: int = 256, width: int = 256,
               device=None) -> NCameraCNN:
    """A fresh NCameraCNN with flax's initialisers (`train._init_`: lecun-
    normal kernels, zero biases, each residual block's last BN scale at
    zero) drawn from `seed_or_generator` (an int seed or a CPU
    `torch.Generator`), moved to `device` (CUDA unless the caller names the
    CPU). argus_tpu's `init_model` returns (model, variables) from a dummy
    forward at (height, width); the port's modules know their shapes at
    construction, so the size is not read and the weights live in the
    returned module."""
    from argus_tpu_torch import resolve_device
    from argus_tpu_torch.train import _init_

    del height, width
    device = resolve_device(device)
    gen = seed_or_generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    with torch.random.fork_rng(devices=[]):  # construction's default draws are overwritten; keep the caller's RNG
        model = NCameraCNN(cfg)
    _init_(model, gen)
    return model.to(device)
