"""Training of the port: the train step of either model family (the
NCameraCNN pose regressor or the CubeKeypointNet corner detector), the eval
step, the plateau schedule and the epoch loop with checkpoints, in PyTorch
on the card.

Port of `argus_tpu/train.py` (`TrainConfig`, `geometric_loss_fn`,
`make_optimizer`, `TrainState`, `create_train_state`, `make_train_step`,
`make_eval_step`, `ReduceLROnPlateau`, `initialize_training`, `train`,
`checkpoint_meta`): bf16 (`amp`) or f32, exact train-mode
BN (batch statistics, running statistics updated) or argus_tpu's frozen-BN
fine-tune modes (running statistics, the affine trained or frozen), any
frozen or trained stem and frozen stages, full backprop through the rest;
on the card the fused kernels of `ops.kernels` (with their backward
kernels) under frozen BN and affine, BatchNorm's reduction kernels under
exact BN with `bn_impl` "pallas" or "auto". The step is

    images = u8_to_f32(batch["images"], bf16 if amp else f32)
    images = apply_augmentation(augmentation_config, fold_in(base_seed, step), images)
    loss   = sum(losses(model(images), poses) * mask) / max(sum(mask), 1)
    grads  = d loss / d params                (zero for frozen parameters)
    params += -lr * adam(clip_by_global_norm(grads, max_grad_norm))

with optax's formulas for the clip and for Adam (b1 0.9, b2 0.999, eps 1e-8
outside the square root, both moments bias-corrected), the learning rate
applied outside the optimizer so a schedule can change it. `losses` is
`geometric_loss_fn` for the pose regressor (`model_type="pose_cnn"`) and
`keypoint_loss_fn(uv, poses, nominal_camera_matrices(*crop))` for the
keypoint family (`model_type="keypoint"`, `keypoint_config`), with the crop
the step's `hw`, else the dataset config's, else (256, 256).

The augmentation (`use_augmentation`, argus_tpu's default) runs in the feed
dtype through `ops.augment` (the fused kernel on the card). After a step
`state.batch_stats`, the model's own BN buffers, hold the running
statistics argus_tpu's step returns as `new_batch_stats`.

`train(cfg)` is argus_tpu's loop, on one card or one process a card
(`multigpu`, below). Its data path is argus_tpu's
choice by `device_resident_mb`: the whole train split on the card
(`data.resident.DeviceResidentData`) when it fits the budget, shards of it
swapped in per epoch (`data.resident.ResidentShardedData`) past it, and the
host loader (`data.HostDataLoader`) with the device feed
(`data.feed.device_prefetch`) at 0. On the resident paths an epoch runs
through `make_resident_epoch_step`: batches gathered on the card, the step
captured once as a CUDA graph and replayed. Then a train step per batch
with the losses fetched in blocks of 50, an eval pass per `val_epochs`
whose mean loss drives the plateau schedule, a format-2 checkpoint of the
whole train state per `save_epochs` (written by
`checkpoint.AsyncCheckpointer`), a SIGTERM guard that saves and returns,
and `resume_from`. `python -m argus_tpu_torch.train --dataset-config.dataset-path
DIR ...` runs it from the command line (`configs.cli`).

`grad_accum_steps > 1` splits the augmented batch into microbatches and
combines their gradients by mask count before one clip and Adam step
(frozen BN only, as argus_tpu requires).

Data and tensor parallelism (`multigpu`, `num_chips`, `num_model_shards`)
run one process per card (`parallel`: `init_distributed`, `make_mesh`).
With a mesh the step is argus_tpu's data-parallel step
(`_shard_loss_and_grad`): each rank takes its rows of the global batch
(`Mesh.local_rows`), samples the augmentation for the global row count and
keeps its rows, computes the unnormalised masked loss sum and its gradient
(summed over its microbatches under accumulation), and one bucketed
all-reduce over the data group sums `[loss_sum, mask_count, gradients]`
before everything is divided by max(global count, 1); the clip and Adam
then run alike on every rank, so the parameters stay equal. Exact BN takes
its statistics over the global batch (`ops.norm`). Under
`num_model_shards` k > 1 the wide dense layers are cut over the model
group (`parallel.tp`), their Adam moments with them, and the clip's norm
sums the sharded leaves' squares over the group. `train()` under
`multigpu` prints, logs and writes checkpoints (whole tensors, gathered)
on rank 0, and every rank reads `resume_from`. The entry points run on
CUDA unless the caller passes `device="cpu"`, and raise without a card.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
import sys
import time
from typing import Dict, Optional

import numpy as np

import torch
import torch.distributed as dist

from argus_tpu_torch import ROOT, resolve_device
from argus_tpu_torch.capture import WARMUP_STEPS, CapturedCall
from argus_tpu_torch.checkpoint import AsyncCheckpointer, load_checkpoint, save_checkpoint
from argus_tpu_torch.data.dataset import CameraCubePoseDataset, CameraCubePoseDatasetConfig, HostDataLoader
from argus_tpu_torch.data.feed import device_prefetch
from argus_tpu_torch.data.resident import DeviceResidentData, ResidentShardedData
from argus_tpu_torch.geom import se3_exp, se3_inverse, se3_log, se3_multiply
from argus_tpu_torch.models import CubeKeypointNetConfig, NCameraCNNConfig, resolve_model
from argus_tpu_torch.models.keypoint_net import (
    HeadConv,
    HeadLayerNorm,
    fit_pose,
    keypoint_loss_fn,
    nominal_camera_matrices,
)
from argus_tpu_torch.models.resnet import BasicBlock, BottleneckBlock, Conv, lecun_normal_
from argus_tpu_torch.ops import augment
from argus_tpu_torch.ops.augment import AugmentationConfig
from argus_tpu_torch.ops.image import u8_to_f32
from argus_tpu_torch.ops.norm import BatchNorm
from argus_tpu_torch.parallel.collectives import (
    agree_any,
    all_reduce_,
    all_reduce_loss_and_grads,
    broadcast_object,
)
from argus_tpu_torch.parallel.mesh import Mesh, make_mesh
from argus_tpu_torch.parallel.tp import shard_state, whole_state


# ───────────────────────────── config ─────────────────────────────


@dataclass
class TrainConfig:
    """argus_tpu's `TrainConfig`: the same field names and defaults, so a
    configuration moves between the packages unchanged, except that
    construction creates no directory (argus_tpu makes `save_dir` at once).
    See argus_tpu's docstring for what each field means; the step here reads
    `model_type` and the family's config (`model_config` or
    `keypoint_config`), `amp`, `max_grad_norm`, `learning_rate`,
    `use_augmentation`, `grad_accum_steps`, the multi-card fields and, for
    the keypoint family's cameras, the dataset config's `center_crop`."""

    dataset_config: Optional[CameraCubePoseDatasetConfig] = None
    model_config: NCameraCNNConfig = field(default_factory=NCameraCNNConfig)
    model_type: str = "pose_cnn"
    keypoint_config: CubeKeypointNetConfig = field(default_factory=CubeKeypointNetConfig)
    compile_model: bool = True

    batch_size: int = 32
    learning_rate: float = 1e-4
    n_epochs: int = 100
    max_grad_norm: float = 1.0
    random_seed: int = 42

    multigpu: bool = False
    num_chips: Optional[int] = None
    num_model_shards: int = 1
    amp: bool = False
    num_workers: int = field(default_factory=lambda: min(16, max(1, os.cpu_count() or 1)))
    grad_accum_steps: int = 1
    device_resident_mb: float = 2048.0

    val_epochs: int = 1
    print_epochs: int = 1
    save_epochs: int = 5
    save_dir: str = os.path.join(ROOT, "outputs", "models")
    async_checkpoint: bool = True

    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    use_augmentation: bool = True
    val_spaghetti: bool = True

    wandb_project: str = "argus-estimator"
    wandb_log: bool = True
    resume_from: Optional[str] = None


def check_config(cfg: TrainConfig, mesh: Optional[Mesh] = None) -> None:
    """Raise `ValueError` where `cfg` and the mesh the step runs over
    disagree: the model axis must be `num_model_shards`, the world
    `num_chips` when that is set, and the global batch must divide over
    the data ranks and over the nodes (argus_tpu's asserts,
    `argus_tpu/train.py:626-631`). Without a mesh the step runs on one
    card and the multi-card fields are not read, as argus_tpu's mesh of
    one device ignores them."""
    if mesh is None:
        return
    if cfg.num_model_shards != mesh.n_model:
        raise ValueError(f"num_model_shards={cfg.num_model_shards} but the mesh's model axis has {mesh.n_model} ranks")
    if cfg.num_chips is not None and cfg.num_chips != mesh.world_size:
        raise ValueError(f"num_chips={cfg.num_chips} but the process group has {mesh.world_size} ranks")
    if cfg.batch_size % mesh.n_data:
        raise ValueError(f"global batch {cfg.batch_size} must divide over {mesh.n_data} data shards")
    if cfg.batch_size % mesh.n_nodes:
        raise ValueError(f"global batch {cfg.batch_size} must divide over {mesh.n_nodes} host processes (nodes)")


# ───────────────────────────── loss ─────────────────────────────


def geometric_loss_fn(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Geodesic SE(3) loss || Log(Exp(pred) . target^-1) ||^2 per sample, in
    f32: pred (..., 6) se(3) vectors, target (..., 7) poses (xyzw)."""
    err = se3_log(se3_multiply(se3_exp(pred.float()), se3_inverse(target.float())))
    return (err**2).sum(-1)


def make_loss_fn(cfg: TrainConfig, hw: Optional[tuple] = None):
    """The per-sample loss `losses(model_output, poses) -> (B,)` of the
    configured family: `geometric_loss_fn`, or for the keypoint family
    `keypoint_loss_fn` through the nominal cameras at the training crop
    (`training_crop`), as argus_tpu's `make_train_step_body` builds them."""
    model_type, _ = _resolved_model_config(cfg)
    if model_type != "keypoint":
        return geometric_loss_fn
    cam_P = nominal_camera_matrices(*training_crop(cfg, hw))
    on_device = {}  # one upload per device, not one per step

    def losses(pred, poses):
        uv, _ = pred
        if uv.device not in on_device:
            on_device[uv.device] = cam_P.to(uv.device)
        return keypoint_loss_fn(uv, poses, on_device[uv.device])

    return losses


# ───────────────────────────── optimizer ─────────────────────────────


@dataclass
class AdamState:
    """optax `ScaleByAdamState`: the step count and both moments, keyed by
    parameter name (`models.jax_import` converts it to and from optax's)."""

    count: torch.Tensor  # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Optimizer:
    """`optax.chain(clip_by_global_norm(max_grad_norm), scale_by_adam())`:

        g    = g if |g| < max_grad_norm else g / (|g| / max_grad_norm)
        mu   = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
        step = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)

    with |g| the global norm over every leaf. Not `clip_grad_norm_`, which
    adds 1e-6 to the norm. The learning rate is applied by the caller.
    Under tensor parallelism (`model_group`, the names of the `sharded`
    leaves) each rank holds slices of the sharded leaves: their squares are
    summed over the model group once, and each replicated leaf counts once."""

    def __init__(self, max_grad_norm: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.model_group, self.sharded = None, frozenset()

    def _global_norm(self, names, g) -> torch.Tensor:
        norms = torch._foreach_norm(g)
        if self.model_group is None or not self.sharded:
            return torch.linalg.vector_norm(torch.stack(norms))
        cut = [n for k, n in zip(names, norms) if k in self.sharded]
        whole = [n for k, n in zip(names, norms) if k not in self.sharded]
        sq = all_reduce_(torch.stack(cut).square().sum(), self.model_group)
        if whole:
            sq = sq + torch.stack(whole).square().sum()
        return torch.sqrt(sq)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}  # noqa: E731
        dev = next(iter(params.values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState) -> Dict[str, torch.Tensor]:
        """The Adam step of each leaf for `grads`; advances `state` in place
        (count and moments)."""
        names = list(state.mu)
        g = [grads[k].float() for k in names]
        norm = self._global_norm(names, g)
        div = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), norm / self.max_grad_norm)
        g = torch._foreach_div(g, div)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        state.count += 1
        count = state.count.float()
        one = torch.ones((), device=count.device)
        bc1 = one - torch.pow(torch.full_like(one, self.b1), count)
        bc2 = one - torch.pow(torch.full_like(one, self.b2), count)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return dict(zip(names, torch._foreach_div(torch._foreach_div(mu, bc1), den)))


def make_optimizer(max_grad_norm: float) -> Optimizer:
    """clip-then-Adam, the reference's order (unscale -> clip -> step)."""
    return Optimizer(max_grad_norm)


# ───────────────────────────── train state ─────────────────────────────


@dataclass
class TrainState:
    """argus_tpu's `TrainState`. `params` and `batch_stats` are the model's
    own parameters and BN buffers (by state_dict name), so a step updates
    the model in place. `step`, the count of steps taken, lives on the host
    (argus_tpu keeps it on the device): the step seeds its augmentation from
    it without reading the device back, and a resumed run sets it."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: AdamState
    lr: torch.Tensor  # f32 scalar, the current learning rate
    shardings: dict = field(default_factory=dict)  # {name: parallel.Shard} of the leaves cut over the model group


def _resolved_model_config(cfg: TrainConfig):
    """(model_type, model config with the amp dtype override applied)."""
    model_type = getattr(cfg, "model_type", "pose_cnn")
    mcfg = cfg.keypoint_config if model_type == "keypoint" else cfg.model_config
    if cfg.amp and mcfg.dtype != "bfloat16":
        mcfg = dataclasses.replace(mcfg, dtype="bfloat16")
    return model_type, mcfg


def training_crop(cfg: TrainConfig, hw: Optional[tuple] = None) -> tuple:
    """The training resolution: `hw`, else the dataset config's crop, else
    (256, 256)."""
    ds = getattr(cfg, "dataset_config", None)
    return tuple(hw or (getattr(ds, "center_crop", None) if ds is not None else None) or (256, 256))


def checkpoint_meta(cfg: TrainConfig, hw: Optional[tuple] = None) -> dict:
    """Model metadata stored inside checkpoints (format 2): the family, the
    config that trained (amp override applied) and the training crop."""
    model_type, mcfg = _resolved_model_config(cfg)
    return {"model_type": model_type, "model_config": dataclasses.asdict(mcfg),
            "center_crop": list(training_crop(cfg, hw))}


def build_model(cfg: TrainConfig):
    """The configured model family with the amp dtype override, and its
    camera count."""
    _, mcfg = _resolved_model_config(cfg)
    model, _, _ = resolve_model({}, mcfg)
    return model, mcfg.n_cams


def _init_(model: torch.nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers: every conv and dense kernel lecun-normal (a
    truncated normal, `lecun_normal_`) drawn from `generator`, dense and
    head-conv biases zero, the last BN scale of each residual block at zero
    (`models/resnet.py:120, 301`), the head's LayerNorms at scale one and
    bias zero."""
    for mod in model.modules():
        if isinstance(mod, (Conv, torch.nn.Linear, HeadConv)):
            lecun_normal_(mod.weight, generator)
            if getattr(mod, "bias", None) is not None:
                torch.nn.init.zeros_(mod.bias)
        if isinstance(mod, BottleneckBlock):
            mod.BatchNorm_2.weight.data.zero_()
        elif isinstance(mod, BasicBlock):
            mod.BatchNorm_1.weight.data.zero_()
        elif isinstance(mod, HeadLayerNorm):
            torch.nn.init.ones_(mod.weight)
            torch.nn.init.zeros_(mod.bias)


def create_train_state(cfg: TrainConfig, seed: int = 0, sample_hw: tuple = (256, 256), device=None,
                       mesh: Optional[Mesh] = None):
    """Initialise the model from `seed` and the optimizer state. Returns
    (model, state). `sample_hw` is argus_tpu's init resolution; the port's
    modules need no sample input to initialise. Every rank of a `mesh`
    draws the same weights; with a model axis the wide dense layers are
    then cut to this rank's slices with their Adam moments
    (`parallel.tp.shard_state`; the cut leaves listed in `state.shardings`)."""
    del sample_hw
    device = resolve_device(device)
    check_config(cfg, mesh)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, _ = build_model(cfg)
    _init_(model, torch.Generator().manual_seed(seed))
    model = model.to(device)
    params = dict(model.named_parameters())
    state = TrainState(
        step=0,
        params=params,
        batch_stats=dict(model.named_buffers()),
        opt_state=make_optimizer(cfg.max_grad_norm).init(params),
        lr=torch.tensor(cfg.learning_rate, dtype=torch.float32, device=device),
    )
    if mesh is not None:
        state = shard_state(model, state, mesh)
    return model, state


# ───────────────────────────── step ─────────────────────────────


class TrainStepBody:
    """argus_tpu's `make_train_step_body` in two parts, so that the second
    can be captured in a CUDA graph:

    - `prepare(step, images, poses, mask)`: the host's share. Feeds the
      uint8 frames (`feed_images`) and samples the step's augmentation from
      `fold_in(base_seed, step)` (~100 small ops of host time). On the fused
      path it packs the kernel's operands; on the per-op path it augments.
      Returns the step's operands, all tensors on the device.
    - `compute(state, operands)`: the rest. The `augment_fused` launch on the
      fused path, then the forward and backward, the clip and Adam, with the
      parameters, moments and count updated in place; returns the loss. It
      makes no upload from host memory and reads nothing back.

    With `grad_accum_steps` k > 1 the augmented batch is cut into k
    microbatches; each one's masked-mean loss and gradient are weighted by
    its mask count and summed in f32, then divided by max(total count, 1),
    before one clip and Adam step. Microbatch BN statistics would differ
    from the whole batch's, so k > 1 needs frozen BN (`ValueError`
    otherwise, where argus_tpu asserts), and the batch must divide by k.
    `hw`, the training crop, places the keypoint family's cameras
    (`make_loss_fn`).

    With a `mesh` the operands are this rank's rows of the global batch:
    the augmentation is sampled for the global row count (its colour
    order one global draw) and this rank keeps its rows, and the loss and
    gradient are argus_tpu's data-parallel ones (`_dp_loss_and_grads`).
    The model's BatchNorms take their statistics over the data group."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, base_seed: int = 0, hw=None, device=None,
                 mesh: Optional[Mesh] = None):
        device = resolve_device(device)
        on = next(model.parameters()).device
        if on != device and not (device.index is None and on.type == device.type):
            raise ValueError(f"the model lives on {on}; the train step runs on {device}")
        _, mcfg = _resolved_model_config(cfg)
        self.accum = max(1, int(cfg.grad_accum_steps))
        if self.accum > 1 and not mcfg.bn_frozen:
            raise ValueError("grad_accum_steps > 1 requires bn_frozen (exact accumulation)")
        self.model, self.cfg, self.base_seed, self.device = model, cfg, base_seed, on
        self.opt = make_optimizer(cfg.max_grad_norm)
        self.losses = make_loss_fn(cfg, hw)
        self.n_cams = model.cfg.n_cams
        self.fused = cfg.use_augmentation and augment.fused_applies(cfg.augmentation_config, on)
        self.ahead = {}  # (step, images' shape and dtype) -> that step's parameters, sampled a step early
        self.mesh = mesh
        if mesh is None and getattr(model, "shardings", None):
            raise ValueError("the model's wide layers are cut over a model group: its step needs that mesh")
        for mod in model.modules():  # set on every body, so no group of an earlier body's mesh stays behind
            if isinstance(mod, BatchNorm):
                mod.group = None if mesh is None else mesh.data_group
        if mesh is not None:
            self.opt.model_group = mesh.model_group
            self.opt.sharded = frozenset(getattr(model, "shardings", None) or ())

    def _sample(self, step: int, images: torch.Tensor):
        like = (step, tuple(images.shape), images.dtype)
        drawn = self.ahead.pop(like, None)
        if drawn is None:
            B, H, W, _ = images.shape
            n_data = 1 if self.mesh is None else self.mesh.n_data
            drawn = augment.sample_params(self.cfg.augmentation_config, augment.fold_in(self.base_seed, step),
                                          B * n_data, self.n_cams, H, W, images.device, images.dtype)
            if self.mesh is not None:
                rows = self.mesh.local_rows(B * n_data)
                drawn = augment.take_rows(drawn, rows.start * self.n_cams, rows.stop * self.n_cams)
        return drawn

    def sample_ahead(self, step: int, operands: dict) -> None:
        """Sample step `step`'s augmentation now, for a batch like
        `operands`' (the host path calls this once its step is queued, so
        the sampling overlaps the device's work)."""
        self.ahead.clear()
        if self.cfg.use_augmentation:
            self.ahead[(step, tuple(operands["images"].shape), operands["images"].dtype)] = \
                self._sample(step, operands["images"])

    def prepare(self, step: int, images, poses, mask) -> dict:
        on = self.device
        out = {"images": feed_images(self.cfg, images, on),
               "poses": torch.as_tensor(poses).to(on, torch.float32),
               "mask": torch.as_tensor(mask).to(on, torch.float32)}
        if self.cfg.use_augmentation:
            drawn = self._sample(step, out["images"])
            aug = self.cfg.augmentation_config
            if self.fused:
                B, H, W, _ = out["images"].shape
                field, _, _, packed, order = augment.pack_fused(drawn, B * self.n_cams, H, W, aug.num_spaghetti, on)
                out.update(field=field, packed=packed, order=order)
            else:
                out["images"] = augment.apply_params(aug, drawn, out["images"], self.n_cams)
        return out

    def augmented(self, operands: dict) -> torch.Tensor:
        """The step's images: on the fused path the `augment_fused` launch
        on the packed operands, else the images `prepare` augmented."""
        images = operands["images"]
        if "field" in operands:
            _, H, W, _ = images.shape
            field = operands["field"]
            mh, mwt = augment.resize_matrices(H, W, field.shape[-1], images.device)
            images = augment.apply_packed(self.cfg.augmentation_config,
                                          (field, mh, mwt, operands["packed"], operands["order"]), images, self.n_cams)
        return images

    def compute(self, state: TrainState, operands: dict) -> torch.Tensor:
        loss, grads = self._loss_and_grads(state.params, self.augmented(operands), operands["poses"], operands["mask"])
        updates = self.opt.update(grads, state.opt_state)
        names = list(state.params)
        with torch.no_grad():
            torch._foreach_add_([state.params[k] for k in names],
                                torch._foreach_mul([updates[k] for k in names], -state.lr))
        return loss

    def _loss_and_grads(self, params, images, poses, mask):
        if self.mesh is not None:
            return self._dp_loss_and_grads(params, images, poses, mask)
        if self.accum == 1:
            return _loss_and_grads_on(self.model, params, images, {"cube_pose": poses, "mask": mask}, self.losses)
        B = images.shape[0]
        if B % self.accum:
            raise ValueError(f"batch {B} does not divide into {self.accum} microbatches")
        mb = B // self.accum
        names = list(params)
        gsum = lsum = csum = None
        for i in range(self.accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss_i, g = _loss_and_grads_on(self.model, params, images[rows],
                                           {"cube_pose": poses[rows], "mask": mask[rows]}, self.losses)
            cnt = mask[rows].sum()
            weighted = torch._foreach_mul([g[k].float() for k in names], cnt)
            if gsum is None:
                gsum, lsum, csum = weighted, loss_i * cnt, cnt
            else:
                torch._foreach_add_(gsum, weighted)
                lsum, csum = lsum + loss_i * cnt, csum + cnt
        denom = csum.clamp(min=1.0)
        grads = {k: (gk / denom).to(params[k].dtype) for k, gk in zip(names, gsum)}
        return lsum / denom, grads

    def _dp_loss_and_grads(self, params, images, poses, mask):
        """argus_tpu's `_shard_loss_and_grad` on this rank's rows: the
        unnormalised masked loss sum and its gradient (summed over the
        microbatches), one bucketed all-reduce of [loss_sum, mask_count,
        gradients] over the data group, then each divided by max(global
        count, 1). Nothing divides by this rank's own count, which is 0
        where its rows are all padding."""
        B = images.shape[0]
        if B % self.accum:
            raise ValueError(f"batch {B} does not divide into {self.accum} microbatches")
        mb = B // self.accum
        names = list(params)
        gsum = lsum = csum = None
        for i in range(self.accum):
            rows = slice(i * mb, (i + 1) * mb)
            lsum_i, g = _loss_and_grads_on(self.model, params, images[rows],
                                           {"cube_pose": poses[rows], "mask": mask[rows]}, self.losses, mean=False)
            cnt = mask[rows].sum()
            if gsum is None:
                gsum, lsum, csum = {k: g[k].float() for k in names}, lsum_i, cnt
            else:
                torch._foreach_add_([gsum[k] for k in names], [g[k].float() for k in names])
                lsum, csum = lsum + lsum_i, csum + cnt
        lsum, csum, gsum = all_reduce_loss_and_grads(lsum, csum, gsum, self.mesh.data_group)
        denom = csum.clamp(min=1.0)
        return lsum / denom, {k: (gsum[k] / denom).to(params[k].dtype) for k in names}


def make_train_step(model: torch.nn.Module, cfg: TrainConfig, base_seed: int = 0, mesh: Optional[Mesh] = None,
                    hw=None, device=None):
    """Build the train step `step(state, batch) -> (state, loss)`
    (`TrainStepBody`'s two parts in turn). `batch` holds "images" (B, H, W,
    3 * n_cams) uint8, "cube_pose" (B, 7) and "mask" (B,) (tensors or numpy
    arrays; the step moves them to the model's device). The update is in
    place: the model's parameters, the Adam moments and the step count
    change under the caller's `state`, which is also returned; nothing is
    donated or copied. With `use_augmentation` the fed images are augmented
    with the key `fold_in(base_seed, state.step)` (argus_tpu: `fold_in(
    PRNGKey(base_seed), state.step)`); a step samples the next step's
    parameters (same batch shape) once it has queued its own work, while
    the device runs it. With a `mesh` (`parallel.make_mesh`), `batch` is
    this rank's rows of the global batch (`Mesh.local_rows`) and the step
    is the data-parallel one (`TrainStepBody`); the returned loss is the
    global batch's."""
    check_config(cfg, mesh)
    body = TrainStepBody(model, cfg, base_seed, hw, device, mesh)

    def train_step(state: TrainState, batch: dict):
        operands = body.prepare(state.step, batch["images"], batch["cube_pose"], batch["mask"])
        loss = body.compute(state, operands)
        state.step += 1
        body.sample_ahead(state.step, operands)
        return state, loss

    return train_step


def feed_images(cfg: TrainConfig, images, device) -> torch.Tensor:
    """Frames on `device` in the feed dtype (bf16 under amp), times 1/255:
    argus_tpu's `u8_to_f32`, whatever the frames' dtype."""
    return u8_to_f32(torch.as_tensor(images).to(device), torch.bfloat16 if cfg.amp else torch.float32)


def loss_and_grads(model: torch.nn.Module, cfg: TrainConfig, params: Dict[str, torch.Tensor], batch: dict,
                   hw: Optional[tuple] = None):
    """The step's masked-mean loss on `batch` (uint8 frames, fed as the step
    feeds them, not augmented) and its gradient w.r.t. each of `params`
    (zeros where no gradient reaches, as for frozen parameters):
    (loss, {name: grad})."""
    on = next(iter(params.values())).device
    images = feed_images(cfg, batch["images"], on)
    return _loss_and_grads_on(model, params, images, batch, make_loss_fn(cfg, hw))


def _loss_and_grads_on(model: torch.nn.Module, params: Dict[str, torch.Tensor], images: torch.Tensor,
                       batch: dict, loss_fn=geometric_loss_fn, mean: bool = True):
    """`loss_and_grads` on images already fed (and augmented), with the
    per-sample loss `loss_fn` (`make_loss_fn`); with `mean=False` the
    masked sum of the losses instead of their mean."""
    on = images.device
    poses = torch.as_tensor(batch["cube_pose"]).to(on, torch.float32)
    mask = torch.as_tensor(batch["mask"]).to(on, torch.float32)
    losses = loss_fn(model(images, train=True), poses)
    loss = (losses * mask).sum()
    if mean:
        loss = loss / mask.sum().clamp(min=1.0)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    grads = {k: torch.zeros_like(params[k]) if gk is None else gk for k, gk in zip(names, grads)}
    return loss.detach(), grads


# ───────────────────────────── resident epoch ─────────────────────────────


def epoch_permutation(base_seed: int, epoch: int, n: int, device) -> torch.Tensor:
    """The resident epoch's order of its `n` examples, drawn on `device` from
    a generator seeded by `fold_in(base_seed ^ 0x5EED, epoch)`: a stream
    apart from the augmentation keys, as argus_tpu draws it (the numbers are
    torch's, not jax.random's)."""
    gen = augment.generator(augment.fold_in(base_seed ^ 0x5EED, epoch), device)
    return torch.randperm(n, generator=gen, device=device)


def epoch_batches(perm: torch.Tensor, batch_size: int, rows: slice = None):
    """The resident epoch's batches from its order `perm` of n examples:
    (indices (k, b), mask (k, b)) with k = ceil(n / batch_size), the order
    padded to k * batch_size with its own first entries (mask 0), and of
    each global batch the `rows` this rank holds (all of them by default;
    b = their count)."""
    n = perm.numel()
    k = -(-n // batch_size)
    pad = k * batch_size - n
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    rows = slice(0, batch_size) if rows is None else rows
    mask = (torch.arange(k * batch_size, device=perm.device) < n).to(torch.float32).reshape(k, batch_size)
    return perm.reshape(k, batch_size)[:, rows], mask[:, rows]


def _capturable(mesh: Optional[Mesh]) -> bool:
    """True where the step's collectives can sit in a CUDA graph: none, or
    NCCL's (gloo's cannot be captured)."""
    if mesh is None:
        return True
    groups = [g for g in (mesh.data_group, mesh.model_group) if g is not None]
    return all(dist.get_backend(g) == "nccl" for g in groups)


def make_resident_epoch_step(model: torch.nn.Module, cfg: TrainConfig, base_seed: int, n_examples: int, hw=None,
                             device=None, like=None, mesh: Optional[Mesh] = None):
    """A whole epoch over device-resident data, argus_tpu's
    `make_resident_epoch_step`. Returns (epoch_step, k) with k = ceil(n /
    batch_size) batches an epoch and

        epoch_step(state, images, poses, epoch) -> (state, losses (k,) on the device)

    for images uint8 (n, H, W, 3 * n_cams) and poses (n, 7) on the device.
    The epoch's order is `epoch_permutation(base_seed, epoch, n)`, padded to
    k * batch_size with its own first entries, whose mask is 0. Each batch
    is gathered on the device (`index_select`) and runs `TrainStepBody`,
    accumulation included, with the augmentation keyed by `state.step`, so
    for the same order the epoch gives the per-step path's losses and
    updates. On the card the compute part, `TrainStepBody.compute` from the
    `augment_fused` launch on, is a `capture.CapturedCall`: its first
    `WARMUP_STEPS` steps eager, then one CUDA graph replayed (the state's
    tensors are updated in place, and `state.lr`, which the schedule fills
    in place, is read at each replay). Between its
    replays the host queues the gathers, the augmentation's sampling and
    packing and device-to-device copies, and no upload. On the CPU it runs
    eagerly through the same code. `like`, an epoch step made earlier for
    the same model, config and batch shape, lends it its step body and
    graph (the shard path's two shard lengths share one).

    With a `mesh` (one node) every rank holds the whole split, draws the
    same permutation, and gathers its rows of each global batch
    (`Mesh.local_rows`); the step is the data-parallel one, captured with
    its NCCL all-reduce inside the graph, and run eagerly where a group is
    gloo's (`_capturable`)."""
    device = resolve_device(device)
    if like is not None:
        body, run = like.body, like.run
    else:
        body = TrainStepBody(model, cfg, base_seed, hw, device, mesh)
        graphed = device.type == "cuda" and _capturable(mesh)
        run = CapturedCall(body.compute, body.device) if graphed else body.compute
    B = cfg.batch_size
    n = int(n_examples)
    k = -(-n // B)
    rows = None if mesh is None else mesh.local_rows(B)

    def epoch_step(state: TrainState, images: torch.Tensor, poses: torch.Tensor, epoch: int):
        idx, mask = epoch_batches(epoch_permutation(base_seed, int(epoch), n, body.device), B, rows)
        losses = torch.empty(k, dtype=torch.float32, device=body.device)
        for i in range(k):
            operands = body.prepare(state.step, images.index_select(0, idx[i]), poses.index_select(0, idx[i]),
                                    mask[i])
            losses[i] = run(state, operands)
            state.step += 1
        return state, losses

    epoch_step.body, epoch_step.run = body, run
    return epoch_step, k


# ───────────────────────────── eval step ─────────────────────────────


def eval_arc_params(base_seed: int, step: int, batch_idx: int, n: int, n_arcs: int, H: int, W: int, device):
    """The eval step's spaghetti arcs, (n, n_arcs, 10), keyed by
    fold_in(fold_in(base_seed + 1, step), batch_idx) (argus_tpu: the step
    alone would draw the same arcs on every batch of a validation pass)."""
    key = augment.fold_in(augment.fold_in(base_seed + 1, step), batch_idx)
    return augment._arc_params(augment.generator(key, device), n, n_arcs, H, W)


def make_eval_step(model: torch.nn.Module, cfg: TrainConfig, base_seed: int = 0, hw=None, device=None,
                   mesh: Optional[Mesh] = None):
    """The eval step `eval_step(state, batch, batch_idx=0) -> (sum of the
    per-sample losses times the mask, sum of the mask)`, two f32 scalars on
    the device, so an epoch's mean is exact under padding. Frames are fed
    in f32 (`u8_to_f32`); with `val_spaghetti` and augmentation on, the
    configured number of spaghetti arcs is drawn on them (`eval_arc_params`),
    as argus_tpu's val pipeline does. The keypoint family reports the
    geodesic error of the fitted pose (triangulation + Procrustes through
    the nominal cameras at the crop), the quantity the pose regressor
    reports. No graph is recorded. With a `mesh`, `batch` is this rank's
    rows of the global batch: the arcs are drawn for the global row count
    and this rank keeps its rows, and the two sums are the global batch's
    (summed over the data group)."""
    device = resolve_device(device)
    model_type, mcfg = _resolved_model_config(cfg)
    n_cams = mcfg.n_cams
    n_spag = cfg.augmentation_config.num_spaghetti if cfg.use_augmentation else 0
    cam_P = nominal_camera_matrices(*training_crop(cfg, hw)).to(device) if model_type == "keypoint" else None

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, batch_idx: int = 0):
        images = u8_to_f32(torch.as_tensor(batch["images"]).to(device))
        if cfg.val_spaghetti and n_spag > 0:
            B, H, W, C = images.shape
            per_cam = images.reshape(B, H, W, n_cams, 3).permute(0, 3, 4, 1, 2).reshape(B * n_cams, 3, H, W)
            n_data = 1 if mesh is None else mesh.n_data
            arcs = eval_arc_params(base_seed, state.step, batch_idx, B * n_data * n_cams, n_spag, H, W, device)
            if mesh is not None:
                rows = mesh.local_rows(B * n_data)
                arcs = arcs[rows.start * n_cams:rows.stop * n_cams]
            per_cam = augment.spaghetti_arcs(per_cam, arcs)
            images = per_cam.reshape(B, n_cams, 3, H, W).permute(0, 3, 4, 1, 2).reshape(B, H, W, C).contiguous()
        pred = model(images, train=False)
        poses = torch.as_tensor(batch["cube_pose"]).to(device, torch.float32)
        if model_type == "keypoint":
            losses = geometric_loss_fn(se3_log(fit_pose(cam_P, pred[0])), poses)
        else:
            losses = geometric_loss_fn(pred, poses)
        mask = torch.as_tensor(batch["mask"]).to(device, torch.float32)
        if mesh is None:
            return (losses * mask).sum(), mask.sum()
        sums = all_reduce_(torch.stack([(losses * mask).sum(), mask.sum()]), mesh.data_group)
        return sums[0], sums[1]

    return eval_step


# ───────────────────────────── plateau scheduler ─────────────────────────────


class ReduceLROnPlateau:
    """argus_tpu's host-side ReduceLROnPlateau(min, patience=5, factor=0.5),
    torch's semantics: a relative threshold of 1e-4, and a cut once the bad
    epochs exceed the patience."""

    def __init__(self, patience: int = 5, factor: float = 0.5, threshold: float = 1e-4):
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return lr * self.factor
        return lr


# ───────────────────────────── training loop ─────────────────────────────


def rank_print(msg: str, rank: int = 0) -> None:
    """Print on process 0 only."""
    if rank == 0:
        print(msg, flush=True)


def initialize_training(cfg: TrainConfig, device=None, datasets=None) -> dict:
    """Set up what `train` needs: the datasets and their host loaders, the
    model and train state (restored from `resume_from`), the train and
    eval steps, and the metrics logger. `datasets` = (train, val)
    replaces the datasets of `cfg.dataset_config` (any object with
    `__len__`, `__getitem__`, `cube_poses`, `n_cams`, `_out_hw` and
    `load_images_batch`).

    The data path is argus_tpu's choice: the train split resident on the
    device when it fits `device_resident_mb` (`resident`, with its
    `epoch_step`), shards of it swapped in per epoch past the budget
    (`resident_sharded`, with one epoch step per distinct shard length in
    `shard_steps`, sharing one step and its CUDA graph), else (at 0) the
    host loader.

    Under `multigpu` the process group must exist (`parallel.init_distributed`,
    or `torchrun`); the mesh is the group's ranks with `num_model_shards`
    on the model axis (`num_chips`, when set, must be the world size). Each
    node's loaders take `batch_size // nodes` rows a batch
    (`process_index` the node) and each rank decodes only its rows of them
    (`Mesh.node_rows`); the resident paths run on one node only, as in
    argus_tpu; the logger is enabled on rank 0 alone and the run id is
    rank 0's."""
    from argus_tpu_torch.logging_utils import MetricsLogger, generate_run_id

    device = resolve_device(device)
    mesh = None
    if cfg.multigpu:
        if not dist.is_initialized():
            raise ValueError("multigpu needs an initialised process group: call "
                             "argus_tpu_torch.parallel.init_distributed() or run under torchrun")
        mesh = make_mesh(n_model=cfg.num_model_shards)
    check_config(cfg, mesh)
    rank, node, nodes = (0, 0, 1) if mesh is None else (mesh.rank, mesh.node_index, mesh.n_nodes)
    if datasets is None:
        if cfg.dataset_config is None:
            raise ValueError("TrainConfig.dataset_config is required for training, or pass datasets")
        datasets = (CameraCubePoseDataset(cfg.dataset_config, train=True),
                    CameraCubePoseDataset(cfg.dataset_config, train=False))
    train_dataset, val_dataset = datasets
    node_batch = cfg.batch_size // nodes
    loader_kw = dict(batch_size=node_batch, num_workers=cfg.num_workers, seed=cfg.random_seed,
                     process_index=node, process_count=nodes,
                     rows=None if mesh is None else mesh.node_rows(node_batch))
    train_loader = HostDataLoader(train_dataset, shuffle=True, **loader_kw)
    val_loader = HostDataLoader(val_dataset, shuffle=False, **loader_kw)

    crop = cfg.dataset_config.center_crop if cfg.dataset_config is not None else None
    sample_hw = tuple(crop or train_dataset[0]["images"].shape[:2])
    model, state = create_train_state(cfg, seed=cfg.random_seed, sample_hw=sample_hw, device=device, mesh=mesh)
    if cfg.resume_from is not None:
        state = load_checkpoint(cfg.resume_from, target=state)
    step_kw = dict(base_seed=cfg.random_seed, hw=sample_hw, device=device, mesh=mesh)
    train_step = make_train_step(model, cfg, **step_kw)
    eval_step = make_eval_step(model, cfg, **step_kw)

    resident = epoch_step = resident_sharded = shard_steps = None
    budget_mb = cfg.device_resident_mb
    if nodes == 1 and DeviceResidentData.fits(train_dataset, budget_mb):
        resident = DeviceResidentData.from_dataset(train_dataset, device=device, n_threads=cfg.num_workers)
        epoch_step, _ = make_resident_epoch_step(model, cfg, n_examples=resident.n, **step_kw)
    elif nodes == 1 and ResidentShardedData.applicable(train_dataset, budget_mb):
        resident_sharded = ResidentShardedData(train_dataset, budget_mb, device=device, n_threads=cfg.num_workers,
                                               seed=cfg.random_seed)
        shard_steps = {}
        for n_k in sorted({resident_sharded.shard_size, resident_sharded.tail_size}, reverse=True):
            like = next(iter(shard_steps.values()), None)
            shard_steps[n_k], _ = make_resident_epoch_step(model, cfg, n_examples=n_k, like=like, **step_kw)

    run_id = broadcast_object(generate_run_id())
    logger = MetricsLogger(cfg.wandb_project, run_id=run_id, config=cfg, enabled=cfg.wandb_log and rank == 0)
    return dict(device=device, model=model, sample_hw=sample_hw, state=state, train_loader=train_loader,
                val_loader=val_loader, train_step=train_step, eval_step=eval_step, resident=resident,
                epoch_step=epoch_step, resident_sharded=resident_sharded, shard_steps=shard_steps, logger=logger,
                run_id=run_id, rank=rank, mesh=mesh)


def _save(path: str, state, meta, setup, ckpt=None) -> None:
    """The whole train state to `path` by rank 0 (asynchronously through
    `ckpt` when given); under tensor parallelism every rank first takes
    part in gathering the sharded leaves."""
    mesh = setup["mesh"]
    if mesh is not None:
        state = whole_state(state, mesh)
    if setup["rank"] != 0:
        return
    if ckpt is not None:
        ckpt.save(path, state, meta=meta)
    else:
        save_checkpoint(path, state, meta=meta)


def train(cfg: TrainConfig, device=None, datasets=None) -> str:
    """argus_tpu's training loop (`datasets` as in `initialize_training`).
    Returns the checkpoint's path, `<save_dir>/<run_id>.ckpt`, the same
    on every rank.

    A SIGTERM is latched by `PreemptionGuard`: the loop finishes the step
    in flight, saves the full train state and returns, so `resume_from`
    continues the run. A save in flight is drained before the final save,
    also when an exception unwinds the loop. Under `multigpu` rank 0 alone
    prints, logs and writes the files, and the ranks agree on a preemption
    (`_train_epochs`); every rank returns once the final file is written."""
    from argus_tpu_torch.preemption import PreemptionGuard

    setup = initialize_training(cfg, device, datasets)
    state = setup["state"]
    logger, run_id, rank = setup["logger"], setup["run_id"], setup["rank"]
    scheduler = ReduceLROnPlateau(patience=5, factor=0.5)
    ckpt_path = str(Path(cfg.save_dir) / f"{run_id}.ckpt")

    lr = float(cfg.learning_rate)
    global_step = int(state.step)
    guard = PreemptionGuard()
    ckpt = AsyncCheckpointer() if cfg.async_checkpoint and rank == 0 else None
    meta = checkpoint_meta(cfg, hw=setup["sample_hw"])
    guard.__enter__()
    try:
        state, global_step, lr, preempted = _train_epochs(
            cfg, setup, state, scheduler, ckpt_path, guard, global_step, lr, ckpt, meta)
    finally:
        # always restore the SIGTERM handler, and drain a save in flight so an
        # exception cannot strand a .tmp; a drain error does not replace the
        # exception being raised
        guard.__exit__()
        if ckpt is not None:
            try:
                ckpt.wait()
            except BaseException as e:
                if sys.exc_info()[0] is None:
                    raise
                rank_print(f"    (async checkpoint drain also failed: {e!r})", rank)
    _save(ckpt_path, state, meta, setup)
    if setup["mesh"] is not None:
        setup["mesh"].barrier()
    logger.finish()
    if preempted:
        rank_print(f"    Preempted at step {global_step}; resumable from {ckpt_path}", rank)
    return ckpt_path


def _train_epochs(cfg, setup, state, scheduler, ckpt_path, guard, global_step, lr, ckpt=None, meta=None):
    """The epoch loop of `train`, split out so the guard wraps it in
    try/finally. Returns (state, global_step, lr, preempted).

    Under a mesh a SIGTERM that one rank alone receives must not leave the
    others waiting in an all-reduce, so the ranks agree on stopping, one
    collective (`agree_any`) at a point every rank reaches: on the host
    feed after every 50 steps (where the losses are fetched) and at the
    end of each epoch, on the resident path after each epoch, on the shard
    path after each shard. On one card the loop stops after the step in
    flight."""
    device, rank, logger, mesh = setup["device"], setup["rank"], setup["logger"], setup["mesh"]
    train_step, eval_step = setup["train_step"], setup["eval_step"]

    def stop() -> bool:
        if mesh is None:
            return guard.requested
        return agree_any(guard.requested, mesh.world_group, device)

    preempted = False
    for epoch in range(cfg.n_epochs):
        setup["train_loader"].set_epoch(epoch)

        # the losses stay on the device and are fetched in blocks: a fetch per
        # step would stall the queue of launches; each is logged at its step
        epoch_losses, pending = [], []

        def flush_pending():
            nonlocal global_step
            if not pending:
                return
            for v in torch.stack(pending).cpu().tolist():
                epoch_losses.append(float(v))
                logger.log({"loss": float(v)}, step=global_step)
                global_step += 1
            pending.clear()

        if setup["resident"] is not None:
            # the whole epoch from the resident split: no host feed and no
            # upload; preemption is seen once the epoch is queued
            res = setup["resident"]
            state, losses = setup["epoch_step"](state, res.images, res.poses, epoch)
            pending.extend(losses.unbind())
        elif setup["resident_sharded"] is not None:
            # shard by shard, the next shard's decode and upload overlapping
            # this one's steps; preemption is seen after each shard
            for images, poses, segment, n_k in setup["resident_sharded"].epoch_shards(epoch):
                state, losses = setup["shard_steps"][n_k](state, images, poses, segment)
                pending.extend(losses.unbind())
                if stop():
                    break
        else:
            for batch in device_prefetch(setup["train_loader"], device):
                state, loss = train_step(state, batch)
                pending.append(loss)
                if len(pending) >= 50:
                    flush_pending()
                    if mesh is not None and stop():
                        break
                if mesh is None and guard.requested:
                    break
        flush_pending()

        if stop():
            preempted = True
            rank_print("    Preemption signal received: checkpointing and exiting", rank)
            logger.log({"preempted": 1}, step=global_step)
            break

        if epoch % cfg.print_epochs == 0:
            rank_print(f"    Avg. Loss in Epoch: {np.mean(epoch_losses):.6f}", rank)

        # validation and the plateau schedule: (sum, count) summed on the
        # device (and over the data group), one fetch per pass
        if epoch % cfg.val_epochs == 0:
            total = torch.zeros((), dtype=torch.float32, device=device)
            count = torch.zeros((), dtype=torch.float32, device=device)
            for bi, batch in enumerate(device_prefetch(setup["val_loader"], device)):
                s, c = eval_step(state, batch, bi)
                total += s
                count += c
            val_loss = float(total) / max(float(count), 1.0)
            logger.log({"val_loss": val_loss}, step=global_step)
            rank_print(f"    Validation loss: {val_loss:.6f}", rank)
            new_lr = scheduler.step(val_loss, lr)
            if new_lr != lr:
                lr = new_lr
                state.lr.fill_(lr)
                rank_print(f"    Reducing learning rate to {lr:.2e}", rank)

        # the whole train state, asynchronously unless async_checkpoint is off
        if epoch % cfg.save_epochs == 0:
            _save(ckpt_path, state, meta, setup, ckpt)

    return state, global_step, lr, preempted


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli
    from argus_tpu_torch.parallel import init_distributed

    cfg = cli(TrainConfig)
    if cfg.multigpu:  # one process per card, e.g. under python -m torch.distributed.run
        init_distributed()
    start = time.time()
    train(cfg)
    rank_print(f"Training took {time.time() - start:.2f} seconds.", dist.get_rank() if dist.is_initialized() else 0)
