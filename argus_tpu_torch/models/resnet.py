"""ResNet backbones in PyTorch over NHWC activations (eval and training
forward).

Port of `argus_tpu/models/resnet.py`: the same stage layout, torch-exact
padding (7x7/s2 pad 3, 3x3 pad 1, maxpool 3x3/s2 pad 1), the bottleneck's
stride on the 3x3 (torchvision v1.5), global mean pool then an `output_dim`
projection. Submodules carry the flax scope names (`conv_init`,
`stage{i}_block{j}.Conv_0`, `BatchNorm_0`, `conv_proj`, `norm_proj`, `fc`),
so `models.jax_import` maps argus_tpu variables onto `state_dict` keys
mechanically.

Activations are (N, H, W, C) tensors, in the compute dtype (`dtype`); params
stay f32 and are cast where they are used, as flax does. Fresh weights are
flax's `lecun_normal` (`lecun_normal_`). The `fuse_*` flags keep argus_tpu's
names and values. "on" and "off" force a kernel function on or off, with
argus_tpu's coupling (the stage chain needs `fuse_block` and `fuse_proj`
too). "auto" is off on a CPU tensor; on a CUDA tensor it reads `AUTO_FUSE`,
which holds, per kernel function and mode, whether the port's kernel made
the model faster than its unfused path on the H100 (argus_tpu's "auto"
means "on the TPU" and gives no rule for a GPU). Under frozen BN (`bn_frozen` and
`bn_frozen_affine`) with fusion on, the stem, stage chains, projection and
identity bottlenecks, and the identity BasicBlocks of ResNet-18/34 (stride
1, cin == cout; the strided BasicBlocks stay unfused, as in argus_tpu) run
through the kernel functions of
`argus_tpu_torch.ops.kernels` on BN-folded weights (hand-written CUDA on the
card, their plain versions on the CPU). `fuse_pointwise` ("on", "dot",
"auto"; argus_tpu's `fuse_pw`) runs Conv_0 and Conv_2 of each bottleneck
that no block, projection or chain kernel takes through the pointwise op (`ops.kernels.pointwise`: the kernel, or
with "dot" its matmul form). Otherwise each conv is `F.conv2d` followed by
its BatchNorm, folded into the conv under a frozen affine (`conv_bn`). Under
`frozen_stages >= 1` with the stem and the
stage-0 chain fused, the stem writes the pair-packed view the stage-0 chain
reads (argus_tpu's `packed_out`, `_packed_fwd_ok`).

`forward(x, train=True)` is the training forward, with argus_tpu's BN
modes: exact train-mode BN (batch statistics, the running ones updated in
place, `norm_momentum`, `bn_stats_stride`, `bn_grad_stride`, the reduction
engine `bn_impl`; see `ops.norm`) unless `bn_frozen`, which normalises with
the running statistics, its affine trainable or, with `bn_frozen_affine`,
frozen too (no gradient to scale or bias). Under a frozen affine the BN is
folded into the conv weights with autograd on every call (a gradient dk =
bf16(dw) * c flows back through the fold), and the fused stem, blocks and
chains are `torch.autograd.Function`s whose backward is a kernel too; the
fused stem's backward is its weight gradient, on the first N /
`stem_grad_stride` images. `stem_frozen` stops the gradient at the stem,
and `frozen_stages=k` at the output of stage k-1, so the frozen part runs
its no-save forwards under `torch.no_grad()` (train-mode BN there still
updates its running statistics, as argus_tpu's does). `remat` (every stage)
and `remat_stages` keep nothing of a block's interior for the backward, as
argus_tpu's `nn.remat` does; a chain ignores both. A fused identity
bottleneck runs its no-save forward and the recompute backward (B7), a fused
projection its no-save forward and, in the backward, the saving forward
again; any other block is re-run in the backward (`_recompute`) with the
batch statistics its forward recorded, so no running statistic moves twice.

`forward(x, return_spatial=True)` returns the stride-32 feature map in f32
instead of the pooled features, for the keypoint family's dense head.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from argus_tpu_torch.ops.kernels.basic_fused import basic_saved, fold_basic_params
from argus_tpu_torch.ops.kernels.block_fused import block_remat, block_saved, fold_affine, fold_bottleneck_params
from argus_tpu_torch.ops.kernels.pointwise import pointwise_conv
from argus_tpu_torch.ops.kernels.proj_fused import fold_projection_params, proj_remat, proj_saved
from argus_tpu_torch.ops.kernels.stage_fused import packed_fwd_ok, stage_chain
from argus_tpu_torch.ops.kernels.stem_fused import fold_stem_params, stem_pool
from argus_tpu_torch.ops.norm import IMPLS, BatchNorm, StatsTape

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POINTWISE_FLAGS = ("off", "on", "dot", "auto")

# What "auto" chooses on a CUDA tensor, per kernel function and mode: on
# where the port's kernel made the model faster than its unfused path, cuDNN
# convs on BN-folded weights (`conv_bn`). "forward" is the no-save forward
# (serving, eval, frozen stages), "train" the saving forward with its
# backward. The chain's no-save forward is two functions, as in argus_tpu:
# the stage-0 form ("stage_chain_packed", `packed_fwd_ok`) and the
# whole-stage chains of frozen stages 1-3. From scripts/time_torch_auto_fuse.py
# at batch 256 rows (512 images of 256x256, bf16) on one NVIDIA H100 80GB
# HBM3 at 700.00 W: ms per step or forward saved by turning the function on
# alone, every other entry off (negative: cuDNN wins), in the workloads named.
AUTO_FUSE = {
    ("stem", "forward"): True,  # flagship step 8.51, serving 8.87
    ("stem", "train"): True,  # stem-trained step 13.67
    ("stage_chain_packed", "forward"): True,  # serving 17.87; frozen_stages=3 step 26.15 with the packed stem
    ("stage_chain", "forward"): True,  # frozen_stages=3 step 19.77 (stages 1-2, the TMA forward)
    ("stage_chain", "train"): True,  # flagship step 17.85 (the TMA forward, the Hopper chain backward)
    ("projection", "forward"): True,  # serving 17.24 (the TMA forward)
    ("projection", "train"): True,  # flagship step 14.23, frozen_stages=3 step -0.16 (TMA forward, Hopper backward)
    ("identity", "forward"): True,  # serving 24.54 (the TMA forward)
    ("identity", "train"): True,  # flagship step 16.63, frozen_stages=3 step -0.15 (TMA forward, Hopper backward)
    ("basic", "forward"): True,  # keypoint eval forward 4.41 (the TMA forward)
    ("basic", "train"): False,  # keypoint step -0.13
    ("pointwise", "forward"): True,  # serving 31.60, frozen_stages=3 step 30.99 (fuse_pointwise "auto" in all 16 blocks)
    ("pointwise", "train"): True,  # flagship step 22.88, frozen_stages=3 step 1.16 (TMA forward, Hopper backward)
}


def flag_on(flag: str, x: torch.Tensor, function: str, mode: str) -> bool:
    """A fuse flag's value for kernel function `function` in `mode` on this
    activation: "on" and "off" as given, "auto" off on a CPU tensor and
    `AUTO_FUSE[(function, mode)]` on a CUDA tensor."""
    if flag not in ("on", "off", "auto"):
        raise ValueError(f"fuse flag must be 'on', 'off' or 'auto', got {flag!r}")
    if flag == "auto":
        return x.is_cuda and AUTO_FUSE[(function, mode)]
    return flag == "on"


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `lecun_normal` in place: a normal truncated at +-2 standard
    deviations, rescaled to variance 1 / fan_in (fan_in = kh * kw * cin for
    a conv, in_features for a dense layer: every dim of a torch weight but
    the first)."""
    std = w[0].numel() ** -0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Conv(nn.Module):
    """Bias-free conv with a torch (OIHW) weight, applied to NHWC activations
    in their dtype. `padding` is symmetric, or ((top, bottom), (left, right))."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding=0) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        lecun_normal_(self.weight)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv with its own weight, or with `weight` (OIHW, x's dtype)
        and an f32 `bias`, summed with each output in f32 and rounded once
        to x's dtype: a BN-folded conv (`conv_bn`)."""
        x = x.permute(0, 3, 1, 2)
        pad = self.padding
        if isinstance(pad, tuple):
            (top, bottom), (left, right) = pad
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, self.weight.to(x.dtype) if weight is None else weight, stride=self.stride, padding=pad)
        if bias is not None:
            y.add_(bias.reshape(-1, 1, 1))
        return y.permute(0, 2, 3, 1)

    def hwio(self) -> torch.Tensor:
        """The weight in argus_tpu's HWIO layout."""
        return self.weight.permute(2, 3, 1, 0)


def conv_bn(conv: Conv, bn: BatchNorm, x: torch.Tensor, batch_stats: bool) -> torch.Tensor:
    """`conv` then `bn`. Under a frozen affine with the running statistics
    the BN is folded into the conv as the kernels fold it (`fold_affine`,
    autograd through the fold): one conv on the folded weight in x's dtype,
    then its f32 bias with one rounding, where the unfolded BN would round
    after each of its four elementwise ops."""
    if bn.frozen_affine and not batch_stats:
        w, b = fold_affine(conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, x.dtype,
                           axis=0)
        return conv(x, w, b)
    return bn(conv(x), batch_stats)


def _fold_1x1(conv: Conv, bn: BatchNorm, dtype) -> tuple:
    """A 1x1 conv's folded (CIN, COUT) weight and (1, COUT) f32 bias: the
    pointwise op's operands."""
    cout, cin = conv.weight.shape[:2]
    return fold_affine(conv.weight.reshape(cout, cin).t(), bn.weight, bn.bias, bn.running_mean,
                       bn.running_var, bn.eps, dtype)


def _fold(conv: Conv, bn: BatchNorm):
    """(HWIO kernel, scale, bias, mean, var): the fold helpers' arguments
    (they detach the BN tensors; the gradient reaches the kernel only)."""
    return conv.hwio(), bn.weight, bn.bias, bn.running_mean, bn.running_var


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34); an identity block (stride 1,
    cin == filters) also runs fused on folded weights."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int, eps: float) -> None:
        super().__init__()
        self.eps = eps
        self.Conv_0 = Conv(cin, filters, 3, strides, 1)
        self.BatchNorm_0 = BatchNorm(filters, eps)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(filters, eps)
        self.is_identity = strides == 1 and cin == filters
        if not self.is_identity:
            self.conv_proj = Conv(cin, filters, 1, strides)
            self.norm_proj = BatchNorm(filters, eps)

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        y = torch.relu(conv_bn(self.Conv_0, self.BatchNorm_0, x, batch_stats))
        y = conv_bn(self.Conv_1, self.BatchNorm_1, y, batch_stats)
        residual = x if self.is_identity else conv_bn(self.conv_proj, self.norm_proj, x, batch_stats)
        return torch.relu(y + residual)

    def fold(self, dtype) -> tuple:
        """Frozen-BN-folded weights of an identity block: the 4-tuple of the
        BasicBlock kernel."""
        return fold_basic_params(
            dtype, *_fold(self.Conv_0, self.BatchNorm_0), *_fold(self.Conv_1, self.BatchNorm_1), eps=self.eps
        )

    def forward_fused(self, x: torch.Tensor, folded: tuple) -> torch.Tensor:
        return basic_saved(x, *folded)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 residual block (ResNet-50/101), expansion 4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int, eps: float) -> None:
        super().__init__()
        cout = filters * self.expansion
        self.strides = strides
        self.eps = eps
        self.Conv_0 = Conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters, eps)
        self.Conv_1 = Conv(filters, filters, 3, strides, 1)
        self.BatchNorm_1 = BatchNorm(filters, eps)
        self.Conv_2 = Conv(filters, cout, 1)
        self.BatchNorm_2 = BatchNorm(cout, eps)
        self.is_identity = strides == 1 and cin == cout
        if not self.is_identity:
            self.conv_proj = Conv(cin, cout, 1, strides)
            self.norm_proj = BatchNorm(cout, eps)

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        y = torch.relu(conv_bn(self.Conv_0, self.BatchNorm_0, x, batch_stats))
        y = torch.relu(conv_bn(self.Conv_1, self.BatchNorm_1, y, batch_stats))
        y = conv_bn(self.Conv_2, self.BatchNorm_2, y, batch_stats)
        residual = x if self.is_identity else conv_bn(self.conv_proj, self.norm_proj, x, batch_stats)
        return torch.relu(y + residual)

    def forward_pointwise(self, x: torch.Tensor, impl: str) -> torch.Tensor:
        """argus_tpu's `_call_fused` (frozen BN and affine): Conv_0 and Conv_2
        through the pointwise op on their folded weights (`impl` "kernel" or
        "dot"), Conv_2 with the residual; Conv_1 and the projection shortcut
        as in `forward`, folded."""
        w1, b1 = _fold_1x1(self.Conv_0, self.BatchNorm_0, x.dtype)
        y = pointwise_conv(x, w1, b1, relu=True, impl=impl)
        y = torch.relu(conv_bn(self.Conv_1, self.BatchNorm_1, y, False))
        residual = x if self.is_identity else conv_bn(self.conv_proj, self.norm_proj, x, False)
        w3, b3 = _fold_1x1(self.Conv_2, self.BatchNorm_2, x.dtype)
        return pointwise_conv(y, w3, b3, residual, relu=True, impl=impl)

    def fold(self, dtype) -> tuple:
        """Frozen-BN-folded weights: the 6-tuple of the identity block kernel,
        or the 8-tuple of the projection kernel."""
        args = [
            *_fold(self.Conv_0, self.BatchNorm_0),
            *_fold(self.Conv_1, self.BatchNorm_1),
            *_fold(self.Conv_2, self.BatchNorm_2),
        ]
        if self.is_identity:
            return fold_bottleneck_params(dtype, *args, eps=self.eps)
        return fold_projection_params(
            dtype, *args, *_fold(self.conv_proj, self.norm_proj), eps=self.eps
        )

    def forward_fused(self, x: torch.Tensor, folded: tuple, remat: bool = False) -> torch.Tensor:
        if self.is_identity:
            return (block_remat if remat else block_saved)(x, *folded)
        return (proj_remat if remat else proj_saved)(x, *folded, self.strides)


class ResNet(nn.Module):
    """NHWC ResNet with a trailing `output_dim` projection."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls,
        output_dim: Optional[int] = 1024,
        num_filters: int = 64,
        dtype: str = "float32",
        norm_momentum: float = 0.9,
        norm_eps: float = 1e-5,
        stem_space_to_depth: bool = False,
        bn_stats_stride: int = 1,
        bn_grad_stride: int = 1,
        bn_impl: str = "xla",
        stem_frozen: bool = False,
        stem_grad_stride: int = 1,
        frozen_stages: int = 0,
        bn_frozen: bool = False,
        bn_frozen_affine: bool = False,
        fuse_pointwise: str = "off",
        fuse_block: str = "auto",
        fuse_block_stages: Sequence[int] = (0, 1, 2, 3),
        fuse_proj: str = "auto",
        fuse_stem: str = "auto",
        fuse_stage: str = "auto",
        fuse_stage_stages: Sequence[int] = (0,),
        remat: bool = False,
        remat_stages: Sequence[int] = (),
    ) -> None:
        super().__init__()
        if fuse_pointwise not in POINTWISE_FLAGS:
            raise ValueError(f"fuse_pointwise must be one of {POINTWISE_FLAGS}, got {fuse_pointwise!r}")
        if not 0 <= frozen_stages <= len(stage_sizes):
            raise ValueError(f"frozen_stages={frozen_stages} out of range for {len(stage_sizes)} stages")
        if bn_impl not in IMPLS:
            raise ValueError(f"bn_impl must be one of {IMPLS}, got {bn_impl!r}")
        if min(bn_stats_stride, bn_grad_stride, stem_grad_stride) < 1:
            raise ValueError("bn_stats_stride, bn_grad_stride and stem_grad_stride must be >= 1")
        self.stage_sizes = tuple(stage_sizes)
        self.block_cls = block_cls
        self.output_dim = output_dim
        self.num_filters = num_filters
        self.dtype = DTYPES[dtype]
        self.norm_eps = norm_eps
        self.stem_space_to_depth = stem_space_to_depth
        self.stem_frozen = stem_frozen
        self.stem_grad_stride = stem_grad_stride
        self.frozen_stages = frozen_stages
        self.bn_frozen = bn_frozen
        self.frozen = bn_frozen and bn_frozen_affine
        self.remat, self.remat_stages = remat, tuple(remat_stages)
        self.fuse_pointwise = fuse_pointwise
        self.fuse_block, self.fuse_proj = fuse_block, fuse_proj
        self.fuse_stem, self.fuse_stage = fuse_stem, fuse_stage
        self.fuse_block_stages = tuple(fuse_block_stages)
        self.fuse_stage_stages = tuple(fuse_stage_stages)

        if stem_space_to_depth:
            self.conv_init_s2d = Conv(12, num_filters, 4, 1, ((2, 1), (2, 1)))
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, 3)
        self.norm_init = BatchNorm(num_filters, norm_eps)
        cin = num_filters
        for i, count in enumerate(self.stage_sizes):
            filters = num_filters * 2**i
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"stage{i}_block{j}", block_cls(cin, filters, strides, norm_eps))
                cin = filters * block_cls.expansion
        if output_dim is not None:
            self.fc = nn.Linear(cin, output_dim)
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.frozen_affine = self.frozen
                mod.momentum = norm_momentum
                mod.stats_stride, mod.grad_stride, mod.impl = bn_stats_stride, bn_grad_stride, bn_impl
        self._folded: Optional[Dict[str, tuple]] = None

    def blocks(self, i: int):
        return [getattr(self, f"stage{i}_block{j}") for j in range(self.stage_sizes[i])]

    # ─────────────── BN folding for the fused kernels ───────────────

    def _fold_one(self, key: str) -> tuple:
        if key == "stem":
            return fold_stem_params(*_fold(self.conv_init, self.norm_init), self.norm_eps, self.dtype)
        return getattr(self, key).fold(self.dtype)

    @torch.no_grad()
    def fold_frozen_bn(self) -> None:
        """Fold every frozen BN affine into its conv once and keep the result
        for the fused forward of inference. Call again after the weights
        change or the module moves to another device. The cache is used only
        while gradients are disabled: with gradients on (training) the
        forward folds anew on every call, so it never trains against stale
        weights and the gradient reaches the conv kernels."""
        keys = [] if self.stem_space_to_depth else ["stem"]
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                key = f"stage{i}_block{j}"
                # bottlenecks fold every block; BasicBlocks only their identity ones
                if self.block_cls is BottleneckBlock or getattr(self, key).is_identity:
                    keys.append(key)
        self._folded = {k: self._fold_one(k) for k in keys}

    def _folded_weights(self, key: str) -> tuple:
        if self._folded is not None and not torch.is_grad_enabled():
            return self._folded[key]
        return self._fold_one(key)

    # ─────────────── forward ───────────────

    def forward(self, x: torch.Tensor, train: bool = False, return_spatial: bool = False) -> torch.Tensor:
        dt = self.dtype
        bs = train and not self.bn_frozen  # argus_tpu: use_running_average = not train or bn_frozen
        bottleneck = self.block_cls is BottleneckBlock
        grad = torch.is_grad_enabled()
        # the stem is frozen under stem_frozen or any frozen_stages depth: its
        # forward records no graph, and the frozen stages' neither
        stem_frozen = self.stem_frozen or self.frozen_stages >= 1
        fuse_stem = (
            self.frozen
            and self.num_filters == 64
            and not self.stem_space_to_depth
            and x.shape[1] % 8 == 0
            and x.shape[2] % 8 == 0
            and x.shape[3] == 3
            and flag_on(self.fuse_stem, x, "stem", "train" if grad and not stem_frozen else "forward")
        )
        # the stem hands the stage-0 chain its pair-packed view (argus_tpu's
        # predicate, `models/resnet.py` there: frozen stages, every fuse flag
        # on for the no-save forward, the packed chain's geometry)
        packed = (
            fuse_stem
            and self.frozen_stages >= 1
            and bottleneck
            and 0 in self.fuse_block_stages
            and self._fuse(x, "forward", 0, x.shape[2] // 4)[2]
            and packed_fwd_ok(self.num_filters, 1, x.shape[2] // 4, self.num_filters,
                              self.num_filters * self.block_cls.expansion)
        )

        x = x.to(dt)
        with torch.no_grad() if stem_frozen else contextlib.nullcontext():
            if fuse_stem:
                x = stem_pool(x, *self._folded_weights("stem"), self.stem_grad_stride, packed_out=packed)
            else:
                conv = self.conv_init
                if self.stem_space_to_depth:
                    n, h, w, c = x.shape
                    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                    x, conv = x.reshape(n, h // 2, w // 2, 4 * c), self.conv_init_s2d
                x = torch.relu(conv_bn(conv, self.norm_init, x, bs))
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)

        for i in range(len(self.stage_sizes)):
            frozen = i < self.frozen_stages
            with torch.no_grad() if frozen else contextlib.nullcontext():
                mode = "train" if grad and not frozen else "forward"
                w_in = x.shape[2] * (2 if packed and i == 0 else 1)
                x = self._stage(i, x, *self._fuse(x, mode, i, w_in), bs, x_packed=packed and i == 0)

        if return_spatial:
            # the stride-32 feature map, for dense-prediction heads (keypoint family)
            return x.float()

        # global average pool: f32 sum, result in the compute dtype (jnp.mean)
        x = x.float().mean(dim=(1, 2)).to(dt)
        if self.output_dim is not None:
            x = F.linear(x, self.fc.weight.to(dt)) + self.fc.bias.to(dt)
        return x.float()

    def _fuse(self, x: torch.Tensor, mode: str, i: int, w_in: int) -> tuple:
        """(identity blocks, projection blocks, stage chain) fused for stage
        `i` (input width `w_in`) in `mode`. The chain needs the block and
        projection flags not "off", as argus_tpu's `fuse_stg = fuse_blk and
        fuse_prj and fuse_stage` needs them on; under "auto" each function
        reads its own `AUTO_FUSE` entry, so the chain can run where the
        blocks alone would not."""
        if not self.frozen:
            return False, False, False
        bottleneck = self.block_cls is BottleneckBlock
        blk = flag_on(self.fuse_block, x, "identity" if bottleneck else "basic", mode)
        prj = bottleneck and flag_on(self.fuse_proj, x, "projection", mode)
        f, s = self.num_filters * 2**i, 2 if i > 0 else 1
        cin = self.num_filters if i == 0 else f // 2 * self.block_cls.expansion
        packed = mode == "forward" and packed_fwd_ok(f, s, w_in // s, cin, f * self.block_cls.expansion)
        stg = (bottleneck and self.fuse_block != "off" and self.fuse_proj != "off"
               and flag_on(self.fuse_stage, x, "stage_chain_packed" if packed else "stage_chain", mode))
        return blk, prj, stg

    def _pointwise(self, x: torch.Tensor, mode: str) -> Optional[str]:
        """The pointwise op's implementation for the bottleneck blocks that no
        block, projection or chain kernel takes, or None: argus_tpu's
        `fuse_pw` (frozen BN and affine), "dot" the matmul path on any
        device, "on" and "auto" (`AUTO_FUSE`) the kernel."""
        if not (self.frozen and self.block_cls is BottleneckBlock) or self.fuse_pointwise == "off":
            return None
        if self.fuse_pointwise == "dot":
            return "dot"
        return "kernel" if flag_on(self.fuse_pointwise, x, "pointwise", mode) else None

    def _stage(self, i: int, x: torch.Tensor, fuse_blk: bool, fuse_prj: bool, fuse_stg: bool, bs: bool,
               x_packed: bool = False):
        blocks = self.blocks(i)
        fused_here = i in self.fuse_block_stages
        if fuse_stg and fused_here and (i in self.fuse_stage_stages or i < self.frozen_stages):
            # a chain keeps its own saved residuals: remat does not apply (argus_tpu)
            ws = [self._folded_weights(f"stage{i}_block{j}") for j in range(len(blocks))]
            proj = None if blocks[0].is_identity else ws[0]
            ids = ws if proj is None else ws[1:]
            return stage_chain(x, proj, ids, blocks[0].strides, x_packed=x_packed)
        grad = torch.is_grad_enabled()
        pw = self._pointwise(x, "train" if grad else "forward")
        remat = grad and (self.remat or i in self.remat_stages)
        for j, blk in enumerate(blocks):
            key = f"stage{i}_block{j}"
            if fused_here and ((fuse_blk and blk.is_identity) or (fuse_prj and not blk.is_identity)):
                if remat and isinstance(blk, BottleneckBlock):
                    x = blk.forward_fused(x, self._folded_weights(key), remat=True)
                    continue
                fn = lambda x, blk=blk, key=key: blk.forward_fused(x, self._folded_weights(key))  # noqa: E731
            elif pw is not None:
                fn = lambda x, blk=blk: blk.forward_pointwise(x, pw)  # noqa: E731
            else:
                fn = lambda x, blk=blk: blk(x, bs)  # noqa: E731
            x = _recompute(blk, fn, x) if remat else fn(x)
        return x


def _recompute(block: nn.Module, fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x), a block's forward, under remat: nothing of the block's interior
    is kept for the backward, which re-runs fn (torch.utils.checkpoint,
    non-reentrant) with the batch statistics the forward recorded
    (`StatsTape`): no statistic is computed twice and no running statistic
    moves twice."""
    tape = StatsTape(block)
    return checkpoint(fn, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (tape.record(), tape.replay()))


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock, **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock, **kw)


BACKBONES: Dict[str, Callable[..., ResNet]] = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
}

# block class of each backbone: the serving tuner keys the fused kernels on it
BACKBONE_BLOCKS = {
    "resnet18": BasicBlock,
    "resnet34": BasicBlock,
    "resnet50": BottleneckBlock,
    "resnet101": BottleneckBlock,
}
