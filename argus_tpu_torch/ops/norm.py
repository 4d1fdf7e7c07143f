"""BatchNorm over the last axis of NHWC activations: argus_tpu's eval, frozen
and train modes.

Port of `argus_tpu/ops/norm.py` BatchNorm. The variables match flax's
(scale/bias params, mean/var statistics) under torch's names (weight/bias,
running_mean/running_var), and the affine is computed in the compute dtype
exactly as the reference does, ``((x - mean) * rsqrt(var + eps)) * scale +
bias`` with each factor cast to that dtype.

The caller says which statistics normalise: `forward(x, batch_stats)`, with
argus_tpu's rule ``batch_stats = train and not bn_frozen`` applied by the
model. Without batch statistics the running ones normalise and nothing is
updated; with `frozen_affine` (argus_tpu's `bn_frozen_affine`, torch's
FrozenBatchNorm2d) scale and bias take no gradient either.

With batch statistics (train mode, `norm.py:183-213`):

- the statistics are f32, mean and the biased E[x^2] - E[x]^2 (flax's fast
  variance), and the running ones move in place under `torch.no_grad()` with
  flax's momentum, ``running = momentum * running + (1 - momentum) * batch``
  (0.9 keeps the old value: not torch's convention, nor its unbiased
  variance);
- `impl="xla"` with both strides 1 differentiates through the statistics,
  as autodiff does (`_Moments` and `_Affine` give autograd's values and
  gradients while saving only x, not its f32 copy and the affine's
  intermediates);
- otherwise (a stride above 1, or the reduction kernels) the statistics
  carry no gradient and `_BNApplySubgrad`'s backward applies the exact
  BatchNorm formula with batch moments from `_reduce_moments`:
  ``dx = rstd*scale*(dy - mean(dy) - xhat*mean(dy*xhat))``, dscale and
  dbias the subsample's sums scaled by total/kept rows. The "xla" engine
  subsamples contiguous row blocks along H (`_block_subsample`), the kernel
  engine ("pallas") every s-th row block of the flattened rows
  (`ops.kernels.bn_reduce`): at a stride above 1 the two read other rows.

Under remat (`StatsTape`) a block's forward records the batch statistics
each BatchNorm used, and the block's recompute in the backward normalises
with them: it computes no statistics (no second `bn_stats` launch, no other
sum of another order) and moves no running statistic, as argus_tpu's
`nn.remat` discards what its recompute updates.

Over a process group (`group`, set by a data-parallel train step), the
statistics are the global batch's, argus_tpu's exact BN under a mesh
(`argus_tpu/train.py:274-280`), with SyncBatchNorm's structure on this
module's own reductions: the per-channel sums (the kernel's or the "xla"
path's: sum and sum of squares) are summed over the group before the mean
and variance are formed; in the backward `_BNApplySubgrad` sums (sum dy,
sum dy*xhat) over the group and `_Moments` the incoming cotangents of the
mean and mean of squares; dscale and dbias stay each rank's own share
(the step sums the gradients). Every rank holds as many rows, so the
global row count is the local one times the group's size. The running
statistics move from the global moments on every rank, and `StatsTape`
records them. At a stride above 1 the "xla" engine subsamples each image,
so the ranks' subsamples make the global one; the kernel engine's row
blocks are cut from the flattened rows, so `check_rank_rows` raises where
the ranks' blocks are not the global batch's.

`impl` keeps argus_tpu's names: "pallas" is the reduction kernels (their
plain versions on a CPU tensor), "auto" is the kernels on a CUDA tensor and
"xla" on a CPU tensor, as the port's `fuse_*` flags read "auto".
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from argus_tpu_torch.ops.kernels import bn_reduce
from argus_tpu_torch.parallel.collectives import all_reduce_, group_size

IMPLS = ("xla", "pallas", "auto")


def _block_subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """argus_tpu's H-subsample of (N, H, W, C): keep 1 of every `stride`
    contiguous row blocks along H (block height 8, 4, 2 or 1, the first that
    divides H / stride); x itself when H does not factor."""
    if stride <= 1 or x.ndim != 4:
        return x
    N, H, W, C = x.shape
    for bs in (8, 4, 2, 1):
        if H % (bs * stride) == 0:
            return x.reshape(N, H // (bs * stride), stride, bs, W, C)[:, :, 0].reshape(N, H // stride, W, C)
    return x


def _merged(spans):
    out = []
    for a, b in spans:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


@functools.lru_cache(maxsize=None)
def check_rank_rows(M: int, C: int, stride: int, ranks: int) -> None:
    """Raise unless the kernel engine's visited row blocks of `ranks` equal
    shares of M rows each (an (M, C) view a rank, stride `stride`) make up
    the blocks it visits in the global batch's ranks * M rows."""
    if stride <= 1 or ranks <= 1:
        return
    R, S, n = bn_reduce.visited_rows(M * ranks, C, stride)
    Rl, Sl, nl = bn_reduce.visited_rows(M, C, stride)
    want = _merged([(b * S, b * S + R) for b in range(n // R)])
    got = _merged([(r * M + b * Sl, r * M + b * Sl + Rl) for r in range(ranks) for b in range(nl // Rl)])
    if want != got:
        raise ValueError(f"bn_impl='pallas' at stride {stride}: the row blocks of {ranks} ranks of {M} rows x {C} "
                         f"channels are not the global batch's; use bn_impl='xla' (it subsamples each image) or a "
                         f"stride of 1")


def _sum_over(group, *sums: torch.Tensor):
    """The f32 per-channel sums, each summed over `group` in one collective."""
    if group is None:
        return sums
    flat = all_reduce_(torch.cat([t.float().reshape(-1) for t in sums]), group)
    return flat.split([t.numel() for t in sums])


def _reduce_moments(x, dy, mean, rstd, stride: int, impl: str):
    """(sum dy, sum dy*xhat, rows counted, total rows), from 1/stride of the
    rows: the kernel's row blocks ("pallas") or `_block_subsample`'s."""
    C = x.shape[-1]
    total = x.numel() // C
    if impl == "pallas":
        s_dy, s_dyxh, n = bn_reduce.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)
        return s_dy, s_dyxh, n, total
    xs = _block_subsample(x, stride)
    dys32 = _block_subsample(dy, stride).float()
    xhat32 = (xs.float() - mean) * rstd
    red = tuple(range(x.ndim - 1))
    return dys32.sum(red), (dys32 * xhat32).sum(red), xs.numel() // C, total


class _BNApplySubgrad(torch.autograd.Function):
    """argus_tpu's `_bn_apply_subgrad` custom VJP: the affine on given f32
    mean and rstd (constants), and the exact BatchNorm gradient from batch
    moments estimated on 1/grad_stride of the rows; dx in x's dtype at the
    reference's rounding points, dscale and dbias in f32."""

    @staticmethod
    def forward(ctx, x, mean, rstd, scale, bias, grad_stride: int, impl: str, group=None):
        dt = x.dtype
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.grad_stride, ctx.impl, ctx.group = grad_stride, impl, group
        return ((x - mean.to(dt)) * rstd.to(dt)) * scale.to(dt) + bias.to(dt)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale = ctx.saved_tensors
        dt = x.dtype
        dy = dy.contiguous()
        sum_dy, sum_dy_xhat, n_sub, total = _reduce_moments(x, dy, mean, rstd, ctx.grad_stride, ctx.impl)
        ratio = total / n_sub
        g_dy, g_dy_xhat = _sum_over(ctx.group, sum_dy, sum_dy_xhat)
        n_all = n_sub * group_size(ctx.group)
        m_dy = (g_dy / n_all).to(dt)
        m_dy_xhat = (g_dy_xhat / n_all).to(dt)
        xhat = (x - mean.to(dt)) * rstd.to(dt)
        dx = (rstd.to(dt) * scale.to(dt)) * (dy - m_dy - xhat * m_dy_xhat)
        return dx, None, None, sum_dy_xhat * ratio, sum_dy * ratio, None, None, None


class _Moments(torch.autograd.Function):
    """(mean, mean of squares) over all axes but the last, in f32: autograd's
    values and gradient through ``x.float().mean(red)`` and
    ``x.float().square().mean(red)``, dx = (dmsq / M) * (2 x) + dmean / M cast
    to x's dtype, saving x instead of its f32 copy. `recorded` (a remat
    recompute) gives the values of the forward instead of summing again."""

    @staticmethod
    def forward(ctx, x, recorded=None, group=None):
        ctx.save_for_backward(x)
        ctx.group = group
        if recorded is not None:
            return recorded[0].clone(), recorded[1].clone()
        red = tuple(range(x.ndim - 1))
        x32 = x.float()
        if group is None:
            return x32.mean(red), x32.square().mean(red)
        M = x.numel() // x.shape[-1] * group_size(group)
        s, q = _sum_over(group, x32.sum(red), x32.square().sum(red))
        return s / M, q / M

    @staticmethod
    def backward(ctx, dmean, dmsq):
        (x,) = ctx.saved_tensors
        M = x.numel() // x.shape[-1] * group_size(ctx.group)
        dmean, dmsq = _sum_over(ctx.group, dmean, dmsq)
        return ((dmsq / M) * (2.0 * x.float()) + dmean / M).to(x.dtype), None, None


class _Affine(torch.autograd.Function):
    """``((x - m) * r) * s + b`` in x's dtype with (C,) m, r, s, b of that
    dtype: autograd's values and gradient (each product and broadcast sum
    as autograd forms it), recomputing x - m and (x - m) * r in the
    backward instead of saving them."""

    @staticmethod
    def forward(ctx, x, m, r, s, b):
        ctx.save_for_backward(x, m, r, s)
        return ((x - m) * r) * s + b

    @staticmethod
    def backward(ctx, dy):
        x, m, r, s = ctx.saved_tensors
        red = tuple(range(x.ndim - 1))
        a = x - m
        p = a * r
        dp = dy * s
        da = dp * r
        return da, (-da).sum(red), (dp * a).sum(red), (dy * p).sum(red), dy.sum(red)


class StatsTape:
    """The batch statistics the BatchNorms of one block (`module`) used in its
    forward, for the block's recompute under remat: `record()` around the
    forward, `replay()` around the recompute (torch.utils.checkpoint's
    `context_fn`). Replayed, a BatchNorm takes its recorded statistics and
    updates no running statistic."""

    def __init__(self, module: nn.Module) -> None:
        self.bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
        self.stats = {}

    @contextlib.contextmanager
    def _mode(self, mode: str):
        for bn in self.bns:
            bn.tape = (self, mode)
        try:
            yield
        finally:
            for bn in self.bns:
                bn.tape = None

    def record(self):
        return self._mode("record")

    def replay(self):
        return self._mode("replay")


class BatchNorm(nn.Module):
    """flax-compatible BatchNorm over the channel (last) axis (see the module
    docstring for the modes)."""

    def __init__(self, features: int, eps: float = 1e-5, frozen_affine: bool = False, momentum: float = 0.9,
                 stats_stride: int = 1, grad_stride: int = 1, impl: str = "xla") -> None:
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"BatchNorm impl must be one of {IMPLS}, got {impl!r}")
        self.eps = eps
        self.frozen_affine = frozen_affine
        self.momentum = momentum
        self.stats_stride = stats_stride
        self.grad_stride = grad_stride
        self.impl = impl
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.tape = None  # (StatsTape, "record" or "replay") while a remat block runs
        self.group = None  # the data-parallel process group of the batch statistics, if any

    def forward(self, x: torch.Tensor, batch_stats: bool = False) -> torch.Tensor:
        dt = x.dtype
        scale, bias = self.weight, self.bias
        if not batch_stats:
            if self.frozen_affine:
                scale, bias = scale.detach(), bias.detach()
            rstd = torch.rsqrt(self.running_var + self.eps)
            return ((x - self.running_mean.to(dt)) * rstd.to(dt)) * scale.to(dt) + bias.to(dt)

        impl = self.impl
        if impl == "auto":
            impl = "pallas" if x.is_cuda else "xla"
        custom = self.stats_stride > 1 or self.grad_stride > 1 or impl == "pallas"
        tape, mode = self.tape or (None, None)
        recorded = tape.stats[self] if mode == "replay" else None
        if custom and recorded is not None:
            mean, var = recorded
        elif impl == "pallas":
            with torch.no_grad():
                if self.group is not None:
                    check_rank_rows(x.numel() // x.shape[-1], x.shape[-1], self.stats_stride,
                                    group_size(self.group))
                    if self.grad_stride != self.stats_stride:
                        check_rank_rows(x.numel() // x.shape[-1], x.shape[-1], self.grad_stride,
                                        group_size(self.group))
                s, q, n = bn_reduce.fused_stats(x.detach(), self.stats_stride)
                s, q = _sum_over(self.group, s, q)
                n = n * group_size(self.group)
                mean = s / n
                var = torch.clamp(q / n - mean.square(), min=0.0)
        elif custom:
            with torch.no_grad():
                xs32 = _block_subsample(x, self.stats_stride).float()
                red = tuple(range(x.ndim - 1))
                if self.group is None:
                    mean = xs32.mean(red)
                    var = torch.clamp(xs32.square().mean(red) - mean.square(), min=0.0)
                else:
                    s, q = _sum_over(self.group, xs32.sum(red), xs32.square().sum(red))
                    n = xs32.numel() // x.shape[-1] * group_size(self.group)
                    mean = s / n
                    var = torch.clamp(q / n - mean.square(), min=0.0)
        if not custom:
            mean, msq = _Moments.apply(x, recorded, self.group)
            v = msq - mean.square()
            var = torch.maximum(v, torch.zeros_like(v))  # jnp.maximum's tie gradient (half each)
        if mode == "record":
            tape.stats[self] = (mean, var) if custom else (mean.detach(), msq.detach())

        if mode != "replay":
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

        rstd = torch.rsqrt(var + self.eps)
        if custom:
            return _BNApplySubgrad.apply(x, mean, rstd, scale, bias, self.grad_stride, impl, self.group)
        return _Affine.apply(x, mean.to(dt), rstd.to(dt), scale.to(dt), bias.to(dt))
