"""ResNet stem: conv7x7/s2/pad3 + folded frozen BN + relu +
maxpool3x3/s2/pad1, NHWC, forward, saving forward and weight gradient.

Port of `argus_tpu/ops/pallas/stem_fused.py` (`fused_stem_pool`: the no-save
forward, `_stem_fwd_save_pallas` and `_stem_bwd_pallas`). The conv sums in
f32, the folded bias is added in f32, relu, one rounding to the activation
dtype (y), then the max pool; zero padding of the pool equals torch's -inf
padding because relu output is >= 0. The backward is the weight gradient
only (the image is data, the folded bias a frozen buffer):

    dacc = bf16(sum of g routed to each window's first maximum) * (y > 0)
    dW   = sum over the first n_images images of tap^T dacc     (f32)

with the window elements in row-major order and ties going to the first
(XLA's select-and-scatter order, `_POOL_TERMS`). With `grad_stride` s > 1
only the first N/s images contribute and dW is scaled by s in f32, an
unbiased estimate for a shuffled batch (`_stem_pool_bwd`); argus_tpu's rule
applies: s = 1 when N % s != 0.

On a CUDA tensor the wrappers launch `csrc/stem_fused.cu` (the forward, with
or without y) and `csrc/stem_fused_bwd.cu`; on a CPU tensor they run the
plain versions. `stem_pool` is the stem as autograd sees it: the no-save
forward when nothing needs a gradient, else `stem_saved`, the saving forward
with the weight-gradient backward. With `packed_out` it is argus_tpu's
packed-output stem (`_stem_fwd_packed_pallas`, forward only): the
(N, H/4, W/8, 128) pair-packed view the frozen stage-0 chain reads
(`stem_fwd_packed`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from argus_tpu_torch.ops.kernels._build import I, P, Kernel, tickets
from argus_tpu_torch.ops.kernels.block_fused import (
    check_cuda,
    check_device,
    fold_affine,
    needs_grad,
    zero_grad_of,
)

KERNEL = Kernel("stem_fused", "argus_stem_fwd", [P] * 4 + [I] * 3 + [P])
KERNEL_SAVE = Kernel("stem_fused", "argus_stem_fwd_save", [P] * 5 + [I] * 3 + [P])
# the packed-output stem launches the same kernel, counted apart
KERNEL_PACKED = Kernel("stem_fused", "argus_stem_fwd", [P] * 4 + [I] * 3 + [P])
KERNEL_BWD = Kernel("stem_fused_bwd", "argus_stem_bwd", [P] * 7 + [I] * 5 + [P])

_BWD_TILE = 16  # conv pixels per tile edge of csrc/stem_fused_bwd.cu


def fold_stem_params(k7, scale, bias, mean, var, eps: float, dtype):
    """(7,7,3,64) HWIO kernel + frozen BN buffers -> (w (7,7,3,64) in dtype,
    b (1,64) f32)."""
    return fold_affine(k7, scale, bias, mean, var, eps, dtype)


def stem_fwd_save_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The stem in plain PyTorch with the kernel's rounding point: (out
    (N, H/4, W/4, 64), y (N, H/2, W/2, 64) the conv + bias + relu output)."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=2, padding=3)
    y = torch.relu(y + b.float().reshape(1, -1, 1, 1)).to(x.dtype)
    out = F.max_pool2d(y.float(), 3, stride=2, padding=1).to(x.dtype)
    return out.permute(0, 2, 3, 1).contiguous(), y.permute(0, 2, 3, 1).contiguous()


def stem_pool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return stem_fwd_save_plain(x, w, b)[0]


def packed_view(out: torch.Tensor) -> torch.Tensor:
    """(N, Ho, Wo, 64) -> the pair-packed (N, Ho, Wo/2, 128) view, no copy:
    packed[n, h, j, r*64 + c] = out[n, h, 2j + r, c]."""
    n, ho, wo, c = out.shape
    if wo % 2 or not out.is_contiguous():
        raise ValueError(f"the pair-packed view needs a contiguous output of even width, got {tuple(out.shape)}")
    return out.view(n, ho, wo // 2, 2 * c)


def stem_pool_packed_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argus_tpu's packed-output stem in plain PyTorch: (N, H/4, W/8, 128)."""
    return packed_view(stem_pool_plain(x, w, b))


def stem_bwd_plain(x, g, out, y, n_images: int) -> torch.Tensor:
    """dW (7,7,3,64) f32 from the first n_images images, in plain PyTorch:
    the pool cotangent to each window's first maximum (window terms in
    row-major order, each pixel's contributions summed in that order in f32),
    the relu mask, dacc rounded to x's dtype, then the conv weight gradient."""
    x, g, out, y = (t[:n_images] for t in (x, g, out, y))
    hc, wc = y.shape[1:3]
    hp, wp = out.shape[1:3]
    # conv row/col r sits at r + 1; zeros around are the pool's padding
    yp = F.pad(y.float(), (0, 0, 1, 1, 1, 1))
    d = torch.zeros_like(yp)
    of, gf = out.float(), g.float()
    taken = torch.zeros_like(of, dtype=torch.bool)
    for ry in range(3):
        for rx in range(3):
            rows, cols = slice(ry, ry + 2 * hp - 1, 2), slice(rx, rx + 2 * wp - 1, 2)
            take = (yp[:, rows, cols] == of) & ~taken
            taken |= take
            d[:, rows, cols] += gf * take
    dacc = (d[:, 1:hc + 1, 1:wc + 1] * (y > 0)).to(x.dtype)
    dw = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2), (64, 3, 7, 7),
                                     dacc.float().permute(0, 3, 1, 2), stride=2, padding=3)
    return dw.permute(2, 3, 1, 0).contiguous()


def _check_stem(x, w, b):
    n, h, wd, c = x.shape
    if c != 3 or h % 4 or wd % 4:
        raise ValueError(f"stem kernel takes (N, H, W, 3) with H, W % 4 == 0, got {tuple(x.shape)}")
    check_cuda("x", x, torch.bfloat16)
    check_cuda("w", w, torch.bfloat16, (7, 7, 3, 64))
    if b is not None:
        check_cuda("b", b, torch.float32, (1, 64))
    return n, h, wd


def stem_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The no-save forward, (N, H, W, 3) -> (N, H/4, W/4, 64): the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if not check_device(x):
        return stem_pool_plain(x, w, b)
    n, h, wd = _check_stem(x, w, b)
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.bfloat16, device=x.device)
    KERNEL.launch(x, w, b, out, n, h, wd)
    return out


def stem_fwd_packed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argus_tpu's `_stem_fwd_packed_pallas`, (N, H, W, 3) -> (N, H/4, W/8,
    128) with out[n, h, j, r*64 + c] = pool[n, h, 2j + r, c]. In row-major
    memory that element sits at (j*128 + r*64 + c) = ((2j + r)*64 + c) within
    its row, NHWC's own offset of pool[n, h, 2j + r, c]: the pair packing only
    fills the TPU's 128-lane tiles, and on the card it is a view of the NHWC
    output. So this launches `stem_fwd`'s kernel (counted in
    `KERNEL_PACKED`) and returns the view, which the stage-0 chain reads
    without a copy. The plain version on a CPU tensor."""
    if not check_device(x):
        return stem_pool_packed_plain(x, w, b)
    n, h, wd = _check_stem(x, w, b)
    if wd % 8:
        raise ValueError(f"the packed stem needs W % 8 == 0, got {tuple(x.shape)}")
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.bfloat16, device=x.device)
    KERNEL_PACKED.launch(x, w, b, out, n, h, wd)
    return packed_view(out)


def stem_fwd_save(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The training forward, (out, y): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if not check_device(x):
        return stem_fwd_save_plain(x, w, b)
    n, h, wd = _check_stem(x, w, b)
    out = torch.empty((n, h // 4, wd // 4, 64), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((n, h // 2, wd // 2, 64), dtype=torch.bfloat16, device=x.device)
    KERNEL_SAVE.launch(x, w, b, out, y, n, h, wd)
    return out, y


def stem_bwd(x, g, out, y, n_images: int) -> torch.Tensor:
    """dW (7,7,3,64) f32 over the first n_images images: the CUDA kernel on a
    CUDA tensor (it reads nothing of the other images), the plain version on
    a CPU tensor."""
    if not check_device(x):
        return stem_bwd_plain(x, g, out, y, n_images)
    n, h, wd, c = x.shape
    if c != 3 or h % 4 or wd % 4 or not 1 <= n_images <= n:
        raise ValueError(f"stem backward takes (N, H, W, 3) with H, W % 4 == 0 and 1 <= n_images <= N, "
                         f"got {tuple(x.shape)}, n_images={n_images}")
    check_cuda("x", x, torch.bfloat16)
    for name, t, shape in (("g", g, (n, h // 4, wd // 4, 64)), ("out", out, (n, h // 4, wd // 4, 64)),
                           ("y", y, (n, h // 2, wd // 2, 64))):
        check_cuda(name, t, torch.bfloat16, shape)
    blocks, gsize = bwd_grid(n_images * -(-(h // 2) // _BWD_TILE) * -(-(wd // 2) // _BWD_TILE),
                             torch.cuda.get_device_properties(x.device).multi_processor_count)
    ws = torch.empty((blocks + -(-blocks // gsize), 147, 64), dtype=torch.float32, device=x.device)
    dw = torch.empty((7, 7, 3, 64), dtype=torch.float32, device=x.device)
    KERNEL_BWD.launch(x, g, out, y, ws, dw, tickets(x), n_images, h, wd, blocks, gsize)
    return dw


def bwd_grid(tiles: int, sms: int):
    """(blocks, group size) of the weight-gradient kernel: one persistent
    block an SM (at most one a tile), each block's partial added by the last
    block of its group of about sqrt(blocks), the groups' sums by the last
    group; a ticket counter a group and one for the groups
    (`_build.tickets`)."""
    blocks = min(tiles, sms)
    return blocks, max(1, round(blocks ** 0.5))



class _StemSaved(torch.autograd.Function):
    """argus_tpu's `_stem_pool` custom VJP: the saving forward, then the
    weight gradient on the first N/grad_stride images scaled by grad_stride
    in f32 and cast to w's dtype; the image and the folded bias get zeros."""

    @staticmethod
    def forward(ctx, x, w, b, grad_stride: int):
        out, y = stem_fwd_save(x, w, b)
        ctx.save_for_backward(x, out, y)
        ctx.w_dtype, ctx.b, ctx.grad_stride = w.dtype, b, grad_stride
        return out

    @staticmethod
    def backward(ctx, g):
        x, out, y = ctx.saved_tensors
        s = ctx.grad_stride
        dw = stem_bwd(x, g.contiguous(), out, y, x.shape[0] // s)
        if s > 1:
            dw = dw * float(s)
        need = ctx.needs_input_grad
        return zero_grad_of(need[0], x), dw.to(ctx.w_dtype), zero_grad_of(need[2], ctx.b), None


def stem_saved(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, grad_stride: int = 1) -> torch.Tensor:
    """The trained stem: the saving forward with the weight-gradient backward
    (`grad_stride` falls back to 1 when it does not divide the batch)."""
    if grad_stride < 1:
        raise ValueError(f"grad_stride must be >= 1, got {grad_stride}")
    if x.shape[0] % grad_stride:
        grad_stride = 1
    return _StemSaved.apply(x, w, b, grad_stride)


def stem_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, grad_stride: int = 1,
              packed_out: bool = False) -> torch.Tensor:
    """(N, H, W, 3) image -> (N, H/4, W/4, 64) as autograd sees it: the
    no-save forward when no input needs a gradient, else `stem_saved`. With
    `packed_out`, the (N, H/4, W/8, 128) view of `stem_fwd_packed`, forward
    only (a frozen stem)."""
    if packed_out:
        if needs_grad(x, w, b):
            raise ValueError("the packed-output stem is forward only: call it with gradients off")
        return stem_fwd_packed(x, w, b)
    if needs_grad(x, w, b):
        return stem_saved(x, w, b, grad_stride)
    return stem_fwd(x, w, b)


def fused_stem_pool(x, k7, scale, bias, mean, var, *, eps: float = 1e-5, grad_stride: int = 1,
                    packed_out: bool = False):
    """argus_tpu's `fused_stem_pool` signature: the (7,7,3,64) conv_init
    kernel and raw norm_init buffers, folded here in f32 (the gradient
    reaches k7 only), then the stem."""
    w, b = fold_stem_params(k7, scale, bias, mean, var, eps, x.dtype)
    return stem_pool(x, w, b, grad_stride, packed_out)
