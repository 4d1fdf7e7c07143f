"""Gated gaussian-then-motion blur of the augmentation's per-op path.

Port of `argus_tpu/ops/pallas/blur.py` (`fused_random_blur`, body
`_blur_kernel`): per image a 5-tap separable gaussian (rows, then columns),
its gate, a 3x3 motion kernel on the result, its gate; edge-clamp borders
(kornia reflects: a border difference argus_tpu accepts). Each op rounds to
the image dtype, as the TPU kernel's vector ops do in it, with the per-image
scalars cast to it at the op.

On a CUDA tensor `fused_random_blur` launches `csrc/blur.cu` (one read and
one write of the batch: a block per band of rows, or per tile of a band where
one would not fit, with `band_plan`'s sizes); on a CPU tensor it runs the
plain version `fused_random_blur_plain`, the port of `blur.reference_blur`.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import check_cuda, check_device

KERNEL = Kernel("blur", "argus_blur", [P] * 3 + [I] * 6 + [P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_BUDGET = 72 * 1024  # a block's shared memory: three blocks an SM
HALO = 3  # rows each side of a band: the vertical gaussian's 2 and the motion kernel's 1


def smem_bytes(rows: int, pitch: int, itemsize: int) -> int:
    """A block's shared memory (csrc/blur.cu `blur_smem`): three channels of
    the band and its halo, one channel's vertical gaussian (rows + 2), pairs
    of `pitch` a row, and the band's mbarrier."""
    return (3 * (rows + 2 * HALO) + rows + 2) * pitch * 2 * itemsize + 16


def band_plan(h: int, w: int, itemsize: int):
    """(R rows a band, CW columns a tile) of the kernel: the whole width
    where a band of 8 rows fits the budget, else the widest even tile (with
    a 4-column halo each side) that does; then the most rows that fit,
    spread evenly over the bands."""
    pitch = (w + 1) // 2  # pairs a shared row
    if smem_bytes(8, pitch, itemsize) <= SMEM_BUDGET:
        cw = w + (w & 1)
    else:
        pitch = (SMEM_BUDGET - 16) // (smem_bytes(8, 1, itemsize) - 16)
        cw = 2 * (pitch - 4)
    rows = min(h, max(1, ((SMEM_BUDGET - 16) // (2 * pitch * itemsize) - 6 * HALO - 2) // 4))
    bands = -(-h // rows)
    return -(-h // bands), cw


def clamp_shift(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """x padded by r edge copies on each side of `axis` (an index gather:
    `jnp.pad(mode="edge")` for any dtype)."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    return x.index_select(axis, idx)


def fused_random_blur_plain(images: torch.Tensor, gauss_w: torch.Tensor, motion_k: torch.Tensor,
                            gates: torch.Tensor) -> torch.Tensor:
    """The blur in plain PyTorch, in the image dtype."""
    _, _, H, W = images.shape
    dt = images.dtype
    gw = gauss_w.to(dt)
    mk = motion_k.to(dt)
    xp = clamp_shift(images, 2, 2)
    g = sum(gw[:, k, None, None, None] * xp[:, :, k:k + H, :] for k in range(5))
    gp = clamp_shift(g, 3, 2)
    g2 = sum(gw[:, k, None, None, None] * gp[:, :, :, k:k + W] for k in range(5))
    ggate = gates[:, 0, None, None, None].to(dt)
    g2 = ggate * g2 + (1 - ggate) * images
    mp = clamp_shift(clamp_shift(g2, 2, 1), 3, 1)
    m = sum(mk[:, ky, kx, None, None, None] * mp[:, :, ky:ky + H, kx:kx + W]
            for ky in range(3) for kx in range(3))
    mgate = gates[:, 1, None, None, None].to(dt)
    return mgate * m + (1 - mgate) * g2


def fused_random_blur(images: torch.Tensor, gauss_w: torch.Tensor, motion_k: torch.Tensor,
                      gates: torch.Tensor) -> torch.Tensor:
    """images (N, 3, H, W) f32 or bf16; gauss_w (N, 5); motion_k (N, 3, 3);
    gates (N, 2) in {0, 1} ([:, 0] the gaussian, [:, 1] the motion blur).
    The CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not check_device(images):
        return fused_random_blur_plain(images, gauss_w, motion_k, gates)
    n, c, h, w = images.shape
    if c != 3 or images.dtype not in DTYPES or not 0 < n <= 65535:
        raise ValueError(f"blur kernel takes (N <= 65535, 3, H, W) f32 or bf16, got "
                         f"{tuple(images.shape)} {images.dtype}")
    check_cuda("images", images, images.dtype)
    packed = torch.cat([gauss_w.reshape(n, 5).float(), motion_k.reshape(n, 9).float(),
                        gates.reshape(n, 2).float()], 1).contiguous()
    check_cuda("packed", packed, torch.float32, (n, 16))
    out = torch.empty_like(images)
    rows, cw = band_plan(h, w, images.element_size())
    KERNEL.launch(images, packed, out, n, h, w, rows, cw, DTYPES[images.dtype])
    return out
