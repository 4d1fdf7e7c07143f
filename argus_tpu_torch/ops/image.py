"""Basic on-device image ops (NHWC).

Port of `argus_tpu/ops/image.py` (`u8_to_f32`, `center_crop`).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _inv255(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1/255 rounded to `dtype`, on `device`, made once: an upload from host
    memory waits for the device (and cannot be captured in a CUDA graph).
    Read-only."""
    return torch.tensor(1.0 / 255.0, dtype=dtype, device=device)


def u8_to_f32(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> float [0, 1] in `dtype`, as argus_tpu computes it:
    the cast, then a multiply by 1/255 rounded to `dtype` (under amp a bf16
    multiply, not a float division)."""
    return images.to(dtype) * _inv255(dtype, images.device)


def center_crop(images, crop_hw: tuple):
    """Static centre crop of (..., H, W, C) images (torch or numpy) to
    (..., ch, cw, C): rows from (H - ch) // 2, columns from (W - cw) // 2,
    the pixels the host loader's numpy crop and kornia's `center_crop`
    select."""
    h, w = images.shape[-3], images.shape[-2]
    ch, cw = crop_hw
    top = (h - ch) // 2
    left = (w - cw) // 2
    return images[..., top:top + ch, left:left + cw, :]
