"""Pixel functions that both augmentation paths share: RGB <-> HSV and the
hue shift, and the spaghetti-arc mask. The per-op path (`ops.augment`)
applies them in the image dtype, the fused kernel's plain version
(`augment_fused.fused_augment_plain`) the hue in f32. Imports only torch.
"""

from __future__ import annotations

import torch


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) RGB -> HSV, in the image dtype."""
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = img.amax(1)
    minc = img.amin(1)
    v = maxc
    delta = maxc - minc
    one, zero = torch.ones_like(delta), torch.zeros_like(delta)
    safe_delta = torch.where(delta == 0, one, delta)
    s = torch.where(maxc == 0, zero, delta / torch.where(maxc == 0, one, maxc))
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    # branch by channel ORDERING, never by equality with the recomputed max
    # (argus_tpu/ops/augment.py:119-124): a near-tie picks either sextant
    # formula, and both agree at the tie
    is_r = (r >= g) & (r >= b)
    h = torch.where(is_r, bc - gc, torch.where(g >= b, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, zero, h)
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, v], 1)


def _pick(i_mod: torch.Tensor, vals) -> torch.Tensor:
    """vals[i_mod] for i_mod in 0..5 (floor-mod by 6 keeps it there, also
    where h rounds to 1.0)."""
    out = vals[5]
    for k in range(4, -1, -1):
        out = torch.where(i_mod == k, vals[k], out)
    return out


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) HSV -> RGB, in the image dtype."""
    h, s, v = hsv[:, 0], hsv[:, 1], hsv[:, 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i_mod = torch.remainder(i, 6.0)
    return torch.stack([_pick(i_mod, [v, q, p, p, t, v]), _pick(i_mod, [t, v, v, q, p, p]),
                        _pick(i_mod, [p, p, t, v, v, q])], 1)


def adjust_hue(img: torch.Tensor, shift) -> torch.Tensor:
    """Shift the hue by `shift` (a turn is 1), clipped to [0, 1]."""
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[:, 0:1] + shift, 1.0)
    return torch.clamp(hsv_to_rgb(torch.cat([h, hsv[:, 1:]], 1)), 0.0, 1.0)


def arc_mask(arcs: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, H, W) bool: pixels on any arc of `arcs` (N, n_arcs, 10) [cx, cy,
    1/rx, 1/ry, half width over r_min, ux, uy, vx, vy, wide]. A pixel is on
    an arc when its squared normalised elliptical radius lies between lo^2
    and (1 + hws)^2, lo = max(1 - hws, 0) (hws can exceed 1 for a degenerate
    bbox whose r_min sits at its 1e-3 floor), and its direction lies in the
    sweep (sign tests on two cross products). Each op rounds in f32, as the
    kernel's do."""
    yy = torch.arange(H, dtype=torch.float32, device=arcs.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=arcs.device)[None, :]
    occ = torch.zeros((arcs.shape[0], H, W), dtype=torch.bool, device=arcs.device)
    for i in range(arcs.shape[1]):
        cx, cy, irx, iry, hws, ux, uy, vx, vy, wide = (arcs[:, i, k, None, None] for k in range(10))
        dx = (xx - cx) * irx
        dy = (yy - cy) * iry
        rho2 = dx * dx + dy * dy
        lo = torch.clamp(1.0 - hws, min=0.0)
        on_ring = (rho2 > lo * lo) & (rho2 < (1.0 + hws) * (1.0 + hws))
        pos_u = (ux * dy - uy * dx) >= 0
        pos_v = (dx * vy - dy * vx) >= 0
        in_sweep = (pos_u & pos_v) | ((wide > 0.5) & (pos_u | pos_v))
        occ = occ | (on_ring & in_sweep)
    return occ
