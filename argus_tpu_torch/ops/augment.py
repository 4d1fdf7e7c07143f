"""On-device image augmentation stack of the port.

Port of `argus_tpu/ops/augment.py`: the same transforms, parameter ranges,
probabilities and order (spaghetti arcs -> random erasing x2 -> planckian
jitter -> colour jiggle -> gaussian blur -> motion blur -> plasma shadow ->
salt & pepper), the same public layout (NHWC `(B, H, W, 3 * n_cams)` in and
out, channel-first `(N, 3, H, W)` inside, N = B * n_cams) and the same two
application paths:

- the fused path, one launch of `ops.kernels.augment_fused` for the default
  transform set (argus_tpu's `pallas_fused`; "auto" means fused for a CUDA
  tensor, per-op for a CPU one);
- the per-op path, one PyTorch op per transform, with the gaussian and motion
  blurs in one launch of `ops.kernels.blur` when `pallas_blur` is set (edge
  clamp borders; reflect borders otherwise).

Sampling is separate from application. `sample_params` draws every
transform's parameters into one `AugmentParams`, which either path consumes,
so both paths apply identical parameters from one key. A key is a 64-bit
integer; `split` and `fold_in` (splitmix64) play the part of
`jax.random.split` / `fold_in`, and each of the nine transform slots draws
from its own `torch.Generator` on the images' device, seeded from its
sub-key: switching one transform off shifts no other transform's draws. The
colour-jiggle order, one permutation per batch that steers host-side control
flow in the per-op path, comes from a CPU generator of the same sub-key, so
sampling never reads the device back.

The numbers are not argus_tpu's (torch's generators are not jax.random's);
the distributions are, and the tests feed argus_tpu's sampled parameters to
both packages to compare the application.

Rounding points follow argus_tpu: the per-op path computes in the image
dtype (jiggle factors cast to it, HSV in it); the fused path keeps jiggle
factors in f32, casts them at the op and computes the hue in f32. Planckian
gains are the table rows rounded to the image dtype on both paths (the
value of argus_tpu's one-hot product).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from argus_tpu_torch.ops.kernels.augment_common import adjust_hue, arc_mask
from argus_tpu_torch.ops.kernels.augment_fused import fused_augment
from argus_tpu_torch.ops.kernels.blur import fused_random_blur

Range = Union[float, Tuple[float, float]]
_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class AugmentationConfig:
    """argus_tpu's `AugmentationConfig`: the same fields and defaults.
    `pallas_blur` selects the blur CUDA kernel on the per-op path,
    `pallas_fused` the whole-stack CUDA kernel ("auto": on CUDA tensors)."""

    brightness: Range = (0.8, 1.0)
    contrast: Range = (0.5, 1.2)
    saturation: Range = (0.25, 1.2)
    hue: Range = (-0.1, 0.1)

    num_spaghetti: int = 10

    color_jiggle: bool = True
    planckian_jitter: bool = True
    random_erasing: bool = False
    blur: bool = True
    motion_blur: bool = True
    plasma_shadow: bool = True
    salt_and_pepper: bool = False

    pallas_blur: bool = True
    pallas_fused: Union[bool, str] = "auto"


def _as_range(r: Range, center_one: bool = False) -> Tuple[float, float]:
    """Scalar shorthand: r -> (max(0, 1 - r), 1 + r) for multiplicative
    factors, (-r, r) for the hue."""
    if isinstance(r, (int, float)):
        if center_one:
            return (max(0.0, 1.0 - float(r)), 1.0 + float(r))
        return (-float(r), float(r))
    return (float(r[0]), float(r[1]))


# ───────────────────────────── keys and generators ─────────────────────────────


def _mix(z: int) -> int:
    """splitmix64's finaliser."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from `key` and an integer (the step), like `jax.random.fold_in`."""
    return _mix(_mix(key & _MASK64) ^ (data & _MASK64))


def split(key: int, n: int) -> List[int]:
    """`n` independent sub-keys of `key`, like `jax.random.split`."""
    return [_mix(_mix(key & _MASK64) ^ _mix(i + 1)) for i in range(n)]


def generator(key: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(key)
    return g


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """f32 uniform in [lo, hi) (sampled in f32, cast where it meets the image)."""
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) < p


@functools.lru_cache(maxsize=None)
def _upload(make, args: tuple, device: torch.device) -> torch.Tensor:
    """The numpy table make(*args) on `device`, built and uploaded once per
    device: an upload from host memory waits for the device, which a train
    step must not do. Read-only."""
    return torch.as_tensor(make(*args), device=device)


def _luma_weights() -> np.ndarray:
    return np.array([0.299, 0.587, 0.114], np.float32)


# ───────────────────────────── colour-space helpers (N, 3, H, W) ─────────────────────────────


def _rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, keeping the channel dim, in the image dtype."""
    w = _upload(_luma_weights, (), img.device).to(img.dtype)[None, :, None, None]
    return (img * w).sum(1, keepdim=True)


# ───────────────────────────── colour jiggle ─────────────────────────────


def _adjust_brightness(img, factor):
    return torch.clamp(img * factor, 0.0, 1.0)


def _adjust_contrast(img, factor):
    mean = _rgb_to_gray(img).mean((2, 3), keepdim=True)
    return torch.clamp(factor * img + (1.0 - factor) * mean, 0.0, 1.0)


def _adjust_saturation(img, factor):
    return torch.clamp(factor * img + (1.0 - factor) * _rgb_to_gray(img), 0.0, 1.0)


def _jiggle_params(gen: torch.Generator, order_gen: torch.Generator, B: int, n_cams: int,
                   cfg: AugmentationConfig):
    """(B * n_cams, 4) f32 [brightness, contrast, saturation, hue] factors,
    shared by each example's cameras, and the (4,) application order (int64,
    on the CPU: one permutation per batch)."""

    def shared(lo, hi):
        return _uniform(gen, (B,), lo, hi).repeat_interleave(n_cams)

    b = shared(*_as_range(cfg.brightness, center_one=True))
    c = shared(*_as_range(cfg.contrast, center_one=True))
    s = shared(*_as_range(cfg.saturation, center_one=True))
    h = shared(*_as_range(cfg.hue))
    return torch.stack([b, c, s, h], 1), torch.randperm(4, generator=order_gen)


def color_jiggle(images: torch.Tensor, factors: torch.Tensor, order) -> torch.Tensor:
    """Brightness / contrast / saturation / hue in `order` (a permutation of
    0..3), per-image factors (N, 4) cast to the image dtype."""
    f = factors.to(images.dtype)
    b, c, s, h = (f[:, k, None, None, None] for k in range(4))
    ops = (lambda im: _adjust_brightness(im, b), lambda im: _adjust_contrast(im, c),
           lambda im: _adjust_saturation(im, s), lambda im: adjust_hue(im, h))
    for op in order.tolist():
        images = ops[op](images)
    return images


# ───────────────────────────── planckian jitter ─────────────────────────────


def _cie_xyz_bar(lam_nm: np.ndarray) -> np.ndarray:
    """CIE 1931 2-degree colour matching functions, the multi-lobe piecewise
    Gaussian fit of Wyman, Sloan & Shirley (JCGT 2013). (3, len(lam))."""

    def g(lam, mu, s_lo, s_hi):
        s = np.where(lam < mu, s_lo, s_hi)
        return np.exp(-0.5 * ((lam - mu) / s) ** 2)

    x = (
        1.056 * g(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(lam_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(lam_nm, 568.8, 46.9, 40.5) + 0.286 * g(lam_nm, 530.9, 16.3, 31.1)
    z = 1.217 * g(lam_nm, 437.0, 11.8, 36.0) + 0.681 * g(lam_nm, 459.0, 26.0, 13.8)
    return np.stack([x, y, z])


# CIE XYZ -> linear sRGB (D65), IEC 61966-2-1
_XYZ_TO_SRGB = np.array(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ]
)


def _blackbody_rgb_table(n: int = 25, t_min: float = 3000.0, t_max: float = 15000.0) -> np.ndarray:
    """(n, 3) G-normalised R/G/B gains of blackbody illuminants from 3000 K
    to 15000 K: Planck's spectral radiance integrated against the CIE
    matching functions over 380-780 nm, XYZ -> linear sRGB, clamped at 0."""
    lam_nm = np.linspace(380.0, 780.0, 401)
    lam_m = lam_nm * 1e-9
    cmf = _cie_xyz_bar(lam_nm)
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    table = np.zeros((n, 3))
    for i, T in enumerate(np.linspace(t_min, t_max, n)):
        radiance = 1.0 / (lam_m**5 * (np.exp(h * c / (lam_m * kb * T)) - 1.0))
        rgb = np.maximum(_XYZ_TO_SRGB @ (cmf @ radiance), 0.0)
        table[i] = rgb / rgb[1]
    return table.astype(np.float32)


_PLANCKIAN_TABLE = _blackbody_rgb_table()


def _planckian_gains(gen: torch.Generator, n: int, p: float, dtype) -> torch.Tensor:
    """(n, 3) gated blackbody gains in `dtype` (1.0 rows where the gate is
    off). A row of the table rounded to `dtype` is exactly argus_tpu's
    one-hot product in `dtype`."""
    idx = torch.randint(0, _PLANCKIAN_TABLE.shape[0], (n,), generator=gen, device=gen.device)
    table = _upload(_blackbody_rgb_table, (), gen.device).to(dtype)
    gate = _bernoulli(gen, p, (n, 1))
    return torch.where(gate, table[idx], torch.ones((), dtype=dtype, device=gen.device))


def planckian_jitter(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Per-image white-balance gains (N, 3) in the image dtype."""
    return torch.clamp(images * gains[:, :, None, None], 0.0, 1.0)


# ───────────────────────────── gaussian and motion blur ─────────────────────────────


def _reflect_pad(images: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """`jnp.pad(mode="reflect")` on H and W, any dtype (index gather)."""
    _, _, H, W = images.shape

    def idx(n, r):
        i = torch.arange(-r, n + r, device=images.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    return images[:, :, idx(H, pad_h)][:, :, :, idx(W, pad_w)]


def _shifted_sum_1d(images: torch.Tensor, weights: torch.Tensor, axis: int, radius: int) -> torch.Tensor:
    """Per-image 1-D convolution as shifted adds, reflect padding."""
    padded = _reflect_pad(images, radius if axis == 2 else 0, radius if axis == 3 else 0)
    out = torch.zeros_like(images)
    length = images.shape[axis]
    for k in range(2 * radius + 1):
        out = out + weights[:, k, None, None, None] * padded.narrow(axis, k, length)
    return out


def _gaussian_taps(gen: torch.Generator, n: int, sigma_range=(3.0, 8.0), p: float = 0.5):
    """(n, 5) normalised gaussian taps (f32) and the (n,) gate."""
    sigma = _uniform(gen, (n, 1), *sigma_range)
    x = torch.arange(-2.0, 3.0, device=gen.device)[None, :]
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    w = w / w.sum(1, keepdim=True)
    return w, _bernoulli(gen, p, (n,))


def gaussian_blur(images: torch.Tensor, taps: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """5x5 separable gaussian with per-image taps, reflect padding."""
    w = taps.to(images.dtype)
    blurred = _shifted_sum_1d(_shifted_sum_1d(images, w, 2, 2), w, 3, 2)
    return torch.where(gate[:, None, None, None], blurred, images)


def _motion_kernel(gen: torch.Generator, n: int, angle_deg: float = 35.0, direction: float = 0.5,
                   p: float = 0.7):
    """(n, 3, 3) normalised motion kernels (f32) and the (n,) gate: a 3-tap
    line (asymmetric weights from the direction) at a random angle, splatted
    bilinearly on the 3x3 grid."""
    theta = torch.deg2rad(_uniform(gen, (n,), -angle_deg, angle_deg))
    d = _uniform(gen, (n,), -direction, direction)
    w_taps = torch.stack([(1.0 - d) / 2.0, torch.ones_like(d), (1.0 + d) / 2.0], 1)
    w_taps = w_taps / w_taps.sum(1, keepdim=True)
    offsets = torch.arange(-1.0, 2.0, device=gen.device)
    px = offsets[None, :] * torch.cos(theta)[:, None]
    py = offsets[None, :] * torch.sin(theta)[:, None]
    grid = torch.arange(-1.0, 2.0, device=gen.device)
    wx = torch.clamp(1.0 - (px[:, :, None] - grid[None, None, :]).abs(), min=0.0)
    wy = torch.clamp(1.0 - (py[:, :, None] - grid[None, None, :]).abs(), min=0.0)
    kernel = (w_taps[:, :, None, None] * wy[:, :, :, None] * wx[:, :, None, :]).sum(1)
    kernel = kernel / kernel.sum((1, 2), keepdim=True)
    return kernel, _bernoulli(gen, p, (n,))


def motion_blur(images: torch.Tensor, kernel: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """Per-image 3x3 kernel as shifted adds, reflect padding."""
    k = kernel.to(images.dtype)
    padded = _reflect_pad(images, 1, 1)
    H, W = images.shape[2:]
    out = torch.zeros_like(images)
    for ky in range(3):
        for kx in range(3):
            out = out + k[:, ky, kx, None, None, None] * padded[:, :, ky:ky + H, kx:kx + W]
    return torch.where(gate[:, None, None, None], out, images)


# ───────────────────────────── plasma shadow ─────────────────────────────


def _resize_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear interpolation matrix, half-pixel (align_corners=False)."""
    idx = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    lo = np.clip(np.floor(idx), 0, in_size - 1).astype(int)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = np.clip(idx - lo, 0.0, 1.0)
    M = np.zeros((out_size, in_size), np.float32)
    M[np.arange(out_size), lo] += 1 - frac
    M[np.arange(out_size), hi] += frac
    return M


def _resize_matrix_corner(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) bilinear matrix, corner-preserving (align_corners=True): the
    octave chain's midpoint subdivision."""
    idx = np.arange(out_size) * (in_size - 1) / max(out_size - 1, 1)
    lo = np.clip(np.floor(idx), 0, in_size - 1).astype(int)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = np.clip(idx - lo, 0.0, 1.0)
    M = np.zeros((out_size, in_size), np.float32)
    M[np.arange(out_size), lo] += 1 - frac
    M[np.arange(out_size), hi] += frac
    return M


def _plasma_base_field(gen: torch.Generator, n: int, hw: tuple, roughness: torch.Tensor,
                       max_octave: int = 64) -> torch.Tensor:
    """(n, s, s) un-normalised multi-octave value noise, s = the first power
    of two >= min(max_octave, max(H, W)); roughness (n, 1, 1)."""
    top = min(max_octave, max(hw))
    size = 2
    field = torch.rand((n, size, size), generator=gen, device=gen.device)
    amp = roughness
    while size < top:
        size *= 2
        up = _upload(_resize_matrix_corner, (size, size // 2), gen.device)
        field = up @ field @ up.T
        field = field + amp * (torch.rand((n, size, size), generator=gen, device=gen.device) - 0.5)
        amp = amp * roughness
    return field


def _plasma_params(gen: torch.Generator, n: int, hw: tuple, roughness=(0.1, 0.4),
                   shade_intensity=(-0.6, 0.0), shade_quantity=(0.0, 0.5), p: float = 1.0):
    """(base field (n, s, s), gated intensity (n,), quantity (n,)), f32."""
    rough = _uniform(gen, (n, 1, 1), *roughness)
    intensity = _uniform(gen, (n,), *shade_intensity)
    quantity = _uniform(gen, (n,), *shade_quantity)
    gate = _bernoulli(gen, p, (n,))
    field = _plasma_base_field(gen, n, hw, rough)
    return field, torch.where(gate, intensity, torch.zeros_like(intensity)), quantity


def _resize_matrix_t(out_size: int, in_size: int) -> np.ndarray:
    return np.ascontiguousarray(_resize_matrix(out_size, in_size).T)


def resize_matrices(H: int, W: int, S: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mh (H, S), mwt (S, W)), read-only: the field's bilinear upsample to
    (H, W) is mh @ field @ mwt."""
    device = torch.device(device)
    return _upload(_resize_matrix, (H, S), device), _upload(_resize_matrix_t, (W, S), device)


def plasma_shadow(images: torch.Tensor, field: torch.Tensor, intensity: torch.Tensor,
                  quantity: torch.Tensor) -> torch.Tensor:
    """Darken by `intensity` where the min-max normalised upsampled field is
    below `quantity`."""
    N, _, H, W = images.shape
    S = field.shape[-1]
    if S != H or S != W:
        mh, mwt = resize_matrices(H, W, S, images.device)
        field = mh @ field @ mwt
    fmin = field.amin((1, 2), keepdim=True)
    fmax = field.amax((1, 2), keepdim=True)
    plasma = (field - fmin) / torch.clamp(fmax - fmin, min=1e-6)
    shade = (plasma < quantity[:, None, None]).float()[:, None] * intensity[:, None, None, None]
    return torch.clamp(images + shade.to(images.dtype), 0.0, 1.0)


# ───────────────────────────── random erasing, salt & pepper ─────────────────────────────


def _erasing_params(gen: torch.Generator, N: int, H: int, W: int, scale, ratio, p: float = 0.5):
    """(rh, rw, cy, cx, gate), each (N,): one rectangle per image."""
    area = _uniform(gen, (N,), *scale) * H * W
    aspect = _uniform(gen, (N,), *ratio)
    rh = torch.sqrt(area * aspect)
    rw = torch.sqrt(area / aspect)
    cy = _uniform(gen, (N,), 0.0, 1.0) * (H - rh)
    cx = _uniform(gen, (N,), 0.0, 1.0) * (W - rw)
    return rh, rw, cy, cx, _bernoulli(gen, p, (N,))


def random_erasing(images: torch.Tensor, params, value: float) -> torch.Tensor:
    rh, rw, cy, cx, gate = params
    _, _, H, W = images.shape
    yy = torch.arange(H, device=images.device)[None, :, None]
    xx = torch.arange(W, device=images.device)[None, None, :]
    col = lambda t: t[:, None, None]  # noqa: E731
    mask = (yy >= col(cy)) & (yy < col(cy + rh)) & (xx >= col(cx)) & (xx < col(cx + rw))
    fill = torch.full((), value, dtype=images.dtype, device=images.device)
    return torch.where((mask & col(gate))[:, None], fill, images)


def _salt_pepper_params(gen: torch.Generator, N: int, H: int, W: int, amount=(0.01, 0.06),
                        salt_vs_pepper=(0.4, 0.6), p: float = 0.7):
    """(amount (N,1,1), salt share (N,1,1), uniforms (N,H,W), gate (N,1,1))."""
    amt = _uniform(gen, (N, 1, 1), *amount)
    svp = _uniform(gen, (N, 1, 1), *salt_vs_pepper)
    u = torch.rand((N, H, W), generator=gen, device=gen.device)
    return amt, svp, u, _bernoulli(gen, p, (N, 1, 1))


def salt_and_pepper(images: torch.Tensor, params) -> torch.Tensor:
    amt, svp, u, gate = params
    salt = ((u < amt * svp) & gate)[:, None]
    pepper = ((u >= amt * svp) & (u < amt) & gate)[:, None]
    one = torch.ones((), dtype=images.dtype, device=images.device)
    return torch.where(salt, one, torch.where(pepper, torch.zeros_like(one), images))


# ───────────────────────────── spaghetti arcs ─────────────────────────────


def _arc_params(gen: torch.Generator, n: int, n_arcs: int, H: int, W: int, width_range=(1.0, 5.0)):
    """(n, n_arcs, 10) f32 per-arc scalars [cx, cy, 1/rx, 1/ry, half width
    over r_min, ux, uy, vx, vy, wide]: a PIL-style bbox arc."""
    u = lambda lo, hi: _uniform(gen, (n, n_arcs), lo, hi)  # noqa: E731
    x0 = u(0.0, W)
    y0 = u(0.0, H)
    x1 = x0 + u(0.0, 1.0) * (W - x0)
    y1 = y0 + u(0.0, 1.0) * (H - y0)
    a0 = u(0.0, 360.0)
    a1 = u(0.0, 360.0)
    width = u(*width_range)
    rx = torch.clamp((x1 - x0) / 2.0, min=1e-3)
    ry = torch.clamp((y1 - y0) / 2.0, min=1e-3)
    r_min = torch.minimum(rx, ry)
    sweep = torch.remainder(a1 - a0, 360.0)
    return torch.stack([
        (x0 + x1) / 2.0, (y0 + y1) / 2.0, 1.0 / rx, 1.0 / ry, width / (2.0 * r_min),
        torch.cos(torch.deg2rad(a0)), torch.sin(torch.deg2rad(a0)),
        torch.cos(torch.deg2rad(a1)), torch.sin(torch.deg2rad(a1)), (sweep > 180.0).float(),
    ], -1)


def spaghetti_arcs(images: torch.Tensor, arcs: torch.Tensor) -> torch.Tensor:
    """Black elliptical arcs, `arcs` (N, n_arcs, 10) from `_arc_params`."""
    if arcs.shape[1] == 0:
        return images
    occ = arc_mask(arcs, *images.shape[2:])
    return torch.where(occ[:, None], torch.zeros((), dtype=images.dtype, device=images.device), images)


# ───────────────────────────── parameters ─────────────────────────────


@dataclass
class AugmentParams:
    """Every transform's sampled parameters for one batch of N = B * n_cams
    camera images; None for a transform that is off."""

    arcs: Optional[torch.Tensor] = None  # (N, n_arcs, 10) f32
    erase: Optional[tuple] = None  # two `_erasing_params` tuples (fill 0, fill 1)
    gains: Optional[torch.Tensor] = None  # (N, 3) image dtype
    jiggle: Optional[torch.Tensor] = None  # (N, 4) f32
    order: Optional[torch.Tensor] = None  # (4,) int64, CPU
    gauss: Optional[tuple] = None  # taps (N, 5) f32, gate (N,) bool
    motion: Optional[tuple] = None  # kernel (N, 3, 3) f32, gate (N,) bool
    plasma: Optional[tuple] = None  # field (N, s, s), intensity (N,), quantity (N,), f32
    salt: Optional[tuple] = None  # `_salt_pepper_params`


def sample_params(cfg: AugmentationConfig, key: int, B: int, n_cams: int, H: int, W: int,
                  device, dtype) -> AugmentParams:
    """Sample the enabled transforms' parameters, slot i of
    `split(key, 9)` for the i-th transform (argus_tpu's key slots)."""
    keys = split(key, 9)
    gen = lambda i: generator(keys[i], device)  # noqa: E731
    N = B * n_cams
    p = AugmentParams()
    if cfg.num_spaghetti > 0:
        p.arcs = _arc_params(gen(0), N, cfg.num_spaghetti, H, W)
    if cfg.random_erasing:
        p.erase = (_erasing_params(gen(1), N, H, W, (0.02, 0.1), (2.0, 3.0)),
                   _erasing_params(gen(2), N, H, W, (0.02, 0.05), (0.8, 1.2)))
    if cfg.planckian_jitter:
        p.gains = _planckian_gains(gen(3), N, 0.5, dtype)
    if cfg.color_jiggle:
        p.jiggle, p.order = _jiggle_params(gen(4), generator(keys[4], "cpu"), B, n_cams, cfg)
    if cfg.blur:
        p.gauss = _gaussian_taps(gen(5), N)
    if cfg.motion_blur:
        p.motion = _motion_kernel(gen(6), N)
    if cfg.plasma_shadow:
        p.plasma = _plasma_params(gen(7), N, (H, W))
    if cfg.salt_and_pepper:
        p.salt = _salt_pepper_params(gen(8), N, H, W)
    return p


def take_rows(p: AugmentParams, a: int, b: int) -> AugmentParams:
    """The parameters of camera images [a, b) of `p` (one rank's rows of a
    global batch's draw); the colour order, one draw a batch, is kept."""
    def cut(v):
        if isinstance(v, torch.Tensor):
            return v[a:b]
        return tuple(cut(t) for t in v)

    out = AugmentParams()
    for f in fields(AugmentParams):
        v = getattr(p, f.name)
        setattr(out, f.name, v if v is None or f.name == "order" else cut(v))
    return out


# ───────────────────────────── the two application paths ─────────────────────────────


def pack_fused(p: AugmentParams, N: int, H: int, W: int, n_arcs: int, device):
    """The fused kernel's operands from the sampled parameters: (field,
    mh, mwt, packed (N, 10 n_arcs + 25) f32 in argus_tpu's row layout, order
    (1, 4) int32 on `device`)."""
    f32 = torch.float32
    gw, ggate = p.gauss
    mk, mgate = p.motion
    field, intensity, quantity = p.plasma
    arcs = p.arcs.reshape(N, -1) if n_arcs > 0 else torch.zeros((N, 0), dtype=f32, device=device)
    packed = torch.cat([
        arcs, p.gains.to(f32), p.jiggle, gw, mk.reshape(N, 9), ggate[:, None].to(f32),
        mgate[:, None].to(f32), intensity[:, None], quantity[:, None],
    ], 1).contiguous()
    mh, mwt = resize_matrices(H, W, field.shape[-1], device)
    order = p.order.to(torch.int32)
    if torch.device(device).type == "cuda":  # an upload from pinned memory does not wait for the device
        order = order.pin_memory()
    order = order.to(device, non_blocking=True)[None]
    return field.contiguous(), mh, mwt, packed, order


def apply_per_op(cfg: AugmentationConfig, p: AugmentParams, per_cam: torch.Tensor) -> torch.Tensor:
    """One op per transform, argus_tpu's per-op path."""
    if p.arcs is not None:
        per_cam = spaghetti_arcs(per_cam, p.arcs)
    if p.erase is not None:
        per_cam = random_erasing(per_cam, p.erase[0], 0.0)
        per_cam = random_erasing(per_cam, p.erase[1], 1.0)
    if p.gains is not None:
        per_cam = planckian_jitter(per_cam, p.gains)
    if p.jiggle is not None:
        per_cam = color_jiggle(per_cam, p.jiggle, p.order)
    if cfg.pallas_blur and p.gauss is not None and p.motion is not None:
        gates = torch.stack([p.gauss[1], p.motion[1]], 1)
        per_cam = fused_random_blur(per_cam, p.gauss[0], p.motion[0], gates)
    else:
        if p.gauss is not None:
            per_cam = gaussian_blur(per_cam, *p.gauss)
        if p.motion is not None:
            per_cam = motion_blur(per_cam, *p.motion)
    if p.plasma is not None:
        per_cam = plasma_shadow(per_cam, *p.plasma)
    if p.salt is not None:
        per_cam = salt_and_pepper(per_cam, p.salt)
    return per_cam


def _check_channels(images: torch.Tensor, n_cams: int) -> None:
    if images.shape[-1] != 3 * n_cams:
        raise ValueError(f"expected {3 * n_cams} channels, got {images.shape[-1]}")


def apply_augmentation(cfg: AugmentationConfig, key: int, images: torch.Tensor, n_cams: int = 2,
                       train: bool = True) -> torch.Tensor:
    """The full stack on (B, H, W, 3 * n_cams) float images in [0, 1], in
    their dtype and on their device, with the parameters `key` samples;
    identity when not `train`."""
    if not train:
        return images
    _check_channels(images, n_cams)
    B, H, W, _ = images.shape
    params = sample_params(cfg, key, B, n_cams, H, W, images.device, images.dtype)
    return apply_params(cfg, params, images, n_cams)


def fused_applies(cfg: AugmentationConfig, device) -> bool:
    """True when `apply_params` takes the fused path for images on
    `device`: the default transform set with the fused kernel selected
    ("auto": on CUDA)."""
    fused = torch.device(device).type == "cuda" if cfg.pallas_fused == "auto" else cfg.pallas_fused
    default_set = all((cfg.color_jiggle, cfg.planckian_jitter, cfg.blur, cfg.motion_blur, cfg.plasma_shadow))
    return bool(fused and default_set and not (cfg.random_erasing or cfg.salt_and_pepper))


def _per_cam(images: torch.Tensor, n_cams: int) -> torch.Tensor:
    B, H, W, _ = images.shape
    return images.reshape(B, H, W, n_cams, 3).permute(0, 3, 4, 1, 2).reshape(B * n_cams, 3, H, W)


def _nhwc(per_cam: torch.Tensor, B: int, n_cams: int) -> torch.Tensor:
    _, _, H, W = per_cam.shape
    out = per_cam.reshape(B, n_cams, 3, H, W).permute(0, 3, 4, 1, 2)
    return out.contiguous().reshape(B, H, W, 3 * n_cams)


def apply_params(cfg: AugmentationConfig, params: AugmentParams, images: torch.Tensor,
                 n_cams: int = 2) -> torch.Tensor:
    """The full stack with parameters already sampled (`sample_params`), on
    (B, H, W, 3 * n_cams) images: the fused path or the per-op path, as
    `cfg` and the images' device select (`fused_applies`)."""
    _check_channels(images, n_cams)
    B, H, W, _ = images.shape
    if fused_applies(cfg, images.device):
        operands = pack_fused(params, B * n_cams, H, W, cfg.num_spaghetti, images.device)
        return apply_packed(cfg, operands, images, n_cams)
    return _nhwc(apply_per_op(cfg, params, _per_cam(images, n_cams)), B, n_cams)


def apply_packed(cfg: AugmentationConfig, operands: tuple, images: torch.Tensor, n_cams: int = 2) -> torch.Tensor:
    """The fused path on (B, H, W, 3 * n_cams) images with the operands
    `pack_fused` made: one `augment_fused` launch and its layout
    transposes, no host work and no upload (a CUDA graph can capture it)."""
    _check_channels(images, n_cams)
    return _nhwc(fused_augment(_per_cam(images, n_cams), *operands, cfg.num_spaghetti), images.shape[0], n_cams)


class Augmentation:
    """argus_tpu's object-style wrapper: a config and a train flag, called on
    images with an explicit key."""

    def __init__(self, cfg: AugmentationConfig, train: bool = True, n_cams: int = 2) -> None:
        self.cfg = cfg
        self.train = train
        self.n_cams = n_cams

    def __call__(self, images: torch.Tensor, key: int) -> torch.Tensor:
        return apply_augmentation(self.cfg, key, images, n_cams=self.n_cams, train=self.train)
