"""The whole augmentation stack per image in one launch.

Port of `argus_tpu/ops/pallas/augment_fused.py` (`fused_augment`, body
`_make_kernel` with phases "awjbp", and `jiggle_plan`): spaghetti arcs,
planckian gains, the colour jiggle in the sampled order (three
selector-driven affine passes clip(a x + b luma(x) + g mean(luma(x))) plus
the hue at its position), the gated gaussian and motion blurs with edge
clamp, and the plasma shadow from the (S, S) base field upsampled by
mh @ field @ mwt and normalised by its own min and max.

Rounding points are argus_tpu's: each op in the image dtype with the f32
per-image scalars cast at the op, the luma mean and the hue in f32, the arcs
and the plasma in f32. The upsample sums its products in a fixed order
without fused multiply-adds (`upsample`), on both versions, so the
threshold plasma < quantity falls on the same side in each.

Per-image scalars ride in one packed f32 row (argus_tpu's layout):
    [ arcs: n_arcs x 10 | planckian gains: 3 | jiggle b, c, s, h: 4 |
      gauss taps: 5 | motion 3x3: 9 | blur gates: 2 | plasma intensity, quantity: 2 ]

On a CUDA tensor `fused_augment` launches `csrc/augment_fused.cu` with the
jiggle plan as device data (no host read of the order); on a CPU tensor it
runs the plain version `fused_augment_plain`.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, P, Kernel
from argus_tpu_torch.ops.kernels.augment_common import adjust_hue, arc_mask
from argus_tpu_torch.ops.kernels.blur import DTYPES, clamp_shift
from argus_tpu_torch.ops.kernels.block_fused import check_cuda, check_device

KERNEL = Kernel("augment_fused", "argus_augment_fused", [P] * 8 + [I] * 6 + [P])
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


def smem_bytes(h: int, w: int, s: int, n_arcs: int, itemsize: int) -> int:
    """The kernel's shared memory (csrc/augment_fused.cu `smem_bytes`):
    mh @ field (h x s f32), the shade tile, reductions, ring bounds, nonzero
    ranges, and the three-channel blur buffers in the image dtype."""
    return 4 * (h * s + 32 * 32 + 64 + 2 * n_arcs + 2 * h + 2 * w) + 3 * (38 * 38 + 34 * 38 + 34 * 34) * itemsize


def jiggle_plan(order: torch.Tensor):
    """(hue_pos int32 scalar, (1, 3) int32 affine op selectors) from the
    (4,) order (0 brightness, 1 contrast, 2 saturation, 3 hue): the sampled
    order is [affine passes before hue] hue [affine passes after], on the
    device."""
    is_hue = (order == 3).to(torch.int32)
    hue_pos = torch.argmax(is_hue)
    aff = order[torch.argsort(is_hue, stable=True)][:3]
    return hue_pos.to(torch.int32), aff[None].to(torch.int32)


def upsample(field: torch.Tensor, mh: torch.Tensor, mwt: torch.Tensor) -> torch.Tensor:
    """mh @ field @ mwt, (N, H, W) f32, as the kernel computes it: each
    product and sum rounded separately, summed in index order."""
    t = torch.zeros((field.shape[0], mh.shape[0], field.shape[2]), dtype=torch.float32, device=field.device)
    for j in range(field.shape[1]):
        t = t + mh[None, :, j, None] * field[:, None, j, :]
    up = torch.zeros((field.shape[0], mh.shape[0], mwt.shape[1]), dtype=torch.float32, device=field.device)
    for k in range(mwt.shape[0]):
        up = up + t[:, :, k, None] * mwt[None, None, k, :]
    return up


def _luma(x: torch.Tensor) -> torch.Tensor:
    """Luma in the image dtype; the weights are host scalars rounded to it."""
    c = lambda v: torch.tensor(v, dtype=x.dtype)  # noqa: E731
    return c(0.299) * x[:, 0] + c(0.587) * x[:, 1] + c(0.114) * x[:, 2]


def fused_augment_plain(images, field, mh, mwt, packed, order, n_arcs: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch (batched over images)."""
    N, _, H, W = images.shape
    dt = images.dtype
    A = 10 * n_arcs
    PO, JO, GO, MO, BO, QO = A, A + 3, A + 7, A + 12, A + 21, A + 23
    col = lambda k: packed[:, k]  # noqa: E731  (N,) f32
    vec = lambda s: s.to(dt)[:, None, None, None]  # noqa: E731  cast at the vector op
    x = images

    if n_arcs > 0:
        occ = arc_mask(packed[:, :A].reshape(N, n_arcs, 10), H, W)
        x = torch.where(occ[:, None], torch.zeros((), dtype=dt, device=x.device), x)

    x = torch.clamp(x * packed[:, PO:PO + 3].to(dt)[:, :, None, None], 0.0, 1.0)

    bf, cf, sf, hf = (col(JO + k) for k in range(4))
    hue_pos, aff = jiggle_plan(order[0])

    def hue(img):  # the per-op hue, computed in f32
        return adjust_hue(img.float(), hf[:, None, None, None]).to(dt)

    def unified(img, op):
        a = torch.where(op == 0, bf, torch.where(op == 1, cf, sf))
        b_ = torch.where(op == 2, 1.0 - sf, torch.zeros_like(sf))
        g_ = torch.where(op == 1, 1.0 - cf, torch.zeros_like(cf))
        lum = _luma(img)
        m32 = lum.float().mean((1, 2))
        return torch.clamp(vec(a) * img + vec(b_) * lum[:, None] + vec(g_ * m32), 0.0, 1.0)

    hp = int(hue_pos)
    for r in range(3):
        if r == hp:
            x = hue(x)
        x = unified(x, aff[0, r])
    if hp == 3:
        x = hue(x)

    gw = [vec(col(GO + k)) for k in range(5)]
    xp = clamp_shift(x, 2, 2)
    g = sum(gw[k] * xp[:, :, k:k + H, :] for k in range(5))
    gp = clamp_shift(g, 3, 2)
    g2 = sum(gw[k] * gp[:, :, :, k:k + W] for k in range(5))
    ggate = col(BO)
    g2 = vec(ggate) * g2 + vec(1.0 - ggate) * x
    mp = clamp_shift(clamp_shift(g2, 2, 1), 3, 1)
    m = sum(vec(col(MO + 3 * ky + kx)) * mp[:, :, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3))
    mgate = col(BO + 1)
    x = vec(mgate) * m + vec(1.0 - mgate) * g2

    up = upsample(field, mh, mwt)
    fmin = up.amin((1, 2), keepdim=True)
    fmax = up.amax((1, 2), keepdim=True)
    plasma = (up - fmin) / torch.clamp(fmax - fmin, min=1e-6)
    shade = (plasma < col(QO + 1)[:, None, None]).float() * col(QO)[:, None, None]
    return torch.clamp(x + shade[:, None].to(dt), 0.0, 1.0)


def fused_augment(images, field, mh, mwt, packed, order, n_arcs: int) -> torch.Tensor:
    """argus_tpu's signature: images (N, 3, H, W) in [0, 1], f32 or bf16;
    field (N, S, S) f32; mh (H, S), mwt (S, W) f32; packed (N, 10 n_arcs +
    25) f32; order (1, 4) int32. The CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not check_device(images):
        return fused_augment_plain(images, field, mh, mwt, packed, order, n_arcs)
    n, c, h, w = images.shape
    s = field.shape[-1]
    if c != 3 or images.dtype not in DTYPES or n <= 0:
        raise ValueError(f"augment kernel takes (N, 3, H, W) f32 or bf16, got {tuple(images.shape)} "
                         f"{images.dtype}")
    if smem_bytes(h, w, s, n_arcs, images.element_size()) > SMEM_LIMIT:
        raise ValueError(f"augment kernel keeps mh @ field ({h}x{s} f32) in shared memory: too large")
    check_cuda("images", images, images.dtype)
    check_cuda("field", field, torch.float32, (n, s, s))
    check_cuda("mh", mh, torch.float32, (h, s))
    check_cuda("mwt", mwt, torch.float32, (s, w))
    check_cuda("packed", packed, torch.float32, (n, 10 * n_arcs + 25))
    hue_pos, aff = jiggle_plan(order.reshape(4))
    plan = torch.cat([hue_pos[None], aff[0]]).contiguous()
    scratch = torch.empty_like(images)
    out = torch.empty_like(images)
    KERNEL.launch(images, field, mh, mwt, packed, plan, scratch, out, n, h, w, s, n_arcs,
                  DTYPES[images.dtype])
    return out
