"""BatchNorm's reduction kernels: per-channel (sum x, sum x^2) statistics and
the backward's (sum dy, sum dy * xhat), over every row or a block-granular
row subsample.

Port of `argus_tpu/ops/pallas/bn_reduce.py` (`fused_stats`,
`fused_bn_bwd_reduce`), with its signatures and returns: each takes an
activation (..., C) viewed as (M, C) rows and returns the two f32 sums of
shape (C,) and the number of rows visited. The rows visited are argus_tpu's:

- `stride == 1`: every row, for any M (`n_rows == M`);
- `stride > 1`: blocks of R = m_t * f contiguous rows, blocks 0, s, 2s, ...,
  `grid = max(1, n_blocks // s)` of them, `n_rows = grid * R`, with `m_t`
  from `_block_rows` and `f` from `_fold_factor` (argus_tpu's copies below:
  they decide which rows a strided estimate reads, so they are part of the
  function).

`fused_stats_plain` and `fused_bn_bwd_reduce_plain` compute the same sums in
plain PyTorch over the same rows; the wrappers launch `csrc/bn_reduce.cu` on a
CUDA tensor and run the plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from argus_tpu_torch.ops.kernels._build import I, L, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import check_cuda, check_device

KERNEL_STATS = Kernel("bn_reduce", "argus_bn_stats", [P, P, P, L, L, L, I, I, I, P])
KERNEL_BWD = Kernel("bn_reduce", "argus_bn_bwd_reduce", [P] * 6 + [L, L, L, I, I, I, P])

_TARGET_BLOCKS = 4 * 132  # four blocks on each of the H100's SMs
_MIN_ROWS = 1024  # rows a block reduces at least


def _fold_factor(C: int) -> int:
    """argus_tpu's lane-fold factor: (M, C) viewed as (M/f, f*C), f*C >= 128."""
    f = 1
    while C * f < 128:
        f *= 2
    return f


def _block_rows(M: int, Cf: int, stride: int) -> int:
    """argus_tpu's rows per block of the folded view: ~1 MB bf16 blocks, a
    power of two that divides M/stride's block count."""
    target = max(8, (1 << 20) // (Cf * 2))
    m_t = 8
    while m_t * 2 <= target and (M % (m_t * 2 * stride)) == 0 and (M // (m_t * 2 * stride)) >= 1:
        m_t *= 2
    return m_t


def visited_rows(M: int, C: int, stride: int) -> tuple:
    """(R, S, n_rows): the kernels visit blocks of R contiguous rows every S
    rows, n_rows in all (R = S = n_rows = M at stride 1)."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if stride == 1:
        return M, M, M
    f = _fold_factor(C)
    if M % f:
        raise ValueError(f"a strided BN reduction needs M % {f} == 0 for C = {C}, got M = {M}")
    m_t = _block_rows(M // f, C * f, stride)
    n_blocks = (M // f) // m_t
    if n_blocks == 0:
        raise ValueError(f"a strided BN reduction needs at least {m_t * f} rows, got {M}")
    R = m_t * f
    return R, stride * R, max(1, n_blocks // stride) * R


def _rows(x2: torch.Tensor, stride: int) -> torch.Tensor:
    """The rows of the (M, C) view that the kernels visit, in order."""
    R, S, n = visited_rows(x2.shape[0], x2.shape[1], stride)
    if n == x2.shape[0]:
        return x2
    return torch.cat([x2[b * S: b * S + R] for b in range(n // R)])


def fused_stats_plain(x: torch.Tensor, stride: int = 1):
    """(sum x, sum x^2, n_rows) in f32 over the visited rows."""
    xs = _rows(x.reshape(-1, x.shape[-1]), stride).float()
    return xs.sum(0), (xs * xs).sum(0), xs.shape[0]


def fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride: int = 1):
    """(sum dy, sum dy * xhat, n_rows) in f32 over the visited rows, xhat =
    (x - mean) * rstd in f32."""
    C = x.shape[-1]
    xs = _rows(x.reshape(-1, C), stride).float()
    dys = _rows(dy.reshape(-1, C), stride).float()
    xhat = (xs - mean.float()) * rstd.float()
    return dys.sum(0), (dys * xhat).sum(0), xs.shape[0]


def _launch_args(x: torch.Tensor, stride: int):
    C = x.shape[-1]
    M = x.numel() // C
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the BN reduction kernels take bf16 or f32, got {x.dtype}")
    vec = 16 // x.element_size()
    if C % vec:
        raise ValueError(f"the BN reduction kernels need C % {vec} == 0 for {x.dtype}, got C = {C}")
    check_cuda("x", x, x.dtype)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    R, S, n = visited_rows(M, C, stride)
    slabs = -(-C // (32 * vec))
    splits = max(1, min(-(-n // _MIN_ROWS), _TARGET_BLOCKS // slabs))
    ws = torch.empty((splits, 2, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    return ws, out, (n, R, S, C, int(x.dtype == torch.float32), splits), n


def fused_stats(x: torch.Tensor, stride: int = 1):
    """(sum x, sum x^2, n_rows) in f32 per channel of x (..., C): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not check_device(x):
        return fused_stats_plain(x, stride)
    ws, out, ints, n = _launch_args(x, stride)
    KERNEL_STATS.launch(x, ws, out, *ints)
    return out[0], out[1], n


def fused_bn_bwd_reduce(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        stride: int = 1):
    """(sum dy, sum dy * (x - mean) * rstd, n_rows) in f32 per channel: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if not check_device(x):
        return fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride)
    ws, out, ints, n = _launch_args(x, stride)
    C = x.shape[-1]
    check_cuda("dy", dy, x.dtype, x.shape)
    if dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    check_cuda("mean", mean, torch.float32, (C,))
    check_cuda("rstd", rstd, torch.float32, (C,))
    KERNEL_BWD.launch(x, dy, mean, rstd, ws, out, *ints)
    return out[0], out[1], n
