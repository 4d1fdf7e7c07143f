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

On the card each is ONE launch of a stream over the visited rows
(`stats_plan` says how the work is cut, and fixes the order of every sum, so
the result is the same bit for bit from run to run): the (M, C) view is a
3-D tensor map (the visited blocks of R rows, R rows, C channels) read in
boxes of `box_rows` rows x `slab` channels; block b of the grid reduces
slab b % nslab over its run of `per` boxes (split b // nslab) through a ring
of shared-memory stages, writes its partial sums, and the last block to
finish adds the partials in split order (in `runs` runs a channel, then the
runs in order). The last block is the one that draws the grid's last
ticket from a counter (`_build.tickets`, word 0), one a CUDA stream, so
that launches on two streams never share one. One tensor holds the partials and the output;
the plan and the launcher's ints are cached per (M, C, stride, itemsize,
streams).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from argus_tpu_torch.ops.kernels._build import P, Kernel, tickets
from argus_tpu_torch.ops.kernels.block_fused import check_cuda, check_device

KERNEL_STATS = Kernel("bn_reduce", "argus_bn_stats", [P] * 6)
KERNEL_BWD = Kernel("bn_reduce", "argus_bn_bwd_reduce", [P] * 9)

_BLOCKS = 132  # the persistent grid: one block on each of the H100's SMs
_STAGE_BYTES = 16384  # a ring stage: one box (two in the backward: x and dy)
_SLAB_BYTES = 256  # a box row: the channels one block reduces
_MAX_BOX_ROWS = 256  # a TMA box dimension's limit
_MIN_BOXES = 8  # boxes a block streams at least
_THREADS = 256  # the consumer threads of a block
_MAX_RUNS = 32  # runs of the final sum a column of four channels


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


class StatsPlan(NamedTuple):
    """How the one-launch reduction cuts the visited rows of an (M, C) view
    (csrc/bn_reduce.cu `stream_kernel`):

    - R, S, n_rows: `visited_rows`; nblk = n_rows // R visited blocks of R
      rows (1 at stride 1, R = M);
    - slab: channels of a box row (the row's channels split into nslab
      slabs of at most 256 bytes, a multiple of 16 bytes each; the last
      slab's box zero-fills past C);
    - box_rows: rows of a box, a power of two (at a stride, it divides R);
      bpr = ceil(R / box_rows) boxes a block of R rows (at stride 1 the last
      box zero-fills past M), boxes = nblk * bpr boxes a slab, box i at
      rows (i % bpr) * box_rows of visited block i // bpr;
    - splits: grid blocks a slab, each `per` consecutive boxes (the last
      fewer); block b = split * nslab + slab;
    - runs: the final sum of a channel's `splits` partials in `runs`
      contiguous runs of ceil(splits / runs), added in split order, then
      the runs added in order (the last block sums C / 2 columns of four
      channels: `runs` fills its 256 threads).
    """

    R: int
    S: int
    n_rows: int
    nblk: int
    slab: int
    nslab: int
    box_rows: int
    bpr: int
    boxes: int
    per: int
    splits: int
    runs: int

    @property
    def grid(self) -> int:
        return self.nslab * self.splits


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


@functools.lru_cache(maxsize=None)
def stats_plan(M: int, C: int, stride: int, itemsize: int, tensors: int = 1) -> StatsPlan:
    """The plan of the one-launch reduction over (M, C) at `stride`, for
    inputs of `itemsize` bytes and `tensors` streams (1: the statistics; 2:
    the backward's x and dy), cached per argument tuple."""
    R, S, n = visited_rows(M, C, stride)
    vec = 16 // itemsize
    nslab = -(-C * itemsize // _SLAB_BYTES)
    slab = -(-(-(-C // nslab)) // vec) * vec
    box_rows = min(_MAX_BOX_ROWS, _pow2_floor(_STAGE_BYTES // (tensors * slab * itemsize)))
    if R != n or R != M:  # a strided plan: R is a power of two, and the boxes divide it
        box_rows = min(box_rows, R)
    bpr = -(-R // box_rows)
    nblk = n // R
    boxes = nblk * bpr
    splits = max(1, min(_BLOCKS // nslab, -(-boxes // _MIN_BOXES)))
    per = -(-boxes // splits)
    splits = -(-boxes // per)
    runs = min(splits, _MAX_RUNS, _pow2_floor(_THREADS // (C // 2)) if C // 2 <= _THREADS else 1)
    return StatsPlan(R, S, n, nblk, slab, nslab, box_rows, bpr, boxes, per, splits, runs)


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


@functools.lru_cache(maxsize=None)
def _launch_plan(M: int, C: int, stride: int, itemsize: int, tensors: int):
    """(rows of C floats before the output in the workspace, the plan's 13
    ints as a C array (the launcher reads them through one pointer), its
    address, n_rows), cached with `stats_plan`."""
    p = stats_plan(M, C, stride, itemsize, tensors)
    ints = (ctypes.c_int * 13)(p.R, p.S, p.nblk, C, int(itemsize == 4), p.slab, p.box_rows, p.bpr, p.nslab, p.per,
                               p.boxes, p.splits, p.runs)
    return -(-p.grid * 2 * p.slab // C), ints, ctypes.addressof(ints), p.n_rows


def _launch_args(x: torch.Tensor, stride: int, tensors: int):
    """(workspace (k + 2, C), the output's address (its rows k and k + 1),
    the plan's address, the stream's ticket, k, n_rows): one allocation
    holds the grid's partials, from its start, and the output."""
    C = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the BN reduction kernels take bf16 or f32, got {x.dtype}")
    e = x.element_size()
    if C % (16 // e):
        raise ValueError(f"the BN reduction kernels need C % {16 // e} == 0 for {x.dtype}, got C = {C}")
    check_cuda("x", x, x.dtype)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    M = x.numel() // C
    if M >= 2**31:
        raise ValueError(f"the BN reduction kernels take fewer than 2^31 rows, got {M}")
    k, _, plan, n = _launch_plan(M, C, stride, e, tensors)
    ws = torch.empty((k + 2, C), dtype=torch.float32, device=x.device)
    return ws, ws.data_ptr() + 4 * k * C, plan, tickets(x), k, n


def fused_stats(x: torch.Tensor, stride: int = 1):
    """(sum x, sum x^2, n_rows) in f32 per channel of x (..., C): the CUDA
    kernel on a CUDA tensor (one launch), the plain version on a CPU
    tensor."""
    if not check_device(x):
        return fused_stats_plain(x, stride)
    ws, out, plan, ticket, k, n = _launch_args(x, stride, 1)
    KERNEL_STATS.launch(x, ws, out, plan, ticket)
    return ws[k], ws[k + 1], n


def fused_bn_bwd_reduce(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                        stride: int = 1):
    """(sum dy, sum dy * (x - mean) * rstd, n_rows) in f32 per channel: the
    CUDA kernel on a CUDA tensor (one launch), the plain version on a CPU
    tensor."""
    if not check_device(x):
        return fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride)
    ws, out, plan, ticket, k, n = _launch_args(x, stride, 2)
    C = x.shape[-1]
    check_cuda("dy", dy, x.dtype, x.shape)
    if dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    check_cuda("mean", mean, torch.float32, (C,))
    check_cuda("rstd", rstd, torch.float32, (C,))
    KERNEL_BWD.launch(x, dy, mean, rstd, ws, out, plan, ticket)
    return ws[k], ws[k + 1], n
