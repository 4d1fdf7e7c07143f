"""Whole-stage forward chain on folded frozen-BN weights (NHWC): an optional
projection block, then identity blocks.

Port of `argus_tpu/ops/pallas/stage_fused.py` `fused_stage` (no-save
forward; the TPU runs stage 0 through `_chain_fwd_packed`). The chain is
the composition of the projection and identity block forwards, with the same
rounding points; the TPU's chain cap and pair-packed layout are Mosaic
constraints and are not ported.

On a CUDA tensor `fused_stage` launches `csrc/stage_fused.cu`, which runs the
whole chain from one C call; on a CPU tensor it runs the plain version
`stage_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from argus_tpu_torch.ops.kernels._build import I, P, Kernel
from argus_tpu_torch.ops.kernels.block_fused import (
    bottleneck_block_plain,
    check_channels,
    check_cuda,
    check_device,
)
from argus_tpu_torch.ops.kernels.proj_fused import projection_block_plain

KERNEL = Kernel("stage_fused", "argus_stage_fwd", [P] * 8 + [I] * 8 + [P])


def stage_plain(x, proj_folded, id_folded, stride):
    """The chain in plain PyTorch."""
    cur = x
    if proj_folded is not None:
        cur = projection_block_plain(cur, *proj_folded, stride)
    for idw in id_folded:
        cur = bottleneck_block_plain(cur, *idw)
    return cur


def _check_weights(ws, shapes) -> None:
    for i, (t, shape) in enumerate(zip(ws, shapes)):
        dtype = torch.bfloat16 if i % 2 == 0 else torch.float32
        check_cuda(f"weight {i}", t, dtype, shape)


def fused_stage(
    x: torch.Tensor,
    proj_folded: Optional[Sequence[torch.Tensor]],
    id_folded: Sequence[Sequence[torch.Tensor]],
    stride: int = 2,
) -> torch.Tensor:
    """Run a stage: `proj_folded` (w1, b1, w2, b2, w3, b3, wsc, bsc) or None,
    then each identity block of `id_folded` (w1, b1, w2, b2, w3, b3)."""
    ids = [tuple(w) for w in id_folded]
    if proj_folded is None and not ids:
        raise ValueError("a stage needs at least one block")
    if not check_device(x):
        return stage_plain(x, proj_folded, ids, stride)
    n, h, w, cin = x.shape
    s = stride if proj_folded is not None else 1
    if s not in (1, 2) or h % s or w % s:
        raise ValueError(f"stride {stride} does not fit spatial size {(h, w)}")
    f = (proj_folded[0] if proj_folded is not None else ids[0][0]).shape[1]
    cout = proj_folded[4].shape[1] if proj_folded is not None else cin
    check_channels(CIN=cin, F=f, COUT=cout)
    check_cuda("x", x, torch.bfloat16)
    if proj_folded is not None:
        _check_weights(
            proj_folded,
            [(cin, f), (1, f), (3, 3, f, f), (1, f), (f, cout), (1, cout), (cin, cout), (1, cout)],
        )
    for idw in ids:
        _check_weights(idw, [(cout, f), (1, f), (3, 3, f, f), (1, f), (f, cout), (1, cout)])

    ho, wo = h // s, w // s
    bf, dev = torch.bfloat16, x.device
    h1 = torch.empty((n, h, w, f), dtype=bf, device=dev)
    h2 = torch.empty((n, ho, wo, f), dtype=bf, device=dev)
    n_tmp = len(ids) if proj_folded is not None else len(ids) - 1
    tmp = [torch.empty((n, ho, wo, cout), dtype=bf, device=dev) for _ in range(min(n_tmp, 2))]
    tmp += [h2] * (2 - len(tmp))  # unused slots: any valid pointer
    out = torch.empty((n, ho, wo, cout), dtype=bf, device=dev)

    # host arrays of weight pointers, alive until the launcher returns
    proj_arr = None
    if proj_folded is not None:
        proj_arr = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in proj_folded])
    id_ptrs = [t.data_ptr() for idw in ids for t in idw]
    id_arr = (ctypes.c_void_p * max(len(id_ptrs), 1))(*id_ptrs)
    KERNEL.launch(
        x, out, h1, h2, tmp[0], tmp[1],
        ctypes.addressof(proj_arr) if proj_arr is not None else None,
        ctypes.addressof(id_arr), len(ids), n, h, w, cin, f, cout, s,
    )
    return out
