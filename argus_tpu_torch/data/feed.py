"""The device feed: host batches to the card, `depth` batches ahead.

Port of `argus_tpu/parallel/mesh.py` `device_prefetch` for one card. Each
host batch (a dict of numpy arrays) is copied into pinned host buffers
(`depth + 1` sets, reused in turn) and from there to the card with
`non_blocking=True` on a side stream, while the train step runs on the
current stream. An event recorded after each batch's copies is what the
current stream waits on before the batch is used, and what the feed waits
on before it refills that batch's pinned buffers, so no copy reads a
buffer that is being overwritten; `record_stream` marks each device tensor
as used by the current stream, so the caching allocator does not hand its
memory to a later batch while the step still reads it. On the CPU the feed
passes the batches through as tensors.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from argus_tpu_torch import resolve_device


def device_prefetch(batches: Iterable[dict], device=None, depth: int = 2) -> Iterator[dict]:
    """Yield each host batch of `batches` as a dict of tensors on `device`
    (CUDA unless the caller names the CPU), with the copies of the next
    `depth - 1` batches in flight behind it."""
    device = resolve_device(device)
    if device.type != "cuda":
        for b in batches:
            yield {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
        return
    side = torch.cuda.Stream(device)
    staging = [{} for _ in range(depth + 1)]  # pinned buffers, one set per batch in flight
    copied = [None] * len(staging)  # the event after the copies that last read each set
    buf: deque = deque()
    for i, b in enumerate(batches):
        j = i % len(staging)
        if copied[j] is not None:
            copied[j].synchronize()
        pinned = staging[j]
        for k, v in b.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            if k not in pinned or pinned[k].shape != src.shape or pinned[k].dtype != src.dtype:
                pinned[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            pinned[k].copy_(src)
        with torch.cuda.stream(side):
            on_card = {k: pinned[k].to(device, non_blocking=True) for k in b}
            copied[j] = torch.cuda.Event()
            copied[j].record(side)
        buf.append((on_card, copied[j]))
        if len(buf) >= depth:
            yield _hand_over(*buf.popleft(), device)
    while buf:
        yield _hand_over(*buf.popleft(), device)


def _hand_over(on_card: dict, ready: torch.cuda.Event, device) -> dict:
    """The batch for the current stream: wait for its copies, and tie each
    tensor's memory to the current stream."""
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ready)
    for t in on_card.values():
        t.record_stream(stream)
    return on_card
