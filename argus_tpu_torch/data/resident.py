"""Device-resident training data: the whole train split on the card, or
shards of it swapped in per epoch.

Port of `argus_tpu/data/resident.py` (`DeviceResidentData`,
`ResidentShardedData`) for one card. The split is decoded once (the native
libpng batch decoder when it builds) and uploaded through a pinned staging
buffer (an upload from pageable memory waits for the device); batches are
then gathered on the card by `train.make_resident_epoch_step`, whose step
the host replays as a CUDA graph, so the host ships an index row per step
instead of a batch of frames.

A split past the budget is cut into equal shards, each fitting half the
budget (the shard in use and the next one's upload coexist), with a smaller
tail. Each epoch walks the shards in an order drawn from numpy's
`default_rng((seed ^ 0x5A4D) + epoch)`, argus_tpu's order exactly; while a
shard trains, one worker thread decodes the next and uploads it on a side
CUDA stream, and the train stream waits on that upload's event before it
reads the shard. The shuffle is shard-local (shard order x order within a
shard), argus_tpu's relaxation of the global permutation.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from argus_tpu_torch import resolve_device


class DeviceResidentData:
    """The train split on `device`: images uint8 (N, H, W, 3 * n_cams),
    poses float32 (N, 7) xyzw."""

    def __init__(self, images: torch.Tensor, poses: torch.Tensor) -> None:
        self.images = images
        self.poses = poses
        self.n = int(images.shape[0])

    @staticmethod
    def bytes_estimate(dataset) -> int:
        """The split's footprint on the card: uint8 frames and f32 poses."""
        h, w = dataset._out_hw()
        per_example = h * w * 3 * dataset.n_cams + 7 * 4
        return len(dataset) * per_example

    @classmethod
    def fits(cls, dataset, budget_mb: float) -> bool:
        """True when the split fits the budget (MiB); a budget of 0 disables
        the resident path."""
        return budget_mb > 0 and cls.bytes_estimate(dataset) <= budget_mb * 2**20

    @classmethod
    def from_dataset(cls, dataset, device=None, n_threads: Optional[int] = None) -> "DeviceResidentData":
        """Decode the whole split and upload it once."""
        device = resolve_device(device)
        idxs = list(range(len(dataset)))
        images, poses, ready = _decode_upload(dataset, idxs, device, n_threads or (os.cpu_count() or 1))
        _hand_over(device, ready, images, poses)
        return cls(images, poses)


def _decode_upload(dataset, idxs, device: torch.device, n_threads: int, stream=None):
    """Decode `idxs` and copy them to `device` through pinned memory, on
    `stream` (the current stream when None). Returns (images, poses, the
    event after the copies, None on the CPU); the copies may still be in
    flight."""
    imgs = np.ascontiguousarray(dataset.load_images_batch(idxs, n_threads=n_threads))
    poses = np.ascontiguousarray(np.asarray(dataset.cube_poses[idxs], np.float32))
    if device.type != "cuda":
        return torch.from_numpy(imgs), torch.from_numpy(poses), None
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        # the pinned staging copies go back to torch's host cache once the
        # uploads that read them have run
        out = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in (imgs, poses)]
        ready = torch.cuda.Event()
        ready.record()
    return out[0], out[1], ready


def _hand_over(device: torch.device, ready, *tensors) -> None:
    """Order the current stream after the upload `ready` marks, and tie the
    uploaded tensors' memory to it."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


class ResidentShardedData:
    """A split past the budget as shards swapped onto the card per epoch:
    `shard_size` examples each (half the budget), the last `tail_size`."""

    def __init__(self, dataset, budget_mb: float, device=None, n_threads: Optional[int] = None,
                 seed: int = 0) -> None:
        per_example = DeviceResidentData.bytes_estimate(dataset) / max(1, len(dataset))
        self.shard_size = max(1, int(budget_mb * 2**20 / 2 / per_example))
        n = len(dataset)
        self.n = n
        self.n_shards = -(-n // self.shard_size)
        self.dataset = dataset
        self.device = resolve_device(device)
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.seed = seed
        self.index_shards = [np.arange(i, min(i + self.shard_size, n)) for i in range(0, n, self.shard_size)]
        self.tail_size = len(self.index_shards[-1])

    @classmethod
    def applicable(cls, dataset, budget_mb: float) -> bool:
        """True when a budget is set and the split does not fit it whole."""
        return budget_mb > 0 and not DeviceResidentData.fits(dataset, budget_mb)

    def epoch_shards(self, epoch: int):
        """Yield (images, poses, segment, shard length) for each shard in the
        epoch's order, on the device and ready for the current stream; the
        next shard is decoded and uploaded while the caller trains on this
        one. `segment` = epoch * n_shards + position is the epoch number to
        give the epoch step, so every shard draws its own permutation."""
        from concurrent.futures import ThreadPoolExecutor

        order = np.random.default_rng((self.seed ^ 0x5A4D) + epoch).permutation(self.n_shards)
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def load(k):
            idxs = self.index_shards[order[k]]
            return (*_decode_upload(self.dataset, list(idxs), self.device, self.n_threads, side), len(idxs))

        with ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(load, 0)
            for k in range(self.n_shards):
                imgs, poses, ready, n_k = nxt.result()
                _hand_over(self.device, ready, imgs, poses)
                if k + 1 < self.n_shards:
                    nxt = pool.submit(load, k + 1)
                yield imgs, poses, epoch * self.n_shards + k, n_k
