"""HDF5 + PNG cube-pose dataset and the host input feed.

Port of `argus_tpu/data/dataset.py`. The HDF5 schema is argus_tpu's (train
and test groups with `cube_poses` in wxyz, `q_leap`, `img_stems`); poses
are converted to xyzw once at load. PNGs are decoded on the host, by the
port's native libpng loader (`argus_tpu_torch.native`) when it builds, else
by cv2 on a thread pool, centre-cropped, and batched as uint8: the
conversion to float and the augmentation run on the card in the train step.
`HostDataLoader` yields argus_tpu's batches: the same per-epoch permutation,
host shards, padding and masks. `h5py` and cv2 are imported when a dataset
is opened or a PNG decoded, not with this module.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from argus_tpu_torch import ROOT
from argus_tpu_torch.geom import xyzwxyz_to_xyzxyzw_SE3


def resolve_path(path: str) -> str:
    """`path` as given (absolute or relative to the working directory), else
    relative to the repository root."""
    if os.path.exists(path):
        return path
    if os.path.exists(os.path.join(ROOT, path)):
        return os.path.join(ROOT, path)
    raise FileNotFoundError(f"The specified path does not exist: {path}!")


@dataclass(frozen=False)
class CameraCubePoseDatasetConfig:
    """argus_tpu's dataset config, the same fields and checks.

    Fields:
        dataset_path: directory containing `<stem>.hdf5` and an `img/` directory.
        center_crop: (height, width) of the centre crop, or None to disable.
    """

    dataset_path: Optional[str] = None
    center_crop: Optional[tuple] = (256, 256)

    def __post_init__(self) -> None:
        assert isinstance(self.dataset_path, str), "The dataset path must be a str!"
        self.dataset_path = resolve_path(self.dataset_path)
        p = Path(self.dataset_path)
        assert not p.suffix, "The dataset path must point to a directory!"
        if p.is_dir():
            assert (p / f"{p.stem}.hdf5").exists(), f"There must be an hdf5 file named {p.stem}.hdf5!"
            assert (p / "img").exists(), "The dataset must have an `img` directory!"


def _decode_png(path: str) -> np.ndarray:
    """One PNG as RGB uint8 (H, W, 3) through cv2 (its libpng path releases
    the GIL)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"Failed to decode image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _center_crop_np(img: np.ndarray, crop_hw: tuple) -> np.ndarray:
    """Centre crop of (H, W, C) uint8 with a numpy slice (`ops.image.center_crop`'s pixels)."""
    h, w = img.shape[:2]
    ch, cw = crop_hw
    top = (h - ch) // 2
    left = (w - cw) // 2
    return img[top:top + ch, left:left + cw]


class CameraCubePoseDataset:
    """The dataset for N cameras and a cube. `__getitem__` returns host data:
    {"images": uint8 (H, W, 3 * n_cams), the cameras concatenated along
    channels, "cube_pose": float32 (7,) with an xyzw quaternion}."""

    def __init__(self, cfg_dataset: CameraCubePoseDatasetConfig, cfg_aug=None, train: bool = True) -> None:
        import h5py

        self.dataset_path = cfg_dataset.dataset_path
        self.center_crop = cfg_dataset.center_crop
        self.cfg_aug = cfg_aug  # accepted as argus_tpu does; augmentation runs on the card
        self.train = train

        stem = Path(self.dataset_path).stem
        with h5py.File(f"{self.dataset_path}/{stem}.hdf5", "r") as f:
            group = f["train" if train else "test"]
            self.n_cams = int(f.attrs["n_cams"])
            poses_wxyz = np.asarray(group["cube_poses"][()], dtype=np.float32)
            self.cube_poses = xyzwxyz_to_xyzxyzw_SE3(poses_wxyz)  # (N, 7) xyzw
            self.q_leap = np.asarray(group["q_leap"][()], dtype=np.float32)
            self.img_stems = [s.decode("utf-8") for s in group["img_stems"][()]]

    def __len__(self) -> int:
        return self.cube_poses.shape[0]

    def image_paths(self, idx: int) -> list:
        stem = self.img_stems[idx]
        return [f"{self.dataset_path}/{stem}_{suffix}.png" for suffix in ("a", "b")[: self.n_cams]]

    def load_images(self, idx: int) -> np.ndarray:
        """Decode and crop one example's camera images -> uint8 (H, W, 3 * n_cams)."""
        imgs = [_decode_png(p) for p in self.image_paths(idx)]
        h, w = imgs[0].shape[:2]
        if self.center_crop and (h, w) != tuple(self.center_crop):
            ch, cw = self.center_crop
            if h >= ch and w >= cw:  # never "crop" smaller images up
                imgs = [_center_crop_np(im, self.center_crop) for im in imgs]
        return np.concatenate(imgs, axis=-1)

    def _raw_size(self) -> tuple:
        if not hasattr(self, "_raw_hw"):
            self._raw_hw = _decode_png(self.image_paths(0)[0]).shape[:2]
        return self._raw_hw

    def _out_hw(self) -> tuple:
        """(H, W) after cropping: the crop when the raw images are at least
        that large, else the raw size."""
        if self.center_crop:
            raw_h, raw_w = self._raw_size()
            ch, cw = self.center_crop
            if raw_h >= ch and raw_w >= cw:
                return (ch, cw)
            return (raw_h, raw_w)
        return self._raw_size()

    def load_images_batch(self, idxs, n_threads: int = 8, pool=None) -> np.ndarray:
        """Decode a batch -> uint8 (len(idxs), H, W, 3 * n_cams): one call of
        the native decoder (its own thread pool) when it built, else cv2 per
        image on `pool`."""
        from argus_tpu_torch import native

        idxs = list(idxs)
        if native.available():
            paths = [p for i in idxs for p in self.image_paths(i)]
            ch, cw = self._out_hw()
            flat = native.decode_batch(paths, (ch, cw), n_threads=n_threads)
            per_cam = flat.reshape(len(idxs), self.n_cams, ch, cw, 3)
            return np.concatenate([per_cam[:, c] for c in range(self.n_cams)], axis=-1)
        mapper = pool.map if pool is not None else map
        return np.stack(list(mapper(self.load_images, idxs)))

    def __getitem__(self, idx: int) -> dict:
        return {"images": self.load_images(idx), "cube_pose": self.cube_poses[idx]}


class HostDataLoader:
    """Deterministic, sharded, prefetching batch feed: argus_tpu's
    `HostDataLoader`.

    Yields dicts of host numpy arrays of one shape:
        images:    uint8   (B, H, W, 3 * n_cams)
        cube_pose: float32 (B, 7) xyzw
        mask:      float32 (B,)   1 for real examples, 0 for padding

    Each epoch draws `np.random.default_rng([seed, epoch]).permutation(n)`
    (or takes 0..n-1 without `shuffle`), wrap-pads it with `np.resize` to a
    multiple of `process_count`, and takes every `process_count`-th index
    from `process_index`. The last batch is padded by repeating its first
    row, with mask 0. A producer thread decodes `prefetch` batches ahead; an
    error there is raised in the consumer. `dataset` is anything with
    `__len__`, `cube_poses` and `load_images_batch(idxs, n_threads, pool)`.

    `rows`, a slice of the `batch_size` rows, is one rank's share of its
    node's batch (`parallel.Mesh.node_rows`): the loader then yields those
    rows only and decodes only them (and the batch's first row where its
    padding repeats it).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 process_index: int = 0, process_count: int = 1, prefetch: int = 2,
                 rows: Optional[slice] = None) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.rows = slice(0, batch_size) if rows is None else rows
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch."""
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng([self.seed, self.epoch]).permutation(n)
        else:
            order = np.arange(n)
        per_host = -(-n // self.process_count)
        padded = np.resize(order, per_host * self.process_count)
        return padded[self.process_index::self.process_count]

    def __len__(self) -> int:
        per_host = -(-len(self.dataset) // self.process_count)
        return -(-per_host // self.batch_size)

    def _make_batch(self, idxs: np.ndarray) -> dict:
        a, b = self.rows.start, self.rows.stop
        mine = idxs[a:b]  # this rank's real rows; the rest of its share repeats the batch's first row
        n_real = len(mine)
        pad = (b - a) - n_real
        load = mine.tolist() + ([int(idxs[0])] if pad > 0 and (a > 0 or n_real == 0) else [])
        images = self.dataset.load_images_batch(load, n_threads=self.num_workers, pool=self._pool)
        poses = self.dataset.cube_poses[np.asarray(load, np.int64)]
        if pad > 0:
            first = slice(len(load) - 1, len(load)) if len(load) > n_real else slice(0, 1)
            images = np.concatenate([images[:n_real], np.repeat(images[first], pad, axis=0)], axis=0)
            poses = np.concatenate([poses[:n_real], np.repeat(poses[first], pad, axis=0)], axis=0)
        mask = np.zeros((b - a,), np.float32)
        mask[:n_real] = 1.0
        return {
            "images": np.ascontiguousarray(images, dtype=np.uint8),
            "cube_pose": poses.astype(np.float32),
            "mask": mask,
        }

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        batches = [indices[i:i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []  # a producer error must end the epoch loudly, not truncate it

        def producer():
            try:
                for b in batches:
                    q.put(self._make_batch(b))
            except BaseException as e:  # noqa: BLE001 - raised in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise RuntimeError("HostDataLoader producer thread failed") from error[0]
