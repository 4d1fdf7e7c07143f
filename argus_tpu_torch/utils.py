"""Host-side utilities: timing, the images -> pose helper, the directory-tree
printer of config errors, and the host spaghetti drawer.

Port of `argus_tpu/utils.py`:
  * `time_fn` (argus_tpu's `time_jax_fn`): wall clock of a thunk, taken
    after the device of its result has finished.
  * `get_pose`: `se3_exp(model(images))`.
  * `get_tree_string`: the coloured tree of files with an extension under a
    directory, the same string as argus_tpu's.
  * `draw_spaghetti`: black arcs drawn on a PIL image with a numpy
    Generator, the host version kept for data-generation checks (the train
    step draws its arcs on the card, `ops.augment`).
"""

from __future__ import annotations

import fnmatch
import os
import time
from typing import Callable, Tuple

import numpy as np
import torch


def _synchronize(result) -> None:
    """Wait for the CUDA devices of the tensors in `result` (a tensor or a
    tuple, list or dict of them); nothing to wait for on the CPU."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


def time_fn(fn: Callable[[], object], warmup: int = 0) -> Tuple[object, float]:
    """(result, seconds) of `fn()` by the host's clock, the result's device
    synchronised before the clock is read; `warmup` untimed calls first."""
    for _ in range(warmup):
        _synchronize(fn())
    start = time.perf_counter()
    result = fn()
    _synchronize(result)
    return result, time.perf_counter() - start


def get_pose(images: torch.Tensor, apply_fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Images -> SE(3) poses (xyzw): `se3_exp(apply_fn(images))`, with
    `apply_fn` mapping (B, H, W, 3 * n_cams) images to (B, 6) se(3) vectors."""
    from argus_tpu_torch.geom import se3_exp

    return se3_exp(apply_fn(images))


# ───────────────────────────── directory tree printing ─────────────────────────────


def _tree_lines(path: str, extension: str, indent: str = "") -> list[str]:
    lines: list[str] = []
    try:
        items = sorted(os.listdir(path))
    except OSError:
        return lines
    items = [it for it in items if os.path.isdir(os.path.join(path, it)) or fnmatch.fnmatch(it, f"*.{extension}")]
    for i, item in enumerate(items):
        last = i == len(items) - 1
        lines.append(indent + ("└── " if last else "├── ") + item)
        full = os.path.join(path, item)
        if os.path.isdir(full):
            lines.extend(_tree_lines(full, extension, indent + ("    " if last else "│   ")))
    return lines


def get_tree_string(path: str, extension: str) -> str:
    """ANSI-blue tree of the files matching `*.extension` under `path`, for
    config-error messages."""
    BLUE, RESET = "\033[94m", "\033[0m"
    return BLUE + path + "\n" + "\n".join(_tree_lines(path, extension)) + "\n" + RESET


# ───────────────────────────── host-side spaghetti (PIL) ─────────────────────────────


def draw_spaghetti(img, n_arcs: int = 10, width_range=(1.0, 5.0), rng: np.random.Generator | None = None):
    """Draw `n_arcs` random black arcs on a PIL image in place (wires
    occluding the cube) and return it; `rng` a numpy Generator for
    determinism."""
    from PIL import ImageDraw

    rng = rng or np.random.default_rng()
    d = ImageDraw.Draw(img)
    for _ in range(n_arcs):
        x0, y0 = int(rng.integers(0, img.width)), int(rng.integers(0, img.height))
        x1, y1 = int(rng.integers(x0, img.width)), int(rng.integers(y0, img.height))
        start_angle, end_angle = int(rng.integers(0, 360)), int(rng.integers(0, 360))
        width = float(rng.uniform(*width_range))
        d.arc((x0, y0, x1, y1), start_angle, end_angle, fill=(0, 0, 0), width=int(width))
    return img
