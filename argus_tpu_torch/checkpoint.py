"""argus_tpu checkpoint files (format 2), read and written without flax.

A format-2 file is one msgpack map ``{"format": 2, "meta": {...}, "state":
{...}}``: `meta` carries the model family, its config and the training crop,
`state` the nested train state (params, batch_stats, opt_state, step, lr).
Legacy files hold the bare state. Array leaves use flax's ndarray encoding
(`_msgpack`), so files written here load in `argus_tpu.checkpoint` and the
other way round.

Loaded arrays are numpy arrays (read-only views of the file bytes), except
bfloat16 ones, which come back as torch bfloat16 tensors.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from argus_tpu_torch import _msgpack


def _plain(obj: Any) -> Any:
    """Tuples become lists, as `argus_tpu.checkpoint._plain` stores them."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> str:
    """Write `tree` (nested dicts of numpy arrays, torch tensors and scalars)
    with `meta` as a format-2 checkpoint, atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"format": 2, "meta": _plain(meta or {}), "state": tree}
    data = _msgpack.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def load_checkpoint_with_meta(path: str) -> tuple:
    """(state, meta) from a checkpoint; meta is {} for legacy bare-state files."""
    with open(path, "rb") as f:
        raw = _msgpack.restore(f.read())
    if isinstance(raw, dict) and raw.get("format") == 2:
        return raw["state"], raw.get("meta") or {}
    return raw, {}

