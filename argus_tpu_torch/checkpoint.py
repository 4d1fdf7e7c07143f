"""argus_tpu checkpoint files (format 2), read and written without flax, and
the train state's codec.

A format-2 file is one msgpack map ``{"format": 2, "meta": {...}, "state":
{...}}``: `meta` carries the model family, its config and the training crop,
`state` the nested train state. Legacy files hold the bare state. Array
leaves use flax's ndarray encoding (`_msgpack`), so files written here load
in `argus_tpu.checkpoint` and the other way round.

The port's `train.TrainState` crosses as argus_tpu's: `step` an int32
scalar, `params` and `batch_stats` through the weight bridge
(`models.jax_import`), `opt_state` the optax chain's state as flax
serialises the tuple `(clip's EmptyState, ScaleByAdamState(count, mu,
nu))`, i.e. ``{"0": {}, "1": {"count", "mu", "nu"}}``, and `lr` an f32
scalar (`train_state_tree`). `load_checkpoint(path, target)` fills a
`TrainState` in place and raises on a missing or extra key or a shape
that differs. `AsyncCheckpointer` snapshots the state on the card, because
the train step updates it in place, and writes from a worker thread.

Loaded raw trees hold numpy arrays (read-only views of the file bytes),
except bfloat16 ones, which come back as torch bfloat16 tensors.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from argus_tpu_torch import _msgpack
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    optax_moments_from_adam,
    state_dict_from_variables,
    variables_from_state_dict,
)


def _plain(obj: Any) -> Any:
    """Tuples become lists, as `argus_tpu.checkpoint._plain` stores them."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _is_train_state(obj: Any) -> bool:
    return all(hasattr(obj, k) for k in ("step", "params", "batch_stats", "opt_state", "lr"))


def train_state_tree(state) -> dict:
    """A `TrainState` as argus_tpu's format-2 state tree (host numpy arrays).
    A state with sharded leaves raises: gather it first
    (`parallel.tp.whole_state`), since files hold whole tensors."""
    if getattr(state, "shardings", None):
        raise ValueError("a tensor-parallel state holds slices; write parallel.tp.whole_state(state, mesh)")
    params, _ = variables_from_state_dict(state.params)
    _, stats = variables_from_state_dict(state.batch_stats)
    opt = state.opt_state
    count, mu, nu = optax_moments_from_adam(opt.count, opt.mu, opt.nu)
    return {
        "step": np.asarray(int(state.step), np.int32),
        "params": params,
        "batch_stats": stats,
        "opt_state": {"0": {}, "1": {"count": count, "mu": mu, "nu": nu}},
        "lr": np.asarray(state.lr.detach().cpu().numpy(), np.float32),
    }


def _keys_match(what: str, got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"checkpoint {what}: missing {missing[:5]}, extra {extra[:5]}")


@torch.no_grad()
def _copy_into(what: str, dst: dict, src: dict) -> None:
    _keys_match(what, src, dst)
    for k, t in dst.items():
        v = torch.as_tensor(src[k])
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {what} {k}: shape {tuple(v.shape)}, the state's {tuple(t.shape)}")
        t.copy_(v)


def restore_train_state(tree: dict, state):
    """Fill `state` (a `TrainState`) in place from an argus_tpu state tree;
    raises on a missing or extra key or a shape that differs. The whole
    tensors of the file are cut to the state's `shardings` (tensor
    parallelism) first. Returns `state`."""
    _keys_match("state", tree, ("step", "params", "batch_stats", "opt_state", "lr"))
    opt = tree["opt_state"]
    _keys_match("opt_state", opt, ("0", "1"))
    _keys_match("opt_state Adam state", opt["1"], ("count", "mu", "nu"))
    cuts = getattr(state, "shardings", None) or {}
    cut = lambda d: {k: cuts[k].take(torch.as_tensor(v)) if k in cuts else v for k, v in d.items()}  # noqa: E731
    reference = {**state.params, **state.batch_stats}
    sd = state_dict_from_variables(tree["params"], tree["batch_stats"], None if cuts else reference)
    _copy_into("params and batch_stats", reference, cut(sd))
    count, mu, nu = adam_moments_from_optax(opt["1"]["count"], opt["1"]["mu"], opt["1"]["nu"])
    _copy_into("Adam mu", state.opt_state.mu, cut(mu))
    _copy_into("Adam nu", state.opt_state.nu, cut(nu))
    with torch.no_grad():
        state.opt_state.count.copy_(count)
        state.lr.copy_(torch.tensor(float(np.asarray(tree["lr"])), dtype=torch.float32))
    state.step = int(np.asarray(tree["step"]))
    return state


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> str:
    """Write `tree` (a `TrainState`, or nested dicts of numpy arrays, torch
    tensors and scalars) with `meta` as a format-2 checkpoint, atomically
    (tmp file + rename)."""
    if _is_train_state(tree):
        tree = train_state_tree(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"format": 2, "meta": _plain(meta or {}), "state": tree}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _msgpack.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_checkpoint_with_meta(path: str, target: Any = None) -> tuple:
    """(state, meta) from a checkpoint; meta is {} for legacy bare-state
    files. With a `TrainState` `target`, the state is restored into it in
    place (`restore_train_state`) and returned; without, the raw tree."""
    with open(path, "rb") as f:
        raw = _msgpack.restore(f.read())
    if isinstance(raw, dict) and raw.get("format") == 2:
        state, meta = raw["state"], raw.get("meta") or {}
    else:
        state, meta = raw, {}
    if target is not None:
        state = restore_train_state(state, target)
    return state, meta


def load_checkpoint(path: str, target: Any = None) -> Any:
    """A checkpoint's state: restored into `target` (a `TrainState`) in
    place, or the raw tree without one."""
    return load_checkpoint_with_meta(path, target)[0]


def find_latest_checkpoint(save_dir: str) -> Optional[str]:
    """The most recently written .ckpt under `save_dir`, or None: point
    `TrainConfig.resume_from` at it after a preemption or a crash."""
    candidates = glob.glob(os.path.join(save_dir, "*.ckpt"))
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


class _Snapshot:
    """A copy of a `TrainState`'s tensors, taken on the card."""

    def __init__(self, state) -> None:
        from argus_tpu_torch.train import AdamState

        clone = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
        opt = state.opt_state
        self.step = int(state.step)
        self.params, self.batch_stats = clone(state.params), clone(state.batch_stats)
        self.opt_state = AdamState(opt.count.clone(), clone(opt.mu), clone(opt.nu))
        self.lr = state.lr.detach().clone()


class AsyncCheckpointer:
    """Checkpoint writes that overlap training, argus_tpu's `AsyncCheckpointer`.

    The port's train step updates the parameters and Adam moments in place,
    so `save` first snapshots every tensor of the state with a copy on the
    card, enqueued on the current stream behind the steps already queued
    (argus_tpu snapshots against buffer donation the same way). A worker
    thread waits for those copies, fetches the snapshot to the host,
    serialises and writes it, while the loop goes on. One save in flight at
    a time: a new `save` waits for the previous one. A worker's exception is
    raised by the next `save` or `wait`; call `wait()` after the last save."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def save(self, path: str, tree: Any, meta: Optional[dict] = None) -> str:
        self.wait()
        ready = None
        if _is_train_state(tree):
            tree = _Snapshot(tree)
            if tree.lr.is_cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(tree.lr.device))

        def work():
            try:
                if ready is not None:
                    ready.synchronize()
                save_checkpoint(path, tree, meta=meta)
            except BaseException as e:  # raised by the next save() or wait()
                self._err = e

        self._thread = threading.Thread(target=work, name="argus-ckpt", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
