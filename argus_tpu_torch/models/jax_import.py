"""Weight bridge between argus_tpu variable trees and the port's state_dict.

The counterpart of `argus_tpu/models/torch_import.py`. The port's modules
carry flax's scope names, so a flax leaf path maps to a state_dict key by
joining the path with dots and renaming the leaf:

    params/.../kernel  (H, W, I, O)  -> ....weight  (O, I, H, W)
    params/.../kernel  (I, O)        -> ....weight  (O, I)        Dense
    params/.../bias                  -> ....bias
    params/.../scale                 -> ....weight                BatchNorm
    batch_stats/.../mean             -> ....running_mean
    batch_stats/.../var              -> ....running_var

`state_dict_from_variables` takes the numpy nested dicts that
`checkpoint.load_checkpoint_with_meta` returns; `variables_from_state_dict`
is its exact inverse.

The optimizer state crosses the same way: optax's `ScaleByAdamState`
(`count`, and `mu`/`nu` trees shaped like the params) maps onto the port's
Adam moments keyed by parameter name (`adam_moments_from_optax`), and back
(`optax_moments_from_adam`).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_STAT_LEAVES = {v: k for k, v in _STAT_NAMES.items()}


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.clone()
    return torch.from_numpy(np.array(v))


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _param_entry(path: Tuple[str, ...], v) -> Tuple[str, torch.Tensor]:
    t = _tensor(v)
    leaf = path[-1]
    if leaf == "kernel":
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        elif t.ndim == 2:
            t = t.t()
        else:
            raise ValueError(f"kernel {'/'.join(path)} has unsupported rank {t.ndim}")
        name = "weight"
    elif leaf == "scale":
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    else:
        raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
    return ".".join(path[:-1] + (name,)), t.contiguous()


def state_dict_from_variables(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    reference: Optional[Dict[str, torch.Tensor]] = None,
) -> "OrderedDict[str, torch.Tensor]":
    """argus_tpu (params, batch_stats) -> the port's state_dict. With a
    `reference` state_dict, a converted key it lacks raises KeyError and a
    shape that differs raises ValueError, so architecture drift is loud."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, v in _flatten(params):
        key, t = _param_entry(path, v)
        sd[key] = t
    for path, v in _flatten(batch_stats or {}):
        if path[-1] not in _STAT_NAMES:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (_STAT_NAMES[path[-1]],))] = _tensor(v)
    if reference is not None:
        for key, t in sd.items():
            if key not in reference:
                raise KeyError(f"imported weight {key} has no destination in the model")
            if tuple(reference[key].shape) != tuple(t.shape):
                raise ValueError(
                    f"shape mismatch at {key}: model {tuple(reference[key].shape)} vs "
                    f"checkpoint {tuple(t.shape)}"
                )
    return sd


def _put(tree: Dict[str, Any], path, leaf) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = leaf


def _array(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def variables_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's state_dict -> argus_tpu (params, batch_stats) nested dicts
    of numpy arrays (bfloat16 leaves stay torch tensors)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in sd.items():
        *scope, name = key.split(".")
        if name in _STAT_LEAVES:
            _put(stats, scope + [_STAT_LEAVES[name]], _array(t))
        elif name == "bias":
            _put(params, scope + ["bias"], _array(t))
        elif name == "weight":
            if t.ndim == 4:
                _put(params, scope + ["kernel"], _array(t.permute(2, 3, 1, 0)))
            elif t.ndim == 2:
                _put(params, scope + ["kernel"], _array(t.t()))
            elif t.ndim == 1:
                _put(params, scope + ["scale"], _array(t))
            else:
                raise ValueError(f"weight {key} has unsupported rank {t.ndim}")
        else:
            raise KeyError(f"state_dict key {key} has no argus_tpu counterpart")
    return params, stats


def adam_moments_from_optax(count, mu: Dict[str, Any], nu: Dict[str, Any]):
    """optax `ScaleByAdamState` leaves (count, mu tree, nu tree) -> (count as
    an int32 tensor, mu, nu keyed by the port's parameter names), through the
    params key map (kernels transposed like the weights they track)."""
    mu_sd = OrderedDict(_param_entry(path, v) for path, v in _flatten(mu))
    nu_sd = OrderedDict(_param_entry(path, v) for path, v in _flatten(nu))
    if list(mu_sd) != list(nu_sd):
        raise ValueError("optax mu and nu trees differ in structure")
    return torch.tensor(int(np.asarray(count)), dtype=torch.int32), mu_sd, nu_sd


def optax_moments_from_adam(count, mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor]):
    """The inverse of `adam_moments_from_optax`: (count as a numpy int32
    scalar, mu tree, nu tree) for optax's `ScaleByAdamState`."""
    mu_tree, _ = variables_from_state_dict(mu)
    nu_tree, _ = variables_from_state_dict(nu)
    return np.asarray(int(count), np.int32), mu_tree, nu_tree
