"""Model zoo of the port: ResNet backbones and the NCameraCNN pose regressor.

`model_from_meta` rebuilds the model from the metadata a format-2 checkpoint
carries, as `argus_tpu.models` does. The keypoint family is not ported yet.
"""

from __future__ import annotations

import dataclasses

from argus_tpu_torch.models.pose_cnn import NCameraCNN, NCameraCNNConfig
from argus_tpu_torch.models.resnet import ResNet, resnet18, resnet34, resnet50, resnet101

_KEYPOINT_TODO = (
    "the keypoint model family (CubeKeypointNet) is not ported yet: ROADMAP queue A "
    "(keypoint family)"
)


def _coerce_config(cls, raw: dict):
    """Build a config dataclass from a msgpack-round-tripped dict: lists back
    to tuples, bytes to str, unknown keys dropped."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in raw:
            continue
        v = raw[f.name]
        if isinstance(v, bytes):
            v = v.decode("utf-8")
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def model_from_meta(meta: dict):
    """(model, config, model_type) from checkpoint metadata; an empty meta
    (legacy checkpoint) means the default NCameraCNN."""
    meta = meta or {}
    model_type = meta.get("model_type", "pose_cnn")
    if model_type == "keypoint":
        raise NotImplementedError(_KEYPOINT_TODO)
    cfg = _coerce_config(NCameraCNNConfig, meta.get("model_config", {}) or {})
    return NCameraCNN(cfg), cfg, "pose_cnn"


def resolve_model(meta: dict, model_config=None):
    """(model, config, model_type), an explicit config overriding the meta."""
    if model_config is not None:
        if not isinstance(model_config, NCameraCNNConfig):
            raise NotImplementedError(_KEYPOINT_TODO)
        return NCameraCNN(model_config), model_config, "pose_cnn"
    return model_from_meta(meta)


__all__ = [
    "NCameraCNN",
    "NCameraCNNConfig",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "model_from_meta",
    "resolve_model",
]
