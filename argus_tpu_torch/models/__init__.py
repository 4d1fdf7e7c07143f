"""Model zoo of the port: ResNet backbones and both pose-estimator
families, the NCameraCNN pose regressor and the CubeKeypointNet corner
detector (with its triangulation and Procrustes pose fit).

`model_from_meta` rebuilds either family from the metadata a format-2
checkpoint carries, as `argus_tpu.models` does.
"""

from __future__ import annotations

import dataclasses

from argus_tpu_torch.models.keypoint_net import CubeKeypointNet, CubeKeypointNetConfig
from argus_tpu_torch.models.pose_cnn import NCameraCNN, NCameraCNNConfig
from argus_tpu_torch.models.resnet import ResNet, resnet18, resnet34, resnet50, resnet101


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
    raw = meta.get("model_config", {}) or {}
    if meta.get("model_type", "pose_cnn") == "keypoint":
        cfg = _coerce_config(CubeKeypointNetConfig, raw)
        return CubeKeypointNet(cfg), cfg, "keypoint"
    cfg = _coerce_config(NCameraCNNConfig, raw)
    return NCameraCNN(cfg), cfg, "pose_cnn"


def resolve_model(meta: dict, model_config=None):
    """(model, config, model_type), an explicit config overriding the meta;
    its type selects the family."""
    if model_config is not None:
        if isinstance(model_config, CubeKeypointNetConfig):
            return CubeKeypointNet(model_config), model_config, "keypoint"
        return NCameraCNN(model_config), model_config, "pose_cnn"
    return model_from_meta(meta)


__all__ = [
    "CubeKeypointNet",
    "CubeKeypointNetConfig",
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
