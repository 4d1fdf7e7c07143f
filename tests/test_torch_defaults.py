"""The port's configuration dataclasses against argus_tpu's: the same field
names in the same order and the same default values, nested defaults
(a `default_factory` that builds another config) compared field by field.

A configuration moves between the two packages unchanged (a checkpoint's
stored model config, a CLI flag, a `TrainConfig()` a user builds with no
arguments), so a default that drifts changes what the port trains. The
defaults are read from the dataclass fields, so argus_tpu's `TrainConfig`
is never constructed (its `__post_init__` makes `save_dir`).
`TrainState.shardings`, the port's record of the leaves cut over a model
group (tensor parallelism), has no argus_tpu counterpart and stays out.
"""

import dataclasses
import importlib

import pytest

# (module under both packages, dataclass name)
CONFIGS = [
    ("data.dataset", "CameraCubePoseDatasetConfig"),
    ("data.synthetic", "RenderStyle"),
    ("datagen", "GenerateDataConfig"),
    ("models.keypoint_net", "CubeKeypointNetConfig"),
    ("models.pose_cnn", "NCameraCNNConfig"),
    ("ops.augment", "AugmentationConfig"),
    ("train", "TrainConfig"),
    ("train", "TrainState"),
    ("validate", "ValConfig"),
    ("validate_real", "ValRealConfig"),
]
PORT_ONLY = {("train", "TrainState"): {"shardings"}}


def _defaults(cls, skip=frozenset()) -> dict:
    """{field: default} of a dataclass, a factory's product expanded when it
    is itself a dataclass; a field without a default maps to MISSING."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in skip:
            continue
        if f.default is not dataclasses.MISSING:
            value = f.default
        elif f.default_factory is not dataclasses.MISSING:
            value = f.default_factory()
        else:
            value = dataclasses.MISSING
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = (type(value).__name__, _defaults(type(value)))
        out[f.name] = value
    return out


@pytest.mark.parametrize("module,name", CONFIGS, ids=[f"{m}.{n}" for m, n in CONFIGS])
def test_config_defaults_match_argus_tpu(module, name):
    theirs = getattr(importlib.import_module(f"argus_tpu.{module}"), name)
    ours = getattr(importlib.import_module(f"argus_tpu_torch.{module}"), name)
    assert dataclasses.is_dataclass(theirs) and dataclasses.is_dataclass(ours)
    skip = PORT_ONLY.get((module, name), frozenset())
    want, got = _defaults(theirs), _defaults(ours, skip)
    assert list(got) == list(want)
    differ = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not differ, differ
