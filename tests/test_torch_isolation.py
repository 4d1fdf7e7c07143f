"""The port stands alone: it imports without jax, flax, msgpack or
argus_tpu, and its entry points refuse to fall back to the CPU when no card
is present."""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "argus_tpu")

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    # forget anything a site hook imported at start-up, then refuse it
    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import argus_tpu_torch
    names = ["argus_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(argus_tpu_torch.__path__, "argus_tpu_torch.")
    ]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("imported", len(names), "modules")
    """
)


def test_port_imports_without_jax_or_argus_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split()[-2])
    assert n >= 15, proc.stdout


# the modules of the training loop, each imported alone under the same block
LOOP_MODULES = (
    "argus_tpu_torch.checkpoint", "argus_tpu_torch.configs", "argus_tpu_torch.data",
    "argus_tpu_torch.data.dataset", "argus_tpu_torch.data.feed", "argus_tpu_torch.data.resident",
    "argus_tpu_torch.data.synthetic",
    "argus_tpu_torch.logging_utils", "argus_tpu_torch.native", "argus_tpu_torch.preemption",
    "argus_tpu_torch.train",
)


def test_loop_modules_import_without_jax():
    """Each module of the loop is among those the package walk imports under
    the block (its first import, before any other module of the port)."""
    code = _BLOCKED_IMPORT.replace(
        "import argus_tpu_torch\n",
        f"import {LOOP_MODULES[-1]}\nimport argus_tpu_torch\n", 1,
    ).replace('print("imported"', f'assert set({LOOP_MODULES!r}) <= set(names), names\nprint("imported"')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert int(proc.stdout.split()[-2]) >= 30, proc.stdout


# the modules of the pointwise, remat and Hopper-backward slices: each imported first, alone,
# under the same block
SLICE_MODULES = ("argus_tpu_torch.ops.kernels.pointwise", "argus_tpu_torch.ops.norm",
                 "argus_tpu_torch.models.resnet", "argus_tpu_torch.ops.kernels.wgrad_plan",
                 "argus_tpu_torch.ops.kernels.bwd_prev")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_import_without_jax(module):
    code = _BLOCKED_IMPORT.replace(
        "import argus_tpu_torch\n", f"import {module}\nimport argus_tpu_torch\n", 1,
    ).replace('print("imported"', f'assert {module!r} in names, names\nprint("imported"')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


# the parallel slice's modules: each imported first, alone, under the same block (tp imports the package,
# its mesh and collectives)
PARALLEL_MODULES = ("argus_tpu_torch.parallel.tp", "argus_tpu_torch.parallel.launch", "argus_tpu_torch.dryrun")


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_import_without_jax(module):
    code = _BLOCKED_IMPORT.replace(
        "import argus_tpu_torch\n", f"import {module}\nimport argus_tpu_torch\n", 1,
    ).replace('print("imported"', f'assert {module!r} in names, names\nprint("imported"')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


SERVING_OPS = ("stem_fwd", "stage_fwd", "projection_block", "bottleneck_block")


def test_serving_and_validation_import_without_jax():
    """The serving module first, alone: it registers the four serving ops
    (`argus::`) and imports no model or checkpoint code (an exported
    program's loader needs neither); then validation and the utilities
    among the package walk, under the same block."""
    check = (
        "import sys, torch\n"
        "import argus_tpu_torch.serve\n"
        f"missing = [op for op in {SERVING_OPS!r} if not hasattr(torch.ops.argus, op)]\n"
        "assert not missing, missing\n"
        "models = sorted(m for m in sys.modules if m.startswith(('argus_tpu_torch.models', "
        "'argus_tpu_torch.checkpoint')))\n"
        "assert not models, models\n"
        "import argus_tpu_torch\n"
    )
    modules = ("argus_tpu_torch.validate", "argus_tpu_torch.validate_real", "argus_tpu_torch.utils",
               "argus_tpu_torch.capture")
    code = _BLOCKED_IMPORT.replace("import argus_tpu_torch\n", check, 1).replace(
        'print("imported"', f'assert set({modules!r}) <= set(names), names\nprint("imported"')
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|msgpack|argus_tpu)\b", re.M)
    assert not banned.findall(src)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from argus_tpu_torch import resolve_device
    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.serve import Estimator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    path = str(tmp_path / "any.ckpt")
    save_checkpoint(path, {"params": {}, "batch_stats": {}})
    with pytest.raises(RuntimeError, match="CUDA"):
        Estimator(path)


def test_train_imports_without_jax():
    """The training module stands alone like the rest of the package."""
    code = _BLOCKED_IMPORT.replace(
        'print("imported", len(names), "modules")',
        'import argus_tpu_torch.train as t; assert callable(t.make_train_step); '
        'print("imported", len(names), "modules")',
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_train_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from argus_tpu_torch.data.feed import device_prefetch
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state, initialize_training, make_eval_step, \
        make_train_step, train

    cfg = TrainConfig(
        model_config=NCameraCNNConfig(backbone="resnet18", resnet_output_dim=8, bn_frozen=True,
                                      bn_frozen_affine=True),
        use_augmentation=False,
    )
    model, _ = create_train_state(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch([{"mask": np.ones(2, np.float32)}]))
    loop_cfg = dataclasses.replace(cfg, device_resident_mb=0)
    for entry in (initialize_training, train):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(loop_cfg, datasets=([], []))


# the remaining modules of argus_tpu, the script twins beside the originals, and the two host scripts that
# need no twin: one process per block list imports each in turn and reports what raised
REMAINING_MODULES = ("argus_tpu_torch.datagen", "argus_tpu_torch.data.streaming",
                     "argus_tpu_torch.models.torch_import", "argus_tpu_torch.profiling",
                     "argus_tpu_torch.models.pose_cnn")
SCRIPT_TWINS = ("timing_torch", "throughput_torch", "rotation_overfitting_torch", "view_augmentations_torch",
                "verify_torch_import_torch", "convergence_ab_torch", "make_mujoco_scene_torch")
HOST_SCRIPTS = ("mujoco_rendering", "mesh_conversion")

_IMPORT_EACH = textwrap.dedent(
    """
    import importlib, importlib.abc, importlib.util, json, os, sys

    BLOCKED, MODULES, SCRIPTS = {blocked!r}, {modules!r}, {scripts!r}

    def blocked(name):
        return name.split(".")[0] in BLOCKED

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {{name}}")
            return None

    for name in [m for m in sys.modules if blocked(m)]:
        del sys.modules[name]
    sys.meta_path.insert(0, Block())

    out = {{}}
    for name in MODULES + SCRIPTS:
        try:
            if name in SCRIPTS:
                spec = importlib.util.spec_from_file_location(name, os.path.join("scripts", name + ".py"))
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
            else:
                importlib.import_module(name)
            out[name] = "ok"
        except Exception as e:
            out[name] = repr(e)
    out["leaked"] = sorted(m for m in sys.modules if blocked(m))
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def imported_under_block():
    """{name: "ok" or the exception}: the port's remaining modules and the twins with jax, flax, msgpack
    and argus_tpu blocked; the host scripts (and argus_tpu.configs, their CLI) with jax and flax blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    runs = ((("jax", "jaxlib", "flax", "msgpack", "argus_tpu"), REMAINING_MODULES, SCRIPT_TWINS),
            (("jax", "jaxlib", "flax"), ("argus_tpu.configs",), HOST_SCRIPTS))
    out = {}
    for blocked, modules, scripts in runs:
        code = _IMPORT_EACH.format(blocked=blocked, modules=modules, scripts=scripts)
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert not res.pop("leaked"), res
        out.update(res)
    return out


@pytest.mark.parametrize("name", REMAINING_MODULES + SCRIPT_TWINS + ("argus_tpu.configs",) + HOST_SCRIPTS)
def test_remaining_modules_and_scripts_import_without_jax(name, imported_under_block):
    assert imported_under_block[name] == "ok", imported_under_block[name]


@pytest.mark.parametrize("twin", SCRIPT_TWINS + HOST_SCRIPTS)
def test_script_imports_nothing_of_jax_anywhere(twin):
    """Also the imports inside functions, which importing the file does not run."""
    src = open(os.path.join(REPO, "scripts", f"{twin}.py")).read()
    banned = "jax|jaxlib|flax" if twin in HOST_SCRIPTS else "jax|jaxlib|flax|msgpack|argus_tpu"
    assert not re.findall(rf"^\s*(import|from)\s+({banned})\b", src, re.M)
