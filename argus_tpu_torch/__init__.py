"""argus_tpu_torch: the PyTorch/CUDA port of argus_tpu for NVIDIA Hopper (H100).

The JAX package `argus_tpu` stays the reference; this package runs the same
models on a CUDA card with hand-written sm_90a kernels in place of the Pallas
TPU kernels. It imports torch, numpy and the standard library only: never
jax, flax, msgpack or anything of `argus_tpu`.

Covered so far (ROADMAP.md lists what waits): serving of both model
families (`serve.Estimator`: on the card one CUDA graph replayed per input
shape, the single-frame control loop included), the exported serving
program (`serve.export_estimator`, `serve.ExportedEstimator`), validation
(`validate`, `validate_real`), the train step of either family
(`train.make_train_step`) in argus_tpu's BN modes (exact train-mode BN with
BatchNorm's reduction kernels, frozen BN with a trained or frozen affine)
with a trained or frozen stem or frozen stages, the augmentation stack,
and argus_tpu's training loop (`train.train`: the host data feed of
`data`, the eval step, the plateau schedule, checkpoints of the whole
train state and resume), with the CUDA kernels of `ops.kernels`; on one
card or, under `multigpu`, one process per card (`parallel`): argus_tpu's
bucketed gradient all-reduce over the data ranks, exact BatchNorm over the
global batch, the wide dense layers cut over `num_model_shards` ranks, and
the multi-process dry-run (`dryrun`). Around them: the streaming render
feed (`data.streaming`: rendered batches straight into the train step),
the Unity/MJPC data generation's host parts (`datagen`), torchvision
weight import (`models.torch_import`), `models.pose_cnn.init_model`,
tracing and timing (`profiling`), and twins of argus_tpu's scripts
(`scripts/*_torch.py`).

Entry points take `device=None`, meaning CUDA; they raise when no card is
present, and run on the CPU only when the caller passes `device="cpu"`.
"""

from __future__ import annotations

import os

import torch

# the repository root, against which configs resolve relative paths and
# under which `outputs/` is written (argus_tpu's `ROOT`)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and absent, so a
    missing card never silently turns into a CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "argus_tpu_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


__all__ = ["ROOT", "resolve_device"]
