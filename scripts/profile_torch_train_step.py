#!/usr/bin/env python3
"""Profile one of the port's train steps on one NVIDIA GPU with
`torch.profiler`: device time by CUDA kernel and the device's busy and idle
share over a window of steps.

    python3 scripts/profile_torch_train_step.py
        [--model flagship|stem|exact|exact-xla|keypoint|keypoint-unfused|default|default-auto]
        [--steps 3] [--out chiprun_out/profile_<model>.txt]

`flagship` is `chip_smoke.flagship_train_setup`'s step (ResNet-50 NCameraCNN
at full width, batch 256 two-camera 256x256 uint8 rows, bf16, frozen BN and
stem, full backprop, argus_tpu's default augmentation); `stem` the same
with the fused stem trained (`stem_frozen=False`); `exact` the same model
at argus_tpu's default BN and stem (exact train-mode BN with
`bn_impl="auto"`: the BN reduction kernels, cuDNN convs), `exact-xla` with
`bn_impl="xla"`; `keypoint` is
`chip_smoke.keypoint_setup`'s (CubeKeypointNet at argus_tpu's default
config, resnet18, the same batch shape, fused identity BasicBlocks and
stem), `keypoint-unfused` the same with the fuse flags off (cuDNN convs);
`default` is `chip_smoke.default_train_setup`'s (argus_tpu's default
training configuration: the same ResNet-50 in f32 at batch 32, exact BN on
"xla", cuDNN convs under torch's TF32 defaults), `default-auto` the same
with `bn_impl="auto"` (the BN reduction kernels). Each step is the eager
per-step path (`make_train_step`). After a warm-up step, `--steps` steps run
under the profiler; busy time is the sum of the device-side events' time
(kernels, copies, memsets; one stream, so they do not overlap), the window
is the host clock from the first step's start to a synchronise after the
last, and idle is the rest of the window.
Prints a summary, the device time grouped by kind (each of the port's
kernels by name, cuDNN/CUTLASS convolutions, PyTorch elementwise and copy
kernels, reductions, the rest), and writes the kernel table to `--out`.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kind(key: str) -> str:
    """The group of a device kernel's name."""
    if "argus::" in key:
        return key.split("argus::")[1].split("(")[0].split("<")[0]
    if "xmma" in key or "cutlass" in key or "cudnn" in key.lower():
        return "cuDNN/CUTLASS conv"
    if "elementwise" in key or "copy" in key.lower():
        return "PyTorch elementwise and copies"
    if "reduce" in key:
        return "PyTorch reductions"
    return "other"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("flagship", "stem", "exact", "exact-xla", "keypoint", "keypoint-unfused",
                                        "default", "default-auto"), default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    args.out = args.out or os.path.join(REPO, "chiprun_out", f"profile_{args.model}.txt")
    sys.path.insert(0, REPO)
    import chip_smoke
    from argus_tpu_torch.train import make_train_step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chip_smoke.GPU = chip_smoke.gpu_line()
    auto = {k: "auto" for k in chip_smoke.FUSE_ON}
    if args.model == "flagship":
        cfg, model, state, batch = chip_smoke.flagship_train_setup()
    elif args.model == "stem":
        cfg, model, state, batch = chip_smoke.flagship_train_setup(stem_frozen=False, **auto)
    elif args.model.startswith("default"):
        cfg, model, state, batch = chip_smoke.default_train_setup(
            bn_impl="auto" if args.model == "default-auto" else "xla")
    elif args.model.startswith("exact"):
        cfg, model, state, batch = chip_smoke.flagship_train_setup(
            bn_frozen=False, bn_frozen_affine=False, stem_frozen=False,
            bn_impl="xla" if args.model == "exact-xla" else "auto", **auto)
    else:
        cfg, model, state, batch = chip_smoke.keypoint_setup()
        if args.model == "keypoint-unfused":
            cfg, model, state = chip_smoke.keypoint_unfused_twin(cfg, model)
    step = make_train_step(model, cfg)
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only (kernels, copies, memsets); the host ops that
    # launched them carry the same time again
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / args.steps / 1e3, e.count // args.steps, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    step_ms = window_ms / args.steps
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(f"{chip_smoke.GPU}\n{args.steps} steps, {step_ms:.2f} ms/step (host clock), "
                f"device busy {busy_ms:.2f} ms/step\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.3f} ms/step  {n:6d} per step  {key[:160]}\n")
    chip_smoke.say(f"profile {args.model}: {args.steps} profiled steps, {step_ms:.2f} ms/step by host clock, device busy "
                   f"{busy_ms:.2f} ms/step = {100 * busy_ms / step_ms:.1f}% (idle {100 - 100 * busy_ms / step_ms:.1f}%)")
    groups = collections.Counter()
    for ms, _, key in rows:
        groups[kind(key)] += ms
    chip_smoke.say("profile by kind (ms/step): " + ", ".join(f"{k} {v:.2f}" for k, v in groups.most_common()))
    for ms, n, key in rows[:20]:
        chip_smoke.say(f"profile:   {ms:9.3f} ms/step  {n:5d} per step  {key[:90]}")
    chip_smoke.say(f"profile: full table in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
