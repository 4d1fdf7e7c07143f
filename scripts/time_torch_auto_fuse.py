#!/usr/bin/env python3
"""Time each kernel function of the port against cuDNN inside the model, to
fill `argus_tpu_torch.models.resnet.AUTO_FUSE` (what the fuse flags' "auto"
chooses on a CUDA tensor).

    python3 scripts/time_torch_auto_fuse.py [--steps 6] [--out outputs/auto_fuse.json]

Needs one CUDA card. Every fuse flag (`fuse_pointwise` too) is set to
"auto" and `AUTO_FUSE` is patched: first with every entry off (the baseline:
cuDNN convs on BN-folded weights), then with one entry (or the packed stem's
pair) on at a time. A function's gain is the baseline's time less its own. Workloads, at
full width (ResNet-50 NCameraCNN, 2 cameras, 1024-d features, bf16, frozen
BN and affine, random weights, batch 256 rows = 512 camera images of
256x256):

- `flagship`: the train step with a frozen stem (argus_tpu's flagship),
  augmentation on: the stem's no-save forward, and the stage chain,
  projection, identity and pointwise functions in training mode (the
  pointwise op alone, as `fuse_pointwise` runs it with the block flags
  off: Conv_0 and Conv_2 of every bottleneck);
- `stem_trained`: the same with the stem trained: the stem in training mode;
- `frozen3`: the `frozen_stages=3` fine-tune step: the packed stem with the
  stage-0 chain, the whole-stage chains of stages 1-2 (no save), the
  stage-3 blocks in training mode, and the pointwise op (its no-save
  forward in stages 0-2, its training pair in stage 3);
- `serving`: the model's forward on a resident batch of frames (gradients
  off): every function's no-save forward, the pointwise op's among them;
- `keypoint_eval` and `keypoint_step`: CubeKeypointNet (ResNet-18,
  frozen BN, affine and stem) eval forward and train step: the
  BasicBlock's two modes.

Each workload is also timed with every flag "on", every flag "off" and the
current table ("auto"). Prints one line per timing and writes them all to
`--out` as JSON. Times are CUDA-event means over `--steps` calls after one
warm-up call, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("fuse_block", "fuse_proj", "fuse_stem", "fuse_stage", "fuse_pointwise")


def _timer(fn, steps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return sum(ms) / len(ms)


def _set_flags(backbone, value: str) -> None:
    for f in FLAGS:
        setattr(backbone, f, value)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default=os.path.join(REPO, "outputs", "auto_fuse.json"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_torch_auto_fuse: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from argus_tpu_torch.models import resnet
    from argus_tpu_torch.models import CubeKeypointNetConfig
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import feed_images, make_train_step

    cs.GPU = cs.gpu_line()
    torch.backends.cudnn.benchmark = False
    table = dict(resnet.AUTO_FUSE)
    results = {"gpu": cs.GPU, "table": {f"{k[0]}/{k[1]}": v for k, v in table.items()}, "runs": {}}

    def timed(workload, label, fn, patch=None, flags="auto", backbone=None):
        resnet.AUTO_FUSE.update(patch if patch is not None else table)
        _set_flags(backbone, flags)
        kernels.reset_launch_counts()
        ms = _timer(fn, args.steps)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        resnet.AUTO_FUSE.update(table)
        results["runs"].setdefault(workload, {})[label] = {"ms": ms, "launches": launched}
        cs.say(f"{workload} {label}: {ms:.2f} ms (launches in {args.steps + 1} calls {launched})")
        return ms

    def sweep(workload, fn, backbone, keys):
        off = {k: False for k in table}
        base = timed(workload, "baseline (every entry off)", fn, off, backbone=backbone)
        for k in keys:
            ks = k if isinstance(k[0], tuple) else (k,)
            ms = timed(workload, "+".join(f"{a}/{b}" for a, b in ks), fn, {**off, **{kk: True for kk in ks}},
                       backbone=backbone)
            cs.say(f"{workload}: {' + '.join(f'{a}/{b}' for a, b in ks)} on saves {base - ms:.2f} ms "
                   f"({'kernel' if ms < base else 'cuDNN'} wins)")
        for flags in ("on", "off", "auto"):
            timed(workload, f"all {flags}", fn, None, flags=flags, backbone=backbone)

    t0 = time.perf_counter()
    for workload, overrides in (("flagship", {}), ("stem_trained", {"stem_frozen": False}),
                                ("frozen3", {"frozen_stages": 3})):
        cfg, model, state, batch = cs.flagship_train_setup(**overrides)
        step = make_train_step(model, cfg)
        holder = {"state": state}

        def run(step=step, holder=holder, batch=batch):
            holder["state"], _ = step(holder["state"], batch)

        keys = {
            "flagship": [("stem", "forward"), ("stage_chain", "train"), ("projection", "train"),
                         ("identity", "train"), ("pointwise", "train")],
            "stem_trained": [("stem", "train")],
            "frozen3": [(("stem", "forward"), ("stage_chain_packed", "forward")), ("stage_chain", "forward"),
                        ("projection", "train"), ("identity", "train"), ("pointwise", "forward"),
                        ("pointwise", "train")],
        }[workload]
        sweep(workload, run, model.backbone, keys)
        if workload == "flagship":
            images = feed_images(cfg, batch["images"], "cuda")

            def forward(model=model, images=images):
                with torch.inference_mode():
                    model(images)

            model.backbone.fold_frozen_bn()  # once, as `serve.Estimator` folds
            sweep("serving", forward, model.backbone,
                  [("stem", "forward"), ("stage_chain_packed", "forward"), ("projection", "forward"),
                   ("identity", "forward"), ("pointwise", "forward")])
        del model, state, batch, step, holder
        torch.cuda.empty_cache()

    kcfg = CubeKeypointNetConfig(bn_frozen=True, bn_frozen_affine=True, stem_frozen=True, fuse_block="auto",
                                 fuse_stem="auto")
    cfg, model, state, batch = cs.keypoint_setup(kcfg)
    images = feed_images(cfg, batch["images"], "cuda")

    def kp_forward():
        with torch.inference_mode():
            model(images)

    sweep("keypoint_eval", kp_forward, model.backbone, [("basic", "forward")])
    step = make_train_step(model, cfg, hw=(cs.HW, cs.HW))
    holder = {"state": state}

    def kp_run():
        holder["state"], _ = step(holder["state"], batch)

    sweep("keypoint_step", kp_run, model.backbone, [("basic", "train")])
    cs.say(f"time_torch_auto_fuse: done in {time.perf_counter() - t0:.0f} s")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
