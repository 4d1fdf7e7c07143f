#!/usr/bin/env python3
"""Time the train steps of one tree on the card: Path A (the flagship with
the fused stem trained, and at `stem_grad_stride=4`), the flagship's timed
steps with and without augmentation, `train()` end to end, and the stem
weight gradient through its wrapper:

    python3 scripts/time_torch_steps.py [--root DIR] [--reps 2] [--parts path_a,flagship,loop,stem]

`--root DIR` runs an unpacked tree (the parent commit, say) with its own
`chip_smoke.py` phases, each `--reps` times: `path_a_phase` (its 8-row
check against the unfused step, then 6 timed steps each way),
`train_phase` (the flagship's 8-row check, then 6 timed steps with and 6
without augmentation), `loop_phase` (`train()` at full width: 2 epochs
and 1 resumed, end-to-end camera-images/s beside the compute-only step),
then `stem_bwd` at N = 512 and N/4 with CUDA events over 5 and 50 calls
and the host's enqueue time a call. A step moves 5-10% with the host
between runs, so compare two trees by alternating them on one card:

    for r in _trees/parent . . _trees/parent; do python3 scripts/time_torch_steps.py --root $r; done

Every line names the tree and ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--parts", default="path_a,flagship,loop,stem")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the train steps on the card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    os.environ["WANDB_MODE"] = "disabled"
    import chip_smoke as c
    from argus_tpu_torch.ops.kernels import _build
    from argus_tpu_torch.ops.kernels import stem_fused as ks

    c.GPU = c.gpu_line()
    _build.build()
    parts = args.parts.split(",")
    for rep in range(args.reps):
        if "path_a" in parts:
            _, ms, ms4 = c.path_a_phase()
            c.say(f"path A ({root}) run {rep}: {ms:.2f} ms/step, at stem_grad_stride=4 {ms4:.2f} ms/step")
        if "flagship" in parts:
            _, ms = c.train_phase()
            c.say(f"flagship ({root}) run {rep}: {ms:.2f} ms/step with augmentation (6 timed steps)")
        if "loop" in parts:
            with tempfile.TemporaryDirectory() as tmp:
                loop = c.loop_phase(tmp)
            c.say(f"train() ({root}) run {rep}: {c.N_IMG / loop['e2e_ms'] * 1e3:.1f} camera-images/s end to end, "
                  f"{c.N_IMG / loop['compute_ms'] * 1e3:.1f} compute only")
    if "stem" not in parts:
        return
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.rand(c.N_IMG, c.HW, c.HW, 3, generator=g, device="cuda").to(torch.bfloat16)
    w7 = (0.2 * torch.randn(7, 7, 3, 64, generator=g, device="cuda")).to(torch.bfloat16)
    b = 0.1 * torch.randn(1, 64, generator=g, device="cuda")
    out, y = ks.stem_fwd_save(x, w7, b)
    gr = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
    for n in (c.N_IMG, c.N_IMG // 4):
        fn = lambda n=n: ks.stem_bwd(x, gr, out, y, n)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        c.say(f"stem_bwd ({root}) n_images {n}: {c.cuda_ms(fn, 5):.4f} ms over 5 calls, {c.cuda_ms(fn, 50):.4f} over 50, "
              f"host enqueue {host:.4f} ms a call")


if __name__ == "__main__":
    main()
