#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (argus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and ignored):

1. build every CUDA kernel of the serving, training, augmentation,
   keypoint, trained-stem, exact-BN, frozen-stage, pointwise and remat paths
   from `argus_tpu_torch/csrc/` (17 sources, one nvcc each, in parallel) and
   print the seconds and ptxas' register/spill report; `cuobjdump -sass` of
   the BasicBlock, projection and identity backwards' libraries (the
   identity's saved-residual and recompute backwards), the stage chain's
   backward, the BasicBlock, identity bottleneck and projection forwards,
   the chain forwards, the pointwise backward and forward and the stem's
   weight gradient must show wgmma (HGMMA) instructions, and the
   augmentation kernel's bf16 instantiation packed bf16x2 products and sums
   (its conversions counted beside them);
2. per kernel, at the serving shapes of a batch of 256 two-camera frames
   (N = 512 camera images at 256x256): hold the CUDA kernel against its plain
   PyTorch version on the same bf16 inputs, max |kernel - plain| <=
   2e-2 * max |plain| + 1e-2 (one bf16 rounding of f32 sums taken in another
   order), and time the kernel, the plain version and the cuDNN composition of
   the same function (`library_ms`, bf16 channels-last `F.conv2d` calls) with
   CUDA events;
3. end to end: a full-width ResNet-50 NCameraCNN (2 cameras, 1024-d
   features, random weights from a seeded generator, BN buffers and scales
   randomised) saved as an argus_tpu format-2 checkpoint, served by
   `Estimator(ckpt, batch_size=256)` on the card; the launch counts of one
   `predict` must be 1 stem / 1 stage / 3 projection / 10 identity, and the
   poses must match `Estimator(ckpt, batch_size=8, device="cpu")` on the first
   8 rows within atol 0.05 (bf16 on both sides);
4. the training kernels at the shapes of the flagship train step (batch 256
   rows, N = 512 camera images, 256x256): each saving forward (out, h1, h2)
   and each one-pass backward (dx and every dw) of the stage-0 chain, the
   three projection blocks and the three identity-block geometries against
   its plain version, same tolerance; `library_ms` of a saving forward is the
   cuDNN composition's forward, of a backward its autograd backward (timed
   with retain_graph); then the three BasicBlock kernels (no-save forward,
   saving forward, one-pass backward) at the four geometries of ResNet-18's
   identity blocks at N = 512 (C/H = 64/64, 128/32, 256/16, 512/8), same
   tolerance and yardsticks; then the kernels redesigned on the Hopper
   wgmma/TMA engines (the BasicBlock, projection, and the identity block's
   saved-residual and recompute backwards, the stage-0 chain's backward,
   the BasicBlock, identity bottleneck and projection forwards, the chain
   forwards, the pointwise backward and forward) and the one-launch BN
   reductions beside the form they had before (the mma.sync engine, the
   two-launch reduction: `ops/kernels/bwd_prev.py`), at the seven
   BasicBlock and projection geometries, the four identity ones, the
   chain's, the four BasicBlock forward ones, the three identity forward
   ones of stages 1-3, configuration P's twelve pointwise ones (backward
   and forward), the three projection forward ones, the frozen stages' two
   chains, the stage-0 chain's saving forward and ResNet-50's 24 BN cases,
   each call broken down by device kernel (data gradient, weight gradient,
   split sum, mask pass, forward conv, forward conv on the TMA engine, BN
   stream, BN reduce) from `torch.profiler`, with per-step totals;
5. the augmentation kernels at the flagship step's shapes (N = 512 camera
   images, 256x256, parameters from the port's samplers): the whole-stack
   kernel against its plain version in bf16 at each of the 4 hue positions
   (forced orders) with 10 arcs and with none, and in f32; the blur kernel
   in bf16 and f32; max |kernel - plain| <= 1.6e-2 and mean <= 1e-3 in bf16
   (both round every op to bf16 at the same points; the contrast's luma mean
   and the hue's divisions differ by an f32 ulp, which can move a bf16
   rounding by one ulp, 2^-8 in [0.5, 1)), <= 1e-5 in f32; two calls of the
   whole-stack kernel bit-equal, and the stack at 16 x 203x137 (a height
   its bands do not divide, an odd width), 8 x 512x512 and 4 x 128x1920
   (bands too large for shared memory: the streamed form) in bf16 and f32,
   each two calls bit-equal. Then the two
   paths through `apply_augmentation` on one bf16 batch, launches counted:
   the fused path 1 `augment_fused`, the per-op path 1 `blur`; and the fused
   path against the per-op path on the same parameters, in f32 and bf16,
   interior only (4 px margin: the per-op path reflects at the border, the
   kernels clamp); mean |diff| <= 1e-3 (f32) and 2e-3 (bf16), and at most
   1e-5 (f32) and 1e-3 (bf16) of the elements more than 2e-2 apart: where
   the plasma threshold falls on the other side of a pixel (the per-op path
   upsamples with a matrix product, the kernel in a fixed order of separate
   roundings) and, in bf16, where the per-op hue, computed in bf16, lands a
   few ulps from the kernel's f32 hue. Times: kernel, plain, and for the
   blur the yardstick `library_ms` (`F.pad(replicate)` and grouped
   `F.conv2d`); the stack has no single PyTorch call (null);
6. the flagship train step through `argus_tpu_torch.train` (ResNet-50
   NCameraCNN at full width, 2 cameras, 1024-d features, bf16, frozen BN with
   frozen affine, frozen stem, full backprop through stages 0-3, argus_tpu's
   default augmentation, clip(1.0) + Adam, batch 256 of seeded uint8 frames
   and non-identity poses, random weights with BN scales randomised): first
   the fused loss and gradients against the same model with every fuse flag
   off (cuDNN convs and frozen BN through autograd) on the first 8 rows of
   one augmented batch, loss within 1e-2 relative and each parameter's
   gradient within 0.1 relative (2-norm; 0.05 in the median over
   parameters): the two bf16 paths round at different points (the unfused
   one rounds each conv output before a bf16 BN, the fused one once after
   the folded bias) and the roundings accumulate through 50 layers each way
   (measured on the H100: 1.9e-3 and 0.025 / 0.017); then a warm-up step
   and 6 timed steps with finite losses, launches per step 1 augment / 1
   stem / 1 + 1 chain / 3 + 3 projection / 10 + 10 identity, ms per step
   (CUDA events and host clock), camera-images/s and peak memory; then the
   same for the step without augmentation, beside it;
7. the keypoint family (CubeKeypointNet at argus_tpu's default config:
   2 cameras, 8 corners, resnet18, head_features 128, 32x32 heatmaps) with
   `fuse_block`/`fuse_stem` "on", bf16, frozen BN + affine + stem, default
   augmentation, clip(1.0) + Adam, batch 256 rows, random weights with
   every BN and LayerNorm randomised: the fused loss and gradients on 8
   augmented rows against the unfused (cuDNN) step, loss within 1e-2, and
   both against the f32 step (bf16 gradients of this model sit 5-10% from
   f32 on either path): the fused step within 1.25x the unfused step's
   distance from f32 (max and median over parameters) and within 0.25 /
   0.15 of the unfused step; the launches of an eval forward (1 stem / 5
   `basic_fused`) and of a step (1 augment / 1 stem / 5 + 5 BasicBlock),
   6 timed steps fused and 6 unfused in the same call; then keypoint
   serving, `Estimator(ckpt, batch_size=256)` on a checkpoint of those
   weights (unfused bf16, as argus_tpu serves BasicBlock backbones: no
   kernel launch), poses within 0.05 of the CPU estimator on 8 rows, or,
   where the CPU's own bf16 poses sit farther than that from its f32 ones
   (the random-weight fit amplifies bf16 rounding), no farther from the f32
   poses than 1.25x the CPU's bf16 ones;
8. the stem_fused_save/bwd and BN-reduction kernels (with phase 4): the
   trained stem's saving forward (out and y within one bf16 ulp of the plain
   version, or within 1e-5 of the largest value where relu keeps a sum that
   sits within f32 rounding of zero) and its weight gradient over all 512
   images and over the first 128 (2e-2 * max |plain| + 1e-2; two calls
   bit-equal), and at 16 x 200x136 and 16 x 200x132 (not whole tiles; the
   second's patch rows by cp.async) over 16 and 4 images; BatchNorm's
   statistics and backward reductions at every distinct (M, C) of ResNet-50's
   53 BN inputs at N = 512, strides 1 and 4 (n_rows equal, sums within 1e-4
   of each channel's sum of magnitudes, one device kernel a call, two calls
   bit-equal), timed beside `torch.batch_norm_stats` and
   `torch.batch_norm_backward_reduce` (CUDA events over 10 calls, the device
   time from torch.profiler, the host's enqueue time); then Path A, the flagship step
   with the fused stem trained (fuse flags "on"): against the unfused cuDNN
   step on 8 augmented rows within phase 6's gates (conv_init's gradient
   included), launches 1 augment / 1 stem save / 1 stem backward / 1 + 1 /
   3 + 3 / 10 + 10, 6 timed steps, and 6 at `stem_grad_stride=4`; Path B,
   the exact-BN step at argus_tpu's default BN and stem with `bn_impl="auto"`
   against its "xla" twin on 8 augmented rows (loss within 1e-2, gradients
   0.3 / 0.1 max / median, the running statistics' change 5e-2 / 1e-2,
   relative 2-norms: the engines reduce in other orders and round bf16 at
   other points), launches 1 augment / 53 `bn_stats` / 53 `bn_bwd_reduce`,
   6 timed steps of each; then the keypoint family's default step (exact BN,
   unfused), 6 timed steps;
9. the frozen-stage fine-tune (`frozen_stages=3`: stem and stages 0-2
   frozen, fuse flags "on"): the packed-output stem (argus_tpu's
   `_stem_fwd_packed_pallas`) against its plain version at 512 x 256x256
   within one bf16 ulp, and the whole-stage no-save chains of stages 1 and
   2 (stride 2, 3 and 5 identity blocks) under the conv gate, timed beside
   plain and cuDNN; then the step: fused against unfused on 8 augmented
   rows under phase 6's gates (nothing below stage 3 gets a gradient),
   launches per eval forward 1 packed stem / 1 stage-0 chain / 2 frozen
   chains / 1 projection / 2 identity and per step 1 augment / 1 packed
   stem / 1 / 2 / 1+1 / 2+2, 6 timed steps fused and 6 unfused;
10. what "auto" chooses (`models.resnet.AUTO_FUSE`, printed): the fuse
   flags all "on", all "off" and all "auto" for the flagship step, the
   `frozen_stages=3` step and batch-256 serving, in this call, the three
   settings interleaved (the fastest of 288 steps or predicts each); an
   "auto" step launches exactly what the table names, and is no slower
   than the faster of "on" and "off" by more than 2%;
11. `train()` end to end: the `frozen_stages=3` fine-tune at full width
   (fuse "auto", `device_resident_mb=0`, augmentation on) on 1024 + 160
   frames rendered by the port's synthetic renderer into an in-memory
   dataset (no h5py on the card), through `HostDataLoader` and the device
   feed: 2 epochs, then 1 more resumed from the saved file; finite losses,
   the step count continuing, the file restoring bit-equal into a fresh
   `TrainState`, every kernel "auto" names launched; end-to-end
   camera-images/s beside the compute-only step, and how long
   `AsyncCheckpointer.save` holds the caller;
12. the pointwise kernels (`fuse_pointwise`, B11) at every (M, CIN, COUT,
   residual) of configuration P's step (N = 512 camera images, 256x256:
   Conv_0 and Conv_2 of the 16 bottlenecks) and at an odd M (513 x 7 x 7):
   the forward with and without the residual (and with relu off at the odd
   M and at one P geometry of each kind), the backward with and without
   emitting m, against their plain versions under the conv gate (out, dx,
   m, dw); timed beside the plain version and "dot" (cuBLAS's bf16
   GEMMs with f32 outputs and PyTorch's epilogue passes, `library_ms`);
13. configuration P, the flagship step with `fuse_pointwise="on"` and the
   block, projection and chain flags off: loss and gradients on 8
   augmented rows against the "off" step (its convs on folded weights) under
   phase 6's gates, launches per step 1 augment / 1 stem / 32 pointwise /
   32 pointwise_bwd, 6 timed steps each with "on", "dot", "off" and "auto"
   (ms/step, camera-images/s, peak memory);
14. the identity block's recompute backward (B7, the backward of a fused
   identity block under remat) at the four identity geometries (N = 512)
   against its plain version under the conv gate (dx, dw1-3), timed beside
   the plain version, cuDNN's folded recompute forward with its autograd
   backward (`library_ms`) and the saved-residual backward at the same
   shapes;
15. configuration R, the flagship step with `remat=True` and the fuse flags
   "on": loss and gradients on 8 rows against the step without remat under
   phase 6's gates; launches per step 1 augment / 1 stem / 1 + 1 stage-0
   chain (it ignores remat) / 3 projection forwards, 3 saving forwards
   re-run and 3 backwards / 10 identity forwards and 10 recompute
   backwards; 6 timed steps each way, R's peak memory below the other's;
16. configuration R-B, Path B with `remat=True`: loss, gradients and the
   running statistics' change after one step on 8 rows against Path B
   without remat within Path B's gates, `bn_stats` launches per step the
   same (53) both ways, 6 timed steps each way, R-B's peak memory below
   Path B's; (phase 10, "auto", also switches `fuse_pointwise` in the two
   train workloads, and its expected launches count the pointwise kernels
   where `AUTO_FUSE` names them);
17. the `kernels` JSON line, the card's name and power limit, and the result
   line `{"ok": true, "device": {...}}` last. A kernel's bound takes the
   peak that applies: 989 TFLOP/s (bf16 tensor cores) for the conv kernels,
   67 TFLOP/s (f32 on the CUDA cores) for the blur and the augmentation
   kernel's f32 work, 133.8 TFLOP/s (packed bf16x2 on the CUDA cores) for
   its image-dtype work on bf16 images; where a kernel's work runs at two
   rates, the times of the two parts add.

Exits non-zero, printing no result, without a CUDA device or without the
package beside it. Imports nothing of JAX or argus_tpu.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 256  # serving batch: rows of two-camera frames
N_IMG = 2 * N_ROWS  # camera images through the backbone
HW = 256
TOL_REL, TOL_ABS = 2e-2, 1e-2  # kernel vs plain, bf16 outputs
POSE_ATOL = 0.05  # GPU bf16 serving vs CPU bf16 serving
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32 = 67e12  # H100 SXM f32 on the CUDA cores (NVIDIA's data sheet)
PEAK_BF16X2 = 133.8e12  # H100 SXM bf16 outside the tensor cores (NVIDIA's H100 architecture whitepaper)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
BF = 2  # bytes per bf16

TRAIN_LOSS_RTOL = 1e-2  # fused vs unfused bf16 step, loss
GRAD_RTOL, GRAD_RTOL_MEDIAN = 0.1, 0.05  # fused vs unfused bf16 step, per-leaf gradients
TRAIN_STEPS = 6
# the keypoint step's gradients: bf16 against f32 differs by 5-10% per
# parameter (2-norm) on either path (argus_tpu's own bf16 moments sit 0.17 /
# 0.097 from its f32 ones, tests/test_torch_keypoint.py), so the fused step
# is held to the f32 step no worse than the unfused cuDNN bf16 step is, with
# KP_GRAD_SLACK, and to the unfused step within KP_GRAD_RTOL (max, median)
KP_GRAD_SLACK = 1.25
KP_GRAD_RTOL = (0.25, 0.15)
AUG_TOL = {"bf16": (1.6e-2, 1e-3), "f32": (1e-5, 1e-5)}  # augmentation kernel vs plain: max, mean
PATHS_TOL = {"f32": (1e-3, 1e-5), "bf16": (2e-3, 1e-3)}  # fused vs per-op path: mean, share beyond 2e-2

REPLACES = {
    "stem_fused": "argus_tpu/ops/pallas/stem_fused.py:244",
    "stage_fused": "argus_tpu/ops/pallas/stage_fused.py:527",
    "proj_fused": "argus_tpu/ops/pallas/proj_fused.py:205",
    "block_fused": "argus_tpu/ops/pallas/block_fused.py:270",
    "stage_fused_save": "argus_tpu/ops/pallas/stage_fused.py:364",
    "stage_fused_bwd": "argus_tpu/ops/pallas/stage_fused.py:586",
    "proj_fused_save": "argus_tpu/ops/pallas/proj_fused.py:205",
    "proj_fused_bwd": "argus_tpu/ops/pallas/proj_fused.py:363",
    "block_fused_save": "argus_tpu/ops/pallas/block_fused.py:314",
    "block_fused_bwd": "argus_tpu/ops/pallas/block_fused.py:394",
    "augment_fused": "argus_tpu/ops/pallas/augment_fused.py:278",
    "blur": "argus_tpu/ops/pallas/blur.py:81",
    "basic_fused": "argus_tpu/ops/pallas/basic_fused.py:87",
    "basic_fused_save": "argus_tpu/ops/pallas/basic_fused.py:87",
    "basic_fused_bwd": "argus_tpu/ops/pallas/basic_fused.py:167",
    "stem_fused_save": "argus_tpu/ops/pallas/stem_fused.py:280",
    "stem_fused_bwd": "argus_tpu/ops/pallas/stem_fused.py:304",
    "bn_stats": "argus_tpu/ops/pallas/bn_reduce.py:74",
    "bn_bwd_reduce": "argus_tpu/ops/pallas/bn_reduce.py:149",
    "stem_fused_packed": "argus_tpu/ops/pallas/stem_fused.py:262",
    "stage_fused_frozen": "argus_tpu/ops/pallas/stage_fused.py:364",
    "pointwise": "argus_tpu/ops/pallas/pointwise.py:93",
    "pointwise_bwd": "argus_tpu/ops/pallas/pointwise.py:157",
    "block_fused_rbwd": "argus_tpu/ops/pallas/block_fused.py:519",
}
SOURCES = {name: f"argus_tpu_torch/csrc/{name.replace('_save', '')}.cu" for name in REPLACES}
SOURCES.update(stem_fused_packed="argus_tpu_torch/csrc/stem_fused.cu",
               stage_fused_frozen="argus_tpu_torch/csrc/stage_fused.cu")
SOURCES.update(bn_stats="argus_tpu_torch/csrc/bn_reduce.cu", bn_bwd_reduce="argus_tpu_torch/csrc/bn_reduce.cu")
_NONE = {name: 0 for name in REPLACES}
EXPECTED_LAUNCHES = {**_NONE, "stem_fused": 1, "stage_fused": 1, "proj_fused": 3, "block_fused": 10}
EXPECTED_TRAIN_LAUNCHES = {
    **_NONE, "augment_fused": 1, "stem_fused": 1, "stage_fused_save": 1, "stage_fused_bwd": 1, "proj_fused_save": 3,
    "proj_fused_bwd": 3, "block_fused_save": 10, "block_fused_bwd": 10,
}
# the keypoint family (resnet18, fused): per train step, and per eval forward
EXPECTED_KP_LAUNCHES = {**_NONE, "augment_fused": 1, "stem_fused": 1, "basic_fused_save": 5, "basic_fused_bwd": 5}
EXPECTED_KP_EVAL_LAUNCHES = {**_NONE, "stem_fused": 1, "basic_fused": 5}
# the trained stem (Path A): per step, beside the flagship's fused blocks
EXPECTED_STEM_LAUNCHES = {**EXPECTED_TRAIN_LAUNCHES, "stem_fused": 0, "stem_fused_save": 1, "stem_fused_bwd": 1}
# exact BN (Path B): every BN of ResNet-50 reduces once each way; no conv kernel
EXPECTED_EXACT_LAUNCHES = {**_NONE, "augment_fused": 1, "bn_stats": 53, "bn_bwd_reduce": 53}
# Path B against its "xla" twin on 8 rows: loss, per-parameter gradients (max,
# median over parameters) and the running statistics' change (max, median
# over buffers), relative 2-norms: the two engines reduce in other orders and
# the kernel path's dx is argus_tpu's closed formula where "xla" is autodiff
# through each bf16 op, so bf16 roundings differ at every BN
EXACT_LOSS_RTOL, EXACT_GRAD_RTOL, EXACT_STATS_RTOL = 1e-2, (0.3, 0.1), (5e-2, 1e-2)
STEM_ULP = 2.0 ** -7  # one bf16 ulp relative to the value: 2^-8 of the binade's top, 2^-7 of its bottom
# a conv value within f32 rounding of zero, which relu keeps on one side and
# zeroes on the other: the 147-term sums' reordering error, relative to the output's largest value
STEM_ZERO = 1e-5
BN_RTOL = 1e-4  # the BN reductions: kernel vs plain, relative to the channel's sum of magnitudes
# ResNet-18's identity BasicBlocks at N = 512, 256x256 frames: (C, H = W,
# blocks of that geometry in a forward: stage 0 blocks 0-1, stages 1-3 block 1)
BASIC_GEOMETRIES = [(64, 64, 2), (128, 32, 1), (256, 16, 1), (512, 8, 1)]
SHIFT_INVARIANT = "heatmap.bias"  # its gradient is zero up to rounding: the spatial softmax cancels it
# the frozen_stages=3 fine-tune, fuse "on": per train step, and per eval forward
EXPECTED_FROZEN_LAUNCHES = {
    **_NONE, "augment_fused": 1, "stem_fused_packed": 1, "stage_fused": 1, "stage_fused_frozen": 2,
    "proj_fused_save": 1, "proj_fused_bwd": 1, "block_fused_save": 2, "block_fused_bwd": 2,
}
EXPECTED_FROZEN_EVAL_LAUNCHES = {
    **_NONE, "stem_fused_packed": 1, "stage_fused": 1, "stage_fused_frozen": 2, "proj_fused": 1, "block_fused": 2,
}
C1_STEPS = 5  # timed steps of the loop phase's compute-only step; the median is kept
# interleaved steps or predicts per fuse setting in the auto phase, in the
# orders of AUTO_ORDERS; the fastest is kept (the steps carry the host's
# jitter: the fine-tune's enqueue takes about as long as its device time,
# and the fastest of 24, and once of 96, came 3-11% apart between settings
# that launch the same kernels)
C1_ROUNDS = 288
# the order of ("on", "off", "auto") in auto-phase round r is
# AUTO_ORDERS[r % 6]: over six rounds each setting runs twice in each
# position and three times after each other setting (a step or predict
# after an "off" one tends to be slower, and rotating one order put "auto"
# after "off" twice as often as "on")
AUTO_ORDERS = ((0, 1, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0), (1, 0, 2), (0, 2, 1))
LOOP_TRAIN, LOOP_VAL = 1024, 160  # rendered examples of the loop phase: 4 train batches, 1 padded val batch
LOOP_VAL_BATCHES = 1
AUTO_SLACK = 0.02  # "auto" may be this much slower than the faster of all "on" and all "off"


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


GPU = ""


def say(msg: str) -> None:
    print(f"{msg}  [{GPU}]", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` back-to-back calls, CUDA events, one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops, nbytes: float, peak: float = PEAK_FLOPS):
    """(ms, what bounds it): the larger of the operations' time at their
    peak and the bytes' at PEAK_BYTES. `flops` is a count at `peak`, or a
    {peak: count} of work that runs at several rates (the times add)."""
    work = flops if isinstance(flops, dict) else {peak: flops}
    t_ops, t_bytes = sum(n / pk for pk, n in work.items()) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ─────────────────────────── phase 1: build ───────────────────────────


def build_phase() -> None:
    from argus_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    took = _build.build()
    say(f"build: {len(took)} of {len(_build.SOURCES)} kernel libraries compiled in "
        f"{time.perf_counter() - t0:.1f} s wall ({', '.join(f'{k} {v:.1f} s' for k, v in took.items())})")
    for name in _build.SOURCES:
        log = _build.log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")


def hgmma_check() -> None:
    """The redesigned kernels run on wgmma: `cuobjdump -sass` of their
    libraries must show HGMMA instructions."""
    import shutil

    from argus_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name in ("basic_fused_bwd", "proj_fused_bwd", "block_fused_bwd", "block_fused_rbwd", "basic_fused",
                 "stage_fused_bwd", "block_fused", "pointwise_bwd", "proj_fused", "stage_fused", "pointwise",
                 "stem_fused_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        n = sass.count("HGMMA")
        say(f"cuobjdump -sass {name}: {n} HGMMA instructions")
        if n == 0:
            raise AssertionError(f"{name}: no wgmma (HGMMA) instruction in its library")


def bf16x2_check() -> None:
    """The augmentation kernel's bf16 instantiations (the resident and the
    streamed form) do their image-dtype ops as packed bf16x2 instructions:
    `cuobjdump -sass` of its library must show them in each (printed beside
    its f32 -> bf16 conversions, one per rounding in the parent's form)."""
    import re
    import shutil
    from collections import Counter

    from argus_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("augment_fused"))], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs = [f for f in re.split(r"\n\s+Function : ", sass)[1:] if "augment_kernel" in f.split("\n", 1)[0]]
    bf = [f for f in funcs if "bfloat16" in f.split("\n", 1)[0]]
    if len(bf) != 2:  # the resident and the streamed form
        raise AssertionError(f"augment_fused: {len(bf)} bf16 instantiations of augment_kernel in its library")
    for f in bf:
        ops = Counter(m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", f))
        packed = {k: v for k, v in ops.items() if k.startswith(("HMUL2", "HADD2", "HFMA2", "HMNMX2")) and "BF16" in k}
        conv = {k: v for k, v in ops.items() if k.startswith("F2F")}
        head = f.split("\n", 1)[0]  # the mangled name: kStream is its Lb0E / Lb1E
        form = "streamed" if "Lb1E" in head or "true" in head else "resident"
        say(f"cuobjdump -sass augment_fused bf16 ({form}): {sum(ops.values())} instructions, packed bf16x2 "
            f"{packed}, conversions {conv}")
        if not any(k.startswith("HMUL2") for k in packed) or not any(k.startswith(("HADD2", "HFMA2")) for k in packed):
            raise AssertionError(f"augment_fused: no packed bf16x2 product or sum in its bf16 {form} instantiation")


# ─────────────────────────── phase 2: kernels ───────────────────────────


def _w(g, *shape):
    import torch

    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    return (torch.randn(*shape, generator=g, device="cuda") / fan_in**0.5).to(torch.bfloat16)


def _b(g, c):
    import torch

    return 0.1 * torch.randn(1, c, generator=g, device="cuda")


def _id_weights(g, c, f):
    return (_w(g, c, f), _b(g, f), _w(g, 3, 3, f, f), _b(g, f), _w(g, f, c), _b(g, c))


def _proj_weights(g, cin, f, cout):
    return (_w(g, cin, f), _b(g, f), _w(g, 3, 3, f, f), _b(g, f), _w(g, f, cout), _b(g, cout),
            _w(g, cin, cout), _b(g, cout))


def _lib_conv(x, w, stride=1, padding=0):
    """cuDNN conv of an NHWC bf16 activation with an HWIO or (CIN, COUT)
    weight, in channels-last layout; returns NHWC bf16."""
    import torch
    import torch.nn.functional as F

    if w.ndim == 2:
        w = w.reshape(1, 1, *w.shape)
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(x.permute(0, 3, 1, 2), wt, stride=stride, padding=padding).permute(0, 2, 3, 1)


def _lib_block(x, w1, b1, w2, b2, w3, b3, wsc=None, bsc=None, stride=1):
    import torch

    dt = x.dtype
    h1 = torch.relu(_lib_conv(x, w1) + b1.reshape(-1).to(dt))
    h2 = torch.relu(_lib_conv(h1, w2, stride, 1) + b2.reshape(-1).to(dt))
    y = _lib_conv(h2, w3) + b3.reshape(-1).to(dt)
    res = x if wsc is None else _lib_conv(x, wsc, stride) + bsc.reshape(-1).to(dt)
    return torch.relu(y + res)


def _block_flops(n, h, w, cin, f, cout, s, proj):
    ho, wo = h // s, w // s
    fl = 2 * n * (h * w * cin * f + ho * wo * (9 * f * f + f * cout))
    return fl + (2 * n * ho * wo * cin * cout if proj else 0)


def _round_trip_bytes(n, h, w, f, s):
    """Device-memory bytes a block's h1 (n, h, w, f) and h2 (n, h/s, w/s, f)
    cost today: each written once and read back once."""
    return 2 * BF * n * f * (h * w + (h // s) * (w // s))


def _compare(name, got, want) -> float:
    if isinstance(want, (tuple, list)):  # several outputs: each held to the tolerance
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} outputs, plain version {len(want)}")
        return max(_compare(f"{name}[{i}]", a, b) for i, (a, b) in enumerate(zip(got, want)))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    if not (err <= TOL_REL * ref + TOL_ABS) or not got.isfinite().all():
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {TOL_REL} * {ref} + {TOL_ABS}")
    return err


def _recorder(results: dict):
    def record(name, cases):
        """cases: [(label, count per predict or step, kernel fn, plain fn, library
        fn, flops, bytes, device kernels per call (at most: a weight gradient's
        partial sums are one more where it splits), bytes of intermediates
        written to device memory and
        read back (a saving forward's h1/h2 are outputs, only their reads
        count; a backward's m1/m2 and the chain's cotangents both ways))]"""
        entry = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
        for label, count, kern, plain, lib, flops, nb, gemms, extra in cases:
            err = _compare(f"{name} {label}", kern(), plain())
            ms, pms, lms = cuda_ms(kern, 5), cuda_ms(plain, 2), cuda_ms(lib, 5)
            b, by = bound_ms(flops, nb)
            say(f"{name} {label} x{count}: max_abs_err {err:.4g}, kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                f"library {lms:.3f} ms, bound {b:.3f} ms ({by}), {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{gemms} device kernels per call, intermediates {extra / 1e9:.2f} GB written and read back")
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("flops", flops), ("bytes", nb)):
                entry[k] += count * v
        results[name] = entry

    return record


def kernel_phase() -> dict:
    """Per-kernel check and timing at the serving shapes. Returns the
    measured entries keyed by kernel name; proj/block times are totals over
    the calls one predict makes (3 projection blocks, 3 + 5 + 2 identity
    blocks)."""
    import torch

    from argus_tpu_torch.ops.kernels import block_fused, proj_fused, stage_fused, stem_fused

    torch.backends.cudnn.allow_tf32 = False  # the plain f32 reference convs run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"kernel phase: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}; library_ms is bf16 cuDNN")
    g = torch.Generator(device="cuda").manual_seed(0)
    results = {}

    record = _recorder(results)

    # stem: (N, 256, 256, 3) -> (N, 64, 64, 64)
    x = torch.rand(N_IMG, HW, HW, 3, generator=g, device="cuda").to(torch.bfloat16)
    w7 = _w(g, 7, 7, 3, 64)
    b7 = _b(g, 64)
    out = stem_fused.stem_pool(x, w7, b7)

    def lib_stem():
        import torch.nn.functional as F

        y = torch.relu(_lib_conv(x, w7, 2, 3) + b7.reshape(-1).to(torch.bfloat16))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    record("stem_fused", [(
        f"{tuple(x.shape)}", 1, lambda: stem_fused.stem_pool(x, w7, b7),
        lambda: stem_fused.stem_pool_plain(x, w7, b7), lib_stem,
        2 * N_IMG * (HW // 2) ** 2 * 64 * 147, nbytes(x, w7, b7, out), 1, 0,
    )])
    del x, out

    # stage-0 chain: (N, 64, 64, 64) -> (N, 64, 64, 256)
    x0 = torch.rand(N_IMG, 64, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    p0 = _proj_weights(g, 64, 64, 256)
    ids0 = [_id_weights(g, 256, 64) for _ in range(2)]
    flops0 = _block_flops(N_IMG, 64, 64, 64, 64, 256, 1, True) + 2 * _block_flops(
        N_IMG, 64, 64, 256, 64, 256, 1, False)

    def lib_stage():
        y = _lib_block(x0, *p0[:6], p0[6], p0[7])
        for w in ids0:
            y = _lib_block(y, *w)
        return y

    out_bytes = N_IMG * 64 * 64 * 256 * BF
    record("stage_fused", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: stage_fused.fused_stage(x0, p0, ids0, 1),
        lambda: stage_fused.stage_plain(x0, p0, ids0, 1), lib_stage,
        flops0, nbytes(x0, *p0, *[t for w in ids0 for t in w]) + out_bytes, 9,
        3 * _round_trip_bytes(N_IMG, 64, 64, 64, 1) + 2 * 2 * out_bytes,  # + 2 block boundaries
    )])
    del x0

    # stage 1-3 entries and identity blocks
    proj_cases, id_cases = [], []
    for i, (h, cin, f, n_id) in enumerate([(64, 256, 128, 3), (32, 512, 256, 5), (16, 1024, 512, 2)]):
        cout, ho = 4 * f, h // 2
        xp = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = _proj_weights(g, cin, f, cout)
        proj_cases.append((
            f"stage{i + 1} {tuple(xp.shape)} F={f}", 1,
            lambda xp=xp, pw=pw: proj_fused.projection_block(xp, *pw, 2),
            lambda xp=xp, pw=pw: proj_fused.projection_block_plain(xp, *pw, 2),
            lambda xp=xp, pw=pw: _lib_block(xp, *pw[:6], pw[6], pw[7], stride=2),
            _block_flops(N_IMG, h, h, cin, f, cout, 2, True),
            nbytes(xp, *pw) + N_IMG * ho * ho * cout * BF, 3,
            _round_trip_bytes(N_IMG, h, h, f, 2),
        ))
        xi = torch.rand(N_IMG, ho, ho, cout, generator=g, device="cuda").to(torch.bfloat16)
        iw = _id_weights(g, cout, f)
        id_cases.append((
            f"stage{i + 1} {tuple(xi.shape)} F={f}", n_id,
            lambda xi=xi, iw=iw: block_fused.bottleneck_block(xi, *iw),
            lambda xi=xi, iw=iw: block_fused.bottleneck_block_plain(xi, *iw),
            lambda xi=xi, iw=iw: _lib_block(xi, *iw),
            _block_flops(N_IMG, ho, ho, cout, f, cout, 1, False),
            2 * nbytes(xi) + nbytes(*iw), 3, _round_trip_bytes(N_IMG, ho, ho, f, 1),
        ))
    record("proj_fused", proj_cases)
    record("block_fused", id_cases)
    del proj_cases, id_cases
    torch.cuda.empty_cache()
    return results


# ─────────────────────────── phase 3: end to end ───────────────────────────


def _randomize_(model, seed: int, last_bn: str = "BatchNorm_2", out_layer: str = "head_out") -> None:
    """Seeded random weights: lecun-normal convs and dense layers, BN scales,
    biases, means and variances all randomised (`last_bn`, the last BN of
    each residual block, at a smaller scale so the residual stack keeps
    activations O(1): BatchNorm_2 of a bottleneck, BatchNorm_1 of a
    BasicBlock), LayerNorm scales and biases randomised; the output layer
    gets a gain of 8, so the se(3) outputs (and the pose comparison) are
    O(1) rather than O(0.1), or the keypoint heatmaps peak at a few pixels
    and the corners spread over the image."""
    import torch

    from argus_tpu_torch.models.keypoint_net import HeadLayerNorm
    from argus_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                lo, hi = (0.1, 0.3) if name.endswith(last_bn) else (0.5, 1.5)
                mod.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
            elif isinstance(mod, HeadLayerNorm):
                c = mod.weight.shape[0]
                mod.weight.copy_(0.5 + torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
            elif hasattr(mod, "weight") and isinstance(mod.weight, torch.nn.Parameter):
                w = mod.weight
                fan_in = w[0].numel()
                gain = 8.0 if name == out_layer else 1.0
                w.copy_(gain * torch.randn(w.shape, generator=g) / fan_in**0.5)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=g))


def end_to_end_phase(tmpdir: str) -> tuple:
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.serve import Estimator

    cfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50")
    model = NCameraCNN(cfg)
    _randomize_(model, seed=0)
    params, stats = variables_from_state_dict(model.state_dict())
    ckpt = os.path.join(tmpdir, "resnet50_random.ckpt")
    meta = {"model_type": "pose_cnn", "model_config": dataclasses.asdict(cfg), "center_crop": [HW, HW]}
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats}, meta=meta)
    del model, params, stats

    t0 = time.perf_counter()
    est = Estimator(ckpt, batch_size=N_ROWS)
    frames = np.random.default_rng(0).integers(0, 256, (N_ROWS, HW, HW, 6), dtype=np.uint8)
    for k in FUSE_ON:  # every kernel of the path launches here; the auto phase times "auto"
        setattr(est.model.backbone, k, "on")
    est.predict(frames)
    say(f"end to end: Estimator(batch_size={N_ROWS}) on {est.device} built and warmed in "
        f"{time.perf_counter() - t0:.1f} s; config dtype={est.cfg.dtype}, fuse flags {est.cfg.fuse_stem} "
        f"(set to 'on')")

    kernels.reset_launch_counts()
    poses = est.predict(frames)
    launches = kernels.launch_counts()
    say(f"end to end: launches in one predict {launches}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"launch counts {launches} != expected {EXPECTED_LAUNCHES}")
    if poses.shape != (N_ROWS, 7) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    qnorm = np.linalg.norm(poses[:, 3:], axis=-1)
    if not np.allclose(qnorm, 1.0, atol=1e-2):
        raise AssertionError(f"quaternions not unit: {qnorm.min()}..{qnorm.max()}")

    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        est.predict(frames)
    ms = (time.perf_counter() - t0) / reps * 1e3
    say(f"end to end: {ms:.2f} ms per predict of {N_ROWS} rows = {N_ROWS / ms * 1e3:.1f} rows/s, "
        f"{N_IMG / ms * 1e3:.1f} camera-images/s (host clock, uint8 numpy in, poses numpy out)")
    # where a predict's time goes: the uint8 upload (host clock) and the
    # model forward on a resident batch (CUDA events)
    t0 = time.perf_counter()
    for _ in range(reps):
        on_card = torch.from_numpy(frames).to("cuda")
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) / reps * 1e3
    with torch.inference_mode():
        images = on_card.float() / 255.0
        forward_ms = cuda_ms(lambda: est.model(images), reps)
    say(f"end to end breakdown: uint8 upload {upload_ms:.2f} ms (pageable, {frames.nbytes / 1e6:.0f} MB), "
        f"model forward {forward_ms:.2f} ms on the card; together {upload_ms + forward_ms:.2f} ms "
        f"of the {ms:.2f} ms predict (separate runs, so the two may not add up exactly)")

    t0 = time.perf_counter()
    cpu = Estimator(ckpt, batch_size=8, device="cpu")
    ref = cpu.predict(frames[:8])
    err = float(np.abs(poses[:8] - ref).max())
    say(f"end to end: GPU vs CPU poses on the first 8 rows: max abs diff {err:.4g} (atol {POSE_ATOL}), "
        f"|pose| max {float(np.abs(ref).max()):.3g}, CPU estimator {time.perf_counter() - t0:.1f} s")
    if not err <= POSE_ATOL:
        raise AssertionError(f"GPU poses differ from the CPU estimator by {err} > {POSE_ATOL}")
    return launches, ms


# ─────────────────────── phase 4: training kernels ───────────────────────


def _lib_bwd(fn, args, g):
    """The autograd backward of the cuDNN composition `fn(*args)` for the
    output gradient g, w.r.t. the bf16 arguments (x and the weights; the f32
    biases are constants), re-run on one recorded graph (retain_graph)."""
    import torch

    args = [t.detach().requires_grad_(t.dtype == torch.bfloat16) for t in args]
    out = fn(*args)
    leaves = [t for t in args if t.requires_grad]
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def _flat(res):
    """(dx, dws...) or the chain's (dx, proj dws, [id dws]) as one list."""
    dx, *rest = res
    out = [dx]
    for r in rest:
        if isinstance(r, (tuple, list)) and r and isinstance(r[0], (tuple, list)):
            out += [t for ds in r for t in ds]
        elif isinstance(r, (tuple, list)):
            out += list(r)
        else:
            out.append(r)
    return out


def train_kernel_phase() -> dict:
    """Each saving forward and one-pass backward at the shapes of the flagship
    train step, against its plain version; times per step (3 projection
    blocks, 3 + 5 + 2 identity blocks). A backward's FLOPs are twice the
    forward's (a data and a weight gradient per conv); its bytes count x, g,
    out, h1, h2 and the weights read once, dx and the f32 dw written once."""
    import torch

    from argus_tpu_torch.ops.kernels import block_fused, proj_fused, stage_fused

    g = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    record = _recorder(results)

    def grad_like(t):
        return torch.randn(t.shape, generator=g, device="cuda").to(torch.bfloat16)

    def dw_bytes(*ws):
        return sum(t.numel() * 4 for t in ws)

    # stage-0 chain: (N, 64, 64, 64) -> (N, 64, 64, 256), projection + 2 identity blocks
    x0 = torch.rand(N_IMG, 64, 64, 64, generator=g, device="cuda").to(torch.bfloat16)
    p0 = _proj_weights(g, 64, 64, 256)
    ids0 = [_id_weights(g, 256, 64) for _ in range(2)]
    wts0 = [t for t in p0] + [t for w in ids0 for t in w]
    flops0 = _block_flops(N_IMG, 64, 64, 64, 64, 256, 1, True) + 2 * _block_flops(
        N_IMG, 64, 64, 256, 64, 256, 1, False)
    out, bnds, h1s, h2s = stage_fused.fused_stage_save(x0, p0, ids0, 1)
    saved_bytes = nbytes(out, *bnds, *h1s, *h2s)

    def lib_stage(x, *w):
        y = _lib_block(x, *w[:8])
        for j in range(2):
            y = _lib_block(y, *w[8 + 6 * j: 14 + 6 * j])
        return y

    record("stage_fused_save", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: stage_fused.fused_stage_save(x0, p0, ids0, 1),
        lambda: stage_fused.stage_save_plain(x0, p0, ids0, 1), lambda: lib_stage(x0, *wts0),
        flops0, nbytes(x0, *wts0) + saved_bytes, 9,
        nbytes(*h1s, *h2s, *bnds),
    )])
    g0 = grad_like(out)
    pw0 = (p0[0], p0[2], p0[4], p0[6])
    iw0 = [(w[0], w[2], w[4]) for w in ids0]
    bwd_args = (x0, g0, out, bnds, h1s, h2s, pw0, iw0, 1)
    dws0 = [t for t in pw0] + [t for w in iw0 for t in w]
    record("stage_fused_bwd", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: _flat(stage_fused.stage_bwd(*bwd_args)),
        lambda: _flat(stage_fused.stage_bwd_plain(*bwd_args)), _lib_bwd(lib_stage, [x0, *wts0], g0),
        2 * flops0, nbytes(x0, g0, out, *bnds, *h1s, *h2s, *dws0) + nbytes(x0) + dw_bytes(*dws0),
        1 + 2 * 6 + 7, 3 * _round_trip_bytes(N_IMG, 64, 64, 64, 1) + 3 * 2 * nbytes(g0),
    )])
    del x0, out, bnds, h1s, h2s, g0, bwd_args
    torch.cuda.empty_cache()

    proj_save, proj_bwd, id_save, id_bwd = [], [], [], []
    for i, (h, cin, f, n_id) in enumerate([(64, 256, 128, 3), (32, 512, 256, 5), (16, 1024, 512, 2)]):
        cout, ho = 4 * f, h // 2
        xp = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        pw = _proj_weights(g, cin, f, cout)
        fl = _block_flops(N_IMG, h, h, cin, f, cout, 2, True)
        saved = proj_fused.projection_block_save(xp, *pw, 2)
        label = f"stage{i + 1} {tuple(xp.shape)} F={f}"
        proj_save.append((
            label, 1, lambda xp=xp, pw=pw: proj_fused.projection_block_save(xp, *pw, 2),
            lambda xp=xp, pw=pw: proj_fused.projection_block_save_plain(xp, *pw, 2),
            lambda xp=xp, pw=pw: _lib_block(xp, *pw[:6], pw[6], pw[7], stride=2),
            fl, nbytes(xp, *pw, *saved), 3, _round_trip_bytes(N_IMG, h, h, f, 2) // 2,
        ))
        gp = grad_like(saved[0])
        args = (xp, gp, *saved, pw[0], pw[2], pw[4], pw[6], 2)
        proj_bwd.append((
            label, 1, lambda args=args: proj_fused.proj_bwd(*args),
            lambda args=args: proj_fused.proj_bwd_plain(*args),
            _lib_bwd(lambda x, *w: _lib_block(x, *w[:6], w[6], w[7], stride=2), [xp, *pw], gp),
            2 * fl, nbytes(xp, gp, *saved, pw[0], pw[2], pw[4], pw[6]) + nbytes(xp)
            + dw_bytes(pw[0], pw[2], pw[4], pw[6]), 18, _round_trip_bytes(N_IMG, h, h, f, 2) + 2 * nbytes(gp),
        ))
        xi = torch.rand(N_IMG, ho, ho, cout, generator=g, device="cuda").to(torch.bfloat16)
        iw = _id_weights(g, cout, f)
        fl = _block_flops(N_IMG, ho, ho, cout, f, cout, 1, False)
        saved = block_fused.bottleneck_block_save(xi, *iw)
        label = f"stage{i + 1} {tuple(xi.shape)} F={f}"
        id_save.append((
            label, n_id, lambda xi=xi, iw=iw: block_fused.bottleneck_block_save(xi, *iw),
            lambda xi=xi, iw=iw: block_fused.bottleneck_block_save_plain(xi, *iw),
            lambda xi=xi, iw=iw: _lib_block(xi, *iw), fl, nbytes(xi, *iw, *saved), 3,
            _round_trip_bytes(N_IMG, ho, ho, f, 1) // 2,
        ))
        gi = grad_like(saved[0])
        args = (xi, gi, *saved, iw[0], iw[2], iw[4])
        id_bwd.append((
            label, n_id, lambda args=args: block_fused.block_bwd(*args),
            lambda args=args: block_fused.block_bwd_plain(*args),
            _lib_bwd(_lib_block, [xi, *iw], gi),
            2 * fl, nbytes(xi, gi, *saved, iw[0], iw[2], iw[4]) + nbytes(xi)
            + dw_bytes(iw[0], iw[2], iw[4]), 10, _round_trip_bytes(N_IMG, ho, ho, f, 1) + 2 * nbytes(gi),
        ))
    record("proj_fused_save", proj_save)
    record("proj_fused_bwd", proj_bwd)
    record("block_fused_save", id_save)
    record("block_fused_bwd", id_bwd)
    del proj_save, proj_bwd, id_save, id_bwd
    torch.cuda.empty_cache()
    return results


def _lib_basic(x, w1, b1, w2, b2):
    """The identity BasicBlock as a cuDNN bf16 composition."""
    import torch

    dt = x.dtype
    h1 = torch.relu(_lib_conv(x, w1, 1, 1) + b1.reshape(-1).to(dt))
    return torch.relu(_lib_conv(h1, w2, 1, 1) + b2.reshape(-1).to(dt) + x)


def basic_kernel_phase() -> dict:
    """The three BasicBlock kernels (no-save forward, saving forward, one-pass
    backward) at the four geometries of ResNet-18's identity blocks at N =
    512, 256x256, against their plain versions; times per eval forward or
    train step (2 blocks at stage 0, 1 at each of stages 1-3). Each conv is
    N*H*W*9*C^2 MACs; the backward is four GEMMs of that size (a data and a
    weight gradient per conv); its bytes count x, g, out, h1 and the weights
    read once, dx and the f32 dw written once."""
    import torch

    from argus_tpu_torch.ops.kernels import basic_fused

    g = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    record = _recorder(results)
    fwd, save, bwd = [], [], []
    for c, h, count in BASIC_GEOMETRIES:
        x = torch.rand(N_IMG, h, h, c, generator=g, device="cuda").to(torch.bfloat16)
        ws = (_w(g, 3, 3, c, c), _b(g, c), _w(g, 3, 3, c, c), _b(g, c))
        conv = 2 * N_IMG * h * h * 9 * c * c
        act = nbytes(x)
        label = f"{tuple(x.shape)}"
        fwd.append((
            label, count, lambda x=x, ws=ws: basic_fused.basic_block(x, *ws),
            lambda x=x, ws=ws: basic_fused.basic_fwd_plain(x, *ws, save=False),
            lambda x=x, ws=ws: _lib_basic(x, *ws), 2 * conv, 2 * act + nbytes(*ws), 2, 2 * act,
        ))
        save.append((
            label, count, lambda x=x, ws=ws: basic_fused.basic_block_save(x, *ws),
            lambda x=x, ws=ws: basic_fused.basic_fwd_plain(x, *ws, save=True),
            lambda x=x, ws=ws: _lib_basic(x, *ws), 2 * conv, 3 * act + nbytes(*ws), 2, act,
        ))
        out, h1 = basic_fused.basic_block_save(x, *ws)
        gr = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
        args = (x, gr, out, h1, ws[0], ws[2])
        bwd.append((
            label, count, lambda args=args: basic_fused.basic_bwd(*args),
            lambda args=args: basic_fused.basic_bwd_plain(*args), _lib_bwd(_lib_basic, [x, *ws], gr),
            4 * conv, 5 * act + nbytes(ws[0], ws[2]) + 2 * 4 * ws[0].numel(), 7, 4 * act,
        ))
    record("basic_fused", fwd)
    record("basic_fused_save", save)
    record("basic_fused_bwd", bwd)
    del fwd, save, bwd
    torch.cuda.empty_cache()
    return results


@functools.cache
def _timing_script():
    """scripts/time_torch_block_bwd.py as a module (its cases, breakdown and
    ResNet-50's BN inputs), scripts/ kept off sys.path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("time_torch_block_bwd",
                                                  os.path.join(REPO, "scripts", "time_torch_block_bwd.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def engine_phase() -> None:
    """The redesigned kernels (the BasicBlock, projection, identity and
    recompute backwards, the stage-0 chain's backward, the BasicBlock,
    identity and projection forwards, the chain forwards, the pointwise
    backward and forward on the Hopper engines; the BN reductions as one
    launch) beside the form they had before (`ops/kernels/bwd_prev.py`), at
    the geometries of scripts/time_torch_block_bwd.py, in this call: ms per
    call (CUDA events, 5 calls) and each call's device kernels by launch
    (torch.profiler), and the ms per train step of each (the recompute's per
    configuration R step, the BasicBlock forward's per eval forward, the
    pointwise kernels' per configuration P step, the frozen chains' per
    frozen_stages=3 step, the BN reductions' per Path B step; stage 0's
    identity geometry runs in the chain, 0 a step; the identity and
    projection forwards' per step is also their time per predict)."""
    import torch

    tbb = _timing_script()

    got = {}
    for engine in ("prev", "new"):
        for row, label, count, fn in tbb.cases(engine):
            ms, _ = tbb.cuda_ms(fn, 5)
            parts = tbb.breakdown(fn)
            got.setdefault((row, label), {})[engine] = (ms, count)
            say(f"{'previous' if engine == 'prev' else 'redesigned'} {row} {label} x{count}: {ms:.3f} ms per call; "
                f"{tbb.fmt(parts)}")
        torch.cuda.empty_cache()
    step = {}
    for (row, label), d in got.items():
        (pms, count), (nms, _) = d["prev"], d["new"]
        say(f"{row} {label}: {nms:.3f} ms redesigned against {pms:.3f} ms in the previous form ({pms / nms:.2f}x)")
        prev, new = step.get(row, (0.0, 0.0))
        step[row] = (prev + count * pms, new + count * nms)
    per = {"block_fused_rbwd": "R step", "basic_fused": "eval forward", "pointwise_bwd": "P step",
           "pointwise": "P step", "stage_fused_frozen": "frozen_stages=3 step", "bn_stats": "Path B step",
           "bn_bwd_reduce": "Path B step"}
    for row, (pms, nms) in step.items():
        say(f"{row} per {per.get(row, 'train step')}: {nms:.2f} ms redesigned against {pms:.2f} ms "
            f"({pms / nms:.2f}x)")


def device_ms(fn, reps: int):
    """(device ms per launch or None, {device kernel: launches}) of `reps`
    calls of `fn` after a warm-up, from torch.profiler's kernel records. On
    this card's PyTorch a profiled window now and then loses records (a
    launch, or the whole window, sometimes several windows in a row): the
    time is per recorded launch, and a window with no record is read again,
    up to five times; None when none had a record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, counts = 0.0, {}
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None)
            t = getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
            if t > 0:
                us += t
                counts[ev.key] = counts.get(ev.key, 0) + ev.count
        if counts:
            return us / 1e3 / sum(counts.values()), counts
    return None, {}


def host_us(fn, reps: int) -> float:
    """µs of the host per call of `fn`, `reps` calls enqueued back to back
    after ten (the device kept busy by the first ones; synchronized
    after)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return us


def _ulp_compare(name, got, want) -> float:
    """bf16 outputs bit-equal or one bf16 ulp apart (or both within f32
    rounding of zero)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    import torch

    a, b = got.float(), want.float()
    err = (a - b).abs()
    bad = int((err > STEM_ULP * torch.maximum(a.abs(), b.abs()) + STEM_ZERO * b.abs().max()).sum())
    off = int((err > 0).sum())
    say(f"{name}: {off} of {a.numel()} elements differ from the plain version, {bad} by more than one bf16 ulp; "
        f"max |diff| {err.max().item():.4g}")
    if bad or not got.isfinite().all():
        raise AssertionError(f"{name}: kernel disagrees with its plain version by more than one bf16 ulp")
    return err.max().item()


def stem_bn_kernel_phase() -> dict:
    """The trained stem's two kernels at the flagship's shapes (N = 512,
    256x256) and BatchNorm's two reductions at every distinct (M, C) of
    ResNet-50's 53 BN inputs at N = 512, against their plain versions. The
    stem's saving forward: out and y within one bf16 ulp of the plain
    version's; its weight gradient over all N images and over the first N/4
    (`stem_grad_stride` 4), 2e-2 * max |plain| + 1e-2; library_ms the cuDNN
    composition's forward, and its autograd weight gradient. The BN
    reductions at stride 1 and 4: n_rows equal, sums within BN_RTOL of each
    channel's sum of magnitudes; library_ms `torch.batch_norm_stats` and
    `torch.batch_norm_backward_reduce` on the channels-last view (stride 1;
    mean/invstd and sum dy, sum dy*(x-mean)); each reduction one device
    kernel a call and two calls bit-equal; beside the CUDA-event time (10
    calls) the device time (torch.profiler, 10 calls) and the host's
    enqueue time per call (100 calls). Times per train step: one stem each
    way, each BN shape times its count."""
    import torch
    import torch.nn.functional as F

    from argus_tpu_torch.ops.kernels import bn_reduce, stem_fused

    g = torch.Generator(device="cuda").manual_seed(8)
    results = {}
    bf = torch.bfloat16

    x = torch.rand(N_IMG, HW, HW, 3, generator=g, device="cuda").to(bf)
    w7, b7 = _w(g, 7, 7, 3, 64), _b(g, 64)
    out, y = stem_fused.stem_fwd_save(x, w7, b7)
    pout, py = stem_fused.stem_fwd_save_plain(x, w7, b7)
    err = max(_ulp_compare("stem_fused_save out", out, pout), _ulp_compare("stem_fused_save y", y, py))
    del pout, py
    conv_flops = 2 * N_IMG * (HW // 2) ** 2 * 64 * 147

    def lib_fwd(w):
        yl = torch.relu(_lib_conv(x, w, 2, 3) + b7.reshape(-1).to(bf))
        return F.max_pool2d(yl.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    ms = cuda_ms(lambda: stem_fused.stem_fwd_save(x, w7, b7), 5)
    pms = cuda_ms(lambda: stem_fused.stem_fwd_save_plain(x, w7, b7), 2)
    lms = cuda_ms(lambda: lib_fwd(w7), 5)
    nb = nbytes(x, w7, b7, out, y)
    b, by = bound_ms(conv_flops, nb)
    say(f"stem_fused_save {tuple(x.shape)} x1: kernel {ms:.3f} ms, plain {pms:.3f} ms, library {lms:.3f} ms, bound "
        f"{b:.3f} ms ({by}), {nb / ms / 1e6:.0f} GB/s")
    results["stem_fused_save"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, flops=conv_flops, bytes=nb)

    gr = torch.randn(out.shape, generator=g, device="cuda").to(bf)
    wl = w7.detach().requires_grad_(True)
    lib_out = lib_fwd(wl)
    entry = dict(max_abs_err=0.0)
    for n_images in (N_IMG, N_IMG // 4):
        kern = lambda n=n_images: stem_fused.stem_bwd(x, gr, out, y, n)  # noqa: E731
        plain = lambda n=n_images: stem_fused.stem_bwd_plain(x, gr, out, y, n)  # noqa: E731
        got = kern()
        e = _compare(f"stem_fused_bwd n_images={n_images}", got, plain())
        if not torch.equal(got, kern()):
            raise AssertionError(f"stem_fused_bwd n_images={n_images}: two calls on the same input differ")
        ms, pms = cuda_ms(kern, 5), cuda_ms(plain, 2)
        if n_images == N_IMG:
            lib = lambda: torch.autograd.grad(lib_out, [wl], gr, retain_graph=True)  # noqa: E731
            lms = cuda_ms(lib, 5)
        else:
            lms = None
        fl = conv_flops * n_images // N_IMG
        nb = nbytes(x, gr, out, y) * n_images // N_IMG + 147 * 64 * 4
        b, by = bound_ms(fl, nb)
        say(f"stem_fused_bwd n_images={n_images} x1: max_abs_err {e:.4g}, kernel {ms:.3f} ms, plain {pms:.3f} ms, "
            f"library {'-' if lms is None else f'{lms:.3f}'} ms (autograd dW of the cuDNN composition, all images), "
            f"bound {b:.3f} ms ({by}), {nb / ms / 1e6:.0f} GB/s")
        entry["max_abs_err"] = max(entry["max_abs_err"], e)
        if n_images == N_IMG:
            entry.update(ms=ms, plain_ms=pms, library_ms=lms, flops=fl, bytes=nb)
    results["stem_fused_bwd"] = entry
    del x, out, y, gr, lib_out, wl
    # a size that is not a whole number of the kernel's 16 x 16 tiles (conv
    # output 100 x 68), and a width whose patch rows go by cp.async (W % 8 != 0)
    for shape in ((16, 200, 136), (16, 200, 132)):
        xs = torch.rand(*shape, 3, generator=g, device="cuda").to(bf)
        os_, ys = stem_fused.stem_fwd_save(xs, w7, b7)
        gs = torch.randn(os_.shape, generator=g, device="cuda").to(bf)
        for n_images in (shape[0], shape[0] // 4):
            got = stem_fused.stem_bwd(xs, gs, os_, ys, n_images)
            entry["max_abs_err"] = max(entry["max_abs_err"], _compare(
                f"stem_fused_bwd {shape} n_images={n_images}", got, stem_fused.stem_bwd_plain(xs, gs, os_, ys, n_images)))
            if not torch.equal(got, stem_fused.stem_bwd(xs, gs, os_, ys, n_images)):
                raise AssertionError(f"stem_fused_bwd {shape} n_images={n_images}: two calls on the same input differ")
    del xs, os_, ys, gs
    torch.cuda.empty_cache()

    def bn_close(name, got, want, scale):
        err = (got - want).abs()
        bad = err > BN_RTOL * scale + 1e-6
        if bool(bad.any()) or not bool(got.isfinite().all()):
            raise AssertionError(f"{name}: {int(bad.sum())} channels beyond {BN_RTOL} of their sum of magnitudes, "
                                 f"max rel {(err / scale.clamp(min=1e-30)).max().item():.3g}")
        return (err / scale.clamp(min=1e-30)).max().item(), err.max().item()

    stats = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, peak=PEAK_F32)
    one_kernel = {"bn_stats": 0, "bn_bwd_reduce": 0}  # cases whose profiled calls showed one stream kernel each
    bwd = dict(stats)
    for m, c, count in _timing_script().bn_inputs(N_IMG, HW):
        side = int(round((m // N_IMG) ** 0.5))
        xb = torch.randn(m, c, generator=g, device="cuda").to(bf)
        dy = torch.randn(m, c, generator=g, device="cuda").to(bf)
        x4 = xb.view(N_IMG, side, side, c).permute(0, 3, 1, 2)
        dy4 = dy.view(N_IMG, side, side, c).permute(0, 3, 1, 2)
        s, q, n = bn_reduce.fused_stats(xb, 1)
        mean = s / n
        rstd = torch.rsqrt(torch.clamp(q / n - mean * mean, min=0.0) + 1e-5)
        for stride in (1, 4):
            R, S, n_rows = bn_reduce.visited_rows(m, c, stride)
            rows = xb if n_rows == m else torch.cat([xb[i * S: i * S + R] for i in range(n_rows // R)])
            drows = dy if n_rows == m else torch.cat([dy[i * S: i * S + R] for i in range(n_rows // R)])
            xa, da = rows.float().abs(), drows.float().abs()
            k_s, k_q, k_n = bn_reduce.fused_stats(xb, stride)
            p_s, p_q, p_n = bn_reduce.fused_stats_plain(xb, stride)
            if k_n != p_n:
                raise AssertionError(f"bn_stats ({m}, {c}) stride {stride}: n_rows {k_n} != plain {p_n}")
            (r1, a1), (r2, a2) = bn_close("bn_stats sum", k_s, p_s, xa.sum(0)), \
                bn_close("bn_stats sumsq", k_q, p_q, (xa * xa).sum(0))
            e1, e1_abs = max(r1, r2), max(a1, a2)
            k_d, k_dx, k_n2 = bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride)
            p_d, p_dx, p_n2 = bn_reduce.fused_bn_bwd_reduce_plain(xb, dy, mean, rstd, stride)
            if k_n2 != p_n2 or k_n2 != k_n:
                raise AssertionError(f"bn_bwd_reduce ({m}, {c}) stride {stride}: n_rows {k_n2} != plain {p_n2}")
            xh = ((rows.float() - mean) * rstd).abs()
            (r1, a1), (r2, a2) = bn_close("bn_bwd_reduce sum dy", k_d, p_d, da.sum(0)), \
                bn_close("bn_bwd_reduce sum dy*xhat", k_dx, p_dx, (da * xh).sum(0))
            e2, e2_abs = max(r1, r2), max(a1, a2)
            again = bn_reduce.fused_stats(xb, stride), bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride)
            if not all(torch.equal(a, b) for a, b in zip((k_s, k_q, k_d, k_dx), again[0][:2] + again[1][:2])):
                raise AssertionError(f"bn ({m}, {c}) stride {stride}: two calls on the same input differ")
            stats["max_abs_err"] = max(stats["max_abs_err"], e1_abs)
            bwd["max_abs_err"] = max(bwd["max_abs_err"], e2_abs)
            del rows, drows, xa, da, xh
            t = [cuda_ms(lambda: bn_reduce.fused_stats(xb, stride), 10),
                 cuda_ms(lambda: bn_reduce.fused_stats_plain(xb, stride), 3),
                 cuda_ms(lambda: bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride), 10),
                 cuda_ms(lambda: bn_reduce.fused_bn_bwd_reduce_plain(xb, dy, mean, rstd, stride), 3)]
            dev = [device_ms(lambda: bn_reduce.fused_stats(xb, stride), 10),
                   device_ms(lambda: bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride), 10)]
            for name, (_, counts) in zip(("bn_stats", "bn_bwd_reduce"), dev):  # one device kernel a call
                if not counts:  # the profiler recorded nothing: not measured here
                    continue
                if len(counts) != 1 or "stream_kernel" not in next(iter(counts)) or sum(counts.values()) > 10:
                    raise AssertionError(f"bn ({m}, {c}) stride {stride} {name}: device kernels of 10 calls {counts}")
                one_kernel[name] += 1
            host = [host_us(lambda: bn_reduce.fused_stats(xb, stride), 100),
                    host_us(lambda: bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride), 100)]
            nb_s, nb_b = n_rows * c * BF + 2 * c * 4, 2 * n_rows * c * BF + 4 * c * 4
            if stride == 1:
                lib_s = cuda_ms(lambda: torch.batch_norm_stats(x4, 1e-5), 10)
                lib_b = cuda_ms(lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, rstd, None, True, False,
                                                                         False), 10)
                # f32 operations per element: x and x*x summed (3); dy summed,
                # (x - mean) * rstd * dy summed (5)
                for d, ms, pms, lms, nb, ops in ((stats, t[0], t[1], lib_s, nb_s, 3), (bwd, t[2], t[3], lib_b, nb_b, 5)):
                    for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bytes", nb),
                                 ("flops", ops * n_rows * c)):
                        d[k] += count * v
            else:
                lib_s = lib_b = None
            dms = ["not measured" if d[0] is None else f"{d[0]:.4f}" for d in dev]
            say(f"bn ({m}, {c}) x{count} stride {stride}: n_rows {k_n}; bn_stats {t[0]:.3f} ms (device "
                f"{dms[0]}, host {host[0]:.1f} us a call; plain {t[1]:.3f}, library "
                f"{'-' if lib_s is None else f'{lib_s:.3f}'}, bound {bound_ms(0, nb_s)[0]:.4f}), bn_bwd_reduce "
                f"{t[2]:.3f} ms (device {dms[1]}, host {host[1]:.1f} us; plain {t[3]:.3f}, library "
                f"{'-' if lib_b is None else f'{lib_b:.3f}'}, bound {bound_ms(0, nb_b)[0]:.4f}); "
                f"{nb_s / 1e6:.1f} MB, max rel err {e1:.3g}, {e2:.3g} (abs {e1_abs:.3g}, {e2_abs:.3g})")
        del xb, dy, x4, dy4
        torch.cuda.empty_cache()
    say(f"bn: one stream kernel a call in the profiled calls of {one_kernel['bn_stats']} / "
        f"{one_kernel['bn_bwd_reduce']} of the 24 cases (the others' windows came back empty)")
    if min(one_kernel.values()) < 12:
        raise AssertionError(f"bn: one kernel a call shown in too few cases {one_kernel}: the profiler recorded little")
    results["bn_stats"], results["bn_bwd_reduce"] = stats, bwd
    say(f"bn per step (53 BNs, stride 1): bn_stats {stats['ms']:.2f} ms (library {stats['library_ms']:.2f}, bound "
        f"{bound_ms(0, stats['bytes'])[0]:.2f}), bn_bwd_reduce {bwd['ms']:.2f} ms (library {bwd['library_ms']:.2f}, "
        f"bound {bound_ms(0, bwd['bytes'])[0]:.2f})")
    return results


# ─────────────────────── phase 5: augmentation ───────────────────────


# The augmentation kernels' bounds count the f32 operations the function
# needs, each op (product, sum, comparison, min, max) one operation; the
# peak counts a fused multiply-add as two, so these bounds are if anything
# low. Per channel element of the blur: 5 + 5 + 9 taps (a product each, one
# sum fewer), and two gates of 3 (two products and a sum).
BLUR_OPS = 41
# Per pixel of the stack, beside the arcs and the upsample (`aug_ops`): the
# gains 9 (a product and a clip of 2 per channel); the jiggle ops by their
# own terms: brightness 9 (a product and a clip a channel), contrast 12 (a
# product, a sum and a clip a channel) and 6 for its luma sum, saturation 20
# (luma 5; two products, a sum and a clip a channel), hue 45; the blurs 3 x
# BLUR_OPS; the field's min and max 2; its normalisation, threshold and
# shade 7 (a difference, a quotient, a comparison, a product, a sum, a clip).
AUG_PIXEL_OPS = 9 + (9 + 12 + 6 + 20 + 45) + 3 * BLUR_OPS + 2 + 7
# Of those, the ones in the image dtype (the kernel's packed bf16x2
# instructions on bf16 images): the gains, brightness, contrast and
# saturation, the luma of the contrast's sum (5 of its 6: the sum is f32),
# the blurs, and the shade's sum and clip (3 of its 7). The hue, the luma
# sum, the field's min and max and the plasma's normalisation, threshold and
# shade product stay f32, as do the arcs and the upsample.
AUG_IMAGE_OPS = 9 + (9 + 12 + 5 + 20) + 3 * BLUR_OPS + 3


def arc_ops(arcs, H: int, W: int) -> int:
    """Operations of the arc test on this run's arcs (N, n_arcs, 10): per
    pixel and arc while the pixel is on no earlier arc, 9 for the ring test
    (two offsets, two scalings, the squared radius, two comparisons), and 11
    more where it is on the ring (two cross products, their signs, the sweep
    test)."""
    import torch

    yy = torch.arange(H, dtype=torch.float32, device=arcs.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=arcs.device)[None, :]
    done = torch.zeros((arcs.shape[0], H, W), dtype=torch.bool, device=arcs.device)
    ops = 0
    for i in range(arcs.shape[1]):
        cx, cy, irx, iry, hws, ux, uy, vx, vy, wide = (arcs[:, i, k, None, None] for k in range(10))
        dx, dy = (xx - cx) * irx, (yy - cy) * iry
        rho2 = dx * dx + dy * dy
        lo = torch.clamp(1.0 - hws, min=0.0)
        ring = ~done & (rho2 > lo * lo) & (rho2 < (1.0 + hws) * (1.0 + hws))
        ops += 9 * int((~done).sum()) + 11 * int(ring.sum())
        pos_u, pos_v = (ux * dy - uy * dx) >= 0, (dx * vy - dy * vx) >= 0
        done |= ring & ((pos_u & pos_v) | ((wide > 0.5) & (pos_u | pos_v)))
    return ops


def aug_ops(field, mh, mwt, packed, n_arcs: int) -> tuple:
    """(image-dtype, f32) operations the whole stack needs on this run's
    operands: AUG_PIXEL_OPS a pixel (AUG_IMAGE_OPS of them in the image
    dtype), the arcs (`arc_ops`), and the bilinear upsample mh @ field @ mwt
    over the nonzero entries of mh's rows and mwt's columns (two at most: a
    product each, one sum fewer)."""
    n, H, W, S = field.shape[0], mh.shape[0], mwt.shape[1], field.shape[-1]
    taps = lambda nz: int((2 * nz - 1).clamp(min=0).sum())  # noqa: E731
    upsample = n * (S * taps((mh != 0).sum(1)) + H * taps((mwt != 0).sum(0)))
    arcs = packed[:, :10 * n_arcs].reshape(n, n_arcs, 10)
    image = n * H * W * AUG_IMAGE_OPS
    return image, n * H * W * (AUG_PIXEL_OPS - AUG_IMAGE_OPS) + upsample + arc_ops(arcs, H, W)


def _aug_compare(label: str, got, want, dt: str) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} {want.dtype}")
    err = (got.float() - want.float()).abs()
    mx, mean = err.max().item(), err.mean().item()
    tol_max, tol_mean = AUG_TOL[dt]
    say(f"{label}: max |kernel - plain| {mx:.4g} (tol {tol_max}), mean {mean:.3g} (tol {tol_mean})")
    if not (mx <= tol_max and mean <= tol_mean) or not got.isfinite().all():
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return mx


def _nhwc(per_cam):
    n = per_cam.shape[0] // 2
    return per_cam.reshape(n, 2, 3, HW, HW).permute(0, 3, 4, 1, 2).reshape(n, HW, HW, 6).contiguous()


def augment_phase() -> tuple:
    """The two augmentation kernels against their plain versions, the two
    paths' launches, and the fused path against the per-op path. Returns
    (measured entries, launches of each path's run)."""
    import torch
    import torch.nn.functional as F

    from argus_tpu_torch.ops import augment as TA
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.ops.kernels import augment_fused as kaf
    from argus_tpu_torch.ops.kernels import blur as kb

    g = torch.Generator(device="cuda").manual_seed(4)
    cfg = TA.AugmentationConfig()
    x = {"f32": torch.rand(N_IMG, 3, HW, HW, generator=g, device="cuda")}
    x["bf16"] = x["f32"].to(torch.bfloat16)
    params = {dt: TA.sample_params(cfg, 11, N_ROWS, 2, HW, HW, "cuda", x[dt].dtype) for dt in x}
    results = {}

    def fused_case(dt, n_arcs, order=None):
        p = params[dt] if n_arcs else dataclasses.replace(params[dt], arcs=None)
        args = list(TA.pack_fused(p, N_IMG, HW, HW, n_arcs, "cuda"))
        if order is not None:
            args[4] = torch.tensor([order], dtype=torch.int32, device="cuda")
        return (lambda: kaf.fused_augment(x[dt], *args, n_arcs),
                lambda: kaf.fused_augment_plain(x[dt], *args, n_arcs), args)

    worst = 0.0
    for hue_pos in range(4):
        order = [1, 0, 2]
        order.insert(hue_pos, 3)
        for n_arcs in (10, 0):
            kern, plain, _ = fused_case("bf16", n_arcs, order)
            worst = max(worst, _aug_compare(f"augment_fused bf16 order {order} {n_arcs} arcs", kern(), plain(),
                                            "bf16"))
    kern, plain, _ = fused_case("f32", 10)
    worst = max(worst, _aug_compare(f"augment_fused f32 order {params['f32'].order.tolist()} 10 arcs", kern(),
                                    plain(), "f32"))
    kern, plain, args = fused_case("bf16", 10)  # the train step's case
    if not torch.equal(kern(), kern()):
        raise AssertionError("augment_fused: two calls on the same input differ")
    # a size the kernel's bands do not divide (203 rows: bands of 26, the last
    # one 21) and an odd width (the shared rows' pad column, the cooperative
    # load); a 512 crop and 1920-wide frames, whose bands do not fit in shared
    # memory (the streamed form: chunks of 41 and 18 rows of 64 at 512x512 in
    # bf16 and f32, the image read twice)
    for dt in ("bf16", "f32"):
        for n, h, w in ((16, 203, 137), (8, 512, 512), (4, 128, 1920)):
            xr = torch.rand(n, 3, h, w, generator=g, device="cuda").to(x[dt].dtype)
            pr = TA.sample_params(cfg, 12, n // 2, 2, h, w, "cuda", xr.dtype)
            ar = TA.pack_fused(pr, n, h, w, 10, "cuda")
            rc = kaf.chunk_rows(h, w, ar[0].shape[-1], 10, xr.element_size())
            got = kaf.fused_augment(xr, *ar, 10)
            if not torch.equal(got, kaf.fused_augment(xr, *ar, 10)):
                raise AssertionError(f"augment_fused {dt} {n} x {h}x{w}: two calls on the same input differ")
            worst = max(worst, _aug_compare(f"augment_fused {dt} {n} x {h}x{w} 10 arcs (chunks of {rc} of "
                                            f"{kaf.band_rows(h)} rows)", got, kaf.fused_augment_plain(xr, *ar, 10),
                                            dt))
    image_ops, f32_ops = aug_ops(*args[:4], 10)
    flops = {PEAK_BF16X2: image_ops, PEAK_F32: f32_ops}  # bf16 images: the image-dtype ops as bf16x2
    nb = 2 * nbytes(x["bf16"]) + nbytes(*args)
    ms, pms = cuda_ms(kern, 10), cuda_ms(plain, 2)
    b, by = bound_ms(flops, nb)
    say(f"augment_fused {tuple(x['bf16'].shape)} bf16 x1: kernel {ms:.3f} ms, plain {pms:.3f} ms, no library "
        f"call, bound {b:.3f} ms ({by}: {image_ops / PEAK_BF16X2 * 1e3:.3f} ms of {image_ops:.3g} image-dtype "
        f"operations at the bf16x2 peak and {f32_ops / PEAK_F32 * 1e3:.3f} ms of {f32_ops:.3g} f32 ones, "
        f"{nb / PEAK_BYTES * 1e3:.3f} ms of bytes), {(image_ops + f32_ops) / ms / 1e9:.1f} TFLOP/s, "
        f"{nb / ms / 1e6:.0f} GB/s")
    results["augment_fused"] = dict(max_abs_err=worst, ms=ms, plain_ms=pms, library_ms=None, flops=flops,
                                    bytes=nb)

    def blur_args(dt):
        (gw, gg), (mk, mg) = params[dt].gauss, params[dt].motion
        return x[dt], gw, mk, torch.stack([gg, mg], 1)

    worst = max(_aug_compare(f"blur {dt}", kb.fused_random_blur(*blur_args(dt)),
                             kb.fused_random_blur_plain(*blur_args(dt)), dt) for dt in ("bf16", "f32"))
    xb, gw, mk, gates = blur_args("bf16")
    c = N_IMG * 3
    wv = gw.repeat_interleave(3, 0).to(xb.dtype)
    wm = mk.repeat_interleave(3, 0).to(xb.dtype)[:, None]
    gg, mg = (gates[:, k].to(xb.dtype).repeat_interleave(3)[None, :, None, None] for k in range(2))

    def lib_blur():
        xx = xb.reshape(1, c, HW, HW)
        g1 = F.conv2d(F.pad(xx, (0, 0, 2, 2), mode="replicate"), wv[:, None, :, None], groups=c)
        g1 = F.conv2d(F.pad(g1, (2, 2, 0, 0), mode="replicate"), wv[:, None, None, :], groups=c)
        g2 = gg * g1 + (1 - gg) * xx
        m = F.conv2d(F.pad(g2, (1, 1, 1, 1), mode="replicate"), wm, groups=c)
        return (mg * m + (1 - mg) * g2).reshape(xb.shape)

    lib_err = (lib_blur().float() - kb.fused_random_blur_plain(xb, gw, mk, gates).float()).abs().max().item()
    ms = cuda_ms(lambda: kb.fused_random_blur(xb, gw, mk, gates), 10)
    pms = cuda_ms(lambda: kb.fused_random_blur_plain(xb, gw, mk, gates), 2)
    lms = cuda_ms(lib_blur, 5)
    flops, nb = BLUR_OPS * xb.numel(), 2 * nbytes(xb) + nbytes(gw, mk, gates)
    b, by = bound_ms(flops, nb, PEAK_F32)
    say(f"blur {tuple(xb.shape)} bf16 x1: kernel {ms:.3f} ms, plain {pms:.3f} ms, library (replicate pad + grouped "
        f"conv2d, max |library - plain| {lib_err:.3g}) {lms:.3f} ms, bound {b:.3f} ms ({by}), "
        f"{nb / ms / 1e6:.0f} GB/s")
    results["blur"] = dict(max_abs_err=worst, ms=ms, plain_ms=pms, library_ms=lms, flops=flops, bytes=nb,
                           peak=PEAK_F32)

    # the two paths through the entry point: launches, then fused vs per-op on the interior
    path_launches = {}
    outs = {}
    for dt in ("bf16", "f32"):
        nhwc = _nhwc(x[dt])
        for name, c_ in (("fused", cfg), ("per-op", dataclasses.replace(cfg, pallas_fused=False))):
            kernels.reset_launch_counts()
            outs[name] = TA.apply_augmentation(c_, 11, nhwc)
            torch.cuda.synchronize()
            if dt == "bf16":
                path_launches[name] = kernels.launch_counts()
        want = {"fused": {**_NONE, "augment_fused": 1}, "per-op": {**_NONE, "blur": 1}}
        if dt == "bf16" and path_launches != want:
            raise AssertionError(f"augmentation launches {path_launches} != expected {want}")
        d = (outs["fused"].float() - outs["per-op"].float())[:, 4:-4, 4:-4].abs()
        mean, far = d.mean().item(), (d > 2e-2).float().mean().item()
        ok = all(bool(((o >= 0) & (o <= 1)).all()) and o.shape == nhwc.shape and o.dtype == nhwc.dtype
                 for o in outs.values())
        say(f"augmentation paths {dt}: launches fused {path_launches['fused']['augment_fused']} augment_fused, "
            f"per-op {path_launches['per-op']['blur']} blur; fused vs per-op interior: mean |diff| {mean:.3g} "
            f"(tol {PATHS_TOL[dt][0]}), share beyond 2e-2 {far:.3g} (tol {PATHS_TOL[dt][1]}), max "
            f"{d.max().item():.3g}; outputs in [0, 1]: {ok}")
        if not (ok and mean <= PATHS_TOL[dt][0] and far <= PATHS_TOL[dt][1]):
            raise AssertionError(f"the fused augmentation path disagrees with the per-op path ({dt})")
    del x, params, outs
    torch.cuda.empty_cache()
    return results, path_launches


# ─────────────────────── phase 6: the train step ───────────────────────


def _grad_errors(got: dict, want: dict):
    """Per-parameter relative 2-norm errors; a parameter whose reference
    gradient is zero must get a zero gradient."""
    import torch

    errs = {}
    for k, w in want.items():
        if torch.count_nonzero(w) == 0:
            if torch.count_nonzero(got[k]) != 0:
                raise AssertionError(f"fused step gives {k} a gradient where the unfused gives none")
            continue
        errs[k] = ((got[k].float() - w.float()).norm() / w.float().norm()).item()
    return errs


FUSE_ON = dict(fuse_block="on", fuse_proj="on", fuse_stem="on", fuse_stage="on")


def flagship_train_setup(**model_overrides):
    """(cfg, model, state, batch) of the flagship train step on the card:
    ResNet-50 NCameraCNN at full width (2 cameras, 1024-d features), bf16,
    frozen BN + affine, frozen stem, full backprop, argus_tpu's default
    augmentation, clip(1.0) + Adam at lr 1e-4; random weights from seed 0 with BN randomised; a batch
    of 256 seeded uint8 frame pairs with non-identity poses, on the card.
    `model_overrides` replace fields of the model config (the trained stem,
    exact BN)."""
    import numpy as np
    import torch

    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops.augment import AugmentationConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state

    mcfg = NCameraCNNConfig(**{
        **dict(n_cams=2, resnet_output_dim=1024, backbone="resnet50", bn_frozen=True, bn_frozen_affine=True,
               stem_frozen=True, frozen_stages=0, **FUSE_ON),
        **model_overrides,
    })
    cfg = TrainConfig(model_config=mcfg, amp=True, use_augmentation=True,
                      augmentation_config=AugmentationConfig(), batch_size=N_ROWS, learning_rate=1e-4,
                      max_grad_norm=1.0)
    model, state = create_train_state(cfg, seed=0)
    _randomize_(model, seed=0)  # in place: the state holds the same parameters
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(N_ROWS, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.0, 1.0, (N_ROWS, 1))
    poses = np.concatenate([rng.normal(0, 0.3, (N_ROWS, 3)), axis * np.sin(angle / 2), np.cos(angle / 2)], 1)
    batch = {
        "images": torch.randint(0, 256, (N_ROWS, HW, HW, 6), generator=g, device="cuda", dtype=torch.uint8),
        "cube_pose": torch.from_numpy(poses.astype(np.float32)).cuda(),
        "mask": torch.ones(N_ROWS, device="cuda"),
    }
    return cfg, model, state, batch


def train_phase() -> tuple:
    import torch

    from argus_tpu_torch.models import NCameraCNN
    from argus_tpu_torch.ops.augment import apply_augmentation
    from argus_tpu_torch.train import _loss_and_grads_on, feed_images, make_train_step

    cfg, model, state, batch = flagship_train_setup()
    mcfg = cfg.model_config

    # the fused step against the unfused one (cuDNN convs, frozen BN through
    # autograd), both on one augmented batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    head = {k: v[:8] for k, v in batch.items()}
    images = apply_augmentation(cfg.augmentation_config, 99, feed_images(cfg, head["images"], "cuda"))
    off = dataclasses.replace(mcfg, **{k: "off" for k in FUSE_ON})
    ref = NCameraCNN(dataclasses.replace(off, dtype="bfloat16")).cuda()
    ref.load_state_dict(model.state_dict())
    loss_f, grads_f = _loss_and_grads_on(model, state.params, images, head)
    loss_r, grads_r = _loss_and_grads_on(ref, dict(ref.named_parameters()), images, head)
    errs = _grad_errors(grads_f, grads_r)
    worst = max(errs, key=errs.get)
    median = sorted(errs.values())[len(errs) // 2]
    loss_err = abs(loss_f.item() - loss_r.item()) / abs(loss_r.item())
    say(f"train: fused vs unfused (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}) on the first 8 rows: loss "
        f"{loss_f.item():.6f} vs {loss_r.item():.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); "
        f"gradients of {len(errs)} parameters: max rel {errs[worst]:.3g} ({worst}), median {median:.3g} "
        f"(tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN})")
    if not (loss_err <= TRAIN_LOSS_RTOL and errs[worst] <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the fused train step disagrees with the unfused one")
    del ref, grads_f, grads_r, head, images
    torch.cuda.empty_cache()

    runs = {}
    for aug in (True, False):
        c = dataclasses.replace(cfg, use_augmentation=aug)
        runs[aug] = _time_steps(make_train_step(model, c), state, batch,
                                f"{'with' if aug else 'without'} augmentation")
        state = runs[aug][2]
        want = EXPECTED_TRAIN_LAUNCHES if aug else {**EXPECTED_TRAIN_LAUNCHES, "augment_fused": 0}
        if runs[aug][0] != want:
            raise AssertionError(f"train launch counts {runs[aug][0]} != expected {want}")
    say(f"train: augmentation costs {runs[True][1] - runs[False][1]:.2f} ms of the {runs[True][1]:.2f} ms step")
    return runs[True][0], runs[True][1]


def _time_steps(step, state, batch, label: str):
    """A warm-up step, then TRAIN_STEPS timed ones: (launches in the first,
    mean ms by CUDA events, state)."""
    import numpy as np
    import torch

    from argus_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    say(f"train {label}: warm-up step {time.perf_counter() - t0:.2f} s, loss {loss.item():.6f}")
    torch.cuda.reset_peak_memory_stats()
    ev_ms, host_ms, losses, launches = [], [], [], None
    for i in range(TRAIN_STEPS):
        if i == 0:
            kernels.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        state, loss = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(e0.elapsed_time(e1))
        losses.append(loss.item())
        if i == 0:
            launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"train {label}: launches in one step {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    ms = float(np.mean(ev_ms))
    say(f"train {label}: losses per step {[round(v, 6) for v in losses]}")
    say(f"train {label}: {TRAIN_STEPS} steps of batch {N_ROWS} rows ({N_IMG} camera images, {HW}x{HW}, "
        f"bf16, full backprop): {ms:.2f} ms/step by CUDA events (per step "
        f"{[round(v, 2) for v in ev_ms]}), {float(np.mean(host_ms)):.2f} ms/step by host clock, "
        f"{N_IMG / ms * 1e3:.1f} camera-images/s; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    return launches, ms, state


# ─────────────── phase 8: the trained stem and exact BN (Path A, Path B) ───────────────


def _eight_rows(cfg, batch):
    """The first 8 rows of `batch` and their augmented, fed images."""
    from argus_tpu_torch.ops.augment import apply_augmentation
    from argus_tpu_torch.train import feed_images

    head = {k: v[:8] for k, v in batch.items()}
    return head, apply_augmentation(cfg.augmentation_config, 99, feed_images(cfg, head["images"], "cuda"))


def _spread(errs: dict):
    worst = max(errs, key=errs.get)
    return errs[worst], sorted(errs.values())[len(errs) // 2], worst


def path_a_phase() -> tuple:
    """The flagship step with the fused stem trained (`stem_frozen=False`,
    the fuse flags "on"): against the unfused cuDNN step on 8 augmented
    rows within the flagship's gates (conv_init's gradient included), then
    6 timed steps and 6 with `stem_grad_stride=4`, launches per step 1
    augment / 1 stem save / 1 stem backward / 1+1 / 3+3 / 10+10. Returns
    (launches per step, ms/step, ms/step at grad stride 4)."""
    import torch

    from argus_tpu_torch.models import NCameraCNN
    from argus_tpu_torch.train import _loss_and_grads_on, make_train_step

    cfg, model, state, batch = flagship_train_setup(stem_frozen=False)
    head, images = _eight_rows(cfg, batch)
    ref = NCameraCNN(dataclasses.replace(cfg.model_config, dtype="bfloat16", **{k: "off" for k in FUSE_ON})).cuda()
    ref.load_state_dict(model.state_dict())
    loss_f, grads_f = _loss_and_grads_on(model, state.params, images, head)
    loss_r, grads_r = _loss_and_grads_on(ref, dict(ref.named_parameters()), images, head)
    errs = _grad_errors(grads_f, grads_r)
    worst, median, name = _spread(errs)
    loss_err = abs(loss_f.item() - loss_r.item()) / abs(loss_r.item())
    stem_err = errs.get("backbone.conv_init.weight")
    say(f"path A (trained fused stem): fused vs unfused on the first 8 rows: loss {loss_f.item():.6f} vs "
        f"{loss_r.item():.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients of {len(errs)} parameters: max "
        f"rel {worst:.3g} ({name}), median {median:.3g} (tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN}); conv_init.weight "
        f"{stem_err}")
    if stem_err is None or not (loss_err <= TRAIN_LOSS_RTOL and worst <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the trained-stem step disagrees with the unfused one")
    del ref, grads_f, grads_r, head, images
    torch.cuda.empty_cache()

    launches, ms, state = _time_steps(make_train_step(model, cfg), state, batch, "path A (stem trained)")
    if launches != EXPECTED_STEM_LAUNCHES:
        raise AssertionError(f"path A launch counts {launches} != expected {EXPECTED_STEM_LAUNCHES}")
    model.backbone.stem_grad_stride = 4
    launches4, ms4, state = _time_steps(make_train_step(model, cfg), state, batch, "path A stem_grad_stride=4")
    if launches4 != EXPECTED_STEM_LAUNCHES:
        raise AssertionError(f"path A (grad stride 4) launch counts {launches4} != expected {EXPECTED_STEM_LAUNCHES}")
    del model, state, batch
    torch.cuda.empty_cache()
    return launches, ms, ms4


def path_b_phase() -> tuple:
    """The exact-BN flagship step (argus_tpu's default BN and stem:
    `bn_frozen=False`, `stem_frozen=False`; `bn_impl="auto"`, strides 1):
    against the same step with `bn_impl="xla"` (autodiff through the
    statistics) on 8 augmented rows: loss, per-parameter gradients and the
    running statistics' change; then 6 timed steps of each, launches per
    step 1 augment / 53 bn_stats / 53 bn_bwd_reduce and no conv kernel.
    Returns (launches per step, ms/step auto, ms/step xla)."""
    import torch

    from argus_tpu_torch.ops.norm import BatchNorm
    from argus_tpu_torch.train import _loss_and_grads_on, create_train_state, make_train_step

    cfg, model, state, batch = flagship_train_setup(bn_frozen=False, bn_frozen_affine=False, stem_frozen=False,
                                                    bn_impl="auto", **{k: "auto" for k in FUSE_ON})
    xla_cfg = dataclasses.replace(cfg, model_config=dataclasses.replace(cfg.model_config, bn_impl="xla"))
    twin, twin_state = create_train_state(xla_cfg, seed=0)
    twin.load_state_dict(model.state_dict())
    head, images = _eight_rows(cfg, batch)
    before = {k: v.clone() for k, v in model.named_buffers()}
    loss_a, grads_a = _loss_and_grads_on(model, state.params, images, head)
    loss_x, grads_x = _loss_and_grads_on(twin, twin_state.params, images, head)
    errs = _grad_errors(grads_a, grads_x)
    worst, median, name = _spread(errs)
    after_a, after_x = dict(model.named_buffers()), dict(twin.named_buffers())
    moved = {k: (after_a[k] - before[k], after_x[k] - before[k]) for k in before}
    serr = {k: ((a - b).norm() / b.norm()).item() for k, (a, b) in moved.items() if b.norm() > 0}
    s_worst, s_median, s_name = _spread(serr)
    loss_err = abs(loss_a.item() - loss_x.item()) / abs(loss_x.item())
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    say(f"path B (exact BN): bn_impl auto vs xla on the first 8 rows: loss {loss_a.item():.6f} vs {loss_x.item():.6f} "
        f"(rel {loss_err:.3g}, tol {EXACT_LOSS_RTOL}); gradients of {len(errs)} parameters: max rel {worst:.3g} "
        f"({name}), median {median:.3g} (tol {EXACT_GRAD_RTOL}); running statistics' change, {len(serr)} of "
        f"{2 * n_bn} buffers: max rel {s_worst:.3g} ({s_name}), median {s_median:.3g} (tol {EXACT_STATS_RTOL})")
    if not (loss_err <= EXACT_LOSS_RTOL and worst <= EXACT_GRAD_RTOL[0] and median <= EXACT_GRAD_RTOL[1]
            and len(serr) == 2 * n_bn and s_worst <= EXACT_STATS_RTOL[0] and s_median <= EXACT_STATS_RTOL[1]):
        raise AssertionError("the exact-BN step with the reduction kernels disagrees with its xla twin")
    del grads_a, grads_x, head, images, moved
    torch.cuda.empty_cache()

    runs = {}
    for label, m, c, st in (("auto", model, cfg, state), ("xla", twin, xla_cfg, twin_state)):
        runs[label] = _time_steps(make_train_step(m, c), st, batch, f"path B (exact BN, bn_impl={label})")
        torch.cuda.empty_cache()
    if runs["auto"][0] != EXPECTED_EXACT_LAUNCHES:
        raise AssertionError(f"path B launch counts {runs['auto'][0]} != expected {EXPECTED_EXACT_LAUNCHES}")
    want_xla = {**_NONE, "augment_fused": 1}
    if runs["xla"][0] != want_xla:
        raise AssertionError(f"path B (xla) launch counts {runs['xla'][0]} != expected {want_xla}")
    say(f"path B: exact BN {runs['auto'][1]:.2f} ms/step with the reduction kernels, {runs['xla'][1]:.2f} ms/step "
        f"with xla reductions, in this call")
    del model, twin, state, twin_state, runs["xla"]
    torch.cuda.empty_cache()
    return runs["auto"][0], runs["auto"][1]


def keypoint_default_phase() -> float:
    """The keypoint family at argus_tpu's default config (exact BN, "xla",
    stem and affine trained, unfused), bf16, batch 256: 6 timed steps,
    finite losses, launches 1 augment."""
    import torch

    from argus_tpu_torch.models import CubeKeypointNetConfig
    from argus_tpu_torch.train import make_train_step

    cfg, model, state, batch = keypoint_setup(CubeKeypointNetConfig())
    launches, ms, state = _time_steps(make_train_step(model, cfg), state, batch, "keypoint default (exact BN)")
    if launches != {**_NONE, "augment_fused": 1}:
        raise AssertionError(f"keypoint default launch counts {launches}")
    del model, state, batch
    torch.cuda.empty_cache()
    return ms


# ─────────────────────── phase 7: the keypoint family ───────────────────────

KP_FUSE = dict(fuse_block="on", fuse_stem="on")


def keypoint_setup(kcfg=None):
    """(cfg, model, state, batch) of the keypoint train step on the card:
    CubeKeypointNet at argus_tpu's default config (2 cameras, 8 corners,
    resnet18, head_features 128, heatmap stride 8: 32x32 heatmaps), bf16
    (amp), frozen BN + affine, frozen stem, the fused identity BasicBlocks
    and stem, argus_tpu's default augmentation, clip(1.0) + Adam at lr 1e-4;
    random weights from seed 0 with every BN and LayerNorm randomised; a
    batch of 256 seeded uint8 frame pairs with cube poses in view of the
    nominal cameras, non-identity rotations. `kcfg` replaces the model config
    (argus_tpu's default, exact BN, for the default step)."""
    import numpy as np
    import torch

    from argus_tpu_torch.models import CubeKeypointNetConfig
    from argus_tpu_torch.ops.augment import AugmentationConfig
    from argus_tpu_torch.train import TrainConfig, create_train_state

    kcfg = kcfg or CubeKeypointNetConfig(bn_frozen=True, bn_frozen_affine=True, stem_frozen=True, **KP_FUSE)
    cfg = TrainConfig(model_type="keypoint", keypoint_config=kcfg, amp=True, use_augmentation=True,
                      augmentation_config=AugmentationConfig(), batch_size=N_ROWS, learning_rate=1e-4,
                      max_grad_norm=1.0)
    model, state = create_train_state(cfg, seed=0)
    _randomize_(model, seed=0, last_bn="BatchNorm_1", out_layer="heatmap")
    g = torch.Generator(device="cuda").manual_seed(6)
    rng = np.random.default_rng(6)
    axis = rng.normal(size=(N_ROWS, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.2, 3.0, (N_ROWS, 1))
    t = np.array([0.0, 0.0, 0.05]) + rng.normal(0, 0.02, (N_ROWS, 3))
    poses = np.concatenate([t, axis * np.sin(angle / 2), np.cos(angle / 2)], 1)
    batch = {
        "images": torch.randint(0, 256, (N_ROWS, HW, HW, 6), generator=g, device="cuda", dtype=torch.uint8),
        "cube_pose": torch.from_numpy(poses.astype(np.float32)).cuda(),
        "mask": torch.ones(N_ROWS, device="cuda"),
    }
    return cfg, model, state, batch


def keypoint_unfused_twin(cfg, model):
    """(cfg, model, state) of the same keypoint step with the fuse flags off
    (cuDNN convs, frozen BN through autograd), on `model`'s weights."""
    from argus_tpu_torch.train import create_train_state

    off = dataclasses.replace(cfg, keypoint_config=dataclasses.replace(
        cfg.keypoint_config, **{k: "off" for k in KP_FUSE}))
    ref, ref_state = create_train_state(off, seed=0)
    ref.load_state_dict(model.state_dict())
    return off, ref, ref_state


def keypoint_phase(tmpdir: str) -> tuple:
    """The keypoint family's path: the fused step against the unfused one,
    the launches of a step and of an eval forward, 6 timed steps of each,
    and keypoint serving at batch 256 against the CPU estimator. Returns
    (launches per step, launches per eval forward, fused ms/step)."""
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.ops.augment import apply_augmentation
    from argus_tpu_torch.serve import Estimator
    from argus_tpu_torch.train import _loss_and_grads_on, create_train_state, feed_images, make_loss_fn, \
        make_train_step

    cfg, model, state, batch = keypoint_setup()
    # the served weights: the random initial ones, which no training step
    # (and no nondeterministic cuDNN weight gradient) has touched
    served = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    off, ref, ref_state = keypoint_unfused_twin(cfg, model)

    # the fused step against the unfused one (cuDNN convs, frozen BN through
    # autograd) and both against the unfused f32 step, on one augmented batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    head = {k: v[:8] for k, v in batch.items()}
    images = apply_augmentation(cfg.augmentation_config, 99, feed_images(cfg, head["images"], "cuda"))
    losses = make_loss_fn(cfg)
    f32, f32_state = create_train_state(dataclasses.replace(off, amp=False), seed=0)
    f32.load_state_dict(model.state_dict())
    runs = {}
    for name, (m, st, im) in (("fused", (model, state, images)), ("unfused", (ref, ref_state, images)),
                              ("f32", (f32, f32_state, images.float()))):
        loss, grads = _loss_and_grads_on(m, st.params, im, head, losses)
        runs[name] = (loss.item(), grads.pop(SHIFT_INVARIANT).abs().max().item(), grads)
    del f32, f32_state

    def spread(a, b):
        errs = _grad_errors(runs[a][2], runs[b][2])
        worst = max(errs, key=errs.get)
        return errs[worst], sorted(errs.values())[len(errs) // 2], worst, len(errs)

    (fu_max, fu_med, fu_worst, n), f_32, u_32 = spread("fused", "unfused"), spread("fused", "f32"), \
        spread("unfused", "f32")
    loss_err = abs(runs["fused"][0] - runs["unfused"][0]) / abs(runs["unfused"][0])
    say(f"keypoint: on the first 8 rows of one augmented batch, loss fused {runs['fused'][0]:.6f}, unfused "
        f"{runs['unfused'][0]:.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}), f32 {runs['f32'][0]:.6f}; "
        f"gradients of {n} parameters, relative 2-norm (max, median): fused vs unfused {fu_max:.3g} ({fu_worst}), "
        f"{fu_med:.3g} (tol {KP_GRAD_RTOL}); fused vs f32 {f_32[0]:.3g} ({f_32[2]}), {f_32[1]:.3g}; unfused vs "
        f"f32 {u_32[0]:.3g} ({u_32[2]}), {u_32[1]:.3g} (the fused step's may be {KP_GRAD_SLACK}x these); "
        f"{SHIFT_INVARIANT} (zero up to rounding) max |grad| fused {runs['fused'][1]:.3g}, unfused "
        f"{runs['unfused'][1]:.3g}, f32 {runs['f32'][1]:.3g}")
    if not (np.isfinite([r[0] for r in runs.values()]).all() and loss_err <= TRAIN_LOSS_RTOL
            and fu_max <= KP_GRAD_RTOL[0] and fu_med <= KP_GRAD_RTOL[1]
            and f_32[0] <= KP_GRAD_SLACK * u_32[0] and f_32[1] <= KP_GRAD_SLACK * u_32[1]):
        raise AssertionError("the fused keypoint step disagrees with the unfused one")
    del runs, head, images
    torch.cuda.empty_cache()

    # the eval forward: launches, and its time fused and unfused
    fed = feed_images(cfg, batch["images"], "cuda")
    with torch.no_grad():
        kernels.reset_launch_counts()
        uv, probs = model(fed)
        eval_launches = kernels.launch_counts()
        if eval_launches != EXPECTED_KP_EVAL_LAUNCHES:
            raise AssertionError(f"keypoint eval launches {eval_launches} != expected {EXPECTED_KP_EVAL_LAUNCHES}")
        if uv.shape != (N_ROWS, 2, 8, 2) or probs.shape != (N_IMG, HW // 8, HW // 8, 8) or not uv.isfinite().all():
            raise AssertionError(f"bad keypoint output: {tuple(uv.shape)} {tuple(probs.shape)}")
        ev_f, ev_r = cuda_ms(lambda: model(fed), 3), cuda_ms(lambda: ref(fed), 3)
    say(f"keypoint eval forward ({N_IMG} camera images): launches {eval_launches}; fused {ev_f:.2f} ms, "
        f"unfused (cuDNN) {ev_r:.2f} ms")
    del fed, uv, probs

    runs = {}
    for name, (m, c, st) in (("fused", (model, cfg, state)), ("unfused", (ref, off, ref_state))):
        runs[name] = _time_steps(make_train_step(m, c), st, batch, f"keypoint {name}")
        torch.cuda.empty_cache()
    if runs["fused"][0] != EXPECTED_KP_LAUNCHES:
        raise AssertionError(f"keypoint train launch counts {runs['fused'][0]} != expected {EXPECTED_KP_LAUNCHES}")
    want_off = {**_NONE, "augment_fused": 1}
    if runs["unfused"][0] != want_off:
        raise AssertionError(f"unfused keypoint launch counts {runs['unfused'][0]} != expected {want_off}")
    say(f"keypoint train: fused {runs['fused'][1]:.2f} ms/step against unfused (cuDNN) {runs['unfused'][1]:.2f} "
        f"ms/step in this call ({N_IMG / runs['fused'][1] * 1e3:.1f} against "
        f"{N_IMG / runs['unfused'][1] * 1e3:.1f} camera-images/s)")
    del ref, ref_state, runs["unfused"]
    torch.cuda.empty_cache()

    # serving: a keypoint checkpoint of the initial weights, batch 256 on the card
    params, stats = variables_from_state_dict(served)
    ckpt = os.path.join(tmpdir, "keypoint_random.ckpt")
    meta = {"model_type": "keypoint", "model_config": dataclasses.asdict(cfg.keypoint_config),
            "center_crop": [HW, HW]}
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats}, meta=meta)
    del model, state, params, stats
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    est = Estimator(ckpt, batch_size=N_ROWS)
    frames = np.random.default_rng(7).integers(0, 256, (N_ROWS, HW, HW, 6), dtype=np.uint8)
    kernels.reset_launch_counts()
    poses = est.predict(frames)
    serve_launches = kernels.launch_counts()
    if serve_launches != _NONE:  # BasicBlock backbones serve unfused, as in argus_tpu
        raise AssertionError(f"keypoint serving launched kernels: {serve_launches}")
    if poses.shape != (N_ROWS, 7) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"bad keypoint poses: shape {poses.shape}, finite {np.isfinite(poses).all()}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        est.predict(frames)
    ms = (time.perf_counter() - t1) / 3 * 1e3
    ref_poses = Estimator(ckpt, batch_size=8, device="cpu").predict(frames[:8])
    f32 = Estimator(ckpt, batch_size=1, device="cpu")  # f32, the latency configuration
    f32_poses = np.concatenate([f32.predict(frames[i:i + 1]) for i in range(8)])

    def pose_diff(a, b):  # (translation, quaternion up to sign) max abs differences
        flip = np.where(np.sum(a[:, 3:] * b[:, 3:], -1, keepdims=True) < 0, -1.0, 1.0)
        return float(np.abs(a[:, :3] - b[:, :3]).max()), float(np.abs(a[:, 3:] - flip * b[:, 3:]).max())

    d_gpu, d_bf16 = pose_diff(poses[:8], ref_poses), pose_diff(ref_poses, f32_poses)
    d_gpu32 = pose_diff(poses[:8], f32_poses)
    err = max(d_gpu)
    say(f"keypoint serving: Estimator(batch_size={N_ROWS}) dtype={est.cfg.dtype}, fuse_block={est.cfg.fuse_block}, "
        f"{ms:.2f} ms per predict ({N_ROWS / ms * 1e3:.1f} rows/s, host clock); GPU vs CPU (bf16) poses on the "
        f"first 8 rows: max abs diff {err:.4g} (atol {POSE_ATOL}; translation {d_gpu[0]:.3g}, quaternion up to "
        f"sign {d_gpu[1]:.3g}); against the CPU's f32 poses, the GPU's: translation {d_gpu32[0]:.3g}, quaternion "
        f"{d_gpu32[1]:.3g}, the CPU's bf16: translation {d_bf16[0]:.3g}, quaternion {d_bf16[1]:.3g}; "
        f"{time.perf_counter() - t0:.1f} s with the CPU estimators")
    # the random-weight keypoint fit amplifies bf16 rounding: where the CPU's
    # own bf16 poses sit farther than POSE_ATOL from its f32 ones, the GPU's
    # are held to the f32 poses no worse than the CPU's bf16 ones (KP_GRAD_SLACK)
    if not (err <= POSE_ATOL or all(g <= KP_GRAD_SLACK * max(b, POSE_ATOL) for g, b in zip(d_gpu32, d_bf16))):
        raise AssertionError(f"keypoint GPU poses differ from the CPU estimator by {err} > {POSE_ATOL}, and from its "
                             f"f32 poses by {d_gpu32} against the CPU's bf16 {d_bf16}")
    return runs["fused"][0], eval_launches, runs["fused"][1]


# ─────────────── phase 9: the frozen-stage fine-tune (B2) ───────────────


def frozen_kernel_phase() -> dict:
    """The kernels only the `frozen_stages=3` fine-tune reaches, at its shapes
    (N = 512 camera images of 256x256): the packed-output stem against
    `stem_pool_packed_plain` within one bf16 ulp (the stem's gate), and the
    whole-stage no-save chains of stages 1 and 2 (stride 2, 3 and 5
    identity blocks) against `stage_plain` under the conv gate. library_ms
    is the cuDNN composition of the same function. Times per step (one
    launch each)."""
    import torch
    import torch.nn.functional as F

    from argus_tpu_torch.ops.kernels import stage_fused, stem_fused

    g = torch.Generator(device="cuda").manual_seed(9)
    results = {}
    bf = torch.bfloat16
    x = torch.rand(N_IMG, HW, HW, 3, generator=g, device="cuda").to(bf)
    w7, b7 = _w(g, 7, 7, 3, 64), _b(g, 64)
    out = stem_fused.stem_fwd_packed(x, w7, b7)
    if out.shape != (N_IMG, HW // 4, HW // 8, 128):
        raise AssertionError(f"packed stem shape {tuple(out.shape)}")
    err = _ulp_compare("stem_fused_packed", out, stem_fused.stem_pool_packed_plain(x, w7, b7))

    def lib_stem():
        y = torch.relu(_lib_conv(x, w7, 2, 3) + b7.reshape(-1).to(bf))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1).reshape(out.shape)

    ms = cuda_ms(lambda: stem_fused.stem_fwd_packed(x, w7, b7), 5)
    pms = cuda_ms(lambda: stem_fused.stem_pool_packed_plain(x, w7, b7), 2)
    lms = cuda_ms(lib_stem, 5)
    flops, nb = 2 * N_IMG * (HW // 2) ** 2 * 64 * 147, nbytes(x, w7, b7, out)
    b, by = bound_ms(flops, nb)
    say(f"stem_fused_packed {tuple(x.shape)} -> {tuple(out.shape)} x1: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"library {lms:.3f} ms, bound {b:.3f} ms ({by})")
    results["stem_fused_packed"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms, flops=flops, bytes=nb)
    del x, out

    record = _recorder(results)
    cases = []
    for i, (h, cin, f, n_id) in ((1, (64, 256, 128, 3)), (2, (32, 512, 256, 5))):
        cout, ho = 4 * f, h // 2
        xs = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(bf)
        pw = _proj_weights(g, cin, f, cout)
        ids = [_id_weights(g, cout, f) for _ in range(n_id)]

        def lib(xs=xs, pw=pw, ids=ids):
            y = _lib_block(xs, *pw[:6], pw[6], pw[7], stride=2)
            for w in ids:
                y = _lib_block(y, *w)
            return y

        out_bytes = N_IMG * ho * ho * cout * BF
        cases.append((
            f"stage{i} {tuple(xs.shape)} F={f} S=2 {n_id} identity", 1,
            lambda xs=xs, pw=pw, ids=ids: stage_fused.fused_stage(xs, pw, ids, 2),
            lambda xs=xs, pw=pw, ids=ids: stage_fused.stage_plain(xs, pw, ids, 2), lib,
            _block_flops(N_IMG, h, h, cin, f, cout, 2, True) + n_id * _block_flops(N_IMG, ho, ho, cout, f, cout, 1,
                                                                                     False),
            nbytes(xs, *pw, *[t for w in ids for t in w]) + out_bytes, 3 * (1 + n_id),
            _round_trip_bytes(N_IMG, h, h, f, 2) + n_id * _round_trip_bytes(N_IMG, ho, ho, f, 1)
            + 2 * n_id * out_bytes,
        ))
    record("stage_fused_frozen", cases)
    del cases
    torch.cuda.empty_cache()
    return results


def _expected_launches(frozen_stages: int, stem_trained: bool, serving: bool = False, augment: bool = True,
                       pointwise: bool = False) -> dict:
    """The launches of one flagship train step (or, with `serving`, one
    no-save forward) with every fuse flag "auto" (`fuse_pointwise` too with
    `pointwise`, else "off"): what `AUTO_FUSE` names for each function in its
    mode (`models/resnet.py`'s dispatch)."""
    from argus_tpu_torch.models.resnet import AUTO_FUSE

    want = dict(_NONE, augment_fused=int(augment and not serving))

    def mode(frozen):
        return "forward" if serving or frozen else "train"

    stem_on = AUTO_FUSE[("stem", "train" if stem_trained and not serving else "forward")]
    packed = stem_on and frozen_stages >= 1 and AUTO_FUSE[("stage_chain_packed", "forward")]
    if stem_on:
        key = "stem_fused_packed" if packed else "stem_fused_save" if stem_trained and not serving else "stem_fused"
        want[key] += 1
        if stem_trained and not serving:
            want["stem_fused_bwd"] += 1
    for i, n in enumerate((3, 4, 6, 3)):
        frozen = i < frozen_stages
        m = mode(frozen)
        if i == 0 or frozen:
            chain = "stage_chain_packed" if i == 0 and m == "forward" else "stage_chain"
            if AUTO_FUSE[(chain, m)]:
                if m == "forward":
                    want["stage_fused" if i == 0 else "stage_fused_frozen"] += 1
                else:
                    want["stage_fused_save"] += 1
                    want["stage_fused_bwd"] += 1
                continue
        for name, count, fn in (("proj_fused", 1, "projection"), ("block_fused", n - 1, "identity")):
            if AUTO_FUSE[(fn, m)]:
                if m == "forward":
                    want[name] += count
                else:
                    want[name + "_save"] += count
                    want[name + "_bwd"] += count
            elif pointwise and AUTO_FUSE[("pointwise", m)]:  # Conv_0 and Conv_2 of each block the kernels do not take
                want["pointwise"] += 2 * count
                want["pointwise_bwd"] += 2 * count * (m == "train")
    return want


def frozen_phase() -> tuple:
    """The `frozen_stages=3` fine-tune step (the flagship with stages 0-2 and
    the stem frozen, fuse "on"): the fused loss and the stage-3 and head
    gradients against the unfused cuDNN step on 8 augmented rows, under phase
    6's gates (nothing below stage 3 gets a gradient on either side); the
    launches of an eval forward (1 packed stem / 1 stage-0 chain / 2 frozen
    chains / 1 projection / 2 identity) and of a step (1 augment / 1 packed
    stem / 1 / 2 / 1+1 / 2+2); 6 timed steps fused and 6 unfused. Returns
    (launches per step, launches per eval forward, fused ms/step, unfused
    ms/step)."""
    import torch

    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import _loss_and_grads_on, create_train_state, feed_images, make_train_step

    cfg, model, state, batch = flagship_train_setup(frozen_stages=3)
    off = dataclasses.replace(cfg, model_config=dataclasses.replace(cfg.model_config,
                                                                    **{k: "off" for k in FUSE_ON}))
    ref, ref_state = create_train_state(off, seed=0)
    ref.load_state_dict(model.state_dict())
    head, images = _eight_rows(cfg, batch)
    loss_f, grads_f = _loss_and_grads_on(model, state.params, images, head)
    loss_r, grads_r = _loss_and_grads_on(ref, ref_state.params, images, head)
    errs = _grad_errors(grads_f, grads_r)
    worst, median, name = _spread(errs)
    trained = ("backbone.stage3_", "backbone.fc.", "head_")
    below = sorted(k for k, v in {**grads_f, **grads_r}.items()
                   if torch.count_nonzero(v) and not k.startswith(trained))
    loss_err = abs(loss_f.item() - loss_r.item()) / abs(loss_r.item())
    say(f"frozen fine-tune (frozen_stages=3): fused vs unfused on the first 8 rows: loss {loss_f.item():.6f} vs "
        f"{loss_r.item():.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients of {len(errs)} parameters "
        f"(stage 3 and the head): max rel {worst:.3g} ({name}), median {median:.3g} (tol {GRAD_RTOL}, "
        f"{GRAD_RTOL_MEDIAN}); parameters below stage 3 with a gradient: {below}")
    if below or not (loss_err <= TRAIN_LOSS_RTOL and worst <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the frozen_stages=3 fused step disagrees with the unfused one")
    del grads_f, grads_r, head, images
    torch.cuda.empty_cache()

    fed = feed_images(cfg, batch["images"], "cuda")
    with torch.no_grad():
        kernels.reset_launch_counts()
        pred = model(fed)
        eval_launches = kernels.launch_counts()
        want = ref(fed)
    err = ((pred - want).norm() / want.norm()).item()
    say(f"frozen fine-tune eval forward ({N_IMG} camera images): launches {eval_launches}; outputs against the "
        f"unfused forward: relative 2-norm {err:.3g} (tol {GRAD_RTOL})")
    if eval_launches != EXPECTED_FROZEN_EVAL_LAUNCHES or not err <= GRAD_RTOL:
        raise AssertionError(f"frozen eval forward: launches {eval_launches} != {EXPECTED_FROZEN_EVAL_LAUNCHES} "
                             f"or outputs {err} apart")
    del fed, pred, want

    runs = {}
    for label, (m, c, st) in (("fused", (model, cfg, state)), ("unfused", (ref, off, ref_state))):
        runs[label] = _time_steps(make_train_step(m, c), st, batch, f"frozen_stages=3 {label}")
        torch.cuda.empty_cache()
    if runs["fused"][0] != EXPECTED_FROZEN_LAUNCHES:
        raise AssertionError(f"frozen_stages=3 launch counts {runs['fused'][0]} != {EXPECTED_FROZEN_LAUNCHES}")
    if runs["unfused"][0] != {**_NONE, "augment_fused": 1}:
        raise AssertionError(f"unfused frozen_stages=3 launch counts {runs['unfused'][0]}")
    say(f"frozen fine-tune: fused {runs['fused'][1]:.2f} ms/step against unfused (cuDNN) "
        f"{runs['unfused'][1]:.2f} ms/step in this call")
    del model, ref, state, ref_state, batch
    torch.cuda.empty_cache()
    return runs["fused"][0], eval_launches, runs["fused"][1], runs["unfused"][1]


# ─────────────── phase 10: what "auto" chooses (C1) ───────────────


def _median_step_ms(step, state, batch, n: int = C1_STEPS):
    """A warm-up call, then the median ms of `n` calls by CUDA events: (ms,
    launches in the first timed call, state)."""
    import torch

    from argus_tpu_torch.ops import kernels

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms = []
    for i in range(n):
        if i == 0:
            kernels.reset_launch_counts()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        if i == 0:
            launches = kernels.launch_counts()
    return sorted(ms)[n // 2], launches, state


def auto_phase(tmpdir: str) -> dict:
    """The fuse flags all "on", all "off" and all "auto" in one call, for the
    flagship step, the `frozen_stages=3` step (both batch 256, the fastest
    of C1_ROUNDS steps by CUDA events after a warm-up step each) and
    batch-256 serving (the fastest of C1_ROUNDS `Estimator.predict` calls by
    host clock), the three settings interleaved in AUTO_ORDERS on one
    model or estimator with its flags switched: a step samples the next
    step's augmentation parameters and uploads them from pageable memory,
    which waits for the device, so the step's time carries the host's
    jitter (10-25% between steps of one setting at the fine-tune's ~45 ms,
    where "auto" and "on" launch the same kernels), and the upload of the
    frames varies a predict's more than the 2% gate. Prints `AUTO_FUSE`'s choice for each function and mode; an
    "auto" step must launch exactly what the table names, and be no slower
    than the faster of "on" and "off" by more than AUTO_SLACK. Returns
    {workload: {flags: ms}}."""
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.models.resnet import AUTO_FUSE
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.serve import Estimator
    from argus_tpu_torch.train import make_train_step

    say("auto: AUTO_FUSE " + ", ".join(f"{f}/{m} {'on' if v else 'off'}" for (f, m), v in AUTO_FUSE.items()))
    timings = {}

    def switch(backbone, flags, pointwise=True):
        for k in (*FUSE_ON, "fuse_pointwise") if pointwise else FUSE_ON:
            setattr(backbone, k, flags)

    settings = ("on", "off", "auto")
    for workload, frozen_stages in (("flagship", 0), ("frozen_stages=3", 3)):
        cfg, model, state, batch = flagship_train_setup(frozen_stages=frozen_stages)
        step = make_train_step(model, cfg)
        launched = {}
        for flags in settings:  # a warm-up step each, then the launches of one step
            switch(model.backbone, flags)
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            launched[flags] = kernels.launch_counts()
        want = _expected_launches(frozen_stages, stem_trained=False, pointwise=True)
        if launched["auto"] != want:
            raise AssertionError(f"auto {workload}: launches {launched['auto']} != the table's {want}")
        steps = {}
        for r in range(C1_ROUNDS):
            for flags in (settings[i] for i in AUTO_ORDERS[r % 6]):
                switch(model.backbone, flags)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                state, _ = step(state, batch)
                e1.record()
                torch.cuda.synchronize()
                steps.setdefault(flags, []).append(e0.elapsed_time(e1))
        for flags in settings:
            ms = min(steps[flags])
            timings.setdefault(workload, {})[flags] = ms
            say(f"auto: {workload} step, flags {flags}: fastest of {C1_ROUNDS} {ms:.2f} ms/step, median "
                f"{sorted(steps[flags])[C1_ROUNDS // 2]:.2f} ({N_IMG / ms * 1e3:.1f} camera-images/s; launches "
                f"{({k: v for k, v in launched[flags].items() if v})})")
        del model, state, batch, step
        torch.cuda.empty_cache()

    mcfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50")
    model = NCameraCNN(mcfg)
    _randomize_(model, seed=0)
    params, stats = variables_from_state_dict(model.state_dict())
    ckpt = os.path.join(tmpdir, "resnet50_auto.ckpt")
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats},
                    meta={"model_type": "pose_cnn", "model_config": dataclasses.asdict(mcfg), "center_crop": [HW, HW]})
    del model, params, stats
    est = Estimator(ckpt, batch_size=N_ROWS)
    if {getattr(est.cfg, k) for k in FUSE_ON} != {"auto"}:
        raise AssertionError(f"batched serving's tuned config is not 'auto': {est.cfg}")
    frames = np.random.default_rng(0).integers(0, 256, (N_ROWS, HW, HW, 6), dtype=np.uint8)
    times = {}
    for flags in ("on", "off", "auto"):
        switch(est.model.backbone, flags, pointwise=False)  # batched serving keeps fuse_pointwise "off"
        est.predict(frames)
        kernels.reset_launch_counts()
        est.predict(frames)
        launches = kernels.launch_counts()
        if flags == "auto":
            want = _expected_launches(0, stem_trained=False, serving=True)
            if launches != want:
                raise AssertionError(f"auto serving: launches {launches} != the table's {want}")
        say(f"auto: serving, flags {flags}: launches {({k: v for k, v in launches.items() if v})}")
    # the settings interleaved in AUTO_ORDERS, so that the host's load and
    # the one before fall on all three alike
    for r in range(C1_ROUNDS):
        for flags in (settings[i] for i in AUTO_ORDERS[r % 6]):
            switch(est.model.backbone, flags, pointwise=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.predict(frames)
            times.setdefault(flags, []).append((time.perf_counter() - t0) * 1e3)
    for flags, ts in times.items():
        timings.setdefault("serving", {})[flags] = min(ts)
        say(f"auto: serving predict of {N_ROWS} rows, flags {flags}: fastest of {C1_ROUNDS} {min(ts):.2f} ms, "
            f"median {sorted(ts)[C1_ROUNDS // 2]:.2f} ms (host clock, interleaved with the other settings)")
    del est
    torch.cuda.empty_cache()
    for workload, t in timings.items():
        best = min(t["on"], t["off"])
        say(f"auto: {workload}: auto {t['auto']:.2f} ms against on {t['on']:.2f} and off {t['off']:.2f} "
            f"({(t['auto'] / best - 1) * 100:+.1f}% of the faster; limit {AUTO_SLACK * 100:.0f}%)")
        if t["auto"] > (1 + AUTO_SLACK) * best:
            raise AssertionError(f"auto {workload} is slower than the faster of on and off by more than {AUTO_SLACK}")
    return timings



# ─────────────── phase 11: training end to end (the loop) ───────────────


class FramesDataset:
    """An in-memory dataset with the interface `HostDataLoader` reads:
    frames rendered by the port's synthetic renderer (the card's Python has
    no h5py, so no HDF5 + PNG dataset is written there), xyzw poses."""

    def __init__(self, images, poses_wxyz):
        from argus_tpu_torch.geom import xyzwxyz_to_xyzxyzw_SE3

        self.images = images
        self.cube_poses = xyzwxyz_to_xyzxyzw_SE3(poses_wxyz).astype("float32")
        self.n_cams = 2
        self.requested = []  # host clock of each batch request

    def __len__(self):
        return len(self.cube_poses)

    def __getitem__(self, idx):
        return {"images": self.images[idx], "cube_pose": self.cube_poses[idx]}

    def load_images_batch(self, idxs, n_threads=1, pool=None):
        self.requested.append(time.perf_counter())
        return self.images[list(idxs)]


class _Recorder:
    """The loop's metrics, kept in memory with their host time (the runs here
    log to no file and no service)."""

    runs = []

    def __init__(self, *a, **k):
        self.records = []
        _Recorder.runs.append(self)

    def log(self, metrics, step=None):
        self.records.append((time.perf_counter(), step, dict(metrics)))

    def finish(self):
        pass


def loop_phase(tmpdir: str) -> dict:
    """`train()` on the card at full width: the `frozen_stages=3` fine-tune
    (ResNet-50 NCameraCNN, 2 cameras, 1024-d features, 256x256, batch 256,
    amp, frozen BN and affine, augmentation on, fuse "auto",
    `device_resident_mb=0`) on LOOP_TRAIN + LOOP_VAL rendered examples
    through `HostDataLoader` and the device feed: 2 epochs, then a run
    resumed from the file that saved for 1 more. Checks: every epoch's loss
    and val loss finite, the step count continuing (8, then 12), the first
    file restoring bit-equal into a fresh `TrainState`, and every kernel
    "auto" names for this path launched. Prints end-to-end camera-images/s
    of the resumed run's train pass (loader, feed, steps; from its first
    batch request to its losses), and of the first run's second epoch,
    during which epoch 0's checkpoint is written, beside the compute-only
    step on a resident batch, and how long `AsyncCheckpointer.save` holds
    the caller."""
    import numpy as np
    import torch

    from argus_tpu_torch import logging_utils
    from argus_tpu_torch.checkpoint import AsyncCheckpointer, load_checkpoint, train_state_tree
    from argus_tpu_torch.data.synthetic import render_dataset_arrays
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step, train

    t0 = time.perf_counter()
    sets = [render_dataset_arrays(n, HW, HW, seed=s) for n, s in ((LOOP_TRAIN, 10), (LOOP_VAL, 11))]
    datasets = tuple(FramesDataset(*a) for a in sets)
    say(f"loop: rendered {LOOP_TRAIN} + {LOOP_VAL} corner-projection examples ({HW}x{HW}, 2 cameras) in "
        f"{time.perf_counter() - t0:.1f} s; PNG decode is not on this path (no HDF5 writer on this host)")
    mcfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50", bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True, frozen_stages=3)
    cfg = TrainConfig(model_config=mcfg, amp=True, batch_size=N_ROWS, n_epochs=2, learning_rate=1e-4,
                      device_resident_mb=0, wandb_log=False, num_workers=8, save_dir=os.path.join(tmpdir, "ckpt"))
    orig = logging_utils.MetricsLogger
    logging_utils.MetricsLogger = _Recorder
    try:
        _Recorder.runs.clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = train(cfg, datasets=datasets)
        t_first = time.perf_counter() - t0
        launches = kernels.launch_counts()
        datasets[0].requested.clear()
        t0 = time.perf_counter()
        resumed = train(dataclasses.replace(cfg, n_epochs=1, resume_from=first), datasets=datasets)
        t_resumed = time.perf_counter() - t0
    finally:
        logging_utils.MetricsLogger = orig
    runs = [r.records for r in _Recorder.runs]
    losses = [[m["loss"] for _, _, m in r if "loss" in m] for r in runs]
    vals = [[m["val_loss"] for _, _, m in r if "val_loss" in m] for r in runs]
    per_epoch = LOOP_TRAIN // N_ROWS
    say(f"loop: train() 2 epochs in {t_first:.1f} s, resumed 1 epoch in {t_resumed:.1f} s (model set-up, "
        f"datasets and checkpoint files included); losses {[round(v, 4) for v in losses[0]]} then "
        f"{[round(v, 4) for v in losses[1]]}; val losses {[round(v, 4) for v in vals[0]]} then "
        f"{[round(v, 4) for v in vals[1]]}; launches over both epochs {({k: v for k, v in launches.items() if v})}")
    first_tree, final_tree = load_checkpoint(first), load_checkpoint(resumed)
    steps = (int(first_tree["step"]), int(final_tree["step"]))
    if steps != (2 * per_epoch, 3 * per_epoch) or len(losses[0]) != 2 * per_epoch or len(losses[1]) != per_epoch:
        raise AssertionError(f"loop: step counts {steps}, losses {len(losses[0])} + {len(losses[1])}")
    if not (np.isfinite(losses[0] + losses[1]).all() and np.isfinite(vals[0] + vals[1]).all()
            and len(vals[0]) == 2 and len(vals[1]) == 1):
        raise AssertionError(f"loop: non-finite or missing losses {losses} {vals}")
    want = {k for k, v in _expected_launches(3, stem_trained=False).items() if v}
    want |= {k for k, v in _expected_launches(3, stem_trained=False, serving=True).items() if v}
    missed = sorted(k for k in want if not launches[k])
    if missed or launches["stem_fused_packed"] != 2 * (per_epoch + LOOP_VAL_BATCHES):
        raise AssertionError(f"loop: kernels of the path not launched {missed} (launches {launches})")

    # the saved file restores bit-equal into a fresh state
    _, fresh = create_train_state(cfg, seed=5)
    load_checkpoint(first, target=fresh)
    got = train_state_tree(fresh)

    def leaves(t, pre=""):
        for k, v in t.items():
            yield from leaves(v, f"{pre}/{k}") if isinstance(v, dict) else [(f"{pre}/{k}", np.asarray(v))]

    a, b = dict(leaves(got)), dict(leaves(first_tree))
    unequal = [k for k in b if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if a.keys() != b.keys() or unequal:
        raise AssertionError(f"loop: the saved state does not restore bit-equal: {unequal[:5]}")
    say(f"loop: {first} restores bit-equal into a fresh TrainState ({len(b)} leaves); steps {steps[0]} then "
        f"{steps[1]}")

    # end to end against compute only, and the save's hold on the loop
    # each epoch's losses are logged when its train pass ends
    t_val0 = next(t for t, s, m in runs[0] if "val_loss" in m)
    t_loss1 = [t for t, s, m in runs[0] if "loss" in m][per_epoch]
    saving_ms = (t_loss1 - t_val0) / per_epoch * 1e3
    t_resumed_loss = next(t for t, s, m in runs[1] if "loss" in m)
    e2e_ms = (t_resumed_loss - datasets[0].requested[0]) / per_epoch * 1e3
    model, state = create_train_state(cfg, seed=5)
    load_checkpoint(first, target=state)
    batch = {"images": torch.from_numpy(sets[0][0][:N_ROWS]).cuda(),
             "cube_pose": torch.from_numpy(datasets[0].cube_poses[:N_ROWS]).cuda(),
             "mask": torch.ones(N_ROWS, device="cuda")}
    compute_ms, _, state = _median_step_ms(make_train_step(model, cfg, base_seed=cfg.random_seed), state, batch)
    ck = AsyncCheckpointer()
    t0 = time.perf_counter()
    ck.save(os.path.join(tmpdir, "held.ckpt"), state)
    hold_ms = (time.perf_counter() - t0) * 1e3
    ck.wait()
    write_ms = (time.perf_counter() - t0) * 1e3
    say(f"loop: end to end {N_IMG / e2e_ms * 1e3:.1f} camera-images/s ({e2e_ms:.2f} ms per step of the resumed "
        f"run's train pass through HostDataLoader, the feed and the step; host clock) against compute only "
        f"{N_IMG / compute_ms * 1e3:.1f} ({compute_ms:.2f} ms/step, resident batch, CUDA events); the first "
        f"run's second epoch, while epoch 0's file is written, {saving_ms:.2f} ms/step; AsyncCheckpointer.save "
        f"holds the caller {hold_ms:.1f} ms, the write ends {write_ms:.0f} ms after")
    del model, state, batch, fresh
    torch.cuda.empty_cache()
    return dict(e2e_ms=e2e_ms, saving_ms=saving_ms, compute_ms=compute_ms, hold_ms=hold_ms, launches=launches)



# ─────────────── phase 12: the pointwise kernels (B11) ───────────────

# configuration P's pointwise calls per step at N = 512, 256x256: (H = W, CIN,
# COUT, residual, calls) for Conv_0 (no residual) and Conv_2 (the block's
# residual) of the 16 bottleneck blocks
POINTWISE_GEOMETRIES = [
    (64, 64, 64, False, 1), (64, 256, 64, False, 2), (64, 64, 256, True, 3), (64, 256, 128, False, 1),
    (32, 512, 128, False, 3), (32, 128, 512, True, 4), (32, 512, 256, False, 1), (16, 1024, 256, False, 5),
    (16, 256, 1024, True, 6), (16, 1024, 512, False, 1), (8, 2048, 512, False, 2), (8, 512, 2048, True, 3),
]
P_FUSE = dict(fuse_pointwise="on", fuse_block="off", fuse_proj="off", fuse_stage="off", fuse_stem="on")
EXPECTED_P_LAUNCHES = {**_NONE, "augment_fused": 1, "stem_fused": 1, "pointwise": 32, "pointwise_bwd": 32}
# configuration R (remat, every fuse flag on): the stage-0 chain pair ignores remat; stages 1-3
EXPECTED_R_LAUNCHES = {
    **_NONE, "augment_fused": 1, "stem_fused": 1, "stage_fused_save": 1, "stage_fused_bwd": 1, "proj_fused": 3,
    "proj_fused_save": 3, "proj_fused_bwd": 3, "block_fused": 10, "block_fused_rbwd": 10,
}
# the identity geometries of B7: (H = W, CIN, F, launches per R step); the
# stage-0 geometry runs in the chain there, and is checked here beside
RBWD_GEOMETRIES = [(64, 256, 64, 0), (32, 512, 128, 3), (16, 1024, 256, 5), (8, 2048, 512, 2)]


def pointwise_kernel_phase() -> dict:
    """The pointwise forward (with and without the residual) and backward
    (emitting m where the op had a residual) at every geometry of
    configuration P, and at an odd M, against their plain versions under the
    conv gate, for out, dx, m and dw; times per P step. `library_ms` is the
    "dot" composition (cuBLAS's bf16 GEMMs with f32 outputs and PyTorch's
    epilogue passes); the bound counts x2, w, b (and res) read and out
    written once (the backward: g, out, x2, w read, dx, the f32 dw and m
    written), 2 * M * CIN * COUT FLOPs a product."""
    import torch

    from argus_tpu_torch.ops.kernels import pointwise

    g = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    record = _recorder(results)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    # an odd M (513 images of 7x7): no tile divides it
    m_odd = 513 * 7 * 7
    x, w, b, res, gr = rand(m_odd, 256), _w(g, 256, 64), _b(g, 64), rand(m_odd, 64), rand(m_odd, 64)
    for r in (None, res):
        out = pointwise.pointwise_fwd(x, w, b, r)
        e = _compare(f"pointwise M={m_odd}", out, pointwise.pointwise_fwd_plain(x, w, b, r))
        e = max(e, _compare(f"pointwise M={m_odd} relu off", pointwise.pointwise_fwd(x, w, b, r, False),
                            pointwise.pointwise_fwd_plain(x, w, b, r, False)))
        args = (gr, out, x, w, True, r is not None)
        e = max(e, _compare(f"pointwise_bwd M={m_odd}", [t for t in pointwise.pointwise_bwd(*args) if t is not None],
                            [t for t in pointwise.pointwise_bwd_plain(*args) if t is not None]))
        say(f"pointwise odd M = {m_odd} (CIN 256, COUT 64, residual {r is not None}): forward and backward "
            f"within the gate, max_abs_err {e:.4g}")
    del x, w, b, res, gr

    fwd, bwd = [], []
    relu_off = {False: "512x32x32 512->128", True: "512x32x32 128->512 +res"}  # a geometry of each kind
    for h, cin, cout, with_res, calls in POINTWISE_GEOMETRIES:
        m = N_IMG * h * h
        x, w, b = rand(m, cin), _w(g, cin, cout), _b(g, cout)
        res = rand(m, cout) if with_res else None
        args = (x, w, b, res)
        out = pointwise.pointwise_fwd(*args)
        name = f"{N_IMG}x{h}x{h} {cin}->{cout}{' +res' if with_res else ''}"
        if relu_off[with_res] == name:
            e = _compare(f"pointwise {name} relu off", pointwise.pointwise_fwd(*args, False),
                         pointwise.pointwise_fwd_plain(*args, False))
            say(f"pointwise {name} relu off: within the gate, max_abs_err {e:.4g}")
        label = f"M={m} ({N_IMG}x{h}x{h}) {cin}->{cout}{' +res' if with_res else ''}"
        fl = 2 * m * cin * cout
        fwd.append((
            label, calls, lambda args=args: pointwise.pointwise_fwd(*args),
            lambda args=args: pointwise.pointwise_fwd_plain(*args),
            lambda args=args: pointwise.pointwise_fwd_dot(*args),
            fl, nbytes(*(t for t in args if t is not None), out), 1, 0,
        ))
        gr = rand(m, cout)
        args = (gr, out, x, w, True, with_res)
        bwd.append((  # m is None without a residual: the gate takes the outputs there are
            label, calls, lambda args=args: [t for t in pointwise.pointwise_bwd(*args) if t is not None],
            lambda args=args: [t for t in pointwise.pointwise_bwd_plain(*args) if t is not None],
            lambda args=args: pointwise.pointwise_bwd_dot(*args),
            2 * fl, nbytes(gr, out, x, w, x) + 4 * cin * cout + (nbytes(gr) if with_res else 0), 3, 0,
        ))
    record("pointwise", fwd)
    record("pointwise_bwd", bwd)
    del fwd, bwd
    torch.cuda.empty_cache()
    return results


# ─────────────── phase 13: configuration P (fuse_pointwise) ───────────────


def pointwise_phase() -> tuple:
    """Configuration P: the flagship step with `fuse_pointwise="on"` and the
    block, projection and chain flags off (the stem as the flagship has it):
    its loss and gradients on 8 augmented rows against the "off" step (every
    conv of the blocks through cuDNN on its folded weight), the flagship's
    gates; launches per step 1 augment / 1 stem / 32 pointwise / 32
    pointwise_bwd; then a warm-up and 6 timed steps each with
    `fuse_pointwise` "on", "dot", "off" and "auto", finite losses, ms/step,
    camera-images/s and peak memory. Returns (launches, {flag: (ms, peak
    bytes)})."""
    import torch

    from argus_tpu_torch.train import _loss_and_grads_on, make_train_step

    cfg, model, state, batch = flagship_train_setup(**P_FUSE)
    head, images = _eight_rows(cfg, batch)
    bb = model.backbone
    loss_p, grads_p = _loss_and_grads_on(model, state.params, images, head)
    bb.fuse_pointwise, bb.fuse_stem = "off", "off"
    loss_o, grads_o = _loss_and_grads_on(model, state.params, images, head)
    bb.fuse_pointwise, bb.fuse_stem = "on", "on"
    errs = _grad_errors(grads_p, grads_o)
    worst, median, name = _spread(errs)
    loss_err = abs(loss_p.item() - loss_o.item()) / abs(loss_o.item())
    say(f"P (fuse_pointwise): pointwise vs off on the first 8 rows: loss {loss_p.item():.6f} vs {loss_o.item():.6f} "
        f"(rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients of {len(errs)} parameters: max rel {worst:.3g} "
        f"({name}), median {median:.3g} (tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN})")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the pointwise step disagrees with the off step")
    del grads_p, grads_o, head, images
    torch.cuda.empty_cache()

    step = make_train_step(model, cfg)
    runs, launches = {}, None
    for flag in ("on", "dot", "off", "auto"):
        bb.fuse_pointwise = flag
        got, ms, state = _time_steps(step, state, batch, f"P fuse_pointwise={flag}")
        runs[flag] = (ms, torch.cuda.max_memory_allocated())
        if flag == "on":
            launches = got
            if got != EXPECTED_P_LAUNCHES:
                raise AssertionError(f"P launch counts {got} != expected {EXPECTED_P_LAUNCHES}")
        elif flag in ("dot", "off") and (got["pointwise"] or got["pointwise_bwd"]):
            raise AssertionError(f"P with fuse_pointwise={flag} launched the pointwise kernels: {got}")
    say("P: " + ", ".join(f"{f} {ms:.2f} ms/step ({N_IMG / ms * 1e3:.1f} camera-images/s, peak "
                          f"{peak / 2**30:.2f} GiB)" for f, (ms, peak) in runs.items()) + " in this call")
    del model, state, batch, step
    torch.cuda.empty_cache()
    return launches, runs


# ─────────────── phase 14: the recompute backward (B7) ───────────────


def rbwd_kernel_phase() -> dict:
    """B7 at the four identity geometries (N = 512, 256x256 frames): the
    recomputed h1/h2 against the plain recompute and dx, dw1-3 against the
    plain backward from the kernel's own h1/h2, under the conv gate (where a
    recomputed value lies within the gate of zero the two recomputes' relu
    masks may differ, and the backward from there on with them: counted and
    printed, with dx's elements beyond the gate end to end); times per
    configuration R step (3 + 5 + 2 calls) beside the plain version, the
    bound and the library figure (cuDNN's folded recompute forward plus its
    autograd backward), and the saved-residual backward's time at the same
    shapes. The bound counts the backward's FLOPs plus the recomputed h1
    and h2 (2 * M * (CIN * F + 9 * F * F)), x, g, out and the weights read
    once, dx and the f32 dw written once."""
    import torch

    from argus_tpu_torch.ops.kernels import block_fused

    g = torch.Generator(device="cuda").manual_seed(6)
    results = {}
    record = _recorder(results)
    cases = []
    for h, cin, f, calls in RBWD_GEOMETRIES:
        x = torch.rand(N_IMG, h, h, cin, generator=g, device="cuda").to(torch.bfloat16)
        iw = _id_weights(g, cin, f)
        out, h1, h2 = block_fused.bottleneck_block_save(x, *iw)
        gi = torch.randn(out.shape, generator=g, device="cuda").to(torch.bfloat16)
        args = (x, gi, out, *iw)
        saved_ms = cuda_ms(lambda: block_fused.block_bwd(x, gi, out, h1, h2, iw[0], iw[2], iw[4]), 5)
        xl = x.detach().requires_grad_()
        wl = [t.detach().requires_grad_(t.dtype == torch.bfloat16) for t in iw]

        def lib(xl=xl, wl=wl, gi=gi):  # the recompute: cuDNN forward, then its autograd backward
            y = _lib_block(xl, *wl)
            return torch.autograd.grad(y, [xl, wl[0], wl[2], wl[4]], gi)

        m = N_IMG * h * h
        fl = 2 * _block_flops(N_IMG, h, h, cin, f, cin, 1, False) + 2 * m * (cin * f + 9 * f * f)
        label = f"({N_IMG}, {h}, {h}, {cin}) F={f}"
        # the kernel's recomputed h1/h2 against the plain recompute, and its
        # gradients against the plain backward from those h1/h2: a sum within
        # rounding of zero may take the relu mask the other way in the two
        # recomputes, and the backward from there on with it
        *_, h1k, h2k = block_fused.block_bwd_recompute(*args, recomputed=True)
        _, h1p, h2p = block_fused.bottleneck_block_save_plain(x, *iw)
        flips = [int(((a > 0) != (b > 0)).sum()) for a, b in ((h1k, h1p), (h2k, h2p))]
        near = max((torch.maximum(a.float().abs(), b.float().abs())[(a > 0) != (b > 0)].max().item() if n else 0.0)
                   for (a, b), n in zip(((h1k, h1p), (h2k, h2p)), flips))
        full = [t for t in block_fused.block_bwd_recompute_plain(*args)]
        got = block_fused.block_bwd_recompute(*args)
        beyond = int(((got[0].float() - full[0].float()).abs() > TOL_REL * full[0].float().abs().max() + TOL_ABS).sum())
        say(f"block_fused_rbwd {label}: recomputed h1/h2 relu masks differ from the plain recompute at {flips[0]} "
            f"and {flips[1]} of {h1p.numel()} elements each, all at |h| <= {near:.3g}; against the plain recompute "
            f"end to end, {beyond} dx elements lie beyond the gate")
        del full, got
        cases.append((
            label, calls,
            lambda args=args: block_fused.block_bwd_recompute(*args, recomputed=True),
            lambda args=args, h1k=h1k, h2k=h2k: [
                *block_fused.block_bwd_plain(*args[:3], h1k, h2k, args[3], args[5], args[7]),
                *block_fused.bottleneck_block_save_plain(args[0], *args[3:])[1:]],
            lib,
            fl, nbytes(x, gi, out, *iw) + nbytes(x) + 4 * (cin * f + 9 * f * f + f * cin), 12,
            2 * _round_trip_bytes(N_IMG, h, h, f, 1) + 2 * nbytes(gi),
        ))
        say(f"block_fused_rbwd {label}: the saved-residual backward (block_fused_bwd) takes {saved_ms:.3f} ms here")
        del out, h1, h2
    record("block_fused_rbwd", cases)
    del cases
    torch.cuda.empty_cache()
    return results


# ─────────────── phase 15: configuration R (remat, fused) ───────────────


def remat_phase() -> tuple:
    """Configuration R: the flagship step with `remat=True` and every fuse
    flag "on" (the stage-0 chain ignores remat): loss and gradients on 8
    augmented rows against the same model without remat, the flagship's
    gates; launches per step 1 augment / 1 stem / 1 + 1 chain / 3 projection
    forwards, 3 saving forwards re-run, 3 backwards / 10 identity forwards,
    10 recompute backwards, no saving identity forward; 6 timed steps each
    way, and R's peak memory below the step without remat. Returns
    (launches, ms, peak, ms without remat, peak without remat)."""
    import torch

    from argus_tpu_torch.train import _loss_and_grads_on, make_train_step

    cfg, model, state, batch = flagship_train_setup(remat=True)
    bb = model.backbone
    head, images = _eight_rows(cfg, batch)
    bb.remat = False  # the twin: the same model keeping every block's interiors
    loss_s, grads_s = _loss_and_grads_on(model, state.params, images, head)
    bb.remat = True
    loss_r, grads_r = _loss_and_grads_on(model, state.params, images, head)
    errs = _grad_errors(grads_r, grads_s)
    worst, median, name = _spread(errs)
    loss_err = abs(loss_r.item() - loss_s.item()) / abs(loss_s.item())
    say(f"R (remat, fused): remat vs saved on the first 8 rows: loss {loss_r.item():.6f} vs {loss_s.item():.6f} "
        f"(rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients of {len(errs)} parameters: max rel {worst:.3g} "
        f"({name}), median {median:.3g} (tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN})")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the remat step disagrees with the step without remat")
    del grads_s, grads_r, head, images
    torch.cuda.empty_cache()
    step = make_train_step(model, cfg)
    bb.remat = False
    _, ms_s, state = _time_steps(step, state, batch, "R's twin (no remat, fuse on)")
    peak_s = torch.cuda.max_memory_allocated()
    bb.remat = True
    launches, ms_r, state = _time_steps(step, state, batch, "R (remat, fuse on)")
    peak_r = torch.cuda.max_memory_allocated()
    if launches != EXPECTED_R_LAUNCHES:
        raise AssertionError(f"R launch counts {launches} != expected {EXPECTED_R_LAUNCHES}")
    say(f"R: {ms_r:.2f} ms/step, peak {peak_r / 2**30:.2f} GiB, against {ms_s:.2f} ms/step, peak "
        f"{peak_s / 2**30:.2f} GiB without remat, in this call")
    if not peak_r < peak_s:
        raise AssertionError("R's peak memory is not below the step's without remat")
    del model, state, batch, step
    torch.cuda.empty_cache()
    return launches, ms_r, peak_r, ms_s, peak_s


# ─────────────── phase 16: configuration R-B (remat, exact BN) ───────────────


def remat_exact_phase() -> tuple:
    """Configuration R-B: Path B (exact BN, `bn_impl="auto"`, the stem
    trained) with `remat=True`, against the same model without remat: loss,
    gradients and the running statistics' change after one step on 8
    augmented rows within Path B's gates; then 6 timed steps each way, the
    `bn_stats` launches per step equal (53: the recompute reads the
    statistics its forward recorded), and the remat step's peak memory below
    the other's. Returns (launches, ms, peak, ms without remat, peak without
    remat)."""
    import torch

    from argus_tpu_torch.train import _loss_and_grads_on, make_train_step

    cfg, model, state, batch = flagship_train_setup(bn_frozen=False, bn_frozen_affine=False, stem_frozen=False,
                                                    bn_impl="auto", remat=True, **{k: "auto" for k in FUSE_ON})
    bb = model.backbone
    head, images = _eight_rows(cfg, batch)
    bb.remat = False  # the twin: Path B itself
    before = {k: v.clone() for k, v in model.named_buffers()}
    loss_s, grads_s = _loss_and_grads_on(model, state.params, images, head)
    after_s = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        for k, v in model.named_buffers():
            v.copy_(before[k])
    bb.remat = True
    loss_r, grads_r = _loss_and_grads_on(model, state.params, images, head)
    after_r = dict(model.named_buffers())
    errs = _grad_errors(grads_r, grads_s)
    worst, median, name = _spread(errs)
    serr = {k: ((after_r[k] - before[k]) - (after_s[k] - before[k])).norm().item()
            / (after_s[k] - before[k]).norm().item() for k in before if (after_s[k] - before[k]).norm() > 0}
    s_worst, s_median, s_name = _spread(serr)
    loss_err = abs(loss_r.item() - loss_s.item()) / abs(loss_s.item())
    say(f"R-B (remat, exact BN): remat vs not on the first 8 rows: loss {loss_r.item():.6f} vs {loss_s.item():.6f} "
        f"(rel {loss_err:.3g}, tol {EXACT_LOSS_RTOL}); gradients of {len(errs)} parameters: max rel {worst:.3g} "
        f"({name}), median {median:.3g} (tol {EXACT_GRAD_RTOL}); running statistics' change, {len(serr)} of "
        f"{len(before)} buffers: max rel {s_worst:.3g} ({s_name}), median {s_median:.3g} (tol {EXACT_STATS_RTOL})")
    if not (loss_err <= EXACT_LOSS_RTOL and worst <= EXACT_GRAD_RTOL[0] and median <= EXACT_GRAD_RTOL[1]
            and len(serr) == len(before) and s_worst <= EXACT_STATS_RTOL[0] and s_median <= EXACT_STATS_RTOL[1]):
        raise AssertionError("the remat exact-BN step disagrees with the step without remat")
    del grads_s, grads_r, head, images, before, after_s
    torch.cuda.empty_cache()
    step = make_train_step(model, cfg)
    bb.remat = False
    launches_s, ms_s, state = _time_steps(step, state, batch, "R-B's twin (exact BN, no remat)")
    peak_s = torch.cuda.max_memory_allocated()
    bb.remat = True
    launches, ms_r, state = _time_steps(step, state, batch, "R-B (exact BN, remat)")
    peak_r = torch.cuda.max_memory_allocated()
    if launches != EXPECTED_EXACT_LAUNCHES or launches_s != EXPECTED_EXACT_LAUNCHES:
        raise AssertionError(f"R-B launch counts {launches} (without remat {launches_s}) != expected "
                             f"{EXPECTED_EXACT_LAUNCHES}")
    say(f"R-B: {ms_r:.2f} ms/step, peak {peak_r / 2**30:.2f} GiB, against {ms_s:.2f} ms/step, peak "
        f"{peak_s / 2**30:.2f} GiB without remat, in this call; bn_stats launches per step {launches['bn_stats']} "
        f"both ways")
    if not peak_r < peak_s:
        raise AssertionError("R-B's peak memory is not below the step's without remat")
    del model, state, batch, step
    torch.cuda.empty_cache()
    return launches, ms_r, peak_r, ms_s, peak_s


def main() -> int:
    global GPU
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import argus_tpu_torch  # noqa: F401  (fails outside a checkout)
    from argus_tpu_torch.ops import kernels

    os.environ["WANDB_MODE"] = "disabled"  # no run here reaches a metrics service

    GPU = gpu_line()
    t_start = time.perf_counter()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    build_phase()
    hgmma_check()
    bf16x2_check()
    measured = kernel_phase()
    from argus_tpu_torch.ops.kernels import _build

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        launches, _ = end_to_end_phase(tmpdir)
    measured.update(train_kernel_phase())
    measured.update(basic_kernel_phase())
    engine_phase()
    measured.update(stem_bn_kernel_phase())
    aug_measured, aug_launches = augment_phase()
    measured.update(aug_measured)
    train_launches, step_ms = train_phase()
    kernel_ms = sum(m["ms"] for name, m in measured.items() if train_launches[name])
    say(f"train breakdown: fused kernels {kernel_ms:.2f} ms of the {step_ms:.2f} ms step (phase-2/4 kernel "
        f"times at these shapes: " + ", ".join(
            f"{name} {m['ms']:.2f}" for name, m in measured.items() if train_launches[name])
        + f"); the other {step_ms - kernel_ms:.2f} ms: the u8 feed, augmentation sampling and layout "
        f"transposes, mean pool, head, loss, BN folds, weight transposes, optimizer and launch gaps")
    a_launches, a_ms, a4_ms = path_a_phase()
    b_launches, b_ms = path_b_phase()
    measured.update(pointwise_kernel_phase())
    p_launches, p_runs = pointwise_phase()
    measured.update(rbwd_kernel_phase())
    r_launches, r_ms, r_peak, r_ms_s, r_peak_s = remat_phase()
    rb_launches, rb_ms, rb_peak, rb_ms_s, rb_peak_s = remat_exact_phase()
    say(f"the slice's steps in this call (ms/step, peak GiB): P " + ", ".join(
        f"{f} {ms:.2f} ({peak / 2**30:.2f})" for f, (ms, peak) in p_runs.items())
        + f"; R {r_ms:.2f} ({r_peak / 2**30:.2f}) against {r_ms_s:.2f} ({r_peak_s / 2**30:.2f}) without remat; "
        f"R-B {rb_ms:.2f} ({rb_peak / 2**30:.2f}) against {rb_ms_s:.2f} ({rb_peak_s / 2**30:.2f})")
    measured.update(frozen_kernel_phase())
    kernels.reset_launch_counts()  # the frozen fine-tune phase counts from here
    f_launches, f_eval_launches, f_ms, f_unfused_ms = frozen_phase()
    say(f"train steps in this call (ms/step): frozen stem {step_ms:.2f}, stem trained {a_ms:.2f}, stem trained at "
        f"grad stride 4 {a4_ms:.2f}, exact BN {b_ms:.2f}, frozen_stages=3 {f_ms:.2f} (unfused {f_unfused_ms:.2f})")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        auto_ms = auto_phase(tmpdir)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        loop = loop_phase(tmpdir)
    kp_default_ms = keypoint_default_phase()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        kp_launches, kp_eval_launches, kp_ms = keypoint_phase(tmpdir)
    say(f"keypoint train steps in this call (ms/step): default (exact BN, unfused) {kp_default_ms:.2f}, fused frozen "
        f"BN {kp_ms:.2f}")
    kp_kernel_ms = sum(m["ms"] for name, m in measured.items() if kp_launches[name])
    say(f"keypoint train breakdown: fused kernels {kp_kernel_ms:.2f} ms of the {kp_ms:.2f} ms step (phase-2/4/5 "
        f"kernel times at these shapes: " + ", ".join(
            f"{name} {m['ms']:.2f}" for name, m in measured.items() if kp_launches[name])
        + f"); the other {kp_ms - kp_kernel_ms:.2f} ms: the three strided BasicBlocks (cuDNN convs, frozen BN "
        f"through autograd, both ways), the head (upsampling convs, LayerNorms, heatmap, softmax) both ways, "
        f"the u8 feed, augmentation copies, loss, BN folds, weight transposes, optimizer and launch gaps")

    rows = []
    for name, m in measured.items():
        b, by = bound_ms(m["flops"], m["bytes"], m.get("peak", PEAK_FLOPS))
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": (launches[name] or train_launches[name] or a_launches[name] or b_launches[name]
                         or aug_launches["per-op"][name] or kp_launches[name] or kp_eval_launches[name]
                         or f_launches[name] or f_eval_launches[name] or p_launches[name] or r_launches[name]),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": b, "bound_by": by, "library_ms": m["library_ms"],
        })
    say(f"the fine-tune in this call: fused ('on') {f_ms:.2f} ms/step, 'auto' {auto_ms['frozen_stages=3']['auto']:.2f}, "
        f"unfused {f_unfused_ms:.2f}; train() end to end {N_IMG / loop['e2e_ms'] * 1e3:.1f} camera-images/s against "
        f"{N_IMG / loop['compute_ms'] * 1e3:.1f} compute only")
    say(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s (the build included)")
    print(json.dumps({"kernels": rows}))
    print(GPU)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
