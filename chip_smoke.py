#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (argus_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught and ignored):

1. build every CUDA kernel of the serving, training, augmentation,
   keypoint, trained-stem, exact-BN, frozen-stage, pointwise and remat paths
   from `argus_tpu_torch/csrc/` (19 sources, one nvcc each, in parallel) and
   print the seconds and ptxas' register/spill report; `cuobjdump -sass` of
   the BasicBlock, projection and identity backwards' libraries (the
   identity's saved-residual and recompute backwards), the stage chain's
   backward, the BasicBlock, identity bottleneck and projection forwards,
   the chain forwards, the pointwise backward and forward and the stem's
   weight gradient and forward must show wgmma (HGMMA) instructions, and the
   augmentation kernel's and the blur's bf16 instantiations packed bf16x2
   products and sums (their conversions counted beside them);
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
   8 rows within atol 0.05 (bf16 on both sides); the predict replays a
   CUDA graph captured after `WARMUP_STEPS` eager calls (one graph per
   shape and fuse setting; the launches counted are a replay's), its frames
   staged through pinned memory (the upload timed beside one from pageable
   memory, and the graph's replay alone);
3b. the control loop and export, on the same checkpoint: at batch 1
   (f32, plain convs) `Estimator.predict` replayed, p50 and p90 over 200
   calls by the host clock, beside the same model run eagerly here (upload,
   model, `se3_exp`, download) and the upload alone, no kernel launched,
   the replayed pose against the eager one (bit-equality printed) and the
   CPU estimator's within 0.05, cuDNN's TF32 flag printed; the same for the
   keypoint family (its phase-7 config and random weights; the pose fit
   after the replay, on the card, timed alone); `make_pose_estimator`
   against the estimator (1e-5) and one `validation_step` on 4 frames with
   augmentation (finite losses); then `export_estimator` at batch 256 and
   at batch 1, each served by `ExportedEstimator` in a process of its own
   that has no checkpoint and imports no model module: a replayed graph,
   the batch-256 graph's four `argus::` ops (1 / 1 / 3 / 10) and launches
   (`EXPECTED_LAUNCHES`), poses within 0.05 of the estimator's;
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
   few ulps from the kernel's f32 hue. The blur, in bf16 and f32 at the
   flagship's shape, 3 x 40x72 and 2 x 17x33 (an odd width, a band shorter
   than its halo), bit-equal to its plain version. Times: kernel, plain, and for the
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
   same for the step without augmentation, beside it; then gradient
   accumulation: the step with `grad_accum_steps=2` against 1 on the same 8
   augmented rows (loss and combined gradients) under the same gates, and
   6 timed steps of each at batch 256 (microbatches of 128; launches per
   step the model's kernels twice, the augmentation once), ms per step and
   peak memory;
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
   6 timed steps fused and 6 unfused in the same call; one resident epoch
   (`train.make_resident_epoch_step`, 776 fresh frames: 4 steps, the last
   padded) with its step captured as a CUDA graph after its eager warm-up
   steps, finite losses and the launches of 4 steps counted through the
   replays; then keypoint serving, `Estimator(ckpt, batch_size=256)` on a checkpoint of those
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
   second's patch rows by cp.async) over 16 and 4 images; the three stem
   forwards there and at 16 x 36x44 and 16 x 72x40 within one bf16 ulp, the
   no-save and packed outputs bit-equal to the saving one's (also at N =
   512); BatchNorm's
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
   (fuse "auto", augmentation on) on 1024 + 160 frames rendered by the
   port's synthetic renderer into an in-memory dataset (no h5py on the
   card), on each of the three data paths: the host feed
   (`device_resident_mb=0`: `HostDataLoader` and the device feed), the
   default budget (the split resident on the card, each epoch's step
   captured as a CUDA graph and replayed) and a 300 MiB budget (shards of
   399, 399 and 226 swapped in per epoch): each 2 epochs, then 1 more
   resumed from the saved file; finite losses, the step count continuing,
   the file restoring bit-equal into a fresh `TrainState`, every kernel
   "auto" names launched (counted through the replays); end-to-end
   camera-images/s of each path beside the compute-only step, and how long
   `AsyncCheckpointer.save` holds the caller; then one resident epoch
   replayed against the same epoch (one state, one order) run eagerly on
   the card, losses and the parameters' change under phase 6's gates, the
   replayed epoch's launches those of 4 "auto" steps, bit-equality printed;
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
17. data and tensor parallelism (`argus_tpu_torch.parallel`), after every
   kernel is built: (a) NCCL at world size 1 in this process: the flagship
   step at 256 rows through the bucketed all-reduce on NCCL against the
   one-card step (phase 6's gates), launches, timed steps and the
   all-reduce alone (CUDA events, bucket sizes); the loop phase's resident
   epoch with its step captured as a CUDA graph holding the NCCL
   all-reduce, against the same epoch eager (phase 11's gates, bit-equality
   printed); (b) two ranks on the one card over gloo (NCCL refuses two
   ranks on one device), spawned processes of 128 rows each, their steps
   eager (gloo's collectives cannot be captured): the flagship, Path B
   and the keypoint default, each against the one-card step this process
   computes at 256 rows on the same weights, batch and step number (phase
   6's gates; Path B's for the exact-BN two, with their running
   statistics; beside Path B, one card's "xla" engine against its "auto"
   on the same rows, the spread of bf16 exact BN), and Path B in f32
   (loss 1e-5, gradients 0.02 / 5e-3, running statistics 1e-4 / 1e-5: the
   same function summed in other orders), launches per rank per step the
   one-card step's, the ranks' parameters bit-equal after 5 steps (2 in
   f32); (c) the flagship with
   `num_model_shards=2` on the same two ranks (the wide layers cut, the
   same 256 rows) against the unsharded step; (d) `train()` under
   `multigpu` on the two ranks over the loop phase's rendered split, one
   epoch resident and one on the host feed: finite losses, the parameters
   bit-equal across ranks, rank 0's checkpoint restoring bit-equal on both,
   camera-images/s beside phase 11's one-card figure. Two ranks share one
   card, so none of these times is a scaling figure;
18. the streaming render feed (`data.StreamingRenderLoader`): a render
   source over 512 rows of the port's synthetic renderer (rendered once,
   each batch a copy of its slice, poses xyzw) feeding phase 6's flagship
   step through `device_prefetch`: the first streamed step's loss and
   updated parameters bit-equal to the same step on the same batch passed
   as a dict to a twin state; 1 more and 10 timed streamed steps, launches
   10 times phase 6's, finite losses, camera-images/s beside phase 6's
   compute-only step;
19. torchvision weight import (`models.torch_import.load_torch_resnet`): a
   seeded synthetic torchvision-layout ResNet-50 state_dict
   (`scripts/verify_torch_import_torch.py`) into the bare ResNet-50 with
   the plain stem and with `stem_space_to_depth`: pooled features of 8
   seeded 256x256 frames in f32 on the card (TF32 off) within 2e-4 of the
   largest feature of torchvision's forward rebuilt from `F.*` on the CPU;
   the same weights in a full-width NCameraCNN (head random) as a format-2
   checkpoint served by `Estimator(ckpt, batch_size=256)` with fuse "on":
   launches 1 / 1 / 3 / 10, poses within 0.05 of the f32 CPU estimator on
   8 rows;
20. profiling (`profiling.trace`, `annotate`, `profile_fn`): two flagship
   steps traced, each inside `annotate("train_step")`; the Chrome trace
   names the annotation, the augmentation kernel and a wgmma engine kernel
   (a window the profiler returns without kernel records is traced again,
   up to 5 times); `profile_fn`'s mean, p50 and p95 of the step;
21. argus_tpu's default training configuration (`TrainConfig()` and
   `NCameraCNNConfig()` as shipped: exact BN on "xla", f32, batch 32, the
   fused augmentation with 10 arcs), 2 epochs, no metrics service: its f32
   kernels at its shapes (`fused_stats` and `fused_bn_bwd_reduce` at each
   distinct (M, C) of the 53 BatchNorms at N = 64 images, strides 1 and 4,
   under phase 4's BN_RTOL; `augment_fused` at 64 images under phase 5's
   f32 gate; times beside the plain versions, the library calls and the
   bounds); one step on 8 seeded noise rows with TF32 off against the
   port's step on the CPU from the same weights (loss 1e-5, gradients and
   the running statistics' change under Path B's gates), and "auto" (53 +
   53 reduction launches) against "xla" on the card under Path B's gates;
   a resident epoch of 200 examples (the last batch padded) replayed as a
   CUDA graph against the same epoch eager, for "xla" and "auto" (the
   loop phase's gates, the running statistics and Adam moments compared
   too, launches 1 augment a step, plus 53 + 53 under "auto", bit-equality
   printed); then `train()` over 1,000 + 160 of the loop phase's rendered
   examples (31 full batches and one padded) resident and on shard swaps
   (LOOP_SHARD_MB, a padded batch in each shard), each 2 epochs and 1
   resumed, under the loop phase's checks with exact launch counts;
   camera-images/s of the second epoch and the resumed pass beside the
   compute-only step, and the replayed step beside the eager one; the TF32
   flags on every line (the epochs and `train()` under torch's defaults);
22. argus_tpu's frozen-BN ResNet-50 at its default compute dtype, f32
   (`f32_phase`): the ten f32 kernels (TF32 products) at the f32 flagship
   step's and eval forward's shapes against their plain versions at TF32
   off, within max(F32_GATE, F32_LIB_SLACK x cuDNN TF32's distance), timed
   beside them and cuDNN TF32; the f32 step "on" against "off" at TF32 off
   (loss F32_LOSS_RTOL, gradients and Adam moments within F32_STEP_SLACK x
   "off" at TF32 on), launches a step and an eval forward; "on" / "off" /
   "auto" on CUDA graphs timed in pairs, peak memory, "auto" launching what
   `AUTO_FUSE`'s f32 entries name; the "on" epoch captured, bit-equal to
   eager; `train()` at `TrainConfig(model_config=NCameraCNNConfig(
   bn_frozen=True, bn_frozen_affine=True))`, 2 epochs and 1 resumed;
23. the `kernels` JSON line, the card's name and power limit, and the result
   line `{"ok": true, "device": {...}}` last. A kernel's bound takes the
   peak that applies: 989 TFLOP/s (bf16 tensor cores) for the conv kernels,
   494.7 TFLOP/s (TF32 tensor cores) for the f32 conv kernels,
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
    # the f32 instantiations (TF32 products) of the rows above
    "stem_fused_f32": "argus_tpu/ops/pallas/stem_fused.py:244",
    "stage_fused_f32": "argus_tpu/ops/pallas/stage_fused.py:527",
    "stage_fused_save_f32": "argus_tpu/ops/pallas/stage_fused.py:364",
    "stage_fused_bwd_f32": "argus_tpu/ops/pallas/stage_fused.py:586",
    "proj_fused_f32": "argus_tpu/ops/pallas/proj_fused.py:205",
    "proj_fused_save_f32": "argus_tpu/ops/pallas/proj_fused.py:205",
    "proj_fused_bwd_f32": "argus_tpu/ops/pallas/proj_fused.py:363",
    "block_fused_f32": "argus_tpu/ops/pallas/block_fused.py:270",
    "block_fused_save_f32": "argus_tpu/ops/pallas/block_fused.py:314",
    "block_fused_bwd_f32": "argus_tpu/ops/pallas/block_fused.py:394",
}
SOURCES = {name: f"argus_tpu_torch/csrc/{name.replace('_save', '')}.cu" for name in REPLACES}
SOURCES.update(stem_fused_packed="argus_tpu_torch/csrc/stem_fused.cu",
               stage_fused_frozen="argus_tpu_torch/csrc/stage_fused.cu")
SOURCES.update(bn_stats="argus_tpu_torch/csrc/bn_reduce.cu", bn_bwd_reduce="argus_tpu_torch/csrc/bn_reduce.cu")
SOURCES.update({name: "argus_tpu_torch/csrc/conv_f32.cu" for name in REPLACES if name.endswith("_f32")},
               stem_fused_f32="argus_tpu_torch/csrc/stem_fused_f32.cu")
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
EXPECTED_EXACT_XLA_LAUNCHES = {**_NONE, "augment_fused": 1}  # the same with bn_impl="xla"
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
# interleaved graph replays per fuse setting in the auto phase, in the
# orders of AUTO_ORDERS; the fastest is kept (eager steps carried the host's
# jitter: their fastest of 288 came up to 5% apart between settings that
# launch the same kernels)
C1_ROUNDS = 288
# the order of ("on", "off", "auto") in auto-phase round r is
# AUTO_ORDERS[r % 6]: over six rounds each setting runs twice in each
# position and three times after each other setting (a step or predict
# after an "off" one tends to be slower, and rotating one order put "auto"
# after "off" twice as often as "on")
AUTO_ORDERS = ((0, 1, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0), (1, 0, 2), (0, 2, 1))
LOOP_TRAIN, LOOP_VAL = 1024, 160  # rendered examples of the loop phase: 4 train batches, 1 padded val batch
LOOP_VAL_BATCHES = 1
# the sharded run's budget (MiB): the 1024 examples of 393,244 B (384.0 MiB)
# do not fit, so they train as shards of 399, 399 and 226 (each within half
# the budget; any budget that fits a shard of half the split fits the split)
LOOP_SHARD_MB = 300.0
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
                 "stem_fused_bwd", "stem_fused"):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        n = sass.count("HGMMA")
        say(f"cuobjdump -sass {name}: {n} HGMMA instructions")
        if n == 0:
            raise AssertionError(f"{name}: no wgmma (HGMMA) instruction in its library")


def bf16x2_check() -> None:
    """The augmentation kernel's bf16 instantiations (the resident and the
    streamed form) and the blur's bf16 `blur_kernel` do their image-dtype
    ops as packed bf16x2 instructions: `cuobjdump -sass` of their libraries
    must show them in each (printed beside its f32 -> bf16 conversions, one
    per rounding in the augmentation's parent form)."""
    import re
    import shutil
    from collections import Counter

    from argus_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib, kernel, forms in (("augment_fused", "augment_kernel", 2), ("blur", "blur_kernel", 1)):
        sass = subprocess.run([tool, "-sass", str(_build.library_path(lib))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        funcs = [f for f in re.split(r"\n\s+Function : ", sass)[1:] if kernel in f.split("\n", 1)[0]]
        bf = [f for f in funcs if "bfloat16" in f.split("\n", 1)[0]]
        if len(bf) != forms:  # augment_fused: the resident and the streamed form
            raise AssertionError(f"{lib}: {len(bf)} bf16 instantiations of {kernel} in its library")
        for f in bf:
            ops = Counter(m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", f))
            packed = {k: v for k, v in ops.items()
                      if k.startswith(("HMUL2", "HADD2", "HFMA2", "HMNMX2")) and "BF16" in k}
            conv = {k: v for k, v in ops.items() if k.startswith("F2F")}
            head = f.split("\n", 1)[0]  # the mangled name: augment_kernel's kStream is its Lb0E / Lb1E
            form = ("streamed" if "Lb1E" in head or "true" in head else "resident") if forms == 2 else "band"
            say(f"cuobjdump -sass {lib} bf16 ({form}): {sum(ops.values())} instructions, packed bf16x2 "
                f"{packed}, conversions {conv}")
            if not any(k.startswith("HMUL2") for k in packed) or \
                    not any(k.startswith(("HADD2", "HFMA2")) for k in packed):
                raise AssertionError(f"{lib}: no packed bf16x2 product or sum in its bf16 {form} instantiation")


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
    from argus_tpu_torch.capture import WARMUP_STEPS
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
    for _ in range(WARMUP_STEPS + 1):  # a graph of its own for these flags: eager calls, then the capture
        est.predict(frames)
    captured = est.server.captured()
    say(f"end to end: Estimator(batch_size={N_ROWS}) on {est.device} built and warmed in "
        f"{time.perf_counter() - t0:.1f} s; config dtype={est.cfg.dtype}, fuse flags {est.cfg.fuse_stem} "
        f"(set to 'on'); graphs captured for {captured}")
    if ((N_ROWS, HW, HW, 6), tuple(FUSE_ON.values()) + ("off",)) not in captured:
        raise AssertionError(f"batch-{N_ROWS} predict is not replayed: graphs {captured}")

    kernels.reset_launch_counts()
    poses = est.predict(frames)
    launches = kernels.launch_counts()
    say(f"end to end: launches in one predict (replayed) {launches}")
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
    say(f"end to end: {ms:.2f} ms per predict of {N_ROWS} rows (replayed) = {N_ROWS / ms * 1e3:.1f} rows/s, "
        f"{N_IMG / ms * 1e3:.1f} camera-images/s (host clock, uint8 numpy in, poses numpy out)")
    # where a predict's time goes: the uint8 upload, as the estimator makes
    # it (a copy into a pinned buffer, then an asynchronous upload) and from
    # pageable memory, host clock; the graph's replay on a staged batch
    server = est.server
    upload_ms, pageable_ms = upload_times(server, frames, reps)
    staged = server.staging[frames.shape].dev_in
    with torch.inference_mode():
        replay_ms = cuda_ms(lambda: server.program.net(staged), reps)
    say(f"end to end breakdown: uint8 upload {upload_ms:.2f} ms through the pinned buffer "
        f"({frames.nbytes / 1e6:.0f} MB; from pageable memory {pageable_ms:.2f} ms), the graph's replay "
        f"{replay_ms:.2f} ms on the card; together {upload_ms + replay_ms:.2f} ms of the {ms:.2f} ms predict "
        f"(separate runs, so the two may not add up exactly)")

    t0 = time.perf_counter()
    cpu = Estimator(ckpt, batch_size=8, device="cpu")
    ref = cpu.predict(frames[:8])
    err = float(np.abs(poses[:8] - ref).max())
    say(f"end to end: GPU vs CPU poses on the first 8 rows: max abs diff {err:.4g} (atol {POSE_ATOL}), "
        f"|pose| max {float(np.abs(ref).max()):.3g}, CPU estimator {time.perf_counter() - t0:.1f} s")
    if not err <= POSE_ATOL:
        raise AssertionError(f"GPU poses differ from the CPU estimator by {err} > {POSE_ATOL}")
    return launches, ms, ckpt, frames, poses


def upload_times(server, frames, reps: int) -> tuple:
    """(ms of the estimator's upload through its pinned buffer, ms of one
    upload from pageable memory) of `frames`, host clock, each
    synchronised."""
    import torch

    on_card = torch.empty(frames.shape, dtype=torch.uint8, device="cuda")
    times = {}
    for how in ("pinned", "pageable"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            if how == "pinned":
                server.stage(frames)
            else:
                on_card.copy_(torch.from_numpy(frames))
            torch.cuda.synchronize()
        times[how] = (time.perf_counter() - t0) / reps * 1e3
    return times["pinned"], times["pageable"]


# ─────────────────── phase 3b: the control loop and export ───────────────────

LOOP_CALLS = 200  # timed batch-1 predicts of each kind; p50 and p90 kept
SAME_MODEL_ATOL = 1e-5  # two estimators of one model on the same card and frames
# a process that serves an exported program with no checkpoint and no model code
_EXPORTED_ALONE = r"""
import json, sys
import numpy as np
import torch
from argus_tpu_torch.ops import kernels
from argus_tpu_torch.serve import ExportedEstimator

out = {}
for path, frames_path in zip(sys.argv[1::2], sys.argv[2::2]):
    est = ExportedEstimator(path)
    frames = np.load(frames_path)
    kernels.reset_launch_counts()
    poses = est.predict(frames)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes if n.op == "call_function"]
    ops = {t: targets.count(t) for t in sorted(set(targets)) if t.startswith("argus.")}
    np.save(path + ".poses.npy", poses)
    out[path] = {"launches": launches, "ops": ops, "captured": [str(k) for k in est.server.captured()]}
models = sorted(m for m in sys.modules if m.startswith(("argus_tpu_torch.models", "argus_tpu_torch.checkpoint")))
assert not models, models
print(json.dumps(out))
"""


def _percentiles(ts) -> tuple:
    ts = sorted(ts)
    return ts[len(ts) // 2], ts[int(len(ts) * 0.9)]


def _host_ms(fn, n: int = LOOP_CALLS) -> tuple:
    """(p50, p90) ms of `fn()` by the host's clock over n calls, each ended
    by what `fn` returns on the host."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return _percentiles(ts)


def control_loop_phase(tmpdir: str, ckpt: str, frames256, poses256) -> None:
    """The control loop's path at batch 1 and the exported programs: the
    f32 NCameraCNN estimator replayed against the same model run eagerly
    here and the upload alone, its pose against the eager one and the CPU
    estimator's; the keypoint family the same way (its fit on the card after
    the replay); `make_pose_estimator` against the estimator; one validation
    step with augmentation; then `export_estimator` at batch 256 and 1,
    served by `ExportedEstimator` in a process of its own with no
    checkpoint and no model code: launches, ops, poses."""
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.geom import random_SE3, se3_exp
    from argus_tpu_torch.models import CubeKeypointNet, CubeKeypointNetConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.models.keypoint_net import fit_pose
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.ops.augment import AugmentationConfig, fold_in
    from argus_tpu_torch.serve import Estimator, export_estimator, load_model
    from argus_tpu_torch.validate import validation_step
    from argus_tpu_torch.validate_real import make_pose_estimator

    t_phase = time.perf_counter()
    tf32 = f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (8, HW, HW, 6), dtype=np.uint8)
    one = [np.ascontiguousarray(frames[i:i + 1]) for i in range(8)]

    def pose_diff(a, b):  # translation and quaternion (up to sign) together, max abs
        flip = np.where(np.sum(a[:, 3:] * b[:, 3:], -1, keepdims=True) < 0, -1.0, 1.0)
        return float(max(np.abs(a[:, :3] - b[:, :3]).max(), np.abs(a[:, 3:] - flip * b[:, 3:]).max()))

    # ── batch 1, the two families: replayed, eager, the upload alone ──
    kp_ckpt = os.path.join(tmpdir, "keypoint_serving.ckpt")
    torch.manual_seed(0)
    kcfg = CubeKeypointNetConfig(bn_frozen=True, bn_frozen_affine=True, stem_frozen=True, **KP_FUSE)
    kp_model = CubeKeypointNet(kcfg)
    _randomize_(kp_model, seed=0, last_bn="BatchNorm_1", out_layer="heatmap")
    params, stats = variables_from_state_dict(kp_model.state_dict())
    save_checkpoint(kp_ckpt, {"params": params, "batch_stats": stats},
                    meta={"model_type": "keypoint", "model_config": dataclasses.asdict(kcfg), "center_crop": [HW, HW]})
    del kp_model, params, stats
    for family, path in (("NCameraCNN", ckpt), ("keypoint", kp_ckpt)):
        est = Estimator(path, batch_size=1)
        captured = est.server.captured()
        if not any(shape == (1, HW, HW, 6) for shape, _ in captured):
            raise AssertionError(f"{family} batch-1 predict is not replayed: graphs {captured}")
        kernels.reset_launch_counts()
        i = iter(range(10 ** 9))
        replayed = _host_ms(lambda: est.predict(one[next(i) % 8]))
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        model, cam_P = est.model, est.cam_P

        @torch.inference_mode()
        def eager(f):
            pred = model(torch.from_numpy(f).to("cuda").float() / 255.0)
            return (fit_pose(cam_P, pred[0]) if family == "keypoint" else se3_exp(pred)).cpu().numpy()

        for _ in range(3):
            eager(one[0])
        eager_ms = _host_ms(lambda: eager(one[next(i) % 8]))
        def upload(f):
            est.server.stage(f)
            torch.cuda.current_stream().synchronize()

        upload_ms = _host_ms(lambda: upload(one[next(i) % 8]))
        got = np.concatenate([est.predict(f) for f in one[:4]])
        ref = np.concatenate([eager(f) for f in one[:4]])
        cpu = Estimator(path, batch_size=1, device="cpu")
        want = np.concatenate([cpu.predict(f) for f in one[:2]])
        d_eager, d_cpu = pose_diff(got, ref), pose_diff(got[:2], want)
        with torch.inference_mode():  # the graph's replay alone, on the card; the keypoint fit alone
            staged = est.server.staging[one[0].shape].dev_in
            replay_ms = cuda_ms(lambda: est.server.program.net(staged), 50)
            fit_where = ""
            if family == "keypoint":
                uv = est.server.program.net(staged)
                fit_ms = _host_ms(lambda: est.program.fit(uv).cpu())
                fit_where = (f"; the pose fit (torch.linalg solve, SVD, det) runs on the card after the replay, "
                             f"eagerly: alone p50 {fit_ms[0]:.3f}, p90 {fit_ms[1]:.3f} ms")
        say(f"control loop, {family} batch 1 (f32, plain convs; {tf32}): Estimator.predict replayed p50 "
            f"{replayed[0]:.3f} ms, p90 {replayed[1]:.3f} ms over {LOOP_CALLS} calls; the same model run eagerly "
            f"here (upload, model, {'fit' if family == 'keypoint' else 'se3_exp'}, download) p50 {eager_ms[0]:.3f}, "
            f"p90 {eager_ms[1]:.3f} ms; the upload alone (pinned) p50 {upload_ms[0]:.3f}, p90 {upload_ms[1]:.3f} ms "
            f"(host clock, numpy in and out); the graph's replay alone {replay_ms:.3f} ms (CUDA events){fit_where}; kernel launches {launched or 'none'}; replayed vs eager "
            f"max |diff| {d_eager:.3g} ({'bit-equal' if np.array_equal(got, ref) else 'not bit-equal'}), vs the CPU "
            f"estimator {d_cpu:.3g} (atol {POSE_ATOL})")
        if launched or not np.isfinite(got).all() or d_cpu > POSE_ATOL or d_eager > POSE_ATOL:
            raise AssertionError(f"{family} batch-1 serving: launches {launched}, replayed vs eager {d_eager}, "
                                 f"vs CPU {d_cpu}")
        if family == "NCameraCNN":
            # make_pose_estimator on the same model and frames, and one validation step
            model_v, _, model_type, _ = load_model(ckpt)
            mpe = make_pose_estimator(model_v, model_type=model_type, crop=(HW, HW))
            d_mpe = pose_diff(np.concatenate([mpe.predict(f) for f in one[:4]]), got)
            poses = random_SE3(torch.Generator().manual_seed(4), (4,)).numpy()
            _, _, val_losses = validation_step(mpe.model, model_type, frames[:4], poses, fold_in(0, 1),
                                               AugmentationConfig(), use_train=True)
            val_losses = val_losses.cpu().numpy()
            say(f"control loop: make_pose_estimator vs Estimator on 4 frames max |diff| {d_mpe:.3g} (tol "
                f"{SAME_MODEL_ATOL}); validation_step on 4 frames with augmentation: losses {val_losses.round(4).tolist()}")
            if d_mpe > SAME_MODEL_ATOL or not np.isfinite(val_losses).all():
                raise AssertionError(f"make_pose_estimator {d_mpe}, validation losses {val_losses}")
            del mpe, model_v
        del est, cpu, model
        torch.cuda.empty_cache()

    # ── export at batch 256 and 1, served in a process of its own ──
    t0 = time.perf_counter()
    paths = {n: os.path.join(tmpdir, f"resnet50_b{n}.pt2") for n in (N_ROWS, 1)}
    for n, path in paths.items():
        export_estimator(ckpt, path, batch_size=n)
        np.save(path + ".frames.npy", frames256 if n == N_ROWS else one[0])
    export_s = time.perf_counter() - t0
    ref1 = Estimator(ckpt, batch_size=1).predict(one[0])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _EXPORTED_ALONE] + [a for n, p in paths.items()
                                                                     for a in (p, p + ".frames.npy")],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving the exported programs failed:\n{proc.stderr[-6000:]}")
    served = json.loads(proc.stdout.strip().splitlines()[-1])
    want_ops = {"argus.stem_fwd.default": 1, "argus.stage_fwd.default": 1, "argus.projection_block.default": 3,
                "argus.bottleneck_block.default": 10}
    for n, path in paths.items():
        r = served[path]
        got = np.load(path + ".poses.npy")
        err = pose_diff(got, poses256 if n == N_ROWS else ref1)
        size = os.path.getsize(path) / 2**20
        say(f"export: batch {n}, {size:.0f} MiB, loaded alone (no checkpoint, no model module): graphs "
            f"{r['captured']}, argus ops {r['ops'] or 'none'}, launches in one predict {r['launches'] or 'none'}; "
            f"poses vs the Estimator's max |diff| {err:.3g} (atol {POSE_ATOL})")
        want_launches = {k: v for k, v in EXPECTED_LAUNCHES.items() if v} if n == N_ROWS else {}
        if (r["ops"] != (want_ops if n == N_ROWS else {}) or r["launches"] != want_launches or not r["captured"]
                or not np.isfinite(got).all() or err > POSE_ATOL):
            raise AssertionError(f"exported batch-{n} program: {r}, pose diff {err}")
    say(f"control loop and export phase: {time.perf_counter() - t_phase:.1f} s (the two exports {export_s:.1f} s, "
        f"the loading process {time.perf_counter() - t0:.1f} s)")


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


def _bn_close(name, got, want, scale):
    """A BN reduction's sums against the plain version's within BN_RTOL of
    each channel's sum of magnitudes: (max relative, max absolute)."""
    err = (got - want).abs()
    bad = err > BN_RTOL * scale + 1e-6
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: {int(bad.sum())} channels beyond {BN_RTOL} of their sum of magnitudes, "
                             f"max rel {(err / scale.clamp(min=1e-30)).max().item():.3g}")
    return (err / scale.clamp(min=1e-30)).max().item(), err.max().item()


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
    # the no-save and packed forwards compute the same bits (the weight
    # gradient's first-match search compares the saved out with y)
    if not torch.equal(stem_fused.stem_fwd(x, w7, b7), out) or \
            not torch.equal(stem_fused.stem_fwd_packed(x, w7, b7), stem_fused.packed_view(out)):
        raise AssertionError("stem_fused / stem_fused_packed differ from stem_fused_save's out")
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
    # output 100 x 68), and a width whose patch rows go by cp.async (W % 8 != 0);
    # the forwards there and at two small images (one of them W % 8 != 0),
    # each within one bf16 ulp of the plain version, the no-save and packed
    # forwards the saving one's out bit for bit (no packed view at W % 8 != 0)
    for shape in ((16, 200, 136), (16, 200, 132), (16, 36, 44), (16, 72, 40)):
        xs = torch.rand(*shape, 3, generator=g, device="cuda").to(bf)
        os_, ys = stem_fused.stem_fwd_save(xs, w7, b7)
        po, py = stem_fused.stem_fwd_save_plain(xs, w7, b7)
        err = max(err, _ulp_compare(f"stem_fused_save {shape} out", os_, po),
                  _ulp_compare(f"stem_fused_save {shape} y", ys, py))
        err = max(err, _ulp_compare(f"stem_fused {shape}", stem_fused.stem_fwd(xs, w7, b7), po))
        if not torch.equal(stem_fused.stem_fwd(xs, w7, b7), os_):
            raise AssertionError(f"stem_fused {shape}: differs from stem_fused_save's out")
        if shape[2] % 8 == 0:
            packed = stem_fused.stem_fwd_packed(xs, w7, b7)
            err = max(err, _ulp_compare(f"stem_fused_packed {shape}", packed, stem_fused.packed_view(po)))
            if not torch.equal(packed, stem_fused.packed_view(os_)):
                raise AssertionError(f"stem_fused_packed {shape}: differs from stem_fused_save's out")
        results["stem_fused_save"]["max_abs_err"] = max(results["stem_fused_save"]["max_abs_err"], err)
        if shape[1] < 200:
            continue
        gs = torch.randn(os_.shape, generator=g, device="cuda").to(bf)
        for n_images in (shape[0], shape[0] // 4):
            got = stem_fused.stem_bwd(xs, gs, os_, ys, n_images)
            entry["max_abs_err"] = max(entry["max_abs_err"], _compare(
                f"stem_fused_bwd {shape} n_images={n_images}", got, stem_fused.stem_bwd_plain(xs, gs, os_, ys, n_images)))
            if not torch.equal(got, stem_fused.stem_bwd(xs, gs, os_, ys, n_images)):
                raise AssertionError(f"stem_fused_bwd {shape} n_images={n_images}: two calls on the same input differ")
    del xs, os_, ys, gs
    torch.cuda.empty_cache()

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
            (r1, a1), (r2, a2) = _bn_close("bn_stats sum", k_s, p_s, xa.sum(0)), \
                _bn_close("bn_stats sumsq", k_q, p_q, (xa * xa).sum(0))
            e1, e1_abs = max(r1, r2), max(a1, a2)
            k_d, k_dx, k_n2 = bn_reduce.fused_bn_bwd_reduce(xb, dy, mean, rstd, stride)
            p_d, p_dx, p_n2 = bn_reduce.fused_bn_bwd_reduce_plain(xb, dy, mean, rstd, stride)
            if k_n2 != p_n2 or k_n2 != k_n:
                raise AssertionError(f"bn_bwd_reduce ({m}, {c}) stride {stride}: n_rows {k_n2} != plain {p_n2}")
            xh = ((rows.float() - mean) * rstd).abs()
            (r1, a1), (r2, a2) = _bn_close("bn_bwd_reduce sum dy", k_d, p_d, da.sum(0)), \
                _bn_close("bn_bwd_reduce sum dy*xhat", k_dx, p_dx, (da * xh).sum(0))
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
    # bit for bit at the flagship's shape and at small ones (one band, an odd
    # width with a band shorter than its halo), in both dtypes
    for dt in ("bf16", "f32"):
        cases = [blur_args(dt)]
        for n, h, w in ((3, 40, 72), (2, 17, 33)):
            xr = torch.rand(n, 3, h, w, generator=g, device="cuda").to(x[dt].dtype)
            pr = TA.sample_params(cfg, 13, n, 1, h, w, "cuda", xr.dtype)
            (gw_, gg_), (mk_, mg_) = pr.gauss, pr.motion
            cases.append((xr, gw_, mk_, torch.stack([gg_, mg_], 1)))
        for args in cases:
            got, want = kb.fused_random_blur(*args), kb.fused_random_blur_plain(*args)
            bad = int((got != want).sum())
            say(f"blur {dt} {tuple(args[0].shape)}: {bad} elements differ from the plain version")
            if bad or not torch.equal(got, want):
                raise AssertionError(f"blur {dt} {tuple(args[0].shape)}: not bit-equal to its plain version")
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


def flagship_train_setup(amp: bool = True, **model_overrides):
    """(cfg, model, state, batch) of the flagship train step on the card:
    ResNet-50 NCameraCNN at full width (2 cameras, 1024-d features), bf16
    (f32, argus_tpu's default, with `amp=False`),
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
    cfg = TrainConfig(model_config=mcfg, amp=amp, use_augmentation=True,
                      augmentation_config=AugmentationConfig(), batch_size=N_ROWS, learning_rate=1e-4,
                      max_grad_norm=1.0)
    model, state = create_train_state(cfg, seed=0)
    _randomize_(model, seed=0)  # in place: the state holds the same parameters
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {
        "images": torch.randint(0, 256, (N_ROWS, HW, HW, 6), generator=g, device="cuda", dtype=torch.uint8),
        "cube_pose": torch.from_numpy(_random_poses(np.random.default_rng(2), N_ROWS)).cuda(),
        "mask": torch.ones(N_ROWS, device="cuda"),
    }
    return cfg, model, state, batch


def _random_poses(rng, n: int):
    """(n, 7) f32 non-identity poses (xyz, then an xyzw quaternion of a
    random axis and an angle below 1 rad) drawn from `rng`."""
    import numpy as np

    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.0, 1.0, (n, 1))
    return np.concatenate([rng.normal(0, 0.3, (n, 3)), axis * np.sin(angle / 2), np.cos(angle / 2)], 1).astype(
        np.float32)


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


def accum_phase() -> tuple:
    """The flagship step with `grad_accum_steps=2` against
    `grad_accum_steps=1` (phase 6's step; `train.TrainStepBody`'s loss and
    combined gradient) on the same 8 augmented rows, under phase 6's gates;
    then 6 timed steps of each at batch 256 (two microbatches of 128 rows
    for accumulation), launches per step (the model's kernels twice, the
    augmentation once) and peak memory. Returns (launches per accumulated
    step, {accum: (ms/step, peak bytes)})."""
    import torch

    from argus_tpu_torch.train import TrainStepBody, make_train_step

    cfg, model, state, batch = flagship_train_setup()
    cfg2 = dataclasses.replace(cfg, grad_accum_steps=2)
    head, images = _eight_rows(cfg, batch)
    args = (state.params, images, head["cube_pose"], head["mask"])
    loss1, g1 = TrainStepBody(model, cfg)._loss_and_grads(*args)
    loss2, g2 = TrainStepBody(model, cfg2)._loss_and_grads(*args)
    errs = _grad_errors(g2, g1)
    worst, median, name = _spread(errs)
    loss_err = abs(loss2.item() - loss1.item()) / abs(loss1.item())
    say(f"accumulation: grad_accum_steps=2 vs 1 on the first 8 augmented rows: loss {loss2.item():.6f} vs "
        f"{loss1.item():.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}); gradients of {len(errs)} parameters: "
        f"max rel {worst:.3g} ({name}), median {median:.3g} (tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN})")
    if not (loss_err <= TRAIN_LOSS_RTOL and worst <= GRAD_RTOL and median <= GRAD_RTOL_MEDIAN):
        raise AssertionError("the accumulated step disagrees with the whole-batch one")
    del g1, g2, head, images, args
    runs = {}
    for accum, c in ((1, cfg), (2, cfg2)):
        torch.cuda.empty_cache()
        launches, ms, state = _time_steps(make_train_step(model, c), state, batch, f"grad_accum_steps={accum}")
        runs[accum] = (launches, ms, torch.cuda.max_memory_allocated())
    want = {k: v if k == "augment_fused" else 2 * v for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    if runs[2][0] != want or runs[1][0] != EXPECTED_TRAIN_LAUNCHES:
        raise AssertionError(f"accumulation launch counts {runs[2][0]} != {want}")
    say(f"accumulation on {GPU}: grad_accum_steps=2 {runs[2][1]:.2f} ms/step, peak {runs[2][2] / 2**30:.2f} GiB; "
        f"grad_accum_steps=1 {runs[1][1]:.2f} ms/step, peak {runs[1][2] / 2**30:.2f} GiB (batch {N_ROWS}, "
        f"CUDA events, peak after each warm-up step)")
    del model, state, batch
    torch.cuda.empty_cache()
    return runs[2][0], {a: r[1:] for a, r in runs.items()}


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
    if runs["xla"][0] != EXPECTED_EXACT_XLA_LAUNCHES:
        raise AssertionError(f"path B (xla) launch counts {runs['xla'][0]} != expected {EXPECTED_EXACT_XLA_LAUNCHES}")
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
    from argus_tpu_torch.train import WARMUP_STEPS, _loss_and_grads_on, create_train_state, feed_images, \
        make_loss_fn, make_resident_epoch_step, make_train_step

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

    # one resident epoch of 3 batches and a padded fourth, captured: its
    # first WARMUP_STEPS steps eager, then the capture and replays
    n_res = 3 * N_ROWS + 8
    g = torch.Generator(device="cuda").manual_seed(8)
    frames = torch.randint(0, 256, (n_res, HW, HW, 6), generator=g, device="cuda", dtype=torch.uint8)
    poses = batch["cube_pose"].repeat(4, 1)[:n_res].contiguous()
    epoch_step, k = make_resident_epoch_step(model, cfg, base_seed=3, n_examples=n_res, hw=(HW, HW))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, res_losses = epoch_step(state, frames, poses, 0)
    res_losses = res_losses.tolist()
    res_s = time.perf_counter() - t0
    res_launches = kernels.launch_counts()
    want = {name: k * v for name, v in EXPECTED_KP_LAUNCHES.items()}
    say(f"keypoint resident epoch ({n_res} examples, {k} steps, {WARMUP_STEPS} eager then captured and replayed): "
        f"losses {[round(v, 4) for v in res_losses]}, {res_s:.2f} s with the capture; launches {res_launches}")
    if epoch_step.run.graph is None or res_launches != want or not np.isfinite(res_losses).all():
        raise AssertionError(f"keypoint resident epoch: captured {epoch_step.run.graph is not None}, launches "
                             f"{res_launches} != {want}, losses {res_losses}")
    del epoch_step, frames, poses
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

    table = {(f, m): v for (f, m, d), v in AUTO_FUSE.items() if d == "bfloat16"}  # the flagship runs in bf16
    want = dict(_NONE, augment_fused=int(augment and not serving))

    def mode(frozen):
        return "forward" if serving or frozen else "train"

    stem_on = table[("stem", "train" if stem_trained and not serving else "forward")]
    packed = stem_on and frozen_stages >= 1 and table[("stage_chain_packed", "forward")]
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
            if table[(chain, m)]:
                if m == "forward":
                    want["stage_fused" if i == 0 else "stage_fused_frozen"] += 1
                else:
                    want["stage_fused_save"] += 1
                    want["stage_fused_bwd"] += 1
                continue
        for name, count, fn in (("proj_fused", 1, "projection"), ("block_fused", n - 1, "identity")):
            if table[(fn, m)]:
                if m == "forward":
                    want[name] += count
                else:
                    want[name + "_save"] += count
                    want[name + "_bwd"] += count
            elif pointwise and table[("pointwise", m)]:  # Conv_0 and Conv_2 of each block the kernels do not take
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


def _replay_rounds(call, settings) -> dict:
    """{flags: [ms]}: `call(flags)` timed by CUDA events, C1_ROUNDS times
    for each of `settings`, interleaved in AUTO_ORDERS, so that the card's
    clocks and the call before fall on all of them alike."""
    import torch

    torch.cuda.synchronize()
    out = {}
    for r in range(C1_ROUNDS):
        order = [settings[i] for i in AUTO_ORDERS[r % 6]]
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in order]
        for flags, (e0, e1) in zip(order, events):
            e0.record()
            call(flags)
            e1.record()
        torch.cuda.synchronize()
        for flags, (e0, e1) in zip(order, events):
            out.setdefault(flags, []).append(e0.elapsed_time(e1))
    return out


def auto_phase(tmpdir: str) -> dict:
    """The fuse flags all "on", all "off" and all "auto" in one call, for the
    flagship step, the `frozen_stages=3` step (both batch 256) and batch-256
    serving. Each setting of a workload gets its own CUDA graph, as the
    resident training path and the estimator run it: the step's
    `TrainStepBody.compute` through `capture.CapturedCall` on operands
    prepared once, the estimator's replayed program on its staged frames.
    The three graphs are replayed interleaved in AUTO_ORDERS, C1_ROUNDS
    times each, timed by CUDA events, and the fastest is kept. A replay
    holds only what the flags change: an eager step also waits for the
    host's ~100 sampling ops and its launches, which moved the fastest of
    288 eager steps up to 5% between settings that launch the same kernels,
    and the host clock around a predict also holds its 100 MB upload.
    Prints `AUTO_FUSE`'s choice for each function and mode; an "auto" step
    (eager) and predict must launch exactly what the table names, and
    "auto" must be no slower than the faster of "on" and "off" by more than
    AUTO_SLACK. Returns {workload: {flags: ms}}."""
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.capture import WARMUP_STEPS, CapturedCall
    from argus_tpu_torch.models.resnet import AUTO_FUSE
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.serve import Estimator
    from argus_tpu_torch.train import TrainStepBody, make_train_step

    say("auto: AUTO_FUSE " + ", ".join(f"{f}/{m}/{d} {'on' if v else 'off'}" for (f, m, d), v in AUTO_FUSE.items()))
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
        body = TrainStepBody(model, cfg)
        operands = body.prepare(state.step, batch["images"], batch["cube_pose"], batch["mask"])
        runs = {}
        for flags in settings:  # each setting's own graph of the step's compute: eager calls, then its capture
            switch(model.backbone, flags)
            runs[flags] = CapturedCall(body.compute, body.device)
            for _ in range(WARMUP_STEPS + 1):
                runs[flags](state, operands)
        steps = _replay_rounds(lambda flags: runs[flags](state, operands), settings)
        for flags in settings:
            ms = min(steps[flags])
            timings.setdefault(workload, {})[flags] = ms
            say(f"auto: {workload} step, flags {flags}: fastest of {C1_ROUNDS} replays {ms:.2f} ms/step, median "
                f"{sorted(steps[flags])[C1_ROUNDS // 2]:.2f} ({N_IMG / ms * 1e3:.1f} camera-images/s; launches "
                f"of an eager step {({k: v for k, v in launched[flags].items() if v})})")
        del model, state, batch, step, body, operands, runs
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
    for flags in settings:
        switch(est.model.backbone, flags, pointwise=False)  # batched serving keeps fuse_pointwise "off"
        for _ in range(WARMUP_STEPS + 1):  # each setting's own graph: eager calls, then its capture
            est.predict(frames)
        kernels.reset_launch_counts()
        est.predict(frames)
        launches = kernels.launch_counts()
        if flags == "auto":
            want = _expected_launches(0, stem_trained=False, serving=True)
            if launches != want:
                raise AssertionError(f"auto serving: launches {launches} != the table's {want}")
        say(f"auto: serving, flags {flags}: launches in a replayed predict "
            f"{({k: v for k, v in launches.items() if v})}")
    staged = est.server.stage(frames).dev_in  # the frames in the graphs' static input

    def replay(flags):  # the program's graph of these flags (the graphs are keyed by them) on the staged frames
        switch(est.model.backbone, flags, pointwise=False)
        with torch.inference_mode():
            est.server.program(staged)

    times = _replay_rounds(replay, settings)
    for flags, ts in times.items():
        timings.setdefault("serving", {})[flags] = min(ts)
        say(f"auto: serving predict of {N_ROWS} rows, flags {flags}: fastest of {C1_ROUNDS} replays of its program "
            f"{min(ts):.2f} ms, median {sorted(ts)[C1_ROUNDS // 2]:.2f} ms (CUDA events on the staged frames, "
            f"interleaved with the other settings)")
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

    def _out_hw(self):
        return tuple(self.images.shape[1:3])

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


def _loop_runs(cfg, datasets):
    """`train()` for 2 epochs, then a run resumed from the file that saved
    for 1 more: (first file, resumed file, each run's records, the first
    run's launches, host clock as each run's set-up returned, seconds of
    each run)."""
    import torch

    from argus_tpu_torch import logging_utils
    from argus_tpu_torch import train as ttrain
    from argus_tpu_torch.ops import kernels

    ready = []
    orig_logger, orig_init = logging_utils.MetricsLogger, ttrain.initialize_training

    def init(*a, **k):
        setup = orig_init(*a, **k)
        torch.cuda.synchronize()
        ready.append(time.perf_counter())
        return setup

    logging_utils.MetricsLogger, ttrain.initialize_training = _Recorder, init
    try:
        _Recorder.runs.clear()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        first = ttrain.train(cfg, datasets=datasets)
        t_first = time.perf_counter() - t0
        launches = kernels.launch_counts()
        datasets[0].requested.clear()
        t0 = time.perf_counter()
        resumed = ttrain.train(dataclasses.replace(cfg, n_epochs=1, resume_from=first), datasets=datasets)
        t_resumed = time.perf_counter() - t0
    finally:
        logging_utils.MetricsLogger, ttrain.initialize_training = orig_logger, orig_init
    return first, resumed, [r.records for r in _Recorder.runs], launches, ready, (t_first, t_resumed)


def _check_loop(label, cfg, first, resumed, runs, launches, per_epoch, times, want_launches=None):
    """The loop's checks: finite losses and val losses, the step count
    continuing (2 epochs, then 3), the first file restoring bit-equal into
    a fresh `TrainState` (running statistics and Adam moments included),
    and the first run's launches: `want_launches` exactly where given, else
    (the fine-tune) every kernel "auto" names for this path launched
    (`stem_fused_packed` once a train step and once a val batch)."""
    import numpy as np

    from argus_tpu_torch.checkpoint import load_checkpoint, train_state_tree
    from argus_tpu_torch.train import create_train_state

    losses = [[m["loss"] for _, _, m in r if "loss" in m] for r in runs]
    vals = [[m["val_loss"] for _, _, m in r if "val_loss" in m] for r in runs]
    say(f"loop ({label}): train() 2 epochs in {times[0]:.1f} s, resumed 1 epoch in {times[1]:.1f} s (model set-up, "
        f"datasets and checkpoint files included); losses {[round(v, 4) for v in losses[0]]} then "
        f"{[round(v, 4) for v in losses[1]]}; val losses {[round(v, 4) for v in vals[0]]} then "
        f"{[round(v, 4) for v in vals[1]]}; launches over both epochs {({k: v for k, v in launches.items() if v})}")
    first_tree, final_tree = load_checkpoint(first), load_checkpoint(resumed)
    steps = (int(first_tree["step"]), int(final_tree["step"]))
    if steps != (2 * per_epoch, 3 * per_epoch) or len(losses[0]) != 2 * per_epoch or len(losses[1]) != per_epoch:
        raise AssertionError(f"loop ({label}): step counts {steps}, losses {len(losses[0])} + {len(losses[1])}")
    if not (np.isfinite(losses[0] + losses[1]).all() and np.isfinite(vals[0] + vals[1]).all()
            and len(vals[0]) == 2 and len(vals[1]) == 1):
        raise AssertionError(f"loop ({label}): non-finite or missing losses {losses} {vals}")
    if want_launches is not None:
        if launches != want_launches:
            raise AssertionError(f"loop ({label}): launches {launches} != expected {want_launches}")
    else:
        want = {k for k, v in _expected_launches(3, stem_trained=False).items() if v}
        want |= {k for k, v in _expected_launches(3, stem_trained=False, serving=True).items() if v}
        missed = sorted(k for k in want if not launches[k])
        if missed or launches["stem_fused_packed"] != 2 * (per_epoch + LOOP_VAL_BATCHES):
            raise AssertionError(f"loop ({label}): kernels of the path not launched {missed} (launches {launches})")

    _, fresh = create_train_state(cfg, seed=5)
    load_checkpoint(first, target=fresh)

    def leaves(t, pre=""):
        for k, v in t.items():
            yield from leaves(v, f"{pre}/{k}") if isinstance(v, dict) else [(f"{pre}/{k}", np.asarray(v))]

    a, b = dict(leaves(train_state_tree(fresh))), dict(leaves(first_tree))
    unequal = [k for k in b if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
    if a.keys() != b.keys() or unequal:
        raise AssertionError(f"loop ({label}): the saved state does not restore bit-equal: {unequal[:5]}")
    say(f"loop ({label}): {first} restores bit-equal into a fresh TrainState ({len(b)} leaves); steps {steps[0]} "
        f"then {steps[1]}")


def _second_epoch_ms(records, per_epoch):
    """ms a step of the first run's second epoch (its train pass, while
    epoch 0's file is written): from epoch 0's val loss to epoch 1's losses,
    which are logged when its pass ends."""
    t_val0 = next(t for t, s, m in records if "val_loss" in m)
    t_loss1 = [t for t, s, m in records if "loss" in m][per_epoch]
    return (t_loss1 - t_val0) / per_epoch * 1e3


def _loop_config(save_dir: str):
    """The loop phase's `TrainConfig`: the `frozen_stages=3` fine-tune at
    full width, batch 256, amp, 2 epochs, no metrics service."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    mcfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50", bn_frozen=True,
                            bn_frozen_affine=True, stem_frozen=True, frozen_stages=3)
    return TrainConfig(model_config=mcfg, amp=True, batch_size=N_ROWS, n_epochs=2, learning_rate=1e-4,
                       wandb_log=False, num_workers=8, save_dir=save_dir)


def loop_phase(tmpdir: str) -> dict:
    """`train()` on the card at full width: the `frozen_stages=3` fine-tune
    (ResNet-50 NCameraCNN, 2 cameras, 1024-d features, 256x256, batch 256,
    amp, frozen BN and affine, augmentation on, fuse "auto") on LOOP_TRAIN +
    LOOP_VAL rendered examples, on each of argus_tpu's three data paths: the
    host feed (`device_resident_mb=0`: `HostDataLoader` and the device
    feed), the default budget (2048 MiB: the split resident on the card, each
    epoch's step replayed as a CUDA graph) and LOOP_SHARD_MB (shards of 399,
    399 and 226 swapped in per epoch, 2 + 2 + 1 steps an epoch). Each: 2 epochs,
    then a run resumed from the file that saved for 1 more, under
    `_check_loop`'s checks (launches counted through the replays). Then one
    resident epoch replayed against the same epoch run eagerly on the card
    (`_captured_vs_eager`). Prints end-to-end camera-images/s of each path
    beside the compute-only step on a resident batch: the resumed run's
    train pass (the host feed's from its first batch request, the resident
    paths' from the end of `initialize_training`, so with their 2 eager
    steps and the capture), and the first run's second epoch (every step
    replayed; epoch 0's file is written meanwhile); and how long
    `AsyncCheckpointer.save` holds the caller."""
    import torch

    from argus_tpu_torch.checkpoint import AsyncCheckpointer, load_checkpoint
    from argus_tpu_torch.data.resident import ResidentShardedData
    from argus_tpu_torch.data.synthetic import render_dataset_arrays
    from argus_tpu_torch.train import WARMUP_STEPS, create_train_state, make_train_step

    t0 = time.perf_counter()
    sets = [render_dataset_arrays(n, HW, HW, seed=s) for n, s in ((LOOP_TRAIN, 10), (LOOP_VAL, 11))]
    datasets = tuple(FramesDataset(*a) for a in sets)
    say(f"loop: rendered {LOOP_TRAIN} + {LOOP_VAL} corner-projection examples ({HW}x{HW}, 2 cameras) in "
        f"{time.perf_counter() - t0:.1f} s; PNG decode is not on this path (no HDF5 writer on this host)")
    base = _loop_config(os.path.join(tmpdir, "ckpt"))
    per_epoch = LOOP_TRAIN // N_ROWS
    shards = ResidentShardedData(datasets[0], LOOP_SHARD_MB)
    shard_steps = sum(-(-len(idx) // N_ROWS) for idx in shards.index_shards)
    if len({len(idx) for idx in shards.index_shards}) != 2:
        raise AssertionError(f"LOOP_SHARD_MB gives shards {[len(i) for i in shards.index_shards]}")
    out = {}
    for label, budget, steps in (("host feed", 0.0, per_epoch), ("resident", base.device_resident_mb, per_epoch),
                                 ("sharded", LOOP_SHARD_MB, shard_steps)):
        cfg = dataclasses.replace(base, device_resident_mb=budget)
        first, resumed, runs, launches, ready, times = _loop_runs(cfg, datasets)
        _check_loop(label, cfg, first, resumed, runs, launches, steps, times)
        t_resumed_loss = next(t for t, s, m in runs[1] if "loss" in m)
        start = datasets[0].requested[0] if label == "host feed" else ready[1]
        out[label] = dict(e2e_ms=(t_resumed_loss - start) / steps * 1e3,
                          saving_ms=_second_epoch_ms(runs[0], steps), first=first)
        torch.cuda.empty_cache()

    model, state = create_train_state(base, seed=5)
    load_checkpoint(out["host feed"]["first"], target=state)
    batch = {"images": torch.from_numpy(sets[0][0][:N_ROWS]).cuda(),
             "cube_pose": torch.from_numpy(datasets[0].cube_poses[:N_ROWS]).cuda(),
             "mask": torch.ones(N_ROWS, device="cuda")}
    compute_ms, _, state = _median_step_ms(make_train_step(model, base, base_seed=base.random_seed), state, batch)
    ck = AsyncCheckpointer()
    t0 = time.perf_counter()
    ck.save(os.path.join(tmpdir, "held.ckpt"), state)
    hold_ms = (time.perf_counter() - t0) * 1e3
    ck.wait()
    write_ms = (time.perf_counter() - t0) * 1e3
    del model, state, batch
    torch.cuda.empty_cache()
    rate = lambda ms: N_IMG / ms * 1e3  # noqa: E731
    say(f"loop: end to end on {GPU}, camera-images/s (ms a step): " + "; ".join(
        f"{label} {rate(o['e2e_ms']):.1f} ({o['e2e_ms']:.2f}) in the resumed run's train pass, "
        f"{rate(o['saving_ms']):.1f} ({o['saving_ms']:.2f}) in the first run's second epoch"
        for label, o in out.items())
        + f"; compute only {rate(compute_ms):.1f} ({compute_ms:.2f} ms/step, the host path's step on a resident "
        f"batch, CUDA events, median of {C1_STEPS}). The host feed's pass runs from its first batch request, the "
        f"resident paths' from the end of initialize_training (the upload is set-up; their one epoch holds "
        f"{WARMUP_STEPS} eager steps and the capture); the second epoch's window runs from epoch 0's val loss "
        f"to epoch 1's losses, while epoch 0's file is written; host clock. AsyncCheckpointer.save holds the "
        f"caller {hold_ms:.1f} ms, the write ends {write_ms:.0f} ms after")
    _captured_vs_eager(base, sets, _expected_launches(3, stem_trained=False), "loop:")
    return dict(compute_ms=compute_ms, paths=out, config=base, sets=sets)


def _captured_vs_eager(cfg, sets, per_step: dict, label: str, mesh=None, n: int = None) -> dict:
    """One resident epoch replayed as a CUDA graph against the same epoch
    (one state, one order) run eagerly on the card, over the first `n`
    examples of the split (all by default) at `cfg.batch_size`: epoch 0
    captures (WARMUP_STEPS eager steps first), epoch 1 is replayed from a
    snapshot of the state, then the snapshot is restored in place and the
    per-step path (`make_train_step`) is fed epoch 1's batches
    (`epoch_batches`: the order padded with its own first entries, mask 0),
    gathered on the card. Losses within phase 6's loss gate; the change of
    each parameter and Adam moment within its gradient gates (max, median
    over tensors) and of each running statistic within Path B's statistics
    gates; a tensor that the eager epoch leaves as it was (frozen BN, frozen
    stages) must be left bit-equal; the replayed epoch's launches, counted
    through the replays, `per_step` a step. Prints the largest differences,
    whether the two epochs are bit-equal and a step's ms of each, by CUDA
    events and by the host clock (each epoch synchronised once), with the
    TF32 flags. With a `mesh` both run its data-parallel step (the graph
    then holds the step's all-reduce). Returns a step's ms by CUDA events
    and whether the two epochs are bit-equal, {"replayed": ms, "eager": ms,
    "bit_equal": bool}."""
    import torch

    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import create_train_state, epoch_batches, epoch_permutation, \
        make_resident_epoch_step, make_train_step

    B = cfg.batch_size
    model, state = create_train_state(cfg, seed=5, mesh=mesh)
    images = torch.from_numpy(sets[0][0][:n]).cuda()
    poses = torch.from_numpy(FramesDataset(*sets[0]).cube_poses[:n]).cuda()
    n = images.shape[0]
    graphed, k = make_resident_epoch_step(model, cfg, cfg.random_seed, n, mesh=mesh)
    state, _ = graphed(state, images, poses, 0)
    if graphed.run.graph is None:
        raise AssertionError(f"{label} the resident epoch step was not captured")
    snap = {name: t.detach().clone() for name, t in _state_tensors(state).items()}
    step0 = state.step
    ms, host = {}, {}

    def timed(key, fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        host[key] = (time.perf_counter() - t0) / k * 1e3
        ms[key] = e0.elapsed_time(e1) / k
        return out

    kernels.reset_launch_counts()
    state, loss_g = timed("replayed", lambda: graphed(state, images, poses, 1))
    launches = kernels.launch_counts()
    got = {name: t.detach().clone() for name, t in _state_tensors(state).items()}
    with torch.no_grad():
        for name, t in _state_tensors(state).items():
            t.copy_(snap[name])
    state.step = step0
    step = make_train_step(model, cfg, cfg.random_seed, mesh=mesh)
    idx, mask = epoch_batches(epoch_permutation(cfg.random_seed, 1, n, "cuda"), B,
                              None if mesh is None else mesh.local_rows(B))

    def eager():
        st, losses = state, []
        for i in range(k):
            st, loss = step(st, {"images": images.index_select(0, idx[i]), "cube_pose": poses.index_select(0, idx[i]),
                                 "mask": mask[i]})
            losses.append(loss)
        return st, torch.stack(losses)

    state, loss_e = timed("eager", eager)
    want = {name: t.detach().clone() for name, t in _state_tensors(state).items()}
    loss_err = ((loss_g - loss_e).abs() / loss_e.abs()).max().item()
    errs = {"parameters": {}, "moments": {}, "statistics": {}}
    unmoved = []
    for name, b in want.items():
        a, s0 = got[name], snap[name]
        moved = (b.float() - s0.float()).norm()
        if moved == 0:
            if not torch.equal(a, b):
                unmoved.append(name)
            continue
        group = "parameters" if name.startswith("params/") else "statistics" if name.startswith("stats/") \
            else "moments"
        errs[group][name] = ((a.float() - b.float()).norm() / moved).item()
    spread = {group: _spread(e) if e else (0.0, 0.0, "-") for group, e in errs.items()}
    bit_equal = torch.equal(loss_g, loss_e) and all(torch.equal(got[name], want[name]) for name in want)
    expected = {name: k * v for name, v in per_step.items()}
    say(f"{label} captured vs eager resident epoch ({n} examples, {k} steps of {B} rows, every one replayed; "
        f"{_tf32_flags()}): losses {loss_g.tolist()} vs {loss_e.tolist()} (max rel {loss_err:.3g}, tol "
        f"{TRAIN_LOSS_RTOL}); the change of " + "; ".join(
            f"{len(errs[g])} {g}: max rel {w:.3g} ({wn}), median {m:.3g}" for g, (w, m, wn) in spread.items())
        + f" (tol {GRAD_RTOL}, {GRAD_RTOL_MEDIAN}; statistics {EXACT_STATS_RTOL}); {len(unmoved)} unmoved tensors "
        f"changed; bit-equal: {bit_equal}; launches of the replayed epoch "
        f"{({k_: v for k_, v in launches.items() if v})}; a step {ms['replayed']:.2f} ms replayed, "
        f"{ms['eager']:.2f} ms eager (CUDA events; host clock {host['replayed']:.2f}, {host['eager']:.2f})")
    if launches != expected:
        raise AssertionError(f"{label} replayed epoch launches {launches} != {expected}")
    (pw, pm, _), (mw, mm, _), (sw, sm, _) = (spread[g] for g in ("parameters", "moments", "statistics"))
    if unmoved or not errs["parameters"] or not (
            loss_err <= TRAIN_LOSS_RTOL and max(pw, mw) <= GRAD_RTOL and max(pm, mm) <= GRAD_RTOL_MEDIAN
            and sw <= EXACT_STATS_RTOL[0] and sm <= EXACT_STATS_RTOL[1]):
        raise AssertionError(f"{label} the captured resident epoch disagrees with the eager one {unmoved[:5]}")
    del model, state, images, poses, graphed, step, snap, got, want
    torch.cuda.empty_cache()
    return {**ms, "bit_equal": bit_equal}


def _state_tensors(state) -> dict:
    """Every tensor a train step changes, by name: the parameters, the Adam
    moments and count, and the BN running statistics."""
    out = {f"params/{k}": v for k, v in state.params.items()}
    out.update({f"mu/{k}": v for k, v in state.opt_state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.opt_state.nu.items()})
    out["count"] = state.opt_state.count
    out.update({f"stats/{k}": v for k, v in state.batch_stats.items()})
    return out


def _tf32_flags() -> str:
    import torch

    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


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


# ─────────────── phase 17: data and tensor parallelism (A7) ───────────────

PAR_TIMED = 3  # timed steps of a configuration on each of the two ranks
PAR_TIMEOUT = 600.0  # seconds the two ranks may take in all
PAR_CONFIGS = ("flagship", "path B", "keypoint default", "path B f32")
# Path B in f32 on two ranks against one card: the same function summed in other orders (loss; gradients max,
# median; running statistics' change max, median), where bf16 exact BN amplifies each rounding through 53 BNs
# (one card's own "auto" and "xla" engines sit ~2e-3 apart in loss at 256 rows in bf16)
PAR_F32_LOSS_RTOL, PAR_F32_GRAD_RTOL, PAR_F32_STATS_RTOL = 1e-5, (0.02, 5e-3), (1e-4, 1e-5)
# each configuration's gates against the one-card step: (loss; gradients max, median; running statistics' change
# max, median, or None where BN is frozen). The flagship takes phase 6's; Path B in bf16 Path B's exact-BN gates
# (one card's own two engines differ by ~0.2 / 0.09 in its gradients); the keypoint default, whose exact BN runs
# the differentiable moments of the "xla" engine over the data group, gates a few times above its readings
# (loss 0, gradients 7.1e-3 / 3.5e-3, statistics 1.5e-6 / 2.6e-7 on the H100)
PAR_GATES = {
    "flagship": (TRAIN_LOSS_RTOL, (GRAD_RTOL, GRAD_RTOL_MEDIAN), None),
    "path B": (EXACT_LOSS_RTOL, EXACT_GRAD_RTOL, EXACT_STATS_RTOL),
    "keypoint default": (1e-3, (0.03, 0.015), (1e-4, 1e-5)),
    "path B f32": (PAR_F32_LOSS_RTOL, PAR_F32_GRAD_RTOL, PAR_F32_STATS_RTOL),
}


def _par_setup(name: str, bn_impl: str = None):
    """(cfg, model, state, batch) of a configuration of the parallel phase,
    the same weights and batch in every process: the flagship step (phase
    6), Path B (exact BN, `bn_impl="auto"`, phase 8), the keypoint default
    (exact BN, unfused), each at batch 256, and Path B in f32; `bn_impl`
    replaces Path B's engine."""
    from argus_tpu_torch.models import CubeKeypointNetConfig
    from argus_tpu_torch.train import create_train_state

    if name == "flagship":
        return flagship_train_setup()
    if name == "keypoint default":
        return keypoint_setup(CubeKeypointNetConfig())
    cfg, model, state, batch = flagship_train_setup(bn_frozen=False, bn_frozen_affine=False, stem_frozen=False,
                                                    bn_impl="auto", **{k: "auto" for k in FUSE_ON})
    f32 = name.endswith("f32")
    if f32 or bn_impl:
        cfg = dataclasses.replace(cfg, amp=not f32,
                                  model_config=dataclasses.replace(cfg.model_config, bn_impl=bn_impl or "auto"))
        twin, state = create_train_state(cfg, seed=0)
        twin.load_state_dict(model.state_dict())
        model = twin
    return cfg, model, state, batch


def _par_expected(name: str) -> dict:
    if name == "flagship":
        return EXPECTED_TRAIN_LAUNCHES
    if name.startswith("path B"):
        return EXPECTED_EXACT_LAUNCHES
    return {**_NONE, "augment_fused": 1}


def _step_grads(body, state, batch, step: int = 0):
    """(loss, {name: grad}, the BN buffers' change) of `body`'s train step
    `step` on `batch` (the rows it holds): prepared and augmented as the
    step is, no update."""
    import torch

    before = {k: v.detach().clone() for k, v in body.model.named_buffers()}
    ops = body.prepare(step, batch["images"], batch["cube_pose"], batch["mask"])
    loss, grads = body._loss_and_grads(state.params, body.augmented(ops), ops["poses"], ops["mask"])
    moved = {k: (v.detach() - before[k]).float() for k, v in body.model.named_buffers()}
    torch.cuda.synchronize()
    return loss.item(), grads, moved


def _on_host(d: dict) -> dict:
    return {k: v.detach().float().cpu() for k, v in d.items()}


def _digest(tensors) -> str:
    """A hash of the tensors' bytes (the ranks' parameters compared bitwise)."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _gates(label: str, got: tuple, want: tuple, config: str) -> None:
    """A parallel step's (loss, gradients, BN buffers' change) against the
    one-card step's, under `PAR_GATES[config]` (the keypoint head's
    `SHIFT_INVARIANT` bias, zero up to rounding, left out)."""
    loss_tol, grad_tol, stats_tol = PAR_GATES[config]
    errs = _grad_errors(got[1], {k: v for k, v in want[1].items() if k != SHIFT_INVARIANT})
    worst, median, name = _spread(errs)
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    msg = (f"{label}: loss {got[0]:.6f} vs {want[0]:.6f} one-card (rel {loss_err:.3g}, tol {loss_tol}); gradients of "
           f"{len(errs)} parameters: max rel {worst:.3g} ({name}), median {median:.3g} (tol {grad_tol})")
    ok = loss_err <= loss_tol and worst <= grad_tol[0] and median <= grad_tol[1]
    if stats_tol is not None:
        serr = {k: ((a - want[2][k]).norm() / want[2][k].norm()).item() for k, a in got[2].items()
                if want[2][k].norm() > 0}
        s_worst, s_median, s_name = _spread(serr)
        msg += (f"; running statistics' change, {len(serr)} buffers: max rel {s_worst:.3g} ({s_name}), median "
                f"{s_median:.3g} (tol {stats_tol})")
        ok &= s_worst <= stats_tol[0] and s_median <= stats_tol[1]
    say(msg)
    if not ok:
        raise AssertionError(f"{label} disagrees with the one-card step")


def _all_reduce_ms(grads: dict, group, reps: int = 5) -> tuple:
    """(bucket sizes, ms of one bucketed all-reduce of a step's [loss,
    count, gradients] by CUDA events, the same by the host clock)."""
    import torch

    from argus_tpu_torch.parallel.collectives import all_reduce_loss_and_grads, bucket_bounds

    one = torch.ones((), device="cuda")
    n = 2 + sum(g.numel() for g in grads.values())
    sizes = [b - a for a, b in bucket_bounds(n)]
    all_reduce_loss_and_grads(one, one, grads, group)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        all_reduce_loss_and_grads(one, one, grads, group)
    e1.record()
    torch.cuda.synchronize()
    return sizes, e0.elapsed_time(e1) / reps, (time.perf_counter() - t0) * 1e3 / reps


def _timed_rank_steps(step, state, batch, n: int = PAR_TIMED):
    """A warm-up step, a counted one, then `n` timed ones: (launches of the
    counted step, ms each by CUDA events, the losses)."""
    import torch

    from argus_tpu_torch.ops import kernels

    state, loss = step(state, batch)
    kernels.reset_launch_counts()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    ms, losses = [], [loss.item()]
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(loss.item())
    return launches, ms, losses, state


def _par_rank(rank: int, n: int, data_dir: str) -> dict:
    """One of the two ranks sharing the card (gloo): (b) the configurations'
    data-parallel step on this rank's 128 rows (Path B in f32 counted, not
    timed), (c) the
    flagship step with `num_model_shards=2`, (d) `train()` under
    `multigpu`, one epoch resident and one on the host feed. Returns what
    the parent gates."""
    import numpy as np
    import torch

    from argus_tpu_torch.checkpoint import load_checkpoint, train_state_tree
    from argus_tpu_torch.parallel import make_mesh
    from argus_tpu_torch.parallel.collectives import gather_whole
    from argus_tpu_torch.parallel.tp import shard_state
    from argus_tpu_torch.train import TrainStepBody, create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False  # as the parent's phases 2 and 6 set them
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"dp": {}}
    mesh = make_mesh()
    for name in PAR_CONFIGS:
        cfg, model, state, batch = _par_setup(name)
        local = {k: v[mesh.local_rows(N_ROWS)] for k, v in batch.items()}
        body = TrainStepBody(model, cfg, mesh=mesh)
        loss, grads, moved = _step_grads(body, state, local)
        sizes, ar_ms, ar_host = _all_reduce_ms(grads, mesh.data_group) if name == "flagship" else (None, None, None)
        launches, ms, losses, state = _timed_rank_steps(make_train_step(model, cfg, mesh=mesh), state, local,
                                                        0 if name.endswith("f32") else PAR_TIMED)
        out["dp"][name] = dict(loss=loss, grads=_on_host(grads) if rank == 0 else None,
                               moved=_on_host(moved) if rank == 0 else None, launches=launches, ms=ms,
                               losses=losses, digest=_digest(state.params.values()), buckets=sizes,
                               all_reduce_ms=ar_ms, all_reduce_host_ms=ar_host)
        del cfg, model, state, batch, local, body, grads, moved
        torch.cuda.empty_cache()

    # (c) the flagship step with its wide layers cut over the two ranks
    tp = make_mesh(n_model=2)
    cfg, model, state, batch = _par_setup("flagship")
    cfg = dataclasses.replace(cfg, num_model_shards=2)
    state = shard_state(model, state, tp)
    cuts = state.shardings
    body = TrainStepBody(model, cfg, mesh=tp)
    loss, grads, _ = _step_grads(body, state, batch)
    whole = {k: gather_whole(g, cuts[k], tp.model_group) if k in cuts else g for k, g in grads.items()}
    launches, ms, losses, state = _timed_rank_steps(make_train_step(model, cfg, mesh=tp), state, batch, 1)
    out["tp"] = dict(loss=loss, grads=_on_host(whole) if rank == 0 else None, launches=launches, ms=ms,
                     cut={k: tuple(v.shape) for k, v in state.params.items() if k in cuts})
    del cfg, model, state, batch, body, grads, whole
    torch.cuda.empty_cache()

    # (d) train() under multigpu on the loop phase's rendered split
    from argus_tpu_torch import logging_utils
    from argus_tpu_torch import train as ttrain

    arrays = np.load(os.path.join(data_dir, "split.npz"))
    datasets = (FramesDataset(arrays["train_images"], arrays["train_poses"]),
                FramesDataset(arrays["val_images"], arrays["val_poses"]))
    base = _loop_config(os.path.join(data_dir, "ckpt"))
    orig = (logging_utils.MetricsLogger, ttrain.initialize_training, ttrain._train_epochs)
    ready, finals = [], []

    def init(*a, **k):
        setup = orig[1](*a, **k)
        torch.cuda.synchronize()
        ready.append((time.perf_counter(), setup["resident"] is not None))
        return setup

    def epochs(*a, **k):
        res = orig[2](*a, **k)
        finals.append(res[0])
        return res

    logging_utils.MetricsLogger, ttrain.initialize_training, ttrain._train_epochs = _Recorder, init, epochs
    out["loop"] = {}
    try:
        for label, budget in (("resident", base.device_resident_mb), ("host feed", 0.0)):
            cfg = dataclasses.replace(base, multigpu=True, n_epochs=1, device_resident_mb=budget)
            _Recorder.runs.clear()
            t0 = time.perf_counter()
            path = ttrain.train(cfg, datasets=datasets)
            wall = time.perf_counter() - t0
            records = _Recorder.runs[-1].records
            losses = [m["loss"] for _, _, m in records if "loss" in m]
            t_last = [t for t, _, m in records if "loss" in m][-1]
            final = finals[-1]
            _, fresh = create_train_state(dataclasses.replace(cfg, multigpu=False), seed=5)
            load_checkpoint(path, target=fresh)
            a, b = _tree_leaves(train_state_tree(fresh)), _tree_leaves(train_state_tree(final))
            restores = a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
            out["loop"][label] = dict(losses=losses, vals=[m["val_loss"] for _, _, m in records if "val_loss" in m],
                                      train_ms=(t_last - ready[-1][0]) * 1e3, steps=len(losses), wall=wall,
                                      digest=_digest(final.params.values()), restores=restores, path=path,
                                      resident=ready[-1][1])
            del final, fresh
            finals.clear()
            torch.cuda.empty_cache()
    finally:
        logging_utils.MetricsLogger, ttrain.initialize_training, ttrain._train_epochs = orig
    return out


def _tree_leaves(t, pre: str = "") -> dict:
    import numpy as np

    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_tree_leaves(v, f"{pre}/{k}"))
        else:
            out[f"{pre}/{k}"] = np.asarray(v)
    return out


def _nccl_world1(one_card_ms: float, base, sets) -> None:
    """(a) NCCL at world size 1 in this process: the flagship step through
    the bucketed all-reduce on NCCL against the one-card step on the same
    256 rows (phase 6's gates), its timed steps and launches, the
    all-reduce alone; then the resident epoch captured as a CUDA graph
    with the NCCL all-reduce inside it, against the same epoch eager."""
    import torch
    import torch.distributed as dist

    from argus_tpu_torch.parallel import init_distributed, make_mesh
    from argus_tpu_torch.parallel.launch import free_port
    from argus_tpu_torch.train import TrainStepBody, make_train_step

    init_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0, device="cuda", timeout=300)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"one process on one card took backend {dist.get_backend()}, not nccl")
        mesh = make_mesh(reduce_alone=True)
        cfg, model, state, batch = flagship_train_setup()
        want = _step_grads(TrainStepBody(model, cfg), state, batch)
        got = _step_grads(TrainStepBody(model, cfg, mesh=mesh), state, batch)
        _gates("parallel (a): the data-parallel step over NCCL at world size 1 (256 rows)",
               (got[0], got[1], {}), (want[0], want[1], {}), "flagship")
        sizes, ar_ms, ar_host = _all_reduce_ms(got[1], mesh.data_group)
        del want, got
        torch.cuda.empty_cache()
        launches, ms, state = _time_steps(make_train_step(model, cfg, mesh=mesh), state, batch,
                                          "DP over NCCL at world size 1")
        if launches != EXPECTED_TRAIN_LAUNCHES:
            raise AssertionError(f"DP step launch counts {launches} != {EXPECTED_TRAIN_LAUNCHES}")
        say(f"parallel (a) on {GPU}: NCCL at world size 1, the bucketed all-reduce of [loss, count, gradients]: "
            f"{len(sizes)} buckets of {sizes} f32 values, {ar_ms:.3f} ms by CUDA events ({ar_host:.3f} ms host "
            f"clock); the step {ms:.2f} ms against the one-card step's {one_card_ms:.2f} ms (phase 6)")
        del model, state, batch
        torch.cuda.empty_cache()
        _captured_vs_eager(base, sets, _expected_launches(3, stem_trained=False),
                           "parallel (a): NCCL at world size 1, the all-reduce in the graph;", mesh=mesh)
    finally:
        dist.destroy_process_group()


def parallel_phase(one_card_ms: float, loop: dict, tmpdir: str) -> None:
    """(a) NCCL at world size 1 here; then two ranks on the one card over
    gloo (`parallel.launch.run_ranks`, spawned: CUDA is initialised here),
    each gated against the one-card step this process computes on the same
    weights, batch and step number: (b) the flagship, Path B and the
    keypoint default, 128 rows a rank; (c) the flagship with
    `num_model_shards=2`; (d) `train()` under `multigpu`, resident and on
    the host feed. Two ranks share one card here, so no time of theirs is
    a scaling figure."""
    import numpy as np
    import torch

    from argus_tpu_torch.parallel.launch import run_ranks
    from argus_tpu_torch.train import TrainStepBody

    t0 = time.perf_counter()
    base, sets = loop["config"], loop["sets"]
    _nccl_world1(one_card_ms, base, sets)
    t_a = time.perf_counter() - t0

    refs = {}
    for name in PAR_CONFIGS + ("path B xla",):
        cfg, model, state, batch = _par_setup(*(("path B", "xla") if name == "path B xla" else (name,)))
        loss, grads, moved = _step_grads(TrainStepBody(model, cfg), state, batch)
        refs[name] = (loss, _on_host(grads), _on_host(moved))
        del cfg, model, state, batch, grads, moved
        torch.cuda.empty_cache()
    np.savez(os.path.join(tmpdir, "split.npz"), train_images=sets[0][0], train_poses=sets[0][1],
             val_images=sets[1][0], val_poses=sets[1][1])
    t1 = time.perf_counter()
    ranks = run_ranks(_par_rank, 2, tmpdir, timeout=PAR_TIMEOUT, device="cuda")
    t_ranks = time.perf_counter() - t1

    for name in PAR_CONFIGS:
        r0, r1 = ranks[0]["dp"][name], ranks[1]["dp"][name]
        _gates(f"parallel (b): {name}, 2 ranks x 128 rows over gloo", (r0["loss"], r0["grads"], r0["moved"]),
               refs[name], name)
        want = _par_expected(name)
        if r0["launches"] != want or r1["launches"] != want:
            raise AssertionError(f"{name}: launches per rank {r0['launches']} / {r1['launches']} != {want}")
        steps = len(r0["losses"]) + 1
        if r0["digest"] != r1["digest"] or not np.isfinite(r0["losses"] + r1["losses"]).all():
            raise AssertionError(f"{name}: the ranks' parameters differ after {steps} steps, or a loss is not finite")
        if name == "path B":
            # one card's own two engines on the same 256 rows: the spread of bf16 exact BN at this batch
            e_worst, e_median, e_name = _spread(_grad_errors(refs["path B xla"][1], refs[name][1]))
            say(f"parallel (b): path B on one card, bn_impl xla against auto on the same 256 rows (bf16): loss rel "
                f"{abs(refs['path B xla'][0] - refs[name][0]) / abs(refs[name][0]):.3g}; gradients max rel "
                f"{e_worst:.3g} ({e_name}), median {e_median:.3g}")
        timed = (f"; a step {np.mean(r0['ms']):.2f} ms (rank 0) / {np.mean(r1['ms']):.2f} ms (rank 1) by CUDA "
                 f"events, two ranks sharing one card: no scaling figure") if r0["ms"] else " (not timed)"
        say(f"parallel (b) on {GPU}: {name}: 2 ranks over gloo (eager: gloo's collectives cannot be captured), "
            f"launches per rank per step {({k: v for k, v in r0['launches'].items() if v})}, equal; the ranks' "
            f"parameters bit-equal after {steps} steps{timed}")
    fl = ranks[0]["dp"]["flagship"]
    say(f"parallel (b) on {GPU}: gloo, the bucketed all-reduce of the flagship's [loss, count, gradients]: "
        f"{len(fl['buckets'])} buckets of {fl['buckets']} f32 values, {fl['all_reduce_ms']:.3f} ms by CUDA events "
        f"({fl['all_reduce_host_ms']:.3f} ms host clock); the flagship step on 2 x 128 rows "
        f"{np.mean(fl['ms']):.2f} ms against the one-card step on 256 rows {one_card_ms:.2f} ms (phase 6); both "
        f"ranks share one card, so this is no scaling figure")

    tp = ranks[0]["tp"]
    _gates("parallel (c): the flagship with num_model_shards=2 (2 ranks, the same 256 rows)",
           (tp["loss"], tp["grads"], {}), refs["flagship"], "flagship")
    if tp["launches"] != EXPECTED_TRAIN_LAUNCHES or ranks[1]["tp"]["launches"] != EXPECTED_TRAIN_LAUNCHES:
        raise AssertionError(f"TP launches {tp['launches']} != {EXPECTED_TRAIN_LAUNCHES}")
    say(f"parallel (c) on {GPU}: cut leaves {tp['cut']} a rank; a step {np.mean(tp['ms']):.2f} ms (rank 0)")

    per_epoch = LOOP_TRAIN // N_ROWS
    for label in ("resident", "host feed"):
        r0, r1 = ranks[0]["loop"][label], ranks[1]["loop"][label]
        finite = np.isfinite(r0["losses"] + r0["vals"] + r1["losses"] + r1["vals"]).all()
        if not (finite and r0["steps"] == per_epoch and r0["digest"] == r1["digest"] and r0["restores"]
                and r1["restores"] and r0["path"] == r1["path"] and r0["resident"] == (label == "resident")):
            raise AssertionError(f"parallel (d) {label}: {r0} / {r1}")
        one = loop["paths"][label]["e2e_ms"]
        rate = lambda ms: N_IMG / ms * 1e3  # noqa: E731
        say(f"parallel (d) on {GPU}: train() under multigpu, 2 ranks over gloo, {label}: one epoch of {per_epoch} "
            f"steps, losses {[round(v, 4) for v in r0['losses']]}, val {[round(v, 4) for v in r0['vals']]}; the "
            f"ranks' parameters bit-equal; rank 0's file restores bit-equal on both ranks; "
            f"{rate(r0['train_ms'] / per_epoch):.1f} camera-images/s in the train pass (eager steps) against "
            f"{rate(one):.1f} on one card (phase 11, the resumed run's pass); {r0['wall']:.1f} s with set-up")
    say(f"parallel: the phase took {time.perf_counter() - t0:.1f} s ((a) {t_a:.1f} s, the two ranks "
        f"{t_ranks:.1f} s with their start-up)")



# ─────────────── phase 18: the streaming render feed into the flagship step ───────────────

STREAM_POOL = 512  # rendered rows the render source hands out in turn, as copies
STREAM_WARMUP, STREAM_TIMED = 2, 10  # streamed steps before the timed ones, and timed


def _pool_source(frames, poses_xyzw):
    """A render source over a rendered pool: copies of consecutive rows,
    batch after batch, wrapping (the batch size divides the pool), so the
    phase measures the feed and the step, not the renderer."""
    cursor = [0]

    def render_fn(batch_size: int):
        i = cursor[0]
        cursor[0] = (i + batch_size) % len(frames)
        return frames[i:i + batch_size].copy(), poses_xyzw[i:i + batch_size].copy()

    return render_fn


def streaming_phase(step_ms: float) -> None:
    """The flagship step (phase 6's setup, fuse flags "on") fed by
    `StreamingRenderLoader` through `device_prefetch`: a render source over
    STREAM_POOL rows of the port's synthetic renderer. The first streamed
    step's loss and updated parameters bit-equal to the same step on the
    same batch passed as a dict (no loader) to a twin state; then
    STREAM_WARMUP - 1 more and STREAM_TIMED timed streamed steps: launches
    STREAM_TIMED times phase 6's, finite losses, camera-images/s beside
    phase 6's compute-only step."""
    import numpy as np
    import torch

    from argus_tpu_torch.data import StreamingRenderLoader, device_prefetch
    from argus_tpu_torch.data.synthetic import render_dataset_arrays
    from argus_tpu_torch.geom import xyzwxyz_to_xyzxyzw_SE3
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import make_train_step

    t0 = time.perf_counter()
    frames, poses_wxyz = render_dataset_arrays(STREAM_POOL, HW, HW, seed=12)
    poses = xyzwxyz_to_xyzxyzw_SE3(poses_wxyz).astype(np.float32)
    say(f"streaming: rendered a pool of {STREAM_POOL} rows ({HW}x{HW}, 2 cameras) in {time.perf_counter() - t0:.1f} s")

    cfg, model, state, _ = flagship_train_setup()
    _, twin, twin_state, _ = flagship_train_setup()
    direct = {"images": frames[:N_ROWS].copy(), "cube_pose": poses[:N_ROWS].copy(),
              "mask": np.ones(N_ROWS, np.float32)}
    twin_state, twin_loss = make_train_step(twin, cfg)(twin_state, direct)

    step = make_train_step(model, cfg)
    loader = StreamingRenderLoader(_pool_source(frames, poses), N_ROWS, n_batches=STREAM_WARMUP + STREAM_TIMED)
    losses = []
    for i, batch in enumerate(device_prefetch(loader)):
        if i == STREAM_WARMUP:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(loss)
        if i == 0:
            differ = [k for k, v in state.params.items() if not torch.equal(v, twin_state.params[k])]
            say(f"streaming: the first streamed step against the same step on the same batch as a dict: loss "
                f"{loss.item():.6f} vs {twin_loss.item():.6f}, {len(differ)} of {len(state.params)} updated "
                f"parameters differ")
            if not torch.equal(loss, twin_loss) or differ:
                raise AssertionError(f"the streamed step is not bit-equal to the direct one: {differ[:5]}")
            del twin, twin_state, direct
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {k: STREAM_TIMED * v for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
    values = [v.item() for v in losses]
    say(f"streaming: launches in the {STREAM_TIMED} timed steps {launches}; losses {[round(v, 6) for v in values]}")
    if len(values) != STREAM_WARMUP + STREAM_TIMED or launches != want or not np.all(np.isfinite(values)):
        raise AssertionError(f"streamed steps: {len(values)} losses, launches {launches} != {want}")
    rate = STREAM_TIMED * N_IMG / secs
    say(f"streaming on {GPU}: StreamingRenderLoader -> device_prefetch -> the flagship step, {STREAM_TIMED} timed "
        f"steps of {N_ROWS} rows: {secs / STREAM_TIMED * 1e3:.2f} ms/step, {rate:.1f} camera-images/s (host clock, "
        f"synchronised), against {N_IMG / step_ms * 1e3:.1f} compute only (phase 6, {step_ms:.2f} ms/step, "
        f"CUDA events): {rate / (N_IMG / step_ms * 1e3) * 100:.1f}%")
    del model, state, losses
    torch.cuda.empty_cache()


# ─────────────── phase 19: torchvision weight import at full width ───────────────

IMPORT_ROWS = 8  # frames of the features gate
IMPORT_RTOL = 2e-4  # |port - torchvision| over the features' largest magnitude, f32, TF32 off


def _script(name: str):
    """A script of `scripts/` as a module (they are not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_phase(tmpdir: str) -> None:
    """A seeded synthetic torchvision-layout ResNet-50 state_dict
    (`scripts/verify_torch_import_torch.py`) loaded by `load_torch_resnet`:
    the bare ResNet-50's pooled features with the plain stem and with
    `stem_space_to_depth`, in f32 on the card (TF32 off), against
    torchvision's forward rebuilt from `torch.nn.functional` on the CPU, on
    IMPORT_ROWS seeded frames, within IMPORT_RTOL of the largest feature;
    then a full-width NCameraCNN (head random) with the imported backbone
    saved as a format-2 checkpoint and served by `Estimator(ckpt,
    batch_size=256)` with fuse "on": phase 3's launches, poses within phase
    3's atol of the f32 CPU estimator on the first 8 rows."""
    import numpy as np

    from argus_tpu_torch.capture import WARMUP_STEPS
    from argus_tpu_torch.checkpoint import save_checkpoint
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import variables_from_state_dict
    from argus_tpu_torch.models.torch_import import load_torch_resnet
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.serve import Estimator

    verify = _script("verify_torch_import_torch")
    sd = verify.synthetic_state_dict("resnet50", seed=0)
    x = np.random.default_rng(0).standard_normal((IMPORT_ROWS, 3, HW, HW)).astype(np.float32)
    t0 = time.perf_counter()
    want = verify.torch_reference_features(sd, x)
    ref_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    for s2d in (False, True):
        got = verify.port_features(verify.translated_model(sd, "resnet50", stem_space_to_depth=s2d), x, "cuda")
        err = float(np.abs(got - want).max())
        say(f"import: torchvision ResNet-50 ({len(sd)} keys) through load_torch_resnet, "
            f"{'space-to-depth' if s2d else 'plain'} stem, pooled features {tuple(got.shape)} of {IMPORT_ROWS} "
            f"frames {HW}x{HW} in f32 on the card against the F.* forward on the CPU ({ref_s:.1f} s): max abs "
            f"diff {err:.3g}, {err / scale:.3g} of the largest feature {scale:.4g} (tol {IMPORT_RTOL})")
        if not (got.shape == want.shape and err <= IMPORT_RTOL * scale):
            raise AssertionError(f"imported features differ from torchvision's forward by {err} (scale {scale})")

    cfg = NCameraCNNConfig(n_cams=2, resnet_output_dim=1024, backbone="resnet50")
    model = NCameraCNN(cfg)
    _randomize_(model, seed=3)  # the head and fc: random, the output at gain 8
    model.load_state_dict(load_torch_resnet(sd, model))
    params, stats = variables_from_state_dict(model.state_dict())
    ckpt = os.path.join(tmpdir, "torchvision_resnet50.ckpt")
    meta = {"model_type": "pose_cnn", "model_config": dataclasses.asdict(cfg), "center_crop": [HW, HW]}
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats}, meta=meta)
    del model, params, stats

    est = Estimator(ckpt, batch_size=N_ROWS)
    for k in FUSE_ON:
        setattr(est.model.backbone, k, "on")
    frames = np.random.default_rng(5).integers(0, 256, (N_ROWS, HW, HW, 6), dtype=np.uint8)
    for _ in range(WARMUP_STEPS + 1):
        est.predict(frames)
    kernels.reset_launch_counts()
    poses = est.predict(frames)
    launches = kernels.launch_counts()
    if launches != EXPECTED_LAUNCHES or poses.shape != (N_ROWS, 7) or not np.all(np.isfinite(poses)):
        raise AssertionError(f"imported serving: launches {launches} != {EXPECTED_LAUNCHES}, or bad poses")
    t0 = time.perf_counter()
    ref = Estimator(ckpt, batch_size=1, device="cpu").predict(frames[:8])  # below the fused batch: f32
    err = float(np.abs(poses[:8] - ref).max())
    say(f"import on {GPU}: the imported weights served by Estimator(batch_size={N_ROWS}), bf16, fuse 'on': "
        f"launches {({k: v for k, v in launches.items() if v})}; poses against the f32 CPU estimator on 8 rows: "
        f"max abs diff {err:.4g} (atol {POSE_ATOL}), |pose| max {float(np.abs(ref).max()):.3g}, CPU "
        f"{time.perf_counter() - t0:.1f} s")
    if not err <= POSE_ATOL:
        raise AssertionError(f"imported serving poses differ from the f32 CPU estimator by {err} > {POSE_ATOL}")
    del est


# ─────────────── phase 20: profiling ───────────────

TRACE_ATTEMPTS = 5  # a profiled window on this card's PyTorch now and then loses its kernel records
WGMMA_KERNELS = ("conv_fwd_tma_sm90_kernel", "dgrad_sm90_kernel", "wgrad_sm90_kernel")


def profiling_phase(tmpdir: str) -> None:
    """Two flagship steps (phase 6's setup, fuse "on") inside
    `profiling.trace`, each inside `annotate("train_step")`: the Chrome
    trace must exist and name the annotation twice, the augmentation kernel
    and a wgmma engine kernel (a window with no kernel record is traced
    again, up to TRACE_ATTEMPTS times); then `profile_fn`'s mean, p50 and
    p95 of the step."""
    import torch

    from argus_tpu_torch import profiling
    from argus_tpu_torch.train import make_train_step

    cfg, model, state, batch = flagship_train_setup()
    step = make_train_step(model, cfg)
    state, loss = step(state, batch)
    loss.item()
    for attempt in range(TRACE_ATTEMPTS):
        with profiling.trace(os.path.join(tmpdir, f"trace{attempt}")) as log_dir:
            for _ in range(2):
                with profiling.annotate("train_step"):
                    state, loss = step(state, batch)
            loss.item()
        path = os.path.join(log_dir, profiling.TRACE_FILE)
        with open(path) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
        aug = sorted({n for n in names if "augment_kernel" in n})
        engines = sorted({n for n in names if any(k in n for k in WGMMA_KERNELS)})
        if aug and engines:
            break
    annotated = names.count("train_step")
    say(f"profiling: {path} ({os.path.getsize(path) / 1e6:.1f} MB, {len(names)} events, attempt {attempt + 1}): "
        f"'train_step' {annotated} times; augmentation {aug[:1]}; {len(engines)} wgmma engine kernels, e.g. "
        f"{engines[:2]}")
    if annotated < 2 or not aug or not engines:
        raise AssertionError("the trace does not name the annotation, the augmentation kernel and a wgmma kernel")
    stats = profiling.profile_fn(lambda: step(state, batch)[1], n_trials=10, warmup=1)
    say(f"profiling on {GPU}: profile_fn of the flagship step, {stats['n_trials']} trials (host clock, the loss "
        f"synchronised): mean {stats['mean_ms']:.2f} ms, p50 {stats['p50_ms']:.2f}, p95 {stats['p95_ms']:.2f}")
    del model, state, batch
    torch.cuda.empty_cache()


# ─────────────── phase 21: argus_tpu's default training configuration ───────────────

DEFAULT_TRAIN = 1000  # examples train() takes of the loop phase's split: 31 batches of 32, then 8 rows padded to 32
DEFAULT_CAPTURE = 200  # examples of the captured-vs-eager epoch: 6 batches of 32, then 8 rows padded to 32
DEFAULT_ROWS = 8  # rows of the card-against-CPU step
DEFAULT_LOSS_RTOL = 1e-5  # the card's f32 step (TF32 off) against the port's on the CPU, loss
# launches per train step of the default config by bn_impl: exact BN keeps every conv and stem kernel off
EXPECTED_DEFAULT_LAUNCHES = {"xla": EXPECTED_EXACT_XLA_LAUNCHES, "auto": EXPECTED_EXACT_LAUNCHES}


def _default_config(save_dir: str = None, **model_overrides):
    """argus_tpu's default training configuration, `TrainConfig()` and
    `NCameraCNNConfig()` as shipped (ResNet-50, 2 cameras, 1024-d features,
    exact BN on "xla", f32, batch 32, the fused augmentation with 10 arcs,
    the split resident under 2048 MiB), with 2 epochs, no metrics service
    and `save_dir` (where given); `model_overrides` replace model fields
    (`bn_impl`)."""
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    where = {} if save_dir is None else dict(save_dir=save_dir)
    return TrainConfig(model_config=NCameraCNNConfig(**model_overrides), n_epochs=2, wandb_log=False, **where)


def default_train_setup(rows: int = None, save_dir: str = None, **model_overrides):
    """(cfg, model, state, batch) of argus_tpu's default configuration on the
    card (`_default_config`): random weights from seed 0 with BN randomised,
    and `rows` (the config's batch by default) seeded noise rows (uint8
    frame pairs, non-identity poses, mask 1) on the card."""
    import numpy as np
    import torch

    from argus_tpu_torch.train import create_train_state

    cfg = _default_config(save_dir, **model_overrides)
    rows = rows or cfg.batch_size
    model, state = create_train_state(cfg, seed=0)
    _randomize_(model, seed=0)
    rng = np.random.default_rng(21)
    batch = {"images": torch.from_numpy(rng.integers(0, 256, (rows, HW, HW, 6), dtype=np.uint8)).cuda(),
             "cube_pose": torch.from_numpy(_random_poses(rng, rows)).cuda(),
             "mask": torch.ones(rows, device="cuda")}
    return cfg, model, state, batch


def _set_tf32(convs: bool) -> None:
    """cuDNN's TF32 flag, matmuls in f32: `convs=True` is torch's default,
    which the port's `train()` leaves as it is."""
    import torch

    torch.backends.cudnn.allow_tf32 = convs
    torch.backends.cuda.matmul.allow_tf32 = False


def _default_kernels(batch: int) -> None:
    """The default configuration's f32 kernels at its shapes (`batch` rows,
    N = 2 * batch camera images of 256x256): `fused_stats` and
    `fused_bn_bwd_reduce` on f32 inputs of each distinct (M, C) of ResNet-50's
    53 BatchNorms at strides 1 and 4 against their plain versions under
    phase 4's BN_RTOL, two calls bit-equal; `augment_fused` on N f32 images
    with 10 arcs under phase 5's f32 gate. Prints each time (CUDA events)
    beside the plain version's, the library call's (stride 1) and the
    bound, and the BN sums over one step (53 BNs, stride 1)."""
    import torch

    from argus_tpu_torch.ops import augment as TA
    from argus_tpu_torch.ops.kernels import augment_fused as kaf
    from argus_tpu_torch.ops.kernels import bn_reduce

    n_img = 2 * batch
    g = torch.Generator(device="cuda").manual_seed(21)
    step = {name: dict(ms=0.0, plain=0.0, library=0.0, flops=0, bytes=0) for name in ("bn_stats", "bn_bwd_reduce")}
    worst = 0.0
    for m, c, count in _timing_script().bn_inputs(n_img, HW):
        side = int(round((m // n_img) ** 0.5))
        x = torch.randn(m, c, generator=g, device="cuda")
        dy = torch.randn(m, c, generator=g, device="cuda")
        x4, dy4 = (t.view(n_img, side, side, c).permute(0, 3, 1, 2) for t in (x, dy))
        s, q, n = bn_reduce.fused_stats_plain(x, 1)
        mean = s / n
        rstd = torch.rsqrt(torch.clamp(q / n - mean * mean, min=0.0) + 1e-5)
        for stride in (1, 4):
            rows, drows = (bn_reduce._rows(t, stride) for t in (x, dy))
            xa, da = rows.abs(), drows.abs()
            k_s, k_q, k_n = bn_reduce.fused_stats(x, stride)
            p_s, p_q, p_n = bn_reduce.fused_stats_plain(x, stride)
            k_d, k_dx, k_n2 = bn_reduce.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)
            p_d, p_dx, p_n2 = bn_reduce.fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride)
            if not k_n == p_n == k_n2 == p_n2 == rows.shape[0]:
                raise AssertionError(f"bn f32 ({m}, {c}) stride {stride}: n_rows {k_n}, {k_n2} != plain {p_n}")
            e1 = max(_bn_close("bn_stats f32 sum", k_s, p_s, xa.sum(0)),
                     _bn_close("bn_stats f32 sumsq", k_q, p_q, (xa * xa).sum(0)))
            xh = ((rows - mean) * rstd).abs()
            e2 = max(_bn_close("bn_bwd_reduce f32 sum dy", k_d, p_d, da.sum(0)),
                     _bn_close("bn_bwd_reduce f32 sum dy*xhat", k_dx, p_dx, (da * xh).sum(0)))
            again = bn_reduce.fused_stats(x, stride)[:2] + bn_reduce.fused_bn_bwd_reduce(x, dy, mean, rstd, stride)[:2]
            if not all(torch.equal(a, b) for a, b in zip((k_s, k_q, k_d, k_dx), again)):
                raise AssertionError(f"bn f32 ({m}, {c}) stride {stride}: two calls on the same input differ")
            worst = max(worst, e1[0], e2[0])
            del rows, drows, xa, da, xh
            t = [cuda_ms(lambda: bn_reduce.fused_stats(x, stride), 10),
                 cuda_ms(lambda: bn_reduce.fused_stats_plain(x, stride), 3),
                 cuda_ms(lambda: bn_reduce.fused_bn_bwd_reduce(x, dy, mean, rstd, stride), 10),
                 cuda_ms(lambda: bn_reduce.fused_bn_bwd_reduce_plain(x, dy, mean, rstd, stride), 3)]
            nb_s, nb_b = k_n * c * 4 + 2 * c * 4, 2 * k_n * c * 4 + 4 * c * 4
            lib = ["-", "-"]
            if stride == 1:
                lib_s = cuda_ms(lambda: torch.batch_norm_stats(x4, 1e-5), 10)
                lib_b = cuda_ms(lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, rstd, None, True, False,
                                                                         False), 10)
                lib = [f"{lib_s:.4f}", f"{lib_b:.4f}"]
                # f32 operations per element: x and x*x summed (3); dy summed, (x - mean) * rstd * dy summed (5)
                for name, vals in (("bn_stats", (t[0], t[1], lib_s, 3 * k_n * c, nb_s)),
                                   ("bn_bwd_reduce", (t[2], t[3], lib_b, 5 * k_n * c, nb_b))):
                    for key, v in zip(("ms", "plain", "library", "flops", "bytes"), vals):
                        step[name][key] += count * v
            b_s, b_b = bound_ms(3 * k_n * c, nb_s, PEAK_F32)[0], bound_ms(5 * k_n * c, nb_b, PEAK_F32)[0]
            say(f"default config kernels: bn f32 ({m}, {c}) x{count} stride {stride}: n_rows {k_n}; bn_stats "
                f"{t[0]:.4f} ms (plain {t[1]:.4f}, library {lib[0]}, bound {b_s:.4f}), bn_bwd_reduce {t[2]:.4f} ms "
                f"(plain {t[3]:.4f}, library {lib[1]}, bound {b_b:.4f}); max rel err {e1[0]:.3g}, {e2[0]:.3g} (tol "
                f"{BN_RTOL})")
        del x, dy, x4, dy4
        torch.cuda.empty_cache()
    bounds = {name: bound_ms(d["flops"], d["bytes"], PEAK_F32) for name, d in step.items()}
    say(f"default config kernels: bn f32 per step ({n_img} camera images, 53 BNs, stride 1; {_tf32_flags()}): "
        + "; ".join(f"{name} {d['ms']:.3f} ms (plain {d['plain']:.3f}, library {d['library']:.3f}, bound "
                    f"{bounds[name][0]:.3f} by {bounds[name][1]})" for name, d in step.items())
        + f"; max rel err {worst:.3g} of the channel's sum of magnitudes (tol {BN_RTOL})")

    cfg = TA.AugmentationConfig()
    x = torch.rand(n_img, 3, HW, HW, generator=g, device="cuda")
    params = TA.sample_params(cfg, 21, batch, 2, HW, HW, "cuda", x.dtype)
    args = TA.pack_fused(params, n_img, HW, HW, cfg.num_spaghetti, "cuda")
    got = kaf.fused_augment(x, *args, cfg.num_spaghetti)
    if not torch.equal(got, kaf.fused_augment(x, *args, cfg.num_spaghetti)):
        raise AssertionError("augment_fused f32: two calls on the same input differ")
    err = _aug_compare(f"default config kernels: augment_fused f32 {n_img} x {HW}x{HW} {cfg.num_spaghetti} arcs", got,
                       kaf.fused_augment_plain(x, *args, cfg.num_spaghetti), "f32")
    image_ops, f32_ops = aug_ops(*args[:4], cfg.num_spaghetti)
    nb = 2 * nbytes(x) + nbytes(*args)
    ms = cuda_ms(lambda: kaf.fused_augment(x, *args, cfg.num_spaghetti), 10)
    pms = cuda_ms(lambda: kaf.fused_augment_plain(x, *args, cfg.num_spaghetti), 2)
    b, by = bound_ms(image_ops + f32_ops, nb, PEAK_F32)  # f32 images: every operation at the f32 peak
    say(f"default config kernels: augment_fused {tuple(x.shape)} f32 x1: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"no library call, bound {b:.3f} ms ({by}: {image_ops + f32_ops:.3g} f32 operations, {nb / 1e6:.1f} MB), "
        f"max |kernel - plain| {err:.3g}")
    del x, params, args, got
    torch.cuda.empty_cache()


def _default_step_checks(save_dir: str) -> None:
    """One step of the default configuration on DEFAULT_ROWS seeded noise
    rows, augmentation off, TF32 off: the card's (bn_impl "xla") against
    the port's on the CPU from the same weights (random, BN randomised):
    loss within DEFAULT_LOSS_RTOL, each parameter's gradient within
    EXACT_GRAD_RTOL and each running statistic's change within
    EXACT_STATS_RTOL (relative 2-norms; max, median); then bn_impl "auto"
    (the reduction kernels, 53 + 53 launches) against "xla" on the card from
    the same weights, under Path B's gates."""
    import torch

    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.ops.norm import BatchNorm
    from argus_tpu_torch.train import _loss_and_grads_on, create_train_state, feed_images

    _set_tf32(False)
    cfg, model, state, batch = default_train_setup(DEFAULT_ROWS, save_dir)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def run(m, st, device):
        for k, v in m.state_dict().items():
            v.copy_(w0[k])
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = _loss_and_grads_on(m, st.params, feed_images(cfg, batch["images"], device), batch)
        moved = {k: (v - w0[k].to(device)).cpu() for k, v in m.named_buffers()}
        out = loss.item(), {k: v.cpu() for k, v in grads.items()}, moved, kernels.launch_counts()
        return out + (time.perf_counter() - t0,)

    def compare(label, got, want, loss_tol, grad_tol):
        loss_err = abs(got[0] - want[0]) / abs(want[0])
        errs = _grad_errors(got[1], want[1])
        worst, median, name = _spread(errs)
        serr = {k: ((a - want[2][k]).norm() / want[2][k].norm()).item() for k, a in got[2].items()
                if want[2][k].norm() > 0}
        s_worst, s_median, s_name = _spread(serr)
        say(f"default config: {label} on the first {DEFAULT_ROWS} rows ({_tf32_flags()}): loss {got[0]:.7f} vs "
            f"{want[0]:.7f} (rel {loss_err:.3g}, tol {loss_tol}); gradients of {len(errs)} parameters: max rel "
            f"{worst:.3g} ({name}), median {median:.3g} (tol {grad_tol}); running statistics' change, {len(serr)} of "
            f"{2 * n_bn} buffers: max rel {s_worst:.3g} ({s_name}), median {s_median:.3g} (tol {EXACT_STATS_RTOL}); "
            f"{got[4]:.2f} s and {want[4]:.2f} s")
        if not (loss_err <= loss_tol and worst <= grad_tol[0] and median <= grad_tol[1] and len(serr) == 2 * n_bn
                and s_worst <= EXACT_STATS_RTOL[0] and s_median <= EXACT_STATS_RTOL[1]):
            raise AssertionError(f"default config: {label} disagree")

    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    card = run(model, state, "cuda")
    cpu_model, cpu_state = create_train_state(cfg, seed=0, device="cpu")
    compare("the card's step vs the port's on the CPU", card, run(cpu_model, cpu_state, "cpu"), DEFAULT_LOSS_RTOL,
            EXACT_GRAD_RTOL)
    del cpu_model, cpu_state
    twin, twin_state = create_train_state(_default_config(save_dir, bn_impl="auto"), seed=0)
    auto = run(twin, twin_state, "cuda")
    want = {**_NONE, "bn_stats": n_bn, "bn_bwd_reduce": n_bn}
    if auto[3] != want or card[3] != _NONE:
        raise AssertionError(f"default config: launches of one forward and backward {auto[3]} (auto), {card[3]} "
                             f"(xla); expected {want}, none")
    compare('bn_impl "auto" vs "xla" on the card', auto, card, EXACT_LOSS_RTOL, EXACT_GRAD_RTOL)
    del model, state, twin, twin_state, card, auto
    torch.cuda.empty_cache()


def default_config_phase(tmpdir: str, sets) -> None:
    """argus_tpu's default training configuration on the card (see
    `_default_config`): its f32 kernels at its shapes (`_default_kernels`);
    one step against the port on the CPU and "auto" against "xla"
    (`_default_step_checks`); one resident epoch of DEFAULT_CAPTURE examples
    replayed as a CUDA graph against the same epoch eager, for "xla" and
    "auto" (`_captured_vs_eager`, the running statistics compared too);
    then `train()` itself over DEFAULT_TRAIN + LOOP_VAL of the loop phase's
    rendered examples (the last batch padded) on the default budget (the
    split resident, each epoch's step replayed) and on LOOP_SHARD_MB
    (shards swapped in, a padded batch in each), each 2 epochs and 1 more
    resumed from the file, under `_check_loop`'s checks with exact launch
    counts (1 `augment_fused` a step, nothing else). The epochs and train()
    run with torch's TF32 defaults, which `train()` leaves as they are
    (cuDNN's convs in TF32, matmuls in f32). Prints camera-images/s (64 a
    step, the padded batch counted whole) of the first run's second epoch
    and of the resumed run's pass beside the compute-only step (the eager
    per-step path on a resident batch, CUDA events, median of C1_STEPS), and
    a captured epoch's step replayed beside the same step eager."""
    import torch

    from argus_tpu_torch.checkpoint import load_checkpoint
    from argus_tpu_torch.data.resident import ResidentShardedData
    from argus_tpu_torch.train import create_train_state, make_train_step

    t_phase = time.perf_counter()
    base = _default_config(os.path.join(tmpdir, "ckpt"))
    B = base.batch_size
    _default_kernels(B)
    t_kernels = time.perf_counter() - t_phase
    _default_step_checks(os.path.join(tmpdir, "ckpt"))
    t_step = time.perf_counter() - t_phase - t_kernels

    _set_tf32(True)
    step_ms = {impl: _captured_vs_eager(_default_config(base.save_dir, bn_impl=impl), sets,
                                        EXPECTED_DEFAULT_LAUNCHES[impl], f"default config ({impl}):",
                                        n=DEFAULT_CAPTURE)
               for impl in ("xla", "auto")}
    t_capture = time.perf_counter() - t_phase - t_kernels - t_step

    train_set = tuple(a[:DEFAULT_TRAIN] for a in sets[0])
    datasets = (FramesDataset(*train_set), FramesDataset(*sets[1]))
    per_epoch = -(-DEFAULT_TRAIN // B)
    shards = ResidentShardedData(datasets[0], LOOP_SHARD_MB)
    sizes = [len(idx) for idx in shards.index_shards]
    shard_steps = sum(-(-k // B) for k in sizes)
    if DEFAULT_TRAIN % B == 0 or any(k % B == 0 for k in sizes):
        raise AssertionError(f"default config: no padded batch in {DEFAULT_TRAIN} examples or shards {sizes}")
    out = {}
    for label, budget, steps in (("resident", base.device_resident_mb, per_epoch),
                                 ("sharded", LOOP_SHARD_MB, shard_steps)):
        cfg = dataclasses.replace(base, device_resident_mb=budget)
        first, resumed, runs, launches, ready, times = _loop_runs(cfg, datasets)
        want = {k: 2 * steps * v for k, v in EXPECTED_DEFAULT_LAUNCHES["xla"].items()}
        _check_loop(f"default config, {label}", cfg, first, resumed, runs, launches, steps, times, want)
        t_resumed_loss = next(t for t, s, m in runs[1] if "loss" in m)
        out[label] = dict(e2e_ms=(t_resumed_loss - ready[1]) / steps * 1e3,
                          saving_ms=_second_epoch_ms(runs[0], steps), first=first, steps=steps)
        torch.cuda.empty_cache()

    model, state = create_train_state(base, seed=5)
    load_checkpoint(out["resident"]["first"], target=state)
    batch = {"images": torch.from_numpy(train_set[0][:B]).cuda(),
             "cube_pose": torch.from_numpy(datasets[0].cube_poses[:B]).cuda(),
             "mask": torch.ones(B, device="cuda")}
    compute_ms, launches, state = _median_step_ms(make_train_step(model, base, base_seed=base.random_seed), state,
                                                  batch)
    if launches != EXPECTED_DEFAULT_LAUNCHES["xla"]:
        raise AssertionError(f"default config: compute-only step launches {launches}")
    del model, state, batch
    torch.cuda.empty_cache()
    rate = lambda ms: 2 * B / ms * 1e3  # noqa: E731
    say(f"default config train() end to end on {GPU} ({_tf32_flags()}), camera-images/s (ms a step; {2 * B} "
        f"camera images a step, the padded batch counted whole): " + "; ".join(
            f"{label} ({o['steps']} steps an epoch) {rate(o['saving_ms']):.1f} ({o['saving_ms']:.2f}) in the first "
            f"run's second epoch, {rate(o['e2e_ms']):.1f} ({o['e2e_ms']:.2f}) in the resumed run's pass"
            for label, o in out.items())
        + f"; compute only {rate(compute_ms):.1f} ({compute_ms:.2f} ms/step, the eager per-step path on a resident "
        f"batch, CUDA events, median of {C1_STEPS}); a step of the captured epoch ({DEFAULT_CAPTURE} examples), "
        f"CUDA events: " + ", ".join(f"{impl} {v['replayed']:.2f} ms replayed, {v['eager']:.2f} ms eager"
                                     for impl, v in step_ms.items()))
    say(f"default config: the phase took {time.perf_counter() - t_phase:.1f} s (kernels {t_kernels:.1f} s, the "
        f"step checks {t_step:.1f} s, the captured epochs {t_capture:.1f} s)")


# ──────── phase 22: the frozen-BN ResNet-50 at argus_tpu's default dtype (f32) ────────

PEAK_TF32 = 494.7e12  # H100 SXM dense TF32 tensor-core peak
# an f32 kernel (TF32 products) against its plain version (f32, TF32 off):
# the bf16 gate scaled by TF32's 8x finer rounding, or F32_LIB_SLACK times
# the distance of cuDNN's TF32 composition from the same plain version,
# whichever is larger
F32_GATE = (2.5e-3, 1.25e-3)
F32_LIB_SLACK = 1.25
F32_LOSS_RTOL = 1e-3  # the f32 step "on" against "off" (TF32 off), loss
F32_STEP_SLACK = 1.25  # gradients and Adam moments: this times "off" with TF32 on's distance from the same reference
F32_ROUNDS = 24  # interleaved graph replays a setting of the f32 flagship step, in each of its pairs
F32_CAPTURE = 768  # examples of the f32 captured-vs-eager epoch: 3 steps of 256 rows
EXPECTED_F32_TRAIN_LAUNCHES = {
    **_NONE, "augment_fused": 1, "stem_fused_f32": 1, "stage_fused_save_f32": 1, "stage_fused_bwd_f32": 1,
    "proj_fused_save_f32": 3, "proj_fused_bwd_f32": 3, "block_fused_save_f32": 10, "block_fused_bwd_f32": 10,
}
EXPECTED_F32_EVAL_LAUNCHES = {**_NONE, "stem_fused_f32": 1, "stage_fused_f32": 1, "proj_fused_f32": 3,
                              "block_fused_f32": 10}


def _tensors(res) -> list:
    """A kernel's or plain version's result (a tensor, or nested tuples and
    lists of them, None for an output not asked for) as a flat list."""
    if res is None:
        return []
    if isinstance(res, (tuple, list)):
        return [t for r in res for t in _tensors(r)]
    return [res]


def _f32_record(results: dict, name: str, cases) -> None:
    """cases: [(label, count per step or eval forward, kernel fn, plain fn,
    cuDNN TF32 fn, flops, bytes)]. Each output of the kernel against the
    plain version's (TF32 off) within max(F32_GATE, F32_LIB_SLACK x the
    cuDNN composition's distance from the plain version: output by output
    where the composition gives it, else its first output's); times by CUDA
    events, the plain version's with TF32 off, the library's with it on."""
    import torch

    entry = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0, peak=PEAK_TF32)
    for label, count, kern, plain, lib, flops, nb in cases:
        _set_tf32(False)
        got, want = _tensors(kern()), _tensors(plain())
        _set_tf32(True)
        ref = _tensors(lib())
        if len(got) != len(want):
            raise AssertionError(f"{name} {label}: {len(got)} outputs, plain version {len(want)}")
        worst, tight = 0.0, (-1.0, "")  # the largest error, and the output nearest its gate
        for i, (a, b) in enumerate(zip(got, want)):
            if a.shape != b.shape or a.dtype != b.dtype or a.dtype != torch.float32:
                raise AssertionError(f"{name} {label}[{i}]: {tuple(a.shape)} {a.dtype} vs plain {tuple(b.shape)} "
                                     f"{b.dtype}")
            c = ref[i] if i < len(ref) else ref[0]
            w = b if i < len(ref) else want[0]
            err = (a.float() - b.float()).abs().max().item()
            lib_err = (c.float() - w.float()).abs().max().item()
            fixed = F32_GATE[0] * b.float().abs().max().item() + F32_GATE[1]
            gate = max(fixed, F32_LIB_SLACK * lib_err)
            if not (err <= gate) or not a.isfinite().all():
                raise AssertionError(f"{name} {label}[{i}]: max |kernel - plain| = {err} > {gate} (the fixed gate "
                                     f"{fixed}, cuDNN TF32's distance {lib_err})")
            worst = max(worst, err)
            if err / gate > tight[0]:
                tight = (err / gate, f"output {i}: {err:.4g} against the fixed gate {fixed:.4g} and cuDNN TF32's "
                                     f"distance {lib_err:.4g}")
        ms = cuda_ms(kern, 5)
        _set_tf32(False)
        pms = cuda_ms(plain, 2)
        _set_tf32(True)
        lms = cuda_ms(lib, 5)
        b, by = bound_ms(flops, nb, PEAK_TF32)
        say(f"f32 kernels: {name} {label} x{count}: max |kernel - plain| {worst:.4g}; nearest its gate {tight[1]}; "
            f"kernel {ms:.3f} ms, plain {pms:.3f} ms (TF32 off), cuDNN TF32 "
            f"{lms:.3f} ms, bound {b:.3f} ms ({by}), {flops / ms / 1e9:.1f} TFLOP/s")
        entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("flops", flops), ("bytes", nb)):
            entry[k] += count * v
    results[name] = entry


def _f32_lib_bwd(fn, args, g, leaves):
    """The autograd backward of the cuDNN composition `fn(*args)` for the
    output gradient g w.r.t. `args[i]` for i in `leaves` (x and the
    weights), re-run on one recorded graph; cuDNN's TF32 flag as it stands
    when the graph is recorded and when it is re-run."""
    import torch

    args = [t.detach().requires_grad_(i in leaves) for i, t in enumerate(args)]
    out = fn(*args)
    return lambda: torch.autograd.grad(out, [args[i] for i in leaves], g, retain_graph=True)


def _f32_kernels() -> dict:
    """The ten f32 rows at the f32 flagship step's and eval forward's shapes
    (N = 512 camera images of 256x256), each against its plain version in
    f32 with TF32 off under `_f32_record`'s gate, timed beside it and beside
    cuDNN's f32 composition in TF32 (the library call: `F.conv2d` on the
    folded weights, autograd for the backwards). Returns the entries by
    kernel name, times a step or eval forward."""
    import torch
    import torch.nn.functional as F

    from argus_tpu_torch.ops.kernels import block_fused, proj_fused, stage_fused, stem_fused

    g = torch.Generator(device="cuda").manual_seed(22)
    f32 = torch.float32
    results = {}

    def w_(*shape):
        return _w(g, *shape).float()

    def id_w(c, f):
        return (w_(c, f), _b(g, f), w_(3, 3, f, f), _b(g, f), w_(f, c), _b(g, c))

    def proj_w(cin, f, cout):
        return (w_(cin, f), _b(g, f), w_(3, 3, f, f), _b(g, f), w_(f, cout), _b(g, cout), w_(cin, cout), _b(g, cout))

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    def grad_like(t):
        return torch.randn(t.shape, generator=g, device="cuda")

    def dw_bytes(*ws):
        return sum(t.numel() * 4 for t in ws)

    # the stem: (N, 256, 256, 3) -> (N, 64, 64, 64), no save (frozen stem)
    x = rand(N_IMG, HW, HW, 3)
    w7, b7 = w_(7, 7, 3, 64), _b(g, 64)
    out = stem_fused.stem_pool(x, w7, b7)

    def lib_stem():
        y = torch.relu(_lib_conv(x, w7, 2, 3) + b7.reshape(-1))
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    _f32_record(results, "stem_fused_f32", [(
        f"{tuple(x.shape)}", 1, lambda: stem_fused.stem_pool(x, w7, b7), lambda: stem_fused.stem_pool_plain(x, w7, b7),
        lib_stem, 2 * N_IMG * (HW // 2) ** 2 * 64 * 147, nbytes(x, w7, b7, out),
    )])
    del x, out
    torch.cuda.empty_cache()

    # the stage-0 chain: no-save (eval), saving forward and backward (step)
    x0 = rand(N_IMG, 64, 64, 64)
    p0 = proj_w(64, 64, 256)
    ids0 = [id_w(256, 64) for _ in range(2)]
    wts0 = list(p0) + [t for w in ids0 for t in w]
    flops0 = _block_flops(N_IMG, 64, 64, 64, 64, 256, 1, True) + 2 * _block_flops(N_IMG, 64, 64, 256, 64, 256, 1,
                                                                                    False)

    def lib_stage(x, *w):
        y = _lib_block(x, *w[:8])
        for j in range(2):
            y = _lib_block(y, *w[8 + 6 * j: 14 + 6 * j])
        return y

    out_bytes = N_IMG * 64 * 64 * 256 * 4
    _f32_record(results, "stage_fused_f32", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: stage_fused.fused_stage(x0, p0, ids0, 1),
        lambda: stage_fused.stage_plain(x0, p0, ids0, 1), lambda: lib_stage(x0, *wts0),
        flops0, nbytes(x0, *wts0) + out_bytes,
    )])
    out, bnds, h1s, h2s = stage_fused.fused_stage_save(x0, p0, ids0, 1)
    _f32_record(results, "stage_fused_save_f32", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: stage_fused.fused_stage_save(x0, p0, ids0, 1),
        lambda: stage_fused.stage_save_plain(x0, p0, ids0, 1), lambda: lib_stage(x0, *wts0),
        flops0, nbytes(x0, *wts0, out, *bnds, *h1s, *h2s),
    )])
    g0 = grad_like(out)
    pw0 = (p0[0], p0[2], p0[4], p0[6])
    iw0 = [(w[0], w[2], w[4]) for w in ids0]
    bwd_args = (x0, g0, out, bnds, h1s, h2s, pw0, iw0, 1)
    dws0 = list(pw0) + [t for w in iw0 for t in w]
    leaves0 = [0, 1, 3, 5, 7] + [9 + 6 * j + k for j in range(2) for k in (0, 2, 4)]
    _f32_record(results, "stage_fused_bwd_f32", [(
        f"{tuple(x0.shape)} F=64", 1, lambda: _flat(stage_fused.stage_bwd(*bwd_args)),
        lambda: _flat(stage_fused.stage_bwd_plain(*bwd_args)), _f32_lib_bwd(lib_stage, [x0, *wts0], g0, leaves0),
        2 * flops0, nbytes(x0, g0, out, *bnds, *h1s, *h2s, *dws0) + nbytes(x0) + dw_bytes(*dws0),
    )])
    del x0, out, bnds, h1s, h2s, g0, bwd_args
    torch.cuda.empty_cache()

    cases = {k: [] for k in ("proj_fused_f32", "proj_fused_save_f32", "proj_fused_bwd_f32", "block_fused_f32",
                             "block_fused_save_f32", "block_fused_bwd_f32")}
    for i, (h, cin, f, n_id) in enumerate([(64, 256, 128, 3), (32, 512, 256, 5), (16, 1024, 512, 2)]):
        cout, ho = 4 * f, h // 2
        xp = rand(N_IMG, h, h, cin)
        pw = proj_w(cin, f, cout)
        fl = _block_flops(N_IMG, h, h, cin, f, cout, 2, True)
        saved = proj_fused.projection_block_save(xp, *pw, 2)
        label = f"stage{i + 1} {tuple(xp.shape)} F={f}"
        lib = lambda xp=xp, pw=pw: _lib_block(xp, *pw[:6], pw[6], pw[7], stride=2)  # noqa: E731
        cases["proj_fused_f32"].append((
            label, 1, lambda xp=xp, pw=pw: proj_fused.projection_block(xp, *pw, 2),
            lambda xp=xp, pw=pw: proj_fused.projection_block_plain(xp, *pw, 2), lib, fl, nbytes(xp, *pw, saved[0]),
        ))
        cases["proj_fused_save_f32"].append((
            label, 1, lambda xp=xp, pw=pw: proj_fused.projection_block_save(xp, *pw, 2),
            lambda xp=xp, pw=pw: proj_fused.projection_block_save_plain(xp, *pw, 2), lib, fl, nbytes(xp, *pw, *saved),
        ))
        gp = grad_like(saved[0])
        args = (xp, gp, *saved, pw[0], pw[2], pw[4], pw[6], 2)
        cases["proj_fused_bwd_f32"].append((
            label, 1, lambda args=args: proj_fused.proj_bwd(*args), lambda args=args: proj_fused.proj_bwd_plain(*args),
            _f32_lib_bwd(lambda x, *w: _lib_block(x, *w[:6], w[6], w[7], stride=2), [xp, *pw], gp, [0, 1, 3, 5, 7]),
            2 * fl, nbytes(xp, gp, *saved, pw[0], pw[2], pw[4], pw[6]) + nbytes(xp)
            + dw_bytes(pw[0], pw[2], pw[4], pw[6]),
        ))
        xi = rand(N_IMG, ho, ho, cout)
        iw = id_w(cout, f)
        fl = _block_flops(N_IMG, ho, ho, cout, f, cout, 1, False)
        saved = block_fused.bottleneck_block_save(xi, *iw)
        label = f"stage{i + 1} {tuple(xi.shape)} F={f}"
        lib = lambda xi=xi, iw=iw: _lib_block(xi, *iw)  # noqa: E731
        cases["block_fused_f32"].append((
            label, n_id, lambda xi=xi, iw=iw: block_fused.bottleneck_block(xi, *iw),
            lambda xi=xi, iw=iw: block_fused.bottleneck_block_plain(xi, *iw), lib, fl, 2 * nbytes(xi) + nbytes(*iw),
        ))
        cases["block_fused_save_f32"].append((
            label, n_id, lambda xi=xi, iw=iw: block_fused.bottleneck_block_save(xi, *iw),
            lambda xi=xi, iw=iw: block_fused.bottleneck_block_save_plain(xi, *iw), lib, fl,
            nbytes(xi, *iw, *saved),
        ))
        gi = grad_like(saved[0])
        args = (xi, gi, *saved, iw[0], iw[2], iw[4])
        cases["block_fused_bwd_f32"].append((
            label, n_id, lambda args=args: block_fused.block_bwd(*args),
            lambda args=args: block_fused.block_bwd_plain(*args),
            _f32_lib_bwd(_lib_block, [xi, *iw], gi, [0, 1, 3, 5]),
            2 * fl, nbytes(xi, gi, *saved, iw[0], iw[2], iw[4]) + nbytes(xi) + dw_bytes(iw[0], iw[2], iw[4]),
        ))
    for name, cs in cases.items():
        _f32_record(results, name, cs)
    del cases
    torch.cuda.empty_cache()
    return results


def _f32_table() -> dict:
    """`AUTO_FUSE`'s f32 entries by (function, mode)."""
    from argus_tpu_torch.models.resnet import AUTO_FUSE

    return {(f, m): v for (f, m, d), v in AUTO_FUSE.items() if d == "float32"}


def _expected_f32_launches(serving: bool, stem_trained: bool = False) -> dict:
    """The launches of one f32 flagship step (or, with `serving`, one eval
    forward) with every fuse flag "auto": the f32 kernels `AUTO_FUSE`'s f32
    entries name (the trained stem has no f32 kernel: ROADMAP A14)."""
    table = _f32_table()
    mode = "forward" if serving else "train"
    want = dict(_NONE, augment_fused=int(not serving))
    if table.get(("stem", "forward")) and (serving or not stem_trained):
        want["stem_fused_f32"] += 1
    chain = table.get(("stage_chain_packed" if serving else "stage_chain", mode), False)
    if chain:
        for k in (("stage_fused_f32",) if serving else ("stage_fused_save_f32", "stage_fused_bwd_f32")):
            want[k] += 1
    for i, n in enumerate((3, 4, 6, 3)):
        if i == 0 and chain:
            continue
        for name, count, fn in (("proj_fused", 1, "projection"), ("block_fused", n - 1, "identity")):
            if table.get((fn, mode)):
                for k in ((name + "_f32",) if serving else (name + "_save_f32", name + "_bwd_f32")):
                    want[k] += count
    return want


def _f32_step_checks() -> tuple:
    """The f32 flagship step (`amp=False`, 256 rows, default augmentation)
    from one state three ways: "off" with TF32 off (the reference), "on"
    (the f32 kernels; TF32 off for what they leave to PyTorch) and "off"
    with TF32 on (cuDNN as `train()` runs it). The loss of "on" within
    F32_LOSS_RTOL of the reference's; its gradients (one augmented batch,
    `_loss_and_grads_on`) and its Adam moments after one step no farther
    from the reference than F32_STEP_SLACK times "off" with TF32 on is
    (relative 2-norms, max and median over tensors). Launches of one step
    and of one eval forward (no gradients) with "on". Returns (step
    launches, eval launches)."""
    import torch

    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.ops.augment import apply_augmentation
    from argus_tpu_torch.train import _loss_and_grads_on, feed_images, make_train_step

    cfg, model, state, batch = flagship_train_setup(amp=False)
    bb = model.backbone
    images = apply_augmentation(cfg.augmentation_config, 99, feed_images(cfg, batch["images"], "cuda"))
    snap = {k: t.detach().clone() for k, t in _state_tensors(state).items()}
    step0 = state.step
    step = make_train_step(model, cfg)
    runs = {}
    for label, flags, tf32 in (("ref", "off", False), ("on", "on", False), ("tf32", "off", True)):
        for k in FUSE_ON:
            setattr(bb, k, flags)
        _set_tf32(tf32)
        loss, grads = _loss_and_grads_on(model, state.params, images, batch)
        grads = {k: v.detach().clone() for k, v in grads.items()}
        kernels.reset_launch_counts()
        state, step_loss = step(state, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        moments = {k: t.detach().clone() for k, t in _state_tensors(state).items() if k[:3] in ("mu/", "nu/")}
        with torch.no_grad():
            for k, t in _state_tensors(state).items():
                t.copy_(snap[k])
        state.step = step0
        runs[label] = (loss.item(), grads, moments, launches, step_loss.item())
    if runs["on"][3] != EXPECTED_F32_TRAIN_LAUNCHES:
        raise AssertionError(f"f32 step: launches {runs['on'][3]} != {EXPECTED_F32_TRAIN_LAUNCHES}")
    ref = runs["ref"]
    loss_err = abs(runs["on"][0] - ref[0]) / abs(ref[0])
    spreads = {}
    for label in ("on", "tf32"):
        spreads[label] = [_spread(_grad_errors(runs[label][1], ref[1])),
                          _spread(_grad_errors(runs[label][2], ref[2]))]
    ok = loss_err <= F32_LOSS_RTOL
    for j, what in enumerate(("gradients", "Adam moments")):
        (w_on, m_on, n_on), (w_tf, m_tf, n_tf) = spreads["on"][j], spreads["tf32"][j]
        ok = ok and w_on <= F32_STEP_SLACK * w_tf and m_on <= F32_STEP_SLACK * m_tf
        say(f"f32 step ({N_ROWS} rows): {what} from 'off' with TF32 off: 'on' max rel {w_on:.3g} ({n_on}), median "
            f"{m_on:.3g}; 'off' with TF32 on max rel {w_tf:.3g} ({n_tf}), median {m_tf:.3g} (limit {F32_STEP_SLACK}x)")
    say(f"f32 step ({N_ROWS} rows): loss 'on' {runs['on'][0]:.7f}, 'off' TF32 off {ref[0]:.7f} (rel {loss_err:.3g}, "
        f"tol {F32_LOSS_RTOL}), 'off' TF32 on {runs['tf32'][0]:.7f}; the step's own losses "
        + ", ".join(f"{k} {v[4]:.7f}" for k, v in runs.items())
        + f"; launches of an 'on' step {({k: v for k, v in runs['on'][3].items() if v})}")
    if not ok:
        raise AssertionError("the f32 step 'on' is farther from 'off' (TF32 off) than the gates allow")
    for k in FUSE_ON:
        setattr(bb, k, "on")
    kernels.reset_launch_counts()
    with torch.no_grad():
        model(images)
    eval_launches = kernels.launch_counts()
    if eval_launches != EXPECTED_F32_EVAL_LAUNCHES:
        raise AssertionError(f"f32 eval forward: launches {eval_launches} != {EXPECTED_F32_EVAL_LAUNCHES}")
    say(f"f32 eval forward ({N_ROWS} rows, 'on'): launches {({k: v for k, v in eval_launches.items() if v})}")
    _set_tf32(True)
    launches = runs["on"][3]
    del model, state, batch, images, runs, snap, step
    torch.cuda.empty_cache()
    return launches, eval_launches


def _f32_graph_times() -> dict:
    """The f32 flagship step with the fuse flags "on", "off" and "auto",
    each on its own CUDA graph of `TrainStepBody.compute` (as the auto
    phase), with TF32 as `train()` leaves it. Three f32 graphs of 256 rows
    do not fit the card's 80 GB at once (two hold ~61 GiB in their pools),
    so the graphs are timed in two pairs, "on" with "off" and then "auto"
    with "off", each pair's replays interleaved (alternating which goes
    first) F32_ROUNDS times a setting, by CUDA events, the fastest kept
    ("off": of both pairs). The peak memory of one eager step each; an
    eager "auto" step launches what the f32 entries of `AUTO_FUSE` name,
    and "auto" is no slower than the faster of the others by more than
    AUTO_SLACK. Returns {flags: (ms, peak bytes)}."""
    import torch

    from argus_tpu_torch.capture import WARMUP_STEPS, CapturedCall
    from argus_tpu_torch.ops import kernels
    from argus_tpu_torch.train import TrainStepBody, make_train_step

    _set_tf32(True)
    cfg, model, state, batch = flagship_train_setup(amp=False)
    step = make_train_step(model, cfg)
    peak, launched = {}, {}

    def switch(flags):
        for k in FUSE_ON:
            setattr(model.backbone, k, flags)

    for flags in ("on", "off", "auto"):
        switch(flags)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        peak[flags], launched[flags] = torch.cuda.max_memory_allocated(), kernels.launch_counts()
    want = _expected_f32_launches(serving=False)
    if launched["auto"] != want:
        raise AssertionError(f"f32 auto step: launches {launched['auto']} != the f32 table's {want}")
    body = TrainStepBody(model, cfg)
    operands = body.prepare(state.step, batch["images"], batch["cube_pose"], batch["mask"])
    out = {}
    for pair in (("on", "off"), ("auto", "off")):
        runs = {}
        for flags in pair:
            switch(flags)
            runs[flags] = CapturedCall(body.compute, body.device)
            for _ in range(WARMUP_STEPS + 1):
                runs[flags](state, operands)
        torch.cuda.synchronize()
        for r in range(F32_ROUNDS):
            order = pair if r % 2 == 0 else pair[::-1]
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in order]
            for flags, (e0, e1) in zip(order, events):
                e0.record()
                runs[flags](state, operands)
                e1.record()
            torch.cuda.synchronize()
            for flags, (e0, e1) in zip(order, events):
                out.setdefault(flags, []).append(e0.elapsed_time(e1))
        del runs
        torch.cuda.empty_cache()
    times = {flags: (min(ts), peak[flags]) for flags, ts in out.items()}
    say(f"f32 flagship step ({N_ROWS} rows = {N_IMG} camera images, augmentation on; {_tf32_flags()}; graphs in "
        f"pairs, on + off then auto + off): " + "; ".join(
            f"{flags} fastest of {len(out[flags])} replays {ms:.2f} ms (median {sorted(out[flags])[len(out[flags]) // 2]:.2f}, "
            f"{N_IMG / ms * 1e3:.1f} camera-images/s), peak {pk / 2**30:.2f} GiB an eager step"
            for flags, (ms, pk) in times.items())
        + f"; the f32 table: {({'/'.join(k): v for k, v in _f32_table().items()})}")
    best = min(times["on"][0], times["off"][0])
    if times["auto"][0] > (1 + AUTO_SLACK) * best:
        raise AssertionError(f"f32 auto step {times['auto'][0]:.2f} ms is slower than the faster of on and off "
                             f"({best:.2f}) by more than {AUTO_SLACK}")
    del model, state, batch, step, body, operands
    torch.cuda.empty_cache()
    return times


def f32_phase(tmpdir: str, sets) -> tuple:
    """Phase 22: argus_tpu's frozen-BN ResNet-50 at its default compute
    dtype, f32 (`_f32_kernels`, `_f32_step_checks`, `_f32_graph_times`);
    the "on" flagship step's resident epoch captured as a CUDA graph, bit-
    equal to the same epoch eager (`_captured_vs_eager`, F32_CAPTURE
    examples); then `train()` at `TrainConfig(model_config=NCameraCNNConfig(
    bn_frozen=True, bn_frozen_affine=True))`, every other field at its
    default (f32, batch 32, the stem trained, fuse "auto"), 2 epochs and 1
    resumed, resident, on DEFAULT_TRAIN + LOOP_VAL of the loop phase's
    rendered examples, under `_check_loop`'s checks with the launches the
    f32 table names. Returns (measured entries, step launches, eval
    launches)."""
    import torch

    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    t0 = time.perf_counter()
    measured = _f32_kernels()
    t_kernels = time.perf_counter() - t0
    launches, eval_launches = _f32_step_checks()
    times = _f32_graph_times()

    _set_tf32(True)
    cfg_on, _, _, _ = flagship_train_setup(amp=False)
    cap = _captured_vs_eager(cfg_on, sets, EXPECTED_F32_TRAIN_LAUNCHES, "f32 flagship ('on'):", n=F32_CAPTURE)
    if not cap["bit_equal"]:
        raise AssertionError("f32 flagship ('on'): the captured epoch is not bit-equal to the eager one")

    cfg = TrainConfig(model_config=NCameraCNNConfig(bn_frozen=True, bn_frozen_affine=True), n_epochs=2,
                      wandb_log=False, save_dir=os.path.join(tmpdir, "ckpt"))
    B = cfg.batch_size
    train_set = tuple(a[:DEFAULT_TRAIN] for a in sets[0])
    datasets = (FramesDataset(*train_set), FramesDataset(*sets[1]))
    steps, val_batches = -(-DEFAULT_TRAIN // B), -(-len(sets[1][0]) // B)
    per_step = _expected_f32_launches(serving=False, stem_trained=True)
    per_eval = _expected_f32_launches(serving=True)
    want = {k: 2 * steps * per_step[k] + 2 * val_batches * per_eval[k] for k in per_step}
    t1 = time.perf_counter()
    first, resumed, runs, loop_launches, ready, loop_times = _loop_runs(cfg, datasets)
    _check_loop("f32 frozen-BN default", cfg, first, resumed, runs, loop_launches, steps, loop_times, want)
    rate = 2 * B / _second_epoch_ms(runs[0], steps) * 1e3
    say(f"f32 frozen-BN default train() ({steps} steps of {B} rows an epoch, resident, fuse 'auto', {_tf32_flags()}): "
        f"{rate:.1f} camera-images/s in the first run's second epoch; f32 flagship step ms: "
        + ", ".join(f"{k} {v[0]:.2f}" for k, v in times.items())
        + f"; captured epoch step {cap['replayed']:.2f} ms replayed, {cap['eager']:.2f} ms eager; the phase took "
        f"{time.perf_counter() - t0:.1f} s (kernels {t_kernels:.1f} s, train() {time.perf_counter() - t1:.1f} s)")
    torch.cuda.empty_cache()
    return measured, launches, eval_launches


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
        launches, _, ckpt, frames, poses = end_to_end_phase(tmpdir)
        control_loop_phase(tmpdir, ckpt, frames, poses)
        del frames, poses
    measured.update(train_kernel_phase())
    measured.update(basic_kernel_phase())
    engine_phase()
    measured.update(stem_bn_kernel_phase())
    aug_measured, aug_launches = augment_phase()
    measured.update(aug_measured)
    train_launches, step_ms = train_phase()
    accum_launches, accum_runs = accum_phase()
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

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        parallel_phase(step_ms, loop, tmpdir)
    streaming_phase(step_ms)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        import_phase(tmpdir)
        profiling_phase(tmpdir)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        default_config_phase(tmpdir, loop["sets"])
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmpdir:
        f32_measured, f32_launches, f32_eval_launches = f32_phase(tmpdir, loop["sets"])
    measured.update(f32_measured)

    rows = []
    for name, m in measured.items():
        b, by = bound_ms(m["flops"], m["bytes"], m.get("peak", PEAK_FLOPS))
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": (launches[name] or train_launches[name] or a_launches[name] or b_launches[name]
                         or aug_launches["per-op"][name] or kp_launches[name] or kp_eval_launches[name]
                         or f_launches[name] or f_eval_launches[name] or p_launches[name] or r_launches[name]
                         or f32_launches[name] or f32_eval_launches[name]),
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": b, "bound_by": by, "library_ms": m["library_ms"],
        })
    say(f"the fine-tune in this call: fused ('on') {f_ms:.2f} ms/step, 'auto' {auto_ms['frozen_stages=3']['auto']:.2f}, "
        f"unfused {f_unfused_ms:.2f}; train() end to end, camera-images/s, the resumed run's train pass: " + ", ".join(
            f"{label} {N_IMG / o['e2e_ms'] * 1e3:.1f}" for label, o in loop["paths"].items())
        + "; the first run's second epoch: " + ", ".join(
            f"{label} {N_IMG / o['saving_ms'] * 1e3:.1f}" for label, o in loop["paths"].items())
        + f"; compute only {N_IMG / loop['compute_ms'] * 1e3:.1f}; the flagship step {accum_runs[1][0]:.2f} ms "
        f"({accum_runs[1][1] / 2**30:.2f} GiB), with grad_accum_steps=2 {accum_runs[2][0]:.2f} ms "
        f"({accum_runs[2][1] / 2**30:.2f} GiB); {GPU}")
    say(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.0f} s (the build included)")
    print(json.dumps({"kernels": rows}))
    print(GPU)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
