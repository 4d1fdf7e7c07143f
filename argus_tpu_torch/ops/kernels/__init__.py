"""Hand-written Hopper kernels of the port, one module per argus_tpu Pallas
kernel family (forward, saving forward, backward; the stem, the bottleneck
and the BasicBlock families, the stem and bottleneck ones also in f32; the augmentation's whole-stack and blur
kernels; BatchNorm's two reductions; the pointwise conv; the identity block's
recompute backward), each with its plain PyTorch version
beside it (see `_build` for how the CUDA sources are
compiled and bound).

`KERNELS` maps each kernel's name to its `Kernel` handle, whose `launches`
counts the wrapper's successful launches.
"""

from __future__ import annotations

from argus_tpu_torch.ops.kernels import (
    augment_fused,
    basic_fused,
    block_fused,
    blur,
    bn_reduce,
    pointwise,
    proj_fused,
    stage_fused,
    stem_fused,
)

KERNELS = {
    "stem_fused": stem_fused.KERNEL,
    "stage_fused": stage_fused.KERNEL,
    "proj_fused": proj_fused.KERNEL,
    "block_fused": block_fused.KERNEL,
    "stage_fused_save": stage_fused.KERNEL_SAVE,
    "stage_fused_bwd": stage_fused.KERNEL_BWD,
    "proj_fused_save": proj_fused.KERNEL_SAVE,
    "proj_fused_bwd": proj_fused.KERNEL_BWD,
    "block_fused_save": block_fused.KERNEL_SAVE,
    "block_fused_bwd": block_fused.KERNEL_BWD,
    "augment_fused": augment_fused.KERNEL,
    "blur": blur.KERNEL,
    "basic_fused": basic_fused.KERNEL,
    "basic_fused_save": basic_fused.KERNEL_SAVE,
    "basic_fused_bwd": basic_fused.KERNEL_BWD,
    "stem_fused_save": stem_fused.KERNEL_SAVE,
    "stem_fused_packed": stem_fused.KERNEL_PACKED,
    "stage_fused_frozen": stage_fused.KERNEL_FROZEN,
    "stem_fused_bwd": stem_fused.KERNEL_BWD,
    "bn_stats": bn_reduce.KERNEL_STATS,
    "bn_bwd_reduce": bn_reduce.KERNEL_BWD,
    "pointwise": pointwise.KERNEL,
    "pointwise_bwd": pointwise.KERNEL_BWD,
    "block_fused_rbwd": block_fused.KERNEL_RBWD,
    # the f32 kernels (TF32 products): argus_tpu's default compute dtype
    "stem_fused_f32": stem_fused.KERNEL_F32,
    "stage_fused_f32": stage_fused.KERNEL_F32,
    "stage_fused_save_f32": stage_fused.KERNEL_SAVE_F32,
    "stage_fused_bwd_f32": stage_fused.KERNEL_BWD_F32,
    "proj_fused_f32": proj_fused.KERNEL_F32,
    "proj_fused_save_f32": proj_fused.KERNEL_SAVE_F32,
    "proj_fused_bwd_f32": proj_fused.KERNEL_BWD_F32,
    "block_fused_f32": block_fused.KERNEL_F32,
    "block_fused_save_f32": block_fused.KERNEL_SAVE_F32,
    "block_fused_bwd_f32": block_fused.KERNEL_BWD_F32,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
