"""Hand-written Hopper kernels of the port, one module per argus_tpu Pallas
kernel, each with its plain PyTorch version beside it (see `_build` for how
the CUDA sources are compiled and bound).

`KERNELS` maps each kernel's name to its `Kernel` handle, whose `launches`
counts the wrapper's successful launches.
"""

from __future__ import annotations

from argus_tpu_torch.ops.kernels import block_fused, proj_fused, stage_fused, stem_fused

KERNELS = {
    "stem_fused": stem_fused.KERNEL,
    "stage_fused": stage_fused.KERNEL,
    "proj_fused": proj_fused.KERNEL,
    "block_fused": block_fused.KERNEL,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
