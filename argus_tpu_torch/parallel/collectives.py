"""The collectives of the port's data and tensor parallelism, each over a
process group of a `Mesh`; over None (a group of one rank) each does
nothing.

- `all_reduce_loss_and_grads`: argus_tpu's bucketed gradient all-reduce
  (`_shard_loss_and_grad`, `argus_tpu/train.py:313-346`): one flat f32
  vector `[loss_sum, mask_count, every gradient]` summed over the data
  group in `N_BUCKETS` contiguous buckets, outside the differentiated
  region, so the caller divides the sums by the global mask count.
- `all_reduce_`: an in-place sum (BatchNorm's per-channel sums, the
  clip's squared norm, the eval step's sums, the loop's agreements).
- `copy_to_model` / `reduce_from_model`: the tensor-parallel pair for
  the wide dense layers: the identity forward whose backward sums the
  cotangent over the model group (the features entering the sharded
  projection), and the sum over the model group whose backward is the
  identity (head_fc1's partial products).
- `gather_whole`: a sharded leaf whole on every rank of the model group.

Every collective is issued in the same order on every rank of its group,
from the thread that runs the step; none is retried or caught. NCCL takes
CUDA tensors, gloo CPU and CUDA tensors alike (it stages a CUDA tensor
through host memory itself).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

N_BUCKETS = 4  # argus_tpu's bucket count: one collective per bucket, a few per step


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum (or `op`) `t` over `group` in place; `t` itself over None."""
    if group is None:
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def bucket_bounds(n: int) -> List[Tuple[int, int]]:
    """argus_tpu's bucket edges of a flat vector of n entries:
    round(i * n / k) for k = min(N_BUCKETS, n) buckets."""
    k = min(N_BUCKETS, n)
    edges = [round(i * n / k) for i in range(k + 1)]
    return list(zip(edges[:-1], edges[1:]))


def all_reduce_loss_and_grads(loss_sum: torch.Tensor, count: torch.Tensor, grads: Dict[str, torch.Tensor],
                              group) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss_sum, count, grads) summed over `group`, as one flat f32 vector
    reduced in `N_BUCKETS` buckets; the gradients come back in f32 with
    their shapes. Over None the inputs are returned in f32."""
    names = list(grads)
    if group is None:
        return loss_sum.float(), count.float(), {k: grads[k].float() for k in names}
    flat = torch.cat([loss_sum.reshape(1).float(), count.reshape(1).float()]
                     + [grads[k].reshape(-1).float() for k in names])
    for a, b in bucket_bounds(flat.numel()):
        all_reduce_(flat[a:b], group)
    out, i = {}, 2
    for k in names:
        n = grads[k].numel()
        out[k] = flat[i:i + n].view(grads[k].shape)
        i += n
    return flat[0], flat[1], out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over the model group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the model group; its gradient passes unchanged."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_whole(local: torch.Tensor, shard, group) -> torch.Tensor:
    """The whole tensor of a leaf cut by `shard` (a `mesh.Shard`), on every
    rank of the model group: each rank's slice placed in zeros, summed."""
    return all_reduce_(shard.place(local), group)


def agree_any(flag: bool, group, device) -> bool:
    """True on every rank when any rank of `group` passes True (the loop's
    preemption decision), one collective; `flag` itself over None."""
    if group is None:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce_(t, group, dist.ReduceOp.MAX).item() > 0)


def broadcast_object(obj):
    """Rank 0's `obj` on every rank of the job (the run id); `obj` itself
    without a process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
