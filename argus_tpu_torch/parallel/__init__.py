"""Data and tensor parallelism of the port: one process per card.

Port of `argus_tpu/parallel` (argus_tpu's DDP/NCCL replacement), with
torch's one-process-per-card layout in place of one process driving every
local device:

- `init_distributed` (the rendezvous: `torchrun`'s environment or an
  explicit address), `make_mesh` / `Mesh` (the (data, model) grid of
  ranks, its process groups, `local_rows` in place of `batch_sharding` and
  `global_batch`), `DEFAULT_TP_RULES`, `param_shardings`, `replicated`
  (`mesh`);
- the bucketed gradient all-reduce and the collectives BatchNorm and the
  tensor-parallel layers use (`collectives`);
- `shard_model_`, `whole_state` (`tp`): the sharded leaves of a model and
  a train state gathered whole for a checkpoint;
- `run_ranks`, n local processes on one group (`launch`).
"""

from argus_tpu_torch.parallel.mesh import (
    DEFAULT_TP_RULES,
    Mesh,
    Shard,
    init_distributed,
    make_mesh,
    param_shardings,
    replicated,
)

__all__ = [
    "DEFAULT_TP_RULES",
    "Mesh",
    "Shard",
    "init_distributed",
    "make_mesh",
    "param_shardings",
    "replicated",
]
