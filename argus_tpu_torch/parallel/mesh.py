"""The port's process layout: one process per card, the (data, model) grid
of ranks, the rows of the global batch each rank holds, and the
tensor-parallel rules for the wide dense layers.

Port of `argus_tpu/parallel/mesh.py`. argus_tpu drives every local device
from one process and lets XLA place the collectives; the port runs one
process per card, torch's idiom and the reference's own. The terms map so
that the port's ranks see argus_tpu's global batch:

- argus_tpu's *process* (a host) is the port's *node*: `process_index` /
  `process_count` become the node's index and the node count (under
  `torchrun`, `GROUP_RANK` and `WORLD_SIZE / LOCAL_WORLD_SIZE`);
- argus_tpu's devices of one process are the port's local ranks of one
  node, and its mesh's device order is the ranks' order: rank
  `d * n_model + m` holds data index d and model index m (`make_mesh`
  puts "model" over adjacent ranks, as argus_tpu puts it over adjacent
  devices);
- the global batch's rows are node n's host batch (`HostDataLoader` with
  `batch_size // n_nodes` rows, `process_index=n`), then the next node's,
  and within a node the host batch is cut contiguously over its data
  ranks, which is `global_batch`'s row order; data index d holds global
  rows `[d * b, (d + 1) * b)` with `b = B // n_data` (`Mesh.local_rows`).

The ranks of one model group hold the same rows. A `Mesh` holds the
process groups its collectives run over (`parallel.collectives`): the
data group of this rank's model index and the model group of its data
index, each None where it has one rank (a collective over None does
nothing), unless `reduce_alone` asks for the collectives at size 1 (the
NCCL path on one card).
"""

from __future__ import annotations

import datetime
import os
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the process group `init_distributed` made and its ranks per node
_MADE = {"group": None, "local_world_size": 1}


def _backend_for(dev: torch.device, local_world_size: int) -> str:
    """NCCL where each local rank has a card of its own, else gloo (the
    CPU, and several ranks sharing one card, which NCCL refuses)."""
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_world_size: Optional[int] = None,
    device=None,
    timeout: Optional[float] = None,
) -> Tuple[int, int]:
    """Join the job's process group; returns (process_index, process_count)
    in argus_tpu's sense, the node's index and the node count.

    The rendezvous is `torchrun`'s environment (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK, MASTER_ADDR, MASTER_PORT), or
    the explicit one: `coordinator_address` "host:port", `num_processes`
    the world size and `process_id` this rank (one process per card), with
    `local_world_size` ranks a node (default 1: each process a node of its
    own, argus_tpu's multi-host case). A single process with neither
    returns (0, 1) and initialises nothing, as argus_tpu does; a group that
    exists already is reused, its nodes from `ranks_per_node`.

    The backend follows the device (`device`, default CUDA when present):
    NCCL when every local rank has a card, gloo on the CPU and for several
    ranks on one card. The chosen backend is printed by rank 0. On CUDA the process is bound to card `LOCAL_RANK`
    (modulo the cards present) before the group is created. `timeout`
    (seconds) bounds the rendezvous and every collective; a rendezvous that
    fails raises."""
    if dist.is_initialized():
        lws = ranks_per_node(local_world_size)
        return dist.get_rank() // lws, dist.get_world_size() // lws
    env = os.environ
    if coordinator_address is None and "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        lws = int(env.get("LOCAL_WORLD_SIZE", local_world_size or 1))
        local_rank = int(env.get("LOCAL_RANK", rank % lws))
        init_method = "env://"
    elif coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit rendezvous needs num_processes and process_id")
        rank, world = int(process_id), int(num_processes)
        lws = int(local_world_size or 1)
        local_rank = rank % lws
        init_method = f"tcp://{coordinator_address}"
    else:
        return 0, 1
    if world % lws:
        raise ValueError(f"world size {world} does not divide into nodes of {lws} ranks")
    dev = torch.device("cuda" if device is None and torch.cuda.is_available() else (device or "cpu"))
    backend = _backend_for(dev, lws)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    _MADE.update(group=dist.group.WORLD, local_world_size=lws)
    if rank == 0:
        print(f"init_distributed: backend {backend}, {world} ranks, {world // lws} node(s) of {lws}", flush=True)
    return rank // lws, world // lws


def ranks_per_node(local_world_size: Optional[int] = None) -> int:
    """The ranks of one node in the initialised process group: what
    `init_distributed` found when it made the group, else torchrun's
    LOCAL_WORLD_SIZE, else `local_world_size`. A group of several ranks
    made elsewhere with none of these raises: its node layout, which sets
    the global batch's row order and the model groups, is not known."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 1
    if _MADE["group"] is dist.group.WORLD:
        return _MADE["local_world_size"]
    lws = os.environ.get("LOCAL_WORLD_SIZE", local_world_size)
    if lws is None:
        raise ValueError("the process group was not made by init_distributed and LOCAL_WORLD_SIZE is not set: "
                         "the ranks per node are unknown; call argus_tpu_torch.parallel.init_distributed() or "
                         "run under torchrun")
    lws = int(lws)
    if lws < 1 or dist.get_world_size() % lws:
        raise ValueError(f"world size {dist.get_world_size()} does not divide into nodes of {lws} ranks")
    return lws


@dataclass
class Mesh:
    """The (data, model) grid of ranks seen from one rank (`make_mesh`)."""

    n_data: int
    n_model: int
    rank: int
    local_world_size: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    world_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def node_index(self) -> int:
        return self.rank // self.local_world_size

    @property
    def n_nodes(self) -> int:
        return self.world_size // self.local_world_size

    def local_rows(self, global_rows: int) -> slice:
        """This rank's rows of a global batch of `global_rows` (argus_tpu's
        `batch_sharding` and `global_batch`): data index d holds
        `[d * b, (d + 1) * b)`, b = global_rows // n_data."""
        if global_rows % self.n_data:
            raise ValueError(f"global batch {global_rows} must divide over {self.n_data} data ranks")
        b = global_rows // self.n_data
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def node_rows(self, node_rows: int) -> slice:
        """This rank's rows of its node's host batch of `node_rows`: the
        node's data ranks cut it contiguously in order."""
        per_node = self.n_data // self.n_nodes
        if node_rows % per_node:
            raise ValueError(f"a node's batch {node_rows} must divide over its {per_node} data ranks")
        b = node_rows // per_node
        j = self.data_index - self.node_index * per_node
        return slice(j * b, (j + 1) * b)

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, reduce_alone: bool = False) -> Mesh:
    """The ("data", "model") grid over the ranks of the process group (one
    rank, no group, when none is initialised). `n_data` defaults to the
    world size // n_model and must fill the world; model groups are
    adjacent ranks and lie within a node. Every rank must call this, in the
    same order, since it creates the process groups. `reduce_alone` gives
    a data group also at one data rank (the world, for the collectives' own
    path at size 1)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    lws = ranks_per_node()
    if world % n_model:
        raise ValueError(f"a model axis of {n_model} ranks does not divide the group's {world} ranks")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, the group has {world}")
    if n_model > 1 and (lws % n_model):
        raise ValueError(f"model groups of {n_model} ranks must lie within a node of {lws}")
    mesh = Mesh(n_data, n_model, rank, lws)
    if world == 1:
        if reduce_alone:
            if not dist.is_initialized():
                raise ValueError("reduce_alone needs an initialised process group")
            mesh.data_group = mesh.world_group = dist.group.WORLD
        return mesh
    mesh.world_group = dist.group.WORLD
    if n_model == 1:
        mesh.data_group = dist.group.WORLD
    elif n_data == 1:
        mesh.model_group = dist.group.WORLD
    else:
        for m in range(n_model):  # every rank creates every group, in one order
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_index:
                mesh.data_group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_index:
                mesh.model_group = g
    return mesh


# ───────────────────────────── tensor parallelism ─────────────────────────────


@dataclass(frozen=True)
class Shard:
    """How a parameter is cut over the model group: along `dim` into
    `parts` slices, this rank holding slice `index`; with `blocks` > 1 the
    dim is `blocks` equal blocks and each is cut the same way (head_fc1's
    input columns: one block of features per camera)."""

    dim: int
    parts: int
    index: int
    blocks: int = 1

    def _view(self, t: torch.Tensor) -> torch.Tensor:
        shape = list(t.shape)
        return t.reshape(shape[:self.dim] + [self.blocks, shape[self.dim] // self.blocks] + shape[self.dim + 1:])

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor."""
        v = self._view(full)
        n = v.shape[self.dim + 1] // self.parts
        local = v.narrow(self.dim + 1, self.index * n, n)
        shape = list(full.shape)
        shape[self.dim] //= self.parts
        return local.reshape(shape).contiguous()

    def place(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor with this rank's slice in place and zeros
        elsewhere (summed over the model group, the whole tensor)."""
        shape = list(local.shape)
        shape[self.dim] *= self.parts
        full = torch.zeros(shape, dtype=local.dtype, device=local.device)
        v = self._view(full)
        n = v.shape[self.dim + 1] // self.parts
        v.narrow(self.dim + 1, self.index * n, n).copy_(self._view(local))
        return full


# The port's copy of argus_tpu's `DEFAULT_TP_RULES` (`mesh.py:96-119`),
# written against the port's names (torch's Linear weight is (out, in), the
# transpose of flax's kernel): the backbone projection's output features,
# its bias, and head_fc1's contraction dim. `blocks_of`: the leaf whose cut
# sets head_fc1's column blocks. argus_tpu cuts head_fc1's columns as one
# contiguous block of the camera concatenation and GSPMD reshards the
# features to it; the port cuts them by the projection's feature slices
# (each camera's block of columns cut the same way), so the features need
# no reshard.
DEFAULT_TP_RULES: Tuple[Tuple[str, int, Optional[str]], ...] = (
    (r"(.*\.)?backbone\.fc\.weight$", 0, None),
    (r"(.*\.)?backbone\.fc\.bias$", 0, None),
    (r"(.*\.)?head_fc1\.weight$", 1, "backbone.fc.bias"),
)


def replicated():
    """The spec of a leaf every rank holds whole (argus_tpu's `P()`): None."""
    return None


def param_shardings(named_params, mesh: Mesh,
                    rules: Sequence[Tuple[str, int, Optional[str]]] = DEFAULT_TP_RULES) -> Dict[str, Optional[Shard]]:
    """{name: Shard, or `replicated()`} for `named_params` (a dict or an
    iterable of (name, tensor), whole tensors): the TP rules where they
    match when the mesh has a model axis, replicated elsewhere."""
    params = dict(named_params)
    out: Dict[str, Optional[Shard]] = {k: replicated() for k in params}
    if mesh.n_model == 1:
        return out
    compiled = [(re.compile(p), dim, of) for p, dim, of in rules]
    for name, t in params.items():
        for pat, dim, of in compiled:
            if pat.match(name):
                blocks = 1 if of is None else t.shape[dim] // params[of].shape[0]
                if t.shape[dim] % (blocks * mesh.n_model):
                    raise ValueError(f"{name} {tuple(t.shape)} does not cut into {mesh.n_model} parts along {dim}")
                out[name] = Shard(dim, mesh.n_model, mesh.model_index, blocks)
                break
    return out
