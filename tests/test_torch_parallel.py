"""The port's process layout (argus_tpu_torch.parallel) against argus_tpu's
mesh, without starting processes: the (data, model) grid's coordinates,
the TP rules' sharded leaves against argus_tpu's `param_shardings` through
the weight bridge's names, `init_distributed` without a rendezvous, and
each rank's rows of the host loader and of the resident epoch against
argus_tpu's `HostDataLoader` index arithmetic and `global_batch`'s row
order (1 node x 2 ranks and 2 nodes x 1 rank)."""

import numpy as np
import pytest
import torch

from argus_tpu_torch.data.dataset import HostDataLoader
from argus_tpu_torch.parallel import DEFAULT_TP_RULES, Mesh, Shard, init_distributed, make_mesh, param_shardings
from argus_tpu_torch.train import epoch_batches

N_EX, B = 11, 4  # an epoch of 11 examples in global batches of 4: the last batch padded


class _Indices:
    """A dataset whose example i is the frame filled with i (and pose row i),
    recording which indices were decoded."""

    n_cams = 1

    def __init__(self, n=N_EX):
        self.cube_poses = np.arange(n, dtype=np.float32)[:, None].repeat(7, 1)
        self.decoded = []

    def __len__(self):
        return len(self.cube_poses)

    def load_images_batch(self, idxs, n_threads=1, pool=None):
        self.decoded.extend(idxs)
        return np.stack([np.full((2, 2, 3), i, np.uint8) for i in idxs])


@pytest.mark.parametrize("n_data,n_model,lws", [(2, 1, 2), (2, 2, 4), (1, 2, 2), (4, 2, 2)])
def test_grid_coordinates(n_data, n_model, lws):
    """Rank d * n_model + m holds data index d and model index m (model over
    adjacent ranks, `make_mesh`); nodes are runs of `lws` ranks; each data
    index's rows are its contiguous block of the global batch, and within
    a node its block of the node's host batch."""
    world = n_data * n_model
    seen = set()
    for rank in range(world):
        mesh = Mesh(n_data, n_model, rank, lws)
        d, m = mesh.data_index, mesh.model_index
        assert rank == d * n_model + m and mesh.shape == {"data": n_data, "model": n_model}
        assert mesh.node_index == rank // lws and mesh.n_nodes == world // lws
        rows = mesh.local_rows(8 * n_data)
        assert (rows.start, rows.stop) == (8 * d, 8 * d + 8)
        node = mesh.node_rows(8 * n_data // mesh.n_nodes)
        assert node.start + mesh.node_index * (8 * n_data // mesh.n_nodes) == rows.start
        seen.add((d, m))
    assert len(seen) == world
    if n_data > 1:
        with pytest.raises(ValueError, match="divide"):
            Mesh(n_data, n_model, 0, lws).local_rows(8 * n_data + 1)


def test_single_process_mesh_and_init_without_rendezvous(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.rank, mesh.data_group, mesh.model_group) == (1, 1, 0, None, None)
    with pytest.raises(ValueError, match="does not divide the group's 1 ranks"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_data=2)


def test_tp_rules_shard_argus_tpus_leaves():
    """`param_shardings` marks exactly the leaves argus_tpu's rules shard on a
    model axis of 2 (mapped through the weight bridge's names), along the
    same axis of the transposed kernel, and nothing without a model axis."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from argus_tpu.models import NCameraCNN as JaxNCameraCNN
    from argus_tpu.models import NCameraCNNConfig as JaxConfig
    from argus_tpu.parallel import make_mesh as jax_make_mesh
    from argus_tpu.parallel import param_shardings as jax_param_shardings
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.models.jax_import import _param_entry
    from argus_tpu_torch.train import TrainConfig, create_train_state

    kw = dict(n_cams=2, backbone="resnet18", resnet_output_dim=16)
    variables = JaxNCameraCNN(JaxConfig(**kw)).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 6)), train=False)
    specs = jax_param_shardings(variables["params"], jax_make_mesh(n_data=4, n_model=2))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        if spec.spec != P():
            keys = tuple(str(getattr(p, "key", p)) for p in path)
            name, _ = _param_entry(keys, np.zeros((1, 1) if keys[-1] == "kernel" else (1,)))
            axis = list(spec.spec).index("model")
            want[name] = axis if keys[-1] != "kernel" else 1 - axis  # torch's (out, in) is flax's (in, out)
    assert set(want) == {"backbone.fc.weight", "backbone.fc.bias", "head_fc1.weight"}

    model, _ = create_train_state(TrainConfig(model_config=NCameraCNNConfig(**kw)), device="cpu")
    got = param_shardings(model.named_parameters(), Mesh(1, 2, 1, 2))
    assert {k: s.dim for k, s in got.items() if s is not None} == want
    assert got["head_fc1.weight"] == Shard(dim=1, parts=2, index=1, blocks=2)  # each camera's block of columns
    assert all(s is None for s in param_shardings(model.named_parameters(), Mesh(2, 1, 0, 2)).values())
    assert len(DEFAULT_TP_RULES) == 3


def test_shard_take_place_round_trip():
    """A leaf cut by `Shard.take` over k ranks and placed back
    (`Shard.place`, summed over the ranks) is the leaf; head_fc1's slice m
    is camera c's columns [c D + m D / k, c D + (m + 1) D / k)."""
    w = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    for dim, blocks in ((0, 1), (1, 1), (1, 2)):
        parts = [Shard(dim, 2, m, blocks) for m in range(2)]
        assert torch.equal(sum(p.place(p.take(w)) for p in parts), w)
    cut = Shard(1, 2, 1, 2).take(w)  # D = 4 a camera: rank 1 holds columns 2-3 and 6-7
    assert torch.equal(cut, w[:, [2, 3, 6, 7]])


def _jax_global_batches(nodes, epoch):
    """argus_tpu's global batches: each host's `HostDataLoader` batch (its
    index arithmetic), stitched in process order as `global_batch` does."""
    from argus_tpu.data.dataset import HostDataLoader as JaxHostDataLoader

    loaders = [JaxHostDataLoader(_Indices(), batch_size=B // nodes, shuffle=True, seed=7, num_workers=1,
                                 process_index=p, process_count=nodes) for p in range(nodes)]
    for ld in loaders:
        ld.set_epoch(epoch)
    per_host = [list(ld) for ld in loaders]
    return [{k: np.concatenate([h[i][k] for h in per_host]) for k in ("images", "cube_pose", "mask")}
            for i in range(len(per_host[0]))]


@pytest.mark.parametrize("nodes,lws", [(1, 2), (2, 1)], ids=["1node-2ranks", "2nodes-1rank"])
def test_loader_rows_match_argus_tpus_global_batch(nodes, lws):
    """Each rank's loader (its node's batch, `rows` its share) yields its
    rows of argus_tpu's global batch, padding and mask included, and decodes
    only its rows (and the batch's first row where its padding repeats it)."""
    want = _jax_global_batches(nodes, epoch=1)
    got, decoded = [], []
    for rank in range(2):
        mesh = Mesh(2, 1, rank, lws)
        ds = _Indices()
        ld = HostDataLoader(ds, batch_size=B // mesh.n_nodes, shuffle=True, seed=7, num_workers=1,
                            process_index=mesh.node_index, process_count=mesh.n_nodes,
                            rows=mesh.node_rows(B // mesh.n_nodes))
        ld.set_epoch(1)
        got.append(list(ld))
        decoded.append(ds.decoded)
    assert len(got[0]) == len(got[1]) == len(want)
    for i, w in enumerate(want):
        for k in ("images", "cube_pose", "mask"):
            assert np.array_equal(np.concatenate([got[0][i][k], got[1][i][k]]), w[k]), (i, k)
    if nodes == 1:  # the last batch's padding falls unevenly on the ranks (across hosts argus_tpu wraps)
        assert float(got[0][-1]["mask"].sum()) != float(got[1][-1]["mask"].sum())
    for rank in range(2):  # a rank decodes only what it yields, each of its batch rows at most once
        yielded = {int(v) for b in got[rank] for v in b["images"][:, 0, 0, 0]}
        assert set(decoded[rank]) == yielded and len(decoded[rank]) <= sum(len(b["mask"]) for b in got[rank])


def test_global_batch_row_order_and_resident_rows():
    """argus_tpu's `global_batch` on a 2-device data axis puts rows
    [d b, (d + 1) b) on device d, which is `Mesh.local_rows`; the resident
    epoch's rows of each rank (`train.epoch_batches`) are its block of the
    padded, masked batches argus_tpu's epoch program gathers."""
    import jax

    from argus_tpu.parallel import global_batch
    from argus_tpu.parallel import make_mesh as jax_make_mesh

    host = {"x": np.arange(8, dtype=np.float32)}
    arr = global_batch(jax_make_mesh(n_data=2, devices=jax.devices()[:2]), host)["x"]
    for shard in arr.addressable_shards:
        d = jax.devices().index(shard.device)
        rows = Mesh(2, 1, d, 2).local_rows(8)
        assert np.array_equal(np.asarray(shard.data), host["x"][rows])

    perm = torch.randperm(N_EX, generator=torch.Generator().manual_seed(0))
    k = -(-N_EX // B)
    padded = np.concatenate([perm.numpy(), perm.numpy()[:k * B - N_EX]])  # argus_tpu's padding
    mask = (np.arange(k * B) < N_EX).astype(np.float32)
    whole_idx, whole_mask = epoch_batches(perm, B)
    assert np.array_equal(whole_idx.numpy(), padded.reshape(k, B))
    assert np.array_equal(whole_mask.numpy(), mask.reshape(k, B))
    parts = [epoch_batches(perm, B, Mesh(2, 1, r, 2).local_rows(B)) for r in range(2)]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), whole_idx)
    assert torch.equal(torch.cat([p[1] for p in parts], 1), whole_mask)
    assert parts[0][1].sum() != parts[1][1].sum()  # the padded tail is one rank's


def test_init_distributed_from_torchrun_environment(monkeypatch):
    """`torchrun`'s variables (here a world of one) join a group through
    env://, on gloo for the CPU, and give the node sense of argus_tpu's
    (process_index, process_count); a second call reuses the group."""
    from argus_tpu_torch.parallel.launch import free_port

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1", GROUP_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert init_distributed(device="cpu", timeout=60) == (0, 1)
        assert torch.distributed.is_initialized() and torch.distributed.get_backend() == "gloo"
        assert init_distributed(device="cpu") == (0, 1)
        mesh = make_mesh(reduce_alone=True)
        assert mesh.data_group is not None and mesh.model_group is None
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("lws,nodes", [("2", 2), ("4", 1), (None, None)])
def test_mesh_nodes_of_a_group_made_by_torch(monkeypatch, lws, nodes):
    """A group made by torch's own `init_process_group` (torch's fake
    backend here: 4 ranks, this one rank 1, no collective runs) takes its
    ranks per node from torchrun's LOCAL_WORLD_SIZE, in `make_mesh` and in
    `init_distributed`'s reuse of the group; without that variable both
    raise rather than count every rank a node of its own."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if lws is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", lws)
    dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
    try:
        if nodes is None:
            with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
                make_mesh()
            with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
                init_distributed()
            return
        mesh = make_mesh()
        assert (mesh.n_data, mesh.n_nodes, mesh.node_index, mesh.local_world_size) == (4, nodes, 0, 4 // nodes)
        assert init_distributed() == (0, nodes)
        tp = make_mesh(n_model=2)  # model groups within a node of 2 or 4
        assert (tp.n_data, tp.n_model, tp.data_index, tp.model_index, tp.n_nodes) == (2, 2, 0, 1, nodes)
    finally:
        dist.destroy_process_group()


def test_step_body_sets_its_own_mesh_groups(monkeypatch):
    """Each `TrainStepBody` sets every BatchNorm's group from its own mesh
    (torch's fake backend, 2 ranks): a later body without a mesh clears the
    data group an earlier body set, and a model cut over a model group
    refuses a body without its mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops.norm import BatchNorm
    from argus_tpu_torch.parallel.tp import shard_state
    from argus_tpu_torch.train import TrainConfig, TrainStepBody, create_train_state

    cfg = TrainConfig(model_config=NCameraCNNConfig(n_cams=2, backbone="resnet18", resnet_output_dim=16),
                      use_augmentation=False, batch_size=8)
    model, state = create_train_state(cfg, device="cpu")
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = make_mesh()
        TrainStepBody(model, cfg, device="cpu", mesh=mesh)
        assert bns and all(m.group is mesh.data_group is not None for m in bns)
        TrainStepBody(model, cfg, device="cpu")
        assert all(m.group is None for m in bns)
        shard_state(model, state, make_mesh(n_model=2))
        with pytest.raises(ValueError, match="needs that mesh"):
            TrainStepBody(model, cfg, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("M,C,ok", [(32768, 64, True), (4096, 64, False), (16, 2048, False)])
def test_strided_kernel_rows_over_ranks(M, C, ok):
    """The kernel engine's row blocks at stride 2 (`bn_reduce`'s visited
    rows, from the flattened rows) over 2 ranks of M rows: where the ranks'
    blocks are the global batch's, `check_rank_rows` passes (the rows agree
    row by row); elsewhere it raises, since each rank's subsample would
    differ from the global one argus_tpu takes."""
    from argus_tpu_torch.ops.kernels.bn_reduce import _rows
    from argus_tpu_torch.ops.norm import check_rank_rows

    rows = torch.arange(2 * M, dtype=torch.float32)[:, None].expand(2 * M, C)
    glob = _rows(rows, 2)[:, 0]
    per_rank = torch.cat([_rows(rows[r * M:(r + 1) * M], 2)[:, 0] for r in range(2)])
    assert torch.equal(glob, per_rank) == ok
    if ok:
        check_rank_rows(M, C, 2, 2)
    else:
        with pytest.raises(ValueError, match="not the global batch's"):
            check_rank_rows(M, C, 2, 2)
