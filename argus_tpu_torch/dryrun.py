"""The multi-process dry-run of the port's parallel training, the twin of
argus_tpu's `dryrun_multichip` (`__graft_entry__.py:74-284`): n ranks, one
process each, on gloo on the CPU, at its tiny shapes, one phase after
another, each printing a `dryrun_multichip OK: ...` line:

1. the (data, model) grid with a model axis of 2 where n is even: one
   augmented train step of a ResNet-18 NCameraCNN at 64x64 (exact BN over
   the data group, the wide dense layers cut over the model group);
2. pure data parallelism with the flagship family (ResNet-50, frozen BN and
   affine, frozen stem, `frozen_stages=3`, augmentation on) at 16x16:
   the bucketed gradient all-reduce;
3. the fused backbone at `frozen_stages=0` (every fuse flag "on"; on the
   CPU their plain versions run) under the same all-reduce;
4. the resident whole-epoch program: the split on every rank, one
   permutation, each rank's rows of each batch, 3n examples in batches of
   2n, the second one padded.

Each phase checks finite losses and parameters equal on every rank.

    python -m argus_tpu_torch.dryrun [n]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

IDENTITY_POSE = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)


def _batch(rng, rows: int, hw: tuple) -> dict:
    return {"images": rng.integers(0, 256, (rows, *hw, 6), dtype=np.uint8),
            "cube_pose": np.tile(IDENTITY_POSE, (rows, 1)), "mask": np.ones((rows,), np.float32)}


def _params_agree(state, mesh) -> bool:
    """Every parameter bit-equal on every rank (a cut leaf on the ranks of
    its model index)."""
    from argus_tpu_torch.parallel.collectives import all_reduce_

    ok = True
    for name, t in state.params.items():
        group = mesh.data_group if name in state.shardings else mesh.world_group
        lo, hi = t.detach().clone(), t.detach().clone()
        all_reduce_(lo, group, torch.distributed.ReduceOp.MIN)
        all_reduce_(hi, group, torch.distributed.ReduceOp.MAX)
        ok &= bool(torch.equal(lo, hi))
    return ok


def _phases(rank: int, n: int) -> list:
    """The four phases on this rank; rank 0's lines, [] on the others."""
    from argus_tpu_torch.data.resident import DeviceResidentData
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.ops.augment import AugmentationConfig
    from argus_tpu_torch.parallel import make_mesh
    from argus_tpu_torch.train import TrainConfig, create_train_state, make_resident_epoch_step, make_train_step

    lines = []
    rng = np.random.default_rng(0)
    aug = AugmentationConfig(num_spaghetti=2, pallas_blur=True)

    # 1: the grid, TP on the model axis where n is even
    n_model = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_model=n_model)
    hw = (64, 64)
    cfg = TrainConfig(model_config=NCameraCNNConfig(n_cams=2, backbone="resnet18", resnet_output_dim=64),
                      augmentation_config=aug, use_augmentation=True, batch_size=2 * mesh.n_data,
                      num_model_shards=n_model, wandb_log=False)
    model, state = create_train_state(cfg, seed=0, device="cpu", mesh=mesh)
    batch = {k: v[mesh.local_rows(cfg.batch_size)] for k, v in _batch(rng, cfg.batch_size, hw).items()}
    state, loss = make_train_step(model, cfg, base_seed=0, mesh=mesh, hw=hw, device="cpu")(state, batch)
    if not (torch.isfinite(loss) and _params_agree(state, mesh)):
        raise AssertionError(f"dryrun phase 1: loss {loss}, or the ranks' parameters differ")
    lines.append(f"dryrun_multichip OK: mesh=data{mesh.n_data}xmodel{mesh.n_model}, batch={cfg.batch_size}, "
                 f"cut leaves {sorted(state.shardings)}, loss={float(loss):.4f}")

    # 2: pure DP, the flagship family at frozen BN
    hw = (16, 16)
    mesh = make_mesh(n_data=n)
    flagship = NCameraCNNConfig(n_cams=2, backbone="resnet50", resnet_output_dim=64, bn_frozen=True,
                                bn_frozen_affine=True, stem_frozen=True, frozen_stages=3)
    cfg = TrainConfig(model_config=flagship, augmentation_config=aug, use_augmentation=True, batch_size=2 * n,
                      wandb_log=False)
    batch = {k: v[mesh.local_rows(2 * n)] for k, v in _batch(rng, 2 * n, hw).items()}
    model, state = create_train_state(cfg, seed=1, device="cpu", mesh=mesh)
    state, loss = make_train_step(model, cfg, base_seed=0, mesh=mesh, hw=hw, device="cpu")(state, batch)
    if not (torch.isfinite(loss) and _params_agree(state, mesh)):
        raise AssertionError(f"dryrun phase 2: loss {loss}, or the ranks' parameters differ")
    lines.append(f"dryrun_multichip OK: bucketed all-reduce DP mesh=data{n}, frozen-BN, loss={float(loss):.4f}")

    # 3: the fused backbone at frozen_stages=0
    fused = dataclasses.replace(flagship, frozen_stages=0, fuse_block="on", fuse_proj="on", fuse_stem="on",
                                fuse_stage="on")
    cfg = dataclasses.replace(cfg, model_config=fused)
    model, state = create_train_state(cfg, seed=2, device="cpu", mesh=mesh)
    state, loss = make_train_step(model, cfg, base_seed=0, mesh=mesh, hw=hw, device="cpu")(state, batch)
    if not (torch.isfinite(loss) and _params_agree(state, mesh)):
        raise AssertionError(f"dryrun phase 3: loss {loss}, or the ranks' parameters differ")
    lines.append(f"dryrun_multichip OK: bucketed all-reduce DP mesh=data{n}, FUSED backbone "
                 f"(block+proj+stem+stage on), loss={float(loss):.4f}")

    # 4: the resident whole-epoch program
    n_ex = 3 * n
    model, state = create_train_state(cfg, seed=3, device="cpu", mesh=mesh)
    epoch_step, k = make_resident_epoch_step(model, cfg, 0, n_ex, hw=hw, device="cpu", mesh=mesh)
    res = DeviceResidentData(torch.from_numpy(rng.integers(0, 256, (n_ex, *hw, 6), dtype=np.uint8)),
                             torch.from_numpy(np.tile(IDENTITY_POSE, (n_ex, 1))))
    state, losses = epoch_step(state, res.images, res.poses, 0)
    if not (losses.shape == (k,) and bool(torch.isfinite(losses).all()) and _params_agree(state, mesh)):
        raise AssertionError(f"dryrun phase 4: losses {losses}, or the ranks' parameters differ")
    lines.append(f"dryrun_multichip OK: RESIDENT whole-epoch mesh=data{n}, {k} batches/epoch (padded tail), "
                 f"losses={[round(float(v), 4) for v in losses]}")
    return lines if rank == 0 else []


def dryrun_multichip(n_devices: int, timeout: float = 900.0) -> None:
    """The four phases on `n_devices` gloo ranks on the CPU; prints rank
    0's OK lines. Raises when a rank fails or the run outlasts `timeout`."""
    from argus_tpu_torch.parallel.launch import run_ranks

    for line in run_ranks(_phases, n_devices, timeout=timeout)[0]:
        print(line, flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
