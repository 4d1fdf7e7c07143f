"""argus_tpu's training loop under `multigpu` (`train.train`) on two gloo
processes on the CPU, against the same loop in one process.

An in-memory dataset of 10 noise frame pairs at 32x32 (noise: exact BN on
flat frames divides by a near-zero variance) and 4 validation pairs,
global batch 4, so each epoch's last batch is padded (two real rows, both
on rank 0); ResNet-18 NCameraCNN (output dim 16), frozen BN, augmentation
on, one epoch. Both ranks return the same checkpoint path; the file rank 0
wrote holds the state of the one-process run after 3 steps within
tests/test_torch_train.py's f32 tolerances for a second step (the same
rows, the same augmentation draws, the sums in another order; rank 1's
share of each last batch is padding alone), on the host feed and on the resident
path (every rank holding the split, one permutation). A SIGTERM seen by
rank 1 alone stops a 2-epoch run on both ranks at the first epoch's end
(the ranks agree on it), and rank 0's file holds that step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from argus_tpu_torch.parallel.launch import run_ranks

HW, N_TRAIN, N_VAL, B = 32, 10, 4, 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process while the module runs (the suite's
    workers share the machine's cores with this file's rank processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Frames:
    """The dataset interface `HostDataLoader` and the resident path read."""

    n_cams = 2

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, HW, HW, 6), dtype=np.uint8)
        angle = rng.uniform(0.1, 1.0, n)
        self.cube_poses = np.zeros((n, 7), np.float32)
        self.cube_poses[:, :3] = rng.normal(0, 0.3, (n, 3))
        self.cube_poses[:, 5], self.cube_poses[:, 6] = np.sin(angle / 2), np.cos(angle / 2)

    def __len__(self):
        return len(self.cube_poses)

    def __getitem__(self, idx):
        return {"images": self.images[idx], "cube_pose": self.cube_poses[idx]}

    def _out_hw(self):
        return (HW, HW)

    def load_images_batch(self, idxs, n_threads=1, pool=None):
        return self.images[list(idxs)]


def _cfg(save_dir: str, resident: bool, multigpu: bool):
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    return TrainConfig(model_config=NCameraCNNConfig(backbone="resnet18", resnet_output_dim=16, bn_frozen=True,
                                                     bn_frozen_affine=True),
                       batch_size=B, n_epochs=1, learning_rate=1e-4, wandb_log=False, num_workers=1,
                       save_dir=save_dir, async_checkpoint=False, multigpu=multigpu,
                       device_resident_mb=2048.0 if resident else 0.0)


def _datasets():
    return _Frames(N_TRAIN, 0), _Frames(N_VAL, 1)


def _rank(rank: int, n: int, save_dir: str) -> dict:
    from argus_tpu_torch import preemption
    from argus_tpu_torch.train import train

    out = {label: train(_cfg(f"{save_dir}/{label}", label == "resident", True), device="cpu", datasets=_datasets())
           for label in ("host feed", "resident")}
    preemption.PreemptionGuard.requested = property(lambda self: rank == 1)  # rank 1 alone sees the signal
    cfg = dataclasses.replace(_cfg(f"{save_dir}/preempted", False, True), n_epochs=2)
    out["preempted"] = train(cfg, device="cpu", datasets=_datasets())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("dp_loop"))
    return run_ranks(_rank, 2, save_dir, timeout=300)


def _state(path: str):
    from argus_tpu_torch.checkpoint import load_checkpoint
    from argus_tpu_torch.train import create_train_state

    model, state = create_train_state(_cfg("", False, False), seed=5, device="cpu")
    load_checkpoint(path, target=state)
    return model, state


@pytest.mark.parametrize("label", ["host feed", "resident"])
def test_multigpu_train_matches_one_process(ranks, label, tmp_path):
    from argus_tpu_torch.train import create_train_state, train
    from test_torch_train import TOL, _check_leaves

    assert ranks[0][label] == ranks[1][label]
    cfg = _cfg(str(tmp_path), label == "resident", False)
    _, got = _state(ranks[0][label])
    _, want = _state(train(cfg, device="cpu", datasets=_datasets()))
    _, p0 = create_train_state(cfg, seed=cfg.random_seed, device="cpu")
    assert got.step == want.step == -(-N_TRAIN // B)
    tol = TOL[False]
    _check_leaves(got.opt_state.mu, want.opt_state.mu, tol["moments"][1], "mu")
    _check_leaves(got.params, want.params, tol["update"][1], "update", p0.params)


def test_preemption_seen_by_one_rank_stops_both(ranks):
    assert ranks[0]["preempted"] == ranks[1]["preempted"]
    _, state = _state(ranks[0]["preempted"])
    assert state.step == -(-N_TRAIN // B)  # both ranks stopped after the first epoch, agreed
