"""Repeatable accuracy A/B of the PyTorch port: pretrain, branch into
fine-tune arms, report pose errors as a JSON artifact (the twin of
`scripts/convergence_ab.py`, on `argus_tpu_torch`; the same `ABConfig`,
arms, protocols and JSON schema as its `ACCURACY_r*.json`).

Protocols:
  * "shifted" (default): pretrain on one rendering distribution
    (`data.synthetic.PRETRAIN_STYLE`: textured noisy backgrounds, big
    jittered dots, occluders), fine-tune on a disjoint one
    (`FINETUNE_STYLE`: near-flat dark background, small clean dots), the
    synthetic analog of the reference's ImageNet-pretrain -> sim fine-tune;
  * "same": one distribution for both.

Errors are reported on the fine-tune distribution's held-out test split and
on 64 rows of its train split, per arm, over `arm_seeds` batch orders
(median, IQR and mean). `faces` renders per-face luminance patterns on the
cube (a rotation signal the photometric augmentation cannot erase); `sched`
runs the production fine-tune semantics: each epoch's validation loss on
the held-out split drives `train.ReduceLROnPlateau`.

Arms: exact BN full backprop; frozen BN; + frozen stem; frozen stages 1-3
("stageK"); "stemgradN" (the trained stem's gradient on 1/N of the
images); "keypoint" (the corner-heatmap family, its own pretrain, scored
through `fit_pose`) and "keypoint_frozen" (the same fine-tuned with frozen
BN + affine + stem from the same pretrain snapshot).

The splits live on the device (`resident`), batches are gathered there.
Pretrain snapshots and datasets are cached under `outputs/convergence_ab/`
keyed by protocol and size, so re-runs re-measure only the fine-tune arms;
results for arms already in `out` are merged, not re-run.

    python scripts/convergence_ab_torch.py --out ACCURACY_torch.json
    python scripts/convergence_ab_torch.py --protocol same --pretrain-epochs 90 ...
"""

import json
import os
import sys
import time
import zlib
from dataclasses import dataclass

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class ABConfig:
    """Accuracy A/B configuration.

    Fields:
        out: output JSON path.
        protocol: "shifted" (disjoint pretrain/fine-tune render styles) or
            "same" (one distribution for both).
        pretrain_epochs: pretrain length (exact train-mode BN from random init).
        finetune_epochs: length of each fine-tune arm.
        batch_size: minibatch size (the reference's default 32).
        n_pretrain: pretrain dataset size (shifted protocol; "same" reuses
            n_train).
        n_train: fine-tune dataset size.
        seed: dataset seed.
        n_eval: held-out test-split size of the fine-tune dataset.
        augment: the augmentation stack during pretrain and fine-tune.
        resolution: render resolution (256 = the reference crop).
        arm_seeds: fine-tune repeats per arm (distinct batch orders).
        arms: comma-separated fine-tune arms of this invocation; results
            merge into an existing `out` of the same dataset and protocol.
        faces: per-face luminance patterns on the cube.
        sched: per-epoch validation loss -> ReduceLROnPlateau.
        device: where training runs (the card unless "cpu").
    """

    out: str = "ACCURACY.json"
    protocol: str = "shifted"
    pretrain_epochs: int = 60
    finetune_epochs: int = 40
    batch_size: int = 32
    n_pretrain: int = 512
    n_train: int = 256
    seed: int = 5
    n_eval: int = 256
    augment: bool = True
    resolution: int = 256
    arm_seeds: int = 5
    arms: str = "exact,frozen,frozenstem,stage1,stage2,stage3,keypoint,keypoint_frozen"
    faces: bool = True
    sched: bool = True
    device: str = "cuda"


def run(cfg: ABConfig) -> dict:
    import torch

    from argus_tpu_torch import ROOT, resolve_device
    from argus_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from argus_tpu_torch.data import CameraCubePoseDataset, CameraCubePoseDatasetConfig
    from argus_tpu_torch.data.synthetic import (
        FINETUNE_STYLE,
        FINETUNE_STYLE_FACES,
        PRETRAIN_STYLE,
        PRETRAIN_STYLE_FACES,
        write_synthetic_dataset,
    )
    from argus_tpu_torch.geom import pose_errors, se3_exp
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.models.keypoint_net import CubeKeypointNetConfig, fit_pose, nominal_camera_matrices
    from argus_tpu_torch.train import (
        ReduceLROnPlateau,
        TrainConfig,
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    device = resolve_device(cfg.device)
    cache = os.path.join(ROOT, "outputs", "convergence_ab")
    B = cfg.batch_size
    shifted = cfg.protocol == "shifted"
    if cfg.protocol not in ("shifted", "same"):
        raise ValueError(f"protocol must be 'shifted' or 'same', not {cfg.protocol!r}")
    pre_style = PRETRAIN_STYLE_FACES if cfg.faces else PRETRAIN_STYLE
    ft_style = FINETUNE_STYLE_FACES if cfg.faces else FINETUNE_STYLE
    fc = "f" if cfg.faces else ""
    res = cfg.resolution

    def ensure_dataset(ds_dir, n_train, n_test, seed, style):
        if not os.path.exists(os.path.join(ds_dir, f"{os.path.basename(ds_dir)}.hdf5")):
            write_synthetic_dataset(ds_dir, n_train=n_train, n_test=n_test, height=res, width=res, seed=seed,
                                    pose_encoded="corners", style=style)
        return ds_dir

    if shifted:
        pre_dir = ensure_dataset(os.path.join(cache, f"corners_preA{fc}_n{cfg.n_pretrain}_s{cfg.seed}_r{res}"),
                                 cfg.n_pretrain, 8, cfg.seed, pre_style)
        # a different writer seed: pretrain and fine-tune share no pose and no nuisance draw
        ft_dir = ensure_dataset(
            os.path.join(cache, f"corners_ftB{fc}_n{cfg.n_train}_s{cfg.seed}_r{res}_e{cfg.n_eval}"),
            cfg.n_train, cfg.n_eval, cfg.seed + 1000, ft_style)
    else:
        ds_dir = os.path.join(cache, f"corners256{fc}_n{cfg.n_train}_s{cfg.seed}_r{res}")
        pre_dir = ft_dir = ensure_dataset(ds_dir, cfg.n_train, 64, cfg.seed, ft_style if cfg.faces else None)

    def resident(ds_dir, train):
        """The whole split on the device; batches are gathered there."""
        ds = CameraCubePoseDataset(CameraCubePoseDatasetConfig(ds_dir), train=train)
        idxs = list(range(len(ds)))
        imgs = np.ascontiguousarray(ds.load_images_batch(idxs))
        poses = np.asarray(ds.cube_poses[idxs], np.float32)
        return torch.from_numpy(imgs).to(device), torch.from_numpy(poses).to(device)

    pre_imgs, pre_poses = resident(pre_dir, train=True)
    ft_imgs, ft_poses = (pre_imgs, pre_poses) if pre_dir == ft_dir else resident(ft_dir, True)
    ev_imgs, ev_poses = resident(ft_dir, train=False)  # the held-out test split
    tr_imgs, tr_poses = ft_imgs[:64], ft_poses[:64]  # the fit-number probe

    def make(mode):
        if mode.startswith("keypoint"):
            # pretrain is always exact BN; "keypoint_frozen" fine-tunes with frozen BN (+ affine) and stem
            frozen = mode == "keypoint_frozen"
            tc = TrainConfig(
                model_type="keypoint",
                keypoint_config=CubeKeypointNetConfig(bn_frozen=frozen, bn_frozen_affine=frozen, stem_frozen=frozen),
                use_augmentation=cfg.augment, amp=True, wandb_log=False, learning_rate=1e-4, val_spaghetti=False,
            )
        else:
            frozen = mode != "exact"
            tc = TrainConfig(
                model_config=NCameraCNNConfig(
                    n_cams=2, backbone="resnet50", resnet_output_dim=1024,
                    bn_frozen=frozen, bn_frozen_affine=frozen,
                    stem_frozen=(mode == "frozenstem"),
                    stem_grad_stride=int(mode[8:]) if mode.startswith("stemgrad") else 1,
                    frozen_stages=int(mode[5:]) if mode.startswith("stage") else 0,
                ),
                use_augmentation=cfg.augment, amp=True, wandb_log=False, learning_rate=1e-4, val_spaghetti=False,
            )
        model, state = create_train_state(tc, seed=0, sample_hw=(res, res), device=device)
        # the eval step drives the plateau scheduler (val_spaghetti off: a clean loss)
        ev = make_eval_step(model, tc, base_seed=0, hw=(res, res), device=device) if cfg.sched else None
        return tc, model, state, make_train_step(model, tc, base_seed=0, hw=(res, res), device=device), ev

    cam_P = nominal_camera_matrices(res, res).to(device)

    def make_errs(model, keypoint=False):
        @torch.no_grad()
        def predict(images):
            out = model(images.float() / 255.0, train=False)
            return fit_pose(cam_P, out[0]) if keypoint else se3_exp(out)

        def errs():
            out = {}
            for tag, imgs, poses in (("", ev_imgs, ev_poses), ("train_", tr_imgs, tr_poses)):
                rot, tr = pose_errors(predict(imgs), poses)
                out[f"{tag}rot_deg"] = round(float(rot.mean()), 2)
                out[f"{tag}trans_cm"] = round(float(tr.mean()) * 100, 2)
            return out

        return errs

    def fresh_optimizer(state):
        """A fine-tune's start: step 0 and zero Adam moments, in place."""
        state.step = 0
        with torch.no_grad():
            state.opt_state.count.zero_()
            for t in (*state.opt_state.mu.values(), *state.opt_state.nu.values()):
                t.zero_()

    def train_epochs(state, step, n, tag, d_imgs, d_poses, eval_step=None):
        # crc32, not hash(): str hash is salted per process, and batch orders must
        # repeat across invocations (merge mode re-runs single arms)
        rng = np.random.default_rng(zlib.crc32(tag.encode()))
        t0 = time.perf_counter()
        loss = None
        mask = torch.ones(B, device=device)
        n_ex = int(d_imgs.shape[0])
        scheduler = ReduceLROnPlateau(patience=5, factor=0.5) if eval_step else None
        ev_mask = torch.ones(int(ev_imgs.shape[0]), device=device) if eval_step else None
        for _ in range(n):
            order = rng.permutation(n_ex)
            for s0 in range(0, n_ex - B + 1, B):
                sel = torch.from_numpy(order[s0:s0 + B]).to(device)
                batch = {"images": d_imgs.index_select(0, sel), "cube_pose": d_poses.index_select(0, sel),
                         "mask": mask}
                state, loss = step(state, batch)
            if scheduler is not None:
                lsum, cnt = eval_step(state, {"images": ev_imgs, "cube_pose": ev_poses, "mask": ev_mask})
                lr = float(state.lr)
                new_lr = scheduler.step(float(lsum) / float(cnt), lr)
                if new_lr != lr:
                    state.lr.fill_(new_lr)
        lr_note = f", final lr {float(state.lr):.2e}" if scheduler else ""
        print(f"  [{tag}] {n} epochs in {time.perf_counter() - t0:.0f}s, final loss {float(loss):.5f}{lr_note}",
              flush=True)
        return state

    result = {
        "protocol_name": cfg.protocol,
        "dataset": {
            "kind": "synthetic-corners" + ("-faces" if cfg.faces else ""),
            "faces": cfg.faces,
            "shift": (
                {"pretrain_style": "PRETRAIN_STYLE" + ("_FACES" if cfg.faces else ""),
                 "finetune_style": "FINETUNE_STYLE" + ("_FACES" if cfg.faces else ""),
                 "n_pretrain": cfg.n_pretrain}
                if shifted else None
            ),
            "n_train": cfg.n_train, "resolution": res, "seed": cfg.seed,
            "eval": "held-out test split of the fine-tune distribution",
        },
        "protocol": {"pretrain_epochs": cfg.pretrain_epochs,
                     "finetune_epochs": cfg.finetune_epochs,
                     "batch_size": B, "backbone": "resnet50", "lr": 1e-4,
                     "augment": cfg.augment, "n_eval": cfg.n_eval,
                     "scheduler": (
                         {"kind": "ReduceLROnPlateau", "patience": 5, "factor": 0.5, "val_cadence_epochs": 1}
                         if cfg.sched else None
                     ),
                     "arm_seeds": cfg.arm_seeds},
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "phases": {},
    }
    # merge mode: keep the arms already measured when re-running a subset
    if os.path.exists(cfg.out):
        with open(cfg.out) as f:
            prior = json.load(f)
        if prior.get("dataset") == result["dataset"] and prior.get("protocol") == result["protocol"]:
            result["phases"] = prior.get("phases", {})
            print(f"merging into existing {cfg.out} ({len(result['phases'])} phases)", flush=True)

    arms = [a.strip() for a in cfg.arms.split(",") if a.strip()]
    cache_tag = (f"{cfg.protocol}_{cfg.pretrain_epochs}_n{cfg.n_pretrain if shifted else cfg.n_train}"
                 f"_s{cfg.seed}_r{res}{'_aug' if cfg.augment else ''}{'_faces' if cfg.faces else ''}")

    # 1. pretrain with exact BN (the snapshot is the A/B's input, cached; constant lr)
    pre_ckpt = os.path.join(cache, f"corners_pretrain_{cache_tag}.ckpt")
    _, model_e, state_e, step_e, _ = make("exact")
    if os.path.exists(pre_ckpt):
        load_checkpoint(pre_ckpt, target=state_e)
        print(f"[pretrain] loaded cached snapshot {pre_ckpt}", flush=True)
    else:
        state_e = train_epochs(state_e, step_e, cfg.pretrain_epochs, "pretrain-exact", pre_imgs, pre_poses)
        save_checkpoint(pre_ckpt, state_e)
    result["phases"]["pretrain_exact"] = make_errs(model_e)()
    print(f"[pretrain] {result['phases']['pretrain_exact']}", flush=True)
    del model_e, state_e, step_e

    # 2. fine-tunes branch from the same snapshot, each run restoring it into
    #    the arm's own model with a fresh optimizer. The keypoint family has
    #    its own architecture, so its own cached pretrain under the same shift.
    for mode in arms:
        tc_m, model_m, state_m, step_m, ev_m = make(mode)
        errs_m = make_errs(model_m, keypoint=mode.startswith("keypoint"))
        snap_ckpt = pre_ckpt
        if mode.startswith("keypoint"):
            snap_ckpt = os.path.join(cache, f"corners_pretrain_kp_{cache_tag}.ckpt")
            if os.path.exists(snap_ckpt):
                print(f"[keypoint] loaded cached snapshot {snap_ckpt}", flush=True)
            else:
                if mode == "keypoint":
                    state_k, step_k = state_m, step_m
                else:
                    _, _, state_k, step_k, _ = make("keypoint")
                state_k = train_epochs(state_k, step_k, cfg.pretrain_epochs, "pretrain-keypoint", pre_imgs,
                                       pre_poses)
                save_checkpoint(snap_ckpt, state_k)
                del state_k, step_k
            # frozen and exact keypoint configs hold the same tensors: the snapshot loads into either
            load_checkpoint(snap_ckpt, target=state_m)
            result["phases"]["pretrain_keypoint"] = errs_m()
            print(f"[pretrain-keypoint] {result['phases']['pretrain_keypoint']}", flush=True)
        runs = []
        for s in range(cfg.arm_seeds):
            load_checkpoint(snap_ckpt, target=state_m)
            fresh_optimizer(state_m)
            train_epochs(state_m, step_m, cfg.finetune_epochs, f"finetune-{mode}-s{s}", ft_imgs, ft_poses,
                         eval_step=ev_m)
            run_ = errs_m()
            if cfg.sched:
                run_["final_lr"] = float(f"{float(state_m.lr):.3g}")
            runs.append(run_)

        def stats(key):
            v = np.array([r[key] for r in runs], np.float64)
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            return {"median": round(float(med), 2), "iqr": [round(float(q1), 2), round(float(q3), 2)],
                    "mean": round(float(np.mean(v)), 2)}

        summary = {
            "rot_deg": stats("rot_deg"),
            "trans_cm": stats("trans_cm"),
            "train_rot_deg": stats("train_rot_deg"),
            "train_trans_cm": stats("train_trans_cm"),
            # the mean keys of the round-4 artifacts' readers
            "rot_deg_mean": round(float(np.mean([r["rot_deg"] for r in runs])), 2),
            "trans_cm_mean": round(float(np.mean([r["trans_cm"] for r in runs])), 2),
            "runs": runs,
        }
        result["phases"][f"finetune_{mode}"] = summary
        print(f"[finetune-{mode}] {summary}", flush=True)
        del tc_m, model_m, state_m, step_m, ev_m

        with open(cfg.out, "w") as f:  # the artifact after every arm
            json.dump(result, f, indent=2)
            f.write("\n")

    with open(cfg.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"wrote {cfg.out}", flush=True)
    return result


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    run(cli(ABConfig))
