"""One train step of the port against argus_tpu's in the configurations of
the trained stem and of exact BatchNorm, on the CPU.

Each case runs one step of the port's `make_train_step` (`device="cpu"`,
the kernels' plain versions) and one of argus_tpu's `make_train_step_body`
from one state, without augmentation, and compares the loss, the Adam
moments (the clipped gradients), the params' update and the updated
`batch_stats`, leaf by leaf as tests/test_torch_train.py does (relative
2-norm errors, max over leaves and median; the params and the running
statistics through their change from the initial state):

- the flagship step with the fused stem trained (frozen BN + affine,
  `stem_frozen=False`): f32 and bf16, and bf16 with `stem_grad_stride=2`
  (the stem's dW from the first half of the images, scaled by 2);
- exact BN at argus_tpu's defaults (`bn_frozen=False`, the stem trained
  unfused): `bn_impl="pallas"` (the reduction kernels; argus_tpu's in
  interpret mode) and `"xla"` (autodiff through the statistics), f32;
- BN with running statistics and a trainable affine (`bn_frozen` without
  `bn_frozen_affine`), f32;
- the keypoint family at argus_tpu's default config (exact BN, resnet18,
  head_features 32), f32.

argus_tpu's fused ops ("on" in the stem cases) run through their XLA route,
the math argus_tpu's own tests hold each Pallas kernel against; the port's
plain versions are held against the interpret-mode Pallas kernels by
tests/test_torch_kernels.py and, for the trained stem's saving forward and
weight gradient at both strides, tests/test_torch_bn.py. Two cases run
argus_tpu's Pallas kernels in interpret mode: exact-pallas its BN
reductions (`bn_impl="pallas"`), and stem-grad2-bf16 its fused ops
(`INTERPRET`), so that one whole step trains the stem through
`_stem_fwd_save_pallas` and `_stem_bwd_pallas`.

ResNet-50 at 32x32, two rows of which one is masked; BN buffers and scales
randomised, non-identity targets. Tolerances: tests/test_torch_train.py's
TOL after one step (f32: the same sums in another order flip a relu mask
where a value sits within rounding of zero, and Adam's first step is close
to lr * sign(g) for a gradient that is all but zero; bf16: a rounding of an
f32 sum taken in another order lands one ulp apart and the ulps accumulate
through the layers), and TOL_EXACT for exact BN (below). The running
statistics are held to 1e-3 (f32) and 3e-2 (bf16) in their change: each is
an f32 sum over an activation that the two sides compute in another order.
Exact BN is compared in f32 only: at two rows (four camera images, one
masked) the two packages' bf16 gradients through 53 batch-coupled BN
backwards sat O(1) apart (1.5 at the worst leaf, median 1.2, with the loss
within 5e-3), so bf16 is held at the BN module (tests/test_torch_bn.py)
and on the card at batch 8 rows (chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.models import NCameraCNN as JaxNCameraCNN
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.models import keypoint_net as jkp
from argus_tpu.train import TrainConfig as JaxTrainConfig
from argus_tpu.train import TrainState as JaxTrainState
from argus_tpu.train import make_optimizer as jax_make_optimizer
from argus_tpu.train import make_train_step_body
from argus_tpu_torch.models import CubeKeypointNetConfig, NCameraCNNConfig
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.train import TrainConfig, create_train_state, make_train_step
from test_torch_train import FUSE, TOL, _check_leaves, _pallas_everywhere, _randomize_
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

LR = 1e-4
HW = 32
FLAGSHIP = dict(n_cams=2, backbone="resnet50", resnet_output_dim=32)
CASES = {
    "stem-f32": (False, dict(FLAGSHIP, bn_frozen=True, bn_frozen_affine=True, **FUSE)),
    "stem-bf16": (True, dict(FLAGSHIP, bn_frozen=True, bn_frozen_affine=True, **FUSE)),
    "stem-grad2-bf16": (True, dict(FLAGSHIP, bn_frozen=True, bn_frozen_affine=True, stem_grad_stride=2, **FUSE)),
    "exact-pallas-f32": (False, dict(FLAGSHIP, bn_impl="pallas")),
    "exact-xla-f32": (False, dict(FLAGSHIP)),
    "affine-f32": (False, dict(FLAGSHIP, bn_frozen=True)),
    "keypoint-f32": (False, dict(head_features=32)),
}
INTERPRET = {"stem-grad2-bf16"}  # argus_tpu's fused ops as Pallas kernels in interpret mode
STATS_TOL = {False: (1e-3, 1e-3), True: (3e-2, 1e-2)}
# exact BN in f32: each BN's backward subtracts the cotangent's projections
# on 1 and xhat, so the relative error of the same sums taken in another
# order grows toward the stem (measured: moments 2.5e-2 at stage 0 with
# "xla", 2.7e-4 with "pallas"; the median 5e-4), and Adam's first step
# turns it into sign flips of near-zero gradients (updates 0.11, median 1e-3)
TOL_EXACT = dict(loss=1e-5, moments=[(5e-2, 5e-3)], update=[(0.25, 1e-2)])


def _batch(keypoint: bool):
    rng = np.random.default_rng(3)
    poses = np.array([[0.01, -0.02, 0.05, 0.1, 0.2, -0.1, 0.0], [0.02, 0.01, 0.06, 0.0, 0.6, 0.0, 0.8]],
                     np.float32)
    poses[0, 3:] = [0.1, 0.2, -0.1, np.sqrt(1 - 0.06)]
    if not keypoint:
        poses[:, :3] *= 5
    return {
        "images": rng.integers(0, 256, (2, HW, HW, 6), dtype=np.uint8),
        "cube_pose": poses,
        "mask": np.array([1.0, 0.0], np.float32),  # the second row is padding
    }


def _configs(name, tmp_path):
    amp, kw = CASES[name]
    keypoint = name.startswith("keypoint")
    common = dict(amp=amp, use_augmentation=False, learning_rate=LR)
    if keypoint:
        cfg = TrainConfig(model_type="keypoint", keypoint_config=CubeKeypointNetConfig(**kw), **common)
        jm = jkp.CubeKeypointNetConfig(**kw)
        jcfg = JaxTrainConfig(model_type="keypoint", keypoint_config=jm, wandb_log=False, save_dir=str(tmp_path),
                              **common)
        jmodel = jkp.CubeKeypointNet(dataclasses.replace(jm, dtype="bfloat16" if amp else "float32"))
    else:
        cfg = TrainConfig(model_config=NCameraCNNConfig(**kw), **common)
        jm = JaxConfig(**kw)
        jcfg = JaxTrainConfig(model_config=jm, wandb_log=False, save_dir=str(tmp_path), **common)
        jmodel = JaxNCameraCNN(dataclasses.replace(jm, dtype="bfloat16" if amp else "float32"))
    return cfg, jcfg, jmodel, keypoint


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_matches_argus_tpu(name, tmp_path):
    cfg, jcfg, jmodel, keypoint = _configs(name, tmp_path)
    amp = cfg.amp
    model, state = create_train_state(cfg, seed=0, device="cpu")
    _randomize_(model, seed=1)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params, stats = variables_from_state_dict(model.state_dict())

    # argus_tpu's step: its fused ops through their XLA route (in INTERPRET, as Pallas kernels in interpret
    # mode); with bn_impl="pallas" its BN reductions as Pallas kernels in interpret mode
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32),
    )
    with pytest.MonkeyPatch.context() as mp:
        if name in INTERPRET:
            _pallas_everywhere(mp)
        step = jax.jit(make_train_step_body(jmodel, jcfg, 0, hw=(HW, HW)))
        jstate, jloss = step(jstate, jax.tree_util.tree_map(jnp.asarray, _batch(keypoint)))
    adam = jstate.opt_state[1]
    _, w_mu, w_nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    want = state_dict_from_variables(jax.device_get(jstate.params), jax.device_get(jstate.batch_stats))

    state, loss = make_train_step(model, cfg, hw=(HW, HW), device="cpu")(state, _batch(keypoint))
    tol = TOL_EXACT if name.startswith("exact") else TOL[amp]
    assert abs(float(loss) - float(jloss)) <= tol["loss"] * abs(float(jloss)), (float(loss), float(jloss))
    compared = {k: v for k, v in w_mu.items() if k != "heatmap.bias"}  # zero up to rounding (softmax)
    _check_leaves(state.opt_state.mu, compared, tol["moments"][0], "mu")
    _check_leaves(state.opt_state.nu, {k: w_nu[k] for k in compared}, tol["moments"][0], "nu")
    got = model.state_dict()
    is_stat = lambda k: k.endswith(("running_mean", "running_var"))  # noqa: E731
    _check_leaves({k: v for k, v in got.items() if not is_stat(k)},
                  {k: v for k, v in want.items() if not is_stat(k) and k != "heatmap.bias"},
                  tol["update"][0], "update", p0)
    w_stats = {k: v for k, v in want.items() if is_stat(k)}
    assert state.batch_stats.keys() >= w_stats.keys() and w_stats
    mu = state.opt_state.mu
    if (cfg.keypoint_config if keypoint else cfg.model_config).bn_frozen:  # running statistics stay
        assert all(torch.equal(state.batch_stats[k], p0[k]) and torch.equal(w_stats[k], p0[k]) for k in w_stats)
    else:  # exact BN: every statistic moved as argus_tpu's did
        _check_leaves(state.batch_stats, w_stats, STATS_TOL[amp], "batch_stats", p0)
        assert all(not torch.equal(state.batch_stats[k], p0[k]) for k in w_stats)
    if not (cfg.model_config.bn_frozen_affine and not keypoint):  # the BN affine trains
        assert all(torch.count_nonzero(v) > 0 for k, v in mu.items() if k.endswith("BatchNorm_0.weight"))
    if not keypoint:
        assert torch.count_nonzero(mu["backbone.conv_init.weight"]) > 0  # the stem trains
