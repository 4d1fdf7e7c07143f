"""The port's training step (argus_tpu_torch.train) against argus_tpu's.

One and two steps of the port's `make_train_step` on the CPU against
`argus_tpu.train.make_train_step_body`, from one state: ResNet-50
NCameraCNN (output dim 32), 64x64,
two rows of which one is masked, frozen BN and stem, full backprop, every
fuse flag on, BN buffers and scales randomised (with the zero-initialised
BatchNorm_2 scales a broken backward would hide behind zero gradients) and
non-identity targets. Loss, Adam moments (the clipped gradients) and params
are compared leaf by leaf, in f32 and bf16 (`amp`) without augmentation,
and for one bf16 step with argus_tpu's default augmentation (the per-op
path with the blur kernel on the CPU, both sides; the port's sampler
returns argus_tpu's parameters for `fold_in(PRNGKey(0), 0)`).
argus_tpu's fused ops run as Pallas kernels in interpret mode in the
augmented case, the step's most complete one, and through their XLA route
(the math argus_tpu's own tests hold each Pallas kernel against) in the f32
and bf16 cases; each kernel's plain version in the port is held against its
interpret-mode Pallas kernel by tests/test_torch_kernels.py. A case's
reference and its port side start from one created state, copied
(`_created`). Also: the optimizer against optax, the Adam-state bridge, the
entry points' refusals, and at 32x32 (what they hold does not depend on the
size) the augmentation stream of a resumed state and the frozen stages'
gradients.

Tolerances. Moments are compared per leaf as |port - ref| / |ref| (2-norms),
the params through their update, |p_port - p_ref| / |p_ref - p_0|, after
steps 1 and 2; the step count and the frozen leaves' zero moments exactly:
- f32 (the algorithm): loss 1e-5. Moments 5e-3 after step 1: the same f32
  sums in another order flip a relu mask where a value sits within rounding
  of zero, which moves that element's whole contribution (measured 1.1e-3).
  Adam's first steps are close to lr * sign(g), so an element whose gradient
  is all but zero moves by a different amount; after step 2 the inputs
  differ by that and moments are held to 5e-2 (measured 2.2e-2), updates to
  2e-2 and 5e-2 (measured 6e-3, 1.3e-2).
- bf16 (the rounding points): loss 1e-2 (measured 9e-4). Both sides round
  at the same points, but each rounding of an f32 sum taken in another order
  may land one bf16 ulp (2^-8) apart and the ulps accumulate through 50
  layers each way: moments 0.3 per leaf and 0.1 in the median after step 1,
  0.4 and 0.15 after step 2 (measured 0.09/0.05 and 0.23/0.07; argus_tpu's
  own bf16 moments sit up to 0.22 from its f32 ones). A sign flip of a small
  gradient moves an element by 2 lr, so updates are held to 0.6 per leaf and
  0.4 in the median (measured 0.32 and 0.25).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from argus_tpu.models import NCameraCNN as JaxNCameraCNN
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.ops.augment import AugmentationConfig as JaxAugmentationConfig
from argus_tpu.ops.pallas import block_fused as jb
from argus_tpu.ops.pallas import proj_fused as jp
from argus_tpu.ops.pallas import stage_fused as jst
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu.train import TrainConfig as JaxTrainConfig
from argus_tpu.train import TrainState as JaxTrainState
from argus_tpu.train import make_optimizer as jax_make_optimizer
from argus_tpu.train import make_train_step_body
from argus_tpu_torch.ops import augment as TA
from argus_tpu_torch.models import NCameraCNNConfig
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    optax_moments_from_adam,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.ops.norm import BatchNorm
from argus_tpu_torch.train import (
    AdamState,
    TrainConfig,
    checkpoint_meta,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

LR = 1e-4
FUSE = dict(fuse_block="on", fuse_proj="on", fuse_stem="on", fuse_stage="on")
MODEL = dict(
    n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True, bn_frozen_affine=True,
    stem_frozen=True, frozen_stages=0, **FUSE,
)
# per dtype (amp): loss; then per step (max per leaf, median over leaves) for
# the moments and for the params' update
TOL = {
    False: dict(loss=1e-5, moments=[(5e-3, 5e-3), (5e-2, 5e-2)], update=[(2e-2, 2e-2), (5e-2, 5e-2)]),
    True: dict(loss=1e-2, moments=[(0.3, 0.1), (0.4, 0.15)], update=[(0.6, 0.4), (0.6, 0.4)]),
}


_CREATED = {}


def _created(cfg, **kw):
    """`create_train_state(cfg, device="cpu", **kw)`, deep-copied from the
    last one made when the configuration is the same: the same weights and
    state, bit for bit, for each caller to step or change. (A reference and
    the port's side of a case ask for the same state in turn; one state is
    kept, so the cache holds one ResNet-50 and its moments at most.)"""
    key = repr((cfg, sorted(kw.items())))
    if key not in _CREATED:
        _CREATED.clear()
        _CREATED[key] = create_train_state(cfg, device="cpu", **kw)
    return copy.deepcopy(_CREATED[key])


def _randomize_(model, seed):
    """Random BN buffers and scales (BatchNorm_2 small but nonzero) and
    lecun-normal weights, from a seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                lo, hi = (0.1, 0.3) if name.endswith("BatchNorm_2") else (0.5, 1.5)
                mod.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
            elif isinstance(getattr(mod, "weight", None), torch.nn.Parameter):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=g) / w[0].numel() ** 0.5)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.copy_(0.01 * torch.randn(mod.bias.shape, generator=g))


def _batch(hw=64):
    rng = np.random.default_rng(3)
    poses = np.array([[0.05, -0.1, 0.3, 0.1, 0.2, -0.1, 0.0], [0.2, 0.1, -0.2, 0.0, 0.6, 0.0, 0.8]],
                     np.float32)
    poses[0, 3:] = [0.1, 0.2, -0.1, np.sqrt(1 - 0.06)]
    return {
        "images": rng.integers(0, 256, (2, hw, hw, 6), dtype=np.uint8),
        "cube_pose": poses,
        "mask": np.array([1.0, 0.0], np.float32),  # the second row is padding
    }


def _port(amp, aug=False):
    cfg = TrainConfig(model_config=NCameraCNNConfig(**MODEL), amp=amp, use_augmentation=aug,
                      learning_rate=LR)
    model, state = _created(cfg, seed=0)
    _randomize_(model, seed=1)
    return cfg, model, state


def _pallas_everywhere(mp):
    """Route argus_tpu's fused ops through their Pallas kernels (interpret
    mode on the CPU) instead of the XLA fallback math that "on" selects off
    the TPU."""
    for mod in (jb, jp, jst, js):
        mp.setattr(mod, "_use_pallas", lambda impl: impl != "xla")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """argus_tpu's loss, Adam state and params after one and two steps, per
    dtype, from the port's initial state converted; computed once. The
    fused ops run as Pallas kernels in interpret mode with `pallas`, else
    through their XLA route ("on" off the TPU)."""
    cache = {}

    def run(amp, aug=False, pallas=False):
        if (amp, aug, pallas) in cache:
            return cache[amp, aug, pallas]
        cfg, model, _ = _port(amp, aug)
        params, stats = variables_from_state_dict(model.state_dict())
        jcfg = JaxTrainConfig(
            model_config=JaxConfig(**MODEL), amp=amp, use_augmentation=aug, learning_rate=LR,
            wandb_log=False, save_dir=str(tmp_path_factory.mktemp("save")),
        )
        jmodel = JaxNCameraCNN(dataclasses.replace(JaxConfig(**MODEL), dtype="bfloat16" if amp else "float32"))
        params = jax.tree_util.tree_map(jnp.asarray, params)
        stats = jax.tree_util.tree_map(jnp.asarray, stats)
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32),
        )
        batch = jax.tree_util.tree_map(jnp.asarray, _batch())
        out = []
        with pytest.MonkeyPatch.context() as mp:
            if pallas:
                _pallas_everywhere(mp)
            step = jax.jit(make_train_step_body(jmodel, jcfg, 0))
            for _ in range(1 if aug else 2):
                state, loss = step(state, batch)
                adam = state.opt_state[1]
                out.append((
                    float(loss),
                    adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu)),
                    state_dict_from_variables(jax.device_get(state.params), {}),
                ))
        cache[amp, aug, pallas] = out
        return out

    return run


def _check_leaves(got: dict, want: dict, tol, what, base=None):
    """Per-leaf relative 2-norm errors |got - want| / |want - base| (base
    zero for the moments, the initial params for the update): the largest
    and the median within `tol` = (max, median); leaves that do not move in
    the reference must not move in the port either."""
    assert set(got) >= set(want), what
    errs = []
    for k, w in want.items():
        a, b = got[k].detach().float(), w.float()
        ref = b if base is None else b - base[k].float()
        if torch.count_nonzero(ref) == 0:
            moved = a if base is None else a - base[k].float()
            assert torch.count_nonzero(moved) == 0, f"{what} {k}: moves where argus_tpu's does not"
            continue
        errs.append(((a - b).norm().item() / ref.norm().item(), k))
    worst, median = max(errs), sorted(e for e, _ in errs)[len(errs) // 2]
    assert worst[0] <= tol[0], f"{what} {worst[1]}: relative error {worst[0]} > {tol[0]}"
    assert median <= tol[1], f"{what}: median relative error {median} > {tol[1]}"


@pytest.mark.parametrize("amp,aug", [(False, False), (True, False), (True, True)],
                         ids=["f32", "bf16", "bf16-augmented"])
def test_train_step_matches_argus_tpu(reference, monkeypatch, amp, aug):
    want = reference(amp, aug, pallas=aug)  # the augmented case against the Pallas kernels
    cfg, model, state = _port(amp, aug)
    if aug:
        from test_torch_augment import jax_params

        p = jax_params(JaxAugmentationConfig(), jax.random.fold_in(jax.random.PRNGKey(0), 0), 2, 2, 64, 64,
                       jnp.bfloat16)
        calls = []
        monkeypatch.setattr(TA, "sample_params", lambda *a, **k: calls.append(a) or p)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, cfg, device="cpu")
    tol = TOL[amp]
    for i, (w_loss, (w_count, w_mu, w_nu), w_params) in enumerate(want):
        state, loss = step(state, _batch())
        assert abs(float(loss) - w_loss) <= tol["loss"] * abs(w_loss), (i, float(loss), w_loss)
        assert int(state.opt_state.count) == int(w_count) == i + 1
        _check_leaves(state.opt_state.mu, w_mu, tol["moments"][i], f"step {i + 1} mu")
        _check_leaves(state.opt_state.nu, w_nu, tol["moments"][i], f"step {i + 1} nu")
        _check_leaves(model.state_dict(), w_params, tol["update"][i], f"step {i + 1} update", p0)
    if aug:  # the port sampled for step 0's key (and, ahead, step 1's) and took argus_tpu's parameters
        assert [a[1:4] for a in calls] == [(TA.fold_in(0, 0), 2, 2), (TA.fold_in(0, 1), 2, 2)]
        assert state.step == 1
    # the frozen parts got no gradient: BN affine and the stem
    for k, v in state.opt_state.mu.items():
        if ".BatchNorm" in k or "norm_" in k or "conv_init" in k:
            assert torch.count_nonzero(v) == 0, k


def test_resumed_state_continues_the_augmentation_stream(monkeypatch):
    """The step augments with the key fold_in(base_seed, state.step): a state
    resumed at step 2 (its step set, as a restore sets it) applies the same
    parameters as an uninterrupted run does at steps 2 and 3."""
    applied = []
    apply_params = TA.apply_params
    monkeypatch.setattr(TA, "apply_params", lambda c, p, x, n: applied.append(p) or apply_params(c, p, x, n))

    def run(start, n_steps):
        cfg, model, state = _port(False, aug=True)
        state.step = start
        step = make_train_step(model, cfg, base_seed=3, device="cpu")
        for _ in range(n_steps):
            state, loss = step(state, _batch(32))
            assert torch.isfinite(loss)
        assert state.step == start + n_steps
        out = [(p.jiggle, p.arcs, p.plasma[0]) for p in applied]
        applied.clear()
        return out, cfg

    whole, cfg = run(0, 4)
    resumed, _ = run(2, 2)
    for got, want in zip(resumed, whole[2:], strict=True):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(whole[2][0], whole[3][0])
    first = TA.sample_params(cfg.augmentation_config, TA.fold_in(3, 0), 2, 2, 32, 32, "cpu", torch.float32)
    assert torch.equal(whole[0][0], first.jiggle) and torch.equal(whole[0][1], first.arcs)


def test_optimizer_matches_optax():
    """clip_by_global_norm then scale_by_adam, over three steps on random
    gradient trees whose norm is above, below, then above the clip."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (4, 3), "b.weight": (7,), "b.bias": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.scale_by_adam())
    jstate = tx.init({k: jnp.asarray(v) for k, v in params.items()})
    opt = make_optimizer(1.0)
    state = opt.init({k: torch.from_numpy(v) for k, v in params.items()})
    for scale in (3.0, 0.01, 10.0):
        grads = {k: (scale * rng.normal(size=s) / 3).astype(np.float32) for k, s in shapes.items()}
        want, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate)
        got = opt.update({k: torch.from_numpy(v) for k, v in grads.items()}, state)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(jstate[1].mu[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(jstate[1].nu[k]), rtol=1e-6, atol=1e-12)
        assert int(state.count) == int(jstate[1].count)


def test_adam_state_bridge_round_trip():
    """optax ScaleByAdamState <-> the port's moments, through the params key
    map: kernels transposed like their weights, and back exactly."""
    rng = np.random.default_rng(1)
    tree = lambda: {  # noqa: E731
        "backbone": {"conv_init": {"kernel": rng.normal(size=(7, 7, 3, 8)).astype(np.float32)},
                     "norm_init": {"scale": rng.normal(size=(8,)).astype(np.float32),
                                   "bias": rng.normal(size=(8,)).astype(np.float32)}},
        "head_out": {"kernel": rng.normal(size=(5, 6)).astype(np.float32),
                     "bias": rng.normal(size=(6,)).astype(np.float32)},
    }
    mu, nu = tree(), tree()
    count, tmu, tnu = adam_moments_from_optax(np.asarray(3, np.int32), mu, nu)
    assert int(count) == 3 and count.dtype == torch.int32
    np.testing.assert_array_equal(tmu["head_out.weight"].numpy(), mu["head_out"]["kernel"].T)
    np.testing.assert_array_equal(
        tnu["backbone.conv_init.weight"].numpy(), nu["backbone"]["conv_init"]["kernel"].transpose(3, 2, 0, 1)
    )
    c2, mu2, nu2 = optax_moments_from_adam(count, tmu, tnu)
    assert c2 == 3 and c2.dtype == np.int32
    for a, b in ((mu, mu2), (nu, nu2)):
        for (pa, x), (pb, y) in zip(jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)):
            assert pa == pb
            np.testing.assert_array_equal(x, y)
    AdamState(count, tmu, tnu)  # the port's state takes them as they are


def test_unported_configurations_raise():
    """Data and tensor parallelism are ported: the multi-card fields raise
    only where they disagree with the mesh the step runs over (the model
    axis, the world, the global batch over the data ranks), each naming
    the reason."""
    from argus_tpu_torch.parallel import Mesh

    model_cfg = NCameraCNNConfig(**MODEL)
    create_train_state(TrainConfig(model_config=model_cfg, use_augmentation=False, multigpu=True), device="cpu")
    cases = [
        (dict(num_model_shards=2), Mesh(2, 1, 0, 2), "num_model_shards=2"),
        (dict(num_chips=4), Mesh(2, 1, 0, 2), "num_chips=4"),
        (dict(batch_size=3), Mesh(2, 1, 0, 2), "divide over 2 data shards"),
        (dict(batch_size=6), Mesh(4, 1, 0, 1), "divide over 4 data shards"),
    ]
    for kw, mesh, reason in cases:
        cfg = TrainConfig(**{"model_config": model_cfg, "use_augmentation": False, **kw})
        with pytest.raises(ValueError, match=reason):
            create_train_state(cfg, device="cpu", mesh=mesh)


def test_frozen_stages_stop_gradients():
    """frozen_stages=2: the stem and stages 0-1 get no gradient and run no
    saving forward (their moments stay zero); stages 2-3 train."""
    cfg = TrainConfig(
        model_config=NCameraCNNConfig(**{**MODEL, "backbone": "resnet50", "frozen_stages": 2}),
        use_augmentation=False, learning_rate=LR,
    )
    model, state = create_train_state(cfg, device="cpu")
    _randomize_(model, seed=2)
    state, loss = make_train_step(model, cfg, device="cpu")(state, _batch(32))
    assert torch.isfinite(loss)
    for k, v in state.opt_state.mu.items():
        frozen = "conv_init" in k or "stage0_" in k or "stage1_" in k or "BatchNorm" in k or "norm_" in k
        assert (torch.count_nonzero(v) == 0) == frozen, k


def test_fold_cache_is_not_used_with_gradients():
    """`fold_frozen_bn` caches the folded weights for inference only: with
    gradients on, the forward folds anew (new weights are seen, and the
    gradient reaches the conv kernels)."""
    cfg = TrainConfig(model_config=NCameraCNNConfig(**MODEL), use_augmentation=False)
    model, _ = create_train_state(cfg, device="cpu")
    _randomize_(model, seed=4)
    backbone = model.backbone
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    backbone.fold_frozen_bn()
    with torch.no_grad():
        before = backbone(x)
        backbone.stage1_block0.Conv_0.weight.mul_(2.0)
        cached = backbone(x)  # inference still uses the cached fold
    torch.testing.assert_close(cached, before)
    fresh = backbone(x, train=True)
    assert not torch.allclose(fresh.detach(), before)
    fresh.sum().backward()
    assert backbone.stage1_block0.Conv_0.weight.grad is not None
    assert backbone.stage1_block0.BatchNorm_0.weight.grad is None


@pytest.mark.parametrize("family", ["pose_cnn", "keypoint"])
def test_checkpoint_meta_matches_argus_tpu(tmp_path, family):
    from argus_tpu.models.keypoint_net import CubeKeypointNetConfig as JaxKeypointConfig
    from argus_tpu.train import checkpoint_meta as jax_meta
    from argus_tpu_torch.models import CubeKeypointNetConfig

    kw = dict(amp=True, use_augmentation=False, model_type=family)
    got = checkpoint_meta(TrainConfig(model_config=NCameraCNNConfig(**MODEL), **kw), hw=(64, 64))
    jcfg = JaxTrainConfig(model_config=JaxConfig(**MODEL), wandb_log=False, save_dir=str(tmp_path), **kw)
    want = jax_meta(jcfg, hw=(64, 64))
    assert got == want
    # the keypoint family's default config is argus_tpu's
    assert dataclasses.asdict(TrainConfig().keypoint_config) == dataclasses.asdict(JaxKeypointConfig())
    assert dataclasses.asdict(CubeKeypointNetConfig()) == dataclasses.asdict(JaxKeypointConfig())
