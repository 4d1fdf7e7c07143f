"""The frozen-stage fine-tune and the packed stem (argus_tpu's
`_stem_fwd_packed_pallas`), what "auto" chooses, and fresh weights.

- The packed stem's plain version against argus_tpu's `fused_stem_pool(
  packed_out=True)` in Pallas interpret mode: the port's packed output is
  bit-equal to the pair-packed view of its NHWC output, and the values
  agree with argus_tpu's as the unpacked stem's do (tests/
  test_torch_kernels.py: f32 rtol 2e-4 / atol 1e-4, bf16 2e-2).
- `frozen_stages=3` and `frozen_stages=1` train steps (ResNet-50 widths,
  32x32, two rows of which one is masked, f32, every fuse flag on, the
  kernels' plain versions) against `make_train_step_body` with argus_tpu's
  Pallas kernels in interpret mode, with tests/test_torch_train.py's f32
  tolerances after one step (loss 1e-5; moments and updates 5e-3 / 2e-2
  per leaf and in the median). A spy confirms that argus_tpu took
  `_stem_fwd_packed_pallas` and the port its packed entry.
- C2: fresh kernels are flax's truncated `lecun_normal` (std within 3% of
  fan_in^-1/2, max |w| sqrt(fan_in) <= 2.28, the truncation at 2 / 0.8796).
- C1: "auto" reads `AUTO_FUSE` per function and mode on a CUDA tensor and
  is off on a CPU tensor; "on" and "off" keep argus_tpu's coupling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.models import NCameraCNN as JaxNCameraCNN
from argus_tpu.models import NCameraCNNConfig as JaxConfig
from argus_tpu.ops.pallas import stem_fused as js
from argus_tpu.train import TrainConfig as JaxTrainConfig
from argus_tpu.train import TrainState as JaxTrainState
from argus_tpu.train import make_optimizer as jax_make_optimizer
from argus_tpu.train import make_train_step_body
from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig
from argus_tpu_torch.models import resnet
from argus_tpu_torch.models.jax_import import (
    adam_moments_from_optax,
    state_dict_from_variables,
    variables_from_state_dict,
)
from argus_tpu_torch.ops.kernels import stem_fused as ts
from argus_tpu_torch.train import TrainConfig, _init_, create_train_state, make_train_step
from test_torch_kernels import BF16_TOL, DTYPES, F32_TOL, _check, _conv_bn, _j, _t
from test_torch_train import FUSE, TOL, _check_leaves, _pallas_everywhere, _randomize_

HW = 32
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this module runs: the suite's workers
    share the machine's cores, and more threads each only oversubscribe
    them. The previous count comes back after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_packed_stem_matches_argus_tpu(dtype, hw):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    args = _conv_bn(rng, 7, 7, 3, 64)
    want = js.fused_stem_pool(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True, packed_out=True)
    flat = js.fused_stem_pool(_j(x, jdt), *map(_j, args), impl="pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(want).reshape(flat.shape), np.asarray(flat))
    got = ts.fused_stem_pool(_t(x, tdt), *map(_t, args), packed_out=True)
    n, h, w = 2, hw[0] // 4, hw[1] // 8
    assert got.shape == (n, h, w, 128) and got.dtype == tdt and got.is_contiguous()
    w_, b_ = ts.fold_stem_params(*map(_t, args), 1e-5, tdt)
    assert torch.equal(got, ts.stem_pool_packed_plain(_t(x, tdt), w_, b_))
    assert torch.equal(got.reshape(n, h, 2 * w, 64), ts.stem_pool_plain(_t(x, tdt), w_, b_))
    _check(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    with pytest.raises(ValueError, match="forward only"):
        ts.stem_pool(_t(x, tdt), w_.requires_grad_(True), b_, packed_out=True)


def _batch():
    rng = np.random.default_rng(3)
    poses = np.array([[0.05, -0.1, 0.3, 0.1, 0.2, -0.1, 0.0], [0.2, 0.1, -0.2, 0.0, 0.6, 0.0, 0.8]], np.float32)
    poses[0, 3:] = [0.1, 0.2, -0.1, np.sqrt(1 - 0.06)]
    return {"images": rng.integers(0, 256, (2, HW, HW, 6), dtype=np.uint8), "cube_pose": poses,
            "mask": np.array([1.0, 0.0], np.float32)}


@pytest.mark.parametrize("frozen_stages", [3, 1])
def test_frozen_stages_step_matches_argus_tpu(frozen_stages, tmp_path, monkeypatch):
    kw = dict(n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True, bn_frozen_affine=True,
              stem_frozen=True, frozen_stages=frozen_stages, **FUSE)
    cfg = TrainConfig(model_config=NCameraCNNConfig(**kw), use_augmentation=False, learning_rate=LR)
    model, state = create_train_state(cfg, seed=0, device="cpu")
    _randomize_(model, seed=1)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params, stats = variables_from_state_dict(model.state_dict())

    jcfg = JaxTrainConfig(model_config=JaxConfig(**kw), use_augmentation=False, learning_rate=LR,
                          wandb_log=False, save_dir=str(tmp_path))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                           opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(LR, jnp.float32))
    jax_packed = []
    with pytest.MonkeyPatch.context() as mp:
        _pallas_everywhere(mp)
        packed = js._stem_fwd_packed_pallas
        mp.setattr(js, "_stem_fwd_packed_pallas", lambda *a, **k: jax_packed.append(1) or packed(*a, **k))
        step = jax.jit(make_train_step_body(JaxNCameraCNN(JaxConfig(**kw)), jcfg, 0))
        jstate, jloss = step(jstate, jax.tree_util.tree_map(jnp.asarray, _batch()))
    assert jax_packed, "argus_tpu did not take the packed stem"
    adam = jstate.opt_state[1]
    _, w_mu, w_nu = adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu))
    want = state_dict_from_variables(jax.device_get(jstate.params), {})

    port_packed = []
    fwd = ts.stem_fwd_packed
    monkeypatch.setattr(ts, "stem_fwd_packed", lambda *a: port_packed.append(1) or fwd(*a))
    state, loss = make_train_step(model, cfg, device="cpu")(state, _batch())
    assert port_packed == [1]
    tol = TOL[False]
    assert abs(float(loss) - float(jloss)) <= tol["loss"] * abs(float(jloss)), (float(loss), float(jloss))
    _check_leaves(state.opt_state.mu, w_mu, tol["moments"][0], "mu")
    _check_leaves(state.opt_state.nu, w_nu, tol["moments"][0], "nu")
    _check_leaves(dict(model.named_parameters()), want, tol["update"][0], "update", p0)
    trained = tuple(f"backbone.stage{i}_" for i in range(frozen_stages, 4)) + ("backbone.fc.", "head_")
    moved = {k for k, v in state.opt_state.mu.items() if torch.count_nonzero(v)}
    assert moved and all(k.startswith(trained) for k in moved), sorted(moved)[:3]


def test_fresh_weights_are_flax_lecun_normal():
    """C2: a 3x3x256x256 kernel as flax draws it (std within 3% of
    fan_in^-1/2; nothing beyond 2 / 0.8796 standard units), from an explicit
    generator; and the model's fresh convs and dense layers the same."""
    fan_in = 3 * 3 * 256
    conv = resnet.Conv(256, 256, 3)
    g = torch.Generator().manual_seed(0)
    w = resnet.lecun_normal_(torch.empty(256, 256, 3, 3), g)
    for t in (conv.weight.detach(), w):
        scaled = t * fan_in**0.5
        assert abs(scaled.std().item() - 1.0) <= 0.03 and scaled.abs().max().item() <= 2.28
    assert scaled.abs().max().item() > 2.2  # truncated near 2.2737, not at 2
    assert torch.equal(w, resnet.lecun_normal_(torch.empty(256, 256, 3, 3), torch.Generator().manual_seed(0)))
    cfg = TrainConfig(model_config=NCameraCNNConfig(backbone="resnet18", resnet_output_dim=16))
    model, _ = create_train_state(cfg, seed=4, device="cpu")
    first = {k: v.clone() for k, v in model.state_dict().items()}
    _init_(model, torch.Generator().manual_seed(4))  # create_train_state's draw, again
    for k, a in model.state_dict().items():
        assert torch.equal(a, first[k]), k
        if k.endswith("weight") and a.ndim >= 2:
            assert (a.abs() * a[0].numel() ** 0.5).max() <= 2.28, k
    assert torch.count_nonzero(first["head_out.bias"]) == 0


class _OnCard:
    """Stands in for a CUDA activation: `flag_on` reads only `is_cuda`."""

    is_cuda = True


def test_auto_reads_the_table_on_cuda_and_is_off_on_the_cpu():
    cpu = torch.zeros(1)
    for (fn, mode), on in resnet.AUTO_FUSE.items():
        assert mode in ("forward", "train")
        assert resnet.flag_on("auto", _OnCard(), fn, mode) is on
        assert resnet.flag_on("auto", cpu, fn, mode) is False
        assert resnet.flag_on("on", cpu, fn, mode) and not resnet.flag_on("off", _OnCard(), fn, mode)
    with pytest.raises(ValueError):
        resnet.flag_on("yes", cpu, "stem", "forward")

    frozen = dict(bn_frozen=True, bn_frozen_affine=True)
    auto = resnet.resnet50(**frozen)
    t = resnet.AUTO_FUSE
    for mode in ("forward", "train"):
        for i in range(4):
            chain = "stage_chain_packed" if i == 0 and mode == "forward" else "stage_chain"
            assert auto._fuse(_OnCard(), mode, i, 64 >> i) == (t[("identity", mode)], t[("projection", mode)],
                                                               t[(chain, mode)])
            assert auto._fuse(cpu, mode, i, 64 >> i) == (False, False, False)
    # explicit flags keep argus_tpu's coupling: the chain needs blocks and projections
    for blk, prj, stg, want in (("on", "on", "on", True), ("off", "on", "on", False), ("on", "off", "on", False),
                                ("on", "on", "off", False), ("auto", "auto", "on", True)):
        auto.fuse_block, auto.fuse_proj, auto.fuse_stage = blk, prj, stg
        assert auto._fuse(cpu, "train", 0, 64)[2] is want
    auto.frozen = False  # exact BN or a trained affine: nothing fuses
    assert auto._fuse(_OnCard(), "train", 0, 64) == (False, False, False)


def test_auto_runs_no_kernel_function_on_the_cpu(monkeypatch):
    """Every fuse flag "auto" on CPU tensors: the model takes the plain
    convolutions everywhere; with "on" it takes every fused function."""
    calls = []
    for name in ("stem_pool", "stage_chain"):
        f = getattr(resnet, name)
        monkeypatch.setattr(resnet, name, lambda *a, _f=f, _n=name, **k: calls.append(_n) or _f(*a, **k))
    for cls, name in ((resnet.BottleneckBlock, "block"), (resnet.BasicBlock, "basic")):
        f = cls.forward_fused
        monkeypatch.setattr(cls, "forward_fused", lambda self, *a, _f=f, _n=name: calls.append(_n) or _f(self, *a))
    x = torch.rand(2, 32, 32, 6)
    model = NCameraCNN(NCameraCNNConfig(backbone="resnet50", resnet_output_dim=8, bn_frozen=True,
                                        bn_frozen_affine=True))
    for flags, frozen_stages, chains in (("auto", 0, 0), ("auto", 2, 0), ("on", 2, 2), ("on", 3, 3)):
        for k in FUSE:
            setattr(model.backbone, k, flags)
        model.backbone.frozen_stages = frozen_stages
        calls.clear()
        with torch.no_grad():
            model(x)
        if flags == "auto":
            assert calls == []
        else:
            assert calls.count("stem_pool") == 1 and calls.count("stage_chain") == chains and "block" in calls
