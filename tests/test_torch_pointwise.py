"""The port's pointwise op (argus_tpu_torch.ops.kernels.pointwise) and
`fuse_pointwise` against argus_tpu's, and the unfused frozen-BN path's fold.

- The op on the CPU, both implementations ("kernel": the CUDA kernels'
  plain versions; "dot": the matmul form) against argus_tpu's
  `pointwise_conv_frozen_bn(..., impl="pallas", interpret=True)`, relu on
  and off, residual on and off, forward and the gradients of x, kernel and
  residual, on argus_tpu's `_mk` inputs (`tests/test_pointwise.py`), and an
  odd M (1 x 7 x 7).
- The backward's composition on the card (`csrc/pointwise_bwd.cu`: the mask
  pass, dx from m on the data-gradient engine, dw from x2 and m on the
  weight-gradient engine) in plain torch: bit for bit the plain backward,
  and, as the op's kernel backward, within the op's tolerance of argus_tpu.
- A tiny ResNet-50 (`stage_sizes=(1, 1)`, 8 filters, frozen BN and affine)
  with `fuse_pointwise` "on" and "dot" against argus_tpu's same model with
  its Pallas kernel in interpret mode, outputs and gradients.
- One train step of configuration P (ResNet-50 NCameraCNN, frozen BN,
  affine and stem, `fuse_pointwise="on"`, the block flags off) at 32x32
  against `make_train_step_body`, f32 with argus_tpu's pointwise kernel in
  interpret mode, bf16 against its XLA route (the math argus_tpu's own
  tests hold the kernel against; the op cases above hold the port's plain
  version against the kernel in both dtypes).
- The unfused frozen-BN path (ROADMAP C3: each conv on its BN-folded
  weight) against argus_tpu's frozen-BN forward (unfolded BN) and its step.

Tolerances. The op, f32: argus_tpu's own, 1e-5 forward and 1e-4 gradients
(rtol; atol 1e-5): the same f32 sums in another order. bf16: 2e-2 relative
to the largest value: both sides round the output and dx once, after f32
sums in another order (one bf16 ulp is 2^-8 of a value; measured 7.8e-3),
and dk is f32(bf16(dw)) * c on both. The models (f32): argus_tpu's
`test_fused_model_same_tree_and_outputs`, outputs 1e-4 / 1e-5 and
gradients 2e-3 / 1e-4 (rtol / atol). The steps: `tests/test_torch_train.py`'s
`TOL` (its docstring gives the reasons), one step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from argus_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from argus_tpu.models.resnet import ResNet as JaxResNet
from argus_tpu.ops.pallas import pointwise as jpw
from argus_tpu_torch.models.jax_import import state_dict_from_variables, variables_from_state_dict
from argus_tpu_torch.models.resnet import BottleneckBlock, ResNet
from argus_tpu_torch.ops.kernels import pointwise as tpw
from argus_tpu_torch.ops.kernels.block_fused import relu_mask, wgrad_f32

from test_torch_train import TOL, _check_leaves, _created, _pallas_everywhere, _randomize_
from _torch_threads import _two_threads  # noqa: F401  (autouse, this module)

BF16_TOL = 2e-2  # relative to the largest value of the reference, bf16 (see the module docstring)


def _mk(n=2, h=8, w=8, cin=16, cout=32, seed=0, residual=False):
    """argus_tpu's `tests/test_pointwise.py` inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    k = rng.normal(0, 0.2, (1, 1, cin, cout)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (cout,)).astype(np.float32)
    bias = rng.normal(0, 0.3, (cout,)).astype(np.float32)
    mean = rng.normal(0, 0.3, (cout,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, (cout,)).astype(np.float32)
    res = rng.normal(0, 1, (n, h, w, cout)).astype(np.float32) if residual else None
    return x, k, scale, bias, mean, var, res


DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def argus_op():
    """argus_tpu's Pallas op in interpret mode: (y, dx, dk, dres) for the
    loss sum(sin(y)), per case, computed once."""
    cache = {}

    def run(residual, relu, dt, shape):
        key = (residual, relu, dt, shape)
        if key not in cache:
            x, k, s, b, m, v, res = _mk(*shape, residual=residual)
            jdt = DTYPES[dt][0]
            x = jnp.asarray(x, jdt)
            res = None if res is None else jnp.asarray(res, jdt)

            def f(x, k, res):
                y = jpw.pointwise_conv_frozen_bn(x, k, s, b, m, v, relu=relu, residual=res, impl="pallas",
                                                 interpret=True)
                return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

            (_, y), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(x, jnp.asarray(k), res)
            cache[key] = [None if t is None else np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]
        return cache[key]

    return run


def _port_op(residual, relu, dt, shape, impl):
    x, k, s, b, m, v, res = _mk(*shape, residual=residual)
    tdt = DTYPES[dt][1]
    x = torch.from_numpy(x).to(tdt).requires_grad_()
    k = torch.from_numpy(k).requires_grad_()
    res = None if res is None else torch.from_numpy(res).to(tdt).requires_grad_()
    bn = [torch.from_numpy(t) for t in (s, b, m, v)]
    y = tpw.pointwise_conv_frozen_bn(x, k, *bn, relu=relu, residual=res, impl=impl)
    torch.sin(y.float()).sum().backward()
    return [None if t is None else t.detach().float().numpy() for t in (y, x.grad, k.grad, None if res is None
                                                                       else res.grad)]


def _assert_op(got, want, dt, rtol, what):
    for name, a, b in zip(("y", "dx", "dk", "dres"), got, want):
        if b is None:
            assert a is None, (what, name)
            continue
        if dt == "f32":
            np.testing.assert_allclose(a, b, rtol=rtol if name == "y" else 1e-4, atol=1e-5, err_msg=f"{what} {name}")
        else:
            err = np.abs(a - b).max()
            assert err <= BF16_TOL * np.abs(b).max(), (what, name, err, np.abs(b).max())


@pytest.mark.parametrize("impl", tpw.IMPLS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_op_matches_argus_tpu_pallas(argus_op, residual, relu, dt, impl):
    shape = (2, 8, 8, 16, 32)
    _assert_op(_port_op(residual, relu, dt, shape, impl), argus_op(residual, relu, dt, shape), dt, 1e-5,
               f"residual={residual} relu={relu}")


@pytest.mark.parametrize("residual", [False, True])
def test_op_odd_row_count(argus_op, residual):
    """M = 1 * 7 * 7: no tile divides it (argus_tpu's `test_odd_m_not_multiple_of_8`)."""
    shape = (1, 7, 7, 16, 32)
    _assert_op(_port_op(residual, True, "f32", shape, "kernel"), argus_op(residual, True, "f32", shape), "f32",
               1e-5, "odd M")


def test_op_takes_the_no_save_forward_without_gradients():
    """No input needs a gradient (a frozen stage): no autograd node."""
    x, k, s, b, m, v, _ = (torch.from_numpy(t) if t is not None else None for t in _mk())
    y = tpw.pointwise_conv_frozen_bn(x, k, s, b, m, v)
    assert y.grad_fn is None
    y = tpw.pointwise_conv_frozen_bn(x.requires_grad_(), k, s, b, m, v)
    assert "PwNoRes" in type(y.grad_fn.next_functions[0][0]).__name__


# ───────────────────────── the backward's composition ─────────────────────────


def pointwise_bwd_twin(g2, out2, x2, w, relu=True, emit_m=False, need_dx=True):
    """csrc/pointwise_bwd.cu's launches in plain torch: the mask pass writes
    m = g * (out > 0) once (g itself without relu), the 1x1 data gradient
    takes m as A and w^T (COUT, CIN) as B and rounds dx once, the weight
    gradient sums x2^T m in f32."""
    m = relu_mask(g2, out2) if relu else g2
    dx = (m.float() @ w.t().contiguous().float()).to(x2.dtype) if need_dx else None
    return dx, wgrad_f32(x2, m), m if emit_m else None


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("relu,emit_m,need_dx", [(True, False, True), (True, True, True), (False, True, True),
                                                 (True, True, False), (False, False, False)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 32), (1, 7, 7, 16, 32), (3, 5, 7, 72, 24)], ids=["M128", "M49", "M105"])
def test_backward_composition_matches_the_plain_backward(shape, relu, emit_m, need_dx, dt):
    """The pass, dx from m and dw from x2 and m: bit for bit
    `pointwise_bwd_plain`, relu on and off, m emitted or not, dx asked for
    or not, at odd M."""
    x, k, s, b, mu, v, _ = _mk(*shape)
    tdt = DTYPES[dt][1]
    x2 = torch.from_numpy(x).to(tdt).reshape(-1, x.shape[-1])
    w, bias = tpw.fold_affine(torch.from_numpy(k).reshape(k.shape[-2:]), *(torch.from_numpy(t) for t in (s, b, mu, v)),
                              1e-5, tdt)
    out2 = tpw.pointwise_fwd_plain(x2, w, bias, None, relu)
    g2 = torch.from_numpy(np.random.default_rng(7).normal(0, 1, tuple(out2.shape)).astype(np.float32)).to(tdt)
    got = pointwise_bwd_twin(g2, out2, x2, w, relu, emit_m, need_dx)
    want = tpw.pointwise_bwd_plain(g2, out2, x2, w, relu, emit_m, need_dx)
    for a, r in zip(got, want):
        assert (a is None and r is None) or torch.equal(a, r)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("residual", [False, True])
def test_backward_composition_matches_argus_tpu_pallas(argus_op, monkeypatch, residual, relu, dt):
    """The op with the composition as its kernel backward against argus_tpu's
    Pallas op (`_pw_bwd_pallas` in interpret mode) under the op's tolerance:
    dx, dk and the residual's cotangent m; an odd M beside it in f32."""
    monkeypatch.setitem(tpw._BWD, "kernel", pointwise_bwd_twin)
    shape = (2, 8, 8, 16, 32)
    _assert_op(_port_op(residual, relu, dt, shape, "kernel"), argus_op(residual, relu, dt, shape), dt, 1e-5,
               f"composition residual={residual} relu={relu}")
    if relu and dt == "f32":
        odd = (1, 7, 7, 16, 32)
        _assert_op(_port_op(residual, True, "f32", odd, "kernel"), argus_op(residual, True, "f32", odd), "f32", 1e-5,
                   "composition odd M")


# ───────────────────────── models ─────────────────────────


def tiny_models(stage_sizes=(1, 1), **kw):
    """The port's and argus_tpu's ResNet-50-style backbone (8 filters, output
    dim 8, f32) with the port's randomised weights (every BN scale and
    buffer random, BatchNorm_2's small) in both: (port, argus_tpu model,
    argus_tpu variables)."""
    kw = dict(stage_sizes=stage_sizes, output_dim=8, num_filters=8, **kw)
    port = ResNet(block_cls=BottleneckBlock, **kw)
    _randomize_(port, seed=3)
    params, stats = variables_from_state_dict(port.state_dict())
    tree = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    return port, JaxResNet(block_cls=JaxBottleneck, **kw), tree


def _images(n=2, hw=32):
    return np.random.default_rng(0).normal(0, 1, (n, hw, hw, 3)).astype(np.float32)


def argus_loss_grads(jmodel, variables, x):
    """argus_tpu's sum(y**2) in train mode: (y, grads as a state_dict, the
    new running statistics as a state_dict)."""

    def loss(p):
        y, upd = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, x, train=True,
                              mutable=["batch_stats"])
        return jnp.sum(y**2), (y, upd)

    (_, (y, upd)), g = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return (np.asarray(y), state_dict_from_variables(jax.device_get(g), {}),
            state_dict_from_variables({}, jax.device_get(upd["batch_stats"])))


def port_loss_grads(model, x):
    model.zero_grad()
    y = model(torch.from_numpy(x), train=True)
    (y**2).sum().backward()
    return y.detach().numpy(), {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


def assert_grads(got, want, rtol=2e-3, atol=1e-4):
    for k, w in want.items():
        if not np.any(w.numpy()):
            assert k not in got or not torch.any(got[k]), k  # frozen: no gradient either side
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("fuse", ["on", "dot"])
def test_tiny_model_matches_argus_tpu(monkeypatch, fuse):
    """argus_tpu's `test_fused_model_same_tree_and_outputs`, across the two
    packages: the same variable tree, outputs and gradients."""
    port, jmodel, tree = tiny_models(bn_frozen=True, bn_frozen_affine=True, fuse_pointwise=fuse)
    monkeypatch.setattr(jpw, "_use_pallas", lambda impl: impl != "xla")
    x = _images()
    y_ref, g_ref, _ = argus_loss_grads(jmodel, tree, jnp.asarray(x))
    calls = []
    fwd = tpw._FWD[port._pointwise(torch.zeros(1), "train")]
    monkeypatch.setitem(tpw._FWD, "kernel" if fuse == "on" else "dot", lambda *a: calls.append(1) or fwd(*a))
    y, g = port_loss_grads(port, x)
    assert len(calls) == 4  # Conv_0 and Conv_2 of both blocks
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    assert_grads(g, g_ref)
    assert set(port.state_dict()) == set(ResNet(block_cls=BottleneckBlock, stage_sizes=(1, 1), num_filters=8,
                                                output_dim=8).state_dict())


@pytest.mark.parametrize("block", ["bottleneck", "basic"])
def test_folded_unfused_path_matches_argus_tpu(block):
    """C3: under frozen BN and affine with every kernel off, each conv runs on
    its folded weight; argus_tpu's frozen-BN model applies the BN unfolded.
    f32, outputs and gradients at argus_tpu's model tolerances."""
    from argus_tpu.models.resnet import BasicBlock as JaxBasic
    from argus_tpu_torch.models.resnet import BasicBlock

    if block == "bottleneck":
        port, jmodel, tree = tiny_models(bn_frozen=True, bn_frozen_affine=True)
    else:
        kw = dict(stage_sizes=(1, 1), output_dim=8, num_filters=8, bn_frozen=True, bn_frozen_affine=True)
        port = ResNet(block_cls=BasicBlock, **kw)
        _randomize_(port, seed=3)
        params, stats = variables_from_state_dict(port.state_dict())
        tree = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
        jmodel = JaxResNet(block_cls=JaxBasic, **kw)
    x = _images()
    y_ref, g_ref, _ = argus_loss_grads(jmodel, tree, jnp.asarray(x))
    y, g = port_loss_grads(port, x)
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    assert_grads(g, g_ref)


# ───────────────────────── train steps ─────────────────────────


LR = 1e-4


def _step_batch(hw):
    rng = np.random.default_rng(3)
    return {
        "images": rng.integers(0, 256, (2, hw, hw, 6), dtype=np.uint8),
        "cube_pose": np.array([[0.05, -0.1, 0.3, 0.1, 0.2, -0.1, np.sqrt(0.94)],
                               [0.2, 0.1, -0.2, 0.0, 0.6, 0.0, 0.8]], np.float32),
        "mask": np.array([1.0, 0.0], np.float32),
    }


def _port_state(model_kw, amp, seed):
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.train import TrainConfig

    cfg = TrainConfig(model_config=NCameraCNNConfig(**model_kw), amp=amp, use_augmentation=False, learning_rate=LR)
    model, state = _created(cfg, seed=0)
    _randomize_(model, seed=seed)
    return cfg, model, state


def port_step(model_kw, amp, seed=1, hw=32):
    """One step of the port's `make_train_step` from the randomised state, on
    two rows of frames of which one is masked: (loss, state, model, params
    before)."""
    from argus_tpu_torch.train import make_train_step

    cfg, model, state = _port_state(model_kw, amp, seed)
    p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state, loss = make_train_step(model, cfg, device="cpu")(state, _step_batch(hw))
    return float(loss), state, model, p0


def argus_step(model_kw, amp, patch, seed=1, hw=32):
    """One step of argus_tpu's `make_train_step_body` from the same state:
    (loss, (count, mu, nu), params, running statistics)."""
    from argus_tpu.models import NCameraCNN as JaxNCameraCNN
    from argus_tpu.models import NCameraCNNConfig as JaxConfig
    from argus_tpu.train import TrainConfig as JaxTrainConfig
    from argus_tpu.train import TrainState as JaxTrainState
    from argus_tpu.train import make_optimizer as jax_make_optimizer
    from argus_tpu.train import make_train_step_body
    from argus_tpu_torch.models.jax_import import adam_moments_from_optax

    lr = LR
    _, model, _ = _port_state(model_kw, amp, seed)
    batch = _step_batch(hw)
    params, stats = variables_from_state_dict(model.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jcfg = JaxTrainConfig(model_config=JaxConfig(**model_kw), amp=amp, use_augmentation=False, learning_rate=lr,
                          wandb_log=False)
    jmodel = JaxNCameraCNN(dataclasses.replace(JaxConfig(**model_kw), dtype="bfloat16" if amp else "float32"))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                           opt_state=jax_make_optimizer(1.0).init(params), lr=jnp.asarray(lr, jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        patch(mp)
        jstate, jloss = jax.jit(make_train_step_body(jmodel, jcfg, 0))(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                                                                      batch))
    adam = jstate.opt_state[1]
    return (float(jloss), adam_moments_from_optax(adam.count, jax.device_get(adam.mu), jax.device_get(adam.nu)),
            state_dict_from_variables(jax.device_get(jstate.params), {}),
            state_dict_from_variables({}, jax.device_get(jstate.batch_stats)))


def step_pair(model_kw, amp, patch, seed=1, hw=32):
    """argus_tpu's step and the port's from one state."""
    return argus_step(model_kw, amp, patch, seed, hw), port_step(model_kw, amp, seed, hw)


def check_step(want, got, tol, stats_tol=None):
    """The loss, the moments and the params' update after one step within
    `tol` (`TOL[amp]`'s layout); with `stats_tol`, the running statistics'
    change too."""
    (w_loss, (_, w_mu, w_nu), w_params, w_stats), (loss, state, model, p0) = want, got
    assert abs(loss - w_loss) <= tol["loss"] * abs(w_loss), (loss, w_loss)
    _check_leaves(state.opt_state.mu, w_mu, tol["moments"][0], "mu")
    _check_leaves(state.opt_state.nu, w_nu, tol["moments"][0], "nu")
    _check_leaves(model.state_dict(), w_params, tol["update"][0], "update", p0)
    if stats_tol is not None:
        assert all(not torch.equal(state.batch_stats[k], p0[k]) for k in w_stats)
        _check_leaves(state.batch_stats, w_stats, stats_tol, "batch_stats", p0)


P_MODEL = dict(n_cams=2, backbone="resnet50", resnet_output_dim=32, bn_frozen=True, bn_frozen_affine=True,
               stem_frozen=True, fuse_pointwise="on", fuse_block="off", fuse_proj="off", fuse_stem="off",
               fuse_stage="off")


def _pallas_pointwise(mp):
    _pallas_everywhere(mp)
    mp.setattr(jpw, "_use_pallas", lambda impl: impl != "xla")


@pytest.fixture(scope="module")
def p_reference():
    """argus_tpu's configuration-P step per dtype, its pointwise op as the
    Pallas kernel in interpret mode with `pallas`, else through its XLA
    route; computed once."""
    cache = {}

    def run(amp, pallas):
        if (amp, pallas) not in cache:
            cache[amp, pallas] = argus_step(P_MODEL, amp, _pallas_pointwise if pallas else lambda mp: None)
        return cache[amp, pallas]

    return run


def _spread(got: dict, want: dict, base=None):
    """(max, median) over leaves of |got - want| / |want - base|."""
    errs = sorted(
        ((got[k].detach().float() - w.float()).norm() / (w.float() - (0 if base is None else base[k].float())).norm()
         ).item()
        for k, w in want.items() if torch.count_nonzero(w.float() - (0 if base is None else base[k].float())))
    return errs[-1], errs[len(errs) // 2]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_pointwise_step_matches_argus_tpu(p_reference, monkeypatch, amp):
    """Configuration P: every bottleneck's Conv_0 and Conv_2 through the
    pointwise op (32 calls each way), the rest folded (C3). f32 within
    `TOL`. bf16: the port's unfused convs round once after the folded
    bias where argus_tpu's round after each of four BN ops, so each is
    held to argus_tpu's f32 step: the port's bf16 moments and update no
    farther from it than argus_tpu's bf16 ones (max and median over leaves,
    with 1.25x slack), the loss within `TOL` of argus_tpu's bf16 loss.
    f32 against argus_tpu's Pallas kernel in interpret mode; bf16 against
    its XLA route, argus_tpu's f32 step included. Measured at 32x32, max /
    median over leaves of the distance from argus_tpu's f32 step: mu 0.198
    / 0.104 (port) against 0.605 / 0.102 (argus_tpu's bf16), nu 0.272 /
    0.099 against 0.689 / 0.093, update 0.493 / 0.346 against 0.761 /
    0.358; the same on both routes, whose argus_tpu steps (f32 and bf16)
    agree bit for bit at this size, so the XLA route leaves the limit
    where the Pallas route put it."""
    calls = []
    fwd = tpw._FWD["kernel"]
    monkeypatch.setitem(tpw._FWD, "kernel", lambda *a: calls.append(1) or fwd(*a))
    got = port_step(P_MODEL, amp)
    assert len(calls) == 32  # 16 blocks x (Conv_0, Conv_2), one step
    want = p_reference(amp, pallas=not amp)
    if not amp:
        check_step(want, got, TOL[amp])
        return
    loss, state, model, p0 = got
    assert abs(loss - want[0]) <= TOL[True]["loss"] * abs(want[0]), (loss, want[0])
    ref = p_reference(False, pallas=False)
    for what, port, argus, f32, base in (
        ("mu", state.opt_state.mu, want[1][1], ref[1][1], None),
        ("nu", state.opt_state.nu, want[1][2], ref[1][2], None),
        ("update", model.state_dict(), want[2], ref[2], p0),
    ):
        mine, theirs = _spread(port, f32, base), _spread(argus, f32, base)
        assert mine[0] <= 1.25 * theirs[0] and mine[1] <= 1.25 * theirs[1], (what, mine, theirs)


def test_folded_unfused_step_matches_argus_tpu():
    """C3 in a step: a frozen-BN step with every kernel off (f32), the stem
    and every block on folded weights, against argus_tpu's unfolded BN.
    ResNet-18 (the keypoint family's backbone, BasicBlocks); configuration
    P's step folds the bottleneck's Conv_1, shortcut and stem."""
    model = {**P_MODEL, "backbone": "resnet18", "fuse_pointwise": "off"}
    want, got = step_pair(model, False, lambda mp: None)
    check_step(want, got, TOL[False])
