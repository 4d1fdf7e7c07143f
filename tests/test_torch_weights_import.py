"""torchvision weight import of the port (`argus_tpu_torch.models.
torch_import`) against argus_tpu's (`argus_tpu/models/torch_import.py`):
the same weights through the weight bridge, bit for bit, for both stems;
the same errors; the imported ResNet's pooled features against torchvision's
forward rebuilt from `torch.nn.functional`; and `pose_cnn.init_model`'s
weights against argus_tpu's `init_model`."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from argus_tpu.models.torch_import import load_torch_resnet as jax_load
from argus_tpu_torch.models.jax_import import state_dict_from_variables, variables_from_state_dict
from argus_tpu_torch.models.resnet import BACKBONES
from argus_tpu_torch.models.torch_import import conv1_kernel_to_s2d, load_torch_resnet, \
    translate_torch_resnet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The suite's workers share the machine's cores; more torch threads
    each only oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _twin():
    spec = importlib.util.spec_from_file_location(
        "verify_torch_import_torch", os.path.join(REPO, "scripts", "verify_torch_import_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


verify = _twin()


def _bare(backbone, s2d, nf=16):
    return BACKBONES[backbone](output_dim=None, num_filters=nf, stem_space_to_depth=s2d)


@pytest.mark.parametrize("s2d", [False, True], ids=["stem7x7", "s2d"])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_import_equals_argus_tpus_through_the_bridge(backbone, s2d):
    sd = verify.synthetic_state_dict(backbone, seed=1, num_filters=16)
    model = _bare(backbone, s2d)
    target = model.state_dict()
    ours = load_torch_resnet(sd, target, backbone_scope="")
    params, stats = variables_from_state_dict(target)
    new = jax_load(sd, {"params": params, "batch_stats": stats}, backbone_scope="")
    theirs = state_dict_from_variables(new["params"], new["batch_stats"], reference=target)
    assert list(ours) == list(target) and set(theirs) == set(ours)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype == torch.float32, k
        assert torch.equal(ours[k], theirs[k]), k
    stem = "conv_init_s2d.weight" if s2d else "conv_init.weight"
    assert not torch.equal(ours[stem], target[stem])  # the stem was imported, not left at init


def test_import_into_ncameracnn_backbone(tmp_path):
    from argus_tpu_torch.models import NCameraCNN, NCameraCNNConfig

    sd = verify.synthetic_state_dict("resnet18", seed=2)
    model = NCameraCNN(NCameraCNNConfig(backbone="resnet18", resnet_output_dim=16))
    before = model.state_dict()
    torch.save(sd, tmp_path / "resnet18.pth")
    new = load_torch_resnet(str(tmp_path / "resnet18.pth"), model)  # a .pth, loaded with weights_only
    assert all(torch.equal(new[k], v) for k, v in load_torch_resnet(sd, before).items())
    assert list(new) == list(before)
    assert torch.equal(new["backbone.stage3_block1.BatchNorm_1.running_var"], sd["layer4.1.bn2.running_var"])
    for k in ("backbone.fc.weight", "head_fc1.weight", "head_out.bias"):
        assert torch.equal(new[k], before[k]), k  # the classifier and head stay the model's
    assert new["backbone.conv_init.weight"] is not sd["conv1.weight"]
    model.load_state_dict(new)


def test_errors_match_argus_tpu():
    sd = verify.synthetic_state_dict("resnet18", seed=3, num_filters=16)
    target = _bare("resnet18", False).state_dict()
    params, stats = variables_from_state_dict(target)
    variables = {"params": params, "batch_stats": stats}
    stray = dict(sd, **{"layer4.2.conv1.weight": torch.zeros(128, 128, 3, 3)})
    bad_shape = dict(sd, **{"layer1.0.conv1.weight": torch.zeros(16, 16, 1, 1)})
    for load, dst in ((jax_load, variables), (load_torch_resnet, target)):
        with pytest.raises(KeyError, match="stage3_block2"):
            load(stray, dst, backbone_scope="")
        with pytest.raises(ValueError, match="shape mismatch"):
            load(bad_shape, dst, backbone_scope="")
        with pytest.raises(ValueError, match="no parameters were imported"):
            load({}, dst, backbone_scope="")
    # a key of no torchvision layer is refused, not skipped
    with pytest.raises(KeyError, match="no destination"):
        translate_torch_resnet_state_dict(dict(sd, **{"head.weight": torch.zeros(3)}))
    with pytest.raises(KeyError, match="no destination"):
        translate_torch_resnet_state_dict(dict(sd, **{"layer1.0.bn1.scale": torch.zeros(16)}))


def test_s2d_kernel_equals_argus_tpus():
    from argus_tpu.models.resnet import conv1_kernel_to_s2d as jax_s2d

    k7 = torch.randn(16, 3, 7, 7, generator=torch.Generator().manual_seed(0))
    want = np.transpose(jax_s2d(np.transpose(k7.numpy(), (2, 3, 1, 0))), (3, 2, 0, 1))
    assert torch.equal(conv1_kernel_to_s2d(k7), torch.from_numpy(np.ascontiguousarray(want)))


@pytest.mark.parametrize("s2d", [False, True], ids=["stem7x7", "s2d"])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_pooled_features_match_torchvision_forward(backbone, s2d):
    sd = verify.synthetic_state_dict(backbone, seed=4, num_filters=16)
    model = _bare(backbone, s2d)
    model.load_state_dict(load_torch_resnet(sd, model, backbone_scope=""))
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32)
    want = verify.torch_reference_features(sd, x)
    got = verify.port_features(model, x, "cpu")
    assert got.shape == want.shape == (2, 16 * 8 * (4 if backbone == "resnet50" else 1))
    assert float(np.abs(got - want).max()) <= 2e-4


def test_init_model_matches_argus_tpus_tree():
    import jax

    from argus_tpu.models.pose_cnn import NCameraCNNConfig as JaxConfig
    from argus_tpu.models.pose_cnn import init_model as jax_init
    from argus_tpu_torch.models import NCameraCNNConfig
    from argus_tpu_torch.models.pose_cnn import init_model

    kw = dict(backbone="resnet18", resnet_output_dim=16)
    shapes = jax.eval_shape(lambda: jax_init(JaxConfig(**kw), jax.random.PRNGKey(0), 32, 32)[1])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = state_dict_from_variables(zeros["params"], zeros["batch_stats"])
    model = init_model(NCameraCNNConfig(**kw), 0, 32, 32, device="cpu")
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    # flax's initialisers: zero biases, the last BN scale of each block zero, drawn from the seed
    assert torch.count_nonzero(got["backbone.stage0_block0.BatchNorm_1.weight"]) == 0
    assert torch.count_nonzero(got["head_fc1.bias"]) == 0
    again = init_model(NCameraCNNConfig(**kw), torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = init_model(NCameraCNNConfig(**kw), 1, device="cpu").state_dict()
    assert not torch.equal(got["backbone.conv_init.weight"], other["backbone.conv_init.weight"])
