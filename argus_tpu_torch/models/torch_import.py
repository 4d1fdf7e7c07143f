"""torchvision ResNet weights -> the port's ResNet backbones.

Port of `argus_tpu/models/torch_import.py`. The reference initialises its
backbone from torchvision's ImageNet-pretrained ResNet-50; a user with a
torchvision checkpoint (`resnet50-*.pth`, or any `state_dict` of
`torchvision.models.resnet*`) loads it with `load_torch_resnet`. Nothing
is downloaded.

The port's modules carry flax's scope names, and both sides keep conv
weights as OIHW, so the translation renames keys and transposes nothing:

    conv1.weight                  -> conv_init.weight
    bn1.{weight,bias,running_*}   -> norm_init.*
    layer{L}.{B}.conv{k}.weight   -> stage{L-1}_block{B}.Conv_{k-1}.weight
    layer{L}.{B}.bn{k}.*          -> stage{L-1}_block{B}.BatchNorm_{k-1}.*
    layer{L}.{B}.downsample.0/1.* -> stage{L-1}_block{B}.conv_proj / norm_proj.*
    fc.*, *.num_batches_tracked   -> not imported (the classifier is replaced
                                     by the model's own projection)

Under `stem_space_to_depth` the 7x7 stem is rewritten losslessly into the
4x4 kernel over 2x2 space-to-depth input (`conv1_kernel_to_s2d`). A key
with no destination raises `KeyError`, a shape that differs `ValueError`,
and an import of no parameter `ValueError`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Union

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def conv1_kernel_to_s2d(k7: torch.Tensor) -> torch.Tensor:
    """A (Cout, Cin, 7, 7) stride-2 stem kernel -> the equivalent (Cout,
    4 Cin, 4, 4) stride-1 kernel over 2x2 space-to-depth input.

    The kernel is zero-padded to 8x8 with the pad row and column first (so
    the window offsets become [-4, 3] and padding ((2, 1), (2, 1))
    reproduces the 7x7's padding of 3), then each spatial index a = 2 alpha
    + d is split into (alpha, d) with d folded into the input channels in
    space-to-depth's (dy, dx, c) order."""
    cout, cin, kh, kw = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the stem kernel is 7x7, not {kh}x{kw}")
    k8 = k7.new_zeros(cout, cin, 8, 8)
    k8[:, :, 1:, 1:] = k7
    # (o, c, ay, dy, ax, dx) -> (o, dy, dx, c, ay, ax)
    k = k8.reshape(cout, cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k.reshape(cout, 4 * cin, 4, 4).contiguous()


def _bn_key(prefix: str, leaf: str, key: str) -> str:
    if leaf not in _BN_LEAVES:
        raise KeyError(f"torchvision key {key} has no destination in the port's BatchNorm")
    return f"{prefix}.{leaf}"


def translate_torch_resnet_state_dict(state_dict: Dict[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A torchvision ResNet `state_dict` -> {the port's ResNet key: f32 CPU
    tensor}, keys relative to the ResNet (no `backbone.` prefix), `fc.*`
    and BN's `num_batches_tracked` left out. A key of no ResNet layer
    torchvision has raises `KeyError`."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, value in state_dict.items():
        parts = key.split(".")
        if parts[0] == "fc" or parts[-1] == "num_batches_tracked":
            continue
        v = torch.as_tensor(value).detach().to("cpu", torch.float32)
        if key == "conv1.weight":
            out["conv_init.weight"] = v
        elif parts[0] == "bn1" and len(parts) == 2:
            out[_bn_key("norm_init", parts[1], key)] = v
        elif parts[0].startswith("layer") and len(parts) >= 4:
            blk = f"stage{int(parts[0][5:]) - 1}_block{int(parts[1])}"
            mod = parts[2]
            if mod.startswith("conv") and parts[3:] == ["weight"]:
                out[f"{blk}.Conv_{int(mod[4:]) - 1}.weight"] = v
            elif mod.startswith("bn") and len(parts) == 4:
                out[_bn_key(f"{blk}.BatchNorm_{int(mod[2:]) - 1}", parts[3], key)] = v
            elif mod == "downsample" and parts[3:] == ["0", "weight"]:
                out[f"{blk}.conv_proj.weight"] = v
            elif mod == "downsample" and parts[3] == "1" and len(parts) == 5:
                out[_bn_key(f"{blk}.norm_proj", parts[4], key)] = v
            else:
                raise KeyError(f"torchvision key {key} has no destination in the port's ResNet")
        else:
            raise KeyError(f"torchvision key {key} has no destination in the port's ResNet")
    return out


def load_torch_resnet(
    path_or_state_dict: Union[str, bytes, Dict[str, torch.Tensor]],
    model_or_state_dict: Union[torch.nn.Module, Dict[str, torch.Tensor]],
    backbone_scope: str = "backbone",
) -> "OrderedDict[str, torch.Tensor]":
    """torchvision ResNet weights loaded into the weights of an NCameraCNN
    (or, with `backbone_scope` None or "", a bare ResNet). Returns a NEW
    state_dict, the model's own with the backbone's weights replaced (each
    on its tensor's device and in its dtype); `model.load_state_dict` takes
    it.

    `path_or_state_dict` is a `.pth` path (loaded with `weights_only=True`
    on the CPU) or a state_dict already loaded; `model_or_state_dict` a
    module or its state_dict."""
    if isinstance(path_or_state_dict, (str, bytes)):
        state_dict = torch.load(path_or_state_dict, map_location="cpu", weights_only=True)
    else:
        state_dict = path_or_state_dict
    target = model_or_state_dict
    if isinstance(target, torch.nn.Module):
        target = target.state_dict()
    new = OrderedDict((k, v.detach().clone()) for k, v in target.items())
    prefix = f"{backbone_scope}." if backbone_scope else ""

    weights = translate_torch_resnet_state_dict(state_dict)
    # space-to-depth stem: the 7x7 kernel rewritten losslessly
    if f"{prefix}conv_init_s2d.weight" in new and "conv_init.weight" in weights:
        weights["conv_init_s2d.weight"] = conv1_kernel_to_s2d(weights.pop("conv_init.weight"))

    n_params = 0
    for key, v in weights.items():
        dst = prefix + key
        if dst not in new:
            raise KeyError(f"imported weight {key} has no destination {dst} in the model")
        if tuple(new[dst].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {dst}: model {tuple(new[dst].shape)} vs torch {tuple(v.shape)}")
        new[dst] = v.to(new[dst].device, new[dst].dtype)
        n_params += not key.endswith(("running_mean", "running_var"))
    if n_params == 0:
        raise ValueError("no parameters were imported: wrong state_dict?")
    return new
