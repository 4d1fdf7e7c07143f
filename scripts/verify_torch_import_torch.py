"""Torchvision-weight fidelity check of the PyTorch port (the twin of
`scripts/verify_torch_import.py`, on `argus_tpu_torch`).

The reference initialises its backbone from torchvision's ImageNet-pretrained
ResNet-50; the port imports those weights with
`argus_tpu_torch.models.torch_import.load_torch_resnet`. This script proves
the import end to end for a user's `.pth`:

  1. torchvision's eval-mode forward is rebuilt from the state_dict alone
     with `torch.nn.functional` ops (stem conv7x7/s2/p3 -> bn -> relu ->
     maxpool3/s2/p1 -> the layers with v1.5 stride placement -> global
     average pool), on the CPU in f32; no torchvision install is needed;
  2. the same input runs through the port's ResNet carrying the imported
     weights, in f32 on `--device` (TF32 off);
  3. the pooled features must agree within `--tol` (absolute, 2e-4 by
     default).

Golden files keep argus_tpu's npz layout (the weights as argus_tpu's flax
variables, `var:params/...`, `var:batch_stats/...`), so a golden recorded by
either script checks under the other:
  --golden-out FILE   records the verified input, features and weights;
  --golden-check FILE runs only the port's side against a recording.

    python scripts/verify_torch_import_torch.py --pth ~/resnet50-11ad3fa6.pth --golden-out goldens/resnet50.npz
    python scripts/verify_torch_import_torch.py --golden-check goldens/resnet50.npz
    python scripts/verify_torch_import_torch.py --selftest --device cpu
"""

import contextlib
import json
import os
import sys
from dataclasses import dataclass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


@dataclass
class VerifyConfig:
    """torchvision -> port ResNet import verification.

    Fields:
        pth: path to a torchvision ResNet state_dict (.pth).
        selftest: use a synthetic torchvision-layout state_dict instead of a
            file (random weights: checks the translation, not ImageNet
            weights).
        selftest_backbone: resnet18|resnet34|resnet50|resnet101 for --selftest.
        height/width/batch/seed: fixed verification input.
        tol: max |port - torch| allowed on pooled features (f32).
        golden_out: record verified goldens (npz) for later re-checks.
        golden_check: verify the port's side against a golden recording.
        device: where the port's ResNet runs (the card unless "cpu").
    """

    pth: str = ""
    selftest: bool = False
    selftest_backbone: str = "resnet50"
    height: int = 64
    width: int = 64
    batch: int = 2
    seed: int = 0
    tol: float = 2e-4
    golden_out: str = ""
    golden_check: str = ""
    device: str = "cuda"


_STAGES = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}


def synthetic_state_dict(backbone: str, seed: int = 0, num_filters: int = 64):
    """Random-weight state_dict in torchvision's key layout (torchvision's
    widths at the default `num_filters`, each a multiple of it otherwise);
    the same draws as `scripts/verify_torch_import.py`'s at 64."""
    import torch

    g = torch.Generator().manual_seed(seed)
    stages = _STAGES[backbone]
    bottleneck = backbone in ("resnet50", "resnet101")
    sd = {}

    def conv(key, cout, cin, k):
        # small magnitudes: activations stay in a well-conditioned range
        sd[key] = torch.randn(cout, cin, k, k, generator=g) * (cin * k * k) ** -0.5

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = torch.randn(c, generator=g).abs() * 0.2 + 0.9
        sd[f"{prefix}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{prefix}.running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[f"{prefix}.running_var"] = torch.randn(c, generator=g).abs() * 0.2 + 0.9
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1)

    conv("conv1.weight", num_filters, 3, 7)
    bn("bn1", num_filters)
    widths = [num_filters * 2**i for i in range(4)]
    cin = num_filters
    for L, (n_blocks, w) in enumerate(zip(stages, widths), start=1):
        for B in range(n_blocks):
            pre = f"layer{L}.{B}"
            cout = 4 * w if bottleneck else w
            c_in_block = cin if B == 0 else cout
            if bottleneck:
                conv(f"{pre}.conv1.weight", w, c_in_block, 1)
                bn(f"{pre}.bn1", w)
                conv(f"{pre}.conv2.weight", w, w, 3)
                bn(f"{pre}.bn2", w)
                conv(f"{pre}.conv3.weight", cout, w, 1)
                bn(f"{pre}.bn3", cout)
            else:
                conv(f"{pre}.conv1.weight", w, c_in_block, 3)
                bn(f"{pre}.bn1", w)
                conv(f"{pre}.conv2.weight", w, w, 3)
                bn(f"{pre}.bn2", w)
            if B == 0 and c_in_block != cout:
                conv(f"{pre}.downsample.0.weight", cout, c_in_block, 1)
                bn(f"{pre}.downsample.1", cout)
        cin = 4 * w if bottleneck else w
    nf = 4 * widths[-1] if bottleneck else widths[-1]
    sd["fc.weight"] = torch.randn(1000, nf, generator=g)
    sd["fc.bias"] = torch.randn(1000, generator=g)
    return sd


def infer_backbone(sd) -> str:
    """The torchvision variant, from the state_dict's key structure."""
    bottleneck = "layer1.0.conv3.weight" in sd
    stages = []
    for L in (1, 2, 3, 4):
        B = 0
        while f"layer{L}.{B}.conv1.weight" in sd:
            B += 1
        stages.append(B)
    stages = tuple(stages)
    if stages == (2, 2, 2, 2) and not bottleneck:
        return "resnet18"
    if stages == (3, 4, 6, 3):
        return "resnet50" if bottleneck else "resnet34"
    if stages == (3, 4, 23, 3) and bottleneck:
        return "resnet101"
    raise ValueError(f"unrecognized ResNet layout: stages={stages} bottleneck={bottleneck}")


def torch_reference_features(sd, x_nchw):
    """Eval-mode forward of torchvision.models.resnet rebuilt from the
    state_dict alone (v1.5 stride placement: the stride on the Bottleneck's
    3x3), on the CPU in f32. Returns the pooled pre-fc features (N, C) as
    numpy."""
    import torch
    import torch.nn.functional as F

    sd = {k: torch.as_tensor(v).cpu() for k, v in sd.items()}

    def bn(t, p):
        return F.batch_norm(
            t, sd[f"{p}.running_mean"], sd[f"{p}.running_var"], sd[f"{p}.weight"], sd[f"{p}.bias"], False, 0.0, 1e-5,
        )

    with torch.no_grad():
        x = torch.as_tensor(x_nchw, dtype=torch.float32)
        x = F.relu(bn(F.conv2d(x, sd["conv1.weight"], stride=2, padding=3), "bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for L in (1, 2, 3, 4):
            B = 0
            while f"layer{L}.{B}.conv1.weight" in sd:
                pre = f"layer{L}.{B}"
                bottleneck = f"{pre}.conv3.weight" in sd
                stride = 2 if (L > 1 and B == 0) else 1
                identity = x
                if bottleneck:
                    out = F.relu(bn(F.conv2d(x, sd[f"{pre}.conv1.weight"]), f"{pre}.bn1"))
                    out = F.relu(bn(F.conv2d(out, sd[f"{pre}.conv2.weight"], stride=stride, padding=1), f"{pre}.bn2"))
                    out = bn(F.conv2d(out, sd[f"{pre}.conv3.weight"]), f"{pre}.bn3")
                else:
                    out = F.relu(bn(F.conv2d(x, sd[f"{pre}.conv1.weight"], stride=stride, padding=1), f"{pre}.bn1"))
                    out = bn(F.conv2d(out, sd[f"{pre}.conv2.weight"], padding=1), f"{pre}.bn2")
                if f"{pre}.downsample.0.weight" in sd:
                    identity = bn(F.conv2d(x, sd[f"{pre}.downsample.0.weight"], stride=stride), f"{pre}.downsample.1")
                x = F.relu(out + identity)
                B += 1
        return F.adaptive_avg_pool2d(x, 1).flatten(1).numpy()


@contextlib.contextmanager
def strict_f32():
    """TF32 off for cuDNN's convs and cuBLAS's matmuls inside the block
    (both default to TF32 on the card), restored after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def port_features(model, x_nchw, device):
    """Pooled features (N, C) as numpy from the port's bare ResNet `model`
    (f32) on `device`, TF32 off."""
    import torch

    model = model.to(device).eval()
    x = torch.as_tensor(np.transpose(x_nchw, (0, 2, 3, 1))).to(device)
    with strict_f32(), torch.no_grad():
        return model(x, train=False).float().cpu().numpy()


def translated_model(sd, backbone: str, stem_space_to_depth: bool = False):
    """The port's bare ResNet (no fc, f32, CPU) carrying the imported
    torchvision weights."""
    from argus_tpu_torch.models.resnet import BACKBONES
    from argus_tpu_torch.models.torch_import import load_torch_resnet

    model = BACKBONES[backbone](output_dim=None, stem_space_to_depth=stem_space_to_depth)
    model.load_state_dict(load_torch_resnet(sd, model, backbone_scope=""))
    return model


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def main(cfg: VerifyConfig) -> dict:
    from argus_tpu_torch import resolve_device
    from argus_tpu_torch.models.jax_import import state_dict_from_variables, variables_from_state_dict
    from argus_tpu_torch.models.resnet import BACKBONES

    device = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    hw = (cfg.height, cfg.width)

    if cfg.golden_check:
        with np.load(cfg.golden_check, allow_pickle=False) as z:
            backbone = str(z["backbone"])
            x = z["input"]
            want = z["features"]
            variables = _unflatten({k[4:]: z[k] for k in z.files if k.startswith("var:")})
        model = BACKBONES[backbone](output_dim=None)
        ref = model.state_dict()
        model.load_state_dict(state_dict_from_variables(variables["params"], variables["batch_stats"], reference=ref))
        got = port_features(model, x, device)
        max_diff = float(np.abs(got - want).max())
        result = {
            "mode": "golden-check", "backbone": backbone, "device": str(device),
            "max_abs_diff": max_diff, "tol": cfg.tol, "ok": max_diff <= cfg.tol,
        }
    else:
        if cfg.selftest:
            sd = synthetic_state_dict(cfg.selftest_backbone, cfg.seed)
        else:
            if not cfg.pth:
                raise SystemExit("need --pth FILE, --selftest, or --golden-check FILE")
            import torch

            sd = torch.load(cfg.pth, map_location="cpu", weights_only=True)
        backbone = infer_backbone(sd)
        x = rng.standard_normal((cfg.batch, 3, *hw)).astype(np.float32)
        want = torch_reference_features(sd, x)
        model = translated_model(sd, backbone)
        got = port_features(model, x, device)
        scale = float(np.abs(want).max()) or 1.0
        max_diff = float(np.abs(got - want).max())
        result = {
            "mode": "selftest" if cfg.selftest else "pth",
            "backbone": backbone,
            "device": str(device),
            "features": list(got.shape),
            "max_abs_diff": max_diff,
            "ref_feature_scale": scale,
            "tol": cfg.tol,
            "ok": max_diff <= cfg.tol,
        }
        if cfg.golden_out and result["ok"]:
            params, stats = variables_from_state_dict(model.cpu().state_dict())
            os.makedirs(os.path.dirname(cfg.golden_out) or ".", exist_ok=True)
            np.savez_compressed(
                cfg.golden_out,
                backbone=backbone, input=x, features=got,
                **{f"var:{k}": v for k, v in _flatten({"params": params, "batch_stats": stats}).items()},
            )
            result["golden_out"] = cfg.golden_out

    print(json.dumps(result))
    if not result["ok"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    main(cli(VerifyConfig))
