"""Sanity script: overfit a small model to random SE(3) targets with the
geodesic loss (the twin of `scripts/rotation_overfitting.py`, on
`argus_tpu_torch`).

Two modes:
  * `--mode mlp`    - an MLP from 3-d inputs to se(3);
  * `--mode resnet` - the port's ResNet-18 from random 32x32 images (BN on
    its running statistics, as the original's flax apply without `train`).

Both train with Adam on `train.geometric_loss_fn` (flax's initialisers:
lecun-normal kernels, zero biases). If the loss does not collapse toward 0,
the geodesic loss / SE(3) Exp chain is broken.
"""

import os
import sys
from dataclasses import dataclass

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class OverfitConfig:
    mode: str = "mlp"  # "mlp" | "resnet"
    num_examples: int = 100
    n_iters: int = 2000
    lr: float = 1e-3
    print_every: int = 100
    seed: int = 0
    device: str = "cuda"


def main(cfg: OverfitConfig) -> float:
    import torch
    from torch import nn

    from argus_tpu_torch import geom, resolve_device
    from argus_tpu_torch.models.resnet import lecun_normal_, resnet18
    from argus_tpu_torch.train import _init_, geometric_loss_fn

    device = resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    targets = geom.random_SE3(gen, (cfg.num_examples,)).to(device)

    if cfg.mode == "mlp":
        layers = []
        for cin in (3, 256, 256, 256):
            layers += [nn.Linear(cin, 256), nn.ReLU()]
        model = nn.Sequential(*layers, nn.Linear(256, 6))
        for mod in model:
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, gen)
                nn.init.zeros_(mod.bias)
        x = torch.rand(cfg.num_examples, 3, generator=gen)
        forward = model
    elif cfg.mode == "resnet":
        model = resnet18(output_dim=6)
        _init_(model, gen)
        x = torch.rand(cfg.num_examples, 32, 32, 3, generator=gen)

        def forward(images):
            return model(images, train=False)
    else:
        raise ValueError(f"unknown mode {cfg.mode}")

    model.to(device)
    x = x.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    loss = None
    for i in range(cfg.n_iters):
        opt.zero_grad(set_to_none=True)
        loss = geometric_loss_fn(forward(x), targets).mean()
        loss.backward()
        opt.step()
        if i % cfg.print_every == 0:
            print(f"Iteration {i}, Loss: {loss.item():.6f}")
    print(f"Final loss: {loss.item():.6f}")
    return loss.item()


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    main(cli(OverfitConfig))
