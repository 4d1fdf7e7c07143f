"""Augmentation preview of the PyTorch port: write augmented dataset samples
to disk for eyeballing (the twin of `scripts/view_augmentations.py`, on
`argus_tpu_torch.ops.augment`).

Saves side-by-side strips [cam1 raw | cam1 augmented | cam2 raw | cam2
augmented], one PNG per example, so the augmentation distribution can be
inspected. On the card the stack runs as the fused kernel, on the CPU as
the per-op path.

    python scripts/view_augmentations_torch.py --dataset-path outputs/data/cube_unity_data
"""

import os
import sys
from dataclasses import dataclass, field

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from argus_tpu_torch import ROOT  # noqa: E402
from argus_tpu_torch.ops.augment import AugmentationConfig  # noqa: E402


@dataclass
class ViewConfig:
    dataset_path: str
    augmentation_config: AugmentationConfig = field(default_factory=AugmentationConfig)
    n_examples: int = 8
    seed: int = 0
    output_dir: str = os.path.join(ROOT, "outputs", "augmentation_previews")
    device: str = "cuda"


def main(cfg: ViewConfig) -> None:
    import torch
    from PIL import Image

    from argus_tpu_torch import resolve_device
    from argus_tpu_torch.data import CameraCubePoseDataset, CameraCubePoseDatasetConfig
    from argus_tpu_torch.ops.augment import apply_augmentation
    from argus_tpu_torch.ops.image import u8_to_f32

    device = resolve_device(cfg.device)
    dataset = CameraCubePoseDataset(CameraCubePoseDatasetConfig(cfg.dataset_path), train=True)
    os.makedirs(cfg.output_dir, exist_ok=True)

    n = min(cfg.n_examples, len(dataset))
    raw = dataset.load_images_batch(list(range(n)))  # (n, H, W, 3 * n_cams)
    images = u8_to_f32(torch.from_numpy(np.ascontiguousarray(raw)).to(device))
    augmented = apply_augmentation(cfg.augmentation_config, cfg.seed, images, n_cams=dataset.n_cams)
    aug_np = (augmented.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()

    for i in range(n):
        panels = []
        for cam in range(dataset.n_cams):
            panels.append(raw[i, :, :, 3 * cam : 3 * cam + 3])
            panels.append(aug_np[i, :, :, 3 * cam : 3 * cam + 3])
        Image.fromarray(np.concatenate(panels, axis=1)).save(os.path.join(cfg.output_dir, f"preview_{i}.png"))
    print(f"wrote {n} previews to {cfg.output_dir}")


if __name__ == "__main__":
    from argus_tpu_torch.configs import cli

    main(cli(ViewConfig))
