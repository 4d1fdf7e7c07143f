"""The host data path of the port: the HDF5 + PNG dataset, the host loader,
the synthetic dataset writer, and the device feed (`data.feed`).

The host decodes PNGs, crops, batches, shards and prefetches uint8 batches;
the card converts them to float and augments them inside the train step.
argus_tpu's device-resident data (`data/resident.py`) and its streaming
render loader are not ported yet (ROADMAP A11, A12).
"""

from argus_tpu_torch.data.dataset import CameraCubePoseDataset, CameraCubePoseDatasetConfig, HostDataLoader
from argus_tpu_torch.data.feed import device_prefetch
from argus_tpu_torch.data.synthetic import write_synthetic_dataset

__all__ = [
    "CameraCubePoseDataset",
    "CameraCubePoseDatasetConfig",
    "HostDataLoader",
    "device_prefetch",
    "write_synthetic_dataset",
]
