"""The data path of the port: the HDF5 + PNG dataset, the host loader,
the synthetic dataset writer, the streaming render feed (`data.streaming`),
the device feed (`data.feed`) and the device-resident split
(`data.resident`).

The host decodes PNGs (or takes rendered frames straight from a render
source), crops, batches, shards and prefetches uint8 batches, or uploads
the whole split (or shards of it) once; the card converts them to float
and augments them inside the train step.
"""

from argus_tpu_torch.data.dataset import CameraCubePoseDataset, CameraCubePoseDatasetConfig, HostDataLoader
from argus_tpu_torch.data.feed import device_prefetch
from argus_tpu_torch.data.resident import DeviceResidentData, ResidentShardedData
from argus_tpu_torch.data.streaming import StreamingRenderLoader
from argus_tpu_torch.data.synthetic import write_synthetic_dataset

__all__ = [
    "CameraCubePoseDataset",
    "CameraCubePoseDatasetConfig",
    "DeviceResidentData",
    "HostDataLoader",
    "ResidentShardedData",
    "StreamingRenderLoader",
    "device_prefetch",
    "write_synthetic_dataset",
]
