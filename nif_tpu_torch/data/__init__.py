"""Data containers (counterpart of ``nif_tpu/data``): the point-wise
container, the sharded point-wise and grouped streaming datasets (with the
native gather/permute reader of :mod:`.nifio`), and the device prefetch."""
from .point_wise_data import PointWiseData
from .prefetch import prefetch_to_device
from .sharded_dataset import GroupedDataset, ShardedDataset

__all__ = [
    "PointWiseData",
    "ShardedDataset",
    "GroupedDataset",
    "prefetch_to_device",
]
