"""Host-side data layer of the port: datasets, batching loader, split files
(copies of sv3d_tpu/data)."""

from sv3d_tpu_torch.data.datasets import DepthDataset, ImplicitDataset, SceneNetDataset
from sv3d_tpu_torch.data.loader import DataLoader, collate
from sv3d_tpu_torch.data.splits import read_split, split_path, write_split

__all__ = [
    "DataLoader",
    "DepthDataset",
    "ImplicitDataset",
    "SceneNetDataset",
    "collate",
    "read_split",
    "split_path",
    "write_split",
]
