"""Offline preprocessing and the host-side labelling that training needs
(the port's copies; it imports nothing of sv3d_tpu)."""

from sv3d_tpu_torch.preprocessing.occupancies import determine_occupancy, sample_points
from sv3d_tpu_torch.preprocessing.process_sample import process_sample, process_sample_pipeline
from sv3d_tpu_torch.preprocessing.waterproofing import (
    check_mesh_contains,
    implicit_waterproofing,
)

__all__ = [
    "check_mesh_contains",
    "implicit_waterproofing",
    "sample_points",
    "determine_occupancy",
    "process_sample",
    "process_sample_pipeline",
]
