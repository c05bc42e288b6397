"""Depth point cloud -> smoothed voxel occupancy (port of
sv3d_tpu/models/projection.py).

Trilinear scatter, then a separable Gaussian blur whose per-axis sigma is a
learnable parameter.  The scatter runs the hand-written CUDA kernel for a
CUDA tensor and the plain torch scatter for a CPU tensor, as the JAX module
picks its Pallas kernel on the TPU backend.
"""

from __future__ import annotations

import torch
from torch import nn

from sv3d_tpu_torch.config import ProjectionConfig
from sv3d_tpu_torch.ops.voxelize import voxelize


class Projection(nn.Module):
    def __init__(self, config: ProjectionConfig = ProjectionConfig(), device=None):
        super().__init__()
        self.config = config
        self.sigma = nn.Parameter(
            torch.tensor(config.init_sigma, dtype=torch.float32, device=device)
        )

    def forward(self, point_cloud: torch.Tensor) -> torch.Tensor:
        """point_cloud: (B, N, 3) in normed grid space [-0.5, 0.5] ->
        (B, D0, D1, D2, 1) smoothed occupancy grid in [0, 1]."""
        return voxelize(point_cloud, self.config.dims, self.sigma, self.config.kernel_size)
