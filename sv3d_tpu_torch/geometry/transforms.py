"""Grid-space coordinate transforms (port of sv3d_tpu/geometry/transforms.py).

"grid space" is continuous voxel-index coordinates in [0, dims[i]] along grid
axis i; "normed grid space" centers and scales it to [-0.5, 0.5]^3.  Point
coordinate order always equals grid axis order: points[..., i] addresses grid
axis i, with no axis swap anywhere.
"""

from __future__ import annotations

import torch

from sv3d_tpu_torch.geometry.camera import Intrinsics, depth_to_camera
from sv3d_tpu_torch.geometry.frustum import FrustumGrid


def depthmap_to_gridspace(
    depthmap: torch.Tensor, intrinsics: Intrinsics, grid: FrustumGrid
) -> torch.Tensor:
    """Back-project depth maps into frustum-grid-space points.

    depthmap: (B, H, W) -> (B, H*W, 3) points in grid space."""
    pts = depth_to_camera(depthmap, intrinsics.focal_length, intrinsics.cx, intrinsics.cy)
    # The camera->frustum transform is an axis-aligned scale + shift; apply it
    # elementwise in f32, as the JAX package does, so the rounding matches it
    # exactly (a 4x4 matmul would sum in another order).
    c2f = grid.matrix
    kw = dict(dtype=depthmap.dtype, device=depthmap.device)
    scale = torch.tensor([c2f[0, 0], c2f[1, 1], c2f[2, 2]], **kw)
    shift = torch.tensor(c2f[:3, 3], **kw)
    return pts * scale + shift


def norm_grid_space(pc: torch.Tensor, dims) -> torch.Tensor:
    """Grid space -> [-0.5, 0.5]^3."""
    d = torch.tensor(dims, dtype=pc.dtype, device=pc.device)
    return (pc - d / 2.0) / d


def unnorm_grid_space(pc: torch.Tensor, dims) -> torch.Tensor:
    """[-0.5, 0.5]^3 -> grid space."""
    d = torch.tensor(dims, dtype=pc.dtype, device=pc.device)
    return pc * d + d / 2.0


def make_3d_grid(bb_min, bb_max, shape, res_increase: int = 1, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Dense lattice of query points over a bounding box: (prod(shape) *
    res_increase^3, 3) points whose coordinate i is linspace(bb_min[i],
    bb_max[i], shape[i] * res_increase), row-major over (axis0, axis1,
    axis2) (reference model/ifnet.py:202-212)."""
    axes = [torch.linspace(float(bb_min[i]), float(bb_max[i]), int(shape[i]) * res_increase,
                           device=device, dtype=dtype) for i in range(3)]
    g0, g1, g2 = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([g0.reshape(-1), g1.reshape(-1), g2.reshape(-1)], dim=1)
