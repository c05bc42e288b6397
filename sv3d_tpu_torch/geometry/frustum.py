"""View-frustum voxel volume construction (numpy; a copy of
sv3d_tpu/geometry/frustum.py against this package's Intrinsics).

All of this is static host-side setup: the frustum depends only on the
intrinsics, image size, depth range and voxel size, so it is computed once in
numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sv3d_tpu_torch.geometry.camera import Intrinsics


def generate_frustum(
    image_size: tuple, intrinsic_inv: np.ndarray, depth_min: float, depth_max: float
) -> np.ndarray:
    """8 corner points of the view frustum in camera space.

    image_size is (width, height); corners are the 4 image corners scaled by
    depth_min and depth_max, unprojected through the inverse intrinsics
    (reference model/projection.py:165-179).
    """
    x, y = image_size
    corners = np.array(
        [
            [0, 0, 1, 0],
            [0, y, 1, 0],
            [x, y, 1, 0],
            [x, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    eight = np.concatenate(
        [
            corners * depth_min + np.array([0, 0, 0, 1.0]),
            corners * depth_max + np.array([0, 0, 0, 1.0]),
        ],
        axis=0,
    )
    # The reference builds rows [x*d, y*d, d, 1]; replicate that layout.
    eight[:4, 2] = depth_min
    eight[4:, 2] = depth_max
    frustum = (intrinsic_inv @ eight.T).T
    return frustum[:, :3]


def generate_frustum_volume(frustum: np.ndarray, voxel_size: float):
    """Voxel dims + camera->frustum-grid transform for a frustum point set
    (reference model/projection.py:181-198)."""
    mins = frustum.min(axis=0) / voxel_size
    maxs = frustum.max(axis=0) / voxel_size
    dims = tuple(int(d) for d in np.ceil(maxs - mins))
    camera2frustum = np.array(
        [
            [1.0 / voxel_size, 0, 0, -mins[0]],
            [0, 1.0 / voxel_size, 0, -mins[1]],
            [0, 0, 1.0 / voxel_size, -mins[2]],
            [0, 0, 0, 1.0],
        ],
        dtype=np.float32,
    )
    return dims, camera2frustum


@dataclass(frozen=True)
class FrustumGrid:
    """Precomputed frustum voxel grid: dims + camera->grid transform.

    The canonical object the rest of the framework uses for back-projection;
    constructed once per (intrinsics, image size, depth range, voxel size).
    """

    dims: tuple
    camera2frustum: tuple  # 4x4 nested tuple (hashable / static)
    voxel_size: float

    @staticmethod
    def create(
        intrinsics: Intrinsics,
        image_size: tuple = (320, 240),
        depth_min: float = 0.4,
        depth_max: float = 6.0,
        voxel_size: float = 0.05,
    ) -> "FrustumGrid":
        frustum = generate_frustum(image_size, intrinsics.inverse, depth_min, depth_max)
        dims, c2f = generate_frustum_volume(frustum, voxel_size)
        return FrustumGrid(
            dims=dims,
            camera2frustum=tuple(tuple(float(v) for v in row) for row in c2f),
            voxel_size=voxel_size,
        )

    @property
    def matrix(self) -> np.ndarray:
        return np.asarray(self.camera2frustum, dtype=np.float32)
