"""Plain torch ops of the port (the names of sv3d_tpu/ops); the
hand-written kernels and their wrappers live in sv3d_tpu_torch.ops.cuda."""

from sv3d_tpu_torch.ops.grid_sample import (
    Pyramid,
    displacement_axes,
    flatten_grid,
    sample_trilinear,
    sample_trilinear_flat,
)
from sv3d_tpu_torch.ops.lattice import axis_matrices, interp_matrix, resize_volume_cm
from sv3d_tpu_torch.ops.voxelize import (
    gaussian_kernels_1d,
    scatter_voxels,
    smooth_voxels,
    voxelize,
)

__all__ = [
    "Pyramid",
    "sample_trilinear",
    "sample_trilinear_flat",
    "flatten_grid",
    "displacement_axes",
    "interp_matrix",
    "axis_matrices",
    "resize_volume_cm",
    "scatter_voxels",
    "smooth_voxels",
    "voxelize",
    "gaussian_kernels_1d",
]
