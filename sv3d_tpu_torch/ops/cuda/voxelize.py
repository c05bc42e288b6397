"""Wrapper of the CUDA voxelization kernel (sv3d_tpu_torch/csrc/voxelize.cu).

Replaces sv3d_tpu/ops/pallas/voxelize.py::scatter_voxels_pallas.  The plain
version is sv3d_tpu_torch.ops.voxelize.scatter_voxels (index_add_ on the flat
grid); a CPU tensor runs it, a CUDA tensor launches the kernel or raises.
Forward only: the gather backward comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.voxelize import scatter_voxels

__all__ = ["scatter_voxels", "scatter_voxels_cuda"]


def _bind():
    fn = build.load().sv3d_scatter_voxels
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def scatter_voxels_cuda(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """Trilinear scatter of (B, N, 3) normed points into a (B, *dims) grid
    clamped to [0, 1]; same contract as scatter_voxels."""
    dims = tuple(int(d) for d in dims)
    if points.device.type == "cpu":
        return scatter_voxels(points, dims, eps)
    if points.device.type != "cuda":
        raise ValueError(f"scatter_voxels_cuda: unsupported device {points.device}")
    if points.requires_grad:
        raise NotImplementedError(
            "scatter_voxels_cuda is forward-only; run serving under "
            "torch.inference_mode() (the backward comes with training)"
        )
    if points.dtype != torch.float32:
        raise TypeError(f"scatter_voxels_cuda: points must be float32, got {points.dtype}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"scatter_voxels_cuda: points must be (B, N, 3), got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("scatter_voxels_cuda: points must be contiguous")
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"scatter_voxels_cuda: bad dims {dims}")
    b, n, _ = points.shape
    grid = torch.zeros((b, *dims), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _bind()(
        points.data_ptr(), grid.data_ptr(), b, n, *dims,
        -0.5 + eps, 0.5 - eps, stream,
    )
    build.check(rc, "sv3d_scatter_voxels")
    scatter_voxels_cuda.launches += 1
    return grid.clamp_(0.0, 1.0)


scatter_voxels_cuda.launches = 0
