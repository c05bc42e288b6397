"""Wrappers of the CUDA voxelization kernels (sv3d_tpu_torch/csrc/voxelize.cu).

scatter_voxels_cuda replaces sv3d_tpu/ops/pallas/voxelize.py::scatter_voxels_pallas
and is differentiable in the points, as the JAX function's custom VJP is: an
autograd.Function whose forward runs the scatter (K1) and keeps the raw,
unclamped grid, and whose backward runs the gather kernel K1b (the XLA
_scatter_bwd of the JAX package).  The plain versions are
sv3d_tpu_torch.ops.voxelize.scatter_voxels_raw and scatter_voxels_bwd; a CPU
tensor runs them, a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.voxelize import scatter_voxels, scatter_voxels_bwd, scatter_voxels_raw

__all__ = ["scatter_voxels", "scatter_voxels_cuda", "scatter_voxels_raw_cuda",
           "scatter_voxels_bwd_cuda"]


@functools.lru_cache(maxsize=None)
def _bind(name: str, n_ptr: int):
    fn = getattr(build.load(), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _bounds(eps: float):
    return -0.5 + eps, 0.5 - eps


def _check_points(points: torch.Tensor, dims: tuple, who: str) -> None:
    if points.dtype != torch.float32:
        raise TypeError(f"{who}: points must be float32, got {points.dtype}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"{who}: points must be (B, N, 3), got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError(f"{who}: points must be contiguous")
    if len(dims) != 3 or min(dims) < 1:
        raise ValueError(f"{who}: bad dims {dims}")


def _device_of(t: torch.Tensor, who: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {t.device}")
    return t.device.type


def scatter_voxels_raw_cuda(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """K1: the unclamped trilinear scatter (B, *dims); same contract as
    scatter_voxels_raw, which a CPU tensor runs."""
    dims = tuple(int(d) for d in dims)
    if _device_of(points, "scatter_voxels") == "cpu":
        return scatter_voxels_raw(points, dims, eps)
    _check_points(points, dims, "scatter_voxels")
    b, n, _ = points.shape
    grid = torch.zeros((b, *dims), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _bind("sv3d_scatter_voxels", 2)(
        points.data_ptr(), grid.data_ptr(), b, n, *dims, *_bounds(eps), stream,
    )
    build.check(rc, "sv3d_scatter_voxels")
    scatter_voxels_cuda.launches += 1
    return grid


def scatter_voxels_bwd_cuda(points: torch.Tensor, raw: torch.Tensor, grad: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """K1b: gradient (B, N, 3) of clamp(raw) in the points; same contract as
    scatter_voxels_bwd, which a CPU tensor runs."""
    if _device_of(points, "scatter_voxels_bwd") == "cpu":
        return scatter_voxels_bwd(points, raw, grad, eps)
    dims = tuple(int(d) for d in raw.shape[1:])
    _check_points(points, dims, "scatter_voxels_bwd")
    b, n, _ = points.shape
    for name, t in (("raw", raw), ("grad", grad)):
        if t.device != points.device or t.dtype != torch.float32 or tuple(t.shape) != (b, *dims):
            raise ValueError(f"scatter_voxels_bwd: {name} must be float32 (B, *dims) on the "
                             f"points' device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    raw, grad = raw.contiguous(), grad.contiguous()
    out = torch.empty((b, n, 3), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _bind("sv3d_scatter_voxels_bwd", 4)(
        points.data_ptr(), raw.data_ptr(), grad.data_ptr(), out.data_ptr(), b, n, *dims,
        *_bounds(eps), stream,
    )
    build.check(rc, "sv3d_scatter_voxels_bwd")
    scatter_voxels_bwd_cuda.launches += 1
    return out


class _ScatterVoxels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, dims, eps):
        raw = scatter_voxels_raw_cuda(points, dims, eps)
        ctx.save_for_backward(points, raw)
        ctx.eps = eps
        return raw.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, grad):
        points, raw = ctx.saved_tensors
        return scatter_voxels_bwd_cuda(points, raw, grad, ctx.eps), None, None


def scatter_voxels_cuda(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """Trilinear scatter of (B, N, 3) normed points into a (B, *dims) grid
    clamped to [0, 1], differentiable in the points; same contract as
    scatter_voxels.  K1 forward, K1b backward on a CUDA tensor."""
    return _ScatterVoxels.apply(points.contiguous(), tuple(int(d) for d in dims), float(eps))


scatter_voxels_cuda.launches = 0
scatter_voxels_bwd_cuda.launches = 0
