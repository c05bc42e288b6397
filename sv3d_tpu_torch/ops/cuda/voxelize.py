"""Wrappers of the CUDA voxelization kernels (sv3d_tpu_torch/csrc/voxelize.cu).

scatter_voxels_cuda replaces sv3d_tpu/ops/pallas/voxelize.py::scatter_voxels_pallas
and is differentiable in the points, as the JAX function's custom VJP is: an
autograd.Function whose forward makes the clamped grid in one call into the
library (zeroing, scatter K1 and clamp, into one buffer) and keeps it, and
whose backward runs the gather kernel K1b (the XLA _scatter_bwd of the JAX
package) on it: the clamped grid carries the clamp's gradient mask as the
raw grid does.  The plain versions are sv3d_tpu_torch.ops.voxelize.
scatter_voxels_raw and scatter_voxels_bwd; a CPU tensor runs them, a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.voxelize import scatter_voxels, scatter_voxels_bwd, scatter_voxels_raw

__all__ = ["scatter_voxels", "scatter_voxels_cuda", "scatter_voxels_raw_cuda",
           "scatter_voxels_bwd_cuda"]

K1_TOL = 1e-5  # atomics sum in run-dependent order (csrc/voxelize.cu)
# K1b: the same f32 arithmetic in another summation order, 1e-5 of the plain
# result's largest magnitude (K4, K7 and K8 alike: point_query.py)
K1B_RTOL = 1e-5

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    # points, grid, batch, n, d0, d1, d2, lo, hi, clamp, stream
    "sv3d_scatter_voxels": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    # points, grid, grad, out, batch, n, d0, d1, d2, grad's 4 strides, lo, hi,
    # stream
    "sv3d_scatter_voxels_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _F, _F, _P],
}


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    fn = getattr(build.load(), name)
    fn.argtypes = _ARGTYPES[name]
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


def _scatter_cuda(points: torch.Tensor, dims: tuple, eps: float, clamp: bool) -> torch.Tensor:
    """K1 on a CUDA tensor: one library call zeroes one (B, *dims) grid,
    scatters into it and, with clamp, clamps it to [0, 1] in place."""
    _check_points(points, dims, "scatter_voxels")
    b, n, _ = points.shape
    grid = torch.empty((b, *dims), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _bind("sv3d_scatter_voxels")(
        points.data_ptr(), grid.data_ptr(), b, n, *dims, *_bounds(eps), int(clamp), stream,
    )
    build.check(rc, "sv3d_scatter_voxels")
    scatter_voxels_cuda.launches += 1
    return grid


def scatter_voxels_raw_cuda(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """K1 without its clamp: the summed weights (B, *dims); same contract as
    scatter_voxels_raw, which a CPU tensor runs."""
    dims = tuple(int(d) for d in dims)
    if _device_of(points, "scatter_voxels") == "cpu":
        return scatter_voxels_raw(points, dims, eps)
    return _scatter_cuda(points, dims, eps, clamp=False)


def scatter_voxels_bwd_cuda(points: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
                            eps: float = 1e-6) -> torch.Tensor:
    """K1b: gradient (B, N, 3) of the clamped scatter in the points; grid is
    the forward's grid, clamped or raw (the clamp's mask 0 < x < 1 is the
    same on both), grad the cotangent of the clamped grid, in any strides.
    Same contract as scatter_voxels_bwd, which a CPU tensor runs."""
    if _device_of(points, "scatter_voxels_bwd") == "cpu":
        return scatter_voxels_bwd(points, grid, grad, eps)
    dims = tuple(int(d) for d in grid.shape[1:])
    _check_points(points, dims, "scatter_voxels_bwd")
    b, n, _ = points.shape
    for name, t in (("grid", grid), ("grad", grad)):
        if t.device != points.device or t.dtype != torch.float32 or tuple(t.shape) != (b, *dims):
            raise ValueError(f"scatter_voxels_bwd: {name} must be float32 (B, *dims) on the "
                             f"points' device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not grid.is_contiguous():
        raise ValueError("scatter_voxels_bwd: grid must be contiguous")
    out = torch.empty((b, n, 3), dtype=torch.float32, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _bind("sv3d_scatter_voxels_bwd")(
        points.data_ptr(), grid.data_ptr(), grad.data_ptr(), out.data_ptr(), b, n, *dims,
        *grad.stride(), *_bounds(eps), stream,
    )
    build.check(rc, "sv3d_scatter_voxels_bwd")
    scatter_voxels_bwd_cuda.launches += 1
    return out


class _ScatterVoxels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, dims, eps):
        if _device_of(points, "scatter_voxels") == "cpu":
            out = scatter_voxels(points, dims, eps)
        else:
            out = _scatter_cuda(points, dims, eps, clamp=True)
        ctx.save_for_backward(points, out)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, grad):
        points, out = ctx.saved_tensors
        return scatter_voxels_bwd_cuda(points, out, grad, ctx.eps), None, None


def scatter_voxels_cuda(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """Trilinear scatter of (B, N, 3) normed points into a (B, *dims) grid
    clamped to [0, 1], differentiable in the points; same contract as
    scatter_voxels.  K1 forward, K1b backward on a CUDA tensor."""
    return _ScatterVoxels.apply(points.contiguous(), tuple(int(d) for d in dims), float(eps))


scatter_voxels_cuda.launches = 0
scatter_voxels_bwd_cuda.launches = 0


def base_voxels(points: torch.Tensor, dims, eps: float = 1e-6) -> tuple:
    """The scatter's view of (B, N, 3) points, in the kernels' f32
    arithmetic (bounds rounded to f32): which of the B * N points it keeps,
    and each kept point's sample and base voxel floor((p + 0.5)(d - 1)), a
    (B * N,) mask, a (K,) index and three (K,) indices."""
    flat = points.reshape(-1, 3)
    kept = ((flat > -0.5 + eps) & (flat < 0.5 - eps)).all(dim=-1)
    batch = (torch.arange(flat.shape[0], device=flat.device) // points.shape[1])[kept]
    base = [torch.floor((flat[kept, a] + 0.5) * (d - 1.0)).long() for a, d in enumerate(dims)]
    return kept, batch, base


def k1_raw_tol(points: torch.Tensor, dims, eps: float = 1e-6) -> float:
    """The bound on K1's raw sums against the plain scatter's, relative to
    the largest sum: a sum of k nonnegative f32 terms is off its exact value
    by at most ~k 2^-24 of itself in any order, and the two sides add in
    different orders: 2 k 2^-24 with k the most contributions of this run's
    points to one voxel."""
    _, batch, i = base_voxels(points, dims, eps)
    lin = torch.stack([((batch * dims[0] + i[0] + c0) * dims[1] + i[1] + c1) * dims[2] + i[2] + c2
                       for c0 in (0, 1) for c1 in (0, 1) for c2 in (0, 1)])
    k = int(torch.unique(lin, return_counts=True)[1].max()) if lin.numel() else 1
    return 2.0 * k * 2.0 ** -24
