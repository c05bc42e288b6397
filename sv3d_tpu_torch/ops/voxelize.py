"""Point-cloud voxelization + separable Gaussian smoothing
(port of sv3d_tpu/ops/voxelize.py).

scatter_voxels_raw (the scatter before its [0, 1] clamp) and
scatter_voxels_bwd (its gradient in the points, given the clamp) are the plain
torch versions of the scatter kernel and of its backward kernel: they are what
a CPU tensor runs and what the CUDA kernels (sv3d_tpu_torch/ops/cuda/voxelize.py)
are held against on the card.
"""

from __future__ import annotations

import torch


def _scatter_axes(points: torch.Tensor, dims: tuple, eps: float):
    """Border mask (B, N) and per-axis (floor index, frac) of the scatter."""
    axes = []
    valid = None
    for a, size in enumerate(dims):
        p = points[..., a]
        va = (p < 0.5 - eps) & (p > -0.5 + eps)
        valid = va if valid is None else (valid & va)
        g = (p + 0.5) * (size - 1.0)  # continuous voxel coords in [0, size-1]
        gf = torch.floor(g)
        axes.append((gf.long(), g - gf))
    return valid, axes


def scatter_voxels(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """Trilinear scatter of points into a voxel occupancy grid.

    points: (B, N, 3) in normed grid space [-0.5, 0.5]^3 (points[..., i]
    addresses grid axis i).  Points outside (-0.5+eps, 0.5-eps) on any axis
    are dropped.  Returns (B, D0, D1, D2) clamped to [0, 1]."""
    return torch.clamp(scatter_voxels_raw(points, dims, eps), 0.0, 1.0)


def scatter_voxels_raw(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """scatter_voxels before the clamp: (B, D0, D1, D2) summed weights."""
    d0, d1, d2 = (int(d) for d in dims)
    valid, ((i0, f0), (i1, f1), (i2, f2)) = _scatter_axes(points, (d0, d1, d2), eps)
    b = points.shape[0]
    nflat = d0 * d1 * d2
    vox = torch.zeros(b * nflat, dtype=points.dtype, device=points.device)
    base = torch.arange(b, device=points.device)[:, None] * nflat
    for c0 in (0, 1):
        w0 = f0 if c0 else 1.0 - f0
        l0 = i0 + c0
        for c1 in (0, 1):
            w01 = w0 * (f1 if c1 else 1.0 - f1)
            l01 = l0 * d1 + (i1 + c1)
            for c2 in (0, 1):
                w = torch.where(valid, w01 * (f2 if c2 else 1.0 - f2), 0.0)
                lin = torch.where(valid, l01 * d2 + (i2 + c2), 0) + base
                vox = vox.index_add(0, lin.reshape(-1), w.reshape(-1))
    return vox.reshape(b, d0, d1, d2)


def scatter_voxels_bwd(points: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Gradient of clamp(scatter_voxels_raw(points)) in the points, port of
    sv3d_tpu/ops/pallas/voxelize.py::_scatter_bwd.

    grid: the forward's grid, clamped or raw: the clamp passes the gradient
    strictly inside (0, 1), and 0 < raw < 1 holds exactly where
    0 < clamp(raw, 0, 1) < 1, so either carries the mask.  grad:
    (B, D0, D1, D2) incoming gradient of the clamped grid.  Each point
    gathers it at its 8 corners with the derivatives +-(d - 1) of its
    trilinear weights.  Returns (B, N, 3)."""
    b = points.shape[0]
    dims = tuple(int(d) for d in grid.shape[1:])
    d0, d1, d2 = dims
    gflat = torch.where((grid > 0.0) & (grid < 1.0), grad, 0.0).reshape(b, -1)
    valid, ((i0, f0), (i1, f1), (i2, f2)) = _scatter_axes(points, dims, eps)
    s0, s1, s2 = (float(d - 1.0) for d in dims)
    gp0 = torch.zeros_like(f0)
    gp1 = torch.zeros_like(f1)
    gp2 = torch.zeros_like(f2)
    for c0 in (0, 1):
        w0 = f0 if c0 else 1.0 - f0
        dw0 = s0 if c0 else -s0
        for c1 in (0, 1):
            w1 = f1 if c1 else 1.0 - f1
            dw1 = s1 if c1 else -s1
            for c2 in (0, 1):
                w2 = f2 if c2 else 1.0 - f2
                dw2 = s2 if c2 else -s2
                lin = ((i0 + c0) * d1 + (i1 + c1)) * d2 + (i2 + c2)
                lin = torch.where(valid, lin, 0)
                gv = torch.where(valid, torch.gather(gflat, 1, lin), 0.0)
                gp0 = gp0 + gv * dw0 * w1 * w2
                gp1 = gp1 + gv * w0 * dw1 * w2
                gp2 = gp2 + gv * w0 * w1 * dw2
    return torch.stack([gp0, gp1, gp2], dim=-1)


def gaussian_kernels_1d(sigma: torch.Tensor, kernel_size: tuple) -> list:
    """Three normalized 1-D Gaussian kernels with per-axis (learnable) sigma."""
    kernels = []
    for axis in range(3):
        k = int(kernel_size[axis])
        start = -(k // 2) + 1.0 if k % 2 == 0 else float(-(k // 2))
        x = torch.arange(start, k // 2 + 1.0, dtype=sigma.dtype, device=sigma.device)
        kern = torch.exp(-(x**2) / (2.0 * sigma[axis] ** 2))
        kernels.append(kern / torch.sum(kern))
    return kernels


def blur_matrix(kern: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size) banded matrix applying a 1-D cross-correlation with SAME
    zero padding: out[i] = sum_t kern[t] * x[i + t - k//2].  Built from
    shifted identities so it stays differentiable in kern."""
    k = kern.shape[0]
    m = torch.zeros((size, size), dtype=kern.dtype, device=kern.device)
    for t in range(k):
        off = t - k // 2
        eye = torch.diag(
            torch.ones(size - abs(off), dtype=kern.dtype, device=kern.device), off
        )
        m = m + kern[t] * eye
    return m


def smooth_voxels(voxels: torch.Tensor, kernels: list) -> torch.Tensor:
    """Separable 3-D Gaussian blur: one banded-matrix contraction per grid
    axis, in full f32 (the JAX package contracts at HIGHEST precision).

    voxels: (B, D0, D1, D2) -> same shape, clamped to [0, 1]."""
    x = voxels
    m0, m1, m2 = (
        blur_matrix(kern.to(x.dtype), x.shape[1 + axis])
        for axis, kern in enumerate(kernels)
    )
    x = torch.einsum("ij,bjkl->bikl", m0, x)
    x = torch.einsum("ij,bkjl->bkil", m1, x)
    x = torch.einsum("ij,bklj->bkli", m2, x)
    return torch.clamp(x, 0.0, 1.0)


def voxelize(points: torch.Tensor, dims: tuple, sigma: torch.Tensor,
             kernel_size: tuple) -> torch.Tensor:
    """Differentiable voxelization: the trilinear scatter (K1 and its
    backward K1b on a CUDA tensor, the plain scatter on a CPU one), then the
    learnable Gaussian smoothing (reference model/projection.py:119-122).
    Returns the (B, D0, D1, D2, 1) channels-last occupancy grid."""
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda

    vox = scatter_voxels_cuda(points, dims)
    return smooth_voxels(vox, gaussian_kernels_1d(sigma, kernel_size))[..., None]
