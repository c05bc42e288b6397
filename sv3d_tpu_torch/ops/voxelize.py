"""Point-cloud voxelization + separable Gaussian smoothing
(port of sv3d_tpu/ops/voxelize.py).

scatter_voxels is the plain torch version of the scatter: it is what a CPU
tensor runs and what the CUDA kernel (sv3d_tpu_torch/ops/cuda/voxelize.py) is
held against on the card.
"""

from __future__ import annotations

import torch


def scatter_voxels(points: torch.Tensor, dims: tuple, eps: float = 1e-6) -> torch.Tensor:
    """Trilinear scatter of points into a voxel occupancy grid.

    points: (B, N, 3) in normed grid space [-0.5, 0.5]^3 (points[..., i]
    addresses grid axis i).  Points outside (-0.5+eps, 0.5-eps) on any axis
    are dropped.  Returns (B, D0, D1, D2) clamped to [0, 1]."""
    d0, d1, d2 = (int(d) for d in dims)
    axes = []
    valid = None
    for a, size in ((0, d0), (1, d1), (2, d2)):
        p = points[..., a]
        va = (p < 0.5 - eps) & (p > -0.5 + eps)
        valid = va if valid is None else (valid & va)
        g = (p + 0.5) * (size - 1.0)  # continuous voxel coords in [0, size-1]
        gf = torch.floor(g)
        axes.append((gf.long(), g - gf))

    (i0, f0), (i1, f1), (i2, f2) = axes
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
    return torch.clamp(vox.reshape(b, d0, d1, d2), 0.0, 1.0)


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
