"""Trilinear point sampling from 3-D feature grids and encoded feature
pyramids (port of sv3d_tpu/ops/grid_sample.py).

The sampler addresses grid axis i with coordinate points[..., i] (no axis
swap, unlike F.grid_sample), supports both torch coordinate conventions and
zero padding, and is differentiable by autograd in both the volume and the
points.  It is the exact f32 gather path of the IF-Net point query and the
plain version of the fused point-query kernel (sv3d_tpu_torch/ops/point_query.py).
"""

from __future__ import annotations

import torch


class Pyramid:
    """An encoded multi-level feature pyramid in the channel-major layout:
    flats[l] is (B, C_l, G0_l*G1_l*G2_l), dims[l] its 3-D shape."""

    def __init__(self, flats, dims):
        self.flats = tuple(flats)
        self.dims = tuple(tuple(int(x) for x in d) for d in dims)

    def __iter__(self):
        return iter(zip(self.flats, self.dims))

    def __len__(self):
        return len(self.flats)


def flatten_grid(grid: torch.Tensor):
    """(B, C, G0, G1, G2) -> contiguous channel-major (B, C, G0*G1*G2) + dims.

    The port keeps volumes NCDHW internally, so this is a reshape; the JAX
    package's flatten_grid takes the channels-last (B, G0, G1, G2, C).  cuDNN
    may hand back a conv output in channels_last_3d memory (a C=1 input is
    ambiguous), so the flat level is made contiguous here."""
    b, c, g0, g1, g2 = grid.shape
    return grid.reshape(b, c, g0 * g1 * g2).contiguous(), (g0, g1, g2)


def _axis_indices(p: torch.Tensor, size: int, align_corners: bool):
    """Coordinate in [-1, 1] -> (floor index, frac) along one grid axis."""
    if align_corners:
        ix = (p + 1.0) * 0.5 * (size - 1.0)
    else:
        ix = ((p + 1.0) * size - 1.0) * 0.5
    ix0f = torch.floor(ix)
    return ix0f.long(), ix - ix0f


def sample_trilinear_flat(flat: torch.Tensor, dims, p_axes, align_corners: bool = False):
    """Core sampler over a channel-major flat grid.

    flat: (B, C, G0*G1*G2); p_axes: three (B, N) coordinate arrays in
    [-1, 1].  Returns (B, C, N); out-of-range corners weigh 0.  The corners
    are summed in the JAX package's order."""
    g0, g1, g2 = (int(d) for d in dims)
    p0, p1, p2 = p_axes
    b, c, _ = flat.shape
    n = p0.shape[1]
    i0, f0 = _axis_indices(p0, g0, align_corners)
    i1, f1 = _axis_indices(p1, g1, align_corners)
    i2, f2 = _axis_indices(p2, g2, align_corners)

    out = None
    for c0 in (0, 1):
        idx0 = i0 + c0
        v0 = (idx0 >= 0) & (idx0 < g0)
        w0 = f0 if c0 else 1.0 - f0
        idx0c = idx0.clamp(0, g0 - 1)
        for c1 in (0, 1):
            idx1 = i1 + c1
            v01 = v0 & (idx1 >= 0) & (idx1 < g1)
            w01 = w0 * (f1 if c1 else 1.0 - f1)
            idx01 = idx0c * g1 + idx1.clamp(0, g1 - 1)
            for c2 in (0, 1):
                idx2 = i2 + c2
                valid = v01 & (idx2 >= 0) & (idx2 < g2)
                w = torch.where(valid, w01 * (f2 if c2 else 1.0 - f2), 0.0)
                lin = idx01 * g2 + idx2.clamp(0, g2 - 1)  # (B, N)
                vals = torch.gather(flat, 2, lin[:, None, :].expand(b, c, n))
                contrib = w[:, None, :].to(flat.dtype) * vals
                out = contrib if out is None else out + contrib
    return out


def sample_trilinear(grid: torch.Tensor, points: torch.Tensor, align_corners: bool = False):
    """Sample a (B, G0, G1, G2, C) channels-last volume (the JAX package's
    layout) at (B, N, 3) points in [-1, 1]: (B, C, N) features."""
    flat, dims = flatten_grid(grid.permute(0, 4, 1, 2, 3))
    return sample_trilinear_flat(
        flat, dims, (points[..., 0], points[..., 1], points[..., 2]), align_corners
    )


def displacement_axes(p_axes, displacement: float):
    """Three (B, N) coordinate arrays -> their 7 displaced copies as three
    (B, 7N) arrays.  Copy order: center, -d0, +d0, -d1, +d1, -d2, +d2, with
    d in the [-1, 1] sampling space."""
    p0, p1, p2 = p_axes
    d = displacement

    def stack(p, deltas):
        return torch.cat([p + dd for dd in deltas], dim=1)

    return (
        stack(p0, [0.0, -d, d, 0.0, 0.0, 0.0, 0.0]),
        stack(p1, [0.0, 0.0, 0.0, -d, d, 0.0, 0.0]),
        stack(p2, [0.0, 0.0, 0.0, 0.0, 0.0, -d, d]),
    )
