"""Lattice (dense-grid) feature interpolation as separable banded matrices
(port of sv3d_tpu/ops/lattice.py).

The dense sweep's query points form a regular lattice over [-0.5, 0.5]^3, so
trilinear interpolation of a pyramid level is a separable resize: per grid
axis a small (r_out, g_in) matrix with at most two nonzeros per row, and

    features[r0, r1, r2, c] = sum_ijk M0[r0,i] M1[r1,j] M2[r2,k] V[c,i,j,k].

The 7 displaced query copies shift the sampling coordinates along one axis
each, so each displacement swaps in a shifted matrix for that axis.  The
numpy half is a copy of the JAX package's; displaced_resizes_cm and
slab_features (the unfused sweep's materialized feature matrix) are torch.
"""

from __future__ import annotations

import numpy as np
import torch


def interp_matrix(
    out_coords: np.ndarray, g: int, align_corners: bool, dtype=np.float32
) -> np.ndarray:
    """(r, g) trilinear interpolation matrix for one axis.

    out_coords: normalized coordinates in [-1, 1] (grid_sample convention);
    out-of-range taps get weight 0 (padding_mode='zeros')."""
    x = np.asarray(out_coords, dtype=np.float64)
    if align_corners:
        ix = (x + 1.0) * 0.5 * (g - 1.0)
    else:
        ix = ((x + 1.0) * g - 1.0) * 0.5
    i0 = np.floor(ix)
    frac = ix - i0
    rows = np.arange(len(x))
    m = np.zeros((len(x), g), dtype=np.float64)
    for corner, w in ((i0, 1.0 - frac), (i0 + 1.0, frac)):
        valid = (corner >= 0) & (corner < g)
        m[rows[valid], corner[valid].astype(int)] += w[valid]
    return m.astype(dtype)


def lattice_coords(r: int) -> np.ndarray:
    """The dense sweep's per-axis coordinates: linspace(-0.5, 0.5, r) doubled
    into [-1, 1]."""
    return 2.0 * np.linspace(-0.5, 0.5, r)


def axis_matrices(r: int, g: int, align_corners: bool, displacement: float) -> tuple:
    """(center, minus, plus) interpolation matrices for one axis: the center
    lattice and the lattice shifted by -/+ displacement (in [-1, 1] space)."""
    x = lattice_coords(r)
    return (
        interp_matrix(x, g, align_corners),
        interp_matrix(x - displacement, g, align_corners),
        interp_matrix(x + displacement, g, align_corners),
    )


def axis_taps(r: int, g: int, align_corners: bool, displacement: float = 0.0):
    """2-tap form of interp_matrix for one lattice axis: per output row the
    floor/ceil input indices (clamped into the grid) and their weights
    (zeroed out of range).  Same numbers as interp_matrix's nonzeros.  g and
    displacement may be numpy arrays that broadcast against the (r,) lattice,
    giving the taps of many grids and shifts in one call."""
    x = lattice_coords(r) + displacement
    x = np.asarray(x, np.float64)
    if align_corners:
        ix = (x + 1.0) * 0.5 * (g - 1.0)
    else:
        ix = ((x + 1.0) * g - 1.0) * 0.5
    i0 = np.floor(ix)
    f = ix - i0
    w0 = (1.0 - f) * ((i0 >= 0) & (i0 <= g - 1))
    w1 = f * ((i0 + 1 >= 0) & (i0 + 1 <= g - 1))
    return (
        np.clip(i0, 0, g - 1).astype(np.int32),
        w0.astype(np.float32),
        np.clip(i0 + 1, 0, g - 1).astype(np.int32),
        w1.astype(np.float32),
    )


def resize_volume_cm(vol: torch.Tensor, m0, m1, m2) -> torch.Tensor:
    """Separable interpolation matrices (r_i, g_i) applied to a channel-major
    volume (B, C, g0, g1, g2) -> (B, C, r0, r1, r2): three contractions."""
    m0, m1, m2 = (torch.as_tensor(m, dtype=vol.dtype, device=vol.device) for m in (m0, m1, m2))
    v = torch.einsum("ai,bcijk->bcajk", m0, vol)
    v = torch.einsum("xj,bcajk->bcaxk", m1, v)
    return torch.einsum("yk,bcaxk->bcaxy", m2, v)


def displaced_resizes_cm(vol: torch.Tensor, mats0, mats1, mats2) -> list:
    """All 7 displaced resizes of a channel-major (B, C, g0, g1, g2) volume,
    sharing partial products.

    mats{0,1,2} = (center, minus, plus) per axis, as tensors.  Returns
    volumes in the displacement order [center, -d0, +d0, -d1, +d1, -d2, +d2],
    each (B, C, r0, r1, r2)."""
    c0, m0, p0 = mats0
    c1, m1, p1 = mats1
    c2, m2, p2 = mats2
    ax0 = lambda m, v: torch.einsum("ai,bcijk->bcajk", m, v)
    ax1 = lambda m, v: torch.einsum("xj,bcajk->bcaxk", m, v)
    ax2 = lambda m, v: torch.einsum("yk,bcaxk->bcaxy", m, v)

    v0c = ax0(c0, vol)
    v01c = ax1(c1, v0c)
    out = [None] * 7
    out[0] = ax2(c2, v01c)
    out[5] = ax2(m2, v01c)
    out[6] = ax2(p2, v01c)
    out[3] = ax2(c2, ax1(m1, v0c))
    out[4] = ax2(c2, ax1(p1, v0c))
    out[1] = ax2(c2, ax1(c1, ax0(m0, vol)))
    out[2] = ax2(c2, ax1(c1, ax0(p0, vol)))
    return out


def axis0_rows(m: np.ndarray, rows: int, row_offset: int) -> np.ndarray:
    """Rows [row_offset, row_offset + rows) of an axis-0 table; lattice rows
    past the end (the padded edge slab) are zero, so their features are 0."""
    need = row_offset + rows
    if need > m.shape[0]:
        m = np.pad(m, ((0, need - m.shape[0]),) + ((0, 0),) * (m.ndim - 1))
    return m[row_offset:need]


def slab_features(levels, r: tuple, rows: int, row_offset: int, align_corners: bool,
                  displacement: float) -> torch.Tensor:
    """The dense sweep's materialized feature matrix for lattice rows
    [row_offset, row_offset + rows) of the (r0, r1, r2) lattice: (B,
    7*sumC, rows*r1*r2) f32, displacement-major (index d * sumC + c, fc0's
    input order).  levels: iterable of (flat (B, C, g0*g1*g2), dims).  The
    JAX package's 8-channel pad of level 0 and its axis-0 input window are
    TPU layout and are not ported: every level contracts over all its rows."""
    feats = [[] for _ in range(7)]
    for flat, dims in levels:
        b, c = flat.shape[:2]
        vol = flat.reshape(b, c, *dims)
        kw = dict(dtype=flat.dtype, device=flat.device)
        mats0 = tuple(
            torch.tensor(axis0_rows(m, rows, row_offset), **kw)
            for m in axis_matrices(r[0], dims[0], align_corners, displacement)
        )
        mats1, mats2 = (
            tuple(torch.tensor(m, **kw)
                  for m in axis_matrices(r[ax], dims[ax], align_corners, displacement))
            for ax in (1, 2)
        )
        for d, vd in enumerate(displaced_resizes_cm(vol, mats0, mats1, mats2)):
            feats[d].append(vd.reshape(b, c, -1))
    return torch.cat([x for fd in feats for x in fd], dim=1)
