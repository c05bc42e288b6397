"""Occupancy supervision sampling and labelling: a copy of
sv3d_tpu/preprocessing/occupancies.py (sample_points, determine_occupancy,
_normalize_mesh).

A copy, not an import, because the port never imports sv3d_tpu or jax.  The
code is numpy plus the port's copies of io.mesh and implicit_waterproofing,
unchanged.

Meshes live in voxel-index space (0..dims); translate(-dims/2) +
scale(1/dims) puts them in normed grid space [-0.5, 0.5]^3, coordinate i =
grid axis i, the space the IF-Net queries.  sample_points also writes the
reference's axis-swapped, doubled 'grid_coords' key, for file-format
compatibility only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sv3d_tpu_torch.io.mesh import TriMesh, load_obj
from sv3d_tpu_torch.preprocessing.waterproofing import implicit_waterproofing


def _normalize_mesh(mesh: TriMesh, dims) -> TriMesh:
    return mesh.apply_translation(-np.asarray(dims, dtype=np.float64) / 2).apply_scale(
        1.0 / np.asarray(dims, dtype=np.float64)
    )


def sample_points(mesh_path: str | Path, dims, sample_num: int, sigma: float, rng=None):
    """Occupancy supervision points around a GT mesh: surface samples plus
    N(0, sigma) noise, then 10% uniform points in the unit cube, labelled by
    waterproofing.  Returns (boundary_points, occupancies, grid_coords)."""
    rng = np.random.default_rng() if rng is None else rng
    mesh = _normalize_mesh(load_obj(mesh_path), dims)
    points = mesh.sample(sample_num, rng=rng)
    boundary_points = points + sigma * rng.standard_normal((sample_num, 3))
    random_points = rng.uniform(-0.5, 0.5, size=(int(sample_num * 0.1), 3))
    boundary_points = np.vstack([boundary_points, random_points])
    # the reference's torch grid_sample coordinates: axes 0 and 2 swapped, doubled
    grid_coords = boundary_points.copy()
    grid_coords[:, 0], grid_coords[:, 2] = (
        boundary_points[:, 2],
        boundary_points[:, 0].copy(),
    )
    grid_coords = 2 * grid_coords
    occupancies = implicit_waterproofing(mesh, boundary_points)[0]
    return boundary_points, occupancies, grid_coords


def determine_occupancy(mesh_paths, points: np.ndarray, dims=(139, 104, 112)):
    """Label batched point clouds against their GT meshes.

    points: (B, N, 3) already in normed grid space [-0.5, 0.5] (the projected
    cloud of the scene-net forward), queried as-is against the
    unit-normalized mesh.  Returns (points, occupancies (B, N) float32)."""
    points = np.asarray(points)
    occs = np.zeros((len(mesh_paths), points.shape[1]), dtype=np.float32)
    for i, path in enumerate(mesh_paths):
        mesh = _normalize_mesh(load_obj(path), dims)
        occs[i] = implicit_waterproofing(mesh, points[i])[0].astype(np.float32)
    return points, occs
