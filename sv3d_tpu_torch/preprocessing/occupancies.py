"""Occupancy labels of point clouds against GT meshes: a copy of
determine_occupancy and _normalize_mesh from
sv3d_tpu/preprocessing/occupancies.py.

A copy, not an import, because importing any module of sv3d_tpu.preprocessing
runs that package's __init__, which imports process_sample -> sv3d_tpu.geometry
-> jax, and the port never imports jax.  The code is numpy plus the port's
copies of io.mesh and implicit_waterproofing, unchanged.

Meshes live in voxel-index space (0..dims); translate(-dims/2) +
scale(1/dims) puts them in normed grid space [-0.5, 0.5]^3, coordinate i =
grid axis i, the space the IF-Net queries.
"""

from __future__ import annotations

import numpy as np

from sv3d_tpu_torch.io.mesh import TriMesh, load_obj
from sv3d_tpu_torch.preprocessing.waterproofing import implicit_waterproofing


def _normalize_mesh(mesh: TriMesh, dims) -> TriMesh:
    return mesh.apply_translation(-np.asarray(dims, dtype=np.float64) / 2).apply_scale(
        1.0 / np.asarray(dims, dtype=np.float64)
    )


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
