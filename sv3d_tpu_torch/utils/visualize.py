"""Visualization artifact dumps (a copy of sv3d_tpu/utils/visualize.py;
reference util/visualize.py rebuild).

All host-side: isosurface meshes via the native marching cubes, occupied-voxel
box meshes, point lists, and depth map png/exr dumps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from sv3d_tpu_torch.io.mesh import load_obj, save_obj
from sv3d_tpu_torch.native import marching_cubes

# unit cube (8 verts, 12 tris) for voxel box rendering
_CUBE_V = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    dtype=np.float64,
)
_CUBE_F = np.array(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
     [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3]],
    dtype=np.int64,
)


def to_point_list(grid: np.ndarray) -> np.ndarray:
    """(N, 3) integer coordinates of grid cells >= 0.5
    (reference util/visualize.py:10-11)."""
    return np.argwhere(np.asarray(grid) >= 0.5)


def visualize_point_list(points: np.ndarray, output_path: str | Path):
    """Write raw points as OBJ vertices shifted by +0.5 (voxel centers),
    matching reference util/visualize.py:14-20."""
    pts = np.asarray(points).reshape(-1, 3) + 0.5
    with open(output_path, "w") as f:
        for p in pts:
            f.write(f"v {p[0]:f} {p[1]:f} {p[2]:f} 1 1 1\n")


def visualize_sdf(sdf: np.ndarray, output_path: str | Path, level: float = 0.75):
    """Marching-cubes isosurface -> OBJ (reference util/visualize.py:23-25)."""
    verts, tris = marching_cubes(np.asarray(sdf, dtype=np.float32), level)
    save_obj(output_path, verts, tris)
    return verts, tris


def visualize_sdf_u8(occupancy_u8: np.ndarray, output_path: str | Path,
                     level: float = 0.5):
    """``visualize_sdf(1.0 - occupancy_u8/255.0, path, level)`` computed
    directly on the uint8 fixed-point serving pull — no f32 cast and no
    ``1 - v`` temporary (each a full-grid pass; see native.marching_cubes_u8)."""
    from sv3d_tpu_torch.native import marching_cubes_u8

    verts, tris = marching_cubes_u8(np.asarray(occupancy_u8, dtype=np.uint8), level)
    save_obj(output_path, verts, tris)
    return verts, tris


def visualize_grid(grid: np.ndarray, output_path: str | Path):
    """Occupied voxels as a box soup (trimesh multibox analog, reference
    util/visualize.py:28-32)."""
    centers = to_point_list(grid)
    if centers.shape[0] == 0:
        return
    n = centers.shape[0]
    verts = (_CUBE_V[None] - 0.5 + centers[:, None]).reshape(-1, 3)
    faces = (_CUBE_F[None] + 8 * np.arange(n)[:, None, None]).reshape(-1, 3)
    save_obj(output_path, verts, faces)


def visualize_depthmap(depthmap: np.ndarray, output_path: str | Path, flip: bool = False):
    """Normalized .png + raw .exr dump (reference util/visualize.py:34-49)."""
    from PIL import Image

    from sv3d_tpu_torch.io.exr import write_exr

    d = np.asarray(depthmap, dtype=np.float32).squeeze()
    if flip:
        d = d[:, ::-1]
    lo, hi = float(d.min()), float(d.max())
    rescaled = (255.0 / max(hi, 1e-9) * (d - lo)).astype(np.uint8)
    Image.fromarray(rescaled).save(str(output_path) + ".png")
    write_exr(str(output_path) + ".exr", d)


def scale_mesh_to_unit(path: str | Path, dims=(139, 104, 112)) -> Path:
    """Scale a voxel-space mesh by 1/dims into <path without .obj>_scaled.obj
    (reference util/visualize.py:51-59); returns that path."""
    mesh = load_obj(path)
    mesh.apply_scale(1.0 / np.asarray(dims, dtype=np.float64))
    out = Path(str(path)[:-4] + "_scaled.obj")
    mesh.export(out)
    return out
