"""Watertight inside/outside point classification: a copy of
sv3d_tpu/preprocessing/waterproofing.py (implicit_waterproofing and the
MeshIntersector it runs on).

A copy, not an import, because importing any module of sv3d_tpu.preprocessing
runs that package's __init__, which imports process_sample -> sv3d_tpu.geometry
-> jax, and the port never imports jax.  The code itself is numpy plus the
port's copy of the native triangle hash (sv3d_tpu_torch.native), unchanged.

Ray-parity point-in-mesh testing with the native C++ triangle spatial hash,
plus the hole-repair loop that re-tests parity-inconsistent points under
three axis rotations.  A point is inside when both its +z and -z crossing
parities are odd; a disagreement marks a "hole" point.
"""

from __future__ import annotations

import math

import numpy as np

from sv3d_tpu_torch.io.mesh import TriMesh
from sv3d_tpu_torch.native import TriangleHash


class MeshIntersector:
    def __init__(self, mesh: TriMesh, resolution: int = 512):
        triangles = mesh.triangles.astype(np.float64)
        n_tri = triangles.shape[0]
        self.resolution = resolution
        flat = triangles.reshape(3 * n_tri, 3)
        self.bbox_min = flat.min(axis=0)
        self.bbox_max = flat.max(axis=0)
        self.scale = (resolution - 1) / np.maximum(self.bbox_max - self.bbox_min, 1e-30)
        self.translate = 0.5 - self.scale * self.bbox_min
        self._triangles = triangles * self.scale + self.translate
        self._hash = TriangleHash(self._triangles[:, :, :2], resolution)

    def query(self, points: np.ndarray):
        points = np.asarray(points, dtype=np.float64) * self.scale + self.translate
        n = len(points)
        contains = np.zeros(n, dtype=bool)
        holes = np.zeros(n, dtype=bool)

        inside_aabb = np.all((points >= 0) & (points <= self.resolution), axis=1)
        if not inside_aabb.any():
            return contains, holes
        pts = points[inside_aabb]

        pi, ti = self._hash.query(pts[:, :2])
        if len(pi):
            tri = self._triangles[ti]
            p = pts[pi]
            keep = _point_in_triangle_2d(p[:, :2], tri[:, :, :2])
            pi, tri, p = pi[keep], tri[keep], p[keep]

            depth, abs_n2 = _plane_depth(p, tri)
            above = depth >= p[:, 2] * abs_n2
            below = ~above
            n_above = np.bincount(pi[above], minlength=len(pts))
            n_below = np.bincount(pi[below], minlength=len(pts))
            odd_above = n_above % 2 == 1
            odd_below = n_below % 2 == 1
            contains[inside_aabb] = odd_above & odd_below
            holes[inside_aabb] = odd_above ^ odd_below
        return contains, holes


def _point_in_triangle_2d(points: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Strict barycentric containment of 2-D points in 2-D triangles."""
    a = triangles[:, 0] - triangles[:, 2]
    b = triangles[:, 1] - triangles[:, 2]
    y = points - triangles[:, 2]
    det = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    out = np.zeros(len(points), dtype=bool)
    m = det != 0
    s = np.sign(det[m])
    ad = np.abs(det[m])
    u = (b[m, 1] * y[m, 0] - b[m, 0] * y[m, 1]) * s
    v = (-a[m, 1] * y[m, 0] + a[m, 0] * y[m, 1]) * s
    out[m] = (0 < u) & (0 < v) & (u + v < ad) & (u < ad) & (v < ad) & (0 < u + v)
    return out


def _plane_depth(points: np.ndarray, triangles: np.ndarray):
    """Z of each triangle's plane at the point's xy, scaled by |n_z| (so the
    comparison with point z * |n_z| avoids a division)."""
    t1, t2, t3 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    normals = np.cross(t3 - t1, t2 - t1)
    alpha = np.sum(normals[:, :2] * (t1[:, :2] - points[:, :2]), axis=1)
    n2 = normals[:, 2]
    s, a = np.sign(n2), np.abs(n2)
    depth = np.full(len(points), np.nan)
    m = a != 0
    depth[m] = t1[m, 2] * a[m] + alpha[m] * s[m]
    return depth, a


def check_mesh_contains(mesh: TriMesh, points: np.ndarray, hash_resolution: int = 512):
    intersector = MeshIntersector(mesh, hash_resolution)
    return intersector.query(points)


def _rotation_matrix(euler) -> np.ndarray:
    cx, sx = math.cos(euler[0]), math.sin(euler[0])
    cy, sy = math.cos(euler[1]), math.sin(euler[1])
    cz, sz = math.cos(euler[2]), math.sin(euler[2])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx

def implicit_waterproofing(mesh: TriMesh, query_points: np.ndarray):
    """Inside/outside labels with hole repair: points whose +z/-z parities
    disagree are re-tested under three 90-degree rotations
    (reference implicit_waterproofing.py:27-48)."""
    occ, holes = check_mesh_contains(mesh, query_points)
    for euler in ([0, np.pi / 2, 0], [np.pi / 2, 0, 0], [0, 0, np.pi / 2]):
        if not holes.any():
            break
        r = _rotation_matrix(euler)
        rotated = mesh.copy()
        rotated.vertices = rotated.vertices @ r.T
        pts = query_points[holes] @ r.T
        occ_rot, holes_rot = check_mesh_contains(rotated, pts)
        occ[holes] = occ_rot
        new_holes = np.zeros(len(query_points), dtype=bool)
        new_holes[holes] = holes_rot
        holes = new_holes
    return occ, holes
