"""Camera intrinsics and depth conversions (port of sv3d_tpu/geometry/camera.py).

Host-side setup is numpy; the per-pixel transforms are torch and run on the
depth map's device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass(frozen=True)
class Intrinsics:
    """Pinhole camera intrinsics (4x4 homogeneous matrix)."""

    matrix: tuple  # 4x4 nested tuple (hashable)

    @property
    def np(self) -> np.ndarray:
        return np.asarray(self.matrix, dtype=np.float32)

    @property
    def focal_length(self) -> float:
        return float(self.matrix[0][0])

    @property
    def cx(self) -> float:
        return float(self.matrix[0][2])

    @property
    def cy(self) -> float:
        return float(self.matrix[1][2])

    @property
    def inverse(self) -> np.ndarray:
        return np.linalg.inv(self.np)


def parse_intrinsics(text: str) -> Intrinsics:
    """Parse a printed 4x4 matrix like
    ``[[277.128, 0., 159.5, 0.], [0., 277.128, 119.5, 0.], ...]`` into the
    canonical [[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]]."""
    values = [float(v) for v in re.findall(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", text)]
    if len(values) < 16:
        raise ValueError(f"expected >=16 numbers in intrinsics text, got {len(values)}")
    m = np.asarray(values[:16], dtype=np.float64).reshape(4, 4)
    f, cx, cy = m[0, 0], m[0, 2], m[1, 2]
    mat = ((f, 0.0, cx, 0.0), (0.0, f, cy, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))
    return Intrinsics(matrix=mat)


def read_intrinsics(path: str | Path) -> Intrinsics:
    return parse_intrinsics(Path(path).read_text())


def distance_to_depth(distance: torch.Tensor, focal_length: float) -> torch.Tensor:
    """Per-pixel euclidean distance -> planar depth, with the integer
    half-resolution centers (H//2, W//2) of the JAX package.  (H, W) or
    (B, H, W)."""
    h, w = distance.shape[-2], distance.shape[-1]
    kw = dict(dtype=distance.dtype, device=distance.device)
    rs = torch.arange(h, **kw) - (h // 2)
    cs = torch.arange(w, **kw) - (w // 2)
    rr = rs[:, None] ** 2 + cs[None, :] ** 2
    return torch.sqrt(distance**2 / (rr / (focal_length**2) + 1.0))


def depth_to_camera(depth: torch.Tensor, f: float, cx: float, cy: float) -> torch.Tensor:
    """Back-project a depth map into camera-space points:
    X = (u - cx) d / f, Y = -(v - cy) d / f, Z = d, u over columns, v over rows.

    depth: (..., H, W) -> (..., H*W, 3)."""
    h, w = depth.shape[-2], depth.shape[-1]
    kw = dict(dtype=depth.dtype, device=depth.device)
    u = torch.arange(w, **kw)[None, :]
    v = torch.arange(h, **kw)[:, None]
    x = (u - cx) * depth / f
    y = -((v - cy) * depth) / f
    pts = torch.stack([x, y, depth], dim=-1)
    return pts.reshape(*depth.shape[:-2], h * w, 3)
