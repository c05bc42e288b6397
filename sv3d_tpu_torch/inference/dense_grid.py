"""Dense-grid occupancy evaluation, arbitrary-point evaluation and mesh
extraction (port of sv3d_tpu/inference/dense_grid.py, one device).

The IF-Net pyramid is encoded once, then the dense lattice over
[-0.5, 0.5]^3 is swept in slabs of slab_rows axis-0 rows through
IFNet.query_lattice (the CUDA sweep kernel on the card).  slab_rows is a
parameter of the sweep, not a layout: the kernel takes any row count per
launch.  evaluate_points queries arbitrary points in fixed-shape tiles
through IFNet.query_fused (kernels K6 or K4) or the exact gather path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.point_query import stage_channels_last
from sv3d_tpu_torch.ops.grid_sample import Pyramid


def evaluate_on_grid_device(
    model: IFNet, levels, resolution, res_increase: int = 1, slab_rows: int = 1,
) -> torch.Tensor:
    """Whole dense sweep, result left on the levels' device: (r0_padded, r1,
    r2) sigmoid occupancy; rows past resolution[0] * res_increase are padding
    for the caller to trim."""
    resolution = tuple(int(x) for x in resolution)
    r0 = resolution[0] * res_increase
    n_slabs = -(-r0 // slab_rows)
    with torch.inference_mode():
        slabs = [
            torch.sigmoid(
                model.query_lattice(levels, resolution, res_increase, slab_rows, s * slab_rows)
            )[0]
            for s in range(n_slabs)
        ]
        return torch.cat(slabs, dim=0)


def evaluate_on_grid(
    model: IFNet, grid: torch.Tensor, resolution, res_increase: int = 1,
    slab_rows: int = 1, transfer_dtype=torch.float32,
) -> np.ndarray:
    """Sigmoid occupancy on the dense lattice, as a float32 numpy volume
    (r0, r1, r2), r_i = resolution[i] * res_increase.

    grid: (1, D0, D1, D2, 1) occupancy volume.  transfer_dtype is the dtype
    the value grid is cast to on the device before the host pull: float32
    (exact), float16, or uint8 fixed point (x/255); the result is float32 in
    [0, 1] in every case.  None skips the cast."""
    resolution = tuple(int(x) for x in resolution)
    if transfer_dtype == torch.uint8:
        host = _evaluate_u8(model, grid, resolution, res_increase, slab_rows)
        return host.astype(np.float32) / np.float32(255.0)
    r0 = resolution[0] * res_increase
    with torch.inference_mode():
        levels = model.encode(grid)
        out = evaluate_on_grid_device(model, levels, resolution, res_increase, slab_rows)
        if transfer_dtype is not None:
            out = out.to(transfer_dtype)
        return out[:r0].cpu().numpy().astype(np.float32)


def _evaluate_u8(model, grid, resolution, res_increase, slab_rows) -> np.ndarray:
    """Dense sweep -> uint8 fixed point (sigmoid * 255 + 0.5, truncated, as
    the JAX package casts) on the device -> host pull of the raw u8 grid."""
    r0 = int(resolution[0]) * res_increase
    with torch.inference_mode():
        levels = model.encode(grid)
        out = evaluate_on_grid_device(model, levels, resolution, res_increase, slab_rows)
        return (out[:r0] * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def evaluate_points(
    model: IFNet, grid, points: np.ndarray, tile_points: int = 65536,
    use_kernel: bool | None = None, bands="auto",
) -> np.ndarray:
    """Sigmoid occupancy at arbitrary points (M, 3) in [-0.5, 0.5], as (M,)
    float32 numpy.

    grid: (1, D0, D1, D2, 1) occupancy volume (a tensor or array; it moves
    to the model's device).  The pyramid is encoded once; the points are
    padded to whole tiles of min(tile_points, M) points, so every query has
    one shape; fc0's per-level blocks are cut once for all tiles.  use_kernel (default: on for a CUDA model, off on the CPU, as
    the JAX package's use_pallas defaults to the TPU) routes each tile
    through IFNet.query_fused with bands (default "auto": kernel K6, fc0 in
    the kernel; None: kernel K4 on the pyramid staged channels-last once,
    its features contracted by a matmul);
    otherwise through the exact f32 gather path IFNet.query.  Everything
    runs on the model's device; only the result comes back."""
    device = next(model.parameters()).device
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    m = pts.shape[0]
    tile = max(min(int(tile_points), m), 1)
    n_tiles = -(-m // tile)
    padded = np.zeros((n_tiles, 1, tile, 3), dtype=np.float32)
    padded.reshape(-1, 3)[:m] = pts
    with torch.inference_mode():
        levels = model.encode(torch.as_tensor(grid, dtype=torch.float32, device=device))
        if use_kernel and not bands:
            # K4 reads each level channels-last: stage the pyramid once for
            # all tiles, as channel-major views that K4's wrapper takes as
            # they are
            levels = Pyramid([stage_channels_last(f).transpose(1, 2) for f in levels.flats],
                             levels.dims)
        tiles = torch.from_numpy(padded).to(device)
        w0_blocks = [w.contiguous() for w in model.fc0_blocks()] if use_kernel else None
        out = torch.cat([
            torch.sigmoid(model.query_fused(levels, t, bands=bands, w0_blocks=w0_blocks)
                          if use_kernel else model.query(levels, t))[0]
            for t in tiles
        ])
        return out[:m].cpu().numpy()


def implicit_to_mesh(
    model: IFNet, grid: torch.Tensor, resolution, threshold_p: float,
    output_path: str | Path, res_increase: int = 1, slab_rows: int = 1,
    transfer_dtype=torch.uint8,
):
    """Dense evaluation -> marching cubes on (1 - occupancy) at level
    threshold_p -> OBJ.  Returns (vertices, triangles).

    The default uint8 pull is meshed directly by the native u8 marching cubes
    (sv3d_tpu_torch.utils.visualize.visualize_sdf_u8); pass torch.float32 for the
    exact field."""
    resolution = tuple(int(x) for x in resolution)
    if transfer_dtype == torch.uint8:
        from sv3d_tpu_torch.utils.visualize import visualize_sdf_u8

        host_u8 = _evaluate_u8(model, grid, resolution, res_increase, slab_rows)
        return visualize_sdf_u8(host_u8, output_path, level=threshold_p)
    from sv3d_tpu_torch.utils.visualize import visualize_sdf

    value_grid = evaluate_on_grid(
        model, grid, resolution, res_increase, slab_rows, transfer_dtype=transfer_dtype
    )
    return visualize_sdf(1.0 - value_grid, output_path, level=threshold_p)
