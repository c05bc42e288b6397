"""Dense-grid occupancy evaluation, arbitrary-point evaluation and mesh
extraction (port of sv3d_tpu/inference/dense_grid.py).

The IF-Net pyramid is encoded once, the sweep is prepared once
(IFNet.sweep_plan), then the dense lattice over [-0.5, 0.5]^3 is swept in
slabs of slab_rows axis-0 rows through IFNet.query_lattice (the CUDA sweep
kernel K2 on the card) in the JAX package's compute dtype, bfloat16, unless
evaluate_on_grid_device is asked for float32.  slab_rows is a parameter of
the sweep, not a layout: the kernel takes any row count per launch, and a
point's value does not depend on it.  Its default, None, sweeps the whole
lattice in one launch, the fastest on the card (the JAX package's default
of 1 row was sized for the TPU's VMEM).  evaluate_points queries arbitrary
points in fixed-shape tiles through IFNet.query_fused -- in bf16 (the JAX
package's point-query class) kernels K6 bf16 or K5, in float32 K6 or K4 --
or the exact gather path.

mesh= (a multi-GPU Mesh of sv3d_tpu_torch/parallel, every rank calling with
the same model and grid) shards the work as the JAX package's mesh does:
the lattice's axis-0 rows over sp, rank j sweeping ceil(r0 / sp) rows from
j * ceil(r0 / sp) with its own plan (a rank with no rows launches nothing),
the logits assembled on every rank of its dp row by one all-reduce of a
zeroed lattice (gloo takes only broadcast and all_reduce on CUDA tensors);
the points of each evaluate_points tile over all dp * sp ranks, the tile
rounded down to a multiple of their count.  The sigmoid runs once over the
assembled logits, so the result is the single-process one bit for bit
wherever each point's logit is.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.point_query import stage_channels_last
from sv3d_tpu_torch.ops.grid_sample import Pyramid


def evaluate_on_grid_device(
    model: IFNet, levels, resolution, res_increase: int = 1, slab_rows: int | None = None,
    compute_dtype=torch.bfloat16, mesh=None,
) -> torch.Tensor:
    """Whole dense sweep, result left on the levels' device: (r0_padded, r1,
    r2) sigmoid occupancy; rows past resolution[0] * res_increase are padding
    for the caller to trim.  One sweep plan a call; each slab of slab_rows
    rows (None: all of them) is one launch with no host-to-device copy.
    compute_dtype: bfloat16 (the JAX package's default) or float32 (exact,
    the parity route).  mesh: the rows split over its sp ranks (module
    docstring), r0 rows returned on each."""
    resolution = tuple(int(x) for x in resolution)
    r0 = resolution[0] * res_increase
    if mesh is not None and mesh.sp > 1:
        return _sharded_sweep(model, levels, resolution, res_increase, slab_rows,
                              compute_dtype, mesh)
    slab_rows = r0 if slab_rows is None else int(slab_rows)
    n_slabs = -(-r0 // slab_rows)
    with torch.inference_mode():
        plan = model.sweep_plan(levels, resolution, res_increase, compute_dtype)
        slabs = [
            model.query_lattice(levels, resolution, res_increase, slab_rows, s * slab_rows,
                                compute_dtype, plan=plan)[0]
            for s in range(n_slabs)
        ]
        # one sigmoid over the whole lattice: a CPU elementwise kernel may
        # round its vector body and its tail differently
        return torch.sigmoid(torch.cat(slabs, dim=0))


def _sharded_sweep(model, levels, resolution, res_increase, slab_rows, compute_dtype, mesh):
    """evaluate_on_grid_device's rows over mesh.sp: this rank's share swept
    with its own plan, the logits assembled over the dp row, one sigmoid."""
    r = tuple(int(x) * res_increase for x in resolution)
    per = -(-r[0] // mesh.sp)
    lo = min(mesh.sp_index * per, r[0])
    hi = min(lo + per, r[0])
    with torch.inference_mode():
        logits = torch.zeros(r, dtype=torch.float32, device=levels.flats[0].device)
        if hi > lo:
            plan = model.sweep_plan(levels, resolution, res_increase, compute_dtype)
            rows = hi - lo if slab_rows is None else min(int(slab_rows), hi - lo)
            for off in range(lo, hi, rows):
                slab = model.query_lattice(levels, resolution, res_increase, rows, off,
                                           compute_dtype, plan=plan)[0]
                logits[off:min(off + rows, hi)] = slab[:hi - off]
        return torch.sigmoid(mesh.sum_(logits, over="row"))


def evaluate_on_grid(
    model: IFNet, grid: torch.Tensor, resolution, res_increase: int = 1,
    slab_rows: int | None = None, transfer_dtype=torch.float32, mesh=None,
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


def _evaluate_u8(model, grid, resolution, res_increase, slab_rows, mesh=None) -> np.ndarray:
    """Dense sweep -> uint8 fixed point (sigmoid * 255 + 0.5, truncated, as
    the JAX package casts) on the device -> host pull of the raw u8 grid."""
    r0 = int(resolution[0]) * res_increase
    with torch.inference_mode():
        levels = model.encode(grid)
        out = evaluate_on_grid_device(model, levels, resolution, res_increase, slab_rows,
                                      mesh=mesh)
        return (out[:r0] * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def evaluate_points(
    model: IFNet, grid, points: np.ndarray, tile_points: int = 65536,
    use_kernel: bool | None = None, bands="auto", compute_dtype=torch.bfloat16, mesh=None,
) -> np.ndarray:
    """Sigmoid occupancy at arbitrary points (M, 3) in [-0.5, 0.5], as (M,)
    float32 numpy (an empty (0,) array for M = 0).

    grid: (1, D0, D1, D2, 1) occupancy volume (a tensor or array; it moves
    to the model's device).  The pyramid is encoded once; the points are
    padded to whole tiles of min(tile_points, M) points, so every query has
    one shape; fc0's per-level blocks are prepared once for all tiles.
    use_kernel (default: on for a CUDA model, off on the CPU, as the JAX
    package's use_pallas defaults to the TPU) routes each tile through
    IFNet.query_fused, in compute_dtype: bfloat16 (the default, the JAX
    package's use_pallas class) or float32 (exact, the parity route).  bands
    picks the kernel: "auto" or a count, K6 (fc0 in the kernel; bf16 or f32);
    None, K5 (bf16) or K4 (f32) and a matmul.  The kernel routes stage the
    pyramid channels-last once a call, rounded to bf16 for bfloat16 (a
    precision-16 model's bf16 levels as they are; widened for float32).
    use_kernel=False takes the exact f32 gather path IFNet.query whatever
    compute_dtype says.  Everything runs on the model's device; only the
    result comes back.  mesh: each tile's points split over all its ranks,
    the tile rounded down to a multiple of their count (at least one point
    a rank), the logits assembled on every rank (module docstring)."""
    device = next(model.parameters()).device
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    m = pts.shape[0]
    if m == 0:
        return np.zeros((0,), dtype=np.float32)
    shards = 1 if mesh is None else mesh.size
    tile = max(min(int(tile_points), m) // shards * shards, shards)
    share = slice(0, tile) if mesh is None else slice(mesh.rank * (tile // shards),
                                                     (mesh.rank + 1) * (tile // shards))
    n_tiles = -(-m // tile)
    padded = np.zeros((n_tiles, 1, tile, 3), dtype=np.float32)
    padded.reshape(-1, 3)[:m] = pts
    with torch.inference_mode():
        levels = model.encode(torch.as_tensor(grid, dtype=torch.float32, device=device))
        if use_kernel:
            # every kernel route reads each level channels-last (K6 bf16 and
            # K5 its bf16 rounding): stage the pyramid once for all tiles, as
            # channel-major views that the wrappers take as they are
            cast = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
            levels = Pyramid([stage_channels_last(f.to(cast)).transpose(1, 2)
                              for f in levels.flats], levels.dims)
        tiles = torch.from_numpy(padded[:, :, share]).to(device)
        w0_blocks = model.fc0_operands(bands, compute_dtype) if use_kernel else None
        logits = torch.zeros((n_tiles, tile), dtype=torch.float32, device=device)
        logits[:, share] = torch.stack([
            (model.query_fused(levels, t, bands, w0_blocks, compute_dtype)
             if use_kernel else model.query(levels, t))[0]
            for t in tiles
        ])
        if mesh is not None:
            mesh.sum_(logits)
        # one sigmoid over exactly the m logits: a CPU elementwise kernel
        # may round its vector body and its tail differently
        return torch.sigmoid(logits.reshape(-1)[:m]).cpu().numpy()


def implicit_to_mesh(
    model: IFNet, grid: torch.Tensor, resolution, threshold_p: float,
    output_path: str | Path, res_increase: int = 1, slab_rows: int | None = None,
    transfer_dtype=torch.uint8, mesh=None,
):
    """Dense evaluation -> marching cubes on (1 - occupancy) at level
    threshold_p -> OBJ.  Returns (vertices, triangles).

    The default uint8 pull is meshed directly by the native u8 marching cubes
    (sv3d_tpu_torch.utils.visualize.visualize_sdf_u8); pass torch.float32 for the
    exact field.  mesh: the sweep sharded over its sp ranks; rank 0 meshes
    and writes, the others return None after their share."""
    resolution = tuple(int(x) for x in resolution)
    if transfer_dtype == torch.uint8:
        from sv3d_tpu_torch.utils.visualize import visualize_sdf_u8

        host_u8 = _evaluate_u8(model, grid, resolution, res_increase, slab_rows, mesh)
        if mesh is not None and mesh.rank != 0:
            return None
        return visualize_sdf_u8(host_u8, output_path, level=threshold_p)
    from sv3d_tpu_torch.utils.visualize import visualize_sdf

    value_grid = evaluate_on_grid(
        model, grid, resolution, res_increase, slab_rows, transfer_dtype=transfer_dtype,
        mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return None
    return visualize_sdf(1.0 - value_grid, output_path, level=threshold_p)
