"""Offline preprocessing: raw renders -> training-ready grids and occupancy
samples (port of sv3d_tpu/preprocessing/process_sample.py; host code, numpy
on the port's own geometry, io, native and visualize modules).

    python -m sv3d_tpu_torch.preprocessing.process_sample --datasetdir data \
        --splitsdir overfit --scale_factor 1 --num_samples 100000 --num_workers 4

Per sample:
  1. distance.exr -> depth -> frustum grid space -> rounded binary
     depth_grid.npz;
  2. distance_field.df -> marching-cubes mesh.obj at level 1.0 (in the raw
     tree, where the end-to-end dataset reads it), and target.df;
  3. occupancy_{0.01,0.10}.npz: num_samples waterproofed samples per sigma.

The pipeline walks <root>/<splitsdir>/<scene>/<view> and moves samples that
raise IndexError, AttributeError or ValueError under
<root>/quarantine/<splitsdir>/.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
from pathlib import Path

import numpy as np

from sv3d_tpu_torch.data.datasets import _distance_to_depth_np
from sv3d_tpu_torch.geometry.camera import read_intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid
from sv3d_tpu_torch.io.exr import read_exr_channel
from sv3d_tpu_torch.io.volume import read_df
from sv3d_tpu_torch.preprocessing.occupancies import sample_points
from sv3d_tpu_torch.utils.visualize import visualize_sdf

FULL_DIMS = (139, 104, 112)
SIGMAS = (0.01, 0.1)


def _atomic_savez(path_base: Path, compressed: bool = False, **arrays):
    """Write <path_base>.npz through a temporary name and os.replace, so that
    the file's existence means it is complete: a run killed mid-write leaves
    no truncated npz for skip_existing to trust."""
    final = path_base.with_name(path_base.name + ".npz")
    tmp = final.with_name(final.name + ".tmp")
    with open(tmp, "wb") as f:
        (np.savez_compressed if compressed else np.savez)(f, **arrays)
    os.replace(tmp, final)


def depth_grid_from_distance(
    distance_path: str | Path, intrinsic_path: str | Path, down_scale_factor: int = 1
):
    """distance.exr -> (grid-space points (H*W, 3), binary voxel grid, dims).
    A point outside the frustum grid past its far end raises IndexError (a
    negative index would wrap, as numpy indexing does)."""
    intr = read_intrinsics(intrinsic_path)
    frustum = FrustumGrid.create(intr, voxel_size=0.05 * down_scale_factor)
    dist = read_exr_channel(distance_path, "R")
    depth = _distance_to_depth_np(dist, intr.focal_length)

    h, w = depth.shape
    u = np.arange(w, dtype=np.float32)[None, :]
    v = np.arange(h, dtype=np.float32)[:, None]
    x = (u - intr.cx) * depth / intr.focal_length
    y = -((v - intr.cy) * depth) / intr.focal_length
    pts = np.stack([x, y, depth], axis=-1).reshape(-1, 3)
    c2f = frustum.matrix
    scale = np.array([c2f[0, 0], c2f[1, 1], c2f[2, 2]], dtype=np.float32)
    shift = c2f[:3, 3]
    pts = pts * scale + shift

    idx = np.round(pts).astype(np.int32)
    grid = np.zeros(frustum.dims, dtype=np.float64)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
    return pts, grid, frustum.dims


def _dims(down_scale_factor: int) -> tuple:
    return tuple(round(d / down_scale_factor) for d in FULL_DIMS)


def _write_occupancies(mesh_path: Path, out: Path, dims, num_samples: int, rng):
    for sigma in SIGMAS:
        pts, occ, grid_coords = sample_points(mesh_path, dims, num_samples, sigma, rng=rng)
        _atomic_savez(out / f"occupancy_{sigma:.02f}", points=pts, occupancies=occ,
                      grid_coords=grid_coords)


def process_sample(
    dataset_path: str | Path,
    splitsdir: str,
    sample_name: str,
    down_scale_factor: int = 1,
    num_samples: int = 100000,
    seed: int = 0,
):
    """One sample of <dataset_path>/raw/<splitsdir>/<sample_name> into
    <dataset_path>/processed/<splitsdir>/<sample_name>.  Returns that
    directory."""
    dims = _dims(down_scale_factor)
    sample = Path(dataset_path) / "raw" / splitsdir / sample_name
    out = Path(dataset_path) / "processed" / splitsdir / sample_name
    out.mkdir(exist_ok=True, parents=True)

    intrinsic = sample / "intrinsic.txt"
    if not intrinsic.exists():
        intrinsic = Path(dataset_path) / "intrinsics.txt"
    _, grid, grid_dims = depth_grid_from_distance(
        sample / "distance.exr", intrinsic, down_scale_factor
    )
    if tuple(grid_dims) != dims:
        raise ValueError(f"frustum grid dims {grid_dims}, expected {dims}")
    _atomic_savez(out / "depth_grid", compressed=True, grid=grid)

    df = read_df(sample / "distance_field.df", down_scale_factor)
    visualize_sdf(df, sample / "mesh.obj", level=1.0)
    shutil.copyfile(sample / "distance_field.df", out / "target.df")
    _write_occupancies(sample / "mesh.obj", out, dims, num_samples, np.random.default_rng(seed))
    return out


_QUARANTINE_ERRORS = (IndexError, AttributeError, ValueError)


def _pipeline_one(job):
    """Process one scene/view (top level, so a worker process can take it).
    Returns (sample path, the error's class name or None); the quarantine
    moves stay in the parent."""
    (split_root, intrinsic_path, scene, view, down_scale_factor, num_samples,
     processed_root, rng_seed) = job
    dims = _dims(down_scale_factor)
    sample = Path(split_root) / scene / view
    out = sample
    if processed_root is not None:
        out = Path(processed_root) / scene / view
        out.mkdir(parents=True, exist_ok=True)
    try:
        _, grid, _ = depth_grid_from_distance(
            sample / "distance.exr", intrinsic_path, down_scale_factor
        )
        _atomic_savez(out / "depth_grid", compressed=True, grid=grid)
        df = read_df(sample / "distance_field.df", down_scale_factor)
        visualize_sdf(df, sample / "mesh.obj", level=1.0)
        if processed_root is not None:
            shutil.copyfile(sample / "distance_field.df", out / "target.df")
        _write_occupancies(sample / "mesh.obj", out, dims, num_samples,
                           np.random.default_rng(rng_seed))
        return str(sample), None
    except _QUARANTINE_ERRORS as e:
        if processed_root is not None:
            shutil.rmtree(out, ignore_errors=True)
        return str(sample), type(e).__name__


def _sample_outputs_complete(sample: Path, out: Path, processed_root) -> bool:
    """True when every file _pipeline_one would write already exists."""
    need = [out / "depth_grid.npz", out / "occupancy_0.01.npz",
            out / "occupancy_0.10.npz", sample / "mesh.obj"]
    if processed_root is not None:
        need.append(out / "target.df")
    return all(p.exists() for p in need)


def process_sample_pipeline(
    dataset_path: str | Path,
    splitsdir: str,
    down_scale_factor: int = 1,
    num_samples: int = 100000,
    seed: int = 0,
    processed_root: str | Path | None = None,
    num_workers: int = 0,
    skip_existing: bool = False,
):
    """Walk <dataset_path>/<splitsdir>/<scene>/<view>, quarantining the
    samples that fail.  Returns (processed, quarantined) lists of sample
    paths.

    Outputs land next to the raw files, or with processed_root under
    <processed_root>/<scene>/<view> (mesh.obj stays in the raw tree).  The
    intrinsics are <dataset_path>/intrinsics.txt.  num_workers > 1 fans the
    samples out over that many spawned processes.  Sample i of the tree walk
    draws from np.random.default_rng([seed, i]), so the output does not
    depend on the worker count, and skip_existing (skip samples whose
    outputs all exist) writes for the others what a full run would."""
    d_path = Path(dataset_path) / splitsdir
    intrinsic_path = Path(dataset_path) / "intrinsics.txt"
    jobs = []
    done = []
    n_seen = 0
    for scene in sorted(p.name for p in d_path.iterdir() if p.is_dir()):
        for view in sorted(p.name for p in (d_path / scene).iterdir() if p.is_dir()):
            sample = d_path / scene / view
            out = sample if processed_root is None else Path(processed_root) / scene / view
            if skip_existing and _sample_outputs_complete(sample, out, processed_root):
                done.append(str(sample))
            else:
                jobs.append(
                    (d_path, intrinsic_path, scene, view, down_scale_factor,
                     num_samples, processed_root, [seed, n_seen])
                )
            n_seen += 1

    if num_workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(_pipeline_one, jobs))
    else:
        results = [_pipeline_one(j) for j in jobs]

    processed, quarantined = list(done), []
    for (_, _, scene, view, *_), (sample, err) in zip(jobs, results):
        if err is None:
            processed.append(sample)
            continue
        quarantine = Path(dataset_path) / "quarantine" / splitsdir / scene / view
        quarantine.parent.mkdir(parents=True, exist_ok=True)
        print(f"{err} for {sample}; moving to {quarantine}")
        shutil.move(sample, str(quarantine))
        quarantined.append(sample)
    return processed, quarantined


def cli_main(argv=None):
    p = argparse.ArgumentParser(description="offline preprocessing pipeline: "
                                "<datasetdir>/raw/<splitsdir> -> processed/<splitsdir>")
    p.add_argument("--datasetdir", default="data")
    p.add_argument("--splitsdir", required=True)
    p.add_argument("--scale_factor", type=int, default=1)
    p.add_argument("--num_samples", type=int, default=100000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=0)
    a = p.parse_args(argv)
    processed, quarantined = process_sample_pipeline(
        Path(a.datasetdir) / "raw", a.splitsdir, a.scale_factor,
        a.num_samples, a.seed,
        processed_root=Path(a.datasetdir) / "processed" / a.splitsdir,
        num_workers=a.num_workers,
    )
    print(f"processed {len(processed)}, quarantined {len(quarantined)}")
    return processed, quarantined


if __name__ == "__main__":
    cli_main()
