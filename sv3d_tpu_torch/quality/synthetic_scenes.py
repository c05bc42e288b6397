"""Procedural multi-scene dataset generator, the synthetic 3D-Front
stand-in of the quality runs (port of scripts/make_synthetic_scenes.py on
this package's camera, frustum, EXR and distance-field writers; for the same
seed it writes the same raw tree, file for file).

Each scene is a simple "room" in camera space: a floor slab, a back wall and
2-4 random boxes resting on the floor, rendered analytically:

  * distance.exr: exact per-pixel ray/box intersection distances
    (euclidean, the BlenderProc convention the preprocessing consumes)
  * rgb.png: a lambertian-shaded albedo render of the same intersections
  * distance_field.df: the unsigned truncated distance field of the box
    union on the (139, 104, 112) frustum grid, in voxel units (meshed at
    level 1.0 by preprocessing.process_sample)
  * campose.npy, and intrinsics.txt at the root and under raw/

One view per scene under raw/<splitsdir>/<scene>/00000, the scene/view tree
that process_sample_pipeline walks.  --bad_scenes appends scenes whose back
wall sits beyond the 6 m frustum depth: their back-projected points index
out of the frustum grid (IndexError) and the pipeline quarantines them.

    python -m sv3d_tpu_torch.quality.synthetic_scenes --out .synth_data \
        --n_scenes 8 [--bad_scenes 1] [--seed 0]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sv3d_tpu_torch.geometry.camera import Intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid

FOCAL, CX, CY = 277.1281435, 159.5, 119.5
W, H = 320, 240
VOXEL = 0.05
DIMS = (139, 104, 112)

INTRINSICS_TEXT = (
    "[[277.1281435,   0.       , 159.5,  0.],\n"
    "[  0.       , 277.1281435, 119.5,  0.],\n"
    "[  0.       ,   0.       ,   1. ,  0.],\n"
    "[  0.       ,   0.       ,   0. ,  1.]]"
)


def _ray_dirs():
    """(H, W, 3) unnormalized camera-space ray directions (z = 1), matching
    the back-projection convention of depth_grid_from_distance
    (preprocessing/process_sample.py: y is negated)."""
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    x = (u - CX) / FOCAL * np.ones((H, 1))
    y = -(v - CY) / FOCAL * np.ones((1, W))
    return np.stack([x, y, np.ones((H, W))], axis=-1)


def _ray_box(dirs: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Slab-method ray/AABB intersection from the origin.  Returns (t, axis):
    entry distance along the (unnormalized) ray and the slab axis of entry
    (for face normals); t = inf where the ray misses."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = lo / dirs  # (..., 3)
        t1 = hi / dirs
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    t_enter = tmin.max(axis=-1)
    t_exit = tmax.min(axis=-1)
    hit = (t_exit >= np.maximum(t_enter, 0.0)) & (t_exit > 0.0)
    t = np.where(hit, np.where(t_enter > 0.0, t_enter, t_exit), np.inf)
    # face axis: the entry slab for exterior origins; for an origin INSIDE
    # the box (t_enter <= 0) the returned t is the EXIT distance, so the hit
    # face is the exit slab (argmin of tmax), not the entry one
    axis = np.where(
        t_enter > 0.0, np.argmax(tmin, axis=-1), np.argmin(tmax, axis=-1)
    )
    return t, axis


def _box_udf(pts: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Unsigned distance from points (..., 3) to an AABB surface (meters):
    |signed box SDF| so interiors contribute a growing distance too (the
    level-1.0 mesh is then the usual 1-voxel shell around the surface)."""
    c = (lo + hi) * 0.5
    h = (hi - lo) * 0.5
    q = np.abs(pts - c) - h
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(q.max(axis=-1), 0.0)
    return np.abs(outside + inside)


def make_scene_boxes(rng: np.random.Generator, bad: bool = False):
    """Random room geometry: list of (lo, hi, albedo) AABBs in camera space
    (y up, z forward).  bad=True pushes the back wall beyond the 6 m frustum
    depth so back-projection indexes out of the grid (quarantine trigger)."""
    floor_y = rng.uniform(-1.6, -1.1)
    wall_z = rng.uniform(6.3, 6.8) if bad else rng.uniform(4.6, 5.3)
    boxes = [
        # floor slab and back wall span past the frustum cross-section
        (np.array([-4.0, floor_y - 0.3, 0.0]), np.array([4.0, floor_y, 7.2]),
         np.array([0.45, 0.40, 0.35])),
        (np.array([-4.0, floor_y - 0.3, wall_z]), np.array([4.0, 3.4, wall_z + 0.4]),
         np.array([0.55, 0.55, 0.60])),
    ]
    for _ in range(int(rng.integers(2, 5))):
        sx, sy, sz = rng.uniform(0.35, 1.1, 3)
        z = rng.uniform(1.3, min(4.2, wall_z - 0.4) - sz)
        x = rng.uniform(-0.9, 0.9) * z * 0.45
        lo = np.array([x - sx / 2, floor_y, z])
        hi = np.array([x + sx / 2, floor_y + sy, z + sz])
        boxes.append((lo, hi, rng.uniform(0.2, 0.95, 3)))
    return boxes


def render_scene(boxes):
    """(distance (H, W) float32 meters, rgb (H, W, 3) uint8)."""
    dirs = _ray_dirs()
    best_t = np.full((H, W), np.inf)
    best_axis = np.zeros((H, W), np.int64)
    best_box = np.zeros((H, W), np.int64)
    for i, (lo, hi, _alb) in enumerate(boxes):
        t, axis = _ray_box(dirs, lo, hi)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_axis = np.where(closer, axis, best_axis)
        best_box = np.where(closer, i, best_box)
    if not np.isfinite(best_t).all():
        raise RuntimeError("a ray escaped the room (wall too small)")

    distance = (best_t * np.linalg.norm(dirs, axis=-1)).astype(np.float32)

    albedos = np.stack([b[2] for b in boxes])  # (n_boxes, 3)
    light = np.array([0.35, 0.8, -0.49])
    light /= np.linalg.norm(light)
    # face normal = +-e_axis; sign from the ray direction component
    normal_sign = -np.sign(np.take_along_axis(dirs, best_axis[..., None], -1))[..., 0]
    ndotl = np.clip(normal_sign * light[best_axis], 0.0, 1.0)
    shade = (0.35 + 0.65 * ndotl)[..., None] * albedos[best_box]
    rgb = (np.clip(shade, 0.0, 1.0) * 255).astype(np.uint8)
    return distance, rgb


def scene_distance_field(boxes) -> np.ndarray:
    """Unsigned truncated DF of the box union on the frustum grid, in VOXEL
    units (the reference .df convention, meshed at level 1.0)."""
    intr = Intrinsics(
        matrix=(
            (FOCAL, 0.0, CX, 0.0), (0.0, FOCAL, CY, 0.0),
            (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0),
        )
    )
    frustum = FrustumGrid.create(intr, voxel_size=VOXEL)
    if frustum.dims != DIMS:
        raise RuntimeError(f"frustum dims {frustum.dims}, expected {DIMS}")
    c2f = frustum.matrix
    shift = c2f[:3, 3].astype(np.float64)

    idx = np.stack(
        np.meshgrid(*(np.arange(d, dtype=np.float64) for d in DIMS), indexing="ij"),
        axis=-1,
    )
    pts = (idx - shift) * VOXEL  # voxel centers in camera space
    df = np.full(DIMS, np.inf)
    for lo, hi, _alb in boxes:
        df = np.minimum(df, _box_udf(pts, lo, hi))
    return np.minimum(df / VOXEL, 3.0).astype(np.float32)


_RAW_FILES = ("distance.exr", "rgb.png", "distance_field.df", "campose.npy")


def _render(scene_dir: Path, seed: int, i: int, bad: bool) -> None:
    """Render scene i (seeded as SeedSequence([seed, i])) into scene_dir."""
    from PIL import Image

    from sv3d_tpu_torch.io.exr import write_exr
    from sv3d_tpu_torch.io.volume import write_df

    rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
    boxes = make_scene_boxes(rng, bad=bad)
    scene_dir.mkdir(parents=True, exist_ok=True)
    distance, rgb = render_scene(boxes)
    write_exr(scene_dir / "distance.exr", {"R": distance})
    Image.fromarray(rgb).save(scene_dir / "rgb.png")
    write_df(scene_dir / "distance_field.df", scene_distance_field(boxes))
    np.save(scene_dir / "campose.npy", np.eye(4, dtype=np.float64))


def generate(
    out: Path, n_scenes: int, bad_scenes: int = 0, seed: int = 0,
    splitsdir: str = "synth", skip_existing: bool = False, num_workers: int = 0,
):
    """Render scenes 0 .. n_scenes + bad_scenes - 1 (the last bad_scenes of
    them beyond the frustum) under out; returns their "scene/view" names.
    skip_existing keeps a scene whose raw files all exist.  num_workers > 1
    renders over that many spawned processes (each scene is seeded by its
    index, so the files are the same)."""
    raw_root = out / "raw" / splitsdir
    raw_root.mkdir(parents=True, exist_ok=True)
    # datasets read <out>/intrinsics.txt; process_sample_pipeline reads
    # <dataset_path>/intrinsics.txt with dataset_path = <out>/raw
    (out / "intrinsics.txt").write_text(INTRINSICS_TEXT)
    (out / "raw" / "intrinsics.txt").write_text(INTRINSICS_TEXT)

    names, todo = [], []
    for i in range(n_scenes + bad_scenes):
        scene_dir = raw_root / f"{i:03d}" / "00000"
        names.append(f"{i:03d}/00000")
        # scene i is seeded as SeedSequence([seed, i]) independent of n_scenes,
        # so a scene that exists on disk is byte-identical to what a re-render
        # would produce — growing a tree only pays for the NEW scenes
        if not (skip_existing and all((scene_dir / f).exists() for f in _RAW_FILES)):
            todo.append((scene_dir, seed, i, i >= n_scenes))
    if num_workers > 1 and len(todo) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_render, *zip(*todo)))
    else:
        for args in todo:
            _render(*args)
    return names


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=".synth_data")
    p.add_argument("--n_scenes", type=int, default=8)
    p.add_argument("--bad_scenes", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--splitsdir", default="synth")
    a = p.parse_args()
    names = generate(Path(a.out), a.n_scenes, a.bad_scenes, a.seed, a.splitsdir)
    print(f"generated {len(names)} scenes under {a.out}/raw/{a.splitsdir}")


if __name__ == "__main__":
    main()
