"""The one-box scene: a seeded fixture that the tests and the card smoke run
(chip_smoke.py) train, preprocess, evaluate and voxelize on.

The scene is BOX, an axis-aligned box in camera space (metres), before a
wall at WALL_Z, rendered exactly through the ray/box intersection of
synthetic_scenes.  write_smoke_dataset writes it as the one-scene tree that
SceneNetDataset reads (RGB, EXR depth, the box mesh and labelled points);
write_raw_tree writes the raw tree that the preprocessing pipeline walks,
with a second view whose wall lies past the frustum.  iou_box_pair is the
evaluation's analytic case, and k1_points / degenerate_points are the
scatter kernel K1's inputs at the main path's shape.  Imports nothing of the
JAX package.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.ops.cuda.voxelize import base_voxels
from sv3d_tpu_torch.quality.synthetic_scenes import _box_udf, _ray_box

INTRINSICS = "[[277.128, 0., 159.5, 0.], [0., 277.128, 119.5, 0.], [0., 0., 1., 0.], [0., 0., 0., 1.]]"

# the one-scene dataset: an axis-aligned box (camera space, metres) in front
# of a wall at WALL_Z
BOX = ((-0.8, -0.9, 2.4), (0.9, 0.4, 4.0))
WALL_Z = 5.5
#: the raw tree's far view: its wall lies past the frustum's 6 m far plane
FAR_WALL_Z = 7.0
#: the triangles of a box whose 8 corners come in box_vertices' order
BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
    [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
])


def seeded_scene_net(config, device, seed):
    """SceneNet of config on the box scene's camera, its weights drawn from
    seed, in eval mode."""
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    intr = parse_intrinsics(INTRINSICS)
    frustum = FrustumGrid.create(intr, voxel_size=0.05 * config.scale_factor)
    gen = torch.Generator().manual_seed(seed)
    return SceneNet(config, intr, frustum, device=device, generator=gen).eval()


def write_smoke_dataset(root, scale_factor: int = 1, seed: int = 0,
                        n_points: int = 20000) -> Path:
    """A seeded one-scene dataset tree in the layout SceneNetDataset reads:
    intrinsics.txt, splits/overfit/{train,val}.txt, raw/overfit/00000/
    {rgb.png, distance.exr, mesh.obj} and processed/overfit/00000/
    occupancy_{0.10,0.01}.npz.  The scene is BOX before a wall, rendered
    exactly (ray-box distances); the mesh is the box in the voxel-index space
    of the grid that Config(scale_factor=scale_factor) trains on; the
    supervision points are box-surface samples with N(0, sigma) noise plus
    10% uniform points, labelled against the mesh.  Returns root."""
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.data.splits import write_split
    from sv3d_tpu_torch.io.mesh import TriMesh, save_obj
    from sv3d_tpu_torch.preprocessing.occupancies import _normalize_mesh, determine_occupancy

    rng = np.random.default_rng(seed)
    root = Path(root)
    item = "00000"
    raw = root / "raw" / "overfit" / item
    proc = root / "processed" / "overfit" / item
    raw.mkdir(parents=True, exist_ok=True)
    proc.mkdir(parents=True, exist_ok=True)
    (root / "intrinsics.txt").write_text(INTRINSICS)
    for split in ("train", "val"):
        write_split(root, "overfit", split, [item])

    write_box_view(raw, rng)
    dims = Config(seed=seed, scale_factor=scale_factor).dims
    verts = box_vertices(scale_factor)
    save_obj(raw / "mesh.obj", verts, BOX_FACES)

    mesh = _normalize_mesh(TriMesh(verts, BOX_FACES), dims)
    for sigma in ("0.10", "0.01"):
        near = mesh.sample(n_points, rng=rng) + float(sigma) * rng.standard_normal((n_points, 3))
        pts = np.vstack([near, rng.uniform(-0.5, 0.5, (n_points // 10, 3))])
        _, occ = determine_occupancy([raw / "mesh.obj"], pts[None], dims=dims)
        np.savez(proc / f"occupancy_{sigma}.npz", points=pts.astype(np.float32),
                 occupancies=occ[0])
    return root


def write_box_view(raw: Path, rng, wall_z: float = WALL_Z) -> None:
    """rgb.png and distance.exr of BOX before a wall at wall_z, into raw."""
    from PIL import Image

    from sv3d_tpu_torch.io.exr import write_exr

    depth, dirs = box_scene_depth(wall_z)
    write_exr(raw / "distance.exr",
              {"R": (depth * np.linalg.norm(dirs, axis=-1)).astype(np.float32)})
    shade = np.clip(1.1 - depth / WALL_Z, 0.0, 1.0)[..., None] * np.array([0.9, 0.7, 0.5])
    shade = shade + 0.05 * rng.standard_normal(shade.shape)
    Image.fromarray((np.clip(shade, 0, 1) * 255).astype(np.uint8)).save(raw / "rgb.png")


def box_vertices(scale_factor: int = 1) -> np.ndarray:
    """BOX's 8 corners (the order of BOX_FACES) in the voxel-index space of
    the frustum grid of voxel size 0.05 * scale_factor."""
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid

    intr = parse_intrinsics(INTRINSICS)
    lo, hi = np.asarray(BOX[0]), np.asarray(BOX[1])
    c2f = np.asarray(FrustumGrid.create(intr, voxel_size=0.05 * scale_factor).camera2frustum)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    return corners @ c2f[:3, :3].T + c2f[:3, 3]


def box_distance_field() -> np.ndarray:
    """The distance (voxel units) of each voxel of the full-resolution grid
    (139, 104, 112) to the solid BOX (0 inside), float32: a
    distance_field.df whose level-1.0 surface is the box grown by one
    voxel."""
    verts = box_vertices(1)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    p = np.moveaxis(np.indices((139, 104, 112), dtype=np.float64), 0, -1)
    inside = ((p >= lo) & (p <= hi)).all(axis=-1)
    return np.where(inside, 0.0, _box_udf(p, lo, hi)).astype(np.float32)


def iou_box_pair() -> tuple:
    """A box in the evaluation's unit cube [-0.5, 0.5]^3 that fills a tenth
    of it (0.4 x 0.5 x 0.5), and the same box shifted by half its width
    along x: their volumetric IoU is (1/2) / (3/2) = 1/3.  Returns
    (vertices (2, 8, 3), faces)."""
    lo, hi = np.array([-0.3, -0.25, -0.25]), np.array([0.1, 0.25, 0.25])
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    return np.stack([corners, corners + [0.2, 0.0, 0.0]]), BOX_FACES


def write_raw_tree(root) -> Path:
    """A seeded raw tree in the layout process_sample_pipeline walks (its
    CLI reads <root>/raw/<splitsdir>/<scene>/<view> and
    <root>/raw/intrinsics.txt; the trainers read <root>/intrinsics.txt):
    scene 00000, view 00 the box scene of write_smoke_dataset with its
    full-resolution distance_field.df, view 01 the same box before a wall at
    FAR_WALL_Z, whose grid index past the far end the pipeline must
    quarantine (IndexError); and splits/overfit/{train,val}.txt listing
    00000/00.  <splitsdir> is "overfit": the train split repeats its scene
    50 times.  Returns root."""
    from sv3d_tpu_torch.data.splits import write_split
    from sv3d_tpu_torch.io.volume import write_df

    rng = np.random.default_rng(0)
    root = Path(root)
    df = box_distance_field()
    for view, wall_z in (("00", WALL_Z), ("01", FAR_WALL_Z)):
        raw = root / "raw" / "overfit" / "00000" / view
        raw.mkdir(parents=True, exist_ok=True)
        write_box_view(raw, rng, wall_z)
        write_df(raw / "distance_field.df", df)
    for path in (root / "intrinsics.txt", root / "raw" / "intrinsics.txt"):
        path.write_text(INTRINSICS)
    for split in ("train", "val"):
        write_split(root, "overfit", split, ["00000/00"])
    return root


def box_scene_depth(wall_z: float = WALL_Z) -> tuple:
    """The one-scene dataset's view: the planar depth (240, 320) of BOX
    before a wall at wall_z, rendered exactly (ray-box distances), and the
    ray directions of planar depth 1 (240, 320, 3)."""
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics

    intr = parse_intrinsics(INTRINSICS)
    u = np.arange(320, dtype=np.float64)[None, :]
    v = np.arange(240, dtype=np.float64)[:, None]
    # camera y is up: rows grow down
    dirs = np.stack(np.broadcast_arrays((u - intr.cx) / intr.focal_length,
                                        -(v - intr.cy) / intr.focal_length, 1.0), axis=-1)
    t, _ = _ray_box(dirs, np.asarray(BOX[0]), np.asarray(BOX[1]))
    return np.where(np.isfinite(t), t, wall_z), dirs


# K1's inputs: a depth map per image, (B, 240, 320) metres
DEPTHS = {
    # uniform per pixel: no spatial coherence, the worst case of K1's combine
    "random": lambda b, rng: rng.uniform(0.4, 6.0, (b, 240, 320)),
    # write_smoke_dataset's rendered scene
    "box": lambda b, rng: np.broadcast_to(box_scene_depth()[0], (b, 240, 320)),
    # a wall at 3 m: every lane of a warp in one or two voxels (the tests' case)
    "plane": lambda b, rng: np.full((b, 240, 320), 3.0),
}


def k1_points(model, kind: str, b: int, rng, outside: int = 4096) -> torch.Tensor:
    """K1's points at the main path's shape: the (b, 76800, 3) cloud that
    model.project_depth makes of a DEPTHS[kind] map, then `outside` uniform
    points in [-0.7, 0.7]^3 an image, most of them dropped at the border."""
    dev = next(model.parameters()).device
    depth = torch.tensor(np.ascontiguousarray(DEPTHS[kind](b, rng), dtype=np.float32), device=dev)
    with torch.no_grad():
        pc = model.project_depth(depth)
    extra = torch.tensor(rng.uniform(-0.7, 0.7, (b, outside, 3)).astype(np.float32), device=dev)
    return torch.cat([pc, extra], dim=1).contiguous()


def k1_atomics(points: torch.Tensor, dims, eps: float = 1e-6) -> tuple:
    """The global atomics that K1 issues on these (B, N, 3) points: one a
    (warp, base voxel, in-range corner), a warp being 32 consecutive points
    of the flattened (B * N) list as the kernel's threads take them; and the
    old kernel's, one a (kept point, in-range corner)."""
    kept, batch, i = base_voxels(points, dims, eps)
    corners = math.prod((1 + (ia + 1 < d).long()) for ia, d in zip(i, dims))
    key = ((batch * dims[0] + i[0]) * dims[1] + i[1]) * dims[2] + i[2]
    warp = torch.nonzero(kept)[:, 0] // 32
    _, first = np.unique(torch.stack([warp, key], dim=1).cpu().numpy(), axis=0,
                         return_index=True)
    return int(corners[torch.as_tensor(first, device=key.device)].sum()), int(corners.sum())


def degenerate_points(dims, n: int, rng, voxels: int = 64) -> np.ndarray:
    """(1, n, 3) points in which the 32 lanes of each warp share one base
    voxel (K1's combine sums all 32), drawn from `voxels` voxels so that
    many warps add to each, at fractions in [0.05, 0.95] inside it."""
    warps = -(-n // 32)
    pick = rng.integers(0, voxels, warps)
    base = np.stack([rng.integers(0, d - 1, voxels) for d in dims], axis=-1)[pick]
    g = np.repeat(base, 32, axis=0)[:n] + rng.uniform(0.05, 0.95, (n, 3))
    return (g / (np.asarray(dims) - 1.0) - 0.5)[None].astype(np.float32)
