"""Seeded synthetic rooms: the benchmark's traffic data (a frozen copy of
sv3d_tpu_torch/quality/synthetic_scenes.py's geometry and renderer, with an
occupancy sampler of its own and a minimal EXR writer).

A room is a floor slab, a back wall and 2-4 boxes on the floor, in camera
space (y up, z forward), rendered analytically: per-pixel euclidean
distances and a lambertian RGB.  Supervision points are drawn around the
boxes' surfaces in normed grid space [-0.5, 0.5]^3 and labelled exactly
(inside a box is occupied).  Everything is numpy, drawn from
SeedSequence([seed, i]) for room i, so one seed gives one set of rooms.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

FOCAL, CX, CY = 277.1281435, 159.5, 119.5
W, H = 320, 240

INTRINSICS_TEXT = (
    "[[277.1281435,   0.       , 159.5,  0.],\n"
    "[  0.       , 277.1281435, 119.5,  0.],\n"
    "[  0.       ,   0.       ,   1. ,  0.],\n"
    "[  0.       ,   0.       ,   0. ,  1.]]"
)


def room_rng(seed: int, i: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**63 - 1), int(i)]))


def _ray_dirs():
    """(H, W, 3) camera-space ray directions (z = 1), y negated."""
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    x = (u - CX) / FOCAL * np.ones((H, 1))
    y = -(v - CY) / FOCAL * np.ones((1, W))
    return np.stack([x, y, np.ones((H, W))], axis=-1)


def _ray_box(dirs, lo, hi):
    """Slab-method ray/AABB intersection from the origin: (t, entry axis)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = lo / dirs
        t1 = hi / dirs
    tmin = np.minimum(t0, t1)
    tmax = np.maximum(t0, t1)
    t_enter = tmin.max(axis=-1)
    t_exit = tmax.min(axis=-1)
    hit = (t_exit >= np.maximum(t_enter, 0.0)) & (t_exit > 0.0)
    t = np.where(hit, np.where(t_enter > 0.0, t_enter, t_exit), np.inf)
    axis = np.where(t_enter > 0.0, np.argmax(tmin, axis=-1), np.argmin(tmax, axis=-1))
    return t, axis


def make_room(rng: np.random.Generator):
    """[(lo, hi, albedo)] AABBs of one room in camera space."""
    floor_y = rng.uniform(-1.6, -1.1)
    wall_z = rng.uniform(4.6, 5.3)
    boxes = [
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


def render(boxes):
    """(distance (H, W) float32 metres, rgb (H, W, 3) uint8)."""
    dirs = _ray_dirs()
    best_t = np.full((H, W), np.inf)
    best_axis = np.zeros((H, W), np.int64)
    best_box = np.zeros((H, W), np.int64)
    for i, (lo, hi, _) in enumerate(boxes):
        t, axis = _ray_box(dirs, lo, hi)
        closer = t < best_t
        best_t = np.where(closer, t, best_t)
        best_axis = np.where(closer, axis, best_axis)
        best_box = np.where(closer, i, best_box)
    if not np.isfinite(best_t).all():
        raise RuntimeError("a ray escaped the room")
    distance = (best_t * np.linalg.norm(dirs, axis=-1)).astype(np.float32)
    albedos = np.stack([b[2] for b in boxes])
    light = np.array([0.35, 0.8, -0.49])
    light /= np.linalg.norm(light)
    normal_sign = -np.sign(np.take_along_axis(dirs, best_axis[..., None], -1))[..., 0]
    ndotl = np.clip(normal_sign * light[best_axis], 0.0, 1.0)
    shade = (0.35 + 0.65 * ndotl)[..., None] * albedos[best_box]
    return distance, (np.clip(shade, 0.0, 1.0) * 255).astype(np.uint8)


def camera_to_normed(pts, scale, shift, dims):
    """Camera-space points -> normed grid space (the frustum's axis-aligned
    scale and shift, then centre and divide by dims)."""
    d = np.asarray(dims, np.float64)
    return (pts * scale + shift - d / 2.0) / d


def occupancy_sets(rng, boxes, scale, shift, dims, n: int, sigmas=(0.10, 0.01)):
    """Per sigma: (points (1.1 n, 3), occupancies) float32 in normed grid
    space: n surface samples of the boxes plus N(0, sigma) noise, then n / 10
    uniform points, each labelled 1 inside a box."""
    lo = np.stack([camera_to_normed(b[0], scale, shift, dims) for b in boxes])
    hi = np.stack([camera_to_normed(b[1], scale, shift, dims) for b in boxes])
    lo, hi = np.minimum(lo, hi), np.maximum(lo, hi)
    # face areas: a box has two faces normal to each axis
    ext = hi - lo
    areas = np.stack([ext[:, 1] * ext[:, 2], ext[:, 0] * ext[:, 2], ext[:, 0] * ext[:, 1]], 1)
    p = np.repeat(areas, 2, axis=1).reshape(-1)
    out = []
    for sigma in sigmas:
        face = rng.choice(p.size, size=n, p=p / p.sum())
        box, axis, side = face // 6, (face % 6) // 2, face % 2
        pts = lo[box] + rng.random((n, 3)) * ext[box]
        pts[np.arange(n), axis] = np.where(side, hi[box, axis], lo[box, axis])
        pts = pts + sigma * rng.standard_normal((n, 3))
        pts = np.vstack([pts, rng.uniform(-0.5, 0.5, size=(n // 10, 3))])
        inside = ((pts[:, None] > lo[None]) & (pts[:, None] < hi[None])).all(-1).any(-1)
        out.append((pts.astype(np.float32), inside.astype(np.float32)))
    return out


def box_obj(boxes, scale, shift) -> str:
    """The boxes as an OBJ in voxel-index (grid) space."""
    corners = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)], np.float64)
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    lines = []
    for k, (lo, hi, _) in enumerate(boxes):
        for c in corners:
            v = (lo + c * (hi - lo)) * scale + shift
            lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
        lines += [f"f {8 * k + a + 1} {8 * k + b + 1} {8 * k + c + 1}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def write_png(path: Path, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)


def write_exr(path: Path, channel: np.ndarray) -> None:
    """A one-channel ("R") float32 scanline EXR, ZIP-compressed by blocks of
    16 lines (the subset of the format that OpenEXR readers all take)."""
    a = np.ascontiguousarray(channel, dtype=np.float32)
    h, w = a.shape
    lpb = 16

    def attr(name, typ, val):
        return name.encode() + b"\0" + typ.encode() + b"\0" + struct.pack("<i", len(val)) + val

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = struct.pack("<ii", 20000630, 2)
    header += attr("channels", "chlist", b"R\0" + struct.pack("<iiii", 2, 0, 1, 1) + b"\0")
    header += attr("compression", "compression", bytes([3]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"
    n_blocks = -(-h // lpb)
    out = bytearray(header)
    table = len(out)
    out += b"\0" * (8 * n_blocks)
    offsets = []
    for b in range(n_blocks):
        raw = a[b * lpb:(b + 1) * lpb].tobytes()
        d = np.frombuffer(raw, np.uint8)
        inter = np.concatenate([d[0::2], d[1::2]]).astype(np.int64)
        filt = np.empty_like(inter)
        filt[0] = inter[0]
        filt[1:] = inter[1:] - inter[:-1] + 128
        comp = zlib.compress((filt & 0xFF).astype(np.uint8).tobytes())
        payload = comp if len(comp) < len(raw) else raw
        offsets.append(len(out))
        out += struct.pack("<ii", b * lpb, len(payload)) + payload
    struct.pack_into(f"<{n_blocks}Q", out, table, *offsets)
    Path(path).write_bytes(bytes(out))


def render_pool(seed: int, n: int, out: Path) -> list:
    """n rooms as rgb.png files under out: [(path, rgb uint8)]."""
    out.mkdir(parents=True, exist_ok=True)
    pool = []
    for i in range(n):
        _, rgb = render(make_room(room_rng(seed, i)))
        path = out / f"room{i:02d}.png"
        write_png(path, rgb)
        pool.append((path, rgb))
    return pool


def write_train_tree(seed: int, n: int, root: Path, splitsdir: str, scale, shift, dims,
                     samples: int) -> dict:
    """n rooms in the on-disk layout of a SceneNet dataset under root:
    intrinsics.txt, splits/<splitsdir>/{train,val}.txt, raw/<splitsdir>/<id>/
    {rgb.png, distance.exr, mesh.obj}, processed/<splitsdir>/<id>/
    occupancy_{0.10,0.01}.npz.  Returns {id: (rgb uint8, distance, sets)}
    for the reference, which reads nothing the program made."""
    (root / "splits" / splitsdir).mkdir(parents=True, exist_ok=True)
    (root / "intrinsics.txt").write_text(INTRINSICS_TEXT)
    rooms = {}
    for i in range(n):
        rng = room_rng(seed, i)
        boxes = make_room(rng)
        distance, rgb = render(boxes)
        sets = occupancy_sets(rng, boxes, scale, shift, dims, samples)
        name = f"{i:03d}"
        raw = root / "raw" / splitsdir / name
        proc = root / "processed" / splitsdir / name
        raw.mkdir(parents=True, exist_ok=True)
        proc.mkdir(parents=True, exist_ok=True)
        write_png(raw / "rgb.png", rgb)
        write_exr(raw / "distance.exr", distance)
        (raw / "mesh.obj").write_text(box_obj(boxes, scale, shift))
        for sigma, (p, o) in zip(("0.10", "0.01"), sets):
            np.savez(proc / f"occupancy_{sigma}.npz", points=p, occupancies=o)
        rooms[name] = (rgb, distance, sets)
    names = "".join(f"{k}\n" for k in rooms)
    for split in ("train", "val"):
        (root / "splits" / splitsdir / f"{split}.txt").write_text(names)
    return rooms
