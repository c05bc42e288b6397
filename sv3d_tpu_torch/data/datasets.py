"""Host-side datasets feeding the trainers (a copy of
sv3d_tpu/data/datasets.py; the camera intrinsics come from the port's
sv3d_tpu_torch.geometry.camera).

TPU-native twins of the reference torch Datasets:
  SceneNetDataset  — end-to-end pipeline samples (reference
                     dataset/scene_net_data.py:22-103)
  DepthDataset     — UNet depth-regression samples (reference
                     dataset/scenes_dataset.py:21-75)
  ImplicitDataset  — IF-Net-only samples on precomputed grids (reference
                     dataset/implicit_dataset.py:10-56)

Design differences from the reference:
  * Layout is NHWC float32 host arrays (TPU conv layout); normalization
    (x - 0.5) / 0.5 keeps channels last instead of torchvision's CHW.
  * Point subsampling randomness is derived per (seed, epoch, index) via
    numpy SeedSequence — no shared Generator, so loader worker THREADS cannot
    race it, identical batches fall out for any worker count, and every epoch
    draws fresh subsamples.  The loader advances the epoch by calling
    ``get(idx, epoch)``; plain ``ds[idx]`` is epoch 0.
  * Decoded per-item raw data (PNG/EXR decode, npz load) is LRU-cached:
    overfit splits repeat one item 50-500x and the decode dominated step time.
  * Query points use the framework convention — the npz 'points' field in
    [-0.5, 0.5]^3 with points[..., i] addressing grid axis i.  The reference
    must carry a second axis-swapped-and-doubled 'grid_coords' array purely
    for torch grid_sample (reference scene_net_data.py:69-71); neither package has a
    swap anywhere (see sv3d_tpu_torch/ops/grid_sample.py).
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path

import numpy as np

from sv3d_tpu_torch.data.splits import read_split
from sv3d_tpu_torch.utils.profiling import count, span

# subsampling draws one set per sigma, concatenated in this order (reference
# scene_net_data.py:66: `for sigma in ['0.10', '0.01']`)
SIGMAS = ("0.10", "0.01")


def _distance_to_depth_np(distance: np.ndarray, focal_length: float) -> np.ndarray:
    """Per-pixel euclidean distance -> planar depth, numpy host version
    (twin of sv3d_tpu_torch.geometry.camera.distance_to_depth; reference
    data_processing/distance_to_depth.py:6-26 with integer half-resolution
    centers)."""
    h, w = distance.shape[-2], distance.shape[-1]
    rs = np.arange(h, dtype=np.float32) - (h // 2)
    cs = np.arange(w, dtype=np.float32) - (w // 2)
    rr = rs[:, None] ** 2 + cs[None, :] ** 2
    return np.sqrt(distance**2 / (rr / (focal_length**2) + 1.0)).astype(np.float32)


def _item_rng(seed: int, epoch: int, idx: int) -> np.random.Generator:
    """Fresh, thread-owned generator for one (epoch, dataset index) access."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(epoch), int(idx)])
    )


class _SplitDataset:
    """Shared machinery: split list, overfit repetition, per-access rng,
    LRU-cached raw decode."""

    #: overfit repetition factor (reference scene_net_data.py:31 x50,
    #: scenes_dataset.py:29 x500, implicit_dataset.py:18 x50)
    overfit_factor = 50

    def __init__(self, split, datasetdir, splitsdir, seed=0, cache_items=None):
        self.split = split
        self.datasetdir = Path(datasetdir)
        self.splitsdir = splitsdir
        self.seed = int(seed)
        self.items = read_split(datasetdir, splitsdir, split)
        n_unique = len(self.items)
        if "overfit" in splitsdir and split == "train":
            self.items = self.items * self.overfit_factor
        if cache_items is None:
            # size the decode cache to the split (~3 MB/item decoded): a
            # fixed 64 gave a 24% hit rate on a 272-scene train split and the
            # single-core host's EXR/npz decode throttled the TPU step loop
            cache_items = min(max(n_unique, 64), 512)
        self._lock = threading.Lock()
        self._load_raw = functools.lru_cache(maxsize=cache_items)(self._decode)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.get(idx, epoch=0)

    def get(self, idx, epoch: int):
        item = self.items[idx]
        raw = self._cached(item)
        return self._build(item, raw, _item_rng(self.seed, epoch, idx))

    def _cached(self, item):
        # lru_cache is not atomic under threads; a lock keeps the decode from
        # running num_workers times for the same (hot, repeated) item
        with self._lock:
            count("data.fetches")
            return self._load_raw(item)

    def _decode(self, item):
        """The decode cache's miss path."""
        count("data.cache_misses")
        with span("data.decode"):
            return self._load_raw_impl(item)

    def raw_dir(self, item) -> Path:
        return self.datasetdir / "raw" / self.splitsdir / item

    def processed_dir(self, item) -> Path:
        return self.datasetdir / "processed" / self.splitsdir / item

    def _read_focal_length(self, item) -> float:
        from sv3d_tpu_torch.geometry.camera import read_intrinsics

        per_sample = self.raw_dir(item) / "intrinsic.txt"
        path = per_sample if per_sample.exists() else self.datasetdir / "intrinsics.txt"
        return read_intrinsics(path).focal_length

    def _load_occupancy_sets(self, item):
        """[(points, occupancies)] per sigma, float32/float32."""
        sets = []
        for sigma in SIGMAS:
            with np.load(self.processed_dir(item) / f"occupancy_{sigma}.npz") as z:
                sets.append(
                    (
                        z["points"].astype(np.float32),
                        z["occupancies"].astype(np.float32),
                    )
                )
        return sets

    def _subsample_points(self, sets, num_points, rng):
        """Per-sigma random subsample WITH replacement (reference
        scene_net_data.py:72: np.random.randint draws)."""
        pts, occ = [], []
        for p, o in sets:
            sel = rng.integers(0, p.shape[0], num_points)
            pts.append(p[sel])
            occ.append(o[sel])
        return np.concatenate(pts, axis=0), np.concatenate(occ, axis=0)

    # subclasses implement
    def _load_raw_impl(self, item):
        raise NotImplementedError

    def _build(self, item, raw, rng):
        raise NotImplementedError


def _load_normalized_rgb(path, flip_lr=False, resize_input=False, resize_w=256):
    """rgb.png -> (H, W, 3) float32 in [-1, 1] (SquarePad+Resize optional;
    reference scene_net_data.py:34-45 transform stack, NHWC here)."""
    from sv3d_tpu_torch.io.image import load_rgb, square_pad_resize

    img = load_rgb(path, flip_lr=flip_lr)
    if resize_input:
        img = square_pad_resize(img, resize_w)
    return ((img - 0.5) / 0.5).astype(np.float32)


class SceneNetDataset(_SplitDataset):
    """End-to-end samples: {name, mesh, rgb, points, occupancies,
    depthmap_target} (reference scene_net_data.py:95-103)."""

    overfit_factor = 50

    def __init__(
        self,
        split,
        datasetdir,
        num_points: int = 2048,
        splitsdir: str = "overfit",
        resize_input: bool = False,
        resize_w: int = 256,
        seed: int = 0,
        flip_x_about: float | None = None,
    ):
        super().__init__(split, datasetdir, splitsdir, seed=seed)
        self.num_points = int(num_points)
        self.resize_input = bool(resize_input)
        self.resize_w = int(resize_w)
        #: normed-grid-space mirror constant A: a 50%-probability horizontal
        #: flip maps query points to A - p[..., 0] while rgb/depth columns
        #: reverse.  A = 2*camera2frustum[0,3]/dims[0] - 1 makes the label
        #: mirror EXACT for the pixel-grid mirror (cx = (W-1)/2); the trainer
        #: computes it from its FrustumGrid (see Config.flip_aug).
        self.flip_x_about = None if flip_x_about is None else float(flip_x_about)

    def _load_raw_impl(self, item):
        from sv3d_tpu_torch.io.exr import read_exr_channel

        raw = self.raw_dir(item)
        rgb = _load_normalized_rgb(
            raw / "rgb.png", False, self.resize_input, self.resize_w
        )
        # the flipped variant decodes with flip_lr=True, i.e. the RAW image
        # is mirrored BEFORE SquarePad+Resize: flipping the padded/resized
        # output instead is only equivalent when the horizontal padding is
        # symmetric (true for 320x240, but a portrait/odd-pad input would
        # shift rgb ~1px against the mirrored depth target).  Cached per
        # item, so the extra decode is one-time per LRU fill.
        rgb_flipped = (
            _load_normalized_rgb(
                raw / "rgb.png", True, self.resize_input, self.resize_w
            )
            if self.flip_x_about is not None
            else None
        )
        distance = read_exr_channel(raw / "distance.exr", "R")
        depth = _distance_to_depth_np(distance, self._read_focal_length(item))
        return {
            "rgb": rgb,
            "rgb_flipped": rgb_flipped,
            "depth": depth,
            "mesh": str(raw / "mesh.obj"),
            "occ_sets": self._load_occupancy_sets(item),
        }

    def _build(self, item, raw, rng):
        points, occupancies = self._subsample_points(
            raw["occ_sets"], self.num_points, rng
        )
        rgb, depth = raw["rgb"], raw["depth"]
        out = {}
        if self.flip_x_about is not None:
            flipped = rng.random() < 0.5
            if flipped:
                # exact-mirror augmentation: reversing image columns mirrors
                # the back-projected cloud in camera x (X -> -X, exact when
                # cx = (W-1)/2), and the supervision points mirror about the
                # same plane in normed grid space (p0 -> A - p0).  Occupancy
                # labels are invariant:
                # occ_mirrored_scene(mirror(p)) == occ_scene(p).
                rgb = raw["rgb_flipped"]
                depth = np.ascontiguousarray(depth[:, ::-1])
                points = points.copy()
                points[:, 0] = self.flip_x_about - points[:, 0]
            # the flag rides the batch so mid-step host labeling
            # (subsample_points) can mirror the projected cloud back before
            # querying the UNFLIPPED GT mesh (trainer _occupancies_with_pc)
            out["flipped"] = np.float32(flipped)
        return {
            **out,
            "name": item,
            "mesh": raw["mesh"],
            "rgb": rgb,
            "points": points,
            "occupancies": occupancies,
            "depthmap_target": depth,
        }


class DepthDataset(_SplitDataset):
    """UNet depth-regression samples: {name, input, target}, both left-right
    flipped relative to the raw render (reference scenes_dataset.py:58-67)."""

    overfit_factor = 500

    def __init__(
        self,
        split,
        datasetdir,
        splitsdir: str = "overfit",
        resize_input: bool = False,
        resize_w: int = 256,
        seed: int = 0,
    ):
        super().__init__(split, datasetdir, splitsdir, seed=seed)
        self.resize_input = bool(resize_input)
        self.resize_w = int(resize_w)

    def _load_raw_impl(self, item):
        from sv3d_tpu_torch.io.exr import read_exr_channel

        raw = self.raw_dir(item)
        rgb = _load_normalized_rgb(
            raw / "rgb.png", True, self.resize_input, self.resize_w
        )
        distance = read_exr_channel(raw / "distance.exr", "R")
        depth = _distance_to_depth_np(distance, self._read_focal_length(item))
        return {"rgb": rgb, "depth": np.ascontiguousarray(depth[:, ::-1])}

    def _build(self, item, raw, rng):
        return {"name": item, "input": raw["rgb"], "target": raw["depth"]}


class ImplicitDataset(_SplitDataset):
    """IF-Net-only samples on precomputed grids: {name, input, points,
    occupancies[, target]} (reference implicit_dataset.py:49-56).  input is the
    (D0, D1, D2, 1) binary depth grid; target — the GT distance field — is
    attached when processed/<item>/target.df exists."""

    overfit_factor = 50

    def __init__(
        self,
        split,
        datasetdir,
        num_points: int = 2048,
        splitsdir: str = "overfit",
        seed: int = 0,
        scale_factor: int = 1,
    ):
        super().__init__(split, datasetdir, splitsdir, seed=seed)
        self.num_points = int(num_points)
        self.scale_factor = int(scale_factor)

    def _load_raw_impl(self, item):
        proc = self.processed_dir(item)
        with np.load(proc / "depth_grid.npz") as z:
            grid = z["grid"].astype(np.float32)[..., None]
        target = None
        df_path = proc / "target.df"
        if df_path.exists():
            from sv3d_tpu_torch.io.volume import read_df

            target = read_df(df_path, self.scale_factor).astype(np.float32)[..., None]
        return {
            "grid": grid,
            "target": target,
            "occ_sets": self._load_occupancy_sets(item),
        }

    def _build(self, item, raw, rng):
        points, occupancies = self._subsample_points(
            raw["occ_sets"], self.num_points, rng
        )
        out = {
            "name": item,
            "input": raw["grid"],
            "points": points,
            "occupancies": occupancies,
        }
        if raw["target"] is not None:
            out["target"] = raw["target"]
        return out
