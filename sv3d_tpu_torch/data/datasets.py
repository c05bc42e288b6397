"""End-to-end training samples for the port.

sv3d_tpu.data.datasets.SceneNetDataset is numpy host code and is reused as it
is, except for one method: _read_focal_length imports
sv3d_tpu.geometry.camera, which imports jax.numpy.  The subclass here reads
the intrinsics with the port's JAX-free reader instead; samples are the same
{name, mesh, rgb, points, occupancies, depthmap_target[, flipped]} numpy
dicts, batched by sv3d_tpu.data.loader.DataLoader.
"""

from __future__ import annotations

from sv3d_tpu.data.datasets import SceneNetDataset as _SceneNetDataset
from sv3d_tpu_torch.geometry.camera import read_intrinsics


class SceneNetDataset(_SceneNetDataset):
    def _read_focal_length(self, item) -> float:
        per_sample = self.raw_dir(item) / "intrinsic.txt"
        path = per_sample if per_sample.exists() else self.datasetdir / "intrinsics.txt"
        return read_intrinsics(path).focal_length
