"""Binary .df distance-field reader and writer, and the semantics volume
reader (a copy of sv3d_tpu/io/volume.py).

Matches reference data_processing/volume_reader.py:20-62: a .df file is
3 x uint64 dims followed by float32 data in Fortran order.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_df(path: str | Path, scale_factor: int = 1) -> np.ndarray:
    raw = Path(path).read_bytes()
    dx, dy, dz = struct.unpack_from("<3Q", raw, 0)
    df = np.frombuffer(raw, dtype=np.float32, count=dx * dy * dz, offset=24)
    df = df.reshape((dx, dy, dz), order="F")
    if scale_factor != 1:
        df = down_sample(df, scale_factor)
    return np.ascontiguousarray(df)


def write_df(path: str | Path, df: np.ndarray):
    df = np.asarray(df, dtype=np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<3Q", *df.shape))
        f.write(np.asfortranarray(df).tobytes(order="F"))


def down_sample(df: np.ndarray, factor: int = 2) -> np.ndarray:
    """Block-mean downsampling (reference volume_reader.py:47-51).  Handles
    dims not divisible by factor via edge padding with the block mean of the
    partial block, like skimage.measure.block_reduce with cval=0 — the
    reference pads with zeros, so we replicate zero padding exactly."""
    pads = [(0, (-s) % factor) for s in df.shape]
    padded = np.pad(df, pads, mode="constant")
    sx, sy, sz = (s // factor for s in padded.shape)
    return (
        padded.reshape(sx, factor, sy, factor, sz, factor)
        .mean(axis=(1, 3, 5))
        .astype(df.dtype)
    )


def read_semantics(path: str | Path):
    """A .sem volume (3 x uint64 dims, then uint16 labels in Fortran order)
    -> (per-voxel label, per-voxel instance): label * 1000 + instance."""
    raw = Path(path).read_bytes()
    dx, dy, dz = struct.unpack_from("<3Q", raw, 0)
    sem = np.frombuffer(raw, dtype=np.uint16, count=dx * dy * dz, offset=24)
    sem = sem.reshape((dx, dy, dz), order="F")
    return sem / 1000, sem % 1000
