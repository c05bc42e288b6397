"""Minimal OpenEXR scanline codec (pure Python + numpy + zlib); a copy of
sv3d_tpu/io/exr.py.

The reference reads distance/normal maps with pyexr (OpenEXR C++ bindings,
e.g. dataset/scene_net_data.py:79) and writes depth visualizations the same
way (util/visualize.py:49).  Neither pyexr nor OpenEXR bindings are available
in this image, so this module implements the subset of EXR needed by the
3D-Front renders: single-part scanline files, FLOAT/HALF channels, NONE /
ZIPS / ZIP compression, increasing or decreasing line order.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXEL_SIZES = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}

# compression ids
_NONE, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_NONE: 1, _ZIPS: 1, _ZIP: 16}


def _read_attributes(data: bytes, off: int):
    attrs = {}
    while True:
        end = data.index(b"\x00", off)
        name = data[off:end].decode()
        off = end + 1
        if name == "":
            break
        end = data.index(b"\x00", off)
        typ = data[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<i", data, off)
        off += 4
        attrs[name] = (typ, data[off : off + size])
        off += size
    return attrs, off


def _parse_channels(raw: bytes):
    """chlist: sequence of (name, int32 pixel_type, pLinear+reserved, int32 xs,
    int32 ys), terminated by an empty name."""
    channels = []
    off = 0
    while raw[off] != 0:
        end = raw.index(b"\x00", off)
        name = raw[off:end].decode()
        off = end + 1
        pixel_type, _plin, xs, ys = struct.unpack_from("<iiii", raw, off)
        off += 16
        channels.append((name, pixel_type, xs, ys))
    return channels


def _unfilter_zip(raw: bytes) -> bytes:
    """Undo OpenEXR's zip pre-filter: delta-decode then de-interleave."""
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    d = (np.cumsum(d - 128) + 128).astype(np.uint8)
    out = np.empty_like(d)
    half = (len(d) + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _filter_zip(raw: bytes) -> bytes:
    """OpenEXR zip pre-filter: interleave-split then delta-encode."""
    d = np.frombuffer(raw, dtype=np.uint8)
    inter = np.concatenate([d[0::2], d[1::2]]).astype(np.int64)
    out = np.empty_like(inter)
    out[0] = inter[0]
    out[1:] = inter[1:] - inter[:-1] + 128
    return (out & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str | Path) -> dict:
    """Read a scanline EXR file -> {channel_name: (H, W) float32/uint32 array}."""
    data = Path(path).read_bytes()
    magic, _version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    attrs, off = _read_attributes(data, 8)

    channels = _parse_channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {compression} not supported")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (height + lpb - 1) // lpb

    # scanline offset table
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, off)

    row_bytes = sum(_PIXEL_SIZES[c[1]] * width for c in channels)
    out = {
        name: np.empty((height, width), dtype=_PIXEL_DTYPES[pt])
        for name, pt, _, _ in channels
    }
    for block_off in offsets:
        y, size = struct.unpack_from("<ii", data, block_off)
        payload = data[block_off + 8 : block_off + 8 + size]
        n_lines = min(lpb, ymax - y + 1)
        expect = row_bytes * n_lines
        if compression in (_ZIPS, _ZIP) and size < expect:
            payload = _unfilter_zip(zlib.decompress(payload))
        raw = np.frombuffer(payload, dtype=np.uint8)
        pos = 0
        for line in range(n_lines):
            for name, pt, _, _ in channels:
                nb = _PIXEL_SIZES[pt] * width
                row = raw[pos : pos + nb].view(_PIXEL_DTYPES[pt])
                out[name][y - ymin + line] = row
                pos += nb
    return {
        k: (v.astype(np.float32) if v.dtype == np.float16 else v)
        for k, v in out.items()
    }


def read_exr_channel(path: str | Path, channel: str = "R") -> np.ndarray:
    """Read one channel as (H, W) float32 (pyexr .get(ch)[:, :, 0] analog)."""
    chans = read_exr(path)
    if channel not in chans:
        raise KeyError(f"{path}: channel {channel!r} not in {sorted(chans)}")
    return chans[channel]


def write_exr(path: str | Path, channels: dict | np.ndarray, compress: bool = True):
    """Write a scanline EXR.  `channels` is {name: (H, W) float32} or a single
    (H, W) array (written as channel 'Z', matching pyexr.write of depth maps in
    reference util/visualize.py:49)."""
    if isinstance(channels, np.ndarray):
        channels = {"Z": channels}
    names = sorted(channels)
    arrays = [np.ascontiguousarray(channels[n], dtype=np.float32) for n in names]
    h, w = arrays[0].shape
    for a in arrays:
        assert a.shape == (h, w), "all channels must share one shape"

    compression = _ZIP if compress else _NONE
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = (h + lpb - 1) // lpb

    def attr(name, typ, val):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(val)) + val

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = struct.pack("<ii", _MAGIC, 2)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([compression]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    blocks = []
    for b in range(n_blocks):
        y0 = b * lpb
        n_lines = min(lpb, h - y0)
        raw = b"".join(
            arrays[ci][y0 + line].tobytes()
            for line in range(n_lines)
            for ci in range(len(names))
        )
        if compression == _ZIP:
            comp = zlib.compress(_filter_zip(raw))
            payload = comp if len(comp) < len(raw) else raw
        else:
            payload = raw
        blocks.append((y0, payload))

    out = bytearray(header)
    table_off = len(out)
    out += b"\x00" * (8 * n_blocks)
    offsets = []
    for y0, payload in blocks:
        offsets.append(len(out))
        out += struct.pack("<ii", y0, len(payload)) + payload
    struct.pack_into(f"<{n_blocks}Q", out, table_off, *offsets)
    Path(path).write_bytes(bytes(out))
