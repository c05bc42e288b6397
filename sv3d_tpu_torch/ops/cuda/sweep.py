"""Wrapper of the CUDA dense-lattice sweep kernel (sv3d_tpu_torch/csrc/sweep.cu).

Replaces sv3d_tpu/ops/pallas/sweep.py::fused_sweep_tail.  Its contract is the
logits of the unfused IF-Net lattice query (sv3d_tpu/models/ifnet.py:648-735)
for lattice rows [row_offset, row_offset + rows): 7 displaced trilinear
resizes of every pyramid level, fc0 over the displacement-major feature
vector (index d * sumC + c), then the decoder MLP.  lattice_sweep_plain is
that math in plain f32 torch (slab_features + the decoder); a CPU tensor
runs it, a CUDA tensor launches the kernel or raises.  Inference only.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.lattice import axis0_rows, axis_taps, slab_features
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain


def lattice_sweep_plain(
    levels, mlp, r: tuple, rows: int, row_offset: int, align_corners: bool,
    displacement: float,
) -> torch.Tensor:
    """Plain f32 torch lattice logits: (B, rows, r1, r2).

    levels: iterable of (flat (B, C, g0*g1*g2), dims); mlp: [(weight (out,
    in), bias (out,))] for fc0, fc1, fc2, fc_out; r: lattice (r0, r1, r2)."""
    f = slab_features(levels, r, rows, row_offset, align_corners, displacement)
    return fused_point_mlp_plain(f, *(t for layer in mlp for t in layer)).reshape(
        f.shape[0], rows, r[1], r[2])


def sweep_tables(chans, dims_list, r, rows, row_offset, align_corners, displacement):
    """Per-level 2-tap tables for the kernel.

    Returns (meta (L, 8) int32, tap_idx (E, 2) int32, tap_w (E, 2) f32).  meta
    rows are [C, g0, g1, g2, off0, off1, off2, cg] with cg the level's first
    global channel and off* the entry offsets of its axis tables; a level's
    block holds its axis-0, axis-1 and axis-2 tables, each the
    (center, minus, plus) variants back to back with one entry per output
    index (axis 0: the slab's rows only)."""
    dims = np.asarray(dims_list, np.int64)  # (L, 3)
    shifts = np.asarray([0.0, -displacement, displacement])[:, None]
    idx, wts = [], []
    for ax in range(3):
        # axis_taps broadcasts: (L, 3 variants, r) taps of every level at once
        i0, w0, i1, w1 = axis_taps(r[ax], dims[:, ax, None, None], align_corners, shifts)
        i, w = np.stack([i0, i1], axis=-1), np.stack([w0, w1], axis=-1)
        if ax == 0:
            i = np.moveaxis(axis0_rows(np.moveaxis(i, 2, 0), rows, row_offset), 0, 2)
            w = np.moveaxis(axis0_rows(np.moveaxis(w, 2, 0), rows, row_offset), 0, 2)
        idx.append(i.reshape(len(dims), -1, 2))
        wts.append(w.reshape(len(dims), -1, 2))
    block = 3 * (rows + r[1] + r[2])
    base = np.arange(len(dims)) * block
    meta = np.zeros((len(dims), 8), np.int32)
    meta[:, 0] = chans
    meta[:, 1:4] = dims
    meta[:, 7] = np.cumsum([0, *chans[:-1]])
    meta[:, 4:7] = np.stack([base, base + 3 * rows, base + 3 * (rows + r[1])], axis=1)
    return (
        meta,
        np.ascontiguousarray(np.concatenate(idx, axis=1).reshape(-1, 2)),
        np.ascontiguousarray(np.concatenate(wts, axis=1).reshape(-1, 2)),
    )


def _bind():
    fn = build.load().sv3d_lattice_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(levels, mlp, device):
    for flat, dims in levels:
        if flat.device != device or flat.dtype != torch.float32:
            raise TypeError("lattice_sweep: every level must be float32 on one CUDA device")
        if flat.ndim != 3 or flat.shape[2] != int(np.prod(dims)) or not flat.is_contiguous():
            raise ValueError(
                f"lattice_sweep: level must be contiguous (B, C, {dims}) flat, "
                f"got {tuple(flat.shape)}"
            )
        if flat.requires_grad:
            raise NotImplementedError("lattice_sweep is inference-only")
    (w0, _), (w1, _), (w2, _), (w3, _) = mlp
    h0 = w0.shape[0]
    if h0 not in (256, 512) or tuple(w1.shape) != (256, h0) or tuple(w2.shape) != (256, 256) \
            or tuple(w3.shape) != (1, 256):
        raise ValueError(
            "lattice_sweep: the kernel takes fc0 -> 256|512, fc1 -> 256, fc2 -> 256, "
            f"fc_out -> 1; got {[tuple(w.shape) for w, _ in mlp]}"
        )
    for w, bias in mlp:
        if w.device != device or w.dtype != torch.float32 or bias.device != device \
                or bias.dtype != torch.float32:
            raise TypeError("lattice_sweep: MLP weights must be float32 on the levels' device")


def lattice_sweep(
    levels, mlp, r: tuple, rows: int, row_offset: int, align_corners: bool,
    displacement: float,
) -> torch.Tensor:
    """Lattice logits (B, rows, r1, r2) for rows [row_offset, row_offset+rows)
    of the (r0, r1, r2) lattice; same arguments as lattice_sweep_plain."""
    levels = list(levels)
    device = levels[0][0].device
    if device.type == "cpu":
        return lattice_sweep_plain(levels, mlp, r, rows, row_offset, align_corners, displacement)
    if device.type != "cuda":
        raise ValueError(f"lattice_sweep: unsupported device {device}")
    if len(mlp) != 4:
        raise ValueError(f"lattice_sweep: expected 4 MLP layers, got {len(mlp)}")
    _check_cuda_inputs(levels, mlp, device)
    b = levels[0][0].shape[0]
    chans = [flat.shape[1] for flat, _ in levels]
    sum_c = sum(chans)
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = mlp
    if w0.shape[1] != 7 * sum_c:
        raise ValueError(f"lattice_sweep: fc0 takes {w0.shape[1]} features, levels give {7 * sum_c}")

    meta, tap_idx, tap_w = sweep_tables(
        chans, [d for _, d in levels], r, rows, row_offset, align_corners, displacement
    )
    meta_d = torch.from_numpy(meta).to(device)
    idx_d = torch.from_numpy(tap_idx).to(device)
    w_d = torch.from_numpy(tap_w).to(device)
    ptrs = torch.tensor([flat.data_ptr() for flat, _ in levels], dtype=torch.int64).to(device)
    w0t, w1t, w2t = (w.t().contiguous() for w in (w0, w1, w2))
    w3c, b0c, b1c, b2c, b3c = (t.contiguous() for t in (w3, b0, b1, b2, b3))
    out = torch.empty((b, rows, r[1], r[2]), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _bind()(
        ptrs.data_ptr(), meta_d.data_ptr(), len(levels), idx_d.data_ptr(), w_d.data_ptr(),
        w0t.data_ptr(), b0c.data_ptr(), w1t.data_ptr(), b1c.data_ptr(), w2t.data_ptr(),
        b2c.data_ptr(), w3c.data_ptr(), b3c.data_ptr(), out.data_ptr(),
        b, rows, r[1], r[2], sum_c, w0.shape[0], max(chans), stream,
    )
    build.check(rc, "sv3d_lattice_sweep")
    lattice_sweep.launches += 1
    return out


lattice_sweep.launches = 0
