"""Wrappers of the CUDA dense-lattice sweep kernels (sv3d_tpu_torch/csrc/sweep.cu).

  lattice_sweep_f32_cuda   K2 f32, compute_dtype float32 (the parity route)
  lattice_sweep_bf16_cuda  K2 bf16, compute_dtype bfloat16 (the serving default)

Both replace sv3d_tpu/ops/pallas/sweep.py::fused_sweep_tail.  Their contract
is the logits of the unfused IF-Net lattice query
(sv3d_tpu/models/ifnet.py:648-735) for lattice rows [row_offset, row_offset
+ rows): 7 displaced trilinear resizes of every pyramid level, fc0 over the
displacement-major feature vector (index d * sumC + c), then the decoder
MLP, in the compute dtype's precision class.  lattice_sweep_plain is that
math in plain torch (slab_features + the decoder, with bf16 rounding points
for compute_dtype=torch.bfloat16).

A sweep is prepared once (SweepPlan: the 2-tap tables of the whole lattice,
the level pointers, the weights in the kernel's layouts, the pyramid staged
channels-last, in bf16 for the bf16 kernel) and then launched once per slab by
lattice_sweep(plan, rows, row_offset), which does no host-to-device copy and
no weight transform.  A plan on CPU levels runs the plain version; on CUDA
levels lattice_sweep launches the kernel of the plan's dtype or raises.
Inference only.  A plan holds copies of everything it reads and records
which levels and weights it was made from (SweepPlan.check): after the
weights change in place, or for another pyramid, build a new one.
"""

from __future__ import annotations

import ctypes
import functools
import numpy as np
import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.cuda.layouts import (
    fragment_order,
    matches_record,
    mma_b_fragments,
    stage_channels_last,
    tensor_record,
)
from sv3d_tpu_torch.ops.lattice import axis0_rows, axis_taps, slab_features
from sv3d_tpu_torch.ops.mlp import COMPUTE_DTYPES
from sv3d_tpu_torch.ops.mlp import rounded as _rounded

K2_TOL = 1e-4  # K2 f32: FMA vs plain f32 contractions, summation order only (csrc/sweep.cu)
# K2 bf16 against its plain bf16 version: the same rounding points (levels,
# features, weights and hidden activations to bf16), f32 sums in another
# order, so a value within f32 noise of a bf16 rounding boundary may round
# either way: one bf16 ulp of a feature or a hidden activation.  atol on
# logits; measured 4.8e-4 at |logit| <= 0.10 on the H100.  Such flips touch
# a few of a point's roundings, so over the lattice the mean error stays far
# below the logits' own scale: mean |error| <= K2_BF16_REL_MEAN_TOL x mean
# |logit| (measured 1.2e-4).  A sweep that rounds at other points is off at
# every point by about a rounding error, within the max limit but above the
# mean one (plain_bf16_sweep with a rounding point left out; phase 3 shows
# that both such sweeps fail).
K2_BF16_TOL = 2e-3
K2_BF16_REL_MEAN_TOL = 1e-3


def lattice_sweep_plain(
    levels, mlp, r: tuple, rows: int, row_offset: int, align_corners: bool,
    displacement: float, compute_dtype=torch.float32,
) -> torch.Tensor:
    """Plain torch lattice logits: (B, rows, r1, r2).

    levels: iterable of (flat (B, C, g0*g1*g2), dims); mlp: [(weight (out,
    in), bias (out,))] for fc0, fc1, fc2, fc_out; r: lattice (r0, r1, r2).
    compute_dtype float32: f32 throughout.  bfloat16: the JAX fused tail's
    class, in f32 arithmetic with its rounding points -- levels, the
    interpolated feature, the four weights and each ReLU output rounded to
    bf16; f32 interpolation, accumulation and biases.  One lattice row at a
    time, so that, as in the kernels, a point's logit does not depend on the
    slab it came in (a CPU matmul's summation order may follow its shape)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"lattice_sweep: compute_dtype must be one of {COMPUTE_DTYPES}")
    levels = [(_rounded(flat, compute_dtype), dims) for flat, dims in levels]
    mlp = [(_rounded(w, compute_dtype), b) for w, b in mlp]
    out = []
    for row in range(row_offset, row_offset + rows):
        h = _rounded(slab_features(levels, r, 1, row, align_corners, displacement),
                     compute_dtype)
        for i, (w, b) in enumerate(mlp):
            h = torch.einsum("hf,bfn->bhn", w, h) + b[:, None]
            if i < len(mlp) - 1:
                h = _rounded(torch.relu(h), compute_dtype)
        out.append(h[:, 0].reshape(h.shape[0], 1, r[1], r[2]))
    return torch.cat(out, dim=1)


def sweep_tables(chans, dims_list, r, rows, row_offset, align_corners, displacement):
    """Per-level 2-tap tables of lattice rows [row_offset, row_offset + rows).

    Returns (meta (L, 8) int32, tap_idx (E, 2) int32, tap_w (E, 2) f32).  meta
    rows are [C, g0, g1, g2, off0, off1, off2, cg] with cg the level's first
    global channel and off* the entry offsets of its axis tables; a level's
    block holds its axis-0, axis-1 and axis-2 tables, each the
    (center, minus, plus) variants back to back with one entry per output
    index (axis 0: the slab's rows only, zero past the lattice).  A plan
    holds the whole lattice's tables, rows = r0 and row_offset = 0."""
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


def fc0_chunk_order(chans):
    """K2's fixed fc0 K order (both dtypes): (groups, cols).  groups: (level, d, k16
    chunks, 0) per (d, level) group, d = -1 for a one-channel level whose 7
    copies share one packed chunk (those first), then d-major the levels of
    C % 16 == 0.  cols: for each of the 16 * chunks K positions the fc0
    column it holds, d * sumC + cg + c, or -1 for a zero."""
    sum_c = sum(chans)
    cg = np.cumsum([0, *chans[:-1]])
    groups, cols = [], []
    for lv, c in enumerate(chans):
        if c == 1:
            groups.append((lv, -1, 1, 0))
            cols += [d * sum_c + cg[lv] for d in range(7)] + [-1] * 9
    for d in range(7):
        for lv, c in enumerate(chans):
            if c > 1:
                groups.append((lv, d, c // 16, 0))
                cols += [d * sum_c + cg[lv] + i for i in range(c)]
    return np.asarray(groups, np.int32), np.asarray(cols, np.int64)


def fc0_chunk_table(chans) -> np.ndarray:
    """f32 K2's walk over fc0_chunk_order: (k0_chunks, 4) int32, one row a
    16-row chunk of K: (level, d or -1 for a packed one-channel level, the
    chunk's first channel of the level, its group's index)."""
    groups, _ = fc0_chunk_order(chans)
    return np.asarray([(lv, d, 16 * q, g) for g, (lv, d, n, _) in enumerate(groups)
                       for q in range(n)], np.int32).reshape(-1, 4)


def fc0_in_chunk_order(w0: torch.Tensor, chans) -> torch.Tensor:
    """fc0's (H0, 7 sumC) weight as f32 K2 reads it: row-major (16
    k0_chunks, H0), row k the fc0 column that fc0_chunk_order puts at K
    position k, zeros where it puts none."""
    _, cols = fc0_chunk_order(chans)
    keep = np.flatnonzero(cols >= 0)
    out = w0.new_zeros((len(cols), w0.shape[0]))
    out[torch.from_numpy(keep).to(w0.device)] = \
        w0.t()[torch.from_numpy(cols[keep]).to(w0.device)]
    return out


@functools.lru_cache(maxsize=16)
def _fc0_fragment_index(chans: tuple, h0: int, device) -> torch.Tensor:
    """Flat indices into fc0's (H0, 7 sumC) weight, with one zero appended at
    the end (index -1), of mma_b_fragments applied to fc0 permuted to
    fc0_chunk_order; kept on the device (indices, not weights)."""
    _, cols = fc0_chunk_order(list(chans))
    order = fragment_order(h0, len(cols))
    n, kpos = np.divmod(order, len(cols))
    col = cols[kpos]
    flat = np.where(col >= 0, n * (7 * sum(chans)) + col, -1)
    return torch.from_numpy(flat).to(device)


def _check_levels(levels, device):
    for flat, dims in levels:
        if flat.device != device or flat.dtype not in COMPUTE_DTYPES:
            raise TypeError("lattice_sweep: every level must be float32 or bfloat16 (a "
                            "precision-16 pyramid) on one CUDA device")
        if flat.ndim != 3 or flat.shape[2] != int(np.prod(dims)):
            raise ValueError(
                f"lattice_sweep: level must be (B, C, {dims}) flat, got {tuple(flat.shape)}")


def _check_chans(levels):
    for flat, _ in levels:
        c = flat.shape[1]
        if not (c == 1 or (c % 16 == 0 and c <= 128)):
            raise ValueError(f"lattice_sweep: the kernels take levels of C = 1 or C % 16 == 0 "
                             f"up to 128, got {c}")
        if flat.shape[2] * c >= 2**31:
            raise ValueError("lattice_sweep: G * C exceeds the kernels' 32-bit offsets")


def _check_mlp(mlp, device, sum_c):
    if len(mlp) != 4:
        raise ValueError(f"lattice_sweep: expected 4 MLP layers, got {len(mlp)}")
    (w0, _), (w1, _), (w2, _), (w3, _) = mlp
    h0 = w0.shape[0]
    if h0 not in (256, 512) or tuple(w1.shape) != (256, h0) or tuple(w2.shape) != (256, 256) \
            or tuple(w3.shape) != (1, 256):
        raise ValueError(
            "lattice_sweep: the kernels take fc0 -> 256|512, fc1 -> 256, fc2 -> 256, "
            f"fc_out -> 1; got {[tuple(w.shape) for w, _ in mlp]}"
        )
    if w0.shape[1] != 7 * sum_c:
        raise ValueError(f"lattice_sweep: fc0 takes {w0.shape[1]} features, levels give "
                         f"{7 * sum_c}")
    for w, bias in mlp:
        if w.device != device or w.dtype != torch.float32 or bias.device != device \
                or bias.dtype != torch.float32:
            raise TypeError("lattice_sweep: MLP weights must be float32 on the levels' device")


class SweepPlan:
    """What the sweep's kernel reads that no slab changes, prepared once.

    levels: the pyramid, (flat (B, C, G), dims) pairs, each float32 or
    bfloat16 (a precision-16 model's levels 1..: the bf16 kernel reads them
    as they are, the f32 one widened); mlp: [(weight, bias)] of fc0, fc1,
    fc2, fc_out; r: the lattice (r0, r1, r2).  It holds
    copies of all it reads.  On CPU levels: copies of the levels and the
    weights (lattice_sweep runs the plain version on them).  On CUDA levels,
    on the device: the 2-tap tables of all r0 rows and the level pointers;
    for float32 the pyramid staged channels-last, fc0 permuted to
    fc0_chunk_order as (in, out) rows (fc0_in_chunk_order), the transposed
    fc1 and fc2, fc_out and the chunk table (fc0_chunk_table); for bfloat16
    the pyramid cast to bf16 and staged channels-last, fc0 in bf16 permuted
    to fc0_chunk_order and laid out as mma_b_fragments, fc1 and fc2
    likewise, fc_out's weight rounded to bf16 (kept in f32) and the group
    table; copies of the f32 biases.  Levels need C = 1 or C % 16 == 0 up
    to 128 (ValueError otherwise).  check()
    tells whether given levels and weights are those it was made from,
    unchanged."""

    def __init__(self, levels, mlp, r, align_corners: bool, displacement: float,
                 compute_dtype=torch.bfloat16):
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"lattice_sweep: compute_dtype must be one of {COMPUTE_DTYPES}")
        levels = [(flat, tuple(int(x) for x in dims)) for flat, dims in levels]
        mlp = list(mlp)
        self._made_from = ([(tensor_record(flat), dims) for flat, dims in levels],
                           [tensor_record(t) for layer in mlp for t in layer])
        self.levels = [(flat.detach(), dims) for flat, dims in levels]
        self.mlp = [(w.detach(), b.detach()) for w, b in mlp]
        self.r = tuple(int(x) for x in r)
        self.align_corners = bool(align_corners)
        self.displacement = float(displacement)
        self.compute_dtype = compute_dtype
        self.device = self.levels[0][0].device
        self.batch = self.levels[0][0].shape[0]
        if self.device.type == "cpu":
            self.levels = [(flat.clone(), dims) for flat, dims in self.levels]
            self.mlp = [(w.clone(), b.clone()) for w, b in self.mlp]
            return
        if self.device.type != "cuda":
            raise ValueError(f"lattice_sweep: unsupported device {self.device}")
        _check_levels(self.levels, self.device)
        if torch.is_grad_enabled() and any(flat.requires_grad for flat, _ in levels):
            raise NotImplementedError("lattice_sweep is inference-only")
        _check_chans(self.levels)
        chans = [flat.shape[1] for flat, _ in self.levels]
        _check_mlp(self.mlp, self.device, sum(chans))
        self.h0 = self.mlp[0][0].shape[0]
        dev = self.device
        with torch.no_grad():
            meta, tap_idx, tap_w = sweep_tables(chans, [d for _, d in self.levels], self.r,
                                                self.r[0], 0, self.align_corners,
                                                self.displacement)
            self.meta = torch.from_numpy(meta).to(dev)
            self.tap_idx = torch.from_numpy(tap_idx).to(dev)
            self.tap_w = torch.from_numpy(tap_w).to(dev)
            (w0, b0), (w1, b1), (w2, b2), (w3, b3) = self.mlp
            self.biases = [b.clone() for b in (b0, b1, b2, b3)]
            # the pyramid channels-last in the compute dtype (bf16: cast, a
            # copy, then staged, the transpose moving half the bytes of an
            # f32 one); an f32 level of C = 1 stages as a view of the
            # caller's, so the plan copies it
            self.vols = []
            for flat, _ in self.levels:
                cl = stage_channels_last(flat.to(compute_dtype))
                self.vols.append(cl.clone() if cl.data_ptr() == flat.data_ptr() else cl)
            if compute_dtype == torch.float32:
                self.chunks = torch.from_numpy(fc0_chunk_table(chans)).to(dev)
                self.weights = [fc0_in_chunk_order(w0, chans),
                                w1.t().contiguous(), w2.t().contiguous(),
                                w3.reshape(-1).clone()]
            else:
                self._prepare_bf16(chans)
            self.ptrs = torch.tensor([v.data_ptr() for v in self.vols], dtype=torch.int64).to(dev)
        # the device plan reads only its own copies
        self.levels = self.mlp = None

    def check(self, levels, mlp) -> None:
        """Raise ValueError unless levels ((flat, dims) pairs) and mlp
        ([(weight, bias)]) are the tensors this plan was made from, at the
        same storage, shape and dtype, and, where they count versions,
        unchanged in place since."""
        levels = [(flat, tuple(int(x) for x in dims)) for flat, dims in levels]
        params = [t for layer in mlp for t in layer]
        lv, ps = self._made_from
        if len(levels) != len(lv) or len(params) != len(ps) \
                or not all(matches_record(rec, flat) and d == dims for (rec, d), (flat, dims)
                           in zip(lv, levels)) \
                or not all(matches_record(rec, t) for rec, t in zip(ps, params)):
            raise ValueError("lattice_sweep: the plan is stale: it was made from other levels "
                             "or weights, or they changed in place since; make a new plan")

    def _prepare_bf16(self, chans):
        groups, cols = fc0_chunk_order(chans)
        self.groups = torch.from_numpy(groups).to(self.device)
        self.k0_chunks = len(cols) // 16
        (w0, _), (w1, _), (w2, _), (w3, _) = self.mlp
        w0z = torch.cat([w0.reshape(-1), w0.new_zeros(1)]).to(torch.bfloat16)
        self.weights = [w0z[_fc0_fragment_index(tuple(chans), self.h0, self.device)],
                        mma_b_fragments(w1.to(torch.bfloat16)),
                        mma_b_fragments(w2.to(torch.bfloat16)),
                        _rounded(w3, torch.bfloat16).reshape(-1).contiguous()]


def _out(plan, rows):
    return torch.empty((plan.batch, rows, plan.r[1], plan.r[2]), dtype=torch.float32,
                       device=plan.device)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # vols, meta, chunks, k0_chunks, tap_idx, tap_w, w0k, b0, w1t, b1, w2t, b2, w3, b3,
    # out, batch, rows, row_offset, r0, r1, r2, h0, stream
    "sv3d_lattice_sweep": [_P, _P, _P, _I] + [_P] * 11 + [_I] * 7 + [_P],
    # vols, meta, groups, n_groups, tap_idx, tap_w, w0f, k0_chunks, b0, w1f, b1, w2f,
    # b2, w3, b3, out, batch, rows, row_offset, r0, r1, r2, h0, stream
    "sv3d_lattice_sweep_bf16": [_P, _P, _P, _I, _P, _P, _P, _I] + [_P] * 8 + [_I] * 7 + [_P],
}


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    fn = getattr(build.load(), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def lattice_sweep_f32_cuda(plan: SweepPlan, rows: int, row_offset: int) -> torch.Tensor:
    """K2 f32 on a float32 plan: (B, rows, r1, r2) logits."""
    out = _out(plan, rows)
    w0k, w1t, w2t, w3 = plan.weights
    b0, b1, b2, b3 = plan.biases
    rc = _bind("sv3d_lattice_sweep")(
        plan.ptrs.data_ptr(), plan.meta.data_ptr(), plan.chunks.data_ptr(),
        plan.chunks.shape[0], plan.tap_idx.data_ptr(), plan.tap_w.data_ptr(), w0k.data_ptr(),
        b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(), plan.batch, rows, int(row_offset),
        *plan.r, plan.h0, torch.cuda.current_stream(plan.device).cuda_stream)
    build.check(rc, "sv3d_lattice_sweep")
    lattice_sweep_f32_cuda.launches += 1
    return out


def lattice_sweep_bf16_cuda(plan: SweepPlan, rows: int, row_offset: int) -> torch.Tensor:
    """K2 bf16 on a bfloat16 plan: (B, rows, r1, r2) logits."""
    out = _out(plan, rows)
    w0f, w1f, w2f, w3 = plan.weights
    b0, b1, b2, b3 = plan.biases
    rc = _bind("sv3d_lattice_sweep_bf16")(
        plan.ptrs.data_ptr(), plan.meta.data_ptr(), plan.groups.data_ptr(),
        plan.groups.shape[0], plan.tap_idx.data_ptr(), plan.tap_w.data_ptr(), w0f.data_ptr(),
        plan.k0_chunks, b0.data_ptr(), w1f.data_ptr(), b1.data_ptr(), w2f.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(), plan.batch, rows,
        int(row_offset), *plan.r, plan.h0, torch.cuda.current_stream(plan.device).cuda_stream)
    build.check(rc, "sv3d_lattice_sweep_bf16")
    lattice_sweep_bf16_cuda.launches += 1
    return out


def lattice_sweep(plan: SweepPlan, rows: int, row_offset: int) -> torch.Tensor:
    """Lattice logits (B, rows, r1, r2) for rows [row_offset, row_offset +
    rows) of the plan's lattice: the plain version for a CPU plan, else the
    kernel of the plan's compute dtype."""
    if rows < 1:
        raise ValueError(f"lattice_sweep: rows must be positive, got {rows}")
    if plan.device.type == "cpu":
        return lattice_sweep_plain(plan.levels, plan.mlp, plan.r, rows, row_offset,
                                   plan.align_corners, plan.displacement, plan.compute_dtype)
    if plan.compute_dtype == torch.bfloat16:
        return lattice_sweep_bf16_cuda(plan, rows, row_offset)
    return lattice_sweep_f32_cuda(plan, rows, row_offset)


lattice_sweep_f32_cuda.launches = 0
lattice_sweep_bf16_cuda.launches = 0
