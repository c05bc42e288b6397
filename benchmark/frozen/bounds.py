"""The least time the card could take for a piece of work, from the H100
SXM's published peaks (NVIDIA's data sheet, dense, at its 700 W limit), and
the operations and bytes of the kernels that FlopCounterMode cannot see.

K2's bound is the separable minimum of the dense sweep, with the axis-0
slices it must read worked out from the lattice's geometry alone (a frozen
copy of chip_smoke.py's bound, separable_interp_flops and sweep_bound)."""

from __future__ import annotations

import itertools
import math

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

#: K1's f32 operations a point (8 corner weights and their sums), K1b's
K1_FLOPS_PER_POINT = 32.0
K1B_FLOPS_PER_POINT = 48.0


def bound_ms(n_bytes: float, flops: float, tensor_flops: float = 0.0) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    bandwidth and the operations over their unit's peak, the f32 units and
    the tensor cores at work at once."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, tensor_flops / PEAK_BF16_TENSOR_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_dims(dims, n_stages: int) -> list:
    """The pyramid's grid shapes: the input, then each stage's (a 2x
    max-pool between stages, a size-1 axis staying 1)."""
    out = [tuple(dims), tuple(dims)]
    d = tuple(dims)
    for _ in range(n_stages - 1):
        d = tuple(max(x // 2, 1) if x > 1 else 1 for x in d)
        out.append(d)
    return out


def touched_slices(r0: int, g0: int, align_corners: bool, displacement: float) -> int:
    """How many axis-0 slices of a level of g0 slices the lattice's r0 rows
    read: the distinct taps of nonzero weight of the centre and the two
    displaced copies."""
    x = 2.0 * np.linspace(-0.5, 0.5, r0)
    seen = set()
    for s in (0.0, -displacement, displacement):
        c = x + s
        ix = (c + 1.0) * 0.5 * (g0 - 1.0) if align_corners else ((c + 1.0) * g0 - 1.0) * 0.5
        i0 = np.floor(ix)
        f = ix - i0
        for idx, w in ((i0, 1.0 - f), (i0 + 1.0, f)):
            ok = (idx >= 0) & (idx <= g0 - 1) & (w.astype(np.float32) != 0)
            seen.update(idx[ok].astype(int).tolist())
    return len(seen)


def separable_interp_flops(size_in, size_out) -> float:
    """The least f32 operations to resize one channel of a level to the 7
    displaced copies of a lattice: one axis at a time, 3 a 2-tap lerp, the
    copies sharing every pass they have in common, the cheapest axis order."""
    best = float("inf")
    for order in itertools.permutations(range(3)):
        size, ops = list(size_in), 0.0
        for copies, ax in zip((3, 5, 7), order):
            size[ax] = size_out[ax]
            ops += 3.0 * copies * math.prod(size)
        best = min(best, ops)
    return best


def sweep_work(chans, dims_list, r, decoder, align_corners: bool, displacement: float,
               itemsize: int = 2) -> dict:
    """K2's work over the whole lattice r, batch 1: bytes (the touched
    slices of every level and the weights in itemsize bytes, f32 biases, f32
    logits out), f32 operations (the separable interpolation and fc_out) and
    tensor-core operations (fc0..fc2).  decoder: [in, h0, h1, h2, 1]."""
    n = math.prod(r)
    slices = [touched_slices(r[0], g[0], align_corners, displacement) for g in dims_list]
    pairs = list(zip(decoder[:-1], decoder[1:]))
    n_bytes = (sum(s * g[1] * g[2] * c * itemsize for c, g, s in zip(chans, dims_list, slices))
               + sum(a * b for a, b in pairs) * itemsize + sum(b for _, b in pairs) * 4 + n * 4)
    interp = sum(c * separable_interp_flops((s, g[1], g[2]), r)
                 for c, g, s in zip(chans, dims_list, slices))
    mlp = 2.0 * n * sum(a * b for a, b in pairs)
    fc_out = 2.0 * n * decoder[-2] * decoder[-1]
    return {"bytes": n_bytes, "flops": interp + fc_out, "tensor_flops": mlp - fc_out}


def sweep_bound_ms(work: dict) -> tuple:
    return bound_ms(work["bytes"], work["flops"], work["tensor_flops"])
