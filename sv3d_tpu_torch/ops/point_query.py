"""Plain torch versions of the fused point-query kernels: one pyramid level's
trilinear features at the 7 displaced copies of arbitrary points, and the
two halves of its backward.

  level_features_plain        <- sv3d_tpu/ops/pallas/point_query.py::level_features (K4)
  level_features_banded_plain <- sv3d_tpu/ops/pallas/point_query.py::level_features_banded (K5)
  level_fc0_plain             <- sv3d_tpu/ops/pallas/point_query.py::level_fc0_banded (K6, f32
                                 and bf16)
  level_grad_points_plain     <- sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_points (K7)
  level_grad_vol_plain        <- sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_vol (K8)

Levels are the port's channel-major flats (B, C, G0*G1*G2); coordinates are
three (B, N) arrays in [-1, 1]; features are (B, N, 7*C) f32,
displacement-major within the level (index d * C + c).  The TPU kernels'
query bucketing (bucket_queries, tile padding, the sentinel slots) is TPU
layout and has no counterpart here; so is the 2-D (slab, band) bucketing of
K5 and K6, whose band count has no meaning in the port.

The forward is the exact f32 gather sampler (K6 in bf16 adds the JAX
kernel's rounding points); the backward halves are its
autograd, so the derivative convention is the floor/frac one of the XLA
gather path (d frac / d ix = 1, corners masked by their validity).  These
are what a CPU tensor runs and what the CUDA kernels
(sv3d_tpu_torch/ops/cuda/point_query.py) are held against on the card.
"""

from __future__ import annotations

import torch

from sv3d_tpu_torch.ops.grid_sample import displacement_axes, sample_trilinear_flat
from sv3d_tpu_torch.ops.mlp import COMPUTE_DTYPES, rounded


def level_features_plain(flat, p0, p1, p2, dims, align_corners: bool, displacement: float):
    """(B, C, G) level, (B, N) coords -> (B, N, 7*C) displaced features."""
    b, c, _ = flat.shape
    n = p0.shape[1]
    pd = displacement_axes((p0, p1, p2), displacement)
    f = sample_trilinear_flat(flat, dims, pd, align_corners)  # (B, C, 7N)
    return f.reshape(b, c, 7, n).permute(0, 3, 2, 1).reshape(b, n, 7 * c)


def level_features_banded_plain(flat, p0, p1, p2, dims, align_corners: bool,
                                displacement: float):
    """K4's features rounded to bfloat16 (round to nearest even): (B, N, 7*C).
    A bf16 level is interpolated in f32 from its exact f32 values."""
    return level_features_plain(flat.float(), p0, p1, p2, dims, align_corners,
                                displacement).to(torch.bfloat16)


def level_fc0_plain(flat, w0l, p0, p1, p2, dims, align_corners: bool, displacement: float,
                    compute_dtype=torch.float32):
    """One level's fc0 partial: K4's features (B, N, 7*C) times the level's
    (7*C, H) block of fc0, rows d*C + c (K4's feature order): (B, N, H) f32.
    compute_dtype bfloat16: the JAX kernel's class -- the level, each
    interpolated feature (f32 interpolation), the block and the partial
    rounded to bf16; the products of bf16 values exact in f32, f32 sums."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"level_fc0: compute_dtype must be one of {COMPUTE_DTYPES}")
    if compute_dtype == torch.float32:
        return level_features_plain(flat, p0, p1, p2, dims, align_corners, displacement) @ w0l
    f = level_features_plain(rounded(flat.float()), p0, p1, p2, dims, align_corners,
                             displacement)
    return rounded(rounded(f) @ rounded(w0l.float()))


def level_grad_points_plain(flat, p0, p1, p2, g, dims, align_corners: bool,
                            displacement: float):
    """d features / d coords contracted with g (B, N, 7*C): (B, N, 3)."""
    with torch.enable_grad():
        ps = [p.detach().requires_grad_() for p in (p0, p1, p2)]
        out = level_features_plain(flat.detach(), *ps, dims, align_corners, displacement)
        grads = torch.autograd.grad(out, ps, g)
    return torch.stack(grads, dim=-1)


def level_grad_vol_plain(p0, p1, p2, g, dims, align_corners: bool, displacement: float):
    """d features / d level contracted with g (B, N, 7*C): (B, C, G).  The
    features are linear in the level, so this is the transposed gather,
    taken as the autograd of the sampler over a zero level."""
    b, n, sevenc = g.shape
    g_total = int(dims[0]) * int(dims[1]) * int(dims[2])
    with torch.enable_grad():
        vol = torch.zeros((b, sevenc // 7, g_total), dtype=g.dtype, device=g.device,
                          requires_grad=True)
        out = level_features_plain(vol, p0.detach(), p1.detach(), p2.detach(), dims,
                                   align_corners, displacement)
        (grad,) = torch.autograd.grad(out, vol, g)
    return grad
