"""Wrappers of the CUDA point-query kernels (sv3d_tpu_torch/csrc/point_query.cu).

  level_features_cuda         K4, replaces sv3d_tpu/ops/pallas/point_query.py::level_features
  level_features_banded_cuda  K5, replaces sv3d_tpu/ops/pallas/point_query.py::level_features_banded
  level_fc0_cuda              K6 f32, replaces sv3d_tpu/ops/pallas/point_query.py::level_fc0_banded
  level_fc0_bf16_cuda         K6 bf16, the same in the JAX kernel's precision class
  level_grad_points_cuda      K7, replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_points
  level_grad_vol_cuda         K8, replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_vol

level_features is the differentiable entry (the counterpart of the JAX
package's level_features_diff custom VJP): an autograd.Function whose forward
runs K4 and whose backward runs K8 for the level's gradient and K7 for the
coordinates' when autograd asks for it.  Each wrapper runs its plain version
(sv3d_tpu_torch/ops/point_query.py) for a CPU tensor and launches its kernel
for a CUDA tensor, or raises.  Every wrapper takes the level as the
channel-major flat (B, C, G) that flatten_grid makes; K4, K5 and K7 read it
channels-last, (B, G, C), and so does K6 f32: their wrapper reads a level
that already lies so as it is and stages any other (stage_channels_last);
K6 bf16 reads a channels-last bf16 copy staged the same way (and K5 reads
one when given a bf16 level).  K8 writes the level's gradient channels-last
and returns it as the (B, C, G) transposed view.  level_features saves the level as it was given,
so K7's wrapper stages a channel-major flat again in the backward.  K5 and
K6 are inference-only, as their TPU kernels have no VJP: under autograd
(grad enabled and an input that requires grad) they raise
NotImplementedError rather than return a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.cuda.layouts import mma_b_fragments, stage_channels_last
from sv3d_tpu_torch.ops.point_query import (
    level_fc0_plain,
    level_features_banded_plain,
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)

# K1b, K4, K7, K8: the same f32 arithmetic in another summation order (FMA,
# corner and channel order; K8's atomics add in a run-dependent order on
# both sides, as the plain version's index_add is atomic too), 1e-5 of the
# plain result's largest magnitude (K8 measured up to 2.9e-6 at full width).
K4_RTOL = K7_RTOL = K8_RTOL = 1e-5
K6_RTOL = 1e-5  # FMA order over at most 7 * 128 terms, of the largest |partial|
# K6 bf16 against its plain bf16 version (the same rounding points: level,
# feature, block and partial): f32 sums in another order may round a feature
# or a partial the other way, one bf16 ulp (2^-8 of the partial at the top),
# so max |error| <= K6_BF16_TOL x max |partial|; such flips are rare, so over
# all the partials mean |error| <= K6_BF16_REL_MEAN_TOL x mean |partial|
# (f64 sums instead of f32 moved the mean by ~2e-7 in a CPU estimate).  A
# version that leaves one rounding point out is off at every partial by
# about a rounding error (1.4e-3 to 2.7e-3 of the mean in the same estimate)
# and fails the mean limit (plain_bf16_fc0 with skip; the points phase shows
# it).
K6_BF16_TOL = 1e-2
K6_BF16_REL_MEAN_TOL = 1e-4
K5_ULP = 2.0 ** -7  # one bf16 ulp: |d| <= 2^-7 |ref| + 1e-6

_TAIL = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _bind(name: str, n_ptr: int, n_int: int = 0):
    fn = getattr(build.load(), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + _TAIL
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(t: torch.Tensor, who: str) -> bool:
    """False for a CPU tensor (plain version), True for CUDA, else raise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {t.device}")
    return True


def _inference_only(who: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{who} (the bands= point-query kernel) is INFERENCE-ONLY: it has no "
            "backward kernel.  For training/gradients use the 1-D path (bands=None), "
            "which routes through level_features and its backward kernels; for "
            "inference run under torch.no_grad() or torch.inference_mode()."
        )


def _check(who: str, device, **tensors) -> None:
    for name, (t, shape) in tensors.items():
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32 on {device}, got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{who}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _tail(b, n, c, dims, align_corners, displacement, device):
    return (b, n, c, *(int(d) for d in dims), int(bool(align_corners)), float(displacement),
            torch.cuda.current_stream(device).cuda_stream)


def _features_kernel(who: str, entry: str, dtype, flat, p0, p1, p2, dims, align_corners,
                     displacement, takes_bf16: bool = False):
    """K4 or K5 on a CUDA level: stage the channels-last copy, launch.
    takes_bf16 (K5): the level may be bfloat16 too."""
    b, c, g = flat.shape
    n = p0.shape[1]
    if g != int(dims[0]) * int(dims[1]) * int(dims[2]):
        raise ValueError(f"{who}: level of {g} voxels for dims {dims}")
    if g * c >= 2**31:
        raise ValueError(f"{who}: G * C = {g * c} exceeds the kernel's 32-bit offsets")
    level_dtypes = (torch.float32, torch.bfloat16) if takes_bf16 else (torch.float32,)
    if flat.dtype not in level_dtypes:
        raise TypeError(f"{who}: flat must be one of {level_dtypes}, got {flat.dtype}")
    _check(who, flat.device, p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)))
    vol = stage_channels_last(flat)
    out = torch.empty((b, n, 7 * c), dtype=dtype, device=flat.device)
    # K5's entry takes the level's dtype (0 f32, 1 bf16) before the tail
    flag = (int(flat.dtype == torch.bfloat16),) if takes_bf16 else ()
    rc = _bind(entry, 5, len(flag))(
        vol.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), out.data_ptr(), *flag,
        *_tail(b, n, c, dims, align_corners, displacement, flat.device),
    )
    build.check(rc, entry)
    return out


def level_features_cuda(flat, p0, p1, p2, dims, align_corners: bool, displacement: float):
    """K4: (B, C, G) level, three (B, N) coords in [-1, 1] -> (B, N, 7*C).
    A level that lies channels-last in memory is read as it is; any other is
    staged channels-last here (stage_channels_last)."""
    if not _on_cuda(flat, "level_features"):
        return level_features_plain(flat, p0, p1, p2, dims, align_corners, displacement)
    out = _features_kernel("level_features", "sv3d_level_features", torch.float32, flat,
                           p0, p1, p2, dims, align_corners, displacement)
    level_features_cuda.launches += 1
    return out


def level_features_banded_cuda(flat, p0, p1, p2, dims, align_corners: bool,
                               displacement: float):
    """K5: K4's features stored as bfloat16, (B, N, 7*C); the level as K4
    takes it, in float32 or bfloat16 (read as it is: the bf16 point query
    hands it the pyramid rounded to bf16, as the JAX kernel reads it).
    Inference-only."""
    _inference_only("level_features_banded", flat, p0, p1, p2)
    if not _on_cuda(flat, "level_features_banded"):
        return level_features_banded_plain(flat, p0, p1, p2, dims, align_corners, displacement)
    out = _features_kernel("level_features_banded", "sv3d_level_features_bf16", torch.bfloat16,
                           flat, p0, p1, p2, dims, align_corners, displacement,
                           takes_bf16=True)
    level_features_banded_cuda.launches += 1
    return out


def level_fc0_cuda(flat, w0l, p0, p1, p2, dims, align_corners: bool, displacement: float,
                   out=None):
    """K6: one level's fc0 partial, K4's features (B, N, 7*C) times w0l (7*C,
    H) (rows d*C + c), contracted in the kernel: (B, N, H) f32.  With out
    (B, N, H) given, the partial is added into out in place and out is
    returned, so the caller sums the levels in one buffer.  The level as K4
    takes it: one that lies channels-last in memory (evaluate_points stages
    its pyramid so once a call) is read as it is, any other is staged
    channels-last here (stage_channels_last).  H from 1 to 1024 (the kernel
    takes 256 columns a block).  Inference-only."""
    _inference_only("level_fc0", flat, w0l, p0, p1, p2)
    if not _on_cuda(flat, "level_fc0"):
        part = level_fc0_plain(flat, w0l, p0, p1, p2, dims, align_corners, displacement)
        return part if out is None else out.add_(part)
    b, c, g = flat.shape
    n = p0.shape[1]
    h = w0l.shape[1]
    if g != int(dims[0]) * int(dims[1]) * int(dims[2]):
        raise ValueError(f"level_fc0: level of {g} voxels for dims {dims}")
    if not 1 <= h <= 1024:
        raise ValueError(f"level_fc0: the kernel takes 1 to 1024 outputs, got {h}")
    if g * c >= 2**31:
        raise ValueError(f"level_fc0: G * C = {g * c} exceeds the kernel's 32-bit offsets")
    if flat.device != p0.device or flat.dtype != torch.float32:
        raise TypeError(f"level_fc0: flat must be float32 on {p0.device}, got {flat.dtype} on "
                        f"{flat.device}")
    tensors = dict(w0l=(w0l, (7 * c, h)), p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)))
    if out is not None:
        tensors["out"] = (out, (b, n, h))
    _check("level_fc0", flat.device, **tensors)
    vol = stage_channels_last(flat)
    accumulate = out is not None
    if out is None:
        out = torch.empty((b, n, h), dtype=torch.float32, device=flat.device)
    rc = _bind("sv3d_level_fc0", 6, 2)(
        vol.data_ptr(), w0l.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        out.data_ptr(), h, int(accumulate),
        *_tail(b, n, c, dims, align_corners, displacement, flat.device),
    )
    build.check(rc, "sv3d_level_fc0")
    level_fc0_cuda.launches += 1
    return out


def fc0_block_bf16(w0l: torch.Tensor) -> torch.Tensor:
    """A level's (7*C, H) block of fc0 as K6 bf16 reads it: on CUDA its bf16
    mma fragments (mma_b_fragments of the (H, K) transpose, K = 7*C, or 16 for
    C = 1: the 7 copies packed into one k16 chunk, zeros after); on the CPU
    the block rounded to bf16, the plain version's operand.  Made once for
    the calls that share the weights (evaluate_points)."""
    w = w0l.detach().to(torch.bfloat16)
    if w.device.type == "cpu":
        return w
    wt = w.t()
    if wt.shape[1] < 16:
        wt = torch.cat([wt, wt.new_zeros((wt.shape[0], 16 - wt.shape[1]))], dim=1)
    return mma_b_fragments(wt.contiguous())


def level_fc0_bf16_cuda(level, w0k, p0, p1, p2, dims, align_corners: bool, displacement: float,
                        out=None):
    """K6 bf16: one level's fc0 partial in the JAX kernel's class (the level,
    each feature, the block and the partial rounded to bf16, f32 sums), as
    f32 (B, N, H); with out (B, N, H) f32 given, added into out in place.
    level: (B, C, G) of any float dtype and layout; a channels-last bf16 one
    (evaluate_points stages its pyramid so once a call) is read as it is,
    any other is rounded and staged here.  w0k: fc0_block_bf16(w0l).  C = 1
    or C % 16 == 0 up to 128, H 256 or 512.  Inference-only."""
    _inference_only("level_fc0", level, w0k, p0, p1, p2)
    if not _on_cuda(level, "level_fc0_bf16"):
        part = level_fc0_plain(level, w0k, p0, p1, p2, dims, align_corners, displacement,
                               torch.bfloat16)
        return part if out is None else out.add_(part)
    b, c, g = level.shape
    n = p0.shape[1]
    k = 16 if c == 1 else 7 * c
    h = 16 * w0k.shape[1] if w0k.ndim == 4 else -1
    if g != int(dims[0]) * int(dims[1]) * int(dims[2]):
        raise ValueError(f"level_fc0_bf16: level of {g} voxels for dims {dims}")
    if not (c == 1 or (c % 16 == 0 and c <= 128)) or h not in (256, 512):
        raise ValueError(f"level_fc0_bf16: the kernel takes C = 1 or C % 16 == 0 up to 128 "
                         f"and H 256 or 512, got C {c} and weights {tuple(w0k.shape)}")
    if g * c >= 2**31:
        raise ValueError(f"level_fc0_bf16: G * C = {g * c} exceeds the kernel's 32-bit offsets")
    if tuple(w0k.shape) != (k // 16, h // 16, 32, 8) or w0k.dtype != torch.bfloat16 \
            or w0k.device != level.device or not w0k.is_contiguous():
        raise ValueError(f"level_fc0_bf16: w0k must be fc0_block_bf16 of a ({7 * c}, H) block, "
                         f"got {tuple(w0k.shape)} {w0k.dtype} on {w0k.device}")
    tensors = dict(p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)))
    if out is not None:
        tensors["out"] = (out, (b, n, h))
    _check("level_fc0_bf16", level.device, **tensors)
    vol = stage_channels_last(level.to(torch.bfloat16))
    accumulate = out is not None
    if out is None:
        out = torch.empty((b, n, h), dtype=torch.float32, device=level.device)
    rc = _bind("sv3d_level_fc0_bf16", 6, 2)(
        vol.data_ptr(), w0k.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        out.data_ptr(), h, int(accumulate),
        *_tail(b, n, c, dims, align_corners, displacement, level.device),
    )
    build.check(rc, "sv3d_level_fc0_bf16")
    level_fc0_bf16_cuda.launches += 1
    return out


def level_grad_points_cuda(flat, p0, p1, p2, g, dims, align_corners: bool,
                           displacement: float):
    """K7: d features / d coords contracted with g (B, N, 7*C) -> (B, N, 3).
    The level as K4 takes it: a channels-last level is read as it is, any
    other is staged channels-last here."""
    if not _on_cuda(flat, "level_grad_points"):
        return level_grad_points_plain(flat, p0, p1, p2, g, dims, align_corners, displacement)
    b, c, gsize = flat.shape
    n = p0.shape[1]
    if gsize != int(dims[0]) * int(dims[1]) * int(dims[2]):
        raise ValueError(f"level_grad_points: level of {gsize} voxels for dims {dims}")
    if gsize * c >= 2**31:
        raise ValueError(f"level_grad_points: G * C = {gsize * c} exceeds the kernel's "
                         "32-bit offsets")
    if flat.dtype != torch.float32:
        raise TypeError(f"level_grad_points: flat must be float32, got {flat.dtype}")
    _check("level_grad_points", flat.device, p0=(p0, (b, n)), p1=(p1, (b, n)),
           p2=(p2, (b, n)), g=(g, (b, n, 7 * c)))
    vol = stage_channels_last(flat)
    out = torch.empty((b, n, 3), dtype=torch.float32, device=flat.device)
    rc = _bind("sv3d_level_grad_points", 6)(
        vol.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), g.data_ptr(),
        out.data_ptr(), *_tail(b, n, c, dims, align_corners, displacement, flat.device),
    )
    build.check(rc, "sv3d_level_grad_points")
    level_grad_points_cuda.launches += 1
    return out


def level_grad_vol_cuda(p0, p1, p2, g, dims, align_corners: bool, displacement: float):
    """K8: d features / d level contracted with g (B, N, 7*C) -> (B, C, G), the
    transposed view of a channels-last (B, G, C) buffer."""
    if not _on_cuda(g, "level_grad_vol"):
        return level_grad_vol_plain(p0, p1, p2, g, dims, align_corners, displacement)
    b, n, sevenc = g.shape
    c = sevenc // 7
    gsize = int(dims[0]) * int(dims[1]) * int(dims[2])
    _check("level_grad_vol", g.device, p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)),
           g=(g, (b, n, 7 * c)))
    if gsize * c >= 2**31:
        raise ValueError(f"level_grad_vol: G * C = {gsize * c} exceeds the kernel's 32-bit "
                         "offsets")
    out = torch.zeros((b, gsize, c), dtype=torch.float32, device=g.device)
    rc = _bind("sv3d_level_grad_vol", 5)(
        p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), g.data_ptr(), out.data_ptr(),
        *_tail(b, n, c, dims, align_corners, displacement, g.device),
    )
    build.check(rc, "sv3d_level_grad_vol")
    level_grad_vol_cuda.launches += 1
    return out.transpose(1, 2)


class _LevelFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, p0, p1, p2, dims, align_corners, displacement):
        # the level as given, not the channels-last copy K4 read: the caller's
        # pyramid holds the flats through the forward, so a saved copy of every
        # level would coexist with them and raise the train step's peak memory
        # (by 166.6 MiB at B=4 on the H100); K7's wrapper stages it again
        ctx.save_for_backward(flat, p0, p1, p2)
        ctx.args = (dims, align_corners, displacement)
        return level_features_cuda(flat, p0, p1, p2, dims, align_corners, displacement)

    @staticmethod
    def backward(ctx, g):
        flat, p0, p1, p2 = ctx.saved_tensors
        g = g.contiguous()
        gvol = level_grad_vol_cuda(p0, p1, p2, g, *ctx.args)
        gp = (None, None, None)
        if any(ctx.needs_input_grad[1:4]):
            gpts = level_grad_points_cuda(flat, p0, p1, p2, g, *ctx.args)
            gp = tuple(
                gpts[..., i] if ctx.needs_input_grad[1 + i] else None for i in range(3)
            )
        return (gvol, *gp, None, None, None)


def level_features(vol, p0, p1, p2, dims, align_corners: bool, displacement: float):
    """One pyramid level's trilinear features at the 7 displaced copies of
    (B, N) points given as coordinates in [-1, 1], differentiable in the level
    and the coordinates.

    vol: flat level (B, C, G0*G1*G2) in the channel-major layout that
    flatten_grid makes, or a channels-last view of one ((B, G, C) contiguous,
    transposed), which serves K4 in the forward and K7 in the backward
    without a copy; any other level is staged channels-last by each of
    them.  Returns (B, N, 7*C) f32, displacement-major within the level
    (index d*C + c).  The level's gradient comes back in the channel-major
    flat's shape, channels-last in memory on the card (K8's layout)."""
    dims = tuple(int(d) for d in dims)
    p0, p1, p2 = (p.contiguous() for p in (p0, p1, p2))
    return _LevelFeatures.apply(vol, p0, p1, p2, dims, bool(align_corners), float(displacement))


level_features_cuda.launches = 0
level_features_banded_cuda.launches = 0
level_fc0_cuda.launches = 0
level_fc0_bf16_cuda.launches = 0
level_grad_points_cuda.launches = 0
level_grad_vol_cuda.launches = 0
