"""Wrappers of the CUDA point-query kernels (sv3d_tpu_torch/csrc/point_query.cu).

  level_features_cuda         K4, replaces sv3d_tpu/ops/pallas/point_query.py::level_features
  level_features_banded_cuda  K5, replaces sv3d_tpu/ops/pallas/point_query.py::level_features_banded
  level_fc0_cuda              K6, replaces sv3d_tpu/ops/pallas/point_query.py::level_fc0_banded
  level_grad_points_cuda      K7, replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_points
  level_grad_vol_cuda         K8, replaces sv3d_tpu/ops/pallas/point_query_bwd.py::level_grad_vol

level_features is the differentiable entry (the counterpart of the JAX
package's level_features_diff custom VJP): an autograd.Function whose forward
runs K4 and whose backward runs K8 for the level's gradient and K7 for the
coordinates' when autograd asks for it.  Each wrapper runs its plain version
(sv3d_tpu_torch/ops/point_query.py) for a CPU tensor and launches its kernel
for a CUDA tensor, or raises.  Every wrapper takes the level as the
channel-major flat (B, C, G) that flatten_grid makes; K4 and K5 read it
channels-last, (B, G, C): their wrapper reads a level that already lies so
as it is and stages any other (stage_channels_last), while K6, K7 and K8
read the flat as it is.  K5 and K6 are inference-only, as their TPU
kernels have no VJP: under autograd (grad enabled and an input that requires
grad) they raise NotImplementedError rather than return a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.point_query import (
    level_fc0_plain,
    level_features_banded_plain,
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)

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


def stage_channels_last(flat: torch.Tensor) -> torch.Tensor:
    """The contiguous channels-last (B, G, C) level that K4 and K5 read, from
    a (B, C, G) level in any memory layout: a view when the level already
    lies channels-last (C = 1 always does), else torch's transpose copy,
    counted in stage_channels_last.copies."""
    cl = flat.transpose(1, 2)
    if not cl.is_contiguous():
        stage_channels_last.copies += 1
    return cl.contiguous()


def _features_kernel(who: str, entry: str, dtype, flat, p0, p1, p2, dims, align_corners,
                     displacement):
    """K4 or K5 on a CUDA level: stage the channels-last copy, launch."""
    b, c, g = flat.shape
    n = p0.shape[1]
    if g != int(dims[0]) * int(dims[1]) * int(dims[2]):
        raise ValueError(f"{who}: level of {g} voxels for dims {dims}")
    if g * c >= 2**31:
        raise ValueError(f"{who}: G * C = {g * c} exceeds the kernel's 32-bit offsets")
    if flat.dtype != torch.float32:
        raise TypeError(f"{who}: flat must be float32, got {flat.dtype}")
    _check(who, flat.device, p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)))
    vol = stage_channels_last(flat)
    out = torch.empty((b, n, 7 * c), dtype=dtype, device=flat.device)
    rc = _bind(entry, 5)(
        vol.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), out.data_ptr(),
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
    takes it.  Inference-only."""
    _inference_only("level_features_banded", flat, p0, p1, p2)
    if not _on_cuda(flat, "level_features_banded"):
        return level_features_banded_plain(flat, p0, p1, p2, dims, align_corners, displacement)
    out = _features_kernel("level_features_banded", "sv3d_level_features_bf16", torch.bfloat16,
                           flat, p0, p1, p2, dims, align_corners, displacement)
    level_features_banded_cuda.launches += 1
    return out


def level_fc0_cuda(flat, w0l, p0, p1, p2, dims, align_corners: bool, displacement: float,
                   out=None):
    """K6: one level's fc0 partial, K4's features (B, N, 7*C) times w0l (7*C,
    H) (rows d*C + c), contracted in the kernel: (B, N, H) f32.  With out
    (B, N, H) given, the partial is added into out in place and out is
    returned, so the caller sums the levels in one buffer.  Inference-only."""
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
    tensors = dict(flat=(flat, (b, c, g)), w0l=(w0l, (7 * c, h)), p0=(p0, (b, n)),
                   p1=(p1, (b, n)), p2=(p2, (b, n)))
    if out is not None:
        tensors["out"] = (out, (b, n, h))
    _check("level_fc0", flat.device, **tensors)
    accumulate = out is not None
    if out is None:
        out = torch.empty((b, n, h), dtype=torch.float32, device=flat.device)
    rc = _bind("sv3d_level_fc0", 6, 2)(
        flat.data_ptr(), w0l.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        out.data_ptr(), h, int(accumulate),
        *_tail(b, n, c, dims, align_corners, displacement, flat.device),
    )
    build.check(rc, "sv3d_level_fc0")
    level_fc0_cuda.launches += 1
    return out


def level_grad_points_cuda(flat, p0, p1, p2, g, dims, align_corners: bool,
                           displacement: float):
    """K7: d features / d coords contracted with g (B, N, 7*C) -> (B, N, 3)."""
    if not _on_cuda(flat, "level_grad_points"):
        return level_grad_points_plain(flat, p0, p1, p2, g, dims, align_corners, displacement)
    b, c, gsize = flat.shape
    n = p0.shape[1]
    _check("level_grad_points", flat.device, flat=(flat, (b, c, gsize)), p0=(p0, (b, n)),
           p1=(p1, (b, n)), p2=(p2, (b, n)), g=(g, (b, n, 7 * c)))
    out = torch.empty((b, n, 3), dtype=torch.float32, device=flat.device)
    rc = _bind("sv3d_level_grad_points", 6)(
        flat.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), g.data_ptr(),
        out.data_ptr(), *_tail(b, n, c, dims, align_corners, displacement, flat.device),
    )
    build.check(rc, "sv3d_level_grad_points")
    level_grad_points_cuda.launches += 1
    return out


def level_grad_vol_cuda(p0, p1, p2, g, dims, align_corners: bool, displacement: float):
    """K8: d features / d level contracted with g (B, N, 7*C) -> (B, C, G)."""
    if not _on_cuda(g, "level_grad_vol"):
        return level_grad_vol_plain(p0, p1, p2, g, dims, align_corners, displacement)
    b, n, sevenc = g.shape
    c = sevenc // 7
    gsize = int(dims[0]) * int(dims[1]) * int(dims[2])
    _check("level_grad_vol", g.device, p0=(p0, (b, n)), p1=(p1, (b, n)), p2=(p2, (b, n)),
           g=(g, (b, n, 7 * c)))
    out = torch.zeros((b, c, gsize), dtype=torch.float32, device=g.device)
    rc = _bind("sv3d_level_grad_vol", 5)(
        p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), g.data_ptr(), out.data_ptr(),
        *_tail(b, n, c, dims, align_corners, displacement, g.device),
    )
    build.check(rc, "sv3d_level_grad_vol")
    level_grad_vol_cuda.launches += 1
    return out


class _LevelFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, p0, p1, p2, dims, align_corners, displacement):
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

    vol: contiguous channel-major flat level (B, C, G0*G1*G2), as
    flatten_grid makes it (a channels-last view of it serves the forward
    alone: K7 reads the channel-major flat); returns (B, N, 7*C) f32,
    displacement-major within the level (index d*C + c).  The level's
    gradient comes back in the channel-major flat layout."""
    dims = tuple(int(d) for d in dims)
    p0, p1, p2 = (p.contiguous() for p in (p0, p1, p2))
    return _LevelFeatures.apply(vol, p0, p1, p2, dims, bool(align_corners), float(displacement))


stage_channels_last.copies = 0
level_features_cuda.launches = 0
level_features_banded_cuda.launches = 0
level_fc0_cuda.launches = 0
level_grad_points_cuda.launches = 0
level_grad_vol_cuda.launches = 0
