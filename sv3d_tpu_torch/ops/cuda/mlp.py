"""Wrapper of the CUDA decoder kernels (sv3d_tpu_torch/csrc/mlp.cu).

  fused_point_mlp  K3, replaces sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp

The whole IF-Net decoder, fc0 -> fc1 -> fc2 -> fc_out with biases and ReLUs,
from a materialized (F, N) feature matrix to (N,) logits; the unfused dense
sweep's decoder (IFNet.query_lattice(fused_tail=False)).  A CPU tensor runs
the plain version (sv3d_tpu_torch/ops/mlp.py), a CUDA tensor launches the
kernel of compute_dtype or raises.  bfloat16 is the JAX kernel's class (the
features rounded on load in the kernel, the weights rounded once by
mlp_operands, each ReLU output in the kernel) on the tensor cores, for
IF-Net's widths only (check_bf16_widths); float32 is f32 FMA throughout,
the parity route.  mlp_operands lays the weights out as the kernel reads
them, once for many calls with unchanged weights, and records which weights
it was made from: operands made from other weights, or from weights that
changed in place since, raise ValueError.  Inference-only, as the TPU
kernel has no VJP: under autograd it raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.cuda.layouts import matches_record, mma_b_fragments, tensor_record
from sv3d_tpu_torch.ops.mlp import COMPUTE_DTYPES, fused_point_mlp_plain, rounded

K3_TOL = 1e-4  # f32 FMA vs plain f32 contractions: summation order only (csrc/mlp.cu)
# K3 in bf16 against its plain bf16 version: the same rounding points, f32
# sums in another order, so a hidden activation may round the other way of a
# bf16 boundary (K2 bf16's case); atol on logits.  Such flips are rare, so
# mean |error| <= K3_BF16_REL_MEAN_TOL x mean |logit| (f64 sums instead of
# f32 moved the mean by 2.3e-5 to 2.6e-5 in a CPU estimate on standard
# normal features); a decoder that leaves the hidden rounding out is off at
# every point (3.5e-3 to 4.0e-3 in the same estimate) and fails it
# (plain_bf16_mlp with skip; the points phase shows it).
K3_BF16_TOL = 2e-3
K3_BF16_REL_MEAN_TOL = 3e-4


class MlpOperands(NamedTuple):
    """The decoder's weights as a K3 kernel reads them (mlp_operands)."""

    compute_dtype: torch.dtype
    made_from: tuple  # tensor_record of each weight and bias, in fused_point_mlp's order
    weights: tuple  # fc0, fc1, fc2, fc_out in the kernel's layouts
    biases: tuple  # b0, b1, b2, b3 in f32, contiguous


def check_bf16_widths(h0: int, h1: int, h2: int) -> None:
    """Raise ValueError unless (h0, h1, h2) are widths K3 bf16 takes:
    IF-Net's two decoders, (256, 256, 256) and (512, 256, 256)."""
    if h0 not in (256, 512) or (h1, h2) != (256, 256):
        raise ValueError("fused_point_mlp: the bf16 kernel takes hidden widths (256|512, 256, "
                         f"256), IF-Net's; got {(h0, h1, h2)}")


def _check_weights(weights) -> None:
    """Raise unless the eight decoder tensors are float32 on one device with
    the shapes of one decoder: w_i (H_out, H_in), b_i (H_out,), w3 (1, H2),
    b3 (1,)."""
    w0, b0, w1, b1, w2, b2, w3, b3 = weights
    h0, h1, h2, n_feat = w0.shape[0], w1.shape[0], w2.shape[0], w0.shape[-1]
    shapes = ((h0, n_feat), (h0,), (h1, h0), (h1,), (h2, h1), (h2,), (1, h2), (1,))
    for i, (t, shape) in enumerate(zip(weights, shapes), start=1):
        if t.device != w0.device or t.dtype != torch.float32:
            raise TypeError(f"fused_point_mlp: argument {i} must be float32 on {w0.device}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_point_mlp: argument {i} must be {shape}, got {tuple(t.shape)}")


def mlp_operands(weights, compute_dtype=torch.float32) -> MlpOperands:
    """The eight decoder tensors (w0, b0, w1, b1, w2, b2, w3, b3) as K3 of
    compute_dtype reads them.  bfloat16: fc0's (H0, F) weight rounded to
    bf16, its rows padded with zeros to a multiple of 16 and laid out as
    mma_b_fragments, fc1 and fc2 likewise, fc_out's weight rounded to bf16
    and held in f32; float32: the transposed (in, out) fc0, fc1, fc2 and
    fc_out's weight.  Both with contiguous f32 copies of the biases, and
    tensor_record of each of the eight, which fused_point_mlp checks."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused_point_mlp: compute_dtype must be one of {COMPUTE_DTYPES}")
    _check_weights(weights)
    made_from = tuple(tensor_record(t) for t in weights)
    w0, b0, w1, b1, w2, b2, w3, b3 = (t.detach() for t in weights)
    with torch.no_grad():
        if compute_dtype == torch.bfloat16:
            check_bf16_widths(w0.shape[0], w1.shape[0], w2.shape[0])
            w0p = F.pad(w0.to(torch.bfloat16), (0, -w0.shape[1] % 16))
            ws = (mma_b_fragments(w0p), mma_b_fragments(w1.to(torch.bfloat16)),
                  mma_b_fragments(w2.to(torch.bfloat16)), rounded(w3).reshape(-1).contiguous())
        else:
            ws = tuple(w.t().contiguous() for w in (w0, w1, w2)) + (w3.contiguous(),)
        bs = tuple(b.contiguous() for b in (b0, b1, b2, b3))
    return MlpOperands(compute_dtype, made_from, ws, bs)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # f, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, n_feat, n, h0, h1, h2, stream
    "sv3d_fused_point_mlp": [_P] * 10 + [_I] * 5 + [_P],
    # f, w0f, b0, w1f, b1, w2f, b2, w3, b3, out, n_feat, n, h0, stream
    "sv3d_fused_point_mlp_bf16": [_P] * 10 + [_I] * 3 + [_P],
}


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    fn = getattr(build.load(), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def fused_point_mlp(f, w0, b0, w1, b1, w2, b2, w3, b3, compute_dtype=torch.float32,
                    operands: MlpOperands | None = None) -> torch.Tensor:
    """K3: f (F, N) f32 features; w_i (H_out, H_in) with w3 (1, H2); b_i
    (H_out,).  Returns (N,) f32 logits in compute_dtype's class.  operands:
    mlp_operands((w0, ..., b3), compute_dtype), from a caller that decodes
    many feature matrices with unchanged weights; made here when None;
    operands made for another compute_dtype or from other tensors than
    these, or before one of them changed in place, raise ValueError.  In
    float32 the hidden widths may be at most 512; bfloat16 takes IF-Net's
    (check_bf16_widths)."""
    args = (f, w0, b0, w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "fused_point_mlp is INFERENCE-ONLY (the TPU kernel has no VJP): run it "
            "under torch.no_grad() or torch.inference_mode()")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused_point_mlp: compute_dtype must be one of {COMPUTE_DTYPES}")
    if operands is not None and (
            operands.compute_dtype != compute_dtype
            or len(operands.made_from) != len(args) - 1
            or not all(matches_record(rec, t) for rec, t in zip(operands.made_from, args[1:]))):
        raise ValueError("fused_point_mlp: the operands are stale: they were made for another "
                         "compute_dtype or from other weights, or the weights changed in place "
                         "since; make them anew with mlp_operands")
    if f.device.type == "cpu":
        return fused_point_mlp_plain(*args, compute_dtype=compute_dtype)
    if f.device.type != "cuda":
        raise ValueError(f"fused_point_mlp: unsupported device {f.device}")
    # mlp_operands checked the weights; operands that match them (above) hold
    # what they held then
    if operands is None:
        operands = mlp_operands(args[1:], compute_dtype)
    h0, n_feat = operands.made_from[0][2]  # the shapes of w0, w1 and w2 as recorded
    h1, h2 = operands.made_from[2][2][0], operands.made_from[4][2][0]
    if f.device != operands.weights[0].device or f.dtype != torch.float32:
        raise TypeError(f"fused_point_mlp: argument 0 must be float32 on "
                        f"{operands.weights[0].device}, got {f.dtype} on {f.device}")
    if f.ndim != 2 or f.shape[0] != n_feat:
        raise ValueError(f"fused_point_mlp: argument 0 must be ({n_feat}, N), "
                         f"got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("fused_point_mlp: f must be contiguous")
    bf16 = compute_dtype == torch.bfloat16
    if not bf16 and max(h0, h1, h2) > 512:
        raise ValueError(f"fused_point_mlp: hidden widths up to 512, got {(h0, h1, h2)}")
    return _launch_bf16(f, operands) if bf16 else _launch_f32(f, operands)


def _launch_bf16(f, operands: MlpOperands) -> torch.Tensor:
    n_feat, n = f.shape
    out = torch.empty((n,), dtype=torch.float32, device=f.device)
    (w0f, w1f, w2f, w3), (b0, b1, b2, b3) = operands.weights, operands.biases
    rc = _bind("sv3d_fused_point_mlp_bf16")(
        f.data_ptr(), w0f.data_ptr(), b0.data_ptr(), w1f.data_ptr(), b1.data_ptr(),
        w2f.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n_feat, n, b0.shape[0], torch.cuda.current_stream(f.device).cuda_stream)
    build.check(rc, "sv3d_fused_point_mlp_bf16")
    fused_point_mlp.launches += 1
    return out


def _launch_f32(f, operands: MlpOperands) -> torch.Tensor:
    n_feat, n = f.shape
    out = torch.empty((n,), dtype=torch.float32, device=f.device)
    (w0t, w1t, w2t, w3), (b0, b1, b2, b3) = operands.weights, operands.biases
    rc = _bind("sv3d_fused_point_mlp")(
        f.data_ptr(), w0t.data_ptr(), b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
        w2t.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
        n_feat, n, b0.shape[0], b1.shape[0], b2.shape[0],
        torch.cuda.current_stream(f.device).cuda_stream)
    build.check(rc, "sv3d_fused_point_mlp")
    fused_point_mlp.launches += 1
    return out


fused_point_mlp.launches = 0
