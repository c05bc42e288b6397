"""Wrapper of the CUDA decoder kernel (sv3d_tpu_torch/csrc/mlp.cu).

  fused_point_mlp  K3, replaces sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp

The whole IF-Net decoder, fc0 -> fc1 -> fc2 -> fc_out with biases and ReLUs,
from a materialized (F, N) feature matrix to (N,) logits; the unfused dense
sweep's decoder (IFNet.query_lattice(fused_tail=False)).  A CPU tensor runs
the plain version (sv3d_tpu_torch/ops/mlp.py), a CUDA tensor launches the
kernel or raises.  compute_dtype float32 is f32 throughout; bfloat16 is the
JAX kernel's class (features and weights rounded here, each ReLU output in
the kernel).  Inference-only, as the TPU kernel has no VJP: under autograd it
raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sv3d_tpu_torch.ops.cuda import build
from sv3d_tpu_torch.ops.mlp import COMPUTE_DTYPES, fused_point_mlp_plain, rounded


@functools.lru_cache(maxsize=None)
def _bind():
    fn = build.load().sv3d_fused_point_mlp
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_point_mlp(f, w0, b0, w1, b1, w2, b2, w3, b3,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """K3: f (F, N) f32 features; w_i (H_out, H_in) with w3 (1, H2); b_i
    (H_out,).  Returns (N,) f32 logits in compute_dtype's class.  The hidden
    widths may be at most 512."""
    args = (f, w0, b0, w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "fused_point_mlp is INFERENCE-ONLY (the TPU kernel has no VJP): run it "
            "under torch.no_grad() or torch.inference_mode()")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused_point_mlp: compute_dtype must be one of {COMPUTE_DTYPES}")
    if f.device.type == "cpu":
        return fused_point_mlp_plain(*args, compute_dtype=compute_dtype)
    if f.device.type != "cuda":
        raise ValueError(f"fused_point_mlp: unsupported device {f.device}")
    n_feat, n = f.shape
    h0, h1, h2 = w0.shape[0], w1.shape[0], w2.shape[0]
    shapes = ((f, (n_feat, n)), (w0, (h0, n_feat)), (b0, (h0,)), (w1, (h1, h0)), (b1, (h1,)),
              (w2, (h2, h1)), (b2, (h2,)), (w3, (1, h2)), (b3, (1,)))
    for i, (t, shape) in enumerate(shapes):
        if t.device != f.device or t.dtype != torch.float32:
            raise TypeError(f"fused_point_mlp: argument {i} must be float32 on {f.device}, "
                            f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_point_mlp: argument {i} must be {shape}, got {tuple(t.shape)}")
    if not f.is_contiguous():
        raise ValueError("fused_point_mlp: f must be contiguous")
    if max(h0, h1, h2) > 512:
        raise ValueError(f"fused_point_mlp: hidden widths up to 512, got {(h0, h1, h2)}")
    bf16 = compute_dtype == torch.bfloat16
    if bf16:
        f, w0, w1, w2, w3 = (rounded(t) for t in (f, w0, w1, w2, w3))
    w0t, w1t, w2t = (w.t().contiguous() for w in (w0, w1, w2))
    w3c, b0c, b1c, b2c, b3c = (t.contiguous() for t in (w3, b0, b1, b2, b3))
    out = torch.empty((n,), dtype=torch.float32, device=f.device)
    rc = _bind()(
        f.data_ptr(), w0t.data_ptr(), b0c.data_ptr(), w1t.data_ptr(), b1c.data_ptr(),
        w2t.data_ptr(), b2c.data_ptr(), w3c.data_ptr(), b3c.data_ptr(), out.data_ptr(),
        n_feat, n, h0, h1, h2, int(bf16), torch.cuda.current_stream(f.device).cuda_stream,
    )
    build.check(rc, "sv3d_fused_point_mlp")
    fused_point_mlp.launches += 1
    return out


fused_point_mlp.launches = 0
