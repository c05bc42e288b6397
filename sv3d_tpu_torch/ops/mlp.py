"""Plain torch version of the fused decoder kernel K3 (port of the contract
of sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp).

The IF-Net decoder on a materialized feature matrix: fc0 -> ReLU -> fc1 ->
ReLU -> fc2 -> ReLU -> fc_out.  compute_dtype float32: f32 throughout.
bfloat16: the JAX kernel's class -- the features, the four weights and each
ReLU output rounded to bf16, the products of bf16 values exact in f32, f32
sums and biases.  It is what a CPU tensor runs, and what the CUDA kernel
(sv3d_tpu_torch/ops/cuda/mlp.py) is held against on the card.
"""

from __future__ import annotations

import torch

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def rounded(t: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """t rounded to compute_dtype (round to nearest even), kept in f32."""
    return t.to(compute_dtype).float()


def fused_point_mlp_plain(f, w0, b0, w1, b1, w2, b2, w3, b3,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """f: (F, N) features, or (B, F, N); w_i: (H_out, H_in) with w3 (1, H);
    b_i: (H_out,).  Returns (N,) (or (B, N)) f32 logits."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"fused_point_mlp: compute_dtype must be one of {COMPUTE_DTYPES}")
    layers = ((w0, b0), (w1, b1), (w2, b2), (w3, b3))
    h = rounded(f, compute_dtype)
    for i, (w, b) in enumerate(layers):
        h = torch.einsum("hf,...fn->...hn", rounded(w, compute_dtype), h) + b[:, None]
        if i < len(layers) - 1:
            h = rounded(torch.relu(h), compute_dtype)
    return h[..., 0, :]


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ b (K, N) in the JAX package's bf16 class, as XLA runs its
    bf16 einsums with preferred_element_type=float32: both operands rounded
    to bf16, their products exact, sums and result in f32.  On the card one
    cuBLAS bf16 product with an f32 output (the tensor cores); on the CPU the
    same values by an f32 product of the rounded operands."""
    if a.device.type == "cuda":
        a2 = a.reshape(-1, a.shape[-1]).to(torch.bfloat16)
        out = torch.mm(a2, b.to(torch.bfloat16), out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return rounded(a) @ rounded(b)
