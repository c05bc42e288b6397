"""Plain torch version of the fused decoder kernel K3 (port of the contract
of sv3d_tpu/ops/pallas/mlp.py::fused_point_mlp).

The IF-Net decoder on a materialized feature matrix: fc0 -> ReLU -> fc1 ->
ReLU -> fc2 -> ReLU -> fc_out, in f32.  The JAX kernel runs its products in
bf16 with f32 accumulation; this version and the CUDA kernel
(sv3d_tpu_torch/ops/cuda/mlp.py) are f32 throughout.  It is what a CPU
tensor runs, and what the kernel is held against on the card.
"""

from __future__ import annotations

import torch


def fused_point_mlp_plain(f, w0, b0, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """f: (F, N) features, or (B, F, N); w_i: (H_out, H_in) with w3 (1, H);
    b_i: (H_out,).  Returns (N,) (or (B, N)) f32 logits."""
    layers = ((w0, b0), (w1, b1), (w2, b2), (w3, b3))
    h = f
    for i, (w, b) in enumerate(layers):
        h = torch.einsum("hf,...fn->...hn", w, h) + b[:, None]
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[..., 0, :]
