"""Mixed precision as the JAX package's flax modules run it (--precision
16): a layer given dtype=torch.bfloat16 computes in bf16 on f32 parameters.
The casts are explicit, layer by layer, so the CPU and the card run one
program and each rounding falls where flax's falls; dtype=None inserts no
cast."""

from __future__ import annotations

import torch
from torch import nn


def conv(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """layer(x) for a Conv2d / Conv3d; with dtype set, flax's
    nn.Conv(dtype=dtype): input, kernel and bias cast to dtype, the conv's
    output in dtype, then the bias added in dtype.  The parameters stay f32,
    so their gradients come back f32 through the casts."""
    if dtype is None:
        return layer(x)
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    return y + layer.bias.to(dtype).view(1, -1, *([1] * (y.ndim - 2)))


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor as f32 (the JAX package's .astype(float32) of bf16
    logits); any other dtype, float64 included, as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t
