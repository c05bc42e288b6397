"""Parameter initialization with the JAX package's (flax) initializers, drawn
from an explicit torch.Generator so a seed fixes every weight."""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw keeps the target variance
_TRUNC_STD = 0.87962566103423978


def lecun_trunc_normal_(weight: torch.Tensor, generator: torch.Generator | None) -> None:
    """variance_scaling(1, "fan_in", "truncated_normal") for an (out, in, *k)
    torch weight (flax's lecun_normal conv default and the IF-Net point-conv
    init)."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def flax_init_(module: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """Re-initialize every conv / linear layer of module as flax would: lecun
    truncated normal weights, zero biases.  BatchNorm keeps torch's defaults,
    which equal flax's (scale 1, bias 0, mean 0, var 1).  Run it on CPU
    parameters with a CPU generator, then move the module."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            lecun_trunc_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module
