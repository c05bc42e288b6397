"""BatchNorm with flax.linen.BatchNorm's train-mode semantics, for every
BatchNorm of the port (IF-Net stages, UNet / UNetMini).

torch's nn.BatchNorm*d normalizes a training batch with its biased variance
but folds the UNBIASED one into running_var; flax (momentum=0.9,
epsilon=1e-5, as the JAX package's modules use it) folds the biased one:
running = 0.9 * running + 0.1 * batch.  The first train step of a converted
model would leave different running statistics in the two.  flax also takes
the batch variance as E[x^2] - E[x]^2 (use_fast_variance), which differs
from torch's two-pass variance by enough (2e-5 relative on the first IF-Net
level at the test dims, more after a few layers) to move the next layers'
statistics past 1e-6; the train-mode forward here computes flax's formula
in flax's order.  Eval mode is F.batch_norm with the running statistics.
This module keeps nn.BatchNorm's parameter and buffer names, so state_dicts
and sv3d_tpu_torch.convert.from_flax are unchanged.

dtype (None, or torch.bfloat16 for --precision 16) is flax's
BatchNorm(dtype=...): the statistics come from the input widened to f32
(flax's force_float32_reductions), the running statistics stay f32, the
normalization, scale and bias run in f32 in both modes, and the output is
rounded to dtype.  None keeps the input's dtype throughout, so a float64
module stays float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Normalizes dim 1 of an (N, C, ...) input over every other dim."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum  # flax convention: weight of the old statistic
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            return self._normalize(x.float()).to(self.dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        """flax's formula on x as it is: train mode folds the batch
        statistics into the running ones, eval mode reads those."""
        shape = [1, -1] + [1] * (x.ndim - 2)
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        dims = [0, *range(2, x.ndim)]
        mean = x.mean(dims)
        var = ((x * x).mean(dims) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
