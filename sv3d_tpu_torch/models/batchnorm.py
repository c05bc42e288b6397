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

The batch statistics come from sums that do not depend on how the batch is
split: each sample's sum (and sum of squares) in the input's dtype, the
samples' sums added in float64, then E[x] and E[x^2] rounded to that dtype.
With a process group set (set_group; a multi-GPU mesh's sp column, whose
ranks together hold the global batch), those float64 sums and the count
are all-reduced over the group by torch.distributed.nn's differentiable
all_reduce, so the gradient flows back through the global statistics, and
the statistics, the normalized output and the running statistics are those
of the whole batch in one process, bit for bit where each sample's sums
are.  Without a group nothing is communicated.
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
        self.group = None  # a torch.distributed group whose ranks share the batch

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
        mean, var = self._batch_statistics(x)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked += 1
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def _batch_statistics(self, x: torch.Tensor) -> tuple:
        """(E[x], E[x^2] - E[x]^2) per channel in x's dtype, over the batch
        (and the group's ranks), from float64 sums of each sample's sums."""
        spatial = tuple(range(2, x.ndim))
        per_sample = (x, x * x) if not spatial else (x.sum(spatial), (x * x).sum(spatial))
        sums = torch.cat(per_sample, dim=1).double().sum(0)  # (2C,): sum x, sum x^2
        count = x.numel() // x.shape[1]
        if self.group is not None:
            from torch.distributed.nn.functional import all_reduce

            total = all_reduce(torch.cat([sums, sums.new_tensor([count])]), group=self.group)
            sums, count = total[:-1], total[-1]
        mean, ex2 = (sums / count).to(x.dtype).chunk(2)
        return mean, (ex2 - mean * mean).clamp(min=0.0)


def set_group(module: nn.Module, group) -> nn.Module:
    """Every BatchNorm of module takes its train-mode statistics over the
    ranks of group (None: this process's batch alone)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module
