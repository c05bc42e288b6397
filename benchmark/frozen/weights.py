"""Seeded weights for a model's state dict, drawn on its device.

Every matrix and kernel (a leaf of two dimensions or more) is drawn as flax
initializes it, lecun normal truncated to two standard deviations (variance
1 / fan_in), from one uniform draw on the device fed through the normal's
inverse CDF; biases are 0; a BatchNorm's scale and running variance 1, its
running mean 0; the projection's sigma the configuration's."""

from __future__ import annotations

import math

import torch

#: the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def seeded_state_dict(template: dict, sigma, seed: int, device) -> dict:
    """template: {name: tensor} (a model's state_dict, for names, shapes and
    dtypes) -> {name: tensor on device}, the same for the same seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    mats = [(k, t.shape) for k, t in template.items() if t.ndim >= 2]
    total = sum(math.prod(s) for _, s in mats)
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)).float()
    out, off = {}, 0
    for k, shape in mats:
        n = math.prod(shape)
        std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD
        out[k] = (z[off:off + n] * std).view(shape)
        off += n
    for k, t in template.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[-1]
        if k == "project.sigma":
            out[k] = torch.tensor(sigma, dtype=t.dtype, device=device)
        elif leaf == "running_var" or (leaf == "weight" and t.ndim == 1):
            out[k] = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out
