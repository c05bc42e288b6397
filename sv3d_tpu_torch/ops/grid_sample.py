"""Encoded feature pyramids (port of the Pyramid / flatten_grid half of
sv3d_tpu/ops/grid_sample.py; the gather sampler comes with the training
slice)."""

from __future__ import annotations

import torch


class Pyramid:
    """An encoded multi-level feature pyramid in the channel-major layout:
    flats[l] is (B, C_l, G0_l*G1_l*G2_l), dims[l] its 3-D shape."""

    def __init__(self, flats, dims):
        self.flats = tuple(flats)
        self.dims = tuple(tuple(int(x) for x in d) for d in dims)

    def __iter__(self):
        return iter(zip(self.flats, self.dims))

    def __len__(self):
        return len(self.flats)


def flatten_grid(grid: torch.Tensor):
    """(B, C, G0, G1, G2) -> contiguous channel-major (B, C, G0*G1*G2) + dims.

    The port keeps volumes NCDHW internally, so this is a reshape; the JAX
    package's flatten_grid takes the channels-last (B, G0, G1, G2, C).  cuDNN
    may hand back a conv output in channels_last_3d memory (a C=1 input is
    ambiguous), so the flat level is made contiguous here."""
    b, c, g0, g1, g2 = grid.shape
    return grid.reshape(b, c, g0 * g1 * g2).contiguous(), (g0, g1, g2)
