"""IF-Net implicit occupancy network (port of the serving half of
sv3d_tpu/models/ifnet.py: the conv pyramid encode and the dense-lattice
query; the arbitrary-point query comes with the training slice).

Two variants, selected by IFNetConfig.net_res:
  * 128-res: 6 levels (input + 16/32/64/128/128 channels, maxpool-2 between
    stages), displacement 0.0722, align_corners=False, MLP 2583 -> 256 ->
    256 -> 256 -> 1.
  * 32-res: 4 levels (input + 64/128/128), displacement 0.035,
    align_corners=True, MLP 2247 -> 512 -> 256 -> 256 -> 1.

fc0's input order is displacement-major, index d * sumC + c (c the global
channel across levels), as in the JAX package, so converted weights need no
permutation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu.config import IFNetConfig
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep
from sv3d_tpu_torch.ops.grid_sample import Pyramid, flatten_grid


class _ConvBlock(nn.Module):
    """Conv3d(k3 p1) + ReLU pair(s) + BatchNorm, one pyramid stage."""

    def __init__(self, cin: int, features):
        super().__init__()
        chans = [cin] + list(features)
        self.convs = nn.ModuleList(
            nn.Conv3d(a, b, 3, padding=1) for a, b in zip(chans[:-1], chans[1:])
        )
        self.bn = nn.BatchNorm3d(chans[-1], eps=1e-5, momentum=0.1)

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.bn(x)


class IFNet(nn.Module):
    """Multi-scale implicit occupancy network.

    encode(grid) -> Pyramid; query_lattice(pyramid, ...) -> dense-lattice
    logits.  grid: (B, D0, D1, D2, 1) channels-last occupancy volume.
    Weights are drawn from generator with flax's initializers, then the
    module moves to device."""

    def __init__(self, config: IFNetConfig = IFNetConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = config
        if config.net_res == 128:
            stages = [[16], [32, 32], [64, 64], [128, 128], [128, 128]]
            hidden = (config.hidden_dim,) * 3
        elif config.net_res == 32:
            stages = [[32, 64], [128, 128], [128, 128]]
            hidden = (config.hidden_dim * 2, config.hidden_dim, config.hidden_dim)
        else:
            raise ValueError(f"net_res must be 128 or 32, got {config.net_res}")
        cins = [1] + [s[-1] for s in stages[:-1]]
        self.stages = nn.ModuleList(
            _ConvBlock(cin, s) for cin, s in zip(cins, stages)
        )
        sizes = (self.feature_size,) + hidden + (1,)
        for name, f_in, f_out in zip(("fc0", "fc1", "fc2", "fc_out"), sizes[:-1], sizes[1:]):
            setattr(self, name, nn.Linear(f_in, f_out))
        flax_init_(self, generator)
        self.to(device)

    @property
    def feature_size(self) -> int:
        return sum(self.config.feature_channels) * 7

    @property
    def mlp(self) -> list:
        """[(weight (out, in), bias)] for fc0, fc1, fc2, fc_out."""
        return [(m.weight, m.bias) for m in (self.fc0, self.fc1, self.fc2, self.fc_out)]

    def encode(self, grid: torch.Tensor) -> Pyramid:
        """Run the conv pyramid once; level 0 is the raw input grid.
        Returns a Pyramid of channel-major (B, C, G) levels."""
        x = grid.permute(0, 4, 1, 2, 3).contiguous()
        levels = [flatten_grid(x)]
        for i, stage in enumerate(self.stages):
            x = stage(x)
            levels.append(flatten_grid(x))
            if i < len(self.stages) - 1:
                dims = x.shape[2:]
                if min(dims) == 1:
                    # floor pooling would empty a size-1 dim at degenerate
                    # test scales; pad it with -inf, as the JAX package does
                    pad = []
                    for d in reversed(dims):
                        pad += [0, int(d == 1)]
                    x = F.pad(x, pad, value=float("-inf"))
                x = F.max_pool3d(x, 2, 2)
        return Pyramid([f for f, _ in levels], [d for _, d in levels])

    def query_lattice(
        self, levels: Pyramid, resolution, res_increase: int = 1, slab_rows: int = 4,
        row_offset: int = 0,
    ) -> torch.Tensor:
        """Occupancy logits on rows [row_offset, row_offset + slab_rows) of
        the dense lattice over [-0.5, 0.5]^3 whose axis i has
        resolution[i] * res_increase points: (B, slab_rows, r1, r2).

        Runs the CUDA sweep kernel for CUDA levels and its plain f32 torch
        version for CPU levels (sv3d_tpu_torch/ops/cuda/sweep.py)."""
        cfg = self.config
        r = tuple(int(x) * res_increase for x in resolution)
        return lattice_sweep(
            levels, self.mlp, r, slab_rows, int(row_offset), cfg.align_corners,
            cfg.displacement,
        )
