"""IF-Net implicit occupancy network (port of sv3d_tpu/models/ifnet.py: the
conv pyramid encode, the arbitrary-point queries of training and the
dense-lattice query of serving).

Two variants, selected by IFNetConfig.net_res:
  * 128-res: 6 levels (input + 16/32/64/128/128 channels, maxpool-2 between
    stages), displacement 0.0722, align_corners=False, MLP 2583 -> 256 ->
    256 -> 256 -> 1.
  * 32-res: 4 levels (input + 64/128/128), displacement 0.035,
    align_corners=True, MLP 2247 -> 512 -> 256 -> 256 -> 1.

fc0's input order is displacement-major, index d * sumC + c (c the global
channel across levels), as in the JAX package, so converted weights need no
permutation.

Two arbitrary-point queries, picked by IFNetConfig.fused_query as the JAX
package picks them: query() is the exact f32 gather path; query_fused()
runs the point-query kernels (K4 forward, K7/K8 backward) level by level and
contracts fc0 per level, so the (B, N, 7*sumC) feature tensor never exists.
The port's fused path is f32 throughout, exact like query(); the JAX fused
path is bf16 with f32 accumulation.  No mesh / shard_map routing: one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu.config import IFNetConfig
from sv3d_tpu_torch.models.batchnorm import BatchNorm
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.ops.cuda.point_query import level_features
from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep
from sv3d_tpu_torch.ops.grid_sample import (
    Pyramid,
    displacement_axes,
    flatten_grid,
    sample_trilinear_flat,
)


class _ConvBlock(nn.Module):
    """Conv3d(k3 p1) + ReLU pair(s) + BatchNorm, one pyramid stage."""

    def __init__(self, cin: int, features):
        super().__init__()
        chans = [cin] + list(features)
        self.convs = nn.ModuleList(
            nn.Conv3d(a, b, 3, padding=1) for a, b in zip(chans[:-1], chans[1:])
        )
        self.bn = BatchNorm(chans[-1])

    def forward(self, x):
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.bn(x)


class IFNet(nn.Module):
    """Multi-scale implicit occupancy network.

    forward(grid, points) -> (B, N) occupancy logits; or encode(grid) ->
    Pyramid, then query / query_fused (arbitrary points) or query_lattice
    (dense-lattice logits).  grid: (B, D0, D1, D2, 1) channels-last
    occupancy volume; points: (B, N, 3) in [-0.5, 0.5].  BatchNorm follows
    the module's train/eval mode.  Weights are drawn from generator with
    flax's initializers, then the module moves to device."""

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

    def _mlp_tail(self, h: torch.Tensor) -> torch.Tensor:
        """fc0 pre-activations (B, N, H) -> (B, N) logits."""
        h = F.relu(h)
        for layer in (self.fc1, self.fc2):
            h = F.relu(F.linear(h, layer.weight, layer.bias))
        return F.linear(h, self.fc_out.weight, self.fc_out.bias)[..., 0]

    def query(self, levels: Pyramid, points: torch.Tensor) -> torch.Tensor:
        """Occupancy logits (B, N) at arbitrary points (B, N, 3) in
        [-0.5, 0.5]: the exact f32 gather path, differentiable by autograd."""
        cfg = self.config
        b, n, _ = points.shape
        p_axes = tuple(2.0 * points[..., i] for i in range(3))
        pd = displacement_axes(p_axes, cfg.displacement)  # three (B, 7N)
        f = torch.cat(
            [sample_trilinear_flat(flat, dims, pd, cfg.align_corners) for flat, dims in levels],
            dim=1,
        )  # (B, sumC, 7N)
        # displacement-major features, index d * sumC + c: (B, N, 7 * sumC)
        f = f.reshape(b, f.shape[1], 7, n).permute(0, 3, 2, 1).reshape(b, n, -1)
        return self._mlp_tail(F.linear(f, self.fc0.weight, self.fc0.bias))

    def query_fused(self, levels: Pyramid, points: torch.Tensor) -> torch.Tensor:
        """query() through the point-query kernels: per level, K4 features
        (B, N, 7*C_l) contracted at once with that level's (H, 7*C_l) block of
        fc0 (a plain torch.matmul, as the JAX package leaves it to XLA), then
        the MLP tail.  K8 and K7 carry the gradient back to the level and the
        points."""
        cfg = self.config
        p0, p1, p2 = (2.0 * points[..., i] for i in range(3))
        chans = [flat.shape[1] for flat in levels.flats]
        # fc0's columns are displacement-major, d * sum_c + c
        w0 = self.fc0.weight.view(self.fc0.weight.shape[0], 7, sum(chans))
        h = self.fc0.bias
        for li, (flat, dims) in enumerate(levels):
            cg, c = sum(chans[:li]), chans[li]
            feat = level_features(flat, p0, p1, p2, dims, cfg.align_corners, cfg.displacement)
            h = h + torch.matmul(feat, w0[:, :, cg:cg + c].reshape(-1, 7 * c).t())
        return self._mlp_tail(h)

    def forward(self, grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """encode, then the point query IFNetConfig.fused_query picks."""
        levels = self.encode(grid)
        if self.config.fused_query:
            return self.query_fused(levels, points)
        return self.query(levels, points)

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
