"""Convolutional Occupancy Networks' grid variant (Peng et al., ECCV 2020;
github.com/autonomousvision/convolutional_occupancy_networks,
configs/pointcloud/room_grid64.yaml), SceneNet's decoder under
Config(decoder="convonet_grid") in the place of Projection and the IF-Net:
it takes the back-projected depth as its point cloud.

Three parts, each a module of the source:

  * LocalPoolPointnet (src/encoder/pointnet.py): fc_pos (3 -> 2h) on the
    raw points, a ResnetBlockFC(2h, h), then four times a block over the
    points' features beside the max over the points of their cell
    (ops/cell_pool.py::local_max_pool), fc_c (h -> c); the features'
    mean over each cell (scatter_mean) makes a (B, c, g, g, g) grid,
    laid out (z, y, x), empty cells 0.
  * UNet3D (src/encoder/unet3d.py, pytorch-3dunet's): levels of two convs in
    the order "gcr" (GroupNorm over the input's channels, a bias-free 3x3x3
    conv, ReLU), an encoder conv1 going to max(out / 2, in) channels, a 2x
    max-pool before each level but the first; the decoder upsamples to the
    skip's size (nearest), puts the skip first in the concatenation, then
    two convs (in -> out, out -> out); last a 1x1x1 conv with bias and no
    activation.  Every 3x3x3 conv of training takes its weight gradient
    from the hand-written kernel (models/wgrad.py::WgradConv3d), which the
    tracer counts as convonet.wgrad and convonet.wgrad_kernel.
  * LocalDecoder (src/conv_onet/models/decoder.py): the grid sampled
    trilinearly at the normalized query points (grid_sample, border,
    align_corners), fc_p (3 -> h) on the raw points, then per block net =
    block(net + fc_c_i(c)), and fc_out(relu(net)).

ResnetBlockFC (src/layers.py): x_s + fc_1(relu(fc_0(relu(x)))), x_s a
bias-free linear where the widths differ; fc_0's width min(in, out).
Weights are drawn as flax initializes (models/init.py), fc_1's weight 0 as
the source sets it.  The source guards its normalization with host-side
tests; here it is unconditional (ops/cell_pool.py).  forward() opens the
tracer's spans convonet.encode, convonet.unet3d and convonet.decode, and
counts convonet.pool for each local pool."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu_torch.config import ConvONetConfig
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.models.wgrad import WgradConv3d
from sv3d_tpu_torch.ops.cell_pool import (
    cell_index,
    local_max_pool,
    normalize_coordinate,
    scatter_mean,
)
from sv3d_tpu_torch.utils.profiling import count, span

#: room_grid64's widths: the PointNet's and the decoder's hidden width, the
#: feature volume's channels, the ResnetBlockFC of the PointNet and of the
#: decoder, GroupNorm's groups (one below 8 channels), the unit cube's margin
#: in normalize
HIDDEN, C_DIM, ENCODER_BLOCKS, DECODER_BLOCKS, GROUPS, PADDING = 32, 32, 5, 5, 8, 0.1


class ResnetBlockFC(nn.Module):
    def __init__(self, size_in: int, size_out: int | None = None):
        super().__init__()
        size_out = size_in if size_out is None else size_out
        size_h = min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = None if size_in == size_out else nn.Linear(size_in, size_out, bias=False)

    def forward(self, x):
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + dx


class LocalPoolPointnet(nn.Module):
    def __init__(self, hidden: int, c_dim: int, blocks: int):
        super().__init__()
        self.fc_pos = nn.Linear(3, 2 * hidden)
        self.blocks = nn.ModuleList(ResnetBlockFC(2 * hidden, hidden) for _ in range(blocks))
        self.fc_c = nn.Linear(hidden, c_dim)

    def forward(self, p, index, cells: int):
        """(B, N, c) features of the points p (B, N, 3) in cells index (B, N)."""
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            count("convonet.pool")
            net = block(torch.cat([net, local_max_pool(net, index, cells)], dim=2))
        return self.fc_c(net)


class _GcrConv(nn.Module):
    """GroupNorm over the input's channels (one group below `groups`
    channels), a bias-free 3x3x3 conv, ReLU: pytorch-3dunet's SingleConv in
    the order "gcr"."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups if cin >= groups else 1, cin)
        self.conv = nn.Conv3d(cin, cout, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.norm(x)
        w = self.conv.weight
        if torch.is_grad_enabled() and w.requires_grad:
            y = WgradConv3d.apply(y, w, None, "convonet")
        else:
            y = F.conv3d(y, w, None, padding=1)
        return F.relu(y)


def _double_conv(cin: int, cout: int, groups: int, encoder: bool) -> nn.ModuleList:
    mid = max(cout // 2, cin) if encoder else cout
    return nn.ModuleList([_GcrConv(cin, mid, groups), _GcrConv(mid, cout, groups)])


class UNet3D(nn.Module):
    def __init__(self, channels: int, fmaps, groups: int):
        super().__init__()
        chans = [channels, *fmaps]
        self.encoders = nn.ModuleList(_double_conv(a, b, groups, True)
                                      for a, b in zip(chans[:-1], chans[1:]))
        rev = list(reversed(fmaps))
        self.decoders = nn.ModuleList(_double_conv(a + b, b, groups, False)
                                      for a, b in zip(rev[:-1], rev[1:]))
        self.final_conv = nn.Conv3d(fmaps[0], channels, 1)

    def forward(self, x):
        skips = []
        for i, level in enumerate(self.encoders):
            if i:
                x = F.max_pool3d(x, 2)
            for conv in level:
                x = conv(x)
            skips.append(x)
        for level, skip in zip(self.decoders, reversed(skips[:-1])):
            x = torch.cat([skip, F.interpolate(x, size=skip.shape[2:], mode="nearest")], dim=1)
            for conv in level:
                x = conv(x)
        return self.final_conv(x)


class LocalDecoder(nn.Module):
    def __init__(self, c_dim: int, hidden: int, blocks: int, padding: float):
        super().__init__()
        self.padding = padding
        self.fc_p = nn.Linear(3, hidden)
        self.fc_c = nn.ModuleList(nn.Linear(c_dim, hidden) for _ in range(blocks))
        self.blocks = nn.ModuleList(ResnetBlockFC(hidden) for _ in range(blocks))
        self.fc_out = nn.Linear(hidden, 1)

    def forward(self, grid, q):
        """Logits (B, N) at the points q (B, N, 3) of the grid (B, c, g, g, g)."""
        vgrid = 2.0 * normalize_coordinate(q, self.padding) - 1.0
        c = F.grid_sample(grid, vgrid[:, :, None, None], mode="bilinear", padding_mode="border",
                          align_corners=True)[:, :, :, 0, 0].transpose(1, 2)
        net = self.fc_p(q)
        for fc_c, block in zip(self.fc_c, self.blocks):
            net = block(net + fc_c(c))
        return self.fc_out(F.relu(net))[..., 0]


class ConvONet(nn.Module):
    """forward(cloud, points) -> (B, N) occupancy logits: the cloud (B, M, 3)
    encoded into the grid, the U-Net over it, the decoder at the points
    (B, N, 3); both in normed grid space [-0.5, 0.5]^3, each axis of the
    frustum's box normalized to ConvONet's unit cube."""

    def __init__(self, config: ConvONetConfig = ConvONetConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = c = config
        self.encoder = LocalPoolPointnet(HIDDEN, C_DIM, ENCODER_BLOCKS)
        self.unet3d = UNet3D(C_DIM, c.fmaps, GROUPS)
        self.decoder = LocalDecoder(C_DIM, HIDDEN, DECODER_BLOCKS, PADDING)
        flax_init_(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, ResnetBlockFC):
                    m.fc_1.weight.zero_()
        self.to(device)

    def encode(self, cloud):
        """The feature grid (B, c, g, g, g) of the cloud (B, M, 3), before the
        U-Net."""
        g = self.config.grid
        cells = g ** 3
        index = cell_index(normalize_coordinate(cloud.detach(), PADDING), g)
        return scatter_mean(self.encoder(cloud, index, cells), index, g)

    def forward(self, cloud, points):
        with span("convonet.encode", device=True):
            grid = self.encode(cloud)
        with span("convonet.unet3d", device=True):
            grid = self.unet3d(grid)
        with span("convonet.decode", device=True):
            return self.decoder(grid, points)
