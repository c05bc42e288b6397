"""Points binned into the cells of a cube's grid, as Convolutional Occupancy
Networks bins them (src/common.py::normalize_3d_coordinate and
coordinate2index; torch_scatter's scatter_max and scatter_mean in
src/encoder/pointnet.py::LocalPoolPointnet), in plain torch: the
normalization to the unit cube, a point's cell, the channel-wise max over the
points of a cell given back to each of them (the local pool), and the mean
over the points of a cell (the feature grid).

Features are channels-last, (B, N, C), so that a point's channels are one
contiguous row of the cells' table; a cell index is x + g (y + g z), the
row-major (z, y, x) layout of a (g, g, g) grid that grid_sample reads with
(x, y, z) coordinates.  No kernel of the port's own: the sums and maxima are
aten's scatters, whose order on the card is not fixed."""

from __future__ import annotations

import torch

#: the margin ConvONet keeps inside the unit cube's faces (its 10e-4)
EDGE = 1e-3


def normalize_coordinate(p: torch.Tensor, padding: float) -> torch.Tensor:
    """Points of [-0.5, 0.5]^3 into [0, 1)^3: p / (1 + padding + 1e-3) +
    0.5, a value at or above 1 set to 1 - 1e-3 and one below 0 to 0.  The
    source guards the two with host-side tests of the maximum and minimum;
    here they run unconditionally, so no value is read back to the host."""
    n = p / (1.0 + padding + EDGE) + 0.5
    return torch.where(n >= 1.0, 1.0 - EDGE, n).clamp_min(0.0)


def cell_index(n: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, N) int64 cells of normalized points n (B, N, 3) in [0, 1)^3:
    floor(n * grid) per axis, x + grid (y + grid z)."""
    c = (n * grid).long()
    return c[..., 0] + grid * (c[..., 1] + grid * c[..., 2])


def local_max_pool(x: torch.Tensor, index: torch.Tensor, cells: int) -> torch.Tensor:
    """(B, N, C): for each point of x (B, N, C) the channel-wise max over the
    points that share its cell (index (B, N) into `cells` cells).  Autograd
    passes a maximum's gradient to the points that hold it, shared evenly
    between ties (scatter_reduce's amax)."""
    b, n, c = x.shape
    idx = index[:, :, None].expand(b, n, c)
    table = x.new_zeros(b, cells, c).scatter_reduce(1, idx, x, "amax", include_self=False)
    return table.gather(1, idx)


def scatter_mean(x: torch.Tensor, index: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, C, grid, grid, grid), laid out (z, y, x): the mean of x (B, N, C)
    over the points of each cell (index (B, N) into grid^3 cells), 0 in a
    cell that holds none."""
    b, n, c = x.shape
    cells = grid ** 3
    flat = (index + cells * torch.arange(b, device=index.device)[:, None]).reshape(-1)
    sums = x.new_zeros(b * cells, c).index_add(0, flat, x.reshape(b * n, c))
    counts = x.new_zeros(b * cells).index_add(0, flat, x.new_ones(b * n))
    mean = (sums / counts.clamp_min(1.0)[:, None]).view(b, cells, c)
    return mean.transpose(1, 2).reshape(b, c, grid, grid, grid)
