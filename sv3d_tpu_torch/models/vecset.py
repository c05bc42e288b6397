"""3DShape2VecSet's occupancy autoencoder (Zhang, Tang, Niessner and Wonka,
SIGGRAPH 2023; github.com/1zb/3DShape2VecSet models_ae.py: AutoEncoder,
PointEmbed, Attention, FeedForward / GEGLU, PreNorm), SceneNet's decoder
under Config(decoder="vecset") in the place of Projection and the IF-Net: it
takes the back-projected depth as its point cloud.  Modules and state-dict
names are the source's.

With x the latents and LN a LayerNorm with affine:

  * PE(p) = Linear(6 F + 3 -> dim)([sin(p B), cos(p B), p]), B (3, 3 F)
    holding pi 2^k, k < F, on axis a's F columns (a constant, kept out of
    the state dict); one PE for the cloud, the seeds and the queries.
  * Attn_h(y, c): q = y Wq, [k | v] = c Wkv (no biases), softmax(q k^T /
    sqrt(dim_head)) v per head by F.scaled_dot_product_attention, the heads
    merged, then Wo with a bias.  PreNorm applies LN to y and, for a
    cross-attention, a LN of its own to c.
  * FF(y) = W2 (a * gelu(g)) + b2, [a | g] = W1 y + b1 (GEGLU, exact gelu).
  * Encoder: e = PE(inputs), s = PE(seeds); x = Attn_1(LN s, LN e) + s with
    dim_head = dim; x = FF(LN x) + x.
  * depth times: x = Attn_heads(LN x) + x; x = FF(LN x) + x.
  * Decoder: logits = Linear(dim -> 1)(Attn_1(LN PE(queries), LN x)), no
    residual.

The inputs are a lattice of the back-projected pixels (lattice_index), the
seeds its even rows and columns (seed_index), in the source's place of a
surface sample and its farthest-point sample.  Coordinates are the port's
normed grid space, [-0.5, 0.5] over the frustum's box, doubled onto
[-1, 1].  No drop path (the source's 0.1 is a training regulariser the
benchmark leaves out).  Weights are drawn as flax initializes
(models/init.py).  forward() opens the tracer's spans vecset.encode,
vecset.latents and vecset.decode, and vecset.attention around each
attention call, which it also counts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu_torch.config import VecSetConfig
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.utils.profiling import count, span

#: ae_d512_m512's widths that nothing varies: GEGLU's hidden width over dim,
#: the Fourier frequencies an axis, LayerNorm's epsilon
FF_MULT, NUM_FREQS, LN_EPS = 4, 8, 1e-5


def lattice_index(h: int, w: int, rows: int, cols: int, device=None) -> torch.Tensor:
    """(rows * cols,) flat indices into a row-major h x w image, row-major
    over the lattice: pixel (floor((2 i + 1) h / (2 rows)), floor((2 j + 1) w
    / (2 cols))), the centre of cell (i, j) of a rows x cols division."""
    r = (2 * torch.arange(rows, device=device) + 1) * h // (2 * rows)
    c = (2 * torch.arange(cols, device=device) + 1) * w // (2 * cols)
    return (r[:, None] * w + c[None, :]).reshape(-1)


def seed_index(rows: int, cols: int, device=None) -> torch.Tensor:
    """The positions among the lattice's rows * cols inputs of those whose
    row i and column j are both even, row-major."""
    i = torch.arange(0, rows, 2, device=device)
    j = torch.arange(0, cols, 2, device=device)
    return (i[:, None] * cols + j[None, :]).reshape(-1)


class PointEmbed(nn.Module):
    def __init__(self, dim: int, num_freqs: int):
        super().__init__()
        freqs = math.pi * 2.0 ** torch.arange(num_freqs, dtype=torch.float64)
        # made in float64 and rounded once to the points' dtype (or the
        # module's, which .to(dtype) gives it), so pi 2^k is as exact as the
        # points' precision allows
        self.register_buffer("basis", torch.block_diag(*[freqs[None]] * 3), persistent=False)
        self.mlp = nn.Linear(6 * num_freqs + 3, dim)

    def forward(self, p):
        proj = p @ self.basis.to(p.dtype)
        return self.mlp(torch.cat([proj.sin(), proj.cos(), p], dim=-1))


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, query_dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        k, v = self.to_kv(context).chunk(2, dim=-1)
        q, k, v = (t.unflatten(-1, (self.heads, -1)).transpose(1, 2)
                   for t in (self.to_q(x), k, v))
        with span("vecset.attention", device=True):
            count("vecset.attention")
            out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).flatten(2))


class GEGLU(nn.Module):
    def forward(self, x):
        a, gates = x.chunk(2, dim=-1)
        return a * F.gelu(gates)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, 2 * mult * dim), GEGLU(),
                                 nn.Linear(mult * dim, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module, eps: float, context_dim: int | None = None):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim, eps=eps)
        self.norm_context = None if context_dim is None else nn.LayerNorm(context_dim, eps=eps)

    def forward(self, x, context=None):
        x = self.norm(x)
        if self.norm_context is None:
            return self.fn(x)
        return self.fn(x, self.norm_context(context))


class VecSet(nn.Module):
    """forward(cloud, points, image_size) -> (B, N) occupancy logits: the
    lattice of the cloud (B, H*W, 3), the back-projection of an H x W depth
    map (image_size (H, W)), encoded into the latents, which the query points
    (B, N, 3) attend to; both in normed grid space [-0.5, 0.5]^3."""

    def __init__(self, config: VecSetConfig = VecSetConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = c = config
        d, eps = c.dim, LN_EPS
        cross = lambda: PreNorm(d, Attention(d, d, 1, d), eps, context_dim=d)
        ff = lambda: PreNorm(d, FeedForward(d, FF_MULT), eps)
        self.point_embed = PointEmbed(d, NUM_FREQS)
        self.cross_attend_blocks = nn.ModuleList([cross(), ff()])
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(d, Attention(d, d, c.heads, c.dim_head), eps), ff()])
            for _ in range(c.depth))
        self.decoder_cross_attn = cross()
        self.to_outputs = nn.Linear(d, 1)
        flax_init_(self, generator)
        self.to(device)
        self._index: dict = {}

    def _indices(self, image_size, device) -> tuple:
        """The lattice's flat pixel indices and the seeds' positions among
        them, made once an image size and device."""
        key = (*image_size, device)
        if key not in self._index:
            rows, cols = self.config.lattice
            self._index[key] = (lattice_index(*image_size, rows, cols, device),
                                seed_index(rows, cols, device))
        return self._index[key]

    def forward(self, cloud, points, image_size):
        inputs, seeds = self._indices(tuple(image_size), cloud.device)
        with span("vecset.encode", device=True):
            e = self.point_embed(2.0 * cloud[:, inputs])
            s = e[:, seeds]
            attn, ff = self.cross_attend_blocks
            x = attn(s, e) + s
            x = ff(x) + x
        with span("vecset.latents", device=True):
            for attn, ff in self.layers:
                x = attn(x) + x
                x = ff(x) + x
        with span("vecset.decode", device=True):
            h = self.decoder_cross_attn(self.point_embed(2.0 * points), x)
            return self.to_outputs(h)[..., 0]
