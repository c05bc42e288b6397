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
contracts fc0 per level, so the (B, N, 7*sumC) feature tensor never exists;
with bands= set it runs the inference-only K6, which contracts fc0 inside the
kernel.  query_fused takes a compute_dtype: float32 (its default, the
training path's) is exact like query(); bfloat16 is the JAX fused paths'
class (bf16 operands, f32 accumulation), which evaluate_points serves by
default.
query_lattice() sweeps the dense lattice through K2 by default, or
materializes the slab's features and runs the decoder through K3
(fused_tail=False), in the JAX package's compute_dtype: bfloat16 by default
(serving), float32 for parity.  No shard_map: on a multi-GPU mesh each
rank computes the pyramid of its rows and queries its own slice of the
points (SceneNet.forward(point_slice=), sv3d_tpu_torch/parallel), and the
lattice rows split over the ranks in inference/dense_grid.py.

dtype=torch.bfloat16 (--precision 16) is the flax module's dtype: the conv
stages compute and return bf16 on f32 parameters (models/mixed.py, bf16
BatchNorm), so levels 1.. are bf16 and level 0 stays the f32 input grid.
query() interpolates a bf16 level in bf16 and then runs fc0 onward in f32
(the concat with level 0 promotes); query_fused() casts bf16 levels to f32
at its boundary for its float32 route (the kernels' f32 operands; the
cast's backward returns the level's gradient to bf16); the bf16 routes and
the sweep read a bf16 level as it is.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.models.batchnorm import BatchNorm
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.models.mixed import conv, widen
from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import conv3d_wgrad
from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp, mlp_operands
from sv3d_tpu_torch.ops.cuda.point_query import (
    fc0_block_bf16,
    level_fc0_bf16_cuda,
    level_fc0_cuda,
    level_features,
    level_features_banded_cuda,
)
from sv3d_tpu_torch.ops.cuda.sweep import SweepPlan, lattice_sweep
from sv3d_tpu_torch.ops.grid_sample import (
    Pyramid,
    displacement_axes,
    flatten_grid,
    sample_trilinear_flat,
)
from sv3d_tpu_torch.ops.lattice import slab_features
from sv3d_tpu_torch.ops.mlp import COMPUTE_DTYPES, matmul_bf16
from sv3d_tpu_torch.utils.profiling import count


class _PyramidConv(torch.autograd.Function):
    """F.conv3d(x, weight, bias, padding=1) whose weight gradient is
    conv3d_wgrad's (the plain version on the CPU, the kernel on the card);
    the input's and the bias's gradients stay aten's (cuDNN on the card).
    The tracer counts ifnet.wgrad for each weight gradient taken and
    ifnet.wgrad_kernel for each one the kernel computes."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        if need_x or need_b:
            dx, _, db = torch.ops.aten.convolution_backward(
                dy, x, weight, [weight.shape[0]], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
                [need_x, False, need_b])
        if need_w:
            dw = conv3d_wgrad(x, dy)
            count("ifnet.wgrad")
            if dy.is_cuda:
                count("ifnet.wgrad_kernel")
        return dx, dw, db


class _ConvBlock(nn.Module):
    """Conv3d(k3 p1) + ReLU pair(s) + BatchNorm, one pyramid stage, in dtype
    (None: the parameters').  In f32 training (dtype None, grad enabled, a
    weight that requires grad) each conv runs as _PyramidConv, whose weight
    gradient is the hand-written kernel's on the card; otherwise (inference,
    bf16, a frozen weight) as the plain layer."""

    def __init__(self, cin: int, features, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        chans = [cin] + list(features)
        self.convs = nn.ModuleList(
            nn.Conv3d(a, b, 3, padding=1) for a, b in zip(chans[:-1], chans[1:])
        )
        self.bn = BatchNorm(chans[-1], dtype=dtype)

    def forward(self, x):
        for layer in self.convs:
            if self.dtype is None and torch.is_grad_enabled() and layer.weight.requires_grad:
                y = _PyramidConv.apply(x, layer.weight, layer.bias)
            else:
                y = conv(layer, x, self.dtype)
            x = F.relu(y)
        return self.bn(x)


class IFNet(nn.Module):
    """Multi-scale implicit occupancy network.

    forward(grid, points) -> (B, N) occupancy logits; or encode(grid) ->
    Pyramid, then query / query_fused (arbitrary points) or query_lattice
    (dense-lattice logits).  grid: (B, D0, D1, D2, 1) channels-last
    occupancy volume; points: (B, N, 3) in [-0.5, 0.5].  BatchNorm follows
    the module's train/eval mode.  Weights are drawn from generator with
    flax's initializers, then the module moves to device.  dtype: None or
    torch.bfloat16 (the conv stages' compute dtype)."""

    def __init__(self, config: IFNetConfig = IFNetConfig(), device=None,
                 generator: torch.Generator | None = None, dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.dtype = dtype
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
            _ConvBlock(cin, s, dtype) for cin, s in zip(cins, stages)
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

    def fc0_blocks(self) -> list:
        """Per pyramid level, its (7*C, H) block of fc0, rows d*C + c (K4's
        feature order), as the transpose of an (H, 7*C) copy: a matmul takes
        it as it is, K6 after .contiguous().  fc0's columns are
        displacement-major over the global channels, d * sumC + cg + c."""
        chans = list(self.config.feature_channels)
        h_dim = self.fc0.weight.shape[0]
        w0 = self.fc0.weight.view(h_dim, 7, sum(chans))
        return [
            w0[:, :, cg:cg + c].reshape(h_dim, 7 * c).t()
            for cg, c in zip(np.cumsum([0, *chans[:-1]]).tolist(), chans)
        ]

    def fc0_operands(self, bands=None, compute_dtype=torch.float32) -> list:
        """fc0_blocks() as query_fused's route reads them, made once for
        many calls with unchanged weights (evaluate_points): float32 with
        bands set, contiguous (K6 f32); bfloat16 with bands set,
        fc0_block_bf16 (K6 bf16); bfloat16 without, rounded to bf16 (the
        matmul after K5); float32 without, fc0_blocks() itself."""
        blocks = self.fc0_blocks()
        if compute_dtype == torch.bfloat16:
            return [fc0_block_bf16(w) if bands else w.detach().to(torch.bfloat16)
                    for w in blocks]
        return [w.contiguous() for w in blocks] if bands else blocks

    def encode(self, grid: torch.Tensor) -> Pyramid:
        """Run the conv pyramid once; level 0 is the raw input grid.
        Returns a Pyramid of channel-major (B, C, G) levels, levels 1.. in
        the module's dtype (max-pooled in it, as the JAX package pools)."""
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

    def _mlp_tail(self, h: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        """fc0 pre-activations (B, N, H) -> (B, N) logits.  bfloat16: as the
        JAX fused query's tail, each ReLU output and weight rounded to bf16,
        f32 products and biases (matmul_bf16)."""
        h = F.relu(h)
        if compute_dtype == torch.bfloat16:
            for layer in (self.fc1, self.fc2):
                h = F.relu(matmul_bf16(h, layer.weight.t()) + layer.bias)
            return (matmul_bf16(h, self.fc_out.weight.t()) + self.fc_out.bias)[..., 0]
        for layer in (self.fc1, self.fc2):
            h = F.relu(F.linear(h, layer.weight, layer.bias))
        return F.linear(h, self.fc_out.weight, self.fc_out.bias)[..., 0]

    def query(self, levels: Pyramid, points: torch.Tensor) -> torch.Tensor:
        """Occupancy logits (B, N) at arbitrary points (B, N, 3) in
        [-0.5, 0.5]: the exact f32 gather path, differentiable by autograd.
        A bf16 level is interpolated in bf16 (weights, products and corner
        sums), as the JAX package's gather does; the features then widen to
        the f32 of level 0 for fc0 onward."""
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

    def query_fused(self, levels: Pyramid, points: torch.Tensor, bands=None,
                    w0_blocks=None, compute_dtype=torch.float32) -> torch.Tensor:
        """query() through the point-query kernels.

        bands=None: per level, K4 features (B, N, 7*C_l) contracted at once
        with that level's (H, 7*C_l) block of fc0 (a plain torch.matmul, as
        the JAX package leaves it to XLA), then the MLP tail.  K8 and K7
        carry the gradient back to the level and the points.

        bands set (an int or "auto", as the JAX package takes it): per level,
        K6 contracts the features with the level's fc0 block inside the
        kernel, adding into one (B, N, H) buffer that starts as the fc0 bias;
        then the MLP tail.  Inference-only: under autograd it raises
        NotImplementedError.  The band count only sizes the TPU's 2-D query
        bucketing (bucket_queries_2d, ops/pallas/cost.py::choose_bands), which
        the port does not have, so any band count gives the same result.

        compute_dtype: float32 (the default, the training path's) is exact,
        on f32 levels (bf16 ones are widened here, as the JAX package's
        query_fused casts a precision-16 pyramid);
        bfloat16 is the JAX fused query's class (inference-only): the levels
        rounded to bf16, features rounded once, fc0 in bf16 with f32 sums --
        by K6 bf16 with bands set (each level's partial rounded to bf16), by
        K5 and a bf16 matmul without -- and the tail in bf16 (_mlp_tail).
        A bf16 level is read as it is; evaluate_points stages the pyramid
        rounded to bf16 and channels-last once a call.

        w0_blocks: fc0_operands(bands, compute_dtype), from a caller that
        queries many tiles with unchanged weights (evaluate_points); made
        anew on each call when None."""
        cfg = self.config
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"query_fused: compute_dtype must be one of {COMPUTE_DTYPES}")
        bf16 = compute_dtype == torch.bfloat16
        if not bf16 and any(f.dtype == torch.bfloat16 for f in levels.flats):
            # the f32 kernels' interface, as the JAX package's query_fused
            # casts a precision-16 pyramid: autograd returns the level's
            # gradient to bf16 for the conv backward
            levels = Pyramid([widen(f) for f in levels.flats], levels.dims)
        p0, p1, p2 = ((2.0 * points[..., i]).contiguous() for i in range(3))
        args = (cfg.align_corners, cfg.displacement)
        if w0_blocks is None:
            w0_blocks = self.fc0_operands(bands, compute_dtype)
        if bands:
            b, n = points.shape[:2]
            h = self.fc0.bias.expand(b, n, self.fc0.bias.shape[0]).contiguous()
            kernel = level_fc0_bf16_cuda if bf16 else level_fc0_cuda
            for (flat, dims), w0l in zip(levels, w0_blocks):
                h = kernel(flat, w0l, p0, p1, p2, dims, *args, out=h)
            return self._mlp_tail(h, compute_dtype)
        h = self.fc0.bias
        for (flat, dims), w0l in zip(levels, w0_blocks):
            if bf16:
                # K5 reads a bf16 level as it is (evaluate_points' staged pyramid)
                level = flat.to(torch.bfloat16)
                h = h + matmul_bf16(level_features_banded_cuda(level, p0, p1, p2, dims, *args),
                                    w0l)
            else:
                h = h + torch.matmul(level_features(flat, p0, p1, p2, dims, *args), w0l)
        return self._mlp_tail(h, compute_dtype)

    def forward(self, grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """encode, then the point query IFNetConfig.fused_query picks."""
        levels = self.encode(grid)
        if self.config.fused_query:
            return self.query_fused(levels, points)
        return self.query(levels, points)

    def sweep_plan(self, levels: Pyramid, resolution, res_increase: int = 1,
                   compute_dtype=torch.bfloat16) -> SweepPlan:
        """Everything the sweep kernel K2 reads that no slab changes (tables,
        weights in its layouts, for bfloat16 the pyramid staged in bf16),
        prepared once for a sweep of the lattice whose axis i has
        resolution[i] * res_increase points.  It copies what it reads;
        query_lattice(plan=) raises ValueError when the levels or weights
        are not those it was made from, or changed in place since."""
        cfg = self.config
        r = tuple(int(x) * res_increase for x in resolution)
        return SweepPlan(levels, self.mlp, r, cfg.align_corners, cfg.displacement, compute_dtype)

    def query_lattice(
        self, levels: Pyramid, resolution, res_increase: int = 1, slab_rows: int = 4,
        row_offset: int = 0, compute_dtype=torch.bfloat16, fused_tail: bool | None = None,
        plan: SweepPlan | None = None,
    ) -> torch.Tensor:
        """Occupancy logits on rows [row_offset, row_offset + slab_rows) of
        the dense lattice over [-0.5, 0.5]^3 whose axis i has
        resolution[i] * res_increase points: (B, slab_rows, r1, r2).

        compute_dtype (the JAX package's, bfloat16 by default): bfloat16 is
        the JAX fused tail's precision class (levels, features, weights and
        hidden activations rounded to bf16, f32 accumulation); float32 is
        exact f32, the parity route.

        fused_tail None or True (the counterpart of the JAX package's fused
        tail): the sweep kernel K2 of compute_dtype for CUDA levels, its
        plain torch version for CPU levels (sv3d_tpu_torch/ops/cuda/sweep.py).
        plan: sweep_plan(levels, resolution, res_increase, compute_dtype),
        from a caller that sweeps many slabs (evaluate_on_grid_device); made
        here when None; a plan made for another lattice, dtype, pyramid or
        weights, or whose weights changed in place since, raises ValueError.
        fused_tail=False: the unfused branch -- the levels rounded to
        compute_dtype, the slab's displacement-major (B, 7*sumC, n_slab)
        features materialized (ops/lattice.py slab_features), then the
        decoder through K3 in compute_dtype once per batch element (its plain
        version for CPU levels), the weights laid out for it once a call
        (mlp_operands): in bf16 K3 rounds the features, the weights and each
        ReLU output, as the JAX package's K3 does.  The feature
        matrix is 7 * sumC * n_slab * 4 bytes (120 MB a lattice row at full
        width), so keep slab_rows small there."""
        cfg = self.config
        r = tuple(int(x) * res_increase for x in resolution)
        if fused_tail is None or fused_tail:
            if plan is None:
                plan = self.sweep_plan(levels, resolution, res_increase, compute_dtype)
            elif plan.compute_dtype != compute_dtype or plan.r != r:
                raise ValueError("query_lattice: the plan was made for another lattice or dtype")
            else:
                plan.check(levels, self.mlp)
            return lattice_sweep(plan, slab_rows, int(row_offset))
        rounded = [(flat.to(compute_dtype).float(), dims) for flat, dims in levels]
        f = slab_features(rounded, r, slab_rows, int(row_offset), cfg.align_corners,
                          cfg.displacement)
        b = f.shape[0]
        weights = [t for layer in self.mlp for t in layer]
        # K3's weight layouts once a call, not once an element (the plain
        # version on CPU levels reads the weights as they are)
        operands = mlp_operands(weights, compute_dtype) if f.is_cuda else None
        logits = torch.stack([fused_point_mlp(f[i], *weights, compute_dtype=compute_dtype,
                                              operands=operands) for i in range(b)])
        return logits.reshape(b, slab_rows, r[1], r[2])
