"""Each f32 kernel's limit, the constant beside its wrapper in
sv3d_tpu_torch/ops/cuda/, tells the f32 class from the bf16 one (CPU).

The kernel's plain version in float32 lies within the limit of the same
function in float64; the same plain version run on operands rounded to
bfloat16 lies outside it.  So a kernel that drops into the bf16 class fails
the limit that its card tests and chip_smoke.py hold it to.  Tiny shapes,
seeded inputs; the rounded operands are the values a bf16 kernel of the JAX
package's class would round (levels, features, weights, cotangents), never
the coordinates."""

import numpy as np
import pytest
import torch

from sv3d_tpu_torch.ops.cuda.conv3d_dgrad import DGRAD_RTOL, conv3d_dgrad_plain
from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import WGRAD_RTOL, conv3d_wgrad_plain
from sv3d_tpu_torch.ops.cuda.mlp import K3_TOL
from sv3d_tpu_torch.ops.cuda.point_query import K4_RTOL, K6_RTOL, K7_RTOL, K8_RTOL
from sv3d_tpu_torch.ops.cuda.sweep import K2_TOL, lattice_sweep_plain
from sv3d_tpu_torch.ops.cuda.voxelize import K1B_RTOL
from sv3d_tpu_torch.ops.lattice import slab_features
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain
from sv3d_tpu_torch.ops.point_query import (
    level_fc0_plain,
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)
from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd

torch.set_num_threads(1)

LEVEL_DIMS = [(5, 4, 6), (3, 2, 3)]
CHANNELS = [3, 4]
HIDDEN = (16, 16, 16)
R = (4, 3, 5)
AC, DISP = False, 0.0722


def _max_abs(got, ref):
    return float((got - ref).abs().max())


def _rel_max(got, ref):
    return _max_abs(got, ref) / float(ref.abs().max())


def _per_channel(dim):
    def err(got, ref):
        g, r = got.transpose(0, dim).flatten(1), ref.transpose(0, dim).flatten(1)
        return float(((g - r).norm(dim=1) / r.norm(dim=1)).max())
    return err


def _decoder64(h, mlp):
    """The decoder on (B, F, N) features without a rounding: (B, N)."""
    for i, (w, b) in enumerate(mlp):
        h = torch.einsum("hf,bfn->bhn", w, h) + b[:, None]
        if i < len(mlp) - 1:
            h = torch.relu(h)
    return h[:, 0]


def _mlp(rng, n_feat):
    widths = (n_feat, *HIDDEN, 1)
    return [(torch.tensor(rng.standard_normal((o, i)) / np.sqrt(i), dtype=torch.float32),
             torch.tensor(0.1 * rng.standard_normal(o), dtype=torch.float32))
            for i, o in zip(widths[:-1], widths[1:])]


def _k2(rng):
    """K2 f32: the lattice sweep's logits, atol on logits."""
    levels = [torch.tensor(rng.standard_normal((1, c, int(np.prod(d)))), dtype=torch.float32)
              for c, d in zip(CHANNELS, LEVEL_DIMS)]
    mlp = _mlp(rng, 7 * sum(CHANNELS))

    def run(flats, *weights):
        pairs = list(zip(weights[::2], weights[1::2]))
        lv = list(zip(flats, LEVEL_DIMS))
        if flats[0].dtype == torch.float64:
            f = slab_features(lv, R, R[0], 0, AC, DISP)
            return _decoder64(f, pairs).reshape(1, *R)
        return lattice_sweep_plain(lv, pairs, R, R[0], 0, AC, DISP)

    return run, [levels, *[t for wb in mlp for t in wb]], K2_TOL, _max_abs


def _k3(rng):
    """K3 f32: the decoder's logits on a feature matrix, atol on logits."""
    n_feat = 7 * sum(CHANNELS)
    f = torch.tensor(rng.standard_normal((n_feat, 300)), dtype=torch.float32)
    mlp = _mlp(rng, n_feat)

    def run(f, *weights):
        if f.dtype == torch.float64:
            return _decoder64(f[None], list(zip(weights[::2], weights[1::2])))[0]
        return fused_point_mlp_plain(f, *weights)

    return run, [f, *[t for wb in mlp for t in wb]], K3_TOL, _max_abs


def _points(rng, n=200):
    return [torch.tensor(rng.uniform(-0.6, 0.6, (2, n)), dtype=torch.float32)
            for _ in range(3)]


def _level(rng, c=5):
    dims = LEVEL_DIMS[0]
    return dims, torch.tensor(rng.standard_normal((2, c, int(np.prod(dims)))),
                              dtype=torch.float32)


def _k4(rng):
    """K4: a level's displaced features at points, of the largest |feature|."""
    dims, flat = _level(rng)
    p = _points(rng)
    return (lambda flat: level_features_plain(flat, *[x.to(flat.dtype) for x in p], dims, AC,
                                              DISP),
            [flat], K4_RTOL, _rel_max)


def _k6(rng):
    """K6 f32: a level's fc0 partial at points, of the largest |partial|."""
    dims, flat = _level(rng)
    w0l = torch.tensor(rng.standard_normal((7 * 5, 16)) / np.sqrt(35), dtype=torch.float32)
    p = _points(rng)
    return (lambda flat, w0l: level_fc0_plain(flat, w0l, *[x.to(flat.dtype) for x in p], dims,
                                              AC, DISP),
            [flat, w0l], K6_RTOL, _rel_max)


def _k7(rng):
    """K7: the features' gradient in the coordinates, of the largest one."""
    dims, flat = _level(rng)
    p = _points(rng)
    g = torch.tensor(rng.standard_normal((2, 200, 7 * 5)), dtype=torch.float32)
    return (lambda flat, g: level_grad_points_plain(flat, *[x.to(flat.dtype) for x in p], g,
                                                    dims, AC, DISP),
            [flat, g], K7_RTOL, _rel_max)


def _k8(rng):
    """K8: the features' gradient in the level, of the largest one."""
    dims, _ = _level(rng)
    p = _points(rng)
    g = torch.tensor(rng.standard_normal((2, 200, 7 * 5)), dtype=torch.float32)
    return (lambda g: level_grad_vol_plain(*[x.to(g.dtype) for x in p], g, dims, AC, DISP),
            [g], K8_RTOL, _rel_max)


def _k1b(rng):
    """K1b: the scatter's gradient in the points, of the largest one; the
    grid's values keep clear of the clamp's mask edges 0 and 1."""
    dims = (7, 6, 5)
    points = torch.tensor(rng.uniform(-0.45, 0.45, (2, 300, 3)), dtype=torch.float32)
    grid = torch.tensor(rng.uniform(0.05, 0.95, (2, *dims)), dtype=torch.float32)
    grad = torch.tensor(rng.standard_normal((2, *dims)), dtype=torch.float32)
    return (lambda grid, grad: scatter_voxels_bwd(points.to(grid.dtype), grid, grad),
            [grid, grad], K1B_RTOL, _rel_max)


def _wgrad(rng):
    """The conv weight gradient, by output channel's norm."""
    x = torch.tensor(rng.standard_normal((2, 6, 5, 4, 7)), dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((2, 8, 5, 4, 7)), dtype=torch.float32)
    return conv3d_wgrad_plain, [x, dy], WGRAD_RTOL, _per_channel(0)


def _dgrad(rng):
    """The conv input gradient, by input channel's norm."""
    dy = torch.tensor(rng.standard_normal((2, 8, 5, 4, 7)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((8, 6, 3, 3, 3)) / np.sqrt(8 * 27),
                     dtype=torch.float32)
    return (lambda dy, w: conv3d_dgrad_plain(dy, w, (2, 6, 5, 4, 7)), [dy, w], DGRAD_RTOL,
            _per_channel(1))


def _cast(operands, fn):
    return [[fn(t) for t in op] if isinstance(op, list) else fn(op) for op in operands]


@pytest.mark.parametrize("case", [_k1b, _k2, _k3, _k4, _k6, _k7, _k8, _wgrad, _dgrad],
                         ids=lambda c: c.__name__[1:])
def test_f32_limit_rejects_the_bf16_class(case):
    run, operands, tol, err = case(np.random.default_rng(0))
    exact = run(*_cast(operands, torch.Tensor.double))
    f32 = run(*operands).double()
    bf16 = run(*_cast(operands, lambda t: t.to(torch.bfloat16).float())).double()
    assert f32.dtype == exact.dtype and f32.shape == exact.shape
    assert err(f32, exact) <= tol < err(bf16, exact), (err(f32, exact), tol, err(bf16, exact))
