"""The port's CUDA kernels (K1, K1b, K2, K3, K4, K5, K6, K7, K8) against
their plain torch versions.

This file imports only sv3d_tpu_torch (the card machine has no flax).  The
tests marked ``cuda`` need an NVIDIA GPU and skip without one; run them on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  The
CPU test checks the part of the sweep kernel that Python owns: its 2-tap
tables and index arithmetic, replayed in numpy against the plain sweep."""

import numpy as np
import pytest
import torch

from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.inference.dense_grid import evaluate_points
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp
from sv3d_tpu_torch.ops.cuda.point_query import (
    level_fc0_cuda,
    level_features,
    level_features_banded_cuda,
    level_features_cuda,
    level_grad_points_cuda,
    level_grad_vol_cuda,
)
from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep, lattice_sweep_plain, sweep_tables
from sv3d_tpu_torch.ops.cuda.voxelize import (
    scatter_voxels,
    scatter_voxels_bwd_cuda,
    scatter_voxels_cuda,
    scatter_voxels_raw_cuda,
)
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain
from sv3d_tpu_torch.ops.point_query import (
    level_fc0_plain,
    level_features_banded_plain,
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)
from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd

torch.set_num_threads(1)

CASES = [(128, (17, 16, 18)), (32, (12, 9, 10))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encoded(net_res, dims, device="cpu"):
    cfg = IFNetConfig.for_net_res(net_res)
    model = IFNet(cfg, device=device, generator=torch.Generator().manual_seed(net_res)).eval()
    grid = np.random.default_rng(net_res).uniform(0, 1, (1, *dims, 1)).astype(np.float32)
    with torch.inference_mode():
        levels = model.encode(torch.tensor(grid, device=device))
    return cfg, model, levels


def _emulate_kernel(levels, mlp, r, rows, off, cfg):
    """csrc/sweep.cu's feature and fc0 arithmetic in numpy (f64)."""
    chans = [f.shape[1] for f in levels.flats]
    meta, tap_idx, tap_w = sweep_tables(chans, list(levels.dims), r, rows, off,
                                        cfg.align_corners, cfg.displacement)
    sum_c = sum(chans)
    n = rows * r[1] * r[2]
    p = np.arange(n)
    y, x, a = p % r[2], (p // r[2]) % r[1], p // (r[1] * r[2])
    mlp = [(w.detach().numpy(), b.detach().numpy()) for w, b in mlp]
    w0 = mlp[0][0].astype(np.float64)
    h = np.zeros((w0.shape[0], n))
    for d in range(7):
        v0, v1, v2 = {1: 1, 2: 2}.get(d, 0), {3: 1, 4: 2}.get(d, 0), {5: 1, 6: 2}.get(d, 0)
        for lv, (flat, (g0, g1, g2)) in enumerate(levels):
            c, cg = meta[lv, 0], meta[lv, 7]
            vol = flat[0].numpy().reshape(c, g0, g1 * g2)
            ea = meta[lv, 4] + v0 * rows + a
            ex = meta[lv, 5] + v1 * r[1] + x
            ey = meta[lv, 6] + v2 * r[2] + y
            f = np.zeros((c, n))
            for ca in range(2):
                for cb in range(2):
                    for cc in range(2):
                        w = tap_w[ea, ca] * tap_w[ex, cb] * tap_w[ey, cc]
                        f += w * vol[:, tap_idx[ea, ca], tap_idx[ex, cb] * g2 + tap_idx[ey, cc]]
            h += w0[:, d * sum_c + cg: d * sum_c + cg + c] @ f
    for i, (w, b) in enumerate(mlp):
        if i:
            h = w @ h
        h = h + b[:, None]
        if i < len(mlp) - 1:
            h = np.maximum(h, 0.0)
    return h[0].reshape(rows, r[1], r[2])


@pytest.mark.parametrize("net_res,dims", CASES)
def test_sweep_tables_replay_the_plain_sweep(net_res, dims):
    """Interior slab, a slab running past the lattice end, res_increase 1
    and 2; f32 plain vs f64 replay: atol 1e-5."""
    cfg, model, levels = _encoded(net_res, dims)
    for ri, rows, off in ((2, 2, 4), (1, 5, dims[0] - 2)):
        r = tuple(ri * d for d in dims)
        with torch.inference_mode():
            ref = lattice_sweep_plain(levels, model.mlp, r, rows, off, cfg.align_corners,
                                      cfg.displacement)
        got = _emulate_kernel(levels, model.mlp, r, rows, off, cfg)
        np.testing.assert_allclose(got, ref[0].numpy(), atol=1e-5)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_card(cuda_device):
    """K1: atomics sum in a run-dependent order, atol 1e-5 after the clamp;
    K1b (the backward, through autograd): the same gathers in another
    summation order, 1e-5 of the largest gradient (csrc/voxelize.cu)."""
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(-0.7, 0.7, (2, 76800, 3)).astype(np.float32),
                       device=cuda_device)
    dims = (139, 104, 112)
    before = scatter_voxels_cuda.launches
    got = scatter_voxels_cuda(pts, dims)
    torch.cuda.synchronize()
    assert scatter_voxels_cuda.launches == before + 1
    torch.testing.assert_close(got, scatter_voxels(pts, dims), atol=1e-5, rtol=0)
    with pytest.raises(TypeError):
        scatter_voxels_cuda(pts.double(), dims)

    p = pts.clone().requires_grad_()
    w = torch.randn((2, *dims), device=cuda_device)
    before = scatter_voxels_bwd_cuda.launches
    (scatter_voxels_cuda(p, dims) * w).sum().backward()
    torch.cuda.synchronize()
    assert scatter_voxels_bwd_cuda.launches == before + 1
    raw = scatter_voxels_raw_cuda(pts, dims)
    assert _rel_err(p.grad, scatter_voxels_bwd(pts, raw, w)) <= 1e-5
    assert _rel_err(scatter_voxels_bwd_cuda(pts, raw, w), scatter_voxels_bwd(pts, raw, w)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c", [1, 16, 64])
def test_point_query_kernels_match_plain_on_card(ac, disp, c, cuda_device):
    """K4, K7, K8 against their plain versions, both conventions, channel
    counts that give 1, 2 and 1/2 points per warp; points partly outside the
    volume.  1e-5 of the largest plain magnitude (summation order; K8's
    atomics in run-dependent order)."""
    rng = np.random.default_rng(c)
    dims = (19, 13, 14)
    flat = torch.tensor(rng.standard_normal((2, c, 19 * 13 * 14)).astype(np.float32),
                        device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    g = torch.tensor(rng.standard_normal((2, 333, 7 * c)).astype(np.float32), device=cuda_device)
    args = (dims, ac, disp)
    counts = [f.launches for f in (level_features_cuda, level_grad_points_cuda, level_grad_vol_cuda)]
    assert _rel_err(level_features_cuda(flat, *p, *args), level_features_plain(flat, *p, *args)) <= 1e-5
    assert _rel_err(level_grad_points_cuda(flat, *p, g, *args),
                    level_grad_points_plain(flat, *p, g, *args)) <= 1e-5
    assert _rel_err(level_grad_vol_cuda(*p, g, *args), level_grad_vol_plain(*p, g, *args)) <= 1e-5
    torch.cuda.synchronize()
    assert [f.launches for f in (level_features_cuda, level_grad_points_cuda,
                                 level_grad_vol_cuda)] == [n + 1 for n in counts]

    # through autograd: K4 forward, K8 always, K7 only when a coordinate needs it
    vol = flat.clone().requires_grad_()
    (level_features(vol, *p, *args) * g).sum().backward()
    assert level_grad_points_cuda.launches == counts[1] + 1
    assert _rel_err(vol.grad, level_grad_vol_plain(*p, g, *args)) <= 1e-5
    q = [x.clone().requires_grad_() for x in p]
    (level_features(flat, *q, *args) * g).sum().backward()
    assert level_grad_points_cuda.launches == counts[1] + 2
    ref = level_grad_points_plain(flat, *p, g, *args)
    assert _rel_err(torch.stack([x.grad for x in q], -1), ref) <= 1e-5
    with pytest.raises(ValueError):
        level_features_cuda(flat[:, :, :-1], *p, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_sweep_kernel_matches_plain_on_card(net_res, dims, cuda_device):
    """f32 FMA kernel vs plain f32 torch: summation order only, atol 1e-4."""
    cfg, model, levels = _encoded(net_res, dims, cuda_device)
    r = tuple(2 * d for d in dims)
    with torch.inference_mode():
        for rows, off in ((2, 0), (5, r[0] - 3), (r[0], 0)):
            before = lattice_sweep.launches
            got = lattice_sweep(levels, model.mlp, r, rows, off, cfg.align_corners,
                                cfg.displacement)
            torch.cuda.synchronize()
            assert lattice_sweep.launches == before + 1
            ref = lattice_sweep_plain(levels, model.mlp, r, rows, off, cfg.align_corners,
                                      cfg.displacement)
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c,h", [(1, 256), (16, 512), (64, 256), (160, 256)])
def test_inference_point_kernels_match_plain_on_card(ac, disp, c, h, cuda_device):
    """K6 against its plain version, alone and adding into a buffer: 1e-5 of
    the largest plain magnitude (FMA order over 7*C terms).  K5: at most one
    bf16 ulp, |d| <= 2^-7 |ref| + 1e-6 (the kernel's and the plain f32
    features may round either way of a bf16 boundary).  C = 160 takes two
    channel rounds in K6.  Both raise under autograd."""
    rng = np.random.default_rng(c + h)
    dims = (19, 13, 14)
    flat = torch.tensor(rng.standard_normal((2, c, 19 * 13 * 14)).astype(np.float32),
                        device=cuda_device)
    w0l = torch.tensor((rng.standard_normal((7 * c, h)) / np.sqrt(7 * c)).astype(np.float32),
                       device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    args = (dims, ac, disp)
    counts = [level_fc0_cuda.launches, level_features_banded_cuda.launches]
    ref = level_fc0_plain(flat, w0l, *p, *args)
    assert _rel_err(level_fc0_cuda(flat, w0l, *p, *args), ref) <= 1e-5
    acc = torch.randn((2, 333, h), device=cuda_device)
    got = level_fc0_cuda(flat, w0l, *p, *args, out=acc.clone())
    assert _rel_err(got, acc + ref) <= 1e-5
    got = level_features_banded_cuda(flat, *p, *args)
    ref = level_features_banded_plain(flat, *p, *args)
    assert got.dtype == torch.bfloat16
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-6).all()), float(diff.max())
    torch.cuda.synchronize()
    assert [level_fc0_cuda.launches, level_features_banded_cuda.launches] == [
        counts[0] + 2, counts[1] + 1]
    with pytest.raises(NotImplementedError):
        level_fc0_cuda(flat.clone().requires_grad_(), w0l, *p, *args)
    with pytest.raises(NotImplementedError):
        level_features_banded_cuda(flat, p[0].clone().requires_grad_(), *p[1:], *args)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_kernel_matches_plain_on_card(net_res, cuda_device):
    """K3 against its plain version at F 2583 (H0 256) and 2247 (H0 512), N
    not a multiple of the block's points: atol 1e-4 on logits (summation
    order), as K2."""
    model = IFNet(IFNetConfig.for_net_res(net_res), device=cuda_device,
                  generator=torch.Generator().manual_seed(net_res)).eval()
    weights = [t.detach() for layer in model.mlp for t in layer]
    f = torch.tensor(np.random.default_rng(net_res).standard_normal(
        (model.feature_size, 1001)).astype(np.float32), device=cuda_device)
    before = fused_point_mlp.launches
    got = fused_point_mlp(f, *weights)
    torch.cuda.synchronize()
    assert fused_point_mlp.launches == before + 1
    torch.testing.assert_close(got, fused_point_mlp_plain(f, *weights), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_points_and_unfused_sweep_on_card_match_cpu(net_res, dims, cuda_device):
    """evaluate_points on the card through K6 (bands="auto"), K4 (bands=None)
    and the gather path against the CPU's plain run: 1e-5 on the sigmoid;
    query_lattice(fused_tail=False) through K3 against K2: atol 1e-4."""
    cfg, cpu_model, _ = _encoded(net_res, dims)
    card = IFNet(cfg, device=cuda_device, generator=torch.Generator().manual_seed(net_res)).eval()
    grid = (np.random.default_rng(1).uniform(0, 1, (1, *dims, 1)) > 0.9).astype(np.float32)
    pts = np.random.default_rng(2).uniform(-0.55, 0.55, (1000, 3)).astype(np.float32)
    ref = evaluate_points(cpu_model, grid, pts, tile_points=384, use_kernel=False)
    for kw in (dict(), dict(bands=None), dict(use_kernel=False)):
        got = evaluate_points(card, grid, pts, tile_points=384, **kw)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    with torch.inference_mode():
        levels = card.encode(torch.tensor(grid, device=cuda_device))
        before = fused_point_mlp.launches
        got = card.query_lattice(levels, dims, 2, 3, 5, fused_tail=False)
        assert fused_point_mlp.launches == before + 1
        torch.testing.assert_close(got, card.query_lattice(levels, dims, 2, 3, 5),
                                   atol=1e-4, rtol=0)
