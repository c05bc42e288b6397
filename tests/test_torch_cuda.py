"""The port's CUDA kernels (K1, K1b, K2, K3, K4, K5, K6 f32 and bf16, K7,
K8) against their plain torch versions.

This file imports only sv3d_tpu_torch (the card machine has no flax); each
kernel's limits are its wrapper's constants, and chip_smoke.py is run for
its own references: the bf16 plain versions with a rounding point left
out, points_card_vs_cpu and one_kernel_a_call.  The tests marked ``cuda``
need an NVIDIA GPU and skip without one; run them on
the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  The
CPU tests check the part of the sweep kernels that Python owns: the 2-tap
tables and their index arithmetic, replayed in numpy against the plain
sweep; the sweep plan's whole-lattice tables cut to a slab as the kernels
index them; the bf16 kernel's fc0 order and mma fragment layouts; the
f32 kernel's fc0 rows and chunk table; that the sweep's values do not depend on slab_rows; and that
K2 bf16's mean limit fails a sweep that rounds at the wrong points.  One
card test holds the multi-GPU BatchNorm (its statistics all-reduced over
two ranks on the one card) to the whole batch's."""

import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.inference.dense_grid import (
    evaluate_on_grid,
    evaluate_on_grid_device,
    evaluate_points,
)
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda import rel_mean_err
from sv3d_tpu_torch.ops.cuda.mlp import K3_BF16_REL_MEAN_TOL, K3_BF16_TOL, K3_TOL, fused_point_mlp
from sv3d_tpu_torch.ops.cuda.point_query import (
    K4_RTOL,
    K5_ULP,
    K6_BF16_REL_MEAN_TOL,
    K6_BF16_TOL,
    K6_RTOL,
    K7_RTOL,
    K8_RTOL,
    fc0_block_bf16,
    level_fc0_bf16_cuda,
    level_fc0_cuda,
    level_features,
    level_features_banded_cuda,
    level_features_cuda,
    level_grad_points_cuda,
    level_grad_vol_cuda,
    stage_channels_last,
)
from sv3d_tpu_torch.ops.cuda.sweep import (
    K2_BF16_REL_MEAN_TOL,
    K2_BF16_TOL,
    K2_TOL,
    SweepPlan,
    fc0_chunk_order,
    fc0_chunk_table,
    fc0_in_chunk_order,
    lattice_sweep,
    lattice_sweep_bf16_cuda,
    lattice_sweep_f32_cuda,
    lattice_sweep_plain,
    mma_b_fragments,
    sweep_tables,
)
from sv3d_tpu_torch.ops.cuda.voxelize import (
    K1B_RTOL,
    K1_TOL,
    k1_raw_tol,
    scatter_voxels,
    scatter_voxels_bwd_cuda,
    scatter_voxels_cuda,
    scatter_voxels_raw_cuda,
)
from sv3d_tpu_torch.ops.lattice import slab_features
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain
from sv3d_tpu_torch.ops.point_query import (
    level_fc0_plain,
    level_features_banded_plain,
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)
from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd, scatter_voxels_raw
from sv3d_tpu_torch.quality import box_scene

torch.set_num_threads(1)

CASES = [(128, (17, 16, 18)), (32, (12, 9, 10))]
ROOT = Path(__file__).resolve().parents[1]


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


def _slab_tables(meta, tap_idx, tap_w, r, rows, row_offset):
    """A slab's tables cut from the whole lattice's, indexed as csrc/sweep.cu
    indexes them: axis-0 entry (variant v, slab row a) is the lattice's
    entry of row row_offset + a, zero past the lattice; axes 1 and 2 as
    they are."""
    r0 = r[0]
    lattice_row = row_offset + np.arange(rows)
    ok = lattice_row < r0
    idx, wts = [], []
    for m in meta:
        e0 = m[4] + np.arange(3)[:, None] * r0 + np.where(ok, lattice_row, 0)[None]
        idx += [np.where(ok[None, :, None], tap_idx[e0], 0).reshape(-1, 2),
                tap_idx[m[5]:m[6] + 3 * r[2]]]
        wts += [np.where(ok[None, :, None], tap_w[e0], 0.0).reshape(-1, 2),
                tap_w[m[5]:m[6] + 3 * r[2]]]
    out = meta.copy()
    base = np.arange(len(meta)) * 3 * (rows + r[1] + r[2])
    out[:, 4:7] = np.stack([base, base + 3 * rows, base + 3 * (rows + r[1])], axis=1)
    return (out, np.ascontiguousarray(np.concatenate(idx).astype(np.int32)),
            np.ascontiguousarray(np.concatenate(wts).astype(np.float32)))


@pytest.mark.parametrize("net_res,dims", CASES)
def test_sweep_plan_tables_cut_to_any_slab(net_res, dims):
    """The plan's tables cover all r0 rows; cut at (rows, row_offset) as the
    kernels index them (_slab_tables) they equal sweep_tables of that slab:
    interior slabs, the first and last row, slabs running past the lattice,
    res_increase 1 and 2."""
    cfg, _, levels = _encoded(net_res, dims)
    chans = [f.shape[1] for f in levels.flats]
    for ri in (1, 2):
        r = tuple(ri * d for d in dims)
        full = sweep_tables(chans, list(levels.dims), r, r[0], 0, cfg.align_corners,
                            cfg.displacement)
        for rows, off in ((1, 0), (1, r[0] - 1), (3, 4), (5, r[0] - 3), (r[0], 0), (4, r[0])):
            want = sweep_tables(chans, list(levels.dims), r, rows, off, cfg.align_corners,
                                cfg.displacement)
            got = _slab_tables(*full, r, rows, off)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w, err_msg=f"{ri} {rows}+{off}")


@pytest.mark.parametrize("net_res,dims", CASES)
def test_evaluate_on_grid_is_identical_for_any_slab_rows(net_res, dims):
    """The sweep's values do not depend on the slab a point came in: slab_rows
    1, 3 and r0 (the default, None, is r0), bf16 (the default) and f32, bit
    for bit (CPU: the plain versions)."""
    cfg, model, _ = _encoded(net_res, dims)
    grid = torch.tensor(np.random.default_rng(5).uniform(0, 1, (1, *dims, 1)).astype(np.float32))
    ref = evaluate_on_grid(model, grid, dims)
    assert ref.shape == dims and np.isfinite(ref).all()
    for slab_rows in (1, 3, dims[0]):
        np.testing.assert_array_equal(evaluate_on_grid(model, grid, dims, 1, slab_rows), ref)
    with torch.inference_mode():
        levels = model.encode(grid)
        f32 = [evaluate_on_grid_device(model, levels, dims, 1, s, torch.float32)[:dims[0]]
               for s in (1, 3, dims[0])]
    for got in f32[1:]:
        assert torch.equal(got, f32[0])
    assert float((f32[0] - torch.tensor(ref)).abs().max()) < 2e-2


@pytest.mark.parametrize("net_res", [128, 32])
def test_bf16_sweep_kernel_layouts(net_res):
    """What the bf16 kernel reads, replayed in torch: fc0's K order holds
    every fc0 column once (zeros elsewhere), and the mma fragments, read back
    lane by lane as the kernel's registers are filled (b0: k = 2 (l % 4) +
    {0, 1}, b1: + 8; n = l // 4), give fc0, fc1 and fc2 back."""
    cfg = IFNetConfig.for_net_res(net_res)
    model = IFNet(cfg, generator=torch.Generator().manual_seed(3))
    chans = list(cfg.feature_channels)
    groups, cols = fc0_chunk_order(chans)
    assert len(cols) == 16 * int(groups[:, 2].sum())
    assert sorted(cols[cols >= 0].tolist()) == list(range(7 * sum(chans)))
    w0 = model.fc0.weight.detach()
    w0k = torch.zeros((w0.shape[0], len(cols)))
    w0k[:, torch.from_numpy(np.flatnonzero(cols >= 0))] = w0[:, torch.from_numpy(cols[cols >= 0])]
    for w in (w0k, model.fc1.weight.detach(), model.fc2.weight.detach()):
        frag = mma_b_fragments(w)
        n_out, k = w.shape
        assert frag.shape == (k // 16, n_out // 16, 32, 8)
        back = torch.zeros_like(w)
        lane = torch.arange(32)
        for tile in range(2):
            n = (torch.arange(n_out // 16)[:, None] * 16 + tile * 8 + lane // 4)  # (P, 32)
            for e, dk in enumerate((0, 1, 8, 9)):
                kk = 2 * (lane % 4) + dk  # (32,)
                for c in range(k // 16):
                    back[n, c * 16 + kk] = frag[c, :, :, tile * 4 + e]
        assert torch.equal(back, w)



@pytest.mark.parametrize("net_res,dims", CASES)
def test_f32_sweep_kernel_layouts(net_res, dims):
    """What the f32 kernel reads, replayed in torch: fc0 in the plan's K
    order (fc0_in_chunk_order) holds every fc0 column exactly once, with zero
    rows elsewhere; the chunk table walks that order 16 rows at a time as
    the kernel does (a packed one-channel chunk: row d the level at copy d,
    zeros past 7; else channel first + i of the level at copy d), one group
    index for each (level, d) in turn; features gathered so, contracted with
    the permuted fc0, then the f32 decoder, give lattice_sweep_plain within
    1e-5 on four lattice rows (CPU)."""
    cfg, model, levels = _encoded(net_res, dims)
    chans = [f.shape[1] for f in levels.flats]
    sum_c, cg = sum(chans), np.cumsum([0, *chans[:-1]])
    _, cols = fc0_chunk_order(chans)
    keep = torch.from_numpy(np.flatnonzero(cols >= 0))
    w0 = model.fc0.weight.detach()
    w0k = fc0_in_chunk_order(w0, chans)
    assert w0k.shape == (len(cols), w0.shape[0]) and len(cols) % 16 == 0
    assert sorted(cols[cols >= 0].tolist()) == list(range(7 * sum_c))
    assert torch.equal(w0k[keep], w0.t()[torch.from_numpy(cols[cols >= 0])])
    assert not w0k[torch.from_numpy(np.flatnonzero(cols < 0))].any()

    table = fc0_chunk_table(chans)
    assert table.shape == (len(cols) // 16, 4) and table.dtype == np.int32
    replay, groups = [], []
    for lv, d, first, g in table.tolist():
        if d < 0:
            assert chans[lv] == 1 and first == 0
            replay += [dd * sum_c + cg[lv] for dd in range(7)] + [-1] * 9
        else:
            assert chans[lv] % 16 == 0 and first % 16 == 0 and first < chans[lv]
            replay += [d * sum_c + cg[lv] + first + i for i in range(16)]
        if first == 0:
            groups.append((lv, d))
            assert g == len(groups) - 1
        assert groups[g] == (lv, d)
    assert replay == cols.tolist()

    r, rows, off = dims, 4, dims[0] // 2
    (_, b0), (w1, b1), (w2, b2), (w3, b3) = model.mlp
    with torch.inference_mode():
        f = slab_features(levels, r, rows, off, cfg.align_corners, cfg.displacement)
        fk = f.new_zeros((f.shape[0], len(cols), f.shape[2]))
        fk[:, keep] = f[:, torch.from_numpy(cols[cols >= 0])]
        h = torch.relu(torch.einsum("kh,bkn->bhn", w0k, fk) + b0[:, None])
        h = torch.relu(torch.einsum("hk,bkn->bhn", w1, h) + b1[:, None])
        h = torch.relu(torch.einsum("hk,bkn->bhn", w2, h) + b2[:, None])
        got = (torch.einsum("hk,bkn->bhn", w3, h) + b3[:, None])[:, 0]
        ref = lattice_sweep_plain(levels, model.mlp, r, rows, off, cfg.align_corners,
                                  cfg.displacement)
    torch.testing.assert_close(got.reshape(ref.shape), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("net_res,dims", CASES)
def test_k2_bf16_mean_limit_fails_wrong_rounding(net_res, dims):
    """chip_smoke.py's plain_bf16_sweep: with no rounding point left out it
    is the plain bf16 sweep bit for bit; without its feature or its hidden
    rounding it stays within K2 bf16's max limit on logits but fails the
    mean limit, K2_BF16_REL_MEAN_TOL of the mean |logit| (CPU)."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    cfg, model, levels = _encoded(net_res, dims)
    r = tuple(2 * d for d in dims)
    args = (cfg.align_corners, cfg.displacement)
    with torch.inference_mode():
        ref = lattice_sweep_plain(levels, model.mlp, r, r[0], 0, *args, torch.bfloat16)
        assert torch.equal(smoke["plain_bf16_sweep"](levels, model.mlp, r, r[0], 0, *args), ref)
        for skip in ("feature", "hidden"):
            wrong = smoke["plain_bf16_sweep"](levels, model.mlp, r, r[0], 0, *args, (skip,))
            assert float((wrong - ref).abs().max()) <= K2_BF16_TOL, skip
            assert rel_mean_err(wrong, ref) > K2_BF16_REL_MEAN_TOL, skip


@pytest.mark.parametrize("net_res", [128, 32])
def test_k3_bf16_mean_limit_fails_wrong_rounding(net_res):
    """chip_smoke.py's plain_bf16_mlp: with no rounding point left out it is
    K3's plain bf16 decoder bit for bit; without its hidden rounding it fails
    K3 bf16's mean limit, K3_BF16_REL_MEAN_TOL of the mean |logit|, on a
    slab of the served decoder's features (CPU)."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    dims = (17, 16, 18) if net_res == 128 else (12, 9, 10)
    cfg, model, levels = _encoded(net_res, dims)
    weights = [t.detach() for layer in model.mlp for t in layer]
    with torch.inference_mode():
        f = slab_features(levels, dims, 1, dims[0] // 2, cfg.align_corners,
                          cfg.displacement)[0]
        ref = fused_point_mlp_plain(f, *weights, compute_dtype=torch.bfloat16)
        assert torch.equal(smoke["plain_bf16_mlp"](f, *weights), ref)
        wrong = smoke["plain_bf16_mlp"](f, *weights, skip=("hidden",))
    assert rel_mean_err(wrong, ref) > K3_BF16_REL_MEAN_TOL


@pytest.mark.parametrize("net_res", [128, 32])
def test_k3_bf16_mean_limit_fails_unrounded_features(net_res):
    """chip_smoke.py's plain_bf16_mlp with the features left unrounded (the
    rounding that K3 bf16 does on load): it fails K3 bf16's mean limit on a
    slab of the served decoder's features (CPU; measured 1.1e-2 at net_res
    128 and 3.0e-3 at 32 against the limit's 3e-4)."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    dims = (17, 16, 18) if net_res == 128 else (12, 9, 10)
    cfg, model, levels = _encoded(net_res, dims)
    weights = [t.detach() for layer in model.mlp for t in layer]
    with torch.inference_mode():
        f = slab_features(levels, dims, 1, dims[0] // 2, cfg.align_corners,
                          cfg.displacement)[0]
        ref = fused_point_mlp_plain(f, *weights, compute_dtype=torch.bfloat16)
        wrong = smoke["plain_bf16_mlp"](f, *weights, skip=("feature",))
    assert rel_mean_err(wrong, ref) > K3_BF16_REL_MEAN_TOL


@pytest.mark.parametrize("net_res,dims", CASES)
def test_bf16_points_mean_limit_fails_another_class(net_res, dims):
    """chip_smoke.py's points_card_vs_cpu with the CPU model on both sides:
    every route agrees with itself exactly, and against the bf16 routes the
    f32 route and the bf16 route with its MLP tail in f32 fail the bf16
    points' mean limit, POINTS_BF16_REL_MEAN_TOL of the mean |logit|; the
    model's own tail is back afterwards."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    _, model, _ = _encoded(net_res, dims)
    grid = (np.random.default_rng(1).uniform(0, 1, (1, *dims, 1)) > 0.9).astype(np.float32)
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, (500, 3)).astype(np.float32)
    res = smoke["points_card_vs_cpu"](model, model, grid, pts, 256)
    assert all(a == 0.0 and m == 0.0 for a, m in res["routes"].values()), res["routes"]
    assert len(res["wrong"]) == 4
    assert min(res["wrong"].values()) > smoke["POINTS_BF16_REL_MEAN_TOL"], res["wrong"]
    assert "_mlp_tail" not in vars(model)


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.cuda
def test_scatter_kernel_matches_plain_on_card(cuda_device):
    """K1: atomics sum in a run-dependent order, atol K1_TOL after the
    clamp; K1b (the backward, through autograd): the same gathers in another
    summation order, K1B_RTOL of the largest gradient (csrc/voxelize.cu)."""
    rng = np.random.default_rng(3)
    pts = torch.tensor(rng.uniform(-0.7, 0.7, (2, 76800, 3)).astype(np.float32),
                       device=cuda_device)
    dims = (139, 104, 112)
    before = scatter_voxels_cuda.launches
    got = scatter_voxels_cuda(pts, dims)
    torch.cuda.synchronize()
    assert scatter_voxels_cuda.launches == before + 1
    torch.testing.assert_close(got, scatter_voxels(pts, dims), atol=K1_TOL, rtol=0)
    with pytest.raises(TypeError):
        scatter_voxels_cuda(pts.double(), dims)

    p = pts.clone().requires_grad_()
    w = torch.randn((2, *dims), device=cuda_device)
    before = scatter_voxels_bwd_cuda.launches
    (scatter_voxels_cuda(p, dims) * w).sum().backward()
    torch.cuda.synchronize()
    assert scatter_voxels_bwd_cuda.launches == before + 1
    raw = scatter_voxels_raw_cuda(pts, dims)
    assert _rel_err(p.grad, scatter_voxels_bwd(pts, raw, w)) <= K1B_RTOL
    assert (_rel_err(scatter_voxels_bwd_cuda(pts, raw, w), scatter_voxels_bwd(pts, raw, w))
            <= K1B_RTOL)



def _scatter_inputs(kind, device):
    """K1's inputs at the serving dims: the points that box_scene.k1_points
    projects from write_smoke_dataset's box-before-a-wall depth and from a
    plane at 3 m (B=2, 76,800 + 4,096 outside each); its degenerate input
    (each warp's 32 lanes in one voxel); and B=3 x 1013 uniform points, N
    not a multiple of 32 (warps straddle the samples, the last one ragged)
    with border-dropped points inside the warps."""
    dims = (139, 104, 112)
    rng = np.random.default_rng(12)
    if kind in ("box", "plane"):
        from sv3d_tpu_torch.config import Config

        model = box_scene.seeded_scene_net(Config(seed=0), device, 0)
        return dims, box_scene.k1_points(model, kind, 2, rng)
    pts = (box_scene.degenerate_points(dims, 80896, rng) if kind == "degenerate"
           else rng.uniform(-0.7, 0.7, (3, 1013, 3)).astype(np.float32))
    return dims, torch.tensor(pts, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["box", "plane", "degenerate", "ragged"])
def test_scatter_kernels_on_coherent_degenerate_and_ragged_inputs_on_card(kind, cuda_device):
    """K1 (warp-combined atomics) against its plain version: clamped at atol
    K1_TOL, raw within k1_raw_tol's 2 k 2^-24 of the largest sum (k the
    most contributions to one voxel); one launch a call.  K1b through
    autograd (given the clamped grid the forward kept, the cotangent as the
    blur's einsum backward strides it) and on a contiguous cotangent, at
    K1B_RTOL of the largest plain component."""
    dims, pts = _scatter_inputs(kind, cuda_device)
    before = scatter_voxels_cuda.launches
    got = scatter_voxels_cuda(pts, dims)
    torch.cuda.synchronize()
    assert scatter_voxels_cuda.launches == before + 1
    torch.testing.assert_close(got, scatter_voxels(pts, dims), atol=K1_TOL, rtol=0)
    raw = scatter_voxels_raw_cuda(pts, dims)
    assert _rel_err(raw, scatter_voxels_raw(pts, dims)) <= k1_raw_tol(pts, dims)
    issued, old = box_scene.k1_atomics(pts, dims)
    assert issued <= old if kind == "ragged" else issued < old

    b = pts.shape[0]
    g = torch.randn((dims[0], b, *dims[1:]), device=cuda_device).transpose(0, 1)
    p = pts.clone().requires_grad_()
    before = scatter_voxels_bwd_cuda.launches
    (scatter_voxels_cuda(p, dims) * g).sum().backward()
    torch.cuda.synchronize()
    assert scatter_voxels_bwd_cuda.launches == before + 1
    assert _rel_err(p.grad, scatter_voxels_bwd(pts, got, g)) <= K1B_RTOL
    for cot in (g, g.contiguous()):
        assert _rel_err(scatter_voxels_bwd_cuda(pts, got, cot),
                        scatter_voxels_bwd(pts, got, cot)) <= K1B_RTOL


FEATURE_CHANNELS = [1, 3, 16, 64, 128, 160]


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c", FEATURE_CHANNELS)
def test_point_query_kernels_match_plain_on_card(ac, disp, c, cuda_device):
    """K4, K7, K8 against their plain versions, both conventions, B = 2,
    points partly outside the volume.  K4's channel counts take its scalar
    path (1, 3: 32 and 8 points a warp) and its float4 path (16: 8 points a
    warp; 64, 128: 2 and 1; 160: one point a warp with a masked tail).
    K4_RTOL, K7_RTOL and K8_RTOL of the largest plain magnitude (summation
    order; K8's atomics in run-dependent order)."""
    rng = np.random.default_rng(c)
    dims = (19, 13, 14)
    flat = torch.tensor(rng.standard_normal((2, c, 19 * 13 * 14)).astype(np.float32),
                        device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    g = torch.tensor(rng.standard_normal((2, 333, 7 * c)).astype(np.float32), device=cuda_device)
    args = (dims, ac, disp)
    counts = [f.launches for f in (level_features_cuda, level_grad_points_cuda, level_grad_vol_cuda)]
    assert (_rel_err(level_features_cuda(flat, *p, *args), level_features_plain(flat, *p, *args))
            <= K4_RTOL)
    assert _rel_err(level_grad_points_cuda(flat, *p, g, *args),
                    level_grad_points_plain(flat, *p, g, *args)) <= K7_RTOL
    assert (_rel_err(level_grad_vol_cuda(*p, g, *args), level_grad_vol_plain(*p, g, *args))
            <= K8_RTOL)
    torch.cuda.synchronize()
    assert [f.launches for f in (level_features_cuda, level_grad_points_cuda,
                                 level_grad_vol_cuda)] == [n + 1 for n in counts]

    # through autograd: K4 forward, K8 always, K7 only when a coordinate needs it
    vol = flat.clone().requires_grad_()
    (level_features(vol, *p, *args) * g).sum().backward()
    assert level_grad_points_cuda.launches == counts[1] + 1
    assert _rel_err(vol.grad, level_grad_vol_plain(*p, g, *args)) <= K8_RTOL
    q = [x.clone().requires_grad_() for x in p]
    (level_features(flat, *q, *args) * g).sum().backward()
    assert level_grad_points_cuda.launches == counts[1] + 2
    ref = level_grad_points_plain(flat, *p, g, *args)
    assert _rel_err(torch.stack([x.grad for x in q], -1), ref) <= K7_RTOL
    with pytest.raises(ValueError):
        level_features_cuda(flat[:, :, :-1], *p, *args)


def _k5_within_one_ulp(got, ref):
    diff = (got.float() - ref.float()).abs()
    return bool((diff <= K5_ULP * ref.float().abs() + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 16, 160])
def test_feature_kernels_read_channels_last_levels_on_card(c, cuda_device):
    """K4 and K5 read a channels-last copy of the level, staged by their
    wrapper (C = 1 needs no copy); a level that already lies channels-last
    is read as it is (no copy) with the same result, also from a pointer
    that is not 16-byte aligned (the scalar path); a level in any other
    layout (every other channel of a wider one) is staged, never misread."""
    rng = np.random.default_rng(100 + c)
    dims = (19, 13, 14)
    g = 19 * 13 * 14
    flat = torch.tensor(rng.standard_normal((2, c, g)).astype(np.float32), device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    args = (dims, False, 0.0722)
    before = stage_channels_last.copies
    staged = stage_channels_last(flat)
    assert stage_channels_last.copies == before + (c > 1)
    assert torch.equal(staged, flat.transpose(1, 2).contiguous())

    ref4 = level_features_plain(flat, *p, *args)
    ref5 = level_features_banded_plain(flat, *p, *args)
    got4 = level_features_cuda(flat, *p, *args)
    assert _rel_err(got4, ref4) <= K4_RTOL
    buf = torch.empty(2 * g * c + 1, device=cuda_device)
    buf[1:] = staged.reshape(-1)
    before = stage_channels_last.copies
    for level in (staged.transpose(1, 2), buf[1:].view(2, g, c).transpose(1, 2)):
        assert torch.equal(level_features_cuda(level, *p, *args), got4)
        assert _k5_within_one_ulp(level_features_banded_cuda(level, *p, *args), ref5)
    torch.cuda.synchronize()
    assert stage_channels_last.copies == before

    # K5 on a bf16 level: the staged channels-last copy, read as it is, and a
    # view that is not 8-byte aligned (the scalar path) give K5 on the f32
    # copy of the same values
    staged16 = stage_channels_last(flat.to(torch.bfloat16))
    want16 = level_features_banded_cuda(staged16.float().transpose(1, 2), *p, *args)
    buf16 = torch.empty(2 * g * c + 1, dtype=torch.bfloat16, device=cuda_device)
    buf16[1:] = staged16.reshape(-1)
    before = stage_channels_last.copies
    for level in (staged16.transpose(1, 2), buf16[1:].view(2, g, c).transpose(1, 2)):
        assert torch.equal(level_features_banded_cuda(level, *p, *args), want16)
    assert stage_channels_last.copies == before

    wide = torch.tensor(rng.standard_normal((2, 2 * c, g)).astype(np.float32),
                        device=cuda_device)
    strided = wide[:, ::2]
    assert torch.equal(level_features_cuda(strided, *p, *args),
                       level_features_cuda(strided.contiguous(), *p, *args))
    assert torch.equal(level_features_banded_cuda(strided, *p, *args),
                       level_features_banded_cuda(strided.contiguous(), *p, *args))


@pytest.mark.parametrize("c", [1, 3, 16])
def test_channels_last_staging_on_cpu(c):
    """stage_channels_last on a CPU level: the transpose of a contiguous
    channel-major level (one copy counted, none for C = 1), the level itself
    (a view, no copy) when it already lies channels-last, and the same
    transpose of a level in any other layout.  The K4/K5 wrappers give a
    channels-last CPU level the same features as its channel-major twin."""
    rng = np.random.default_rng(200 + c)
    dims = (5, 6, 7)
    flat = torch.tensor(rng.standard_normal((2, c, 5 * 6 * 7)).astype(np.float32))
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 40)).astype(np.float32)) for _ in range(3)]
    before = stage_channels_last.copies
    staged = stage_channels_last(flat)
    assert stage_channels_last.copies == before + (c > 1)
    assert staged.is_contiguous() and torch.equal(staged, flat.transpose(1, 2))
    level = staged.transpose(1, 2)
    assert stage_channels_last(level).data_ptr() == staged.data_ptr()
    args = (dims, False, 0.0722)
    assert torch.equal(level_features_cuda(level, *p, *args), level_features_cuda(flat, *p, *args))
    assert torch.equal(level_features_banded_cuda(level, *p, *args),
                       level_features_banded_cuda(flat, *p, *args))
    # K5 on a bf16 level: the features of its exact f32 values
    level16 = stage_channels_last(flat.to(torch.bfloat16)).transpose(1, 2)
    assert torch.equal(level_features_banded_cuda(level16, *p, *args),
                       level_features_banded_cuda(flat.to(torch.bfloat16).float(), *p, *args))
    strided = torch.tensor(rng.standard_normal((2, 2 * c, 5 * 6 * 7)).astype(np.float32))[:, ::2]
    cl = stage_channels_last(strided)
    assert cl.is_contiguous() and torch.equal(cl, strided.transpose(1, 2))


@pytest.mark.parametrize("bands", [None, 4])
def test_evaluate_points_stages_the_pyramid_once(bands):
    """evaluate_points' f32 kernel routes, K4's (bands=None) and K6's (bands
    set), stage each level of C > 1 channels-last once a call, not once a
    tile, and give the gather path's values.  On the CPU the wrappers run
    their plain versions."""
    cfg = IFNetConfig.for_net_res(128)
    model = IFNet(cfg, generator=torch.Generator().manual_seed(7)).eval()
    rng = np.random.default_rng(7)
    grid = rng.uniform(0, 1, (1, 17, 16, 18, 1)).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    before = stage_channels_last.copies
    got = evaluate_points(model, grid, pts, tile_points=100, use_kernel=True, bands=bands,
                          compute_dtype=torch.float32)
    with torch.inference_mode():
        flats = model.encode(torch.tensor(grid)).flats
    # a level of one channel or one voxel lies channels-last already
    staged = sum(f.shape[1] > 1 and f.shape[2] > 1 for f in flats)
    assert staged == 4
    assert stage_channels_last.copies == before + staged
    ref = evaluate_points(model, grid, pts, use_kernel=False)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bands", [None, 4])
def test_evaluate_points_stages_the_bf16_pyramid_once(bands):
    """In bf16 both kernel routes stage the pyramid rounded to bf16 and
    channels-last once a call (the C = 1 level needs no copy), and then read
    those views in every tile without another staging copy."""
    model = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(7)).eval()
    rng = np.random.default_rng(8)
    grid = rng.uniform(0, 1, (1, 17, 16, 18, 1)).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    before = stage_channels_last.copies
    got = evaluate_points(model, grid, pts, tile_points=100, use_kernel=True, bands=bands)
    assert stage_channels_last.copies == before + 4
    ref = evaluate_points(model, grid, pts, use_kernel=False)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_sweep_kernel_matches_plain_on_card(net_res, dims, cuda_device):
    """K2 f32 (a float32 plan) vs plain f32 torch: summation order only, atol
    K2_TOL; ragged slabs, a slab past the lattice, the whole lattice."""
    cfg, model, levels = _encoded(net_res, dims, cuda_device)
    r = tuple(2 * d for d in dims)
    with torch.inference_mode():
        plan = SweepPlan(levels, model.mlp, r, cfg.align_corners, cfg.displacement, torch.float32)
        for rows, off in ((2, 0), (5, r[0] - 3), (r[0], 0)):
            before = lattice_sweep_f32_cuda.launches
            got = lattice_sweep(plan, rows, off)
            torch.cuda.synchronize()
            assert lattice_sweep_f32_cuda.launches == before + 1
            ref = lattice_sweep_plain(levels, model.mlp, r, rows, off, cfg.align_corners,
                                      cfg.displacement)
            torch.testing.assert_close(got, ref, atol=K2_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_bf16_sweep_kernel_matches_plain_on_card(net_res, dims, cuda_device):
    """K2 bf16 (a bfloat16 plan) vs plain bf16 torch at atol K2_BF16_TOL on
    logits: ragged slabs, a slab past the lattice, the whole lattice in one
    launch, a batch of two; each point's logit is the same bit for bit in
    whichever slab it comes.  Over the whole lattice the mean error is held
    to K2_BF16_REL_MEAN_TOL of the mean |logit|, a limit that the plain
    sweep without its feature or hidden rounding fails."""
    cfg, model, levels = _encoded(net_res, dims, cuda_device)
    r = tuple(2 * d for d in dims)
    with torch.inference_mode():
        plan = SweepPlan(levels, model.mlp, r, cfg.align_corners, cfg.displacement)
        assert plan.compute_dtype == torch.bfloat16
        # the plan holds the whole lattice's tables (cut per slab by the kernel)
        full = sweep_tables([f.shape[1] for f in levels.flats], list(levels.dims), r, r[0], 0,
                            cfg.align_corners, cfg.displacement)
        for got, want in zip((plan.meta, plan.tap_idx, plan.tap_w), full):
            np.testing.assert_array_equal(got.cpu().numpy(), want)
        whole = lattice_sweep(plan, r[0], 0)
        for rows, off in ((1, 3), (2, 0), (5, r[0] - 3), (r[0], 0)):
            before = lattice_sweep_bf16_cuda.launches
            got = lattice_sweep(plan, rows, off)
            torch.cuda.synchronize()
            assert lattice_sweep_bf16_cuda.launches == before + 1
            ref = lattice_sweep_plain(levels, model.mlp, r, rows, off, cfg.align_corners,
                                      cfg.displacement, torch.bfloat16)
            torch.testing.assert_close(got, ref, atol=K2_BF16_TOL, rtol=0)
            inside = min(rows, r[0] - off)
            assert torch.equal(got[:, :inside], whole[:, off:off + inside])
        smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
        tol = K2_BF16_REL_MEAN_TOL
        assert rel_mean_err(whole, ref) <= tol  # ref: the whole lattice's, last
        for skip in ("feature", "hidden"):
            wrong = smoke["plain_bf16_sweep"](levels, model.mlp, r, r[0], 0, cfg.align_corners,
                                              cfg.displacement, (skip,))
            assert rel_mean_err(wrong, ref) > tol, skip
        both = [(torch.cat([f, f.flip(-1)]), d) for f, d in levels]
        plan2 = SweepPlan(both, model.mlp, r, cfg.align_corners, cfg.displacement)
        got = lattice_sweep(plan2, 3, 4)
        assert torch.equal(got[:1], lattice_sweep(plan, 3, 4))
        torch.testing.assert_close(got, lattice_sweep_plain(
            both, model.mlp, r, 3, 4, cfg.align_corners, cfg.displacement, torch.bfloat16),
            atol=K2_BF16_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_precision16_pyramid_on_card(net_res, dims, cuda_device):
    """A precision-16 IFNet (bf16 convs) on the card: levels 1.. come out
    bf16; K2 bf16 reads them with no second rounding (the same logits, bit
    for bit, as on the pyramid widened to f32) and K2 f32 widens them;
    query_fused's f32 route (K4, then K7/K8 in the backward) widens them at
    its boundary: the same logits and points' gradient as on the widened
    pyramid, the level's gradient back in bf16."""
    from sv3d_tpu_torch.ops.grid_sample import Pyramid

    cfg = IFNetConfig.for_net_res(net_res, fused_query=True)
    model = IFNet(cfg, device=cuda_device, generator=torch.Generator().manual_seed(net_res),
                  dtype=torch.bfloat16).eval()
    grid = torch.tensor(np.random.default_rng(net_res).uniform(0, 1, (1, *dims, 1)),
                        dtype=torch.float32, device=cuda_device)
    with torch.inference_mode():
        levels = model.encode(grid)
        assert [f.dtype for f in levels.flats] == [torch.float32] + [torch.bfloat16] * (
            len(levels) - 1)
        widened = Pyramid([f.float() for f in levels.flats], levels.dims)
        for dtype, counter in ((torch.bfloat16, lattice_sweep_bf16_cuda),
                               (torch.float32, lattice_sweep_f32_cuda)):
            before = counter.launches
            got = model.query_lattice(levels, dims, 1, dims[0], 0, dtype)
            assert counter.launches == before + 1
            assert torch.equal(got, model.query_lattice(widened, dims, 1, dims[0], 0, dtype))
    pts = torch.tensor(np.random.default_rng(1).uniform(-0.45, 0.45, (1, 500, 3)),
                       dtype=torch.float32, device=cuda_device)
    runs = []
    for widen in (False, True):
        lv = model.encode(grid)
        if widen:
            lv = Pyramid([f.detach().float().requires_grad_() for f in lv.flats], lv.dims)
        else:
            for f in lv.flats[1:]:
                f.retain_grad()
        p = pts.clone().requires_grad_()
        before = level_features_cuda.launches
        out = model.query_fused(lv, p)
        assert level_features_cuda.launches == before + len(lv)
        out.square().sum().backward()
        runs.append((out.detach(), p.grad, lv.flats[1].grad))
    (out, gp, gl), (out_w, gp_w, gl_w) = runs
    assert torch.equal(out, out_w)
    torch.testing.assert_close(gp, gp_w, rtol=0, atol=1e-5 * float(gp_w.abs().max()))
    assert gl.dtype == torch.bfloat16 and gl_w.dtype == torch.float32
    assert bool(torch.isfinite(gl.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_plan_makes_no_copy_per_slab(dtype, cuda_device):
    """A sweep's slabs copy nothing from the host and transform no weight:
    torch.profiler sees no host-to-device copy and only the sweep kernel
    (and the output's allocation) during three launches on one plan."""
    from torch.profiler import ProfilerActivity, profile

    cfg, model, levels = _encoded(128, (17, 16, 18), cuda_device)
    r = (17, 16, 18)
    with torch.inference_mode():
        plan = SweepPlan(levels, model.mlp, r, cfg.align_corners, cfg.displacement, dtype)
        lattice_sweep(plan, 1, 0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for off in (0, 5, 16):
                lattice_sweep(plan, 1, off)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "Memcpy" in n or "aten::to" in n or "aten::copy_" in n
                or "aten::t" == n or "contiguous" in n], names
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and "lattice_sweep" in e.key]
    assert kernels and sum(e.count for e in kernels) == 3, names


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c,h", [(1, 256), (3, 256), (16, 512), (64, 256), (128, 256),
                                 (160, 256)])
def test_inference_point_kernels_match_plain_on_card(ac, disp, c, h, cuda_device):
    """K6 against its plain version, alone and adding into a buffer: K6_RTOL
    of the largest plain magnitude (FMA order over 7*C terms); on a staged
    channels-last level the same partial as on the channel-major flat.  K5: at most one
    bf16 ulp, |d| <= K5_ULP |ref| + 1e-6 (the kernel's and the plain f32
    features may round either way of a bf16 boundary), on K4's scalar and
    float4 paths (channel counts as there).  C = 160 takes two channel
    rounds in K6.  Both raise under autograd."""
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
    part = level_fc0_cuda(flat, w0l, *p, *args)
    assert _rel_err(part, ref) <= K6_RTOL
    # K6 f32 reads the level channels-last: a staged view is read as it is
    # and gives the partial that the channel-major flat (staged in the
    # wrapper) gives
    cl = stage_channels_last(flat).transpose(1, 2)
    copies = stage_channels_last.copies
    assert torch.equal(level_fc0_cuda(cl, w0l, *p, *args), part)
    assert stage_channels_last.copies == copies
    acc = torch.randn((2, 333, h), device=cuda_device)
    got = level_fc0_cuda(flat, w0l, *p, *args, out=acc.clone())
    assert _rel_err(got, acc + ref) <= K6_RTOL
    got = level_features_banded_cuda(flat, *p, *args)
    ref = level_features_banded_plain(flat, *p, *args)
    assert got.dtype == torch.bfloat16
    assert _k5_within_one_ulp(got, ref), float((got.float() - ref.float()).abs().max())
    # a bf16 level (the bf16 point query's), channel-major or staged, is read
    # as it is: the features of its exact f32 values
    flat16 = flat.to(torch.bfloat16)
    ref16 = level_features_banded_plain(flat16, *p, *args)
    got16 = level_features_banded_cuda(flat16, *p, *args)
    assert _k5_within_one_ulp(got16, ref16)
    assert torch.equal(level_features_banded_cuda(flat16.float(), *p, *args), got16)
    torch.cuda.synchronize()
    assert [level_fc0_cuda.launches, level_features_banded_cuda.launches] == [
        counts[0] + 3, counts[1] + 3]
    with pytest.raises(NotImplementedError):
        level_fc0_cuda(flat.clone().requires_grad_(), w0l, *p, *args)
    with pytest.raises(NotImplementedError):
        level_features_banded_cuda(flat, p[0].clone().requires_grad_(), *p[1:], *args)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_kernel_matches_plain_on_card(net_res, cuda_device):
    """K3 against its plain version at F 2583 (H0 256) and 2247 (H0 512), N
    not a multiple of the block's points: atol K3_TOL on logits (summation
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
    torch.testing.assert_close(got, fused_point_mlp_plain(f, *weights), atol=K3_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,misaligned", [(1, False), (63, False), (1001, False),
                                          (1000, True), (11648, False)])
@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_kernel_f32_ragged_on_card(net_res, n, misaligned, cuda_device):
    """K3 f32 on a lattice row's features at F 2583 (H0 256) and 2247 (H0
    512): ragged N (a partial tile; N % 4 != 0, and an f that starts 4 bytes
    past a 16-byte boundary, take the 4-byte copies; 11,648 is the full
    row), with and without mlp_operands: one launch a call, bit-identical
    with and without operands, within K3_TOL of the plain f32 version on
    logits."""
    from sv3d_tpu_torch.ops.cuda.mlp import mlp_operands

    f, weights = _k3_inputs(net_res, n, cuda_device, misaligned)
    with torch.inference_mode():
        ops = mlp_operands(weights, torch.float32)
        before = fused_point_mlp.launches
        got = fused_point_mlp(f, *weights, operands=ops)
        again = fused_point_mlp(f, *weights)
        torch.cuda.synchronize()
        assert fused_point_mlp.launches == before + 2
        assert torch.equal(got, again)
        assert got.shape == (n,) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, fused_point_mlp_plain(f, *weights), atol=K3_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_feat,widths", [(77, (40, 100, 200)), (301, (200, 40, 100)),
                                           (1003, (512, 300, 17)), (5, (1, 1, 1))])
def test_mlp_kernel_f32_odd_widths_on_card(n_feat, widths, cuda_device):
    """K3 f32 takes any F and hidden widths up to 512: widths that are no
    multiple of 4 take the 4-byte weight copies and pad in the kernel; 512
    pads every layer to 512 columns.  Within K3_TOL of the plain version on
    logits, at 333 points (a partial tile)."""
    rng = np.random.default_rng(n_feat)
    h0, h1, h2 = widths
    dims = ((h0, n_feat), (h0,), (h1, h0), (h1,), (h2, h1), (h2,), (1, h2), (1,))
    weights = [torch.tensor((rng.standard_normal(d) / np.sqrt(d[-1])).astype(np.float32),
                            device=cuda_device) for d in dims]
    f = torch.tensor(rng.standard_normal((n_feat, 333)).astype(np.float32), device=cuda_device)
    with torch.inference_mode():
        got = fused_point_mlp(f, *weights)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, fused_point_mlp_plain(f, *weights), atol=K3_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res,dims", CASES)
def test_points_and_unfused_sweep_on_card_match_cpu(net_res, dims, cuda_device):
    """evaluate_points on the card in float32 through K6 (bands="auto"), K4
    (bands=None) and the gather path against the CPU's plain run: 1e-5 on
    the sigmoid; in bf16 (the default) through K6 bf16 and K5 against the
    CPU port's bf16 routes (their plain versions): chip_smoke.py's
    POINTS_BF16_CARD_TOL on the sigmoid and POINTS_BF16_REL_MEAN_TOL of the
    mean |logit| on the mean logit difference, a limit that the card's f32
    route and the CPU's bf16 route with its tail in f32 fail
    (points_card_vs_cpu);
    query_lattice(fused_tail=False) through K3 against K2 in the same
    compute dtype: at float32 atol 1e-4 on logits; at bfloat16 (both round
    the levels, features and fc0 to bf16, only K2 its hidden activations)
    atol 2e-3 on the sigmoid (measured 1.8e-4 on the H100)."""
    cfg, cpu_model, _ = _encoded(net_res, dims)
    card = IFNet(cfg, device=cuda_device, generator=torch.Generator().manual_seed(net_res)).eval()
    grid = (np.random.default_rng(1).uniform(0, 1, (1, *dims, 1)) > 0.9).astype(np.float32)
    pts = np.random.default_rng(2).uniform(-0.55, 0.55, (1000, 3)).astype(np.float32)
    ref = evaluate_points(cpu_model, grid, pts, tile_points=384, use_kernel=False)
    f32 = torch.float32
    for kw in (dict(compute_dtype=f32), dict(bands=None, compute_dtype=f32),
               dict(use_kernel=False)):
        got = evaluate_points(card, grid, pts, tile_points=384, **kw)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    res = smoke["points_card_vs_cpu"](card, cpu_model, grid, pts, 384)
    for name, (a, m) in res["routes"].items():
        if "bf16" in name:
            assert a <= smoke["POINTS_BF16_CARD_TOL"], (name, a)
            assert m <= smoke["POINTS_BF16_REL_MEAN_TOL"], (name, m)
        else:
            assert a <= 1e-5, (name, a)
    assert min(res["wrong"].values()) > smoke["POINTS_BF16_REL_MEAN_TOL"], res["wrong"]
    with torch.inference_mode():
        levels = card.encode(torch.tensor(grid, device=cuda_device))
        for dtype in (torch.float32, torch.bfloat16):
            before = fused_point_mlp.launches
            got = card.query_lattice(levels, dims, 2, 3, 5, dtype, fused_tail=False)
            assert fused_point_mlp.launches == before + 1
            k2 = card.query_lattice(levels, dims, 2, 3, 5, dtype)
            if dtype == torch.float32:
                torch.testing.assert_close(got, k2, atol=1e-4, rtol=0)
            else:
                torch.testing.assert_close(torch.sigmoid(got), torch.sigmoid(k2), atol=2e-3,
                                           rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 16, 64, 128, 160])
def test_grad_points_reads_the_saved_channels_last_copy_on_card(c, cuda_device):
    """K7 given a channels-last view of the level (what level_features saves
    when it is given one) reads it as it is (no staging copy) and agrees
    with K7 on the channel-major flat bit for bit, also from a pointer that
    is not 16-byte aligned (the scalar path): K7_RTOL of the plain version's
    largest magnitude.  Through autograd from such a view the backward
    stages nothing."""
    rng = np.random.default_rng(300 + c)
    dims = (19, 13, 14)
    g = 19 * 13 * 14
    flat = torch.tensor(rng.standard_normal((2, c, g)).astype(np.float32), device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    cot = torch.tensor(rng.standard_normal((2, 333, 7 * c)).astype(np.float32),
                       device=cuda_device)
    args = (dims, False, 0.0722)
    ref = level_grad_points_plain(flat, *p, cot, *args)
    got = level_grad_points_cuda(flat, *p, cot, *args)
    assert _rel_err(got, ref) <= K7_RTOL
    staged = stage_channels_last(flat)
    buf = torch.empty(2 * g * c + 1, device=cuda_device)
    buf[1:] = staged.reshape(-1)
    before = stage_channels_last.copies
    for level in (staged.transpose(1, 2), buf[1:].view(2, g, c).transpose(1, 2)):
        assert _rel_err(level_grad_points_cuda(level, *p, cot, *args), ref) <= K7_RTOL
    assert torch.equal(level_grad_points_cuda(staged.transpose(1, 2), *p, cot, *args), got)
    q = [x.clone().requires_grad_() for x in p]
    (level_features(staged.transpose(1, 2), *q, *args) * cot).sum().backward()
    torch.cuda.synchronize()
    assert stage_channels_last.copies == before
    assert _rel_err(torch.stack([x.grad for x in q], -1), ref) <= K7_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c", FEATURE_CHANNELS)
def test_grad_vol_paths_and_layout_on_card(ac, disp, c, cuda_device):
    """K8 against its plain version, both conventions, B = 2, points partly
    outside the volume, K8_RTOL of the largest plain magnitude (atomics in
    run-dependent order), on a small level, a larger one and the 336-voxel
    one of the full-width pyramid (the most contended); the gradient lies
    channels-last, (B, C, G) with strides (G C, 1, C); through autograd it
    reaches a leaf level."""
    rng = np.random.default_rng(400 + c)
    for dims in ((12, 9, 10), (40, 30, 30), (8, 6, 7)):
        gsize = dims[0] * dims[1] * dims[2]
        p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32),
                          device=cuda_device) for _ in range(3)]
        g = torch.tensor(rng.standard_normal((2, 333, 7 * c)).astype(np.float32),
                         device=cuda_device)
        args = (dims, ac, disp)
        ref = level_grad_vol_plain(*p, g, *args)
        before = level_grad_vol_cuda.launches
        got = level_grad_vol_cuda(*p, g, *args)
        torch.cuda.synchronize()
        assert level_grad_vol_cuda.launches == before + 1
        assert got.shape == (2, c, gsize) and got.stride() == (gsize * c, 1, c)
        assert _rel_err(got, ref) <= K8_RTOL, dims
        flat = torch.tensor(rng.standard_normal((2, c, gsize)).astype(np.float32),
                            device=cuda_device).requires_grad_()
        (level_features(flat, *p, *args) * g).sum().backward()
        assert _rel_err(flat.grad, ref) <= K8_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("ac,disp", [(False, 0.0722), (True, 0.035)])
@pytest.mark.parametrize("c,h", [(1, 256), (16, 512), (32, 256), (64, 256), (128, 256),
                                 (128, 512)])
def test_level_fc0_bf16_kernel_matches_plain_on_card(ac, disp, c, h, cuda_device):
    """K6 bf16 against its plain bf16 version (level_fc0_plain(...,
    torch.bfloat16)), alone and adding into a buffer: max |error| within
    K6_BF16_TOL of the largest |partial| and mean |error|
    within K6_BF16_REL_MEAN_TOL of the mean |partial|, a limit that the plain
    version with a rounding point left out fails.  The level as an f32 flat
    (the wrapper rounds and stages it) and as a staged bf16 channels-last
    view (read as it is) give the same partial.  It raises under autograd
    and for channel counts it does not take."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    rng = np.random.default_rng(c + h)
    dims = (19, 13, 14)
    flat = torch.tensor(rng.standard_normal((2, c, 19 * 13 * 14)).astype(np.float32),
                        device=cuda_device)
    w0l = torch.tensor((rng.standard_normal((7 * c, h)) / np.sqrt(7 * c)).astype(np.float32),
                       device=cuda_device)
    p = [torch.tensor(rng.uniform(-1.2, 1.2, (2, 333)).astype(np.float32), device=cuda_device)
         for _ in range(3)]
    args = (dims, ac, disp)
    w0k = fc0_block_bf16(w0l)
    ref = level_fc0_plain(flat, w0l, *p, *args, torch.bfloat16)
    before = level_fc0_bf16_cuda.launches
    got = level_fc0_bf16_cuda(flat, w0k, *p, *args)
    level = stage_channels_last(flat.to(torch.bfloat16)).transpose(1, 2)
    copies = stage_channels_last.copies
    assert torch.equal(level_fc0_bf16_cuda(level, w0k, *p, *args), got)
    assert stage_channels_last.copies == copies
    acc = torch.randn((2, 333, h), device=cuda_device)
    summed = level_fc0_bf16_cuda(level, w0k, *p, *args, out=acc.clone())
    torch.cuda.synchronize()
    assert level_fc0_bf16_cuda.launches == before + 3
    assert torch.equal(got, got.to(torch.bfloat16).float())
    assert _rel_err(got, ref) <= K6_BF16_TOL
    assert rel_mean_err(got, ref) <= K6_BF16_REL_MEAN_TOL
    assert _rel_err(summed - acc, ref) <= K6_BF16_TOL
    for skip in ("level", "feature", "partial"):
        wrong = smoke["plain_bf16_fc0"](flat, w0l, p, *args, skip=(skip,))
        assert rel_mean_err(wrong, ref) > K6_BF16_REL_MEAN_TOL, skip
    with pytest.raises(NotImplementedError):
        level_fc0_bf16_cuda(flat.clone().requires_grad_(), w0k, *p, *args)
    three = torch.zeros((2, 3, 19 * 13 * 14), device=cuda_device)
    with pytest.raises(ValueError):
        level_fc0_bf16_cuda(three, fc0_block_bf16(w0l[:21]), *p, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_kernel_bf16_matches_plain_on_card(net_res, cuda_device):
    """K3 with compute_dtype bfloat16 (the features rounded on load and each
    ReLU output in the kernel, the weights by mlp_operands; fc0-fc2 on the
    tensor cores) against its plain bf16 version:
    atol K3_BF16_TOL on logits (a hidden activation may round
    the other way of a bf16 boundary) and mean |error| within
    K3_BF16_REL_MEAN_TOL of the mean |logit|, a limit that the plain bf16
    decoder with its hidden rounding left out fails."""
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    model = IFNet(IFNetConfig.for_net_res(net_res), device=cuda_device,
                  generator=torch.Generator().manual_seed(net_res)).eval()
    weights = [t.detach() for layer in model.mlp for t in layer]
    f = torch.tensor(np.random.default_rng(net_res).standard_normal(
        (model.feature_size, 1001)).astype(np.float32), device=cuda_device)
    before = fused_point_mlp.launches
    got = fused_point_mlp(f, *weights, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_point_mlp.launches == before + 1
    ref = fused_point_mlp_plain(f, *weights, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got, ref, atol=K3_BF16_TOL, rtol=0)
    assert rel_mean_err(got, ref) <= K3_BF16_REL_MEAN_TOL
    wrong = smoke["plain_bf16_mlp"](f, *weights, skip=("hidden",))
    assert rel_mean_err(wrong, ref) > K3_BF16_REL_MEAN_TOL


def _k3_inputs(net_res, n, device, misaligned=False):
    """IF-Net's decoder weights at net_res and the first n points of one
    lattice row's features (F, n) at the serving dims (139, 104, 112), as
    the unfused sweep hands them to K3: slab_features of a seeded
    occupancy grid's pyramid; misaligned: f starts 4 bytes past a 16-byte
    boundary."""
    dims = (139, 104, 112)
    cfg = IFNetConfig.for_net_res(net_res)
    model = IFNet(cfg, device=device, generator=torch.Generator().manual_seed(net_res)).eval()
    weights = [t.detach() for layer in model.mlp for t in layer]
    grid = (np.random.default_rng(net_res).uniform(0, 1, (1, *dims, 1)) > 0.9).astype(np.float32)
    with torch.inference_mode():
        levels = model.encode(torch.tensor(grid, device=device))
        row = slab_features(levels, dims, 1, 69, cfg.align_corners, cfg.displacement)[0]
        vals = row[:, :n].contiguous()
        if not misaligned:
            return vals, weights
        f = torch.empty(vals.numel() + 1, device=device)[1:].view(vals.shape)
        f.copy_(vals)
    assert f.data_ptr() % 16 == 4 and f.is_contiguous()
    return f, weights


@pytest.mark.cuda
@pytest.mark.parametrize("n,misaligned", [(1, False), (63, False), (1001, False),
                                          (1000, True), (11648, False)])
@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_kernel_bf16_ragged_on_card(net_res, n, misaligned, cuda_device):
    """K3 bf16 on a lattice row's features at F 2583 / 2247 (no multiple of
    16: a zero-padded last chunk) and ragged N (a partial tile; N % 4 != 0
    and a misaligned f take the scalar loads; 11,648 is the full row), with
    and without mlp_operands: one launch a call, bit-identical with and
    without operands, within K3_BF16_TOL of the plain bf16 version and,
    from 1000 points on, within K3_BF16_REL_MEAN_TOL of the mean |logit|."""
    from sv3d_tpu_torch.ops.cuda.mlp import mlp_operands

    f, weights = _k3_inputs(net_res, n, cuda_device, misaligned)
    bf16 = torch.bfloat16
    with torch.inference_mode():
        ops = mlp_operands(weights, bf16)
        before = fused_point_mlp.launches
        got = fused_point_mlp(f, *weights, compute_dtype=bf16, operands=ops)
        again = fused_point_mlp(f, *weights, compute_dtype=bf16)
        torch.cuda.synchronize()
        assert fused_point_mlp.launches == before + 2
        assert torch.equal(got, again)
        ref = fused_point_mlp_plain(f, *weights, compute_dtype=bf16)
        assert got.shape == (n,) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ref, atol=K3_BF16_TOL, rtol=0)
        if n >= 1000:
            assert rel_mean_err(got, ref) <= K3_BF16_REL_MEAN_TOL


@pytest.mark.cuda
def test_mlp_kernel_bf16_runs_one_kernel_on_card(cuda_device):
    """Bf16 fused_point_mlp calls with their operands made run one kernel
    each, K3 bf16's, and no cast or copy of f (chip_smoke.py's
    one_kernel_a_call): in every torch.profiler window of 10 calls nothing
    but that kernel, never more often than fused_point_mlp.launches
    counted, and in one of up to 5 windows exactly as often."""
    from sv3d_tpu_torch.ops.cuda.mlp import mlp_operands

    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"))
    f, weights = _k3_inputs(128, 11648, cuda_device)
    with torch.inference_mode():
        ops = mlp_operands(weights, torch.bfloat16)
        windows = smoke["one_kernel_a_call"](
            lambda: fused_point_mlp(f, *weights, compute_dtype=torch.bfloat16, operands=ops),
            "fused_point_mlp_bf16", lambda: fused_point_mlp.launches, calls=10, tries=5)
    (name, count), = windows[-1][0].items()
    assert "fused_point_mlp_bf16" in name and count == windows[-1][1] == 10, windows


@pytest.mark.cuda
def test_mlp_kernel_bf16_refuses_other_widths_on_card(cuda_device):
    """K3 bf16 on a CUDA tensor raises ValueError for widths other than
    IF-Net's (no other kernel takes them); float32 takes them."""
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.tensor((rng.standard_normal(s) / np.sqrt(s[-1])).astype(np.float32),
                                 device=cuda_device)
    f = mk(40, 100)
    for h0, h1, h2 in ((128, 256, 256), (256, 128, 256), (256, 256, 64)):
        ws = [mk(h0, 40), mk(h0), mk(h1, h0), mk(h1), mk(h2, h1), mk(h2), mk(1, h2), mk(1)]
        with torch.inference_mode():
            with pytest.raises(ValueError, match="hidden widths"):
                fused_point_mlp(f, *ws, compute_dtype=torch.bfloat16)
            got = fused_point_mlp(f, *ws)
        torch.testing.assert_close(got, fused_point_mlp_plain(f, *ws), atol=K3_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unfused_sweep_makes_operands_once_on_card(dtype, cuda_device, monkeypatch):
    """query_lattice(fused_tail=False) on a batch of two makes K3's operands
    once and launches K3 once per batch element."""
    import sv3d_tpu_torch.models.ifnet as ifnet_module

    made = []
    real = ifnet_module.mlp_operands
    monkeypatch.setattr(ifnet_module, "mlp_operands",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    dims = (12, 9, 10)
    cfg = IFNetConfig.for_net_res(32)
    model = IFNet(cfg, device=cuda_device, generator=torch.Generator().manual_seed(3)).eval()
    grid = np.random.default_rng(3).uniform(0, 1, (2, *dims, 1)).astype(np.float32)
    with torch.inference_mode():
        levels = model.encode(torch.tensor(grid, device=cuda_device))
        before = fused_point_mlp.launches
        got = model.query_lattice(levels, dims, 1, 2, 4, dtype, fused_tail=False)
        torch.cuda.synchronize()
    assert len(made) == 1 and fused_point_mlp.launches == before + 2
    assert got.shape == (2, 2, 9, 10) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stale_plan_raises_on_card(dtype, cuda_device):
    """A plan on CUDA levels refuses another pyramid and weights changed in
    place after it was made; it keeps sweeping its own copies; a fresh plan
    sweeps the new weights."""
    cfg, model, levels = _encoded(32, (12, 9, 10), cuda_device)
    r = (12, 9, 10)
    with torch.inference_mode():
        plan = model.sweep_plan(levels, r, 1, dtype)
        before = model.query_lattice(levels, r, 1, 12, 0, dtype, plan=plan)
        other = model.encode(torch.zeros((1, *r, 1), device=cuda_device))
        with pytest.raises(ValueError, match="stale"):
            model.query_lattice(other, r, 1, 12, 0, dtype, plan=plan)
    with torch.no_grad():
        model.fc1.weight.mul_(1.5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="stale"):
            model.query_lattice(levels, r, 1, 12, 0, dtype, plan=plan)
        assert torch.equal(lattice_sweep(plan, 12, 0), before)
        fresh = model.query_lattice(levels, r, 1, 12, 0, dtype)
        want = lattice_sweep_plain(levels, model.mlp, r, 12, 0, cfg.align_corners,
                                   cfg.displacement, dtype)
    torch.testing.assert_close(fresh, want, atol=K2_BF16_TOL, rtol=0)
    assert not torch.equal(fresh, before)


class _PlainLevelFeatures(torch.autograd.Function):
    """level_features with the plain versions of K4, K8 and K7."""

    @staticmethod
    def forward(ctx, flat, p0, p1, p2, dims, align_corners, displacement):
        ctx.save_for_backward(flat, p0, p1, p2)
        ctx.args = (dims, align_corners, displacement)
        return level_features_plain(flat, p0, p1, p2, dims, align_corners, displacement)

    @staticmethod
    def backward(ctx, g):
        flat, p0, p1, p2 = ctx.saved_tensors
        g = g.contiguous()
        gvol = level_grad_vol_plain(p0, p1, p2, g, *ctx.args)
        gp = (None, None, None)
        if any(ctx.needs_input_grad[1:4]):
            gpts = level_grad_points_plain(flat, p0, p1, p2, g, *ctx.args)
            gp = tuple(gpts[..., i] for i in range(3))
        return (gvol, *gp, None, None, None)


@pytest.mark.cuda
def test_ifnet_only_train_step_kernels_match_plain_on_card(cuda_device, monkeypatch):
    """One IF-Net-only train step at the trainer's default shape (net_res 128,
    full dims, B=16 x 4096 points, fused_query, cuDNN deterministic) through
    K4 forward and K8 backward, against the same step with the plain
    versions of the three, each in f32, and both against the plain step in
    float64: the losses at 1e-6 of it; the kernels' gradients within 1e-5
    of the exact ones, relative to each tensor's largest magnitude, or no
    further from them than twice the plain f32 step.  (The first convs'
    weight gradients sum 26M products of a BatchNorm backward over a nearly
    constant sparse grid: there the f32 step itself is ill-conditioned.)
    The step asks no gradient of its points (data) nor of level 0 (the input
    grid): K4 runs on 6 levels, K8 on 5, K7 never."""
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.ops.cuda import point_query as pq
    from sv3d_tpu_torch.training.optim import build_optimizer
    from sv3d_tpu_torch.training.state import TrainState
    from sv3d_tpu_torch.training.trainer_ifnet import train_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(seed=0, fused_query=True)
    rng = np.random.default_rng(0)
    b, n = 16, 4096
    batch = {
        "input": (rng.random((b, *cfg.dims, 1)) < 0.005).astype(np.float32),
        "points": rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32),
        "occupancies": (rng.random((b, n)) < 0.4).astype(np.float32),
    }
    counters = (level_features_cuda, level_grad_vol_cuda, level_grad_points_cuda)

    def step(dtype=torch.float32):
        model = IFNet(cfg.ifnet(), device=cuda_device, generator=torch.Generator().manual_seed(0))
        model.to(dtype)
        state = TrainState(model, build_optimizer(cfg.lr, model))
        for fn in counters:
            fn.launches = 0
        loss = float(train_step(state, {k: torch.tensor(v, dtype=dtype, device=cuda_device)
                                        for k, v in batch.items()})["train_ce_loss"])
        torch.cuda.synchronize()
        grads = {k: p.grad.detach().double() for k, p in model.named_parameters()}
        return loss, grads, [fn.launches for fn in counters]

    loss, grads, launched = step()
    assert launched == [6, 5, 0]
    monkeypatch.setattr(pq, "_LevelFeatures", _PlainLevelFeatures)
    plain_loss, plain, launched = step()
    exact_loss, exact, _ = step(torch.float64)
    assert launched == [0, 0, 0]
    for got in (loss, plain_loss):
        assert np.isfinite(got) and abs(got - exact_loss) <= 1e-6 * abs(exact_loss)
    errs = {k: (_rel_err(grads[k], e), _rel_err(plain[k], e), _rel_err(grads[k], plain[k]))
            for k, e in exact.items()}
    print("kernels vs float64, plain vs float64, kernels vs plain (fraction of the largest "
          "|gradient|):", {k: tuple(f"{x:.2e}" for x in v) for k, v in errs.items()})
    for k, (err, plain_err, _) in errs.items():
        assert err <= max(1e-5, 2.0 * plain_err), (k, err, plain_err)


@pytest.mark.cuda
def test_synced_batchnorm_on_card(cuda_device, tmp_path):
    """BatchNorm's statistics all-reduced over 2 ranks that share the card
    (gloo, which all-reduces CUDA tensors; NCCL refuses two ranks on one
    GPU), in float64: each rank's outputs and input gradients, the summed
    parameter gradients and the running statistics equal to the unsynced
    module's on the whole batch, on the card, at 1e-12
    (tests/torch_parallel_workers.py, no JAX)."""
    import torch_parallel_workers as workers

    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (4, 16, 9, 8, 7))
    cot = rng.normal(size=x.shape)
    whole = workers.batchnorm(x, cot, dp=1, device="cuda")
    ranks = [r["bn"] for r in workers.spawn(2, tmp_path, [
        ("bn", "batchnorm", dict(x=x, cotangent=cot, dp=2, device="cuda"))])]
    tol = dict(rtol=1e-12, atol=1e-12)
    for i, r in enumerate(ranks):
        rows = slice(2 * i, 2 * i + 2)
        torch.testing.assert_close(r["out"], whole["out"][rows], **tol)
        torch.testing.assert_close(r["x_grad"], whole["x_grad"][rows], **tol)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(r[k], whole[k], **tol)
    for k in ("weight_grad", "bias_grad"):
        torch.testing.assert_close(ranks[0][k] + ranks[1][k], whole[k], **tol)
