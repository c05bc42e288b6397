"""Port parity: arbitrary-point inference of sv3d_tpu_torch against sv3d_tpu
on the CPU.

The plain versions of kernels K6 (level_fc0), K5 (level_features_banded) and
K3 (fused_point_mlp) against the JAX package's exact math (1e-5) and against
its Pallas kernels in interpret mode (its own bf16 bounds, 2e-2; K6's and
K3's bf16 modes, the JAX kernels' class, at the tighter bounds measured
here); IFNet.query_lattice(fused_tail=False) and evaluate_points against
JAX's, in f32 and in bf16; evaluate_points on no points; the inference-only
kernels raise under autograd.  The JAX Pallas kernels run at
the tiny dims of its own kernel tests, (19, 13, 14), (17, 16, 18) and
(10, 9, 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import IFNetConfig as JIFNetConfig
from sv3d_tpu.inference.dense_grid import evaluate_points as j_evaluate_points
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.ops.grid_sample import displacement_axes as j_displacement_axes
from sv3d_tpu.ops.grid_sample import sample_trilinear_flat as j_sample
from sv3d_tpu.ops.pallas.mlp import fused_point_mlp as j_fused_point_mlp
from sv3d_tpu.ops.pallas.point_query import (
    bucket_queries_2d,
    level_fc0_banded,
    level_features_banded,
)
from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.inference.dense_grid import evaluate_points
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp
from sv3d_tpu_torch.ops.cuda.point_query import (
    fc0_block_bf16,
    level_fc0_bf16_cuda,
    level_fc0_cuda,
    level_features_banded_cuda,
    stage_channels_last,
)
from sv3d_tpu_torch.ops.grid_sample import Pyramid
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain
from sv3d_tpu_torch.ops.point_query import level_fc0_plain, level_features_banded_plain
from test_torch_unet import randomized

torch.set_num_threads(1)

DIMS = (19, 13, 14)
CONVENTIONS = [(False, 0.0722), (True, 0.035)]  # net_res 128 and 32


def _level(c, seed):
    """A seeded (2, *DIMS, C) channels-last volume, its port flat (2, C, G)
    and 200 points per sample in [-1.3, 1.3] (some outside the volume)."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((2, *DIMS, c)).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (2, 200, 3)).astype(np.float32)
    flat = torch.tensor(np.moveaxis(vol, -1, 1).reshape(2, c, -1).copy())
    return vol, pts, flat, [torch.tensor(pts[..., i]) for i in range(3)]


def _jax_features(vol, pts, ac, disp):
    """JAX's exact gather features, displacement-major: (B, N, 7*C)."""
    b, n, c = pts.shape[0], pts.shape[1], vol.shape[-1]
    flat = jnp.asarray(np.moveaxis(vol, -1, 1).reshape(b, c, -1))
    pd = j_displacement_axes(tuple(jnp.asarray(pts[..., i]) for i in range(3)), disp)
    f = np.asarray(j_sample(flat, vol.shape[1:4], pd, align_corners=ac))  # (B, C, 7N)
    return f.reshape(b, c, 7, n).transpose(0, 3, 2, 1).reshape(b, n, 7 * c)


def _unbucket(out, pos):
    return np.take_along_axis(np.asarray(out, np.float32), np.asarray(pos)[..., None], axis=1)


def _bucketed(pts, ac, bands=4):
    p = [jnp.asarray(pts[..., i]) for i in range(3)]
    return bucket_queries_2d(*p, DIMS[0], DIMS[1], ac, bands)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("ac,disp", CONVENTIONS)
@pytest.mark.parametrize("c", [1, 16])
def test_level_fc0_plain_matches_jax_exact(ac, disp, c):
    """K6's plain version against JAX's exact gather features times the
    level's fc0 block, f32: 1e-5 of the largest |partial|."""
    vol, pts, flat, p = _level(c, c)
    w0l = np.random.default_rng(5).standard_normal((7 * c, 32)).astype(np.float32)
    ref = _jax_features(vol, pts, ac, disp) @ w0l
    got = level_fc0_plain(flat, torch.tensor(w0l), *p, DIMS, ac, disp).numpy()
    assert got.shape == (2, 200, 32)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("ac,disp", CONVENTIONS)
def test_level_fc0_plain_matches_jax_banded_kernel(ac, disp):
    """K6's plain version against JAX's level_fc0_banded (interpret mode,
    bf16 with f32 accumulation) after 2-D bucketing, un-bucketed: 2e-2 of the
    largest |partial| (JAX's bf16 class)."""
    c, h = 16, 128
    vol, pts, flat, p = _level(c, 3)
    w0l = (np.random.default_rng(6).standard_normal((7 * c, h)) / np.sqrt(7 * c)).astype(
        np.float32)
    q0, q1, q2, pos, tile_slab, tile_band, tile_used = _bucketed(pts, ac)
    out = level_fc0_banded(jnp.asarray(vol), jnp.asarray(w0l, jnp.bfloat16), q0, q1, q2,
                           tile_slab, tile_band, tile_used, DIMS, DIMS[0], DIMS[1], ac, disp,
                           4, interpret=True)
    ref = _unbucket(out, pos)
    got = level_fc0_plain(flat, torch.tensor(w0l), *p, DIMS, ac, disp).numpy()
    assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("ac,disp", CONVENTIONS)
def test_level_fc0_bf16_plain_matches_jax_banded_kernel(ac, disp):
    """K6's plain version in bf16 (compute_dtype=torch.bfloat16: the level,
    each feature, the block and the partial rounded to bf16) against JAX's
    level_fc0_banded in interpret mode, un-bucketed: 1e-2 of the largest
    |partial| (measured 6.3e-3; the JAX kernel also rounds its axis-0/1 hat
    weights and the pencil to bf16).  The wrapper's CPU route is the plain
    version on fc0_block_bf16's operand."""
    c, h = 16, 128
    vol, pts, flat, p = _level(c, 3)
    w0l = (np.random.default_rng(6).standard_normal((7 * c, h)) / np.sqrt(7 * c)).astype(
        np.float32)
    q0, q1, q2, pos, tile_slab, tile_band, tile_used = _bucketed(pts, ac)
    out = level_fc0_banded(jnp.asarray(vol), jnp.asarray(w0l, jnp.bfloat16), q0, q1, q2,
                           tile_slab, tile_band, tile_used, DIMS, DIMS[0], DIMS[1], ac, disp,
                           4, interpret=True)
    ref = _unbucket(out, pos)
    got = level_fc0_plain(flat, torch.tensor(w0l), *p, DIMS, ac, disp, torch.bfloat16)
    assert _rel(got.numpy(), ref) <= 1e-2
    # every partial is a bf16 value
    assert torch.equal(got, got.to(torch.bfloat16).float())
    before = level_fc0_bf16_cuda.launches
    w0k = fc0_block_bf16(torch.tensor(w0l))
    assert w0k.dtype == torch.bfloat16 and w0k.shape == (7 * c, h)
    assert torch.equal(level_fc0_bf16_cuda(flat, w0k, *p, DIMS, ac, disp), got)
    acc = torch.ones((2, 200, h))
    assert torch.equal(level_fc0_bf16_cuda(flat, w0k, *p, DIMS, ac, disp, out=acc), got + 1.0)
    assert level_fc0_bf16_cuda.launches == before


@pytest.mark.parametrize("ac,disp", CONVENTIONS)
def test_level_features_banded_plain_matches_jax_kernel(ac, disp):
    """K5's plain version against JAX's level_features_banded (interpret
    mode), un-bucketed: 2e-2 relative to max(|ref|, 1), the bf16 class of
    tests/test_pallas_query.py; and exactly K4's features rounded to bf16."""
    vol, pts, flat, p = _level(16, 4)
    q0, q1, q2, pos, tile_slab, tile_band, tile_used = _bucketed(pts, ac)
    out = level_features_banded(jnp.asarray(vol), q0, q1, q2, tile_slab, tile_band, tile_used,
                                DIMS, DIMS[0], DIMS[1], ac, disp, 4, interpret=True)
    ref = _unbucket(out, pos)
    got = level_features_banded_plain(flat, *p, DIMS, ac, disp)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max() <= 2e-2
    exact = _jax_features(vol, pts, ac, disp)
    np.testing.assert_array_equal(
        got, torch.tensor(exact).to(torch.bfloat16).float().numpy())


def _mlp_weights(n_feat, h0, seed):
    rng = np.random.default_rng(seed)
    shapes = [(h0, n_feat), (h0,), (256, h0), (256,), (256, 256), (256,), (1, 256), (1,)]
    scales = [0.02, 0.1, 0.05, 0.1, 0.05, 0.1, 0.05, 0.1]
    return [(rng.standard_normal(s) * k).astype(np.float32) for s, k in zip(shapes, scales)]


@pytest.mark.parametrize("n_feat,h0", [(2583, 256), (2247, 512)])
def test_fused_point_mlp_plain_matches_jax_kernel(n_feat, h0):
    """K3's plain version against JAX's fused_point_mlp (interpret mode, bf16
    operands): rtol and atol 2e-2 (tests/test_pallas.py); against the chain
    in f32 numpy: 1e-5."""
    ws = _mlp_weights(n_feat, h0, n_feat)
    f = np.random.default_rng(1).standard_normal((n_feat, 1024)).astype(np.float32)
    got = fused_point_mlp_plain(torch.tensor(f), *map(torch.tensor, ws)).numpy()
    assert got.shape == (1024,)
    ref = np.asarray(j_fused_point_mlp(jnp.asarray(f), *map(jnp.asarray, ws), tile=1024,
                                       interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    h = f
    for i in range(4):
        h = ws[2 * i] @ h + ws[2 * i + 1][:, None]
        h = np.maximum(h, 0.0) if i < 3 else h
    np.testing.assert_allclose(got, h[0], rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    before = fused_point_mlp.launches
    np.testing.assert_array_equal(
        fused_point_mlp(torch.tensor(f), *map(torch.tensor, ws)).numpy(), got)
    assert fused_point_mlp.launches == before


@pytest.mark.parametrize("n_feat,h0", [(2583, 256), (2247, 512)])
def test_fused_point_mlp_bf16_plain_matches_jax_kernel(n_feat, h0):
    """K3's plain version in bf16 (the features, the weights and each ReLU
    output rounded to bf16, as JAX's fused_point_mlp rounds them) against
    JAX's kernel in interpret mode: atol 2e-3 on logits up to ~0.8 (measured
    9.0e-4; the f32 version is 4.8e-3 off); the wrapper's CPU route is the
    plain version."""
    ws = _mlp_weights(n_feat, h0, n_feat)
    f = np.random.default_rng(1).standard_normal((n_feat, 1024)).astype(np.float32)
    ref = np.asarray(j_fused_point_mlp(jnp.asarray(f), *map(jnp.asarray, ws), tile=1024,
                                       interpret=True))
    args = (torch.tensor(f), *map(torch.tensor, ws))
    got = fused_point_mlp_plain(*args, compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    before = fused_point_mlp.launches
    np.testing.assert_array_equal(
        fused_point_mlp(*args, compute_dtype=torch.bfloat16).numpy(), got)
    assert fused_point_mlp.launches == before


def _models(net_res, dims, seed=0):
    cfg = JIFNetConfig.for_net_res(net_res)
    grid = (np.random.default_rng(seed).uniform(0, 1, (1, *dims, 1)) > 0.9).astype(np.float32)
    jm = JIFNet(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(grid), jnp.zeros((1, 8, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(seed)), 7)
    tm = IFNet(IFNetConfig.for_net_res(net_res))
    tm.load_state_dict(from_flax(variables))
    return grid, jm, variables, tm.eval()


@pytest.mark.parametrize("net_res,dims", [(128, (17, 16, 18)), (32, (12, 9, 10))])
def test_query_lattice_unfused_matches_jax_and_the_fused_sweep(net_res, dims):
    """query_lattice(fused_tail=False) at compute_dtype float32 on JAX's own
    levels against JAX's unfused f32 sweep without its MLP kernel, and
    against the port's fused sweep (K2's plain version) at float32 on the
    same slab: 1e-5 of the largest |logit|; a batch of two against K2 on the
    same batch.
    Slabs: interior, and the last slab of 3 rows (past the lattice end at
    net_res 128), at offsets that are multiples of the slab size, as the
    sweep issues them.  The two net_res cover both align_corners
    conventions."""
    grid, jm, variables, tm = _models(net_res, dims)
    jlev = jm.apply(variables, jnp.asarray(grid), train=False, method=JIFNet.encode)
    tlev = Pyramid([torch.tensor(np.asarray(f)) for f in jlev.flats], jlev.dims)
    for rows, off in ((2, 4), (3, (-(-dims[0] // 3) - 1) * 3)):
        ref = np.asarray(jax.jit(lambda v, lv, o, rows=rows: jm.apply(
            v, lv, dims, 1, rows, o, method=JIFNet.query_lattice, compute_dtype=jnp.float32,
            fused_tail=False, use_pallas_mlp=False))(variables, jlev, jnp.asarray(off)))
        f32 = torch.float32
        with torch.inference_mode():
            got = tm.query_lattice(tlev, dims, 1, rows, off, f32, fused_tail=False).numpy()
            k2 = tm.query_lattice(tlev, dims, 1, rows, off, f32).numpy()
            # a batch of two runs the decoder once per element
            both = Pyramid([torch.cat([f, f.flip(-1)]) for f in tlev.flats], tlev.dims)
            got2 = tm.query_lattice(both, dims, 1, rows, off, f32, fused_tail=False).numpy()
            k2_2 = tm.query_lattice(both, dims, 1, rows, off, f32).numpy()
        scale = max(1.0, np.abs(ref).max())
        assert got.shape == ref.shape == (1, rows, dims[1], dims[2])
        np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(got, k2, atol=1e-5 * scale, rtol=0)
        np.testing.assert_array_equal(got2[:1], got)
        np.testing.assert_allclose(got2, k2_2, atol=1e-5 * max(1.0, np.abs(k2_2).max()), rtol=0)


@pytest.mark.parametrize("net_res,dims", [(32, (10, 9, 8)), (128, (17, 16, 18))])
def test_evaluate_points_matches_jax(net_res, dims):
    """The port's three routes -- the gather path (use_kernel=False), K4's
    (bands=None) and K6's (bands=4) plain versions -- against JAX's exact
    gather path: 1e-5 on the sigmoid; against JAX's bf16 banded kernel in
    interpret mode: rtol 5e-2, atol 1e-2 (tests/test_inference.py).  Tiles
    that do not divide M, and a tile larger than M."""
    grid, jm, variables, tm = _models(net_res, dims, seed=1)
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    exact = j_evaluate_points(jm, variables, jnp.asarray(grid), pts, tile_points=128,
                              use_pallas=False)
    banded = j_evaluate_points(jm, variables, jnp.asarray(grid), pts, tile_points=300,
                               use_pallas=True, bands=4)
    f32 = torch.float32
    for tile in (128, 1000):
        for kw in (dict(use_kernel=False), dict(use_kernel=True, bands=None, compute_dtype=f32),
                   dict(use_kernel=True, bands=4, compute_dtype=f32)):
            got = evaluate_points(tm, torch.tensor(grid), pts, tile_points=tile, **kw)
            assert got.shape == (300,) and got.dtype == np.float32
            np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0, err_msg=f"{tile} {kw}")
            np.testing.assert_allclose(got, banded, rtol=5e-2, atol=1e-2)
    # CPU default: the gather path
    np.testing.assert_array_equal(evaluate_points(tm, grid, pts, tile_points=128),
                                  evaluate_points(tm, grid, pts, 128, use_kernel=False))


@pytest.mark.parametrize("net_res,dims", [(32, (10, 9, 8)), (128, (17, 16, 18))])
def test_evaluate_points_f32_banded_stages_the_pyramid_once(net_res, dims):
    """The f32 bands="auto" route (K6 f32; its plain version on the CPU)
    stages each level of C > 1 channels-last once a call, not once a tile,
    because K6 f32 reads its level channels-last; its sigmoid stays within
    1e-5 of JAX's exact evaluate_points and of the port's gather path."""
    grid, jm, variables, tm = _models(net_res, dims, seed=6)
    pts = np.random.default_rng(6).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    exact = j_evaluate_points(jm, variables, jnp.asarray(grid), pts, tile_points=128,
                              use_pallas=False)
    with torch.inference_mode():
        flats = tm.encode(torch.tensor(grid)).flats
    # a level of one channel or one voxel lies channels-last already
    staged = sum(f.shape[1] > 1 and f.shape[2] > 1 for f in flats)
    assert staged >= 3
    before = stage_channels_last.copies
    got = evaluate_points(tm, grid, pts, tile_points=100, use_kernel=True, bands="auto",
                          compute_dtype=torch.float32)
    assert stage_channels_last.copies == before + staged
    assert got.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, exact, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, evaluate_points(tm, grid, pts, use_kernel=False),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("bands", [4, None])
@pytest.mark.parametrize("net_res,dims", [(32, (10, 9, 8)), (128, (17, 16, 18))])
def test_evaluate_points_bf16_matches_jax(net_res, dims, bands):
    """The port's bf16 kernel routes (the default compute_dtype: K6 bf16 for
    bands=4, K5 and a bf16 matmul for bands=None, their plain versions on the
    CPU) against JAX's evaluate_points(use_pallas=True) with the same bands
    (its Pallas kernels in interpret mode): 1e-3 on the sigmoid (measured up
    to 3.6e-4; JAX's own bf16 routes are 4.6e-4 from its exact path).  Both
    port routes stay within 1e-3 of the exact gather path too."""
    grid, jm, variables, tm = _models(net_res, dims, seed=1)
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    ref = j_evaluate_points(jm, variables, jnp.asarray(grid), pts, tile_points=300,
                            use_pallas=True, bands=bands)
    exact = evaluate_points(tm, grid, pts, use_kernel=False)
    got = evaluate_points(tm, torch.tensor(grid), pts, tile_points=128, use_kernel=True,
                          bands=bands)
    assert got.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, exact, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got, evaluate_points(
        tm, grid, pts, tile_points=128, use_kernel=True, bands=bands,
        compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("kw", [dict(use_kernel=False), dict(bands=None),
                                dict(bands=4), dict(bands=None, compute_dtype=torch.float32),
                                dict(bands=4, compute_dtype=torch.float32)],
                         ids=["gather", "K5-bf16", "K6-bf16", "K4-f32", "K6-f32"])
def test_evaluate_points_on_no_points(kw):
    """M = 0 gives an empty (0,) float32 array on every route, as JAX's
    evaluate_points does (its map over zero tiles)."""
    grid, _, _, tm = _models(32, (10, 9, 8), seed=5)
    kw = dict(use_kernel=True, **kw) if "use_kernel" not in kw else kw
    for pts in (np.zeros((0, 3), np.float32), []):
        got = evaluate_points(tm, grid, pts, **kw)
        assert got.shape == (0,) and got.dtype == np.float32


def test_inference_only_kernels_raise_under_autograd():
    """bands= (K6) and K5 raise NotImplementedError under autograd, never a
    silent zero gradient; bands=None keeps K4's gradient; under
    inference_mode bands=4 runs and matches bands=None."""
    grid, _, _, tm = _models(32, (10, 9, 8), seed=3)
    pts = torch.tensor(np.random.default_rng(4).uniform(-0.45, 0.45, (1, 50, 3)),
                       dtype=torch.float32)
    levels = tm.encode(torch.tensor(grid))
    with pytest.raises(NotImplementedError, match="bands=None"):
        tm.query_fused(levels, pts, bands=4).sum().backward()
    flat, dims = levels.flats[1], levels.dims[1]
    p = [pts[..., i].contiguous() for i in range(3)]
    with pytest.raises(NotImplementedError, match="bands=None"):
        level_features_banded_cuda(flat, *p, dims, True, 0.035)
    with pytest.raises(NotImplementedError, match="bands=None"):
        level_fc0_cuda(flat.detach(), tm.fc0_blocks()[1], *p, dims, True, 0.035)
    with pytest.raises(NotImplementedError, match="bands=None"):
        level_fc0_bf16_cuda(flat.detach(), tm.fc0_blocks()[1], *p, dims, True, 0.035)
    for bands in (4, None):
        with pytest.raises(NotImplementedError, match="bands=None"):
            tm.query_fused(levels, pts, bands, compute_dtype=torch.bfloat16)
    q = pts.clone().requires_grad_()
    tm.query_fused(levels, q).sum().backward()
    assert q.grad is not None and float(q.grad.abs().sum()) > 0
    with torch.inference_mode():
        np.testing.assert_allclose(tm.query_fused(levels, pts, bands=4).numpy(),
                                   tm.query_fused(levels, pts).numpy(), atol=1e-5)
