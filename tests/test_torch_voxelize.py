"""Port parity: the voxelization and Projection of sv3d_tpu_torch against
sv3d_tpu.

The plain torch scatter sums the same f32 weights as the JAX scatter in
another order; atol 2e-6 is the JAX package's own bound between its XLA
scatter and its Pallas kernel (tests/test_pallas_voxelize.py).  Smoothing is
three f32 contractions on both sides: atol 1e-6."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import ProjectionConfig
from sv3d_tpu.models.projection import Projection as JProjection
from sv3d_tpu.ops.voxelize import gaussian_kernels_1d as j_kernels
from sv3d_tpu.ops.voxelize import scatter_voxels as j_scatter
from sv3d_tpu.ops.voxelize import smooth_voxels as j_smooth
from sv3d_tpu.ops.pallas.voxelize import scatter_voxels_pallas
from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.models.projection import Projection
# the module: sv3d_tpu_torch.ops exports the function voxelize under its
# name, as sv3d_tpu.ops does
tv = importlib.import_module("sv3d_tpu_torch.ops.voxelize")
from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_cuda
from sv3d_tpu_torch.quality import box_scene

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
DIMS = (19, 13, 14)


def test_scatter_matches_jax_and_pallas_including_border_drops():
    pts = RNG.uniform(-0.7, 0.7, (2, 3000, 3)).astype(np.float32)
    got = tv.scatter_voxels(torch.tensor(pts), DIMS).numpy()
    ref = np.asarray(j_scatter(jnp.asarray(pts), DIMS))
    pallas = np.asarray(scatter_voxels_pallas(jnp.asarray(pts), DIMS, interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(got, pallas, atol=2e-6)


def test_cpu_tensor_takes_the_plain_scatter():
    pts = torch.tensor(RNG.uniform(-0.5, 0.5, (1, 500, 3)).astype(np.float32))
    before = scatter_voxels_cuda.launches
    np.testing.assert_array_equal(
        scatter_voxels_cuda(pts, DIMS).numpy(), tv.scatter_voxels(pts, DIMS).numpy()
    )
    assert scatter_voxels_cuda.launches == before


def test_smoothing_and_projection_module():
    vox = RNG.uniform(0.0, 1.2, (2, *DIMS)).astype(np.float32)
    sigma = np.asarray([1.1, 1.5, 2.3], np.float32)
    ref = np.asarray(j_smooth(
        jnp.asarray(vox), j_kernels(jnp.asarray(sigma), (3, 3, 3))))
    got = tv.smooth_voxels(
        torch.tensor(vox), tv.gaussian_kernels_1d(torch.tensor(sigma), (3, 3, 3))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)

    cfg = ProjectionConfig(dims=DIMS, init_sigma=(1.5,))
    pts = RNG.uniform(-0.55, 0.55, (1, 2000, 3)).astype(np.float32)
    jm = JProjection(cfg, use_pallas=False)
    init = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts))
    assert set(init["params"]) == {"sigma"}
    variables = {"params": {"sigma": np.asarray([1.2, 1.7, 2.0], np.float32)}}
    ref = np.asarray(jm.apply(variables, jnp.asarray(pts)))
    tm = Projection(cfg)
    tm.load_state_dict(from_flax(variables))
    with torch.inference_mode():
        got = tm(torch.tensor(pts)).numpy()
    assert got.shape == (1, *DIMS, 1)
    np.testing.assert_allclose(got, ref, atol=1e-6)


# d - 1 a power of two on every axis: a point at k / (d - 1) - 0.5 sits
# exactly on a voxel in f32, with weight exactly 1 there and 0 at the other
# corners
NODE_DIMS = (17, 9, 17)


def _clamp_edge_points(rng):
    """(2, N, 3) points whose raw grid is exactly 0 at corners they touch
    with weight 0, exactly 1 at a lone voxel point, 2 at a doubled one, and
    above 1 at coincident clusters, besides sparse uniform points (some
    dropped at the border) that leave most of their voxels inside (0, 1).
    Along axis 0 the uniform points stay below voxel 10, the voxel points
    sit at 10 and the clusters above 11, so that none adds to another's
    voxels."""
    steps = np.asarray(NODE_DIMS, np.float64) - 1.0
    nodes = np.array([[10, 3, 5], [10, 6, 12], [10, 2, 3], [10, 5, 8]]) / steps - 0.5
    cluster = np.concatenate([rng.uniform(0.3, 0.4, (5, 1)), rng.uniform(-0.4, 0.4, (5, 2))], 1)
    out = []
    for _ in range(2):
        uniform = rng.uniform(-0.55, 0.55, (300, 3))
        uniform[:, 0] = rng.uniform(-0.55, 0.0, 300)
        out.append(np.concatenate([
            uniform, np.repeat(cluster, 20, axis=0),
            nodes, nodes[-1:],  # the last voxel point twice: raw 2 there
        ]))
    return np.stack(out).astype(np.float32)


def test_scatter_backward_takes_the_clamped_or_the_raw_grid():
    """scatter_voxels_bwd's mask is 0 < x < 1 on the grid it is given, which
    holds at the same voxels for the raw and the clamped grid: the two give
    the same gradient, and both equal JAX's custom VJP of
    scatter_voxels_pallas (interpret mode) at 1e-5 of the largest
    component.  The points put raw at exactly 0 and 1 and above 1."""
    pts = _clamp_edge_points(np.random.default_rng(5))
    g = np.random.default_rng(6).standard_normal((2, *NODE_DIMS)).astype(np.float32)
    p = torch.tensor(pts)
    raw = tv.scatter_voxels_raw(p, NODE_DIMS)
    node = tuple(int(round(v)) for v in (pts[0, -1] + 0.5) * (np.asarray(NODE_DIMS) - 1.0))
    assert float(raw[0][node]) == 2.0
    assert float(raw[0][tuple(v + 1 for v in node)]) == 0.0  # touched, weight 0
    assert int((raw == 1.0).sum()) == 6 and bool((raw > 2.0).any())
    assert bool(((raw > 0.0) & (raw < 1.0)).any())

    from_raw = tv.scatter_voxels_bwd(p, raw, torch.tensor(g))
    from_clamped = tv.scatter_voxels_bwd(p, raw.clamp(0.0, 1.0), torch.tensor(g))
    assert torch.equal(from_raw, from_clamped)
    assert torch.equal(scatter_voxels_bwd_cuda(p, raw.clamp(0.0, 1.0), torch.tensor(g)),
                       from_clamped)
    _, vjp = jax.vjp(lambda q: scatter_voxels_pallas(q, NODE_DIMS, interpret=True),
                     jnp.asarray(pts))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(from_clamped.numpy(), ref, atol=1e-5 * float(np.abs(ref).max()))


def test_scatter_autograd_saves_the_clamped_grid_and_matches_jax_on_the_box_scene():
    """The CPU autograd path of scatter_voxels_cuda keeps (points, clamped
    grid) for its backward and nothing else (no raw grid); on the points
    that box_scene.k1_points projects from write_smoke_dataset's box-before-a-wall
    depth at scale factor 8 (76,800 + 4,096 outside), its gradient equals
    jax.grad through scatter_voxels_pallas (interpret mode) at 1e-5 of the
    largest component."""
    cfg = Config(seed=0, scale_factor=8)
    model = box_scene.seeded_scene_net(cfg, "cpu", 0)
    rng = np.random.default_rng(7)
    pts = box_scene.k1_points(model, "box", 1, rng).numpy()
    dims = cfg.dims
    w = rng.standard_normal((1, *dims)).astype(np.float32)

    saved = []
    p = torch.tensor(pts, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        grid = scatter_voxels_cuda(p, dims)
    assert len(saved) == 2
    assert saved[0] is p
    assert saved[1].data_ptr() == grid.data_ptr() and torch.equal(saved[1], grid)
    assert 0.0 < float(grid.detach().max()) <= 1.0
    (grid * torch.tensor(w)).sum().backward()

    ref = jax.grad(lambda q: jnp.sum(scatter_voxels_pallas(q, dims, interpret=True) * w))(
        jnp.asarray(pts))
    assert float(np.abs(ref).max()) > 0.0
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("kind,least,most", [
    ("box", 2.5, None),    # write_smoke_dataset's scene: 3.03x fewer
    ("plane", 4.0, None),  # a wall at 3 m: 4.27x
    ("random", None, 1.1),  # a uniform random depth per pixel: 1.02x
])
def test_k1_atomic_count_on_full_width_depths(kind, least, most):
    """box_scene.k1_atomics, the count of K1's global atomics (one a warp, base voxel
    and corner slot) against one a corner, on a 240x320 depth projected at
    the serving dims: spatially coherent depths combine many lanes of a
    warp, a random depth per pixel almost none."""
    cfg = Config(seed=0)
    model = box_scene.seeded_scene_net(cfg, "cpu", 0)
    pts = box_scene.k1_points(model, kind, 1, np.random.default_rng(0), outside=0)
    issued, old = box_scene.k1_atomics(pts, cfg.dims)
    assert old == 8 * 240 * 320
    if least is not None:
        assert old / issued >= least
    if most is not None:
        assert old / issued < most


def test_k1_atomic_count_matches_a_warp_by_warp_count():
    """k1_atomics on B=3 x 1013 points (warps straddle the samples, many
    points dropped at the border, the last warp ragged, coincident runs)
    against a loop over the warps that counts each distinct base voxel's
    in-range corners once."""
    rng = np.random.default_rng(9)
    pts = rng.uniform(-0.7, 0.7, (3, 1013, 3)).astype(np.float32)
    pts[:, 100:400] = (0.1, -0.2, 0.3)  # one voxel for whole warps
    issued, old = box_scene.k1_atomics(torch.tensor(pts), DIMS)
    flat = pts.reshape(-1, 3)
    want_issued = want_old = 0
    for start in range(0, len(flat), 32):
        seen = set()
        for j in range(start, min(start + 32, len(flat))):
            q = torch.tensor(flat[j])
            if not bool(((q > -0.5 + 1e-6) & (q < 0.5 - 1e-6)).all()):
                continue
            base = tuple(int(torch.floor((q[a] + 0.5) * (d - 1.0))) for a, d in enumerate(DIMS))
            corners = int(np.prod([1 + (i + 1 < d) for i, d in zip(base, DIMS)]))
            want_old += corners
            if (j // 1013, base) not in seen:
                seen.add((j // 1013, base))
                want_issued += corners
    assert (issued, old) == (want_issued, want_old)
    assert issued < old
