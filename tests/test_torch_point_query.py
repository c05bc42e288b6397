"""Port parity of the arbitrary-point query and the scatter backward: the
gather sampler, the plain versions of kernels K4, K7 and K8
(sv3d_tpu_torch/ops/point_query.py) and of K1b (scatter_voxels_bwd), against
the JAX package on the same numpy inputs.

Tolerances: against the exact f32 XLA paths (the sampler and its autodiff)
1e-5, the difference of f32 summation orders; against the Pallas kernels,
which compute in bf16 with f32 accumulation, the JAX package's own bounds
(3e-2 relative for features, tests/test_pallas_query.py; 4e-2 relative for
gradients, tests/test_pallas_query_bwd.py).  Pallas runs in interpret mode
on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.ops.grid_sample import displacement_axes as j_displacement_axes
from sv3d_tpu.ops.grid_sample import sample_trilinear_flat as j_sample
from sv3d_tpu.ops.pallas.point_query import bucket_queries, level_features as j_level_features
from sv3d_tpu.ops.pallas.point_query_bwd import level_grad_points, level_grad_vol
from sv3d_tpu.ops.pallas.voxelize import scatter_voxels_pallas
from sv3d_tpu_torch.ops.cuda.point_query import (
    level_features,
    level_features_cuda,
    level_grad_points_cuda,
    level_grad_vol_cuda,
)
from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_cuda
from sv3d_tpu_torch.ops.grid_sample import displacement_axes, sample_trilinear, sample_trilinear_flat
from sv3d_tpu_torch.ops.point_query import (
    level_features_plain,
    level_grad_points_plain,
    level_grad_vol_plain,
)

torch.set_num_threads(1)

DIMS = {False: (19, 13, 14), True: (18, 13, 14)}  # by align_corners
DISP = {False: 0.0722, True: 0.035}


def _inputs(ac, c, b=2, n=150, seed=0):
    rng = np.random.default_rng(seed + int(ac))
    dims = DIMS[ac]
    vol = rng.standard_normal((b, *dims, c)).astype(np.float32)  # JAX layout
    pts = rng.uniform(-1.1, 1.1, (b, n, 3)).astype(np.float32)  # incl. out of range
    probe = rng.standard_normal((b, n, 7 * c)).astype(np.float32)
    return dims, vol, pts, probe


def _flat(vol):
    """(B, G0, G1, G2, C) numpy -> the port's channel-major flat level."""
    b, c = vol.shape[0], vol.shape[-1]
    return torch.tensor(np.moveaxis(vol, -1, 1).reshape(b, c, -1))


def _jax_xla(vol, pts, probe, dims, ac):
    """Features (B, N, 7C) of the exact XLA gather path and the autodiff of
    sum(features * probe): (feats, grad vol (B, G0, G1, G2, C), grad coords (B, N, 3))."""
    b, n = pts.shape[:2]
    c = vol.shape[-1]

    def feats(v, p0, p1, p2):
        flat = jnp.moveaxis(v, -1, 1).reshape(b, c, -1)
        f = j_sample(flat, dims, j_displacement_axes((p0, p1, p2), DISP[ac]), align_corners=ac)
        return jnp.moveaxis(f.reshape(b, c, 7, n), 1, -1).transpose(0, 2, 1, 3).reshape(b, n, 7 * c)

    args = (jnp.asarray(vol), *(jnp.asarray(pts[..., i]) for i in range(3)))
    f = feats(*args)
    grads = jax.grad(lambda *a: jnp.sum(feats(*a) * probe), argnums=(0, 1, 2, 3))(*args)
    return np.asarray(f), np.asarray(grads[0]), np.stack([np.asarray(g) for g in grads[1:]], -1)


@pytest.mark.parametrize("ac", [False, True])
def test_sampler_values_and_grads_match_xla(ac):
    dims, vol, pts, probe = _inputs(ac, c=3)
    b, n = pts.shape[:2]
    flat = _flat(vol).requires_grad_()
    p = [torch.tensor(pts[..., i], requires_grad=True) for i in range(3)]
    jflat = jnp.moveaxis(jnp.asarray(vol), -1, 1).reshape(b, 3, -1)
    jp = tuple(jnp.asarray(pts[..., i]) for i in range(3))
    w = np.random.default_rng(5).standard_normal((b, 3, n)).astype(np.float32)

    got = sample_trilinear_flat(flat, dims, p, ac)
    ref = j_sample(jflat, dims, jp, align_corners=ac)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-5)
    (got * torch.tensor(w)).sum().backward()
    gref = jax.grad(lambda f, *q: jnp.sum(j_sample(f, dims, q, align_corners=ac) * w),
                    argnums=(0, 1, 2, 3))(jflat, *jp)
    np.testing.assert_allclose(flat.grad.numpy(), np.asarray(gref[0]), atol=1e-5)
    for i in range(3):
        np.testing.assert_allclose(p[i].grad.numpy(), np.asarray(gref[1 + i]), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(gref[1 + i]).max()))
    # the channels-last entry and the displaced copies
    np.testing.assert_allclose(
        sample_trilinear(torch.tensor(vol), torch.tensor(pts), ac).numpy(), np.asarray(ref),
        atol=1e-5)
    for a, r in zip(displacement_axes(tuple(torch.tensor(pts[..., i]) for i in range(3)), 0.07),
                    j_displacement_axes(jp, 0.07)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("ac,c", [(False, 16), (True, 4)])
def test_plain_kernels_match_xla_and_pallas(ac, c):
    """Plain K4 / K7 / K8 against the XLA f32 path at 1e-5 and against the
    Pallas kernels (interpret mode) at the JAX package's bf16 bounds."""
    dims, vol, pts, probe = _inputs(ac, c)
    disp = DISP[ac]
    flat = _flat(vol)
    p = [torch.tensor(pts[..., i]) for i in range(3)]
    g = torch.tensor(probe)
    feats_ref, gvol_ref, gpts_ref = _jax_xla(vol, pts, probe, dims, ac)

    feats = level_features_plain(flat, *p, dims, ac, disp).numpy()
    gpts = level_grad_points_plain(flat, *p, g, dims, ac, disp).numpy()
    gvol = level_grad_vol_plain(*p, g, dims, ac, disp).numpy()
    gvol = np.moveaxis(gvol.reshape(flat.shape[0], c, *dims), 1, -1)
    np.testing.assert_allclose(feats, feats_ref, atol=1e-5)
    np.testing.assert_allclose(gvol, gvol_ref, atol=1e-5 * max(np.abs(gvol_ref).max(), 1.0))
    np.testing.assert_allclose(gpts, gpts_ref, atol=1e-5 * max(np.abs(gpts_ref).max(), 1.0))

    # Pallas, on the bucketed layout
    jp = [jnp.asarray(pts[..., i]) for i in range(3)]
    q0, q1, q2, pos, tile_slab, tile_used = bucket_queries(*jp, dims[0], ac)
    pos = np.asarray(pos)
    jf = j_level_features(jnp.asarray(vol), q0, q1, q2, tile_slab, tile_used, dims, dims[0],
                          ac, disp, interpret=True)
    jf = np.take_along_axis(np.asarray(jf), pos[..., None], axis=1)
    assert (np.abs(feats - jf) / np.maximum(np.abs(jf), 1.0)).max() < 3e-2
    gpad = jnp.zeros((pts.shape[0], q0.shape[1], 7 * c), jnp.float32)
    gpad = jax.vmap(lambda a, i, v: a.at[i].set(v))(gpad, jnp.asarray(pos), jnp.asarray(probe))
    jgp = level_grad_points(jnp.asarray(vol), q0, q1, q2, tile_slab, tile_used, gpad, dims,
                            dims[0], ac, disp, interpret=True)
    jgp = np.take_along_axis(np.asarray(jgp), pos[..., None], axis=1)
    for axis in range(3):
        ref = jgp[..., axis]
        assert np.abs(gpts[..., axis] - ref).max() < 4e-2 * max(np.abs(ref).max(), 1.0)
    jgv = np.asarray(level_grad_vol(q0, q1, q2, tile_slab, tile_used, gpad, dims, dims[0], ac,
                                    disp, interpret=True))
    assert np.abs(gvol - jgv).max() < 4e-2 * max(np.abs(jgv).max(), 1.0)


def test_level_features_function_on_cpu_runs_plain_versions():
    """The differentiable entry on CPU tensors: forward = plain K4, backward =
    plain K8 and K7; no kernel launch is counted."""
    dims, vol, pts, probe = _inputs(False, c=5, n=40)
    flat = _flat(vol).requires_grad_()
    p = [torch.tensor(pts[..., i], requires_grad=True) for i in range(3)]
    before = [f.launches for f in (level_features_cuda, level_grad_points_cuda, level_grad_vol_cuda)]
    out = level_features(flat, *p, dims, False, 0.0722)
    (out * torch.tensor(probe)).sum().backward()
    assert [f.launches for f in (level_features_cuda, level_grad_points_cuda,
                                 level_grad_vol_cuda)] == before
    g = torch.tensor(probe)
    q = [x.detach() for x in p]
    plain = [level_features_plain(flat.detach(), *q, dims, False, 0.0722),
             level_grad_vol_plain(*q, g, dims, False, 0.0722),
             level_grad_points_plain(flat.detach(), *q, g, dims, False, 0.0722)]
    np.testing.assert_array_equal(out.detach().numpy(), plain[0].numpy())
    np.testing.assert_array_equal(flat.grad.numpy(), plain[1].numpy())
    np.testing.assert_array_equal(torch.stack([q.grad for q in p], -1).numpy(), plain[2].numpy())


@pytest.mark.parametrize("ac", [False, True])
def test_level_features_backward_from_a_channels_last_view(ac):
    """level_features given a channels-last view of the level (what K4 and
    K7 read, saved by the forward for the backward without a copy) has the
    features and the gradients, level and coordinates, of the channel-major
    flat."""
    dims, vol, pts, probe = _inputs(ac, c=8, n=60)
    flat = _flat(vol)
    view = flat.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous() and torch.equal(view, flat)
    g = torch.tensor(probe)
    runs = []
    for level in (flat, view):
        lv = level.detach().requires_grad_()
        p = [torch.tensor(pts[..., i], requires_grad=True) for i in range(3)]
        out = level_features(lv, *p, dims, ac, DISP[ac])
        (out * g).sum().backward()
        runs.append((out.detach(), lv.grad, torch.stack([q.grad for q in p], -1)))
    (f0, gv0, gp0), (f1, gv1, gp1) = runs
    assert torch.equal(f0, f1) and torch.equal(gv0, gv1) and torch.equal(gp0, gp1)


def test_scatter_backward_matches_pallas_custom_vjp():
    """jax.grad through scatter_voxels_pallas (interpret mode; its custom VJP
    is the XLA _scatter_bwd) against the port's autograd.Function, whose CPU
    backward is the plain K1b.  Dense points so that some voxels clamp at 1."""
    dims = (9, 7, 8)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.55, 0.55, (2, 600, 3)).astype(np.float32)
    w = rng.standard_normal((2, *dims)).astype(np.float32)
    ref_grid = scatter_voxels_pallas(jnp.asarray(pts), dims, interpret=True)
    ref = jax.grad(lambda p: jnp.sum(scatter_voxels_pallas(p, dims, interpret=True) * w))(
        jnp.asarray(pts))

    p = torch.tensor(pts, requires_grad=True)
    grid = scatter_voxels_cuda(p, dims)
    assert float(grid.detach().max()) == 1.0  # the clamp is active
    before = scatter_voxels_bwd_cuda.launches
    (grid * torch.tensor(w)).sum().backward()
    assert scatter_voxels_bwd_cuda.launches == before
    np.testing.assert_allclose(grid.detach().numpy(), np.asarray(ref_grid), atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref),
                               atol=1e-5 * float(np.abs(ref).max()))
