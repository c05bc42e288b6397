"""Port parity: the voxelization and Projection of sv3d_tpu_torch against
sv3d_tpu.

The plain torch scatter sums the same f32 weights as the JAX scatter in
another order; atol 2e-6 is the JAX package's own bound between its XLA
scatter and its Pallas kernel (tests/test_pallas_voxelize.py).  Smoothing is
three f32 contractions on both sides: atol 1e-6."""

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
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.models.projection import Projection
from sv3d_tpu_torch.ops import voxelize as tv
from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda

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
