"""Port parity: sv3d_tpu_torch.geometry against sv3d_tpu.geometry.

Every transform is elementwise f32 in both packages, so the tolerance is
atol 1e-6 (one or two f32 ulps at grid-space magnitudes of ~100)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu import geometry as jg
from sv3d_tpu_torch import geometry as tg

torch.set_num_threads(1)

TEXT = "[[277.128, 0., 159.5, 0.], [0., 277.128, 119.5, 0.], [0., 0., 1., 0.], [0., 0., 0., 1.]]"
RNG = np.random.default_rng(5)


def test_intrinsics_and_depth_conversions():
    ji, ti = jg.parse_intrinsics(TEXT), tg.parse_intrinsics(TEXT)
    assert ti.matrix == ji.matrix
    np.testing.assert_array_equal(ti.inverse, ji.inverse)

    dist = RNG.uniform(0.5, 6.0, (2, 240, 320)).astype(np.float32)
    jd = np.asarray(jg.distance_to_depth(jnp.asarray(dist), ji.focal_length))
    td = tg.distance_to_depth(torch.tensor(dist), ti.focal_length).numpy()
    np.testing.assert_allclose(td, jd, atol=1e-6)

    jc = np.asarray(jg.depth_to_camera(jnp.asarray(jd), ji.focal_length, ji.cx, ji.cy))
    tc = tg.depth_to_camera(torch.tensor(jd), ti.focal_length, ti.cx, ti.cy).numpy()
    np.testing.assert_allclose(tc, jc, atol=1e-6)


@pytest.mark.parametrize("voxel,dims", [(0.05, (139, 104, 112)), (0.1, (70, 52, 56))])
def test_frustum_and_gridspace(voxel, dims):
    ji, ti = jg.parse_intrinsics(TEXT), tg.parse_intrinsics(TEXT)
    jf = jg.FrustumGrid.create(ji, voxel_size=voxel)
    tf = tg.FrustumGrid.create(ti, voxel_size=voxel)
    assert tf.dims == jf.dims == dims
    assert tf.camera2frustum == jf.camera2frustum

    depth = RNG.uniform(0.4, 6.0, (1, 240, 320)).astype(np.float32)
    jp = np.asarray(jg.depthmap_to_gridspace(jnp.asarray(depth), ji, jf))
    tp = tg.depthmap_to_gridspace(torch.tensor(depth), ti, tf).numpy()
    np.testing.assert_allclose(tp, jp, atol=1e-6 * max(dims))

    jn = np.asarray(jg.norm_grid_space(jnp.asarray(jp), dims))
    tn = tg.norm_grid_space(torch.tensor(jp), dims).numpy()
    np.testing.assert_allclose(tn, jn, atol=1e-6)
    ju = np.asarray(jg.unnorm_grid_space(jnp.asarray(jn), dims))
    tu = tg.unnorm_grid_space(torch.tensor(jn), dims).numpy()
    np.testing.assert_allclose(tu, ju, atol=1e-6 * max(dims))
