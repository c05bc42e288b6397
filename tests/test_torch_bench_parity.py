"""The port's bench against the JAX package at scale 8 (dims (17, 13, 14),
the res_increase-2 lattice 34 x 26 x 28), on converted weights: the
bench's lattice on the f32 route against JAX's f32 sweep at res_increase 2
at 1e-5 on the sigmoid, and on the bf16 route (the headline's timed call)
against JAX's evaluate_on_grid_device (its bf16 class) within K2 bf16's
limits (2e-3, and a mean error of 1e-3 of the mean; here on the sigmoid,
which JAX's sweep returns); the reference scheme's chunk against JAX's
IFNet.__call__ at 1e-5; the scene section's u8 grid against bench.py's
image_to_grid + sweep + u8 cast within +-1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import Config as JConfig
from sv3d_tpu.config import IFNetConfig as JIFNetConfig
from sv3d_tpu.geometry.camera import parse_intrinsics as j_parse_intrinsics
from sv3d_tpu.geometry.frustum import FrustumGrid as JFrustumGrid
from sv3d_tpu.inference.dense_grid import evaluate_on_grid_device as j_evaluate_on_grid_device
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.models.scene_net import SceneNet as JSceneNet
from sv3d_tpu_torch.bench import headline
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.quality.synthetic_scenes import INTRINSICS_TEXT
from test_torch_unet import randomized

torch.set_num_threads(1)

DIMS = (17, 13, 14)


@pytest.fixture(scope="module")
def ifnet_pair():
    """The bench's grid at scale 8, JAX's IFNet with randomized weights and
    the port's IFNet on the same weights, and both pyramids."""
    _, grid = headline.build_ifnet(DIMS, "cpu")
    jm = JIFNet(JIFNetConfig.for_net_res(128))
    jgrid = jnp.asarray(grid.numpy())
    init = jax.jit(lambda k: jm.init(k, jgrid, jnp.zeros((1, 8, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 5)
    tm, _ = headline.build_ifnet(DIMS, "cpu")
    tm.load_state_dict(from_flax(variables))
    jlev = jax.jit(lambda v, g: jm.apply(v, g, train=False, method=JIFNet.encode))(
        variables, jgrid)
    with torch.inference_mode():
        tlev = tm.encode(grid)
    return grid, jm, variables, jlev, tm, tlev


def test_bench_lattice_f32_matches_jax(ifnet_pair):
    _, jm, variables, jlev, tm, tlev = ifnet_pair
    r0 = 2 * DIMS[0]
    row = jax.jit(lambda v, lv, o: jax.nn.sigmoid(jm.apply(
        v, lv, DIMS, 2, 1, o, method=JIFNet.query_lattice, compute_dtype=jnp.float32,
        fused_tail=False, use_pallas_mlp=False))[0])
    ref = np.concatenate([np.asarray(row(variables, jlev, jnp.asarray(i, jnp.int32)))
                          for i in range(r0)])
    with torch.inference_mode():
        got = headline.sweep(tm, tlev, DIMS, None, torch.float32)[:r0].numpy()
    assert got.shape == ref.shape == (34, 26, 28)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_bench_lattice_bf16_matches_jax(ifnet_pair):
    """The headline's timed call (the bf16 route, the port's default slab
    and the primary's slab of 8) against JAX's evaluate_on_grid_device."""
    _, jm, variables, jlev, tm, tlev = ifnet_pair
    r0 = 2 * DIMS[0]
    ref = np.asarray(j_evaluate_on_grid_device(jm, variables, jlev, DIMS, 2))[:r0]
    for slab_rows in (None, headline.SLAB_ROWS):
        with torch.inference_mode():
            got = headline.sweep(tm, tlev, DIMS, slab_rows)[:r0].numpy()
        err = np.abs(got - ref)
        assert err.max() <= 2e-3, slab_rows
        assert err.mean() <= 1e-3 * np.abs(ref).mean(), slab_rows


def test_reference_chunk_matches_jax_call(ifnet_pair):
    grid, jm, variables, _, tm, _ = ifnet_pair
    pts = np.random.default_rng(2).uniform(-0.45, 0.45, (1, 64, 3)).astype(np.float32)
    ref = np.asarray(jax.nn.sigmoid(jax.jit(lambda v, g, p: jm.apply(v, g, p, train=False))(
        variables, jnp.asarray(grid.numpy()), jnp.asarray(pts))))
    with torch.inference_mode():
        got = headline.reference_chunk(tm, grid, torch.from_numpy(pts)).numpy()
    assert got.shape == ref.shape == (1, 64)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_scene_grid_u8_matches_jax():
    """The scene section's device half (predict, encode, the res_increase-2
    sweep in bf16, the u8 cast) against bench.py's image_to_grid + encode +
    evaluate_on_grid_device + u8 cast, on the same weights."""
    config = headline.scene_config(8)
    jconfig = JConfig(seed=0, num_points=8, batch_size=1, net_res=128, scale_factor=8)
    ji = j_parse_intrinsics(INTRINSICS_TEXT)
    jmodel = JSceneNet(jconfig, ji, JFrustumGrid.create(ji, voxel_size=0.05 * 8))
    init = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 240, 320, 3)), jnp.full((1, 240, 320), 2.0), jnp.zeros((1, 16, 3)),
        train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 3)
    rgb = headline.scene_rgb()

    @jax.jit
    def image_to_grid(v, rgb):
        depth = jmodel.apply(v, rgb, train=False, method=JSceneNet.predict_depth)
        pc = jmodel.apply(v, depth, method=JSceneNet.project_depth)
        return jmodel.apply(v, pc, method=lambda m, p: m.project(p))

    jifnet = JIFNet(jconfig.ifnet())
    jifv = {"params": variables["params"]["ifnet"],
            "batch_stats": variables["batch_stats"]["ifnet"]}
    vox = image_to_grid(variables, jnp.asarray(rgb)[None])
    levels = jax.jit(lambda v, g: jifnet.apply(v, g, train=False, method=JIFNet.encode))(
        jifv, vox)
    r0 = 2 * config.dims[0]
    value = j_evaluate_on_grid_device(jifnet, jifv, levels, config.dims, 2)
    ref = np.asarray((value[:r0] * 255.0 + 0.5).astype(jnp.uint8))

    model = headline.scene_model(config, "cpu")
    model.load_state_dict(from_flax(variables))
    got = headline.scene_grid_u8(config, model, rgb)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (34, 26, 28)
    assert len(np.unique(ref)) > 4  # a field, not a constant
    assert np.abs(got.astype(np.int16) - ref.astype(np.int16)).max() <= 1
