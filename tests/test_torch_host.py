"""The port's own copies of the JAX package's host modules held to their
originals: Config, the native geometry library, the EXR and OBJ formats, and
the datasets and loader.  Tests may import both packages; the port itself
imports nothing of sv3d_tpu (tests/test_torch_no_jax.py)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import sv3d_tpu.config as jconfig
import sv3d_tpu.native as jnative
import sv3d_tpu_torch.config as tconfig
import sv3d_tpu_torch.native as tnative
from sv3d_tpu.data.datasets import DepthDataset as JDepthDataset
from sv3d_tpu.data.datasets import SceneNetDataset as JSceneNetDataset
from sv3d_tpu.data.loader import DataLoader as JDataLoader
from sv3d_tpu.io.exr import read_exr as j_read_exr
from sv3d_tpu.io.exr import write_exr as j_write_exr
from sv3d_tpu.io.mesh import load_obj as j_load_obj
from sv3d_tpu.io.mesh import save_obj as j_save_obj
from sv3d_tpu_torch.data.datasets import DepthDataset, SceneNetDataset
from sv3d_tpu_torch.data.loader import DataLoader
from sv3d_tpu_torch.io.exr import read_exr, read_exr_channel, write_exr
from sv3d_tpu_torch.io.mesh import load_obj, save_obj
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset

ROOT = Path(__file__).resolve().parent.parent

#: the port's Config fields that the JAX package's lacks, in their order
PORT_ONLY = ("decoder", "convonet", "vecset")
CONFIGS = [dict(), dict(scale_factor=2), dict(scale_factor=8), dict(net_res=32),
           dict(fused_query=True), dict(inf_res=2), dict(net_res=32, scale_factor=2,
                                                         fused_query=True, precision=16)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items())
                         or "defaults")
def test_config_matches_jax(kw):
    """Field for field, dims, projection() and ifnet(), replace(); the port's
    three decoder fields, which the JAX package lacks, come last, the IF-Net
    by default."""
    got, ref = tconfig.Config(seed=0, **kw), jconfig.Config(seed=0, **kw)
    ported = lambda c: {k: v for k, v in dataclasses.asdict(c).items() if k not in PORT_ONLY}
    assert ported(got) == dataclasses.asdict(ref)
    assert (got.decoder, got.convonet, got.vecset) == ("ifnet", tconfig.ConvONetConfig(),
                                                       tconfig.VecSetConfig())
    assert got.dims == ref.dims
    assert dataclasses.asdict(got.projection()) == dataclasses.asdict(ref.projection())
    gi, ri = got.ifnet(), ref.ifnet()
    assert dataclasses.asdict(gi) == dataclasses.asdict(ri)
    assert (gi.feature_channels, gi.align_corners) == (ri.feature_channels, ri.align_corners)
    assert ported(got.replace(lr=3e-4)) == dataclasses.asdict(ref.replace(lr=3e-4))
    assert got.dtype == (torch.float32 if got.precision == 32 else torch.bfloat16)
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)] + list(PORT_ONLY)
    assert dataclasses.asdict(tconfig.IFNetConfig.for_net_res(32)) == dataclasses.asdict(
        jconfig.IFNetConfig.for_net_res(32))


def test_config_drops_the_tpu_compile_guard():
    """The JAX package refuses fused_query at net_res 32 and full scale (a
    compile limit of its TPU kernel); the port takes it."""
    with pytest.raises(ValueError):
        jconfig.Config(seed=0, net_res=32, fused_query=True)
    assert tconfig.Config(seed=0, net_res=32, fused_query=True).dims == (139, 104, 112)


def _field(shape, seed):
    """A smooth seeded scalar field: a sphere's distance plus low noise."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, s) for s in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return (np.sqrt(x**2 + y**2 + z**2) + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def test_native_library_is_the_ports_own_build():
    path = tnative.build()
    assert path == tnative.library_path() and path.exists()
    assert path.parent == ROOT / "build" / "sv3d_tpu_torch"
    assert tnative._GEOM_ABI == jnative._GEOM_ABI


def test_native_marching_cubes_match():
    vol = _field((16, 17, 18), 0)
    for level in (0.5, 0.8):
        for got, ref in zip(tnative.marching_cubes(vol, level), jnative.marching_cubes(vol, level)):
            assert got.shape[0] > 0
            np.testing.assert_array_equal(got, ref)
    u8 = np.clip(vol * 200.0, 0, 255).astype(np.uint8)
    for got, ref in zip(tnative.marching_cubes_u8(u8, 0.4), jnative.marching_cubes_u8(u8, 0.4)):
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, ref)


def test_native_triangle_hash_kdtree_and_obj_match():
    rng = np.random.default_rng(1)
    tris = rng.uniform(0, 1, (60, 3, 2))
    pts2 = rng.uniform(0, 1, (400, 2))
    got = tnative.TriangleHash(tris, 16).query(pts2)
    ref = jnative.TriangleHash(tris, 16).query(pts2)
    assert len(got[0]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    pts3 = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    queries = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    for g, r in zip(tnative.KDTree(pts3).query(queries), jnative.KDTree(pts3).query(queries)):
        np.testing.assert_array_equal(g, r)
    faces = rng.integers(0, 500, (100, 3))
    assert tnative.format_obj(pts3, faces) == jnative.format_obj(pts3, faces)


def test_exr_and_obj_cross_read(tmp_path):
    """A file written by one package reads back identically in the other,
    and both write the same bytes."""
    rng = np.random.default_rng(2)
    chans = {"R": rng.uniform(0.4, 6.0, (24, 32)).astype(np.float32),
             "G": rng.standard_normal((24, 32)).astype(np.float32)}
    for compress in (True, False):
        write_exr(tmp_path / "t.exr", chans, compress=compress)
        j_write_exr(tmp_path / "j.exr", chans, compress=compress)
        assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
        for a, b in ((read_exr(tmp_path / "j.exr"), chans), (j_read_exr(tmp_path / "t.exr"), chans)):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(read_exr_channel(tmp_path / "j.exr", "R"), chans["R"])

    verts = rng.uniform(-1, 1, (50, 3))
    faces = rng.integers(0, 50, (80, 3))
    save_obj(tmp_path / "t.obj", verts, faces)
    j_save_obj(tmp_path / "j.obj", verts, faces)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    for mesh in (load_obj(tmp_path / "j.obj"), j_load_obj(tmp_path / "t.obj")):
        np.testing.assert_array_equal(mesh.faces, faces)
        np.testing.assert_allclose(mesh.vertices, verts, rtol=1e-7)
    np.testing.assert_array_equal(load_obj(tmp_path / "j.obj").vertices,
                                  j_load_obj(tmp_path / "j.obj").vertices)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_datasets_and_loader_match_on_the_smoke_tree(tmp_path):
    """The tree box_scene.write_smoke_dataset writes at scale_factor 8: the
    port's SceneNetDataset (with and without the flip augmentation) and
    DepthDataset yield the JAX datasets' arrays, and the loaders the same
    batches."""
    root = write_smoke_dataset(tmp_path / "data", scale_factor=8, n_points=500)
    for flip in (None, 0.37):
        kw = dict(num_points=64, splitsdir="overfit", seed=3, flip_x_about=flip)
        got, ref = SceneNetDataset("train", root, **kw), JSceneNetDataset("train", root, **kw)
        assert len(got) == len(ref) == 50
        for i, epoch in ((0, 0), (1, 0), (2, 1), (7, 3)):
            _same(got.get(i, epoch), ref.get(i, epoch))
        lk = dict(batch_size=4, shuffle=True, seed=5, num_workers=2)
        for a, b in zip(DataLoader(got, **lk), JDataLoader(ref, **lk)):
            _same(a, b)
    got, ref = DepthDataset("val", root, seed=1), JDepthDataset("val", root, seed=1)
    _same(got[0], ref[0])
