"""The JAX package's public names in the port: every name in the __all__ of
a subpackage of sv3d_tpu has a counterpart in the same subpackage of
sv3d_tpu_torch (`from sv3d_tpu_torch.io import load_rgb` works wherever
`from sv3d_tpu.io import load_rgb` does), except the GSPMD shardings that
have no role under torch.distributed; and the names added for that, each
held to the JAX function on seeded inputs."""

from __future__ import annotations

import importlib
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.geometry.transforms import make_3d_grid as j_make_3d_grid
from sv3d_tpu.io.image import normalize_rgb as j_normalize_rgb
from sv3d_tpu.io.mesh import save_obj as j_save_obj
from sv3d_tpu.io.volume import read_semantics as j_read_semantics
from sv3d_tpu.ops.lattice import axis_matrices as j_axis_matrices
from sv3d_tpu.ops.lattice import resize_volume_cm as j_resize_volume_cm
from sv3d_tpu.ops.voxelize import voxelize as j_voxelize
from sv3d_tpu.utils.visualize import scale_mesh_to_unit as j_scale_mesh_to_unit
from sv3d_tpu_torch.geometry import make_3d_grid
from sv3d_tpu_torch.io import load_obj, normalize_rgb, read_semantics
from sv3d_tpu_torch.ops import axis_matrices, resize_volume_cm, voxelize
from sv3d_tpu_torch.training import TrainState, build_optimizer, create_train_state
from sv3d_tpu_torch.utils.profiling import trace
from sv3d_tpu_torch.utils.visualize import scale_mesh_to_unit

torch.set_num_threads(1)

#: names of the JAX package's __all__ without a counterpart, and why
EXEMPT = {
    # GSPMD NamedShardings of the (dp, sp) mesh: under torch.distributed a
    # rank holds its share of a batch as a plain tensor (parallel.shard_batch
    # slices it), and replicate_tree broadcasts rank 0's weights
    "parallel": {"batch_sharding", "point_sharding", "replicate"},
}
#: the subpackages of sv3d_tpu that have an __all__
SUBPACKAGES = ["data", "evaluation", "geometry", "inference", "io", "models", "ops", "parallel",
               "preprocessing", "training"]


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_every_public_name_has_a_counterpart(name):
    jax_pkg = importlib.import_module(f"sv3d_tpu.{name}")
    port = importlib.import_module(f"sv3d_tpu_torch.{name}")
    public = set(jax_pkg.__all__)
    exempt = EXEMPT.get(name, set())
    assert exempt <= public, f"{name}: exempt names the JAX package no longer has"
    missing = sorted(n for n in public - exempt if not hasattr(port, n))
    assert not missing, f"sv3d_tpu_torch.{name} lacks {missing}"
    assert not exempt & set(getattr(port, "__all__", ())), name
    assert public - exempt <= set(getattr(port, "__all__", public - exempt)), name


def test_read_semantics_matches_jax(tmp_path):
    """A seeded (5, 4, 3) uint16 semantics volume, labels * 1000 + instance,
    in the .sem layout (3 x uint64 dims, Fortran order)."""
    rng = np.random.default_rng(0)
    sem = (rng.integers(0, 40, (5, 4, 3)) * 1000 + rng.integers(0, 1000, (5, 4, 3)))
    path = tmp_path / "scene.sem"
    path.write_bytes(struct.pack("<3Q", *sem.shape)
                     + np.asfortranarray(sem.astype(np.uint16)).tobytes(order="F"))
    for got, want in zip(read_semantics(path), j_read_semantics(path), strict=True):
        np.testing.assert_array_equal(got, want)


def test_normalize_rgb_matches_jax():
    img = np.random.default_rng(1).uniform(0, 1, (6, 7, 3)).astype(np.float32)
    got = normalize_rgb(img)
    assert got.shape == (3, 6, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, j_normalize_rgb(img))


@pytest.mark.parametrize("res_increase", [1, 2])
def test_make_3d_grid_matches_jax(res_increase):
    bb_min, bb_max, shape = (-0.5, -0.4, -0.3), (0.5, 0.45, 0.2), (5, 4, 3)
    got = make_3d_grid(bb_min, bb_max, shape, res_increase).numpy()
    want = np.asarray(j_make_3d_grid(bb_min, bb_max, shape, res_increase))
    assert got.shape == want.shape == (60 * res_increase**3, 3)
    # linspace's two implementations round the interior points apart by an ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_scale_mesh_to_unit_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    verts = rng.uniform(0, 100, (30, 3))
    faces = rng.integers(0, 30, (20, 3))
    (tmp_path / "jax").mkdir()
    j_save_obj(tmp_path / "mesh.obj", verts, faces)
    j_save_obj(tmp_path / "jax" / "mesh.obj", verts, faces)
    dims = (139, 104, 112)
    out = scale_mesh_to_unit(tmp_path / "mesh.obj", dims)
    want = j_scale_mesh_to_unit(tmp_path / "jax" / "mesh.obj", dims)
    assert out == tmp_path / "mesh_scaled.obj" and want.name == out.name
    got, ref = load_obj(out), load_obj(want)
    np.testing.assert_array_equal(got.faces, ref.faces)
    np.testing.assert_allclose(got.vertices, ref.vertices, rtol=1e-12)
    np.testing.assert_allclose(got.vertices, verts / np.asarray(dims), rtol=1e-6)


@pytest.mark.parametrize("kernel_size", [(3, 3, 3), (5, 3, 4)])
def test_voxelize_matches_jax(kernel_size):
    """The scatter and the learnable smoothing on 2 x 600 seeded points (the
    plain scatter here: a CPU tensor), and the gradient in the points and
    sigma against jax.grad of the JAX function."""
    rng = np.random.default_rng(3)
    dims = (9, 8, 7)
    pts = rng.uniform(-0.55, 0.55, (2, 600, 3)).astype(np.float32)
    sigma = np.array([1.2, 0.9, 1.6], np.float32)
    cot = rng.normal(size=(2, *dims, 1)).astype(np.float32)

    def j_loss(p, s):
        return jnp.sum(j_voxelize(p, dims, s, kernel_size) * cot)

    want = np.asarray(j_voxelize(jnp.asarray(pts), dims, jnp.asarray(sigma), kernel_size))
    jg_p, jg_s = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(pts), jnp.asarray(sigma))
    p = torch.tensor(pts, requires_grad=True)
    s = torch.tensor(sigma, requires_grad=True)
    got = voxelize(p, dims, s, kernel_size)
    assert got.shape == want.shape == (2, *dims, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    for g, jg in ((p.grad, jg_p), (s.grad, jg_s)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())


def test_resize_volume_cm_matches_jax():
    """A channel-major (2, 3, 6, 5, 4) volume resized onto a (9, 9, 9)
    lattice by each axis's center matrix (axis_matrices' own)."""
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(2, 3, 6, 5, 4)).astype(np.float32)
    mats = [axis_matrices(9, g, False, 0.0722)[0] for g in vol.shape[2:]]
    j_mats = [j_axis_matrices(9, g, False, 0.0722)[0] for g in vol.shape[2:]]
    for m, jm in zip(mats, j_mats):
        np.testing.assert_array_equal(np.asarray(m), np.asarray(jm))
    got = resize_volume_cm(torch.from_numpy(vol), *mats).numpy()
    want = np.asarray(j_resize_volume_cm(jnp.asarray(vol), *(jnp.asarray(m) for m in j_mats)))
    assert got.shape == want.shape == (2, 3, 9, 9, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_create_train_state_matches_jax():
    """The JAX package's create_train_state and the port's from one set of
    variables (carried across by from_flax): the same parameters and
    BatchNorm statistics at step 0, and a fresh optimizer over the model."""
    from sv3d_tpu.models.ifnet import IFNet as JIFNet
    from sv3d_tpu.training.optim import build_optimizer as j_build_optimizer
    from sv3d_tpu.training.state import create_train_state as j_create_train_state
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.convert import from_flax
    from sv3d_tpu_torch.models.ifnet import IFNet

    cfg = IFNetConfig.for_net_res(32)
    jm = JIFNet(cfg)
    grid = jnp.zeros((1, 9, 8, 7, 1))
    variables = jm.init(jax.random.PRNGKey(5), grid, jnp.zeros((1, 4, 3)), train=False)
    jstate = j_create_train_state(jm, variables, j_build_optimizer(1e-4, variables["params"]))
    model = IFNet(cfg)
    opt = build_optimizer(1e-4, model)
    state = create_train_state(model, from_flax(variables), opt)
    assert isinstance(state, TrainState) and state.step == int(jstate.step) == 0
    assert state.model is model and state.optimizer is opt and not opt.state
    want = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    kept = create_train_state(model, None, opt)
    assert kept.model is model and kept.step == 0


def test_trace_writes_a_torch_profiler_trace(tmp_path):
    """utils.profiling.trace, the JAX package's jax.profiler context as a
    torch.profiler one: the host's ops of its body land in trace.json."""
    with trace(tmp_path / "profile") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with trace(tmp_path / "unwritten", write=False):
        pass
    assert not (tmp_path / "unwritten").exists()


def test_fit_under_the_advanced_profiler_writes_its_trace(tmp_path):
    """--profiler advanced: the loop traces the first steps through
    utils.profiling.trace into <exp>/profile/trace.json."""
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    root = write_smoke_dataset(tmp_path / "data", scale_factor=8, n_points=200)
    cfg = Config(seed=0, scale_factor=8, batch_size=1, num_points=16, skip_unet=True,
                 datasetdir=str(root), sanity_steps=0, profiler="advanced")
    SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "exp").fit(max_steps=2)
    events = json.loads((tmp_path / "exp" / "profile" / "trace.json").read_text())
    assert events["traceEvents"]
    assert (tmp_path / "exp" / "profile_simple.json").exists()
