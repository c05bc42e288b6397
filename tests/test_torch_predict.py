"""Port parity for the serving slice as a whole: RGB -> UNetMini -> depth ->
back-projection -> Projection -> IF-Net encode -> dense sweep, through both
packages' predict + evaluate_on_grid, from the same (converted) SceneNet
weights: full widths, net_res 128, at scale_factor 8 (dims (17, 13, 14), a
frustum of (18, 13, 14)).

Tolerances: the depth map and the voxel occupancy at atol 1e-4 (f32 conv
sums in another order); the port's f32 sigmoid grid (compute_dtype=float32)
at atol 1e-4 against the JAX chain run with compute_dtype=float32.  Both
packages' evaluate_on_grid sweep in bf16 by default: port against JAX there,
and the port's f32 grid against JAX's bf16 one, at the JAX package's
mixed-precision atol 2e-2 (tests/test_pallas_sweep.py).  The port's main() is driven on the CPU
and its OBJ read back with sv3d_tpu.io.load_obj."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import Config
from sv3d_tpu.geometry.camera import parse_intrinsics as j_parse_intrinsics
from sv3d_tpu.geometry.frustum import FrustumGrid as JFrustumGrid
from sv3d_tpu.inference.dense_grid import evaluate_on_grid as j_evaluate_on_grid
from sv3d_tpu.inference.predict import predict as j_predict
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.models.scene_net import SceneNet as JSceneNet
from sv3d_tpu_torch.convert import from_flax
from test_torch_unet import randomized
from sv3d_tpu_torch.geometry.camera import parse_intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid
from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid, evaluate_on_grid_device
from sv3d_tpu_torch.inference.predict import main, predict
from sv3d_tpu_torch.models.scene_net import SceneNet

torch.set_num_threads(1)

TEXT = "[[277.128, 0., 159.5, 0.], [0., 277.128, 119.5, 0.], [0., 0., 1., 0.], [0., 0., 0., 1.]]"
SCALE = 8


@pytest.fixture(scope="module")
def slice_run():
    config = Config(scale_factor=SCALE, seed=0)
    ji = j_parse_intrinsics(TEXT)
    jmodel = JSceneNet(config, ji, JFrustumGrid.create(ji, voxel_size=0.05 * SCALE))
    init = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 240, 320, 3)), jnp.full((1, 240, 320), 2.0), jnp.zeros((1, 8, 3)),
        train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 3)
    rgb_u8 = np.random.default_rng(4).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    rgb = ((rgb_u8 / np.float32(255.0) - 0.5) / 0.5).astype(np.float32)

    state = SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    jvox, jdepth = j_predict(config, jmodel, state, rgb=rgb)
    ifnet = JIFNet(config.ifnet())
    ifv = {"params": variables["params"]["ifnet"],
           "batch_stats": variables["batch_stats"]["ifnet"]}
    levels = jax.jit(lambda v, g: ifnet.apply(v, g, train=False, method=JIFNet.encode))(ifv, jvox)
    sweep = jax.jit(lambda v, lv, o: jax.nn.sigmoid(ifnet.apply(
        v, lv, config.dims, 1, 1, o, method=JIFNet.query_lattice,
        compute_dtype=jnp.float32, fused_tail=False, use_pallas_mlp=False))[0])
    jgrid_f32 = np.concatenate([
        np.asarray(sweep(ifv, levels, jnp.asarray(r, jnp.int32))) for r in range(config.dims[0])
    ])
    jgrid_bf16 = j_evaluate_on_grid(ifnet, ifv, jvox, config.dims, transfer_dtype=jnp.float32)

    ti = parse_intrinsics(TEXT)
    model = SceneNet(config, ti, FrustumGrid.create(ti, voxel_size=0.05 * SCALE))
    model.load_state_dict(from_flax(variables))
    model.eval()
    vox, depth = predict(config, model, rgb=rgb)
    grid = evaluate_on_grid(model.ifnet, vox, config.dims, transfer_dtype=torch.float32)
    with torch.inference_mode():
        grid_f32 = evaluate_on_grid_device(model.ifnet, model.ifnet.encode(vox), config.dims,
                                           compute_dtype=torch.float32).numpy()
    return SimpleNamespace(
        config=config, model=model, rgb_u8=rgb_u8, jvox=np.asarray(jvox), jdepth=jdepth,
        jgrid_f32=jgrid_f32, jgrid_bf16=jgrid_bf16, vox=vox.numpy(), depth=depth, grid=grid,
        grid_f32=grid_f32,
    )


def test_slice_matches_jax(slice_run):
    s = slice_run
    assert s.config.dims == (17, 13, 14)
    np.testing.assert_allclose(s.depth, s.jdepth, atol=1e-4)
    assert s.vox.shape == (1, 17, 13, 14, 1)
    assert s.vox.max() > 0.1  # the depth map really landed in the grid
    np.testing.assert_allclose(s.vox, s.jvox, atol=1e-4)
    assert s.grid.shape == s.grid_f32.shape == (17, 13, 14) and np.isfinite(s.grid).all()
    np.testing.assert_allclose(s.grid_f32, s.jgrid_f32, atol=1e-4)
    np.testing.assert_allclose(s.grid_f32, s.jgrid_bf16, atol=2e-2)
    np.testing.assert_allclose(s.grid, s.jgrid_bf16, atol=2e-2)


def test_main_writes_a_mesh(slice_run, tmp_path):
    from PIL import Image

    from sv3d_tpu.io.mesh import load_obj

    s = slice_run
    scene = tmp_path / "scene"
    scene.mkdir()
    Image.fromarray(s.rgb_u8).save(scene / "rgb.png")
    (scene / "intrinsic.txt").write_text(TEXT)
    ckpt = tmp_path / "model.pt"
    torch.save(s.model.state_dict(), ckpt)
    # random weights need not cross 0.5: mesh at the grid's median instead
    level = float(1.0 - np.median(s.grid))
    out = tmp_path / "out"
    main([
        "--checkpoint", str(ckpt), "--rgb", str(scene / "rgb.png"),
        "--scale_factor", str(SCALE), "--device", "cpu", "--out", str(out),
        "--threshold", str(level),
    ])
    mesh = load_obj(out / "scene.obj")
    assert len(mesh.vertices) > 0 and len(mesh.faces) > 0
    assert np.all(mesh.vertices.max(axis=0) <= np.asarray(s.config.dims) - 1)


def _served_grid(monkeypatch, argv):
    """Run predict.main(argv) and return the sigmoid grid it meshed:
    implicit_to_mesh is wrapped to also sweep the served model on the grid
    it was handed, as main's own sweep does."""
    import sv3d_tpu_torch.inference.dense_grid as dense_grid

    seen = []
    mesh = dense_grid.implicit_to_mesh

    def recording(ifnet, vox, dims, *args, **kwargs):
        seen.append(evaluate_on_grid(ifnet, vox, dims, transfer_dtype=torch.float32))
        return mesh(ifnet, vox, dims, *args, **kwargs)

    monkeypatch.setattr(dense_grid, "implicit_to_mesh", recording)
    main(argv)
    assert len(seen) == 1
    return seen[0]


def _trainer_checkpoint(model, directory):
    """checkpoints/last of a run that trained model, as the port's trainers
    write it (model, optimizer and step)."""
    from sv3d_tpu_torch.training.checkpoint import CheckpointManager
    from sv3d_tpu_torch.training.state import TrainState

    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    CheckpointManager(directory).save(TrainState(model, opt, step=7), metric=0.5)
    last = directory / "last"
    assert set(torch.load(last, weights_only=True)) == {"model", "optimizer", "step"}
    return last


def test_main_serves_a_trainer_checkpoint(slice_run, tmp_path, monkeypatch):
    """predict --checkpoint <run>/checkpoints/last (a trainer's checkpoint)
    serves the model it holds: the same logits as the bare state_dict of that
    model, on --rgb (CPU)."""
    from PIL import Image

    s = slice_run
    scene = tmp_path / "scene"
    scene.mkdir()
    Image.fromarray(s.rgb_u8).save(scene / "rgb.png")
    (scene / "intrinsic.txt").write_text(TEXT)
    bare = tmp_path / "model.pt"
    torch.save(s.model.state_dict(), bare)
    last = _trainer_checkpoint(s.model, tmp_path / "checkpoints")
    grids = [
        _served_grid(monkeypatch, [
            "--checkpoint", str(ckpt), "--rgb", str(scene / "rgb.png"),
            "--scale_factor", str(SCALE), "--device", "cpu", "--out", str(tmp_path / out)])
        for ckpt, out in ((last, "trained"), (bare, "bare"))
    ]
    assert grids[0].shape == s.config.dims
    np.testing.assert_array_equal(grids[0], grids[1])
    np.testing.assert_array_equal(grids[0], s.grid)
    assert (tmp_path / "trained" / "scene.obj").exists()


def test_main_serves_a_skip_unet_trainer_checkpoint(tmp_path, monkeypatch):
    """A --skip_unet run's checkpoints/last serves --distance EXRs (written
    by the port's io/exr.py): the same logits as its bare state_dict (CPU)."""
    from sv3d_tpu_torch.config import Config as TConfig
    from sv3d_tpu_torch.io.exr import write_exr

    config = TConfig(scale_factor=SCALE, skip_unet=True, seed=0)
    ti = parse_intrinsics(TEXT)
    torch.manual_seed(0)
    model = SceneNet(config, ti, FrustumGrid.create(ti, voxel_size=0.05 * SCALE)).eval()
    assert not any(k.startswith("unet.") for k in model.state_dict())
    rng = np.random.default_rng(6)
    write_exr(tmp_path / "distance.exr",
              {"R": rng.uniform(1.0, 4.0, (240, 320)).astype(np.float32)})
    (tmp_path / "intrinsic.txt").write_text(TEXT)
    bare = tmp_path / "model.pt"
    torch.save(model.state_dict(), bare)
    last = _trainer_checkpoint(model, tmp_path / "checkpoints")
    grids = [
        _served_grid(monkeypatch, [
            "--checkpoint", str(ckpt), "--distance", str(tmp_path / "distance.exr"),
            "--skip_unet", "--scale_factor", str(SCALE), "--device", "cpu",
            "--out", str(tmp_path / out)])
        for ckpt, out in ((last, "trained"), (bare, "bare"))
    ]
    assert grids[0].shape == config.dims and np.isfinite(grids[0]).all()
    np.testing.assert_array_equal(grids[0], grids[1])


def test_main_refuses_an_ifnet_only_checkpoint(tmp_path):
    """An IF-Net-only run's checkpoint holds an IFNet, not a SceneNet: serving
    it fails loudly in load_state_dict, as the JAX package's predict does."""
    from sv3d_tpu_torch.config import Config as TConfig
    from sv3d_tpu_torch.io.exr import write_exr
    from sv3d_tpu_torch.models.ifnet import IFNet

    ifnet = IFNet(TConfig(scale_factor=SCALE).ifnet(), generator=torch.Generator().manual_seed(0))
    last = _trainer_checkpoint(ifnet, tmp_path / "checkpoints")
    (tmp_path / "intrinsic.txt").write_text(TEXT)
    write_exr(tmp_path / "distance.exr", {"R": np.full((240, 320), 2.0, np.float32)})
    with pytest.raises(RuntimeError, match="state_dict"):
        main(["--checkpoint", str(last), "--distance", str(tmp_path / "distance.exr"),
              "--skip_unet", "--scale_factor", str(SCALE), "--device", "cpu",
              "--out", str(tmp_path / "out")])


def test_chip_smoke_serves_a_fit_checkpoint(tmp_path):
    """chip_smoke.py's phase 8b on the CPU at scale_factor 8: the checkpoint
    that SceneNetTrainer.fit writes (checkpoints/last) is served through
    predict.main by checkpoint_serving_phase, which writes a mesh with faces;
    on the CPU no kernel launches (the plain versions run)."""
    import runpy
    from pathlib import Path

    from sv3d_tpu_torch.config import Config as TConfig
    from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"))
    root = write_smoke_dataset(tmp_path / "data", scale_factor=SCALE)
    cfg = TConfig(seed=0, scale_factor=SCALE, batch_size=2, num_points=64,
                  subsample_points=128, fused_query=True, splitsdir="overfit",
                  datasetdir=str(root), sanity_steps=0, experiment="smoke")
    SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "train").fit(max_steps=2)
    got = smoke["checkpoint_serving_phase"](
        tmp_path / "train" / "checkpoints" / "last", root / "raw" / "overfit" / "00000" / "rgb.png",
        root / "intrinsics.txt", tmp_path / "served", device="cpu",
        extra=["--scale_factor", str(SCALE)])
    assert got["faces"] > 0 and 0.0 < got["level"] < 1.0
    assert got["launches"] == {"scatter_voxels": 0, "lattice_sweep_bf16": 0,
                               "lattice_sweep_f32": 0}
