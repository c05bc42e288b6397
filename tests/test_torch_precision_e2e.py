"""Port parity of precision 16 (bf16 mixed precision) end to end: one train
step of each trainer against the JAX package's precision=16 step, and
serving at precision 16.

Each step starts from the same converted f32 weights (the parameters are
f32 at both precisions) and one batch; JAX's step is its trainer's own
jitted step at precision 16.  A bf16 train step at these test sizes is
chaotic: its train-mode BatchNorms divide by statistics of bf16
activations, so one-ulp conv differences move whole channels, and end to
end the predicted depth moves by centimetres, which moves projected points
across voxel boundaries and the voxel grid's gradient with them (the port's
own bf16 step, fed an RGB scaled by 1 + 1e-6, moves its UNet gradients as
far as the JAX step is from it).  So the step is held as precision 16 is
itself defined, against JAX's f32 step of the same weights and batch (the
witness) with the error budget of JAX's own bf16 step:

- the loss and metrics within LOSS_RTOL (point IoU within POINT_IOU_ATOL);
- each parameter's gradient, f32: ||g_port16 - g_jax32|| <= GRAD_BUDGET *
  ||g_jax16 - g_jax32|| + GRAD_FLOOR * ||g_jax32|| (measured up to 2.7 for
  the end-to-end step's one-element fc_out bias, 2.0 elsewhere there, 0.9
  for the IF-Net-only step and 1.4 for the UNet-only steps: independent
  rounding noise of one size gives about sqrt(2));
- every parameter after one Adam step within 2 lr of JAX's (Adam's first
  step is about lr * sign(g)), and equal to JAX's (1e-6) in at least the
  stated share of all elements (measured 0.83 end to end, 0.99 IF-Net-only,
  0.99 UNetMini, 0.90 UNet);
- the BatchNorm running statistics (f32) within STATS_ULPS bf16 ulps of
  their scale, as max and mean (measured up to 1.09 / 0.26).

Serving at precision 16 (eval mode, where the two packages agree closely):
the slice against JAX's, predict.main --precision 16 on the CPU, and a
precision-16 trainer's checkpoint served at 16 and at 32.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import Config as JConfig
from sv3d_tpu.geometry.camera import parse_intrinsics as j_parse_intrinsics
from sv3d_tpu.geometry.frustum import FrustumGrid as JFrustumGrid
from sv3d_tpu.inference.dense_grid import evaluate_on_grid as j_evaluate_on_grid
from sv3d_tpu.inference.predict import predict as j_predict
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.models.scene_net import SceneNet as JSceneNet
from sv3d_tpu.models.unet import UNet as JUNet
from sv3d_tpu.models.unet import UNetMini as JUNetMini
from sv3d_tpu.training.optim import build_optimizer as j_build_optimizer
from sv3d_tpu.training.state import create_train_state
from sv3d_tpu.training.trainer_ifnet import ImplicitRefinementTrainer as JIFNetTrainer
from sv3d_tpu.training.trainer_ifnet import make_train_step as j_ifnet_step
from sv3d_tpu.training.trainer_scene_net import make_train_step as j_scene_step
from sv3d_tpu.training.trainer_unet import DepthRegressorTrainer as JUNetTrainer
from sv3d_tpu.training.trainer_unet import depth_forward as j_depth_forward
from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.data.loader import collate
from sv3d_tpu_torch.geometry.camera import parse_intrinsics
from sv3d_tpu_torch.geometry.frustum import FrustumGrid
from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid
from sv3d_tpu_torch.inference.predict import predict
from sv3d_tpu_torch.models.scene_net import SceneNet
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
from sv3d_tpu_torch.training.trainer_ifnet import ImplicitRefinementTrainer
from sv3d_tpu_torch.training.trainer_scene_net import to_device, train_step
from sv3d_tpu_torch.training.trainer_unet import DepthRegressorTrainer
from test_torch_precision import assert_ulps
from test_torch_predict import SCALE, TEXT, _served_grid
from test_torch_trainer_ifnet import _jax_grads as ifnet_jax_grads
from test_torch_trainer_ifnet import _processed_tree
from test_torch_training import _TENSORS, LR, _inputs, _jax_grads, _jax_net, _port_state
from test_torch_unet import randomized

torch.set_num_threads(1)

LOSS_RTOL = 1e-2
# point IoU counts the logits above 0 among B x N = 128 points: a logit
# within bf16 noise of 0 may fall either side, and each moves it by ~0.008
POINT_IOU_ATOL = 0.02
GRAD_BUDGET = 3.0
GRAD_FLOOR = 2e-2
STATS_ULPS = (4.0, 0.5)


def compare_bf16_step(model, metrics, jnew, jmetrics, jgrads16, jgrads32, same_min, lr=LR):
    """The port's precision-16 step (model after the step with its .grad,
    metrics) against JAX's (jnew: its new state, jmetrics, jgrads16 mapped
    by from_flax) and JAX's f32 gradients of the same step (jgrads32)."""
    for k, v in jmetrics.items():
        atol = POINT_IOU_ATOL if k.endswith("point_iou") else 1e-6
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=LOSS_RTOL, atol=atol,
                                   err_msg=k)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads16) == set(jgrads32)
    norm = lambda a: float(np.linalg.norm(np.asarray(a, np.float64)))
    for name, p in named.items():
        assert p.dtype == p.grad.dtype == torch.float32, name
        got, want, witness = p.grad.numpy(), jgrads16[name], jgrads32[name]
        assert norm(got - witness) <= (GRAD_BUDGET * norm(want - witness)
                                       + GRAD_FLOOR * norm(witness)), name
    want = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jnew.params, "batch_stats": jnew.batch_stats}))
    sd = model.state_dict()
    same = total = 0
    for k, v in want.items():
        got, v = sd[k].numpy(), v.numpy()
        if k in named:
            step = lr * (10 if k.startswith("project.") else 1)
            assert (np.abs(got - v) <= 2 * step + 1e-6).all(), (k, np.abs(got - v).max())
            same += int((np.abs(got - v) <= 1e-6).sum())
            total += got.size
        elif k.endswith(("running_mean", "running_var")):
            assert sd[k].dtype == torch.float32, k
            assert_ulps(got, v, *STATS_ULPS, k)
    assert same / total >= same_min, same / total


@pytest.fixture(scope="module")
def scene16():
    """JAX's precision-16 end-to-end step (UNetMini, B=2, scale_factor 8),
    its bf16 and the f32 gradients of the same step."""
    cfg = JConfig(seed=0, scale_factor=8, batch_size=2, lr=LR, precision=16)
    batch = _inputs()
    jm, variables = _jax_net(cfg, batch, seed=11)
    jstate = create_train_state(jm, variables, j_build_optimizer(cfg.lr, variables["params"]))
    jb = [jnp.asarray(batch[k]) for k in _TENSORS]
    key = jax.random.PRNGKey(1)
    jnew, jmetrics = j_scene_step(jm, cfg)(jstate, *jb, key)
    cfg32 = cfg.replace(precision=32)
    return SimpleNamespace(
        batch=batch, variables=variables, jnew=jnew, jmetrics=jmetrics,
        jgrads16=_jax_grads(jm, cfg, jstate, jb, key),
        jgrads32=_jax_grads(_jax_net(cfg32, batch, seed=11)[0], cfg32, jstate, jb, key))


@pytest.mark.parametrize("fused", [False, True])
def test_scene_step_matches_jax_precision16(scene16, fused):
    """SceneNet end to end against JAX's exact-path step at precision 16.
    The port's fused_query step (plain K4/K7/K8 on the boundary-widened
    pyramid) is held to the same step."""
    s = scene16
    pcfg = Config(seed=0, scale_factor=8, batch_size=2, lr=LR, precision=16, fused_query=fused)
    state = _port_state(pcfg, s.variables)
    assert state.model.unet.dtype == state.model.ifnet.dtype == torch.bfloat16
    metrics = train_step(state, to_device(s.batch, "cpu", _TENSORS), pcfg)
    compare_bf16_step(state.model, metrics, s.jnew, s.jmetrics, s.jgrads16, s.jgrads32, 0.75)


def test_ifnet_step_matches_jax_precision16(tmp_path):
    """The IF-Net-only step (fused_query, B=2, scale_factor 8) on a batch of
    the preprocessed box tree, against JAX's trainer's step at precision 16."""
    root = _processed_tree(tmp_path / "tree", 8)
    kw = dict(seed=0, scale_factor=8, batch_size=2, num_points=64, lr=LR, precision=16,
              fused_query=True, datasetdir=str(root), splitsdir="overfit")
    jtrainer = JIFNetTrainer(JConfig(**kw), experiment_dir=tmp_path / "jax")
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, 5)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    trainer = ImplicitRefinementTrainer(Config(**kw), device="cpu",
                                        experiment_dir=tmp_path / "port")
    ds = trainer.train_dataset()
    batch = collate([ds[0], ds[1]])
    keys = ("input", "points", "occupancies")
    jnew, jmetrics = j_ifnet_step(jtrainer.model)(jstate, *(jnp.asarray(batch[k]) for k in keys))
    jgrads16 = ifnet_jax_grads(jtrainer.model, jstate, batch)
    jgrads32 = ifnet_jax_grads(JIFNet(JConfig(**kw).ifnet()), jstate, batch)

    state = trainer.build_state()
    assert state.model.dtype == torch.bfloat16
    state.model.load_state_dict(from_flax(variables))
    metrics = trainer.train_step(state, batch, trainer.generator)
    compare_bf16_step(state.model, metrics, jnew, jmetrics, jgrads16, jgrads32, 0.95)


@pytest.mark.parametrize("resize_input", [False, True], ids=["UNetMini", "UNet"])
def test_unet_step_matches_jax_precision16(tmp_path, resize_input):
    """The UNet-only step (B=2; UNet at W = 256) against JAX's trainer's step
    at precision 16, whose depth_forward widens the bf16 logits to f32."""
    root = write_smoke_dataset(tmp_path / "tree", scale_factor=8, n_points=200)
    kw = dict(seed=0, batch_size=2, lr=LR, precision=16, resize_input=resize_input, W=256,
              datasetdir=str(root), splitsdir="overfit")
    jtrainer = JUNetTrainer(JConfig(**kw), experiment_dir=tmp_path / "jax")
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, 7)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    trainer = DepthRegressorTrainer(Config(**kw), device="cpu", experiment_dir=tmp_path / "port")
    ds = trainer.train_dataset()
    batch = collate([ds[0], ds[1]])
    rgb, target = jnp.asarray(batch["input"]), jnp.asarray(batch["target"])
    jnew, jmetrics = jtrainer._train_step(jstate, rgb, target)

    def grads(model):
        def loss_fn(params):
            depth, _ = j_depth_forward(model, jtrainer.config,
                                       {"params": params, "batch_stats": jstate.batch_stats},
                                       rgb, True)
            return jnp.mean((depth - target) ** 2)

        g = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(jstate.params))
        return {k: v.numpy() for k, v in from_flax({"params": g}).items()}

    jgrads16 = grads(jtrainer.model)
    jgrads32 = grads((JUNet if resize_input else JUNetMini)(channels_out=1))

    state = trainer.build_state()
    assert state.model.dtype == torch.bfloat16
    state.model.load_state_dict(from_flax(variables))
    metrics = trainer.train_step(state, batch, trainer.generator)
    compare_bf16_step(state.model, metrics, jnew, jmetrics, jgrads16, jgrads32,
                      0.85 if resize_input else 0.95)


# -- serving at precision 16 --------------------------------------------------

@pytest.fixture(scope="module")
def serve16():
    """The serving slice at precision 16, scale_factor 8 (dims (17, 13, 14)),
    in both packages from the same converted weights: depth, voxel grid and
    the bf16 sweep's sigmoid grid."""
    config = JConfig(scale_factor=SCALE, seed=0, precision=16)
    ji = j_parse_intrinsics(TEXT)
    jmodel = JSceneNet(config, ji, JFrustumGrid.create(ji, voxel_size=0.05 * SCALE))
    init = jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, 240, 320, 3)), jnp.full((1, 240, 320), 2.0), jnp.zeros((1, 8, 3)),
        train=False))
    fresh = init(jax.random.PRNGKey(0))
    # a precision-16 flax model's variables are f32: convert.from_flax takes
    # them unchanged into the port's precision-16 SceneNet (strict load below)
    assert all(v.dtype == jnp.float32 for v in jax.tree_util.tree_leaves(fresh))
    variables = randomized(fresh, 3)
    rgb_u8 = np.random.default_rng(4).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    rgb = ((rgb_u8 / np.float32(255.0) - 0.5) / 0.5).astype(np.float32)
    jvox, jdepth = j_predict(config, jmodel, SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]), rgb=rgb)
    ifv = {"params": variables["params"]["ifnet"],
           "batch_stats": variables["batch_stats"]["ifnet"]}
    jgrid = j_evaluate_on_grid(JIFNet(config.ifnet(), dtype=jnp.bfloat16), ifv, jvox,
                               config.dims, transfer_dtype=jnp.float32)

    tconfig = Config(scale_factor=SCALE, seed=0, precision=16)
    ti = parse_intrinsics(TEXT)
    model = SceneNet(tconfig, ti, FrustumGrid.create(ti, voxel_size=0.05 * SCALE))
    model.load_state_dict(from_flax(variables))
    model.eval()
    vox, depth = predict(tconfig, model, rgb=rgb)
    grid = evaluate_on_grid(model.ifnet, vox, tconfig.dims, transfer_dtype=torch.float32)
    # the port's sweep on JAX's voxel grid: the IF-Net apart from the depth
    grid_on_jvox = evaluate_on_grid(model.ifnet, torch.tensor(np.asarray(jvox)), tconfig.dims,
                                    transfer_dtype=torch.float32)
    return SimpleNamespace(config=tconfig, model=model, rgb_u8=rgb_u8, jdepth=np.asarray(jdepth),
                           jvox=np.asarray(jvox), jgrid=np.asarray(jgrid), depth=depth,
                           vox=vox.numpy(), grid=grid, grid_on_jvox=grid_on_jvox)


def test_serving_slice_matches_jax_precision16(serve16):
    """The depth (bf16 UNet, eval mode) within 0.03 m, about 2 bf16 ulps of
    a unit logit through the sigmoid's slope and the depth range (measured
    0.0082); the voxel grid within 1e-2 (measured 3.4e-3); the sigmoid grid
    of the bf16 sweep on the bf16 pyramid within the JAX package's
    mixed-precision bound 2e-2 (measured 3.6e-4), and on JAX's own voxel
    grid within 2e-3, the bound of the unfused bf16 sweeps in
    tests/test_torch_ifnet.py (measured 3.0e-4)."""
    s = serve16
    assert s.config.dims == (17, 13, 14) and s.vox.max() > 0.1
    assert s.depth.dtype == np.float32 and s.grid.shape == s.config.dims
    np.testing.assert_allclose(s.depth, s.jdepth, atol=0.03)
    np.testing.assert_allclose(s.vox, s.jvox, atol=1e-2)
    np.testing.assert_allclose(s.grid, s.jgrid, atol=2e-2)
    np.testing.assert_allclose(s.grid_on_jvox, s.jgrid, atol=2e-3)


def _scene_dir(tmp_path, rgb_u8):
    from PIL import Image

    scene = tmp_path / "scene"
    scene.mkdir()
    Image.fromarray(rgb_u8).save(scene / "rgb.png")
    (scene / "intrinsic.txt").write_text(TEXT)
    return scene / "rgb.png"


def test_main_precision16_writes_a_mesh(serve16, tmp_path, monkeypatch):
    """predict.main --precision 16 --device cpu serves the model's
    state_dict: it meshes the grid that evaluate_on_grid gives the
    precision-16 model, and writes an OBJ with faces."""
    from sv3d_tpu_torch.io.mesh import load_obj

    s = serve16
    rgb = _scene_dir(tmp_path, s.rgb_u8)
    ckpt = tmp_path / "model.pt"
    torch.save(s.model.state_dict(), ckpt)
    level = float(1.0 - np.median(s.grid))  # random weights need not cross 0.5
    grid = _served_grid(monkeypatch, [
        "--checkpoint", str(ckpt), "--rgb", str(rgb), "--precision", "16",
        "--scale_factor", str(SCALE), "--device", "cpu", "--out", str(tmp_path / "out"),
        "--threshold", str(level)])
    np.testing.assert_array_equal(grid, s.grid)
    mesh = load_obj(tmp_path / "out" / "scene.obj")
    assert len(mesh.vertices) > 0 and len(mesh.faces) > 0


def test_precision16_trainer_checkpoint_serves_at_16_and_32(tmp_path, monkeypatch):
    """A precision-16 SceneNetTrainer's checkpoints/last (one fused_query step
    on the smoke tree) serves at --precision 16 and at --precision 32: the
    parameters are f32 at both precisions, so the same checkpoint loads into
    either model; the two grids agree within the JAX package's
    mixed-precision bound 2e-2 and both are meshed."""
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    root = write_smoke_dataset(tmp_path / "data", scale_factor=SCALE)
    cfg = Config(seed=0, scale_factor=SCALE, batch_size=2, num_points=64, precision=16,
                 fused_query=True, datasetdir=str(root), sanity_steps=0, experiment="p16")
    state = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "train").fit(
        max_steps=1)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    last = tmp_path / "train" / "checkpoints" / "last"
    grids = {
        prec: _served_grid(monkeypatch, [
            "--checkpoint", str(last), "--rgb", str(root / "raw/overfit/00000/rgb.png"),
            "--intrinsics", str(root / "intrinsics.txt"), "--precision", prec,
            "--scale_factor", str(SCALE), "--device", "cpu", "--out", str(tmp_path / prec)])
        for prec in ("16", "32")
    }
    assert grids["16"].shape == cfg.dims and np.isfinite(grids["16"]).all()
    np.testing.assert_allclose(grids["16"], grids["32"], atol=2e-2)
    assert not np.array_equal(grids["16"], grids["32"])
    for prec in grids:
        assert (tmp_path / prec / "00000.obj").exists()
