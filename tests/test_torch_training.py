"""Port parity of the end-to-end training slice (sv3d_tpu_torch.training)
against the JAX package, and the trainer's repairs.

One SceneNet train step from the same converted weights and batch, against
the JAX package's step in float32 and in float64 (jax_enable_x64, the
witness of the exact gradients): loss and metrics at 1e-5 (f32 summation
orders); gradients mapped by from_flax, the port's float64 ones against
JAX's float64 ones at EXACT_RTOL and the port's f32 ones against JAX's
float64 ones at GRAD_RTOL (tolerances and reasons below); parameters after
one Adam step at 1e-6; BatchNorm statistics at 1e-6 (+ BN_RTOL).  Adam's
first step is lr * g / (|g| + eps), about lr * sign(g): an element whose
gradient lies within twice the gradient tolerance of zero may step either
way, so such elements are held to 2 * lr.  The biases of the UNet convs that
feed a train-mode BatchNorm (chip_smoke.BN_FED_BIASES) have a gradient that
is exactly 0 in exact arithmetic; both frameworks compute rounding residue
there, held to 1e-4 (float32) and 1e-12 (float64) of their weight's
gradient.

The one-scene dataset tree is box_scene.write_smoke_dataset's, at a small
point count and scale_factor 8, which keeps the grids at (17, 13, 14).
"""

import importlib.util
import json
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import Config
from sv3d_tpu.data.loader import collate
from sv3d_tpu.data.splits import write_split
from sv3d_tpu.geometry import FrustumGrid as JFrustumGrid
from sv3d_tpu.geometry import parse_intrinsics as j_parse_intrinsics
from sv3d_tpu.models.scene_net import SceneNet as JSceneNet
from sv3d_tpu.models.unet import renormalize_depth as j_renormalize_depth
from sv3d_tpu.preprocessing.occupancies import determine_occupancy as j_determine_occupancy
from sv3d_tpu.training.optim import build_optimizer as j_build_optimizer
from sv3d_tpu.training.state import create_train_state
from sv3d_tpu.training.trainer_scene_net import SceneNetTrainer as JSceneNetTrainer
from sv3d_tpu.training.trainer_scene_net import make_train_step, scene_losses as j_scene_losses
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.geometry import FrustumGrid, parse_intrinsics
from sv3d_tpu_torch.models.scene_net import SceneNet
from sv3d_tpu_torch.preprocessing.occupancies import determine_occupancy
from sv3d_tpu_torch.quality import box_scene
from sv3d_tpu_torch.training.checkpoint import load_pretrained_unet, load_state_from_checkpoint
from sv3d_tpu_torch.training.cli import parse_config
from sv3d_tpu_torch.training.optim import build_optimizer
from sv3d_tpu_torch.training.state import TrainState
from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer, to_device, train_step
from test_torch_unet import randomized

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LR = 1e-4
_TENSORS = ("rgb", "depthmap_target", "points", "occupancies")
# Each bound is a fraction of the reference tensor's largest magnitude.
# The port's float64 gradients against JAX's float64 ones: the same exact
# step in two frameworks (measured up to 7.9e-13).
EXACT_RTOL = 1e-9
# The port's f32 gradients against JAX's float64 ones: f32 rounding through
# one step (measured up to 2.4e-4).  The small test grid makes the step
# ill-conditioned: its two deepest IF-Net levels hold 2 and 1 voxels, so
# their train-mode BatchNorm normalizes over 4 and 2 values per channel.
# JAX's own f32 gradients of this step are up to 1.8e-2 from its float64
# ones (fc0; its deepest level's features carry 1.6e-4 relative error),
# which is why the port's f32 step is held to JAX's f32 step only at
# JAX_GRAD_RTOL, and JAX's f32 step to its float64 step at the same bound.
GRAD_RTOL = 3e-4
JAX_GRAD_RTOL = 5e-2
# The gradients of the UNet and of sigma come back through the gradient of
# the voxel grid, which is discontinuous twice: the smoothed grid's clamp
# passes the gradient at exactly 1.0 (common in saturated regions in f32,
# not in f64), and the scatter's backward jumps where a point's grid
# coordinate crosses a voxel boundary, which the ~1e-7 relative f32/f64 depth
# difference does for a few of the 153,600 projected points.  Measured up to
# 1.02e-2 of the largest gradient (against JAX's float64 step).
GRID_GRAD_RTOL = 2e-2
# BatchNorm statistics after the step: 1e-6, plus 1e-5 relative because the
# IF-Net's input grid carries the UNet's ~1e-6 relative depth difference
# (two conv implementations) into the encoder's batch statistics.
BN_RTOL = 1e-5


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    root = box_scene.write_smoke_dataset(tmp_path_factory.mktemp("smoke"), scale_factor=8,
                                         n_points=2000)
    write_split(root, "overfit", "test", ["00000"])
    return root


def port_config(cfg, **kw):
    """The port's Config with the fields of cfg (the JAX package's, field for
    field; the port's decoder fields, which it lacks, at their defaults),
    replaced by kw: the port's Config.dtype is a torch dtype."""
    from dataclasses import fields

    from sv3d_tpu_torch.config import Config as PortConfig

    return PortConfig(**{**{f.name: getattr(cfg, f.name) for f in fields(PortConfig)
                            if hasattr(cfg, f.name)}, **kw})


def _inputs(b=2, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "rgb": rng.uniform(-1, 1, (b, 240, 320, 3)).astype(np.float32),
        "depthmap_target": rng.uniform(0.5, 5.5, (b, 240, 320)).astype(np.float32),
        "points": rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32),
        "occupancies": (rng.uniform(0, 1, (b, n)) > 0.5).astype(np.float32),
    }


def _jax_net(cfg, batch, seed):
    intr = j_parse_intrinsics(box_scene.INTRINSICS)
    jm = JSceneNet(cfg, intr, JFrustumGrid.create(intr, voxel_size=0.05 * cfg.scale_factor))
    init = jax.jit(lambda k: jm.init(k, *(jnp.asarray(batch[k][:1]) for k in
                                          ("rgb", "depthmap_target", "points")), train=False,
                                     subsample_rng=jax.random.PRNGKey(0)))
    return jm, randomized(init(jax.random.PRNGKey(0)), seed)


def _port_state(cfg, variables):
    intr = parse_intrinsics(box_scene.INTRINSICS)
    model = SceneNet(cfg, intr, FrustumGrid.create(intr, voxel_size=0.05 * cfg.scale_factor))
    model.load_state_dict(from_flax(variables))
    return TrainState(model, build_optimizer(cfg.lr, model))


def _jax_scene_f64(m, rgb, dt, pts, key):
    """JAX SceneNet.__call__ in train mode with the UNet's output kept in
    float64 (predict_depth casts it to float32, which would round the depth
    of an otherwise float64 step)."""
    cfg = m.config
    assert not cfg.resize_input
    if cfg.skip_unet:
        depth = dt
    else:
        depth = j_renormalize_depth(m.unet(rgb, train=True)[..., 0], cfg.min_z, cfg.max_z)
    pc = m.project_depth(depth)
    grid = m.project(pc)
    if cfg.subsample_points > 0:
        idx = jax.random.permutation(key, pc.shape[1])[: cfg.subsample_points]
        pts = jnp.concatenate([pc[:, idx], pts], axis=1)
    return m.ifnet(grid, pts, train=True), depth, None


def _jax_grads(jm, cfg, jstate, inputs, key, x64=False) -> dict:
    """The gradients of JAX's step (its loss_and_grads, microbatch by
    microbatch as its scan runs them, averaged), mapped by from_flax; with
    x64, of the same step in float64.  Without subsampling, the key is
    unused; with it, only accum_steps == 1 is compared."""

    def loss_fn(params, stats, rgb, dt, pts, occ):
        variables = {"params": params, "batch_stats": stats}
        if x64:
            (logits, depth, _), mutated = jm.apply(variables, rgb, dt, pts, key,
                                                   method=_jax_scene_f64, mutable=["batch_stats"])
        else:
            (logits, depth, _), mutated = jm.apply(variables, rgb, dt, pts, train=True,
                                                   subsample_rng=key, mutable=["batch_stats"])
        return j_scene_losses(cfg, logits, occ, depth, dt, params)[0], mutated

    with jax.enable_x64(x64):
        dtype = np.float64 if x64 else np.float32
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        params, stats, inputs = cast(jstate.params), cast(jstate.batch_stats), cast(list(inputs))
        grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
        accum = max(cfg.accum_steps, 1)
        m = inputs[0].shape[0] // accum
        grads = []
        for i in range(accum):
            g, mutated = grad_fn(params, stats, *(x[i * m:(i + 1) * m] for x in inputs))
            grads.append(g)
            stats = mutated["batch_stats"]
        mean = jax.tree_util.tree_map(lambda *gs: np.asarray(sum(gs) / accum), *grads)
    return {k: v.numpy() for k, v in from_flax({"params": mean}, dtype).items()}


def _f64_grads(cfg, variables, batch, subsample_idx=None, label_fn=None) -> dict:
    """The port's gradients of the same step in float64 (plain versions)."""
    state = _port_state(cfg, variables)
    state.model.double()
    b64 = {k: torch.tensor(v, dtype=torch.float64) if k in _TENSORS else v
           for k, v in batch.items()}
    train_step(state, b64, cfg, subsample_idx, label_fn)
    return {n: p.grad.numpy() for n, p in state.model.named_parameters()}


def _compare_step(state, metrics, jstate, jmetrics, jgrads, jgrads64, grads64,
                  grad_rtol=GRAD_RTOL, bn_fed=chip_smoke.BN_FED_BIASES):
    """The port's f32 step (state, metrics) and float64 gradients (grads64)
    against JAX's step: its new state and metrics, and its f32 and float64
    gradients (the IF-Net's f32 ones at grad_rtol).  bn_fed: the conv biases
    that feed a train-mode BatchNorm."""
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-5, err_msg=k)
    named = dict(state.model.named_parameters())
    assert set(jgrads) == set(jgrads64) == set(named) == set(grads64)
    # a tensor whose gradient is ~0 is compared on the scale of the whole step
    scale = max(np.abs(g).max() for g in jgrads64.values())
    floor = 1e-6 * scale
    certain = {}  # elements whose gradient sign both frameworks must share
    for name, p in named.items():
        got, want, exact = p.grad.numpy(), jgrads[name], jgrads64[name]
        if name in bn_fed:
            weight_g = np.abs(jgrads64[name[: -len("bias")] + "weight"]).max()
            assert max(np.abs(got).max(), np.abs(want).max()) <= 1e-4 * weight_g, name
            assert max(np.abs(grads64[name]).max(), np.abs(exact).max()) <= 1e-12 * weight_g, name
            certain[name] = np.zeros(want.shape, bool)
            continue
        np.testing.assert_allclose(grads64[name], exact,
                                   atol=EXACT_RTOL * np.abs(exact).max() + 1e-12 * scale,
                                   err_msg=name)
        rtol = GRID_GRAD_RTOL if name.startswith(("unet.", "project.")) else grad_rtol
        np.testing.assert_allclose(got, exact, atol=rtol * np.abs(exact).max() + floor,
                                   err_msg=name)
        tol = JAX_GRAD_RTOL * np.abs(exact).max() + floor
        np.testing.assert_allclose(want, exact, atol=tol, err_msg=name)
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)
        certain[name] = np.abs(want) > 2 * tol
    want = from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    sd = state.model.state_dict()
    for k, v in want.items():
        got, v = sd[k].numpy(), v.numpy()
        if k in certain:  # Adam's first step is about lr * sign(g)
            lr = LR * (10 if k.startswith("project.") else 1)
            tol = np.where(certain[k], 1e-6, 2 * lr + 1e-6)
            assert (np.abs(got - v) <= tol).all(), (k, np.abs(got - v).max())
        elif v.dtype.kind == "f":  # BatchNorm statistics (flax keeps no batch count)
            np.testing.assert_allclose(got, v, rtol=BN_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("accum,fused", [(1, False), (2, True)])
def test_train_step_matches_jax(accum, fused):
    """UNet on, B=2, against JAX's exact (gather-path) step; the port's f32
    fused path (plain K4/K7/K8 here) must give the same step."""
    cfg = Config(seed=0, scale_factor=8, batch_size=2, accum_steps=accum, lr=LR)
    batch = _inputs()
    jm, variables = _jax_net(cfg, batch, seed=11)
    jstate = create_train_state(jm, variables, j_build_optimizer(cfg.lr, variables["params"]))
    jb = [jnp.asarray(batch[k]) for k in ("rgb", "depthmap_target", "points", "occupancies")]
    key = jax.random.PRNGKey(1)
    new_jstate, jmetrics = make_train_step(jm, cfg)(jstate, *jb, key)

    jgrads = _jax_grads(jm, cfg, jstate, jb, key)
    jgrads64 = _jax_grads(jm, cfg, jstate, jb, key, x64=True)

    pcfg = cfg.replace(fused_query=fused)
    state = _port_state(pcfg, variables)
    metrics = train_step(state, to_device(batch, "cpu", _TENSORS), pcfg)
    assert state.step == 1
    _compare_step(state, metrics, new_jstate, jmetrics, jgrads, jgrads64,
                  _f64_grads(pcfg, variables, batch))


def test_subsample_step_matches_jax(smoke_data, tmp_path):
    """skip_unet with subsample_points: the same subsample (JAX's permutation
    passed in), the same host labels (JAX's _occupancies_with_pc, flip_aug
    mirror-back on the flipped row), the same step."""
    cfg = Config(seed=0, scale_factor=8, batch_size=2, num_points=64, subsample_points=256,
                 skip_unet=True, flip_aug=True, lr=LR, datasetdir=str(smoke_data))
    jtrainer = JSceneNetTrainer(cfg, experiment_dir=tmp_path / "jax")
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    ds = jtrainer.train_dataset()
    batch = collate([dict(ds[0], flipped=np.float32(0.0)), dict(ds[1], flipped=np.float32(1.0))])
    key = jax.random.PRNGKey(1)
    jocc = np.asarray(jtrainer._occupancies_with_pc(jstate, batch, key))
    new_jstate, jmetrics = jtrainer._train_step(
        jstate, batch["rgb"], batch["depthmap_target"], batch["points"], jocc, key)

    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "port")
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = _port_state(cfg, variables)
    idx = torch.tensor(np.asarray(jax.random.permutation(key, 240 * 320)[:256]))
    labels = []

    def label_fn(pc, b):
        labels.append(trainer.label_cloud(pc, b))
        return labels[-1]

    metrics = train_step(state, to_device(batch, "cpu", _TENSORS), cfg, [idx], label_fn)
    np.testing.assert_array_equal(labels[0].numpy(), jocc[:, :256])
    assert 0 < labels[0].mean() < 1
    jb = [jnp.asarray(batch[k]) for k in ("rgb", "depthmap_target", "points")] + [jnp.asarray(jocc)]
    jgrads = _jax_grads(jtrainer.model, cfg, jstate, jb, key)
    jgrads64 = _jax_grads(jtrainer.model, cfg, jstate, jb, key, x64=True)
    grads64 = _f64_grads(cfg, variables, batch, [idx], lambda pc, b: labels[0].to(pc))
    _compare_step(state, metrics, new_jstate, jmetrics, jgrads, jgrads64, grads64)


def test_train_step_labels_the_queried_cloud(smoke_data, tmp_path):
    """With the UNet on, the labels the step uses are those of the projected
    points that its own train-mode forward queried.  The eval-mode cloud (the
    one the JAX package's separate projection pass labels) is another cloud."""
    cfg = Config(seed=0, scale_factor=8, batch_size=2, num_points=64, subsample_points=256,
                 datasetdir=str(smoke_data))
    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "exp")
    state = trainer.build_state()
    ds = trainer.train_dataset()
    batch = collate([ds[0], ds[1]])
    idx = torch.randperm(240 * 320, generator=torch.Generator().manual_seed(3))[:256]
    with torch.no_grad():
        state.model.eval()
        rgb = torch.tensor(batch["rgb"])
        pc_eval = state.model.project_depth(state.model.predict_depth(rgb))[:, idx]

    queried, used = [], []
    hook = state.model.ifnet.register_forward_pre_hook(
        lambda mod, args: queried.append(args[1].detach().clone()))
    label_fn = lambda pc, b: used.append(trainer.label_cloud(pc, b)) or used[-1]
    train_step(state, to_device(batch, "cpu", _TENSORS), cfg, [idx], label_fn)
    hook.remove()

    pc_queried = queried[0][:, :256]
    _, want = determine_occupancy(batch["mesh"], pc_queried.numpy(), dims=cfg.dims)
    np.testing.assert_array_equal(used[0].numpy(), want)
    assert float((pc_queried - pc_eval).abs().max()) > 1e-3


def test_determine_occupancy_matches_jax(smoke_data):
    mesh = [str(smoke_data / "raw" / "overfit" / "00000" / "mesh.obj")] * 2
    pts = np.random.default_rng(4).uniform(-0.6, 0.6, (2, 3000, 3))
    dims = (17, 13, 14)
    got = determine_occupancy(mesh, pts, dims=dims)[1]
    assert 20 < got.sum() < got.size / 2
    np.testing.assert_array_equal(got, j_determine_occupancy(mesh, pts, dims=dims)[1])


class _WideConfig(Config):
    """A configuration whose images are 640 wide."""

    def projection(self):
        return replace(super().projection(), image_size=(640, 480))


def test_flip_mirror_check_takes_the_image_width_from_the_config(smoke_data, tmp_path):
    wide = tmp_path / "wide"
    wide.mkdir()
    (wide / "intrinsics.txt").write_text(box_scene.INTRINSICS.replace("159.5", "319.5"))
    trainer = SceneNetTrainer(_WideConfig(seed=0, flip_aug=True, datasetdir=str(wide)),
                              device="cpu", experiment_dir=tmp_path / "a")
    assert np.isfinite(trainer._flip_x_about())
    trainer = SceneNetTrainer(_WideConfig(seed=0, flip_aug=True, datasetdir=str(smoke_data)),
                              device="cpu", experiment_dir=tmp_path / "b")
    with pytest.raises(ValueError, match="W=640"):
        trainer._flip_x_about()
    trainer = SceneNetTrainer(Config(seed=0, flip_aug=True, datasetdir=str(smoke_data)),
                              device="cpu", experiment_dir=tmp_path / "c")
    jtrainer = JSceneNetTrainer(Config(seed=0, flip_aug=True, datasetdir=str(smoke_data)),
                                experiment_dir=tmp_path / "d")
    assert trainer._flip_x_about() == jtrainer._flip_x_about()


def test_fit_checkpoints_resume_and_cli(smoke_data, tmp_path):
    """A 3-step fused_query fit on the written tree (sanity step, one
    validation with visualization, logs, top-k + last), resumed from `last`;
    the UNet warm start; the test split; the CLI."""
    cfg = Config(seed=0, scale_factor=8, batch_size=2, num_points=32, subsample_points=64,
                 fused_query=True, datasetdir=str(smoke_data), sanity_steps=1,
                 val_check_interval=2, visualize=True, experiment="t")
    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "a")
    state = trainer.fit(max_steps=3)
    assert state.step == 3
    recs = [json.loads(x) for x in (tmp_path / "a/logs/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert np.isfinite(recs[0]["train_loss"]) and "val_point_iou" in recs[1]
    ckpts = tmp_path / "a/checkpoints"
    manifest = json.loads((ckpts / "manifest.json").read_text())
    assert manifest["monitor"] == "val_point_iou" and manifest["mode"] == "max"
    assert manifest["last_step"] == 3 and [Path(p).name for _, p in manifest["scores"]] == ["step_2"]
    assert list((tmp_path / "a/vis").glob("*/*_predicted.obj"))

    restored = load_state_from_checkpoint(trainer.build_state(), ckpts / "last")
    assert restored.step == 3
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], v, rtol=0, atol=0)
    resumed = SceneNetTrainer(cfg.replace(resume=str(ckpts / "last"), sanity_steps=0),
                              device="cpu", experiment_dir=tmp_path / "b")
    assert resumed.fit(max_steps=4).step == 4

    warm = load_pretrained_unet(SceneNetTrainer(cfg.replace(seed=1), device="cpu",
                                                experiment_dir=tmp_path / "c").build_state(),
                                ckpts / "last")
    sd = state.model.state_dict()
    for k, v in warm.model.state_dict().items():
        if k.startswith("unet."):
            assert torch.equal(v, sd[k]), k
    assert not torch.equal(warm.model.ifnet.fc0.weight, state.model.ifnet.fc0.weight)

    assert np.isfinite(trainer.test(str(ckpts / "last"), max_batches=1)["val_loss"])

    config, device = parse_config(["--device", "cpu", "--fused_query", "--batch_size", "2",
                                   "--seed", "3"])
    assert device == torch.device("cpu") and config.fused_query and config.batch_size == 2
    for argv in (["--dp", "2"], ["--coordinator_address", "localhost:1234"]):
        with pytest.raises(ValueError, match="torchrun"):
            parse_config(["--device", "cpu", *argv])
    half = SceneNetTrainer(port_config(cfg, precision=16), device="cpu",
                           experiment_dir=tmp_path / "d").build_state()
    assert half.model.unet.dtype == half.model.ifnet.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in half.model.parameters())
