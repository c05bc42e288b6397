"""Port parity of the IF-Net-only trainer (sv3d_tpu_torch.training.
trainer_ifnet) against the JAX package's.

One ImplicitRefinementTrainer step at scale_factor 8 from JAX's weights
carried over by from_flax, on a batch of the tree that the port's
preprocessing pipeline writes from box_scene.write_raw_tree, held as
tests/test_torch_training.py holds the scene step: JAX's exact (gather
path) step in float64 is the witness; the port's float64 gradients at
EXACT_RTOL, its f32 ones at IFNET_GRAD_RTOL; loss, parameters after one
Adam step and BatchNorm statistics as there, against JAX's float64 step
(JAX's f32 step puts the statistics up to 1.1e-5 relative off its float64
step, the port's f32 step 1.2e-7: the binary input grid makes the first
stages' outputs nearly constant, and the one-pass variance cancels).  The
port's fused_query step (plain K4, K7, K8 on the CPU) is held to the same
witness.  Then the eval step's val_ce_loss against JAX's at 1e-5, the GT
mesh at config.dims at scale_factor 2 (the JAX trainer reads the GT
distance field at full resolution there), fit / checkpoint / resume / CLI,
and precision 16."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sv3d_tpu.config import Config
from sv3d_tpu.training.trainer_ifnet import ImplicitRefinementTrainer as JTrainer
from sv3d_tpu.training.trainer_ifnet import make_eval_step, make_train_step
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.data.loader import collate
from sv3d_tpu_torch.io.mesh import load_obj
from sv3d_tpu_torch.preprocessing.process_sample import process_sample_pipeline
from sv3d_tpu_torch.quality.box_scene import write_raw_tree
from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint
from sv3d_tpu_torch.training.trainer_ifnet import TENSORS, ImplicitRefinementTrainer
from sv3d_tpu_torch.training.trainer_ifnet import cli_main, train_step
from test_torch_training import LR, _compare_step, port_config
from test_torch_unet import randomized

torch.set_num_threads(1)

_KEYS = ("input", "points", "occupancies")
# The port's f32 gradients against JAX's float64 ones, as a fraction of each
# tensor's largest magnitude.  The first conv's bias gradient sums 2 x 17 x
# 13 x 14 voxels of its output's gradient with cancellation, so its f32
# error follows the conv backward's summation order: 4.2e-4 with the CPU's
# oneDNN convs, 2.1e-4 with torch's native ones (every other tensor of the
# step within 6e-5); JAX's own f32 step is 5.4e-3 off there.  GRAD_RTOL
# (3e-4), the scene step's bound, sits between the two orders.
IFNET_GRAD_RTOL = 1e-3


def _processed_tree(root, scale_factor):
    write_raw_tree(root)
    processed, quarantined = process_sample_pipeline(
        root / "raw", "overfit", scale_factor, num_samples=2000, seed=0,
        processed_root=root / "processed" / "overfit")
    assert len(processed) == 1 and len(quarantined) == 1
    return root


@pytest.fixture(scope="module")
def tree8(tmp_path_factory):
    return _processed_tree(tmp_path_factory.mktemp("ifnet8"), 8)


def _config(root, **kw):
    return Config(seed=0, scale_factor=8, batch_size=2, num_points=64, lr=LR,
                  datasetdir=str(root), splitsdir="overfit", **kw)


def _jax_state(cfg, tmp_path):
    jtrainer = JTrainer(cfg, experiment_dir=tmp_path / "jax")
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, 5)
    return jtrainer.model, jstate.replace(params=variables["params"],
                                          batch_stats=variables["batch_stats"]), variables


def _batch(cfg, tmp_path):
    ds = ImplicitRefinementTrainer(cfg, device="cpu", experiment_dir=tmp_path / "data").train_dataset()
    return collate([ds[0], ds[1]])


def _jax_grads(jm, jstate, batch, x64=False) -> dict:
    def loss_fn(params, stats, grid, pts, occ):
        logits, mutated = jm.apply({"params": params, "batch_stats": stats}, grid, pts,
                                   train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.sum(optax.sigmoid_binary_cross_entropy(logits, occ), -1)), mutated

    with jax.enable_x64(x64):
        dtype = np.float64 if x64 else np.float32
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        g, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
            cast(jstate.params), cast(jstate.batch_stats), *(cast(batch[k]) for k in _KEYS))
        g = jax.tree_util.tree_map(np.asarray, g)
    return {k: v.numpy() for k, v in from_flax({"params": g}, dtype).items()}


def _jax_step64(jm, jstate, batch):
    """JAX's train step in float64: (new state as numpy arrays, metrics)."""
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        js = jstate.replace(params=cast(jstate.params), batch_stats=cast(jstate.batch_stats),
                            opt_state=cast(jstate.opt_state))
        new, metrics = make_train_step(jm)(js, *(cast(batch[k]) for k in _KEYS))
        return jax.tree_util.tree_map(np.asarray, (new, metrics))


def _port_state(trainer, variables, dtype=torch.float32):
    state = trainer.build_state()
    state.model.load_state_dict(from_flax(variables))
    state.model.to(dtype)
    return state


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_matches_jax(tree8, tmp_path, fused):
    cfg = _config(tree8)
    jm, jstate, variables = _jax_state(cfg, tmp_path)
    batch = _batch(cfg, tmp_path)
    new_jstate, jmetrics = _jax_step64(jm, jstate, batch)
    jgrads = _jax_grads(jm, jstate, batch)
    jgrads64 = _jax_grads(jm, jstate, batch, x64=True)

    trainer = ImplicitRefinementTrainer(cfg.replace(fused_query=fused), device="cpu",
                                        experiment_dir=tmp_path / "port")
    state = _port_state(trainer, variables)
    metrics = trainer.train_step(state, batch, trainer.generator)
    assert state.step == 1 and set(metrics) == {"train_ce_loss"}

    state64 = _port_state(trainer, variables, torch.float64)
    train_step(state64, {k: torch.tensor(np.asarray(batch[k]), dtype=torch.float64)
                         for k in TENSORS})
    grads64 = {n: p.grad.numpy() for n, p in state64.model.named_parameters()}
    _compare_step(state, metrics, new_jstate, jmetrics, jgrads, jgrads64, grads64,
                  IFNET_GRAD_RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_eval_step_matches_jax(tree8, tmp_path, fused):
    cfg = _config(tree8)
    jm, jstate, variables = _jax_state(cfg, tmp_path)
    batch = _batch(cfg, tmp_path)
    want = float(make_eval_step(jm)(jstate, *(jnp.asarray(batch[k]) for k in _KEYS))["val_ce_loss"])
    trainer = ImplicitRefinementTrainer(cfg.replace(fused_query=fused), device="cpu",
                                        experiment_dir=tmp_path / "port")
    got = trainer.eval_step(_port_state(trainer, variables), batch)
    assert set(got) == {"val_ce_loss"}
    np.testing.assert_allclose(float(got["val_ce_loss"]), want, rtol=1e-5)


def test_visualize_writes_the_gt_mesh_at_config_dims(tmp_path):
    """At scale_factor 2 the port reads target.df at dims (70, 52, 56), as
    the prediction; the JAX trainer's dataset reads it at (139, 104, 112)."""
    root = _processed_tree(tmp_path / "tree", 2)
    cfg = Config(seed=0, scale_factor=2, batch_size=1, num_points=64, datasetdir=str(root),
                 splitsdir="overfit")
    trainer = ImplicitRefinementTrainer(cfg, device="cpu", experiment_dir=tmp_path / "exp")
    batch = collate([trainer.val_dataset()[0]])
    assert batch["target"].shape == (1, *cfg.dims, 1)
    assert JTrainer(cfg, experiment_dir=tmp_path / "jax").val_dataset()[0]["target"].shape == (
        139, 104, 112, 1)
    state = trainer.build_state()
    trainer.visualize(state, batch, tmp_path / "vis")
    assert state.model.training
    gt = load_obj(tmp_path / "vis" / "00000" / "00_gt.obj")
    pred = load_obj(tmp_path / "vis" / "00000" / "00_predicted.obj")
    assert len(gt.faces) and len(pred.faces)
    assert (gt.vertices.max(axis=0) <= np.asarray(cfg.dims) - 1).all()
    assert (gt.vertices.min(axis=0) >= 0).all()


def test_fit_checkpoints_resume_and_cli(tree8, tmp_path, monkeypatch):
    """A 4-step fused_query fit (sanity step, two validations with meshes,
    logs, top-k + last), resumed from `last`; the CLI; precision 16."""
    cfg = _config(tree8, fused_query=True, sanity_steps=1, val_check_interval=2,
                  visualize=True)
    trainer = ImplicitRefinementTrainer(cfg, device="cpu", experiment_dir=tmp_path / "a")
    state = trainer.fit(max_steps=4)
    assert state.step == 4
    recs = [json.loads(x) for x in (tmp_path / "a/logs/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 4]
    assert np.isfinite(recs[0]["train_ce_loss"])
    assert [r["step"] for r in recs if "val_ce_loss" in r] == [2, 4]
    ckpts = tmp_path / "a/checkpoints"
    manifest = json.loads((ckpts / "manifest.json").read_text())
    assert manifest["monitor"] == "val_ce_loss" and manifest["mode"] == "min"
    assert manifest["last_step"] == 4
    assert list((tmp_path / "a/vis").glob("*/00000/00_predicted.obj"))
    assert list((tmp_path / "a/vis").glob("*/00000/00_gt.obj"))

    restored = load_state_from_checkpoint(trainer.build_state(), ckpts / "last")
    assert restored.step == 4
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], v, rtol=0, atol=0)
    resumed = ImplicitRefinementTrainer(cfg.replace(resume=str(ckpts / "last"), sanity_steps=0),
                                        device="cpu", experiment_dir=tmp_path / "b")
    assert resumed.fit(max_steps=5).step == 5

    half = ImplicitRefinementTrainer(port_config(cfg, precision=16, sanity_steps=0),
                                     device="cpu", experiment_dir=tmp_path / "c")
    state16 = half.fit(max_steps=1)
    assert state16.model.dtype == torch.bfloat16 and state16.step == 1
    assert all(p.dtype == torch.float32 for p in state16.model.parameters())

    monkeypatch.chdir(tmp_path)  # the CLI's experiment directory is runs/<stamp>_<name>
    cli_main(["--device", "cpu", "--datasetdir", str(tree8), "--splitsdir", "overfit",
              "--scale_factor", "8", "--batch_size", "25", "--num_points", "16", "--seed", "0",
              "--sanity_steps", "0", "--max_epoch", "1", "--val_check_interval", "1.0",
              "--fused_query", "--experiment", "cli"])
    (run,) = (tmp_path / "runs").glob("*_cli")
    assert json.loads((run / "checkpoints/manifest.json").read_text())["last_step"] == 2
