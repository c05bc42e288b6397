"""Port parity of the UNet-only trainer (sv3d_tpu_torch.training.
trainer_unet) against the JAX package's.

One DepthRegressorTrainer step, UNetMini at 240x320 and UNet at W = 256
(resize_input; the 8-level UNet's smallest input), from JAX's weights
carried over by from_flax, on a batch of box_scene.write_smoke_dataset's
tree, held as tests/test_torch_training.py holds the scene step: JAX's step
in float64 is the witness (its depth_forward casts the logits to f32, so
the witness composes the same forward without that cast); the port's
float64 gradients at EXACT_RTOL, its f32 ones at UNET_GRAD_RTOL; the conv biases
that feed a train-mode BatchNorm (exactly 0 in exact arithmetic) at 1e-4 of
their weight's gradient; loss, parameters after one Adam step and BatchNorm
statistics against JAX's float64 step.  Then the written depth_map.exr
against JAX's at 1e-5, the warm start of SceneNetTrainer from a port
UNet-only checkpoint, fit / checkpoint / resume / CLI, and precision 16."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import Config
from sv3d_tpu.models.unet import renormalize_depth as j_renormalize_depth
from sv3d_tpu.models.unet import resize_crop_depth as j_resize_crop_depth
from sv3d_tpu.training.trainer_unet import DepthRegressorTrainer as JTrainer
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.data.loader import collate
from sv3d_tpu_torch.data.splits import write_split
from sv3d_tpu_torch.io.exr import read_exr_channel
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint
from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer
from sv3d_tpu_torch.training.trainer_unet import TENSORS, DepthRegressorTrainer
from sv3d_tpu_torch.training.trainer_unet import cli_main, train_step
from test_torch_training import LR, _compare_step, port_config
from test_torch_unet import randomized

torch.set_num_threads(1)

# The port's f32 gradients against JAX's float64 ones, as a fraction of each
# tensor's largest magnitude.  On the CPU, torch runs the 3x3 convs through
# oneDNN, whose f32 algorithm puts UNetMini's gradients up to 5.5e-4 off
# (torch's native convs: 2.3e-5; JAX's f32 step: 2.4e-6).  The 8-level UNet
# is ill-conditioned at B = 2 (its 1x1 and 2x2 levels' train-mode BatchNorms
# normalize over 2 and 8 values): the port's f32 gradients are 1.3e-3 off,
# JAX's own 8.9e-3.  GRAD_RTOL (3e-4), the scene step's IF-Net bound, holds
# neither.
UNET_GRAD_RTOL = 3e-3

# the conv biases that feed a train-mode BatchNorm, by network
BN_FED = {
    False: tuple(f"{k}.bias" for k in ("down.1", "down.2", "same.0", "same.1", "same.2")),
    True: tuple(f"down.{i}.bias" for i in range(1, 7)) + tuple(f"same.{i}.bias"
                                                                for i in range(7)),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The smoke tree, plus split "one": its scene once (an "overfit" train
    split repeats it 500 times)."""
    root = write_smoke_dataset(tmp_path_factory.mktemp("unet"), scale_factor=8, n_points=200)
    (root / "raw" / "one").symlink_to(root / "raw" / "overfit")
    for split in ("train", "val"):
        write_split(root, "one", split, ["00000"])
    return root


def _config(root, resize_input, **kw):
    return Config(seed=0, batch_size=2, lr=LR, resize_input=resize_input, W=256,
                  datasetdir=str(root), splitsdir="overfit", **kw)


def _jax_state(cfg, tmp_path):
    jtrainer = JTrainer(cfg, experiment_dir=tmp_path / "jax")
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    variables = randomized({"params": jstate.params, "batch_stats": jstate.batch_stats}, 7)
    return jtrainer, jstate.replace(params=variables["params"],
                                    batch_stats=variables["batch_stats"]), variables


def _batch(cfg, tmp_path):
    ds = DepthRegressorTrainer(cfg, device="cpu", experiment_dir=tmp_path / "data").train_dataset()
    return collate([ds[0], ds[1]])


def _jax_step(jtrainer, jstate, batch, x64=False):
    """JAX's train step, float32 or float64, with the logits kept in the
    step's dtype: (gradients mapped by from_flax, new state, metrics)."""
    jm, cfg = jtrainer.model, jtrainer.config

    def loss_fn(params, stats, rgb, target):
        logits, mutated = jm.apply({"params": params, "batch_stats": stats}, rgb, train=True,
                                   mutable=["batch_stats"])
        if cfg.resize_input:
            logits = j_resize_crop_depth(logits)
        depth = j_renormalize_depth(logits[..., 0], cfg.min_z, cfg.max_z)
        return jnp.mean((depth - target) ** 2), mutated

    with jax.enable_x64(x64):
        dtype = np.float64 if x64 else np.float32
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        js = jstate.replace(params=cast(jstate.params), batch_stats=cast(jstate.batch_stats),
                            opt_state=cast(jstate.opt_state))
        (loss, mutated), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            js.params, js.batch_stats, cast(batch["input"]), cast(batch["target"]))
        new = js.apply_gradients(grads=g, batch_stats=mutated["batch_stats"])
        g, new, loss = jax.tree_util.tree_map(np.asarray, (g, new, loss))
    grads = {k: v.numpy() for k, v in from_flax({"params": g}, dtype).items()}
    return grads, new, {"train_loss": loss}


def _port_state(trainer, variables, dtype=torch.float32):
    state = trainer.build_state()
    state.model.load_state_dict(from_flax(variables))
    state.model.to(dtype)
    return state


@pytest.mark.parametrize("resize_input", [False, True], ids=["UNetMini", "UNet"])
def test_train_step_matches_jax(tree, tmp_path, resize_input):
    cfg = _config(tree, resize_input)
    jtrainer, jstate, variables = _jax_state(cfg, tmp_path)
    batch = _batch(cfg, tmp_path)
    jgrads, _, _ = _jax_step(jtrainer, jstate, batch)
    jgrads64, new_jstate, jmetrics = _jax_step(jtrainer, jstate, batch, x64=True)

    trainer = DepthRegressorTrainer(cfg, device="cpu", experiment_dir=tmp_path / "port")
    state = _port_state(trainer, variables)
    metrics = trainer.train_step(state, batch, trainer.generator)
    assert state.step == 1 and set(metrics) == {"train_loss"}

    state64 = _port_state(trainer, variables, torch.float64)
    train_step(state64, {k: torch.tensor(np.asarray(batch[k]), dtype=torch.float64)
                         for k in TENSORS}, cfg)
    grads64 = {n: p.grad.numpy() for n, p in state64.model.named_parameters()}
    _compare_step(state, metrics, new_jstate, jmetrics, jgrads, jgrads64, grads64,
                  UNET_GRAD_RTOL, BN_FED[resize_input])


@pytest.mark.parametrize("resize_input", [False, True], ids=["UNetMini", "UNet"])
def test_eval_step_and_depth_map_match_jax(tree, tmp_path, resize_input):
    """val_loss and the written depth_map.exr (eval-mode BatchNorm) at 1e-5."""
    cfg = _config(tree, resize_input)
    jtrainer, jstate, variables = _jax_state(cfg, tmp_path)
    batch = _batch(cfg, tmp_path)
    want = jtrainer.eval_step(jstate, batch)
    jtrainer.visualize(jstate, batch, tmp_path / "jax_vis")
    trainer = DepthRegressorTrainer(cfg, device="cpu", experiment_dir=tmp_path / "port")
    state = _port_state(trainer, variables)
    got = trainer.eval_step(state, batch)
    assert set(got) == {"val_loss"}
    np.testing.assert_allclose(float(got["val_loss"]), float(want["val_loss"]), rtol=1e-5)
    trainer.visualize(state, batch, tmp_path / "vis")
    for name in set(batch["name"]):
        d = read_exr_channel(tmp_path / "vis" / name / "depth_map.exr", "Z")
        ref = read_exr_channel(tmp_path / "jax_vis" / name / "depth_map.exr", "Z")
        assert d.shape == (240, 320)
        np.testing.assert_allclose(d, ref, rtol=1e-5)


def test_fit_checkpoint_warm_start_resume_and_cli(tree, tmp_path, monkeypatch):
    """A 4-step UNetMini fit (sanity step, two validations writing depth
    maps, logs, top-k + last), resumed from `last`; the checkpoint warm-starts
    SceneNetTrainer's UNet and changes nothing else; the CLI; precision 16."""
    cfg = _config(tree, False, sanity_steps=1, val_check_interval=2, visualize=True)
    trainer = DepthRegressorTrainer(cfg, device="cpu", experiment_dir=tmp_path / "a")
    state = trainer.fit(max_steps=4)
    assert state.step == 4
    recs = [json.loads(x) for x in (tmp_path / "a/logs/metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 4] and np.isfinite(recs[0]["train_loss"])
    assert [r["step"] for r in recs if "val_loss" in r] == [2, 4]
    ckpts = tmp_path / "a/checkpoints"
    manifest = json.loads((ckpts / "manifest.json").read_text())
    assert manifest["monitor"] == "val_loss" and manifest["mode"] == "min"
    assert len(list((tmp_path / "a/vis").glob("*/00000/depth_map.exr"))) == 1

    restored = load_state_from_checkpoint(trainer.build_state(), ckpts / "last")
    assert restored.step == 4
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(restored.model.state_dict()[k], v, rtol=0, atol=0)
    resumed = DepthRegressorTrainer(cfg.replace(resume=str(ckpts / "last"), sanity_steps=0),
                                    device="cpu", experiment_dir=tmp_path / "b")
    assert resumed.fit(max_steps=5).step == 5

    scene_cfg = cfg.replace(scale_factor=8, visualize=False)
    cold = SceneNetTrainer(scene_cfg, device="cpu", experiment_dir=tmp_path / "c").build_state()
    warm = SceneNetTrainer(scene_cfg.replace(pretrain_unet=str(ckpts / "last")), device="cpu",
                           experiment_dir=tmp_path / "d").build_state()
    unet = state.model.state_dict()
    cold_sd = cold.model.state_dict()
    for k, v in warm.model.state_dict().items():
        if k.startswith("unet."):
            assert torch.equal(v, unet[k[len("unet."):]]), k
        else:
            assert torch.equal(v, cold_sd[k]), k
    assert not torch.equal(warm.model.unet.down[0].weight, cold.model.unet.down[0].weight)

    half = DepthRegressorTrainer(port_config(cfg, precision=16), device="cpu",
                                 experiment_dir=tmp_path / "e").build_state()
    assert half.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in half.model.parameters())

    monkeypatch.chdir(tmp_path)  # the CLI's experiment directory is runs/<stamp>_<name>
    cli_main(["--device", "cpu", "--datasetdir", str(tree), "--splitsdir", "one",
              "--batch_size", "1", "--seed", "0", "--sanity_steps", "0", "--max_epoch", "2",
              "--val_check_interval", "1.0", "--experiment", "cli"])
    (run,) = (tmp_path / "runs").glob("*_cli")
    assert json.loads((run / "checkpoints/manifest.json").read_text())["last_step"] == 2
