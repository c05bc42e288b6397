"""A training run of the port held to the JAX package's over several
optimizer steps, not one: the protocol of the scene-scaling runs
(`quality.multiscene`: --use_unet, precision 32, subsample_points 0, the
val_point_iou monitor) on the synthetic tree at scale_factor 8, both sides
in float64 from one init (the JAX trainer's build_state, carried across by
from_flax).

The two trainers' loaders must give the same batches for seed 0 (checked),
and both sides then take those batches in that order: the port through its
trainer's own train_step and validate, the JAX package through its
SceneNet and scene_losses in x64 (its compiled step casts the UNet's output
to float32) with its own optax optimizer (Adam in multi_transform, the
project group at 10x the learning rate) applied in x64.  Checked after every
step: the loss and every metric; after the last: every parameter, every
BatchNorm running statistic, Adam's step count and both moments (torch's
exp_avg / exp_avg_sq against optax's mu / nu), and one validation pass.

Float64 is the only precision two frameworks' runs can be compared in: the
JAX package's own f32 step is 1.75e-2 from its float64 step on this
ill-conditioned small grid.  The bound is the one-step test's EXACT_RTOL
(tests/test_torch_training.py), a fraction of each tensor's largest
magnitude; later steps are held at bounds that the constants below derive,
each beside its measured error.  With fused_query the port runs its plain
K4/K7/K8 and JAX's gather step stays the witness, as in the one-step test.
"""

from __future__ import annotations

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sv3d_tpu.config import Config as JConfig
from sv3d_tpu.models.unet import renormalize_depth as j_renormalize_depth
from sv3d_tpu.training.optim import build_optimizer as j_build_optimizer
from sv3d_tpu.training.trainer_scene_net import SceneNetTrainer as JSceneNetTrainer
from sv3d_tpu.training.trainer_scene_net import scene_losses as j_scene_losses
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.quality import multiscene
from sv3d_tpu_torch.quality.synthetic_scenes import INTRINSICS_TEXT
from sv3d_tpu_torch.training import trainer_scene_net
from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
_chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_chip_smoke)
#: the UNet conv biases that feed a train-mode BatchNorm
BN_FED = _chip_smoke.BN_FED_BIASES

#: optimizer steps (two and a half epochs of the 4-scene train split at B=2)
STEPS = 5
LR = 1e-4
#: the first step's metrics, a fraction of the reference's magnitude: the
#: one-step test's bound (tests/test_torch_training.py; measured 7.2e-14)
EXACT_RTOL = 1e-9
#: Later steps: Adam divides each gradient element by its own running RMS
#: plus eps (1e-8), so a difference of d in a gradient element moves its
#: parameter by up to lr * d / eps = 1e4 d a step, and the two frameworks'
#: float64 rounding (~1e-13 of the largest gradient in one step) grows by one
#: to two orders a step.  The metrics of steps 2-5 and of the validation pass
#: (measured up to 4.5e-9 and 5.1e-10):
TRAJECTORY_RTOL = 1e-7
#: every parameter, BatchNorm statistic and Adam moment after the last step,
#: of its tensor's largest magnitude (measured up to 2.4e-7 on the
#: parameters, 1.2e-6 on exp_avg_sq).  A copy with the project group at 1x
#: the learning rate, or with BatchNorm's momentum at 0.99, fails the checks.
STATE_RTOL = 1e-5
#: the BatchNorm-fed conv biases, whose gradient is rounding residue: their
#: values on the scale of their weight (measured 6.0e-8; Adam moves a
#: residue by up to lr a step) and their moments on the scale of the
#: weight's (measured 1.4e-13)
BN_FED_RTOL, BN_FED_MOMENT_RTOL = 1e-6, 1e-12
#: point_iou is a ratio of two integer counts, which the port divides in
#: float32 (torch's default dtype for an integer division) and JAX in
#: float64: equal counts give ratios within float32's rounding
IOU_RTOL = 2.0 ** -24
TRAIN_SCENES, VAL_SCENES = 4, 1


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """The protocol's configs at scale 8 (the port's as quality.multiscene
    builds it, the JAX package's field for field the same:
    scripts/quality_multiscene.py builds it from the same flags), and the
    synthetic tree's data stage (4 train, 1 val) started in a thread."""
    tmp = tmp_path_factory.mktemp("trajectory")
    argv = ["--root", str(tmp / "tree"), "--n_train", str(TRAIN_SCENES),
            "--n_val", str(VAL_SCENES), "--n_test", "0", "--scale_factor", "8",
            "--num_points", "32", "--num_samples", "400", "--batch_size", "2",
            "--steps", str(STEPS), "--val_every", "3", "--use_unet", "--data_workers", "0"]
    args = multiscene.build_parser().parse_args(argv)
    root = Path(args.root)
    cfg = multiscene._config(args, root)
    assert (cfg.skip_unet, cfg.precision, cfg.subsample_points, cfg.flip_aug) == (
        False, 32, 0, False)
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in fields(JConfig)})
    # the trainers read the tree's intrinsics when they are made; the data
    # stage writes the same text
    root.mkdir(parents=True)
    (root / "intrinsics.txt").write_text(INTRINSICS_TEXT)
    with ThreadPoolExecutor(1) as pool:
        data = pool.submit(multiscene.build_data, root,
                           {"train": TRAIN_SCENES, "val": VAL_SCENES, "test": 0},
                           args.scale_factor, args.num_samples, args.seed, args.data_workers)
        yield cfg, jcfg, tmp, data


def _scene_f64(m, rgb, dt, pts, train):
    """JAX SceneNet.__call__ without subsampling, the UNet's output kept in
    float64 (predict_depth casts it to float32)."""
    cfg = m.config
    depth = j_renormalize_depth(m.unet(rgb, train=train)[..., 0], cfg.min_z, cfg.max_z)
    return m.ifnet(m.project(m.project_depth(depth)), pts, train=train), depth


_KEYS = ("rgb", "depthmap_target", "points", "occupancies")


def _batch64(batch):
    return [jnp.asarray(np.asarray(batch[k], np.float64)) for k in _KEYS]


def _adam_moments(opt_state, params) -> dict:
    """{"mu": {name: array}, "nu": ..., "count": {group: n}} of optax's
    multi_transform state: each top-level subtree's moments from the group
    that owns it, named as from_flax names the parameters."""
    out = {"count": {}}
    for moment in ("mu", "nu"):
        tree = {}
        for group, inner in opt_state.inner_states.items():
            adam = inner.inner_state[0]
            out["count"][group] = int(adam.count)
            for k in params:
                if (k == "project") == (group == "project"):
                    tree[k] = getattr(adam, moment)[k]
        out[moment] = {n: t.numpy() for n, t in from_flax(
            {"params": jax.tree_util.tree_map(np.asarray, tree)}, np.float64).items()}
    return out


def _jax_trajectory(jt, jcfg, init, batches, val_batches) -> dict:
    """The JAX package's float64 run from init over batches: per-step train
    metrics (named as its train step names them), the final variables and
    Adam state, and the validation pass's metrics."""
    m = jt.model

    def loss_fn(params, stats, rgb, dt, pts, occ):
        (logits, depth), mutated = m.apply({"params": params, "batch_stats": stats}, rgb, dt,
                                           pts, True, method=_scene_f64,
                                           mutable=["batch_stats"])
        loss, metrics = j_scene_losses(jcfg, logits, occ, depth, dt, params)
        return loss, (metrics, mutated["batch_stats"])

    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        params, stats = cast(init["params"]), cast(init["batch_stats"])
        tx = j_build_optimizer(jcfg.lr, params)
        opt_state = tx.init(params)

        @jax.jit
        def step(params, stats, opt_state, rgb, dt, pts, occ):
            # flax's TrainState.apply_gradients: tx.update, then apply_updates
            (_, (metrics, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, stats, rgb, dt, pts, occ)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), stats, opt_state, metrics

        @jax.jit
        def evaluate(params, stats, rgb, dt, pts, occ):
            logits, depth = m.apply({"params": params, "batch_stats": stats}, rgb, dt, pts,
                                    False, method=_scene_f64)
            return j_scene_losses(jcfg, logits, occ, depth, dt, params)[1]

        def compile_eval(*args):
            with jax.enable_x64(True):  # a thread's own setting
                return evaluate.lower(*args).compile()

        # the eval step compiles beside the train steps
        with ThreadPoolExecutor(1) as pool:
            compiled = pool.submit(compile_eval, params, stats, *_batch64(val_batches[0]))
            train = []
            for b in batches:
                params, stats, opt_state, metrics = step(params, stats, opt_state,
                                                         *_batch64(b))
                train.append({_named("train", k): float(v) for k, v in metrics.items()})
            evaluate = compiled.result()
        val = [evaluate(params, stats, *_batch64(b)) for b in val_batches]

        final = jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": stats})
        return {"train": train, "val": {_named("val", k): float(np.mean([v[k] for v in val]))
                                        for k in val[0]},
                "state": {k: v.numpy() for k, v in from_flax(final, np.float64).items()},
                "adam": _adam_moments(opt_state, params)}


def _named(prefix: str, metric: str) -> str:
    return metric if metric.startswith("sigma") else f"{prefix}_{metric}"


def _to_f64(batch, device, keys):
    """The trainer's to_device in float64: the port runs the plain versions
    on CPU tensors of any float dtype."""
    out = dict(batch)
    for k in keys:
        if k in batch:
            out[k] = torch.as_tensor(np.asarray(batch[k], np.float64), device=device)
    return out


def _port_trajectory(cfg, init, exp_dir) -> dict:
    """The port's float64 run from init through its trainer's own
    train_step and validate, over its own loaders' batches."""
    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=exp_dir)
    loader = trainer._loader(trainer.train_dataset(), shuffle=True, drop_last=True)
    batches = [b for _ in range(-(-STEPS // len(loader))) for b in loader][:STEPS]
    val_loader = trainer._loader(trainer.val_dataset(), shuffle=False, drop_last=False)
    state = trainer.build_state()
    state.model.load_state_dict(from_flax(init))
    state.model.double()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer_scene_net, "to_device", _to_f64)
        train = [{k: float(v) for k, v in trainer.train_step(state, b, trainer.generator).items()}
                 for b in batches]
        val = trainer.validate(state, val_loader)
    opt = state.optimizer
    val_batches = list(trainer._loader(trainer.val_dataset(), shuffle=False, drop_last=False))
    return {"batches": batches + val_batches, "train": train, "val": val,
            "step": state.step, "trainer": trainer,
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()},
            "adam": {n: {k: (v.numpy() if torch.is_tensor(v) and v.ndim else float(v))
                         for k, v in opt.state[p].items()}
                     for n, p in state.model.named_parameters()},
            "lrs": [g["lr"] for g in opt.param_groups]}


@pytest.fixture(scope="module")
def runs(protocol):
    """Both packages' runs from the JAX trainer's init: the JAX package's
    float64 run in a thread (XLA computes outside the GIL) while the port
    runs both fused_query cases, one after the other."""
    cfg, jcfg, tmp, data = protocol
    jt = JSceneNetTrainer(jcfg, experiment_dir=tmp / "jax")
    # the init compiles while the data stage runs
    state = jt.build_state(jax.random.PRNGKey(jcfg.seed))
    data.result()
    init = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    loader = jt._loader(jt.train_dataset(), shuffle=True, drop_last=True)
    batches = [b for _ in range(-(-STEPS // len(loader))) for b in loader][:STEPS]
    val_batches = list(jt._loader(jt.val_dataset(), shuffle=False, drop_last=False))
    with ThreadPoolExecutor(1) as pool:
        jax_future = pool.submit(_jax_trajectory, jt, jcfg, init, batches, val_batches)
        port = {fused: _port_trajectory(cfg.replace(fused_query=fused), init,
                                        tmp / f"port_{fused}")
                for fused in (False, True)}
        jax_run = jax_future.result()
    return {"batches": batches + val_batches, "jax": jax_run, "port": port}


def _error(got, want, scale=None) -> float:
    """max |got - want| as a fraction of scale (default: want's largest
    magnitude)."""
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(scale, 1e-300))


FUSED = pytest.mark.parametrize("fused", [False, True], ids=["gathers", "fused_query"])


@FUSED
def test_loaders_give_the_jax_batches(runs, fused):
    """The port trainer's train and val loaders give the JAX trainer's
    batches for seed 0, in its order (the shuffle, the epochs' point draws)."""
    for got, want in zip(runs["port"][fused]["batches"], runs["batches"], strict=True):
        assert got["name"] == want["name"]
        for k in _KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@FUSED
def test_every_step_matches_jax(runs, fused):
    """The loss and every train metric of each step: the first at the
    one-step test's EXACT_RTOL, the later ones at TRAJECTORY_RTOL."""
    port, want = runs["port"][fused], runs["jax"]["train"]
    assert port["step"] == STEPS and len(port["train"]) == len(want) == STEPS
    for i, (got, ref) in enumerate(zip(port["train"], want)):
        assert set(got) == set(ref)
        for k, v in ref.items():
            rtol = IOU_RTOL if k.endswith("point_iou") else (
                EXACT_RTOL if i == 0 else TRAJECTORY_RTOL)
            assert _error(got[k], v, abs(v)) <= rtol, (i + 1, k, got[k], v)


@FUSED
def test_final_state_and_adam_moments_match_jax(runs, fused):
    """After the last step: every parameter and BatchNorm running statistic,
    each group's learning rate, and Adam's step count, exp_avg and
    exp_avg_sq against optax's count, mu and nu, at STATE_RTOL of each
    tensor's largest magnitude.  The conv biases that feed a train-mode
    BatchNorm have a gradient of exactly 0 in exact arithmetic; what both
    frameworks compute there is rounding residue, so they and their moments
    are held on the scale of their conv's weight."""
    port, ref = runs["port"][fused], runs["jax"]
    assert port["lrs"] == [LR, 10 * LR]
    assert ref["adam"]["count"] == {"base": STEPS, "project": STEPS}
    assert set(port["state"]) == set(ref["state"])
    for k, want in ref["state"].items():
        if k.endswith("num_batches_tracked"):
            continue  # flax keeps no batch count
        if k in BN_FED:
            scale = np.abs(ref["state"][k[: -len("bias")] + "weight"]).max()
            assert _error(port["state"][k], want, scale) <= BN_FED_RTOL, k
        else:
            assert _error(port["state"][k], want) <= STATE_RTOL, k
    for name, s in port["adam"].items():
        assert s["step"] == STEPS, name
        for key, moment in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = ref["adam"][moment][name]
            if name in BN_FED:
                scale = np.abs(ref["adam"][moment][name[: -len("bias")] + "weight"]).max()
                assert _error(s[key], want, scale) <= BN_FED_MOMENT_RTOL, (key, name)
            else:
                assert _error(s[key], want) <= STATE_RTOL, (key, name)


@FUSED
def test_validation_pass_matches_jax(runs, fused):
    """The trainer's validate after the last step against the JAX package's
    eval step on the same batches: val_point_iou (the checkpoint monitor),
    the losses and sigma."""
    port, ref = runs["port"][fused], runs["jax"]["val"]
    assert port["trainer"].monitor == "val_point_iou"
    assert port["trainer"].monitor_mode == "max"
    assert set(port["val"]) == set(ref)
    for k, v in ref.items():
        rtol = IOU_RTOL if k.endswith("point_iou") else TRAJECTORY_RTOL
        assert _error(port["val"][k], v, abs(v)) <= rtol, (k, port["val"][k], v)
