"""The end-to-end train step on a world of 4 ranks (dp=2 x sp=2) against the
single-process port and the JAX trainer's step on make_mesh(dp=2, sp=2).

The JAX package's test_fused_train_steps_on_dp_sp_mesh configuration
(skip_unet, scale_factor 8, net_res 32, B=4, 2 x 16 supervision points)
with subsample_points 96 and flip_aug (rows 1 and 3 flipped): the query
axis [96 cloud points; 32 points] splits 64 + 64 over sp, so the second
slice straddles the cloud and the points, and each rank labels only the
cloud points in its slice.  The port's --fused_query and gather paths, at
precision 32 and 16, from the JAX trainer's initial weights (converted),
with the JAX step's subsamples (jax.random.permutation of its keys).  The
ranks run in tests/torch_parallel_workers.py (no JAX), all variants in one
spawn.

- float64, two steps: parameters and BatchNorm statistics on every rank
  equal to the single-process port's at rtol 1e-5 of each tensor's largest
  magnitude (measured up to 5.0e-13).
- float32 (precision 32), one step through SceneNetTrainer.train_step:
  metrics at 1e-6 with train_point_iou equal, gradients at 1e-5 of each
  tensor's largest magnitude (measured up to 3.1e-6), BatchNorm statistics at
  1e-5; and the step held to the JAX trainer's mesh step at
  tests/test_torch_training.py's tolerances (_compare_step, with JAX's and
  the port's float64 gradients as witnesses).
- precision 16, one step: the forward is the single-process one bit for
  bit (the batch statistics are float64 sums of each sample's sums), so
  the metrics agree at 1e-6, train_point_iou and the BatchNorm statistics
  exactly; each rank's conv weight gradients come out of its bf16 convs
  rounded to bf16 before the all-reduce (as each device's do in a
  data-parallel bf16 step), so each parameter's gradient is held within a
  quarter of the distance (in norm) between the single-process bf16 step
  and the f32 step of the same weights and batch (measured up to 0.045);
  and the step is held to the JAX trainer's precision-16 mesh step as
  tests/test_torch_precision_e2e.py holds the single-process step to JAX's
  (compare_bf16_step; at least 95% of the parameters equal to JAX's after
  the step, measured 98.9%).
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from sv3d_tpu.config import Config as JConfig
from sv3d_tpu.data.loader import collate
from sv3d_tpu.training.trainer_scene_net import SceneNetTrainer as JSceneNetTrainer
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
from test_torch_precision_e2e import compare_bf16_step
from test_torch_training import (
    _TENSORS,
    LR,
    _compare_step,
    _jax_grads,
    _port_state,
    port_config,
)

torch.set_num_threads(1)

SUBSAMPLE = 96


def _jax_case(tmp, data, precision: int, f32=None) -> SimpleNamespace:
    """The JAX trainer on make_mesh(2, 2) at precision: its initial state,
    the batch, the first step's key, subsample and labels, its mesh step,
    and the witness gradients of a single-device JAX model (its own
    precision's; float64 at precision 32; f32 at 16, f32's case's own when
    given, whose initial weights must be these)."""
    kw = dict(seed=0, scale_factor=8, net_res=32, batch_size=4, num_points=16,
              subsample_points=SUBSAMPLE, skip_unet=True, flip_aug=True, lr=LR,
              datasetdir=str(data), sanity_steps=0, precision=precision)
    jtrainer = JSceneNetTrainer(JConfig(**kw, dp=2, sp=2), experiment_dir=tmp / f"jax{precision}")
    assert jtrainer.mesh.shape == {"dp": 2, "sp": 2}
    jstate = jtrainer.build_state(jax.random.PRNGKey(0))
    ds = jtrainer.train_dataset()
    batch = collate([dict(ds[i], flipped=np.float32(i % 2)) for i in range(4)])
    key = jax.random.PRNGKey(1)
    put = jtrainer._put(batch)
    jocc = np.asarray(jtrainer._occupancies_with_pc(jstate, put, key))
    jnew, jmetrics = jtrainer.train_step(jstate, put, key)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    inputs = [np.asarray(batch[k]) for k in _TENSORS[:3]] + [jocc]
    local = JSceneNetTrainer(JConfig(**kw), experiment_dir=tmp / f"jax_local{precision}")
    witness = {"own": _jax_grads(local.model, local.config, jstate, inputs, key)}
    if precision == 32:
        witness["f64"] = _jax_grads(local.model, local.config, jstate, inputs, key, x64=True)
    else:
        for k, v in from_flax(variables).items():
            assert torch.equal(v, f32.state_dict[k]), k
        witness["f32"] = f32.witness["own"]
    subsamples = [np.asarray(jax.random.permutation(k, 240 * 320)[:SUBSAMPLE])
                  for k in (key, jax.random.PRNGKey(2))]
    return SimpleNamespace(config=port_config(JConfig(**kw)), variables=variables,
                           state_dict=from_flax(variables), batch=batch, subsamples=subsamples,
                           jnew=jnew, jmetrics=jmetrics, witness=witness)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Both JAX cases, and one spawn of 4 ranks running every port variant:
    {(fused, precision, float64): per-rank snapshots}."""
    tmp = tmp_path_factory.mktemp("world4")
    data = write_smoke_dataset(tmp / "data", scale_factor=8, n_points=2000)
    cases = {32: _jax_case(tmp, data, 32)}
    cases[16] = _jax_case(tmp, data, 16, cases[32])
    variants = [(fused, p, f64) for fused in (False, True) for p, f64 in
                ((32, True), (32, False), (16, False))]
    tasks = []
    for fused, p, f64 in variants:
        c = cases[p]
        tasks.append((f"{fused}{p}{f64}", "scene_steps", dict(
            config=c.config.replace(fused_query=fused, dp=2, sp=2), batch=c.batch,
            subsamples=c.subsamples[:2 if f64 else 1], state_dict=c.state_dict,
            exp_dir=str(tmp / "exp"), float64=f64)))
    ranks = workers.spawn(4, tmp, tasks)
    return tmp, cases, {v: [r[f"{v[0]}{v[1]}{v[2]}"] for r in ranks] for v in variants}


def _single(tmp, case, fused, float64):
    steps = case.subsamples[:2 if float64 else 1]
    return workers.scene_steps(case.config.replace(fused_query=fused), case.batch, steps,
                               case.state_dict, str(tmp / "single"), float64=float64)


def _model_after(case, fused, snapshot):
    """A port model holding a rank's state and gradients after its step."""
    state = _port_state(case.config.replace(fused_query=fused), case.variables)
    state.model.load_state_dict(snapshot["state"])
    for n, p in state.model.named_parameters():
        p.grad = snapshot["grads"][n].clone()
    return state


def _same(got: dict, want: dict, rtol: float):
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, rtol=rtol, atol=rtol * float(v.abs().max()),
                                       msg=k)
        else:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_float64_steps_match_single_process(world4, fused):
    tmp, cases, runs = world4
    single = _single(tmp, cases[32], fused, float64=True)
    for rank in runs[(fused, 32, True)]:
        for got, want in zip(rank, single):
            _same(got["state"], want["state"], 1e-5)
            for k, v in want["metrics"].items():
                assert got["metrics"][k] == pytest.approx(v, rel=1e-9), k


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_f32_step_matches_single_process_and_jax_mesh(world4, fused):
    tmp, cases, runs = world4
    case = cases[32]
    single = _single(tmp, case, fused, float64=False)[0]
    exact = _single(tmp, case, fused, float64=True)[0]
    for rank in runs[(fused, 32, False)]:
        got = rank[0]
        for k, v in single["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        assert got["metrics"]["train_point_iou"] == single["metrics"]["train_point_iou"]
        for n, g in single["grads"].items():
            torch.testing.assert_close(got["grads"][n], g, rtol=0,
                                       atol=1e-5 * float(g.abs().max()), msg=n)
        _same({k: v for k, v in got["state"].items() if "running" in k},
              {k: v for k, v in single["state"].items() if "running" in k}, 1e-5)
    got = runs[(fused, 32, False)][0][0]
    state = _model_after(case, fused, got)
    grads64 = {n: g.numpy() for n, g in exact["grads"].items()}
    _compare_step(state, got["metrics"], case.jnew, case.jmetrics, case.witness["own"],
                  case.witness["f64"], grads64)


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_precision16_step_matches_single_process_and_jax_mesh(world4, fused):
    tmp, cases, runs = world4
    case = cases[16]
    single = _single(tmp, case, fused, float64=False)[0]
    single32 = _single(tmp, cases[32], fused, float64=False)[0]
    norm = lambda t: float(t.double().norm())
    for rank in runs[(fused, 16, False)]:
        got = rank[0]
        for k, v in single["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        assert got["metrics"]["train_point_iou"] == single["metrics"]["train_point_iou"]
        for k, v in single["state"].items():
            if "running" in k:
                assert torch.equal(got["state"][k], v), k
        for n, g in single["grads"].items():
            assert (norm(got["grads"][n] - g)
                    <= 0.25 * norm(g - single32["grads"][n]) + 1e-6 * norm(g)), n
    got = runs[(fused, 16, False)][0][0]
    state = _model_after(case, fused, got)
    compare_bf16_step(state.model, got["metrics"], case.jnew, case.jmetrics, case.witness["own"],
                      case.witness["f32"], 0.95)
