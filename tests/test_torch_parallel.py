"""The port's multi-GPU mesh (sv3d_tpu_torch/parallel) on the CPU, against
the single-process port and the JAX package's mesh.

Ranks are spawned by torch.multiprocessing and joined over gloo through a
file:// rendezvous in tmp_path (tests/torch_parallel_workers.py, which
imports nothing of JAX); the cases of one world size share one spawn (a
module fixture).  The same task run in this process without a process
group is the single-process port; the JAX side runs here on the
conftest's 8 virtual devices.

- The mesh helpers without a group: rank coordinates row-major as JAX's
  make_mesh lays devices out, the batch rows and point slices, and the
  ValueErrors where JAX's shardings need divisibility or the world size
  differs.
- Synced BatchNorm at dp=2 in float64: outputs, input and parameter
  gradients and running statistics equal to the unsynced module on the
  whole batch at 1e-12.
- The IF-Net-only step (B=4 at dp=2, and at dp=1 x sp=2, whose loss sums
  the sp shares of each sample's points) and the UNet-only step (B=2 at
  dp=2, UNetMini at 240x320): in
  float64, the parameters and BatchNorm statistics after two steps equal to
  the single-process steps at rtol 1e-9; in float32 through the trainers'
  own train_step, one step's metrics at 1e-6 and gradients at 1e-5 of each
  tensor's largest magnitude, and the eval metrics at 1e-6.
- The sp-sharded dense lattice (bf16, the serving default) at sp=2 and sp=3
  (34 rows: 12, 12 and 10): bit-equal to the single-process sweep, and held
  to JAX's evaluate_on_grid on make_mesh(1, sp) at the JAX package's
  mixed-precision bound, 2e-2 on the sigmoid.
- evaluate_points at world 3 on 1000 points (not a multiple of 3; tiles of
  999 split 333 a rank): equal to the single-process result.
- The end-to-end trainer's CLI at --dp 2 (each rank in its own working
  directory): rank 0 alone writes the experiment directory, the
  checkpoints and metrics.jsonl; --resume on both ranks continues to
  step 3.
- chip_smoke.py's world-2 phase (22) at scale 8 on the CPU, with its own
  checks: the dp=2 fit against one process, the sp=2 lattice and
  evaluate_points at world 2 bit-equal (the plain versions count no
  launches).
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from sv3d_tpu.config import IFNetConfig as JIFNetConfig
from sv3d_tpu.inference.dense_grid import evaluate_on_grid as j_evaluate_on_grid
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.parallel.mesh import make_mesh as j_make_mesh
from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.data.splits import write_split
from sv3d_tpu_torch.models.batchnorm import BatchNorm
from sv3d_tpu_torch.parallel import (
    Mesh,
    barrier,
    initialize_distributed,
    is_main_process,
    local_device,
    make_mesh,
    process_count,
    process_index,
    replicate_tree,
    shard_batch,
)
from sv3d_tpu_torch.parallel.mesh import check_world
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset
from test_torch_training import chip_smoke
from test_torch_unet import randomized

torch.set_num_threads(1)

LATTICE_DIMS = (17, 13, 14)  # scale_factor 8; 34 lattice rows at res_increase 2


def _lattice_case():
    """A net_res-32 JAX IF-Net with randomized weights, converted, and a
    sparse occupancy grid (as tests/test_parallel.py's sweep test)."""
    grid = (np.random.default_rng(3).uniform(0, 1, (1, *LATTICE_DIMS, 1)) > 0.9
            ).astype(np.float32)
    jm = JIFNet(JIFNetConfig.for_net_res(32))
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(grid), jnp.zeros((1, 8, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 5)
    return jm, variables, from_flax(variables), grid


def _ifnet_config(**kw):
    return Config(**{**dict(seed=0, scale_factor=8, net_res=32, batch_size=4, num_points=16,
                            fused_query=True, lr=1e-4), **kw})


def _ifnet_batch():
    rng = np.random.default_rng(1)
    dims = _ifnet_config().dims
    return {"input": (rng.random((4, *dims, 1)) < 0.1).astype(np.float32),
            "points": rng.uniform(-0.5, 0.5, (4, 32, 3)).astype(np.float32),
            "occupancies": (rng.random((4, 32)) < 0.4).astype(np.float32)}


def _unet_batch():
    rng = np.random.default_rng(2)
    return {"input": rng.uniform(-1, 1, (2, 240, 320, 3)).astype(np.float32),
            "target": rng.uniform(0.5, 5.5, (2, 240, 320)).astype(np.float32)}


def _bn_inputs():
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 4, 3))
    return x, rng.normal(size=x.shape)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of 2 ranks: synced BatchNorm, the IF-Net-only and UNet-only
    steps, the sp=2 lattice and the CLI fit.  Returns (tmp, the lattice
    case, the per-rank results)."""
    tmp = tmp_path_factory.mktemp("world2")
    data = write_smoke_dataset(tmp / "data", scale_factor=8, n_points=2000)
    for kind in ("raw", "processed"):  # a 4-item split: one step an epoch at batch 4
        os.symlink(data / kind / "overfit", data / kind / "tiny")
    write_split(data, "tiny", "train", ["00000"] * 4)
    write_split(data, "tiny", "val", ["00000"] * 2)
    workdirs = [tmp / f"cwd{r}" for r in range(2)]
    for d in workdirs:
        d.mkdir()
    case = _lattice_case()
    x, cot = _bn_inputs()
    common = ["--device", "cpu", "--datasetdir", str(data), "--splitsdir", "tiny",
              "--scale_factor", "8", "--batch_size", "4", "--num_points", "16",
              "--subsample_points", "64", "--fused_query", "--flip_aug", "--visualize",
              "--sanity_steps", "0", "--val_check_interval", "2", "--seed", "0",
              "--dp", "2"]
    ifnet, unet = _ifnet_batch(), _unet_batch()
    tasks = [
        ("bn", "batchnorm", dict(x=x, cotangent=cot, dp=2)),
        ("lattice", "lattice", dict(net_res=32, state_dict=case[2], grid=case[3], sp=2)),
        ("cli", "cli_fit", dict(argv=common + ["--max_epoch", "2", "--experiment", "first"],
                                resume_argv=common + ["--max_epoch", "1", "--experiment",
                                                      "resumed"],
                                workdirs=[str(d) for d in workdirs],
                                coordinator=f"file://{tmp / 'rendezvous_2'}")),
    ]
    for kind, batch, meshes in (("ifnet", ifnet, ((2, 1), (1, 2))), ("unet", unet, ((2, 1),))):
        for dp, sp in meshes:
            cfg = _ifnet_config(dp=dp, sp=sp, batch_size=len(batch["input"]))
            tasks += [(f"{kind}{dp}{sp}", "trainer_steps",
                       dict(kind=kind, config=cfg, batch=batch, exp_dir=str(tmp / "exp"))),
                      (f"{kind}{dp}{sp}_f64", "trainer_steps",
                       dict(kind=kind, config=cfg, batch=batch, exp_dir=str(tmp / "exp"),
                            steps=2, float64=True))]
    return tmp, case, workers.spawn(2, tmp, tasks)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """One spawn of 3 ranks: the sp=3 lattice and evaluate_points at world 3."""
    tmp = tmp_path_factory.mktemp("world3")
    case = _lattice_case()
    pts = np.random.default_rng(6).uniform(-0.5, 0.5, (1000, 3)).astype(np.float32)
    tasks = [
        ("lattice", "lattice", dict(net_res=32, state_dict=case[2], grid=case[3], sp=3)),
        ("points", "points", dict(net_res=32, state_dict=case[2], grid=case[3], pts=pts,
                                  dp=1, sp=3)),
    ]
    return tmp, case, pts, workers.spawn(3, tmp, tasks)


def test_mesh_helpers_without_a_group():
    """Coordinates, slices and shard_batch of a (4, 2) mesh, row-major as
    the JAX package's make_mesh lays devices out; the one-process helpers;
    and the ValueErrors."""
    jmesh = j_make_mesh(dp=4, sp=2)
    devices = jax.devices()
    for rank in range(8):
        m = Mesh(4, 2, rank)
        assert jmesh.devices[m.dp_index, m.sp_index] == devices[rank]
        assert m.batch_rows(8) == slice(2 * m.dp_index, 2 * m.dp_index + 2)
        assert m.point_slice(10) == slice(5 * m.sp_index, 5 * m.sp_index + 5)
    m = Mesh(4, 2, 7)
    batch = {"points": np.zeros((2, 10, 3)), "occupancies": torch.zeros(2, 10),
             "rgb": np.zeros((2, 4, 3)), "name": ["a", "b"]}
    out = shard_batch(batch, m)
    assert out["points"].shape == (2, 5, 3) and tuple(out["occupancies"].shape) == (2, 5)
    assert out["rgb"] is batch["rgb"] and out["name"] == ["a", "b"]
    for bad in (lambda: m.point_slice(9), lambda: m.batch_rows(6), lambda: Mesh(2, 2, 4),
                lambda: Mesh(0, 1), lambda: shard_batch({"points": np.zeros((2, 7, 3))}, m)):
        with pytest.raises(ValueError):
            bad()

    # one process: no group, every collective the identity
    assert (process_index(), process_count(), is_main_process()) == (0, 1, True)
    assert initialize_distributed() is False
    with pytest.raises(ValueError, match="torchrun"):
        initialize_distributed(coordinator_address="localhost:1")
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, 1)
    with pytest.raises(ValueError, match="torchrun"):
        check_world(1, 2)
    with pytest.raises(ValueError):
        check_world(0, 1)
    single = make_mesh(1, 1)
    assert single.size == 1 and single.column is None and single.row is None
    t = torch.arange(3.0)
    assert single.sum_(t) is t and torch.equal(t, torch.arange(3.0))
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    single.mean_gradients([p])
    assert torch.equal(p.grad, torch.full((2,), 3.0))
    bn = BatchNorm(2)
    assert replicate_tree(bn, single) is bn
    barrier()
    assert local_device("cpu") == torch.device("cpu")


def test_synced_batchnorm_matches_the_whole_batch(world2):
    """dp=2 in float64: each rank's outputs and input gradients, the summed
    parameter gradients and both ranks' running statistics equal the
    unsynced module's on the whole batch at 1e-12."""
    x, cot = _bn_inputs()
    whole = workers.batchnorm(x, cot, dp=1)
    ranks = [r["bn"] for r in world2[2]]
    tol = dict(rtol=1e-12, atol=1e-12)
    for i, r in enumerate(ranks):
        rows = slice(2 * i, 2 * i + 2)
        torch.testing.assert_close(r["out"], whole["out"][rows], **tol)
        torch.testing.assert_close(r["x_grad"], whole["x_grad"][rows], **tol)
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(r[k], whole[k], **tol)
    for k in ("weight_grad", "bias_grad"):
        torch.testing.assert_close(ranks[0][k] + ranks[1][k], whole[k], **tol)


def _assert_same_state(got: dict, want: dict, rtol: float, residue=(), step_bound=0.0):
    """Equal states at rtol of each tensor's largest magnitude; the
    parameters named in residue (gradient only rounding residue) within
    step_bound."""
    assert set(got) == set(want)
    for k, v in want.items():
        if k in residue:
            assert float((got[k] - v).abs().max()) <= step_bound, k
        elif v.is_floating_point():
            torch.testing.assert_close(got[k], v, rtol=rtol, atol=rtol * float(v.abs().max()),
                                       msg=k)
        else:
            assert torch.equal(got[k], v), k


def _assert_residue(grads: dict, residue, bound: float):
    """The biases in residue: gradients within bound of their weight's."""
    for n in residue:
        weight = float(grads[n[: -len("bias")] + "weight"].abs().max())
        assert float(grads[n].abs().max()) <= bound * weight, n


@pytest.mark.parametrize("kind,dp,sp", [("ifnet", 2, 1), ("ifnet", 1, 2), ("unet", 2, 1)])
def test_trainer_steps_match_single_process(world2, kind, dp, sp):
    """The IF-Net-only and UNet-only steps on the mesh against one process:
    two float64 steps (parameters and BatchNorm statistics at rtol 1e-9 of
    each tensor's largest magnitude, then the eval loss at 1e-12), and
    through the trainer's own eval_step and train_step in f32, the eval
    loss at 1e-6 and one step (loss at 1e-6, gradients at 1e-5 of each
    tensor's largest magnitude).  The UNetMini conv
    biases that feed a train-mode BatchNorm have a gradient that is 0 in
    exact arithmetic (chip_smoke.BN_FED_BIASES): each run computes its own
    rounding residue there (held to 1e-12 of the weight's gradient in
    float64, 1e-4 in f32, as tests/test_torch_training.py holds it), and
    Adam steps such a bias up to lr either way."""
    tmp, _, ranks = world2
    batch = _ifnet_batch() if kind == "ifnet" else _unet_batch()
    cfg = _ifnet_config(batch_size=len(batch["input"]))
    residue = [n[len("unet."):] for n in chip_smoke.BN_FED_BIASES] if kind == "unet" else []
    single64 = workers.trainer_steps(kind, cfg, batch, str(tmp / "single"), steps=2,
                                     float64=True)
    single = workers.trainer_steps(kind, cfg, batch, str(tmp / "single"))
    for r in ranks:
        got64, got = r[f"{kind}{dp}{sp}_f64"], r[f"{kind}{dp}{sp}"]
        for step, (a, b) in enumerate(zip(got64["steps"], single64["steps"])):
            _assert_same_state(a["state"], b["state"], 1e-9, residue, 2 * cfg.lr * (step + 1))
            for run in (a, b):
                _assert_residue(run["grads"], residue, 1e-12)
            for k, v in b["metrics"].items():
                assert a["metrics"][k] == pytest.approx(v, rel=1e-12), k
        for (a, b, rel) in ((got64, single64, 1e-12), (got, single, 1e-6)):
            for k, v in b["eval"].items():
                assert a["eval"][k] == pytest.approx(v, rel=rel), k
        a, b = got["steps"][0], single["steps"][0]
        for k, v in b["metrics"].items():
            assert a["metrics"][k] == pytest.approx(v, rel=1e-6), k
        for run in (a, b):
            _assert_residue(run["grads"], residue, 1e-4)
        for n, g in b["grads"].items():
            if n not in residue:
                torch.testing.assert_close(a["grads"][n], g, rtol=0,
                                           atol=1e-5 * float(g.abs().max()), msg=n)


def _jax_lattice(case, sp):
    jm, variables, _, grid = case
    return j_evaluate_on_grid(jm, variables, jnp.asarray(grid), LATTICE_DIMS, res_increase=2,
                              slab_rows=4, mesh=j_make_mesh(dp=1, sp=sp))


def test_sharded_lattice_sp2(world2):
    """sp=2: bit-equal to the single-process sweep on both ranks; within the
    JAX package's mixed-precision bound of JAX's sweep on make_mesh(1, 2)."""
    _, case, ranks = world2
    single = workers.lattice(32, case[2], case[3], sp=1)
    assert single.shape == (34, 26, 28)
    for r in ranks:
        np.testing.assert_array_equal(r["lattice"], single)
    np.testing.assert_allclose(single, _jax_lattice(case, 2), atol=2e-2)


def test_sharded_lattice_sp3_and_points_world3(world3):
    """sp=3 (rows 12, 12, 10): bit-equal to the single-process sweep and
    within 2e-2 of JAX's on make_mesh(1, 3); evaluate_points over the 3
    ranks (1000 points, tiles of 999) equal to the single-process result."""
    _, case, pts, ranks = world3
    single = workers.lattice(32, case[2], case[3], sp=1)
    single_pts = workers.points(32, case[2], case[3], pts, dp=1, sp=1)
    assert single_pts.shape == (1000,)
    for r in ranks:
        np.testing.assert_array_equal(r["lattice"], single)
        np.testing.assert_array_equal(r["points"], single_pts)
    np.testing.assert_allclose(single, _jax_lattice(case, 3), atol=2e-2)


def test_cli_fit_at_dp2_writes_on_rank_0_and_resumes(world2):
    """`trainer_scene_net` at --dp 2 through its CLI: two steps with one
    validation (with visualization) at step 2, then --resume on both ranks
    to step 3; only rank 0's working directory holds runs/."""
    tmp, _, ranks = world2
    assert [r["cli"]["rank"] for r in ranks] == [0, 1]
    assert not (tmp / "cwd1" / "runs").exists()
    (first,), (resumed,) = ((tmp / "cwd0" / "runs").glob(f"*_{name}") for name in ("first",
                                                                                 "resumed"))
    assert ranks[1]["cli"]["resumed_from"] == str(first / "checkpoints" / "last")
    recs = [json.loads(x) for x in (first / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert np.isfinite(recs[0]["train_loss"]) and 0 <= recs[1]["val_point_iou"] <= 1
    manifest = json.loads((first / "checkpoints" / "manifest.json").read_text())
    assert manifest["last_step"] == 2 and [Path(p).name for _, p in manifest["scores"]] == [
        "step_2"]
    assert list((first / "vis").glob("*/*_predicted.obj"))
    last = torch.load(resumed / "checkpoints" / "last", weights_only=True)
    assert last["step"] == 3


def test_chip_smoke_world2_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.world2_phase, the card's two-rank phase, at scale 8 with
    device="cpu": its ranks spawned from chip_smoke itself, and
    world2_checks without the launch counts."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as smoke  # importable by name, as the spawned ranks import it

    monkeypatch.setattr(smoke, "WORK", tmp_path)
    root = write_smoke_dataset(tmp_path / "data", scale_factor=8, n_points=2000)
    fit = Config(seed=0, scale_factor=8, batch_size=4, num_points=64, subsample_points=128,
                 fused_query=True, datasetdir=str(root), sanity_steps=0)
    serve = Config(seed=0, scale_factor=8)
    grid = (np.random.default_rng(0).random((1, *serve.dims, 1)) < 0.1).astype(np.float32)
    torch.save(torch.tensor(grid), tmp_path / "grid.pt")
    pts = np.random.default_rng(3).uniform(-0.45, 0.45, (1001, 3)).astype(np.float32)
    w2 = smoke.world2_phase(fit, serve, tmp_path / "grid.pt", pts, device="cpu")
    smoke.world2_checks(w2, counted=False)
    assert all(n == [0, 0] for counts in w2["launches"].values() for n in counts.values())
    assert w2["label_flips"] == [0.0, 0.0]  # one thread count: the same depth, the same labels
