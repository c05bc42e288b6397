"""Workers of tests/test_torch_parallel.py and test_torch_parallel_steps.py:
a world of ranks spawned by torch.multiprocessing on the CPU, joined over
gloo through a file:// rendezvous in the test's tmp_path (no TCP port, so
parallel test processes cannot collide).  Not collected by pytest, and it
imports nothing of JAX: each task runs in the ranks through the port's own
entry points, and the same task called in the test process without a
process group is the single-process run it is held to.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from sv3d_tpu_torch.parallel import initialize_distributed, make_mesh


def spawn(world: int, tmp_path: Path, tasks: list) -> list:
    """Run tasks, [(name, function name in this module, kwargs)], in each of
    world ranks; returns each rank's {name: result}, rank by rank.  A rank
    that raises fails the call (the others are terminated)."""
    tmp_path = Path(tmp_path)
    init, out = tmp_path / f"rendezvous_{world}", tmp_path / f"results_{world}"
    out.mkdir(parents=True, exist_ok=True)
    torch.multiprocessing.start_processes(_rank_main, args=(world, str(init), tasks, str(out)),
                                          nprocs=world, join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, init: str, tasks: list, out: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed(f"file://{init}", world, rank, backend="gloo")
    results = {name: globals()[fn](**kwargs) for name, fn, kwargs in tasks}
    torch.save(results, Path(out) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _snapshot(model, metrics) -> dict:
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()
                  if p.grad is not None},
        "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
    }


# -- tasks ------------------------------------------------------------------


def batchnorm(x: np.ndarray, cotangent: np.ndarray, dp: int, steps: int = 2,
              device: str = "cpu") -> dict:
    """A float64 BatchNorm in train mode over this rank's rows of x on
    device, its statistics over the dp ranks; the loss is sum(out *
    cotangent) over the rank's rows.  Returns this rank's outputs and input
    gradients, the parameter gradients (this rank's contributions) and the
    running statistics after steps forwards, on the CPU."""
    from sv3d_tpu_torch.models.batchnorm import BatchNorm, set_group

    mesh = make_mesh(dp, 1) if dp > 1 else None
    rows = mesh.batch_rows(x.shape[0]) if mesh else slice(None)
    bn = BatchNorm(x.shape[1]).double().train().to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1], dtype=torch.float64))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[1], dtype=torch.float64))
    set_group(bn, mesh.column if mesh else None)
    xt = torch.tensor(x[rows], device=device, requires_grad=True)
    for _ in range(steps):
        out = bn(xt)
    (out * torch.tensor(cotangent[rows], device=device)).sum().backward()
    result = {"out": out.detach(), "x_grad": xt.grad, "weight_grad": bn.weight.grad,
              "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
              "running_var": bn.running_var}
    return {k: v.detach().cpu().clone() for k, v in result.items()}


def _as(batch: dict, keys, dtype) -> dict:
    from sv3d_tpu_torch.training.loop import to_device

    return {k: v.to(dtype) if k in keys else v for k, v in to_device(batch, "cpu", keys).items()}


def scene_steps(config, batch: dict, subsamples: list, state_dict: dict, exp_dir: str,
                float64: bool = False) -> list:
    """One end-to-end train step a subsample index array on this rank's rows
    of the global batch, from state_dict's weights: through
    SceneNetTrainer.train_step (its _subsample replaced by the given
    arrays, as the JAX step draws its own), or with float64=True the module's
    train_step on a float64 copy of the model and batch.  Returns a
    snapshot (metrics, gradients, state) after each step."""
    from sv3d_tpu_torch.training.trainer_scene_net import TENSORS, SceneNetTrainer, train_step

    trainer = SceneNetTrainer(config, device="cpu", experiment_dir=Path(exp_dir))
    state = trainer.build_state()
    state.model.load_state_dict(state_dict)
    if float64:
        state.model.double()
    trainer.distribute(state)
    rows = trainer.mesh.batch_rows(config.batch_size) if trainer.mesh else slice(None)
    local = {k: v[rows] for k, v in batch.items()}
    out = []
    for idx in subsamples:
        if float64:
            metrics = train_step(state, _as(local, TENSORS, torch.float64), config,
                                 [torch.as_tensor(idx)], trainer.label_cloud, trainer.mesh)
        else:
            trainer._subsample = lambda b, g, count, idx=idx: [torch.as_tensor(idx)]
            metrics = trainer.train_step(state, local, trainer.generator)
        out.append(_snapshot(state.model, metrics))
    return out


def trainer_steps(kind: str, config, batch: dict, exp_dir: str, steps: int = 1,
                  float64: bool = False) -> dict:
    """The IF-Net-only ("ifnet") or UNet-only ("unet") trainer from its
    seeded build on this rank's rows of batch: the eval metrics of the
    fresh state and steps train steps through the trainer's own eval_step
    and train_step; or with float64=True through its module's train_step
    and eval step on a float64 copy of the model and batch (the points cut
    to its sp slice by shard_batch), steps and then the eval metrics.
    Returns {"eval": metrics, "steps": [a snapshot after each]}."""
    from sv3d_tpu_torch.parallel import shard_batch
    from sv3d_tpu_torch.training import trainer_ifnet, trainer_unet

    module = {"ifnet": trainer_ifnet, "unet": trainer_unet}[kind]
    cls = {"ifnet": trainer_ifnet.ImplicitRefinementTrainer,
           "unet": trainer_unet.DepthRegressorTrainer}[kind]
    trainer = cls(config, device="cpu", experiment_dir=Path(exp_dir))
    state = trainer.build_state()
    if float64:
        state.model.double()
    trainer.distribute(state)
    mesh = trainer.mesh
    rows = mesh.batch_rows(config.batch_size) if mesh else slice(None)
    local = {k: v[rows] for k, v in batch.items()}
    b64 = _as(shard_batch(local, mesh) if mesh else local, module.TENSORS, torch.float64)
    extra = (config,) if kind == "unet" else ()
    out = {"steps": []}
    if not float64:
        out["eval"] = {k: float(v) for k, v in trainer.eval_step(state, local).items()}
    for _ in range(steps):
        if float64:
            metrics = module.train_step(state, b64, *extra, mesh=mesh)
        else:
            metrics = trainer.train_step(state, local, trainer.generator)
        out["steps"].append(_snapshot(state.model, metrics))
    if float64:
        evaluated = (module.eval_forward(state, b64, config, mesh)[1] if kind == "unet"
                     else module.eval_step(state, b64, mesh))
        out["eval"] = {k: float(v) for k, v in evaluated.items()}
    return out


def _ifnet(net_res: int, state_dict: dict):
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet

    model = IFNet(IFNetConfig.for_net_res(net_res))
    model.load_state_dict(state_dict)
    return model.eval()


def lattice(net_res: int, state_dict: dict, grid: np.ndarray, sp: int,
            res_increase: int = 2) -> np.ndarray:
    """evaluate_on_grid (bf16, the serving default) of an IF-Net with
    state_dict's weights on grid (1, D0, D1, D2, 1); with sp > 1 on a
    (1, sp) mesh."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid

    mesh = make_mesh(1, sp) if sp > 1 else None
    return evaluate_on_grid(_ifnet(net_res, state_dict), torch.tensor(grid), grid.shape[1:4],
                            res_increase=res_increase, mesh=mesh)


def points(net_res: int, state_dict: dict, grid: np.ndarray, pts: np.ndarray, dp: int,
           sp: int, **kw) -> np.ndarray:
    """evaluate_points of an IF-Net with state_dict's weights on grid at
    pts; with dp * sp > 1 on a (dp, sp) mesh."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_points

    mesh = make_mesh(dp, sp) if dp * sp > 1 else None
    return evaluate_points(_ifnet(net_res, state_dict), grid, pts, mesh=mesh, **kw)


def cli_fit(argv: list, resume_argv: list, workdirs: list, coordinator: str) -> dict:
    """The end-to-end trainer's CLI in this rank's working directory
    (workdirs[rank]; the cluster flags name the group the rank is in), then
    a second run resumed from rank 0's checkpoints/last."""
    import os

    from sv3d_tpu_torch.training.trainer_scene_net import cli_main

    rank, world = dist.get_rank(), dist.get_world_size()
    cluster = ["--coordinator_address", coordinator, "--num_processes", str(world),
               "--process_id", str(rank)]
    os.chdir(workdirs[rank])
    cli_main(argv + cluster)
    last = sorted(Path(workdirs[0]).glob("runs/*/checkpoints/last"))
    cli_main(resume_argv + cluster + ["--resume", str(last[0])])
    return {"rank": rank, "resumed_from": str(last[0])}
