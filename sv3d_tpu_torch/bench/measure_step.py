"""Train-step and op costs on the card (port of the JAX package's
scripts/measure_step.py):

    python -m sv3d_tpu_torch.bench.measure_step --set all

ops (B = 8, dims (139, 104, 112)): the K1 scatter of 76,800 points a sample
beside the plain torch scatter (its yardstick), K1b through the gradient of
sum(scatter^2), the full voxelization (K1 + the separable Gaussian),
IFNet.query (the exact gathers) at 8 x 4,096 points beside query_fused (K4
and a matmul), IFNet.encode, and the gradient of sum(query^2) into the
pyramid and the points, by the gathers and on the fused route (K4; K7 and
K8 in the backward).

steps (--set base: (B, precision, fused_query) = (4, 32, off), (8, 16, off);
fused: (4, 32, on), (4, 16, on), (8, 16, on)): trainer_scene_net.train_step
on scripts/measure_step.py's seeded synthetic batch (random RGB, constant
depth 2.0, 4,096 supervision points a sample with random occupancies) and
its Config (subsample_points 0: no projected-cloud queries, so no host
labelling).  Each fused configuration runs a second time with 4,096
points of the projected cloud a sample added to the queries
(subsample_points), labelled at random on the device, so that the query
points depend on the depth and the backward runs K7.  Both are device
steps: the trainer's host labelling of the cloud (SceneNetTrainer.
label_cloud), which a training run with subsample_points pays every step,
is not in them.  Each reports the median ms of n_timed steps after 2
warm-ups, the peak device memory and an mfu: the step's FLOPs over the
card's dense peak for its precision (f32 outside the tensor cores at
precision 32, TF32 being off; bf16 on the tensor cores at 16).  The FLOPs
are torch's (torch.utils.flop_counter.FlopCounterMode over one step:
matmuls, convs and their gradients) plus each custom kernel's own count,
which the counter cannot see (the formulas of chip_smoke.py's bounds: K1
32 and K1b 48 a point; K4 16, K7 64 and K8 16 a feature, B x N x 7 x
sum(C) features).

serving (--set serving, or all): the res_increase-2 dense sweep plus the
host pull with transfer_dtype float32, float16 and uint8
(evaluate_on_grid), then marching cubes and the OBJ write.

Prints lines like the JAX script's, then one JSON line with every figure
and the card.  --device cpu runs the plain versions; --scale_factor above
1 shrinks the grid, the point counts (by its cube) and the batches to 2,
for tests.  On a CUDA device every measurement checks the launch counters
of the kernels it is meant to run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.bench.headline import RES_INCREASE, build_ifnet, scaled_count
from sv3d_tpu_torch.bench.timing import (
    PEAK_BF16_TENSOR_FLOPS,
    PEAK_F32_FLOPS,
    device_info,
    timed_runs,
)

B = 8
N_VOXELIZED = 76800  # one 240 x 320 depth map's points
N_POINTS = 4096  # 2 * num_points (2048), the reference's training load
N_TIMED = 5
STEP_CONFIGS = {  # (B, precision, fused_query)
    "base": ((4, 32, False), (8, 16, False)),
    "fused": ((4, 32, True), (4, 16, True), (8, 16, True)),
}
STEP_CONFIGS["all"] = STEP_CONFIGS["base"] + STEP_CONFIGS["fused"]


class Counted:
    """Times fn and checks on a CUDA device that it launched the kernels in
    `ran` and none in `idle` (launch_counters' names)."""

    def __init__(self, device, n_timed: int):
        self.device, self.n_timed = device, n_timed

    def check(self, what: str, launched: dict, ran=(), idle=()) -> None:
        from sv3d_tpu_torch.ops.cuda import require

        if self.device.type == "cuda":
            require(launched, ran, idle, what)

    def ms(self, what: str, fn, ran=(), idle=()) -> dict:
        """Median ms of n_timed runs after 2 warm-ups, and the launches of
        all of them."""
        from sv3d_tpu_torch.ops.cuda import launched

        times = []
        counts = launched(lambda: times.extend(timed_runs(fn, self.device, self.n_timed)))
        self.check(what, counts, ran, idle)
        return {"ms": statistics.median(times) * 1e3, "launches": counts}


def ops(c: Counted, dims, b: int, n_vox: int, n_query: int) -> dict:
    """The op costs at training shapes (module docstring)."""
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda
    from sv3d_tpu_torch.ops.grid_sample import Pyramid
    from sv3d_tpu_torch.ops.voxelize import gaussian_kernels_1d, scatter_voxels, smooth_voxels

    dev = c.device
    rng = np.random.default_rng(0)
    pts_vox = torch.tensor(rng.uniform(-0.45, 0.45, (b, n_vox, 3)).astype(np.float32),
                           device=dev)
    pts_q = torch.tensor(rng.uniform(-0.45, 0.45, (b, n_query, 3)).astype(np.float32),
                         device=dev)
    sigma = torch.tensor([1.5, 1.5, 1.5], device=dev)
    out = {}

    def line(name, shape, r, extra=""):
        print(f"{name:<34s}({shape}): {r['ms']:9.3f} ms{extra}", flush=True)

    vshape = f"B={b}, {n_vox} pts"
    qshape = f"B={b}, {n_query} pts"
    with torch.no_grad():
        out["scatter_K1"] = c.ms("scatter K1", lambda: scatter_voxels_cuda(pts_vox, dims),
                                 ran=("K1",))
        line("scatter_voxels K1", vshape, out["scatter_K1"])
        out["scatter_plain"] = c.ms("plain scatter", lambda: scatter_voxels(pts_vox, dims),
                                    idle=("K1",))
        line("scatter_voxels plain torch", vshape, out["scatter_plain"])

    p_grad = pts_vox.clone().requires_grad_(True)
    out["scatter_grad_K1b"] = c.ms(
        "scatter grad", lambda: torch.autograd.grad(
            (scatter_voxels_cuda(p_grad, dims) ** 2).sum(), p_grad), ran=("K1", "K1b"))
    line("scatter grad K1 + K1b", vshape, out["scatter_grad_K1b"])

    with torch.no_grad():
        kernels = lambda: gaussian_kernels_1d(sigma, (3, 3, 3))
        out["voxelize"] = c.ms("voxelize", lambda: smooth_voxels(
            scatter_voxels_cuda(pts_vox, dims), kernels()), ran=("K1",))
        line("voxelize full (K1 + Gaussian)", vshape, out["voxelize"])

        model, _ = build_ifnet(dims, dev, seed=1)
        grid = (torch.rand((b, *dims, 1), generator=torch.Generator().manual_seed(0))
                > 0.97).float().to(dev)
        levels = model.encode(grid)
        out["query_gathers"] = c.ms("IFNet.query", lambda: model.query(levels, pts_q),
                                    idle=("K4", "K5", "K6", "K6bf16"))
        rate = b * n_query / out["query_gathers"]["ms"] * 1e3
        line("IFNet.query (gathers)", qshape, out["query_gathers"], f"  ({rate / 1e6:.2f} M pts/s)")
        out["query_fused_K4"] = c.ms("query_fused", lambda: model.query_fused(levels, pts_q),
                                     ran=("K4",))
        rate = b * n_query / out["query_fused_K4"]["ms"] * 1e3
        line("IFNet.query_fused (K4 + matmul)", qshape, out["query_fused_K4"],
             f"  ({rate / 1e6:.2f} M pts/s)")
        out["encode"] = c.ms("IFNet.encode", lambda: model.encode(grid))
        line("IFNet.encode", f"B={b}", out["encode"])

    # the gradients into the pyramid and the points
    flats = [f.detach().clone().requires_grad_(True) for f in levels.flats]
    pyramid = Pyramid(flats, levels.dims)
    p_q = pts_q.clone().requires_grad_(True)
    for key, query, ran, idle in (
            ("query_grad_gathers", model.query, (), ("K4", "K7", "K8")),
            ("query_grad_fused", model.query_fused, ("K4", "K7", "K8"), ())):
        out[key] = c.ms(key, lambda query=query: torch.autograd.grad(
            (query(pyramid, p_q) ** 2).sum(), [*flats, p_q]), ran=ran, idle=idle)
        label = "query grad (gathers)" if key.endswith("gathers") else "query grad (K4, K7, K8)"
        line(label, qshape, out[key])
    return out


def step_flops(b: int, n_query: int, n_cloud: int, sum_c: int, fused: bool,
               cloud: bool) -> dict:
    """Each custom kernel's FLOPs in one train step of n_query query points
    and n_cloud projected pixels a sample (the counts of chip_smoke.py's
    bounds), which FlopCounterMode cannot see; K7 runs only when the
    queries hold cloud points."""
    n_feat = b * n_query * 7 * sum_c
    flops = {"K1": 32.0 * b * n_cloud, "K1b": 48.0 * b * n_cloud}
    if fused:
        flops.update({"K4": 16.0 * n_feat, "K8": 16.0 * n_feat})
        if cloud:
            flops["K7"] = 64.0 * n_feat
    return flops


def step_case(c: Counted, b: int, precision: int, fused: bool, scale_factor: int,
              n_query: int, cloud: bool = False) -> dict:
    """One train-step configuration (module docstring); cloud adds n_query
    projected-cloud points a sample, labelled at random on the device."""
    from torch.utils.flop_counter import FlopCounterMode

    from sv3d_tpu_torch.bench.headline import scene_config, scene_model
    from sv3d_tpu_torch.ops.cuda import launched
    from sv3d_tpu_torch.training.optim import build_optimizer
    from sv3d_tpu_torch.training.state import TrainState
    from sv3d_tpu_torch.training.trainer_scene_net import train_step

    dev = c.device
    config = scene_config(scale_factor, batch_size=b, num_points=2048, precision=precision,
                          fused_query=fused, subsample_points=n_query if cloud else 0)
    model = scene_model(config, dev, seed=2)
    state = TrainState(model, build_optimizer(config.lr, model))
    gen = torch.Generator().manual_seed(3)
    h, w = 240, 320
    batch = {
        "rgb": (torch.rand((b, h, w, 3), generator=gen) * 2.0 - 1.0).to(dev),
        "depthmap_target": torch.full((b, h, w), 2.0, device=dev),
        "points": (torch.rand((b, n_query, 3), generator=gen) * 0.9 - 0.45).to(dev),
        "occupancies": (torch.rand((b, n_query), generator=gen) > 0.5).float().to(dev),
    }
    if cloud:
        cloud_labels = (torch.rand((b, n_query), generator=gen) > 0.5).float().to(dev)
        idx = [torch.randperm(h * w, generator=gen)[:n_query]]
        run = lambda: train_step(state, batch, config, idx, lambda pc, batch: cloud_labels)
    else:
        run = lambda: train_step(state, batch, config)

    with FlopCounterMode(display=False) as counter:
        run()  # also the first warm-up step
    torch_flops = float(counter.get_total_flops())
    kernel_flops = step_flops(b, (2 if cloud else 1) * n_query, h * w,
                              sum(model.ifnet.config.feature_channels), fused, cloud)
    counts = launched(run)  # the second warm-up step
    c.check(f"step B={b} f{precision} fused={fused} cloud={cloud}", counts,
            ran=tuple(kernel_flops), idle=tuple(k for k in ("K4", "K7", "K8")
                                                if k not in kernel_flops))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times = timed_runs(run, dev, c.n_timed, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else None
    ms = statistics.median(times) * 1e3
    total = torch_flops + sum(kernel_flops.values())
    peak_flops = PEAK_F32_FLOPS if precision == 32 else PEAK_BF16_TENSOR_FLOPS
    mfu = total / (ms / 1e3) / peak_flops
    workload = (f"device step with {n_query} projected-cloud points a sample, labels drawn "
                "on the device: without the trainer's host labelling" if cloud else
                f"device step of scripts/measure_step.py: {n_query} supervision points a "
                "sample, no projected-cloud queries and so no host labelling")
    return {"B": b, "precision": precision, "fused_query": fused, "cloud": cloud,
            "workload": workload, "ms": ms,
            "ms_runs": [t * 1e3 for t in times], "samples_per_s": b / (ms / 1e3),
            "peak_mib": peak, "flops": {"torch": torch_flops, "kernels": kernel_flops,
                                        "total": total},
            "tflops_per_s": total / (ms / 1e3) / 1e12, "mfu": mfu,
            "peak_flops": peak_flops, "launches": counts}


def steps(c: Counted, which: str, scale_factor: int, n_query: int) -> list:
    """The configurations of `which` in scripts/measure_step.py's batch,
    each fused one again with the projected cloud (module docstring)."""
    out = []
    for b, precision, fused in STEP_CONFIGS[which]:
        if scale_factor > 1:
            b = 2
        for cloud in (False, True) if fused else (False,):
            r = step_case(c, b, precision, fused, scale_factor, n_query, cloud)
            tag = (f"B={b}, f{precision}" + (", fused" if fused else "")
                   + (", +cloud" if cloud else ""))
            peak = "not measured" if r["peak_mib"] is None else f"{r['peak_mib']:.1f} MiB"
            print(f"train step      ({tag}): {r['ms']:8.2f} ms  ({r['samples_per_s']:.1f} "
                  f"samples/s)  [{r['flops']['total'] / 1e9:.1f} GFLOP a step, "
                  f"{r['tflops_per_s']:.1f} TFLOP/s = {100 * r['mfu']:.2f}% of the "
                  f"{'f32' if precision == 32 else 'bf16 tensor'} peak; peak memory {peak}]",
                  flush=True)
            out.append(r)
    return out


def serving(c: Counted, dims, out_dir: Path) -> dict:
    """The serving tail at res_increase 2: sweep + pull per transfer dtype,
    then marching cubes and the OBJ write on the last (uint8) pull."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid
    from sv3d_tpu_torch.utils.visualize import visualize_sdf

    model, grid = build_ifnet(dims, c.device)
    out, value = {}, None
    for name, dt in (("f32", torch.float32), ("f16", torch.float16), ("u8", torch.uint8)):
        def run(dt=dt):
            nonlocal value
            value = evaluate_on_grid(model, grid, dims, res_increase=RES_INCREASE,
                                     transfer_dtype=dt)

        out[name] = c.ms(f"serving {name}", run, ran=("K2",), idle=("K2f32",))
        print(f"dense sweep r_inc={RES_INCREASE} + {name} pull:  {out[name]['ms']:8.1f} ms",
              flush=True)
    t0 = time.perf_counter()
    _, tris = visualize_sdf(1.0 - value, out_dir / "measure_serving.obj", 0.5)
    out["marching_cubes_ms"] = (time.perf_counter() - t0) * 1e3
    out["faces"] = len(tris)
    print(f"marching cubes + native obj write:  {out['marching_cubes_ms']:8.1f} ms "
          f"({len(tris)} faces)", flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train-step and op costs on the card")
    p.add_argument("--set", choices=["base", "fused", "serving", "all"], default="base",
                   help="which step configurations to measure (serving: the dense-sweep "
                   "transfer-dtype A/B and the mesh write alone; all adds it to every step)")
    p.add_argument("--skip_ops", action="store_true", help="skip the op costs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    p.add_argument("--n_timed", type=int, default=N_TIMED, help="timed runs a measurement")
    p.add_argument("--scale_factor", type=int, default=1,
                   help="the grid's scale factor (1: full scale); above 1 the point counts "
                   "shrink by its cube and the batches to 2 (tests)")
    p.add_argument("--out_dir", default="build/sv3d_tpu_torch/bench",
                   help="where the serving section writes its mesh")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.predict import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = args.scale_factor
    dims = Config(scale_factor=s).dims
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    c = Counted(device, args.n_timed)
    n_query = scaled_count(N_POINTS, s)
    result = {"device": device_info(device), "dims": list(dims), "n_timed": args.n_timed,
              "set": args.set}
    if args.set != "serving":
        if not args.skip_ops:
            result["ops"] = ops(c, dims, B if s == 1 else 2, scaled_count(N_VOXELIZED, s),
                                n_query)
        result["steps"] = steps(c, args.set, s, n_query)
    if args.set in ("serving", "all"):
        result["serving"] = serving(c, dims, out_dir)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
