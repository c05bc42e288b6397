"""Smoke run of the PyTorch + CUDA port (sv3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from sv3d_tpu_torch/csrc and holds each
against its plain torch version at the shapes of the path that runs it.
Then drives the port's two paths through their own entry points, at full
width with seeded random weights, and checks that each ran its kernels:

  serving   one seeded 240x320 RGB array to a mesh (load_model -> predict ->
            implicit_to_mesh), net_res 128, scale_factor 1, dims
            (139, 104, 112): kernels K1 (scatter) and K2 (dense sweep);
  training  SceneNetTrainer(...).fit on a seeded one-scene dataset tree that
            the script writes, B=4, 2x2048 supervision + 4096 projected
            points, fused_query: kernels K1, K1b (scatter backward), K4
            (point features), K7 and K8 (their backward).

It also resumes the fit from its checkpoint, checks that the loss drops over
10 steps on one fixed batch, holds one f32 train step on the card (kernels)
and on the CPU (plain versions) against the same step in float64 on the
CPU, and times kernels, paths and the
train step with CUDA events.  Imports nothing of JAX.  Exits non-zero
without CUDA and when any phase fails.  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

INTRINSICS = "[[277.128, 0., 159.5, 0.], [0., 277.128, 119.5, 0.], [0., 0., 1., 0.], [0., 0., 0., 1.]]"
K1_TOL = 1e-5  # atomics sum in run-dependent order (csrc/voxelize.cu)
K2_TOL = 1e-4  # f32 FMA vs plain f32 contractions: summation order only (csrc/sweep.cu)
SLICE_TOL = 1e-4  # card vs CPU sigmoid grid of the small-scale slice
# K1b, K4, K7, K8: the same f32 arithmetic in another summation order (FMA,
# corner and channel order; K8's atomics add in a run-dependent order on
# both sides, as the plain version's index_add is atomic too), 1e-5 of the
# plain result's largest magnitude (K8 measured up to 2.9e-6 at full width).
TRAIN_KERNEL_RTOL = {"K1b": 1e-5, "K4": 1e-5, "K7": 1e-5, "K8": 1e-5}
# One f32 train step, on the card and on the CPU, each held to the same step
# in float64 on the CPU; each bound relative to the float64 value's largest
# magnitude.  Loss and BatchNorm statistics: 1e-4 (summation orders).
# Gradients of the IF-Net: 1e-2 -- the step's f32 rounding flips the ReLU
# after fc0 for a few of its 524,288 pre-activations that lie within ~2e-6
# of zero, and each flip moves that hidden unit's row of the fc0 gradient by
# a whole point's share of the batch: measured up to 3.4e-3 on the card and
# on the CPU alike, at most 6.7e-4 on the rows without a flip.  Gradients
# of the UNet and sigma: 2e-2 -- they come back through the voxel grid's
# gradient, which jumps where a projected point crosses a voxel boundary or
# the smoothed grid touches its clamp at 1.0 (measured up to 3.0e-3).  A
# tensor whose gradient is ~0 is compared on the scale of the whole step
# (1e-6 of the largest gradient).  Adam's first step is about lr * sign(g):
# elements whose exact gradient lies within twice its tolerance of zero may
# step either way and are held to 2 * lr, the others to 1e-3 * lr plus 1e-4
# relative.
STEP_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-2
GRID_GRAD_RTOL = 2e-2
# The biases of the UNetMini convs that feed a train-mode BatchNorm: their
# gradient is exactly 0 in exact arithmetic (the batch mean absorbs a constant
# shift), so two implementations compute different rounding residue there,
# held to 1e-4 of their weight's gradient, and step up to lr either way.
BN_FED_BIASES = ("unet.down.1.bias", "unet.down.2.bias", "unet.same.0.bias",
                 "unet.same.1.bias", "unet.same.2.bias")
WORK = Path(__file__).resolve().parent / "build" / "sv3d_tpu_torch" / "smoke"

# the one-scene dataset: an axis-aligned box (camera space, metres) in front
# of a wall at WALL_Z
BOX = ((-0.8, -0.9, 2.4), (0.9, 0.4, 4.0))
WALL_Z = 5.5
_BOX_FACES = np.array([
    [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
    [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
])


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median milliseconds of one call between CUDA events (host-side
    preparation inside the call included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs error, max abs error / max(1e-30, max |ref|))."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def seeded_scene_net(config, device, seed):
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    intr = parse_intrinsics(INTRINSICS)
    frustum = FrustumGrid.create(intr, voxel_size=0.05 * config.scale_factor)
    gen = torch.Generator().manual_seed(seed)
    return SceneNet(config, intr, frustum, device=device, generator=gen).eval()


def write_smoke_dataset(root, scale_factor: int = 1, seed: int = 0,
                        n_points: int = 20000) -> Path:
    """A seeded one-scene dataset tree in the layout SceneNetDataset reads:
    intrinsics.txt, splits/overfit/{train,val}.txt, raw/overfit/00000/
    {rgb.png, distance.exr, mesh.obj} and processed/overfit/00000/
    occupancy_{0.10,0.01}.npz.  The scene is BOX before a wall, rendered
    exactly (ray-box distances); the mesh is the box in the voxel-index space
    of the grid that Config(scale_factor=scale_factor) trains on; the
    supervision points are box-surface samples with N(0, sigma) noise plus
    10% uniform points, labelled against the mesh.  Returns root."""
    from PIL import Image

    from sv3d_tpu.config import Config
    from sv3d_tpu.data.splits import write_split
    from sv3d_tpu.io.exr import write_exr
    from sv3d_tpu.io.mesh import TriMesh, save_obj
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.preprocessing.occupancies import _normalize_mesh, determine_occupancy

    rng = np.random.default_rng(seed)
    root = Path(root)
    item = "00000"
    raw = root / "raw" / "overfit" / item
    proc = root / "processed" / "overfit" / item
    raw.mkdir(parents=True, exist_ok=True)
    proc.mkdir(parents=True, exist_ok=True)
    (root / "intrinsics.txt").write_text(INTRINSICS)
    for split in ("train", "val"):
        write_split(root, "overfit", split, [item])

    intr = parse_intrinsics(INTRINSICS)
    u = np.arange(320, dtype=np.float64)[None, :]
    v = np.arange(240, dtype=np.float64)[:, None]
    # ray directions with planar depth 1 (camera y is up: rows grow down)
    dirs = np.stack(np.broadcast_arrays((u - intr.cx) / intr.focal_length,
                                        -(v - intr.cy) / intr.focal_length, 1.0), axis=-1)
    lo, hi = np.asarray(BOX[0]), np.asarray(BOX[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        t_lo, t_hi = lo / dirs, hi / dirs
    t_near = np.minimum(t_lo, t_hi).max(axis=-1)
    t_far = np.maximum(t_lo, t_hi).min(axis=-1)
    depth = np.where((t_near <= t_far) & (t_near > 0), t_near, WALL_Z)
    write_exr(raw / "distance.exr",
              {"R": (depth * np.linalg.norm(dirs, axis=-1)).astype(np.float32)})
    shade = np.clip(1.1 - depth / WALL_Z, 0.0, 1.0)[..., None] * np.array([0.9, 0.7, 0.5])
    shade = shade + 0.05 * rng.standard_normal(shade.shape)
    Image.fromarray((np.clip(shade, 0, 1) * 255).astype(np.uint8)).save(raw / "rgb.png")

    dims = Config(seed=seed, scale_factor=scale_factor).dims
    c2f = np.asarray(FrustumGrid.create(intr, voxel_size=0.05 * scale_factor).camera2frustum)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    verts = corners @ c2f[:3, :3].T + c2f[:3, 3]
    save_obj(raw / "mesh.obj", verts, _BOX_FACES)

    mesh = _normalize_mesh(TriMesh(verts, _BOX_FACES), dims)
    for sigma in ("0.10", "0.01"):
        near = mesh.sample(n_points, rng=rng) + float(sigma) * rng.standard_normal((n_points, 3))
        pts = np.vstack([near, rng.uniform(-0.5, 0.5, (n_points // 10, 3))])
        _, occ = determine_occupancy([raw / "mesh.obj"], pts[None], dims=dims)
        np.savez(proc / f"occupancy_{sigma}.npz", points=pts.astype(np.float32),
                 occupancies=occ[0])
    return root


def _counters():
    from sv3d_tpu_torch.ops.cuda import point_query, voxelize

    return {"K1": voxelize.scatter_voxels_cuda, "K1b": voxelize.scatter_voxels_bwd_cuda,
            "K4": point_query.level_features_cuda, "K7": point_query.level_grad_points_cuda,
            "K8": point_query.level_grad_vol_cuda}


def train_kernel_checks(model, dev, rng) -> dict:
    """K1b, K4, K7 and K8 against their plain versions: the full-width
    net_res 128 pyramid (every level, align_corners False) at B=4 with 4096
    supervision + 4096 projected points, plus small dims with both
    align_corners conventions.  Returns {name: (max abs err, rel err, args)}
    with args the full-width arguments for the timings."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_cuda,
        level_grad_points_cuda,
        level_grad_vol_cuda,
    )
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_raw_cuda
    from sv3d_tpu_torch.ops.point_query import (
        level_features_plain,
        level_grad_points_plain,
        level_grad_vol_plain,
    )
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd

    dims = model.config.dims
    cfg = model.ifnet.config
    out = {}
    with torch.no_grad():
        depth = torch.tensor(rng.uniform(0.4, 6.0, (4, 240, 320)).astype(np.float32), device=dev)
        pc = model.project_depth(depth)  # (4, 76800, 3)
        outside = torch.tensor(rng.uniform(-0.7, 0.7, (4, 4096, 3)).astype(np.float32), device=dev)
        pts = torch.cat([pc, outside], dim=1).contiguous()
        raw = scatter_voxels_raw_cuda(pts, dims)
        g = torch.randn(raw.shape, device=dev)
        got = scatter_voxels_bwd_cuda(pts, raw, g)
        out["K1b"] = (*rel_err(got, scatter_voxels_bwd(pts, raw, g)), (pts, raw, g))

        levels = model.ifnet.encode(model.project(pc))
        sub = torch.tensor(rng.choice(pc.shape[1], 4096, replace=False), device=dev)
        sup = torch.tensor(rng.uniform(-0.5, 0.5, (4, 4096, 3)).astype(np.float32), device=dev)
        q = torch.cat([pc[:, sub], sup], dim=1)
        p = tuple((2.0 * q[..., i]).contiguous() for i in range(3))
        gs = [torch.randn((4, q.shape[1], 7 * flat.shape[1]), device=dev) for flat in levels.flats]
        errs = {"K4": [0.0, 0.0], "K7": [0.0, 0.0], "K8": [0.0, 0.0]}
        cases = [(list(levels), gs, p, cfg.align_corners, cfg.displacement)]
        for c in (1, 64):  # small dims, both conventions
            small = torch.randn((2, c, 12 * 9 * 10), device=dev)
            ps = tuple(torch.tensor(rng.uniform(-1.2, 1.2, (2, 300)).astype(np.float32),
                                    device=dev) for _ in range(3))
            gsm = torch.randn((2, 300, 7 * c), device=dev)
            for ac, disp in ((True, 0.035), (False, 0.0722)):
                cases.append(([(small, (12, 9, 10))], [gsm], ps, ac, disp))
        for lv, grads, pp, ac, disp in cases:
            for (flat, ldims), gl in zip(lv, grads):
                args = (ldims, ac, disp)
                for name, got, ref in (
                    ("K4", level_features_cuda(flat, *pp, *args),
                     level_features_plain(flat, *pp, *args)),
                    ("K7", level_grad_points_cuda(flat, *pp, gl, *args),
                     level_grad_points_plain(flat, *pp, gl, *args)),
                    ("K8", level_grad_vol_cuda(*pp, gl, *args),
                     level_grad_vol_plain(*pp, gl, *args)),
                ):
                    a, r = rel_err(got, ref)
                    errs[name] = [max(errs[name][0], a), max(errs[name][1], r)]
        torch.cuda.synchronize()
    for name, (a, r) in errs.items():
        out[name] = (a, r, (levels, p, gs, cfg.align_corners, cfg.displacement))
    return out


def parity_config(data_root):
    """The configuration of the card-vs-CPU train step."""
    from sv3d_tpu.config import Config

    return Config(seed=0, scale_factor=8, batch_size=2, num_points=256, subsample_points=512,
                  fused_query=True, datasetdir=str(data_root), splitsdir="overfit")


def parity_step(cfg, device, dtype=torch.float32, labels=None) -> dict:
    """One train step of cfg from its seeded weights on the first two samples
    and a fixed subsample, on device in dtype.  labels: the host labels of
    the subsample, or None (on the CPU) to label this run's eval-mode cloud,
    so that every run trains on one set of labels.  Returns the loss, the
    gradients, the state after the step (on the CPU) and the labels."""
    from sv3d_tpu.data.loader import collate
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer, to_device, train_step

    trainer = SceneNetTrainer(cfg, device=device, experiment_dir=WORK / f"parity_{device}")
    ds = trainer.train_dataset()
    batch = to_device(collate([ds[0], ds[1]]), device)
    state = trainer.build_state()
    state.model.to(dtype)
    batch = {k: v.to(dtype) if torch.is_tensor(v) else v for k, v in batch.items()}
    idx = [torch.randperm(240 * 320, generator=torch.Generator().manual_seed(5))[:512]]
    if labels is None:
        with torch.no_grad():
            _, _, pc = state.model.eval()(batch["rgb"], batch["depthmap_target"],
                                          batch["points"], idx[0])
        labels = trainer.label_cloud(pc, batch)
    metrics = train_step(state, batch, cfg, idx, lambda pc, b: labels.to(pc))
    model = state.model
    return {
        "loss": float(metrics["train_loss"]),
        "grads": {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
        "state": {k: v.detach().cpu().double() for k, v in model.state_dict().items()},
        "labels": labels,
    }


def step_parity(dev, data_root) -> dict:
    """One fused_query train step at scale_factor 8 from the same seeded
    weights and batch, on the card (kernels, f32) and on the CPU (plain
    versions, f32), each held to the same step on the CPU in float64.
    Returns {run: {kind: (largest difference as a fraction of its bound,
    where)}} for the loss, the gradients, the updated parameters and the
    BatchNorm statistics."""
    cfg = parity_config(data_root)
    cpu32 = parity_step(cfg, "cpu")
    exact = parity_step(cfg, "cpu", torch.float64, cpu32["labels"])
    card = parity_step(cfg, dev, labels=cpu32["labels"])
    return {"card": _against_exact(cfg, card, exact), "cpu": _against_exact(cfg, cpu32, exact)}


def _against_exact(cfg, run, exact) -> dict:
    """The f32 run against the float64 run, each difference as a fraction of
    its bound (STEP_* above)."""
    out = {"loss": (abs(run["loss"] - exact["loss"]) / abs(exact["loss"]) / STEP_RTOL, ""),
           "grads": (0.0, ""), "params": (0.0, ""), "bn": (0.0, "")}

    def worst(kind, ratio, name):
        if ratio > out[kind][0]:
            out[kind] = (ratio, name)

    floor = 1e-6 * max(float(g.abs().max()) for g in exact["grads"].values())
    for n, g in exact["grads"].items():
        lr = cfg.lr * (10.0 if n.startswith("project.") else 1.0)
        v = exact["state"][n]
        diff = float((run["state"][n] - v).abs().max())
        if n in BN_FED_BIASES:
            bound = 1e-4 * float(exact["grads"][n[: -len("bias")] + "weight"].abs().max())
            worst("grads", float(run["grads"][n].abs().max()) / bound, n)
            worst("params", diff / (2 * lr), n)
            continue
        rtol = GRID_GRAD_RTOL if n.startswith(("unet.", "project.")) else STEP_GRAD_RTOL
        tol = rtol * float(g.abs().max()) + floor
        worst("grads", float((run["grads"][n] - g).abs().max()) / tol, n)
        bound = 1e-3 * lr + STEP_RTOL * float(v.abs().max())
        step_diff = (run["state"][n] - v).abs() / torch.where(g.abs() > 2 * tol, bound,
                                                              bound + 2 * lr)
        worst("params", float(step_diff.max()), n)
    for k, v in exact["state"].items():
        if k.endswith(("running_mean", "running_var")):
            diff = float((run["state"][k] - v).abs().max())
            worst("bn", diff / (STEP_RTOL * float(v.abs().max())), k)
    return out


def profile_train_step(trainer, batch, gen, steps: int = 3) -> list:
    """Where a warm full-width fused_query train step spends its time: the
    host-clock step, the summed device self time of torch.profiler's CUDA
    activity, the host labelling of the projected cloud alone, and the top
    kernels by device time.  Returns printable lines."""
    from torch.profiler import ProfilerActivity, profile

    state = trainer.build_state()
    for _ in range(2):
        trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves (device events), not the CPU ops that launched them
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    events = sorted(kernels, key=dev_us, reverse=True)
    device = sum(dev_us(e) for e in events) / 1e3 / steps
    pc = torch.tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (4, 4096, 3)).astype(np.float32))
    label_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.label_cloud(pc, batch)
        label_ms.append((time.perf_counter() - t0) * 1e3)
    lines = [f"profiled fused_query step: {wall:.3f} ms host clock, {device:.3f} ms device self "
             f"time, device idle {100.0 * (1.0 - device / wall):.1f}%; host labelling of "
             f"4x4096 points {statistics.median(label_ms):.3f} ms (median of 5)"]
    for e in events[:15]:
        ms = dev_us(e) / 1e3 / steps
        lines.append(f"  {ms:9.3f} ms {100.0 * ms / device:5.1f}%  x{e.count // steps:<4d} "
                     f"{e.key[:90]}")
    # which convolutions the backward time belongs to (device time of the
    # kernels each aten op launched, by input shapes)
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::convolution_backward"]
    total = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    for e in sorted(convs, key=total, reverse=True)[:4]:
        lines.append(f"  conv backward {total(e) / 1e3 / steps:9.3f} ms, grad/input/weight "
                     f"shapes {e.input_shapes[:3]}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    from sv3d_tpu.config import Config
    from sv3d_tpu_torch.inference.dense_grid import (
        evaluate_on_grid,
        evaluate_on_grid_device,
        implicit_to_mesh,
    )
    from sv3d_tpu_torch.inference.predict import build_parser, load_model, predict
    from sv3d_tpu_torch.ops.cuda import build
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_cuda,
        level_grad_points_cuda,
        level_grad_vol_cuda,
    )
    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep, lattice_sweep_plain
    from sv3d_tpu_torch.ops.cuda.voxelize import (
        scatter_voxels,
        scatter_voxels_bwd_cuda,
        scatter_voxels_cuda,
    )
    from sv3d_tpu_torch.ops.point_query import (
        level_features_plain,
        level_grad_points_plain,
        level_grad_vol_plain,
    )
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)

    config = Config(seed=0)  # net_res 128, scale_factor 1, inf_res 1, UNetMini
    dims = config.dims
    check(dims == (139, 104, 112), f"serving dims {dims}")
    model = seeded_scene_net(config, dev, seed=0)

    # -- phase 2: K1 against its plain version at the main-path shape --------
    with torch.inference_mode():
        depth = torch.tensor(rng.uniform(0.4, 6.0, (1, 240, 320)).astype(np.float32), device=dev)
        pc = model.project_depth(depth)  # (1, 76800, 3)
        outside = torch.tensor(rng.uniform(-0.7, 0.7, (1, 4096, 3)).astype(np.float32), device=dev)
        pts = torch.cat([pc, outside], dim=1).contiguous()
        k1 = scatter_voxels_cuda(pts, dims)
        k1_ref = scatter_voxels(pts, dims)
        torch.cuda.synchronize()
        k1_err = float((k1 - k1_ref).abs().max())
    print(f"K1 scatter_voxels: {tuple(pts.shape)} -> {tuple(k1.shape)}, "
          f"max_abs_err {k1_err:.3e} (tol {K1_TOL:g}), occupied {int((k1 > 0).sum())}", flush=True)
    check(k1_err <= K1_TOL, f"K1 disagrees with its plain version: {k1_err}")

    # -- phase 3: K2 against its plain version at net_res 128 full scale -----
    ifnet = model.ifnet
    cfg = ifnet.config
    with torch.inference_mode():
        levels = ifnet.encode(model.project(pts))
        k2_err = 0.0
        for rows, off in ((1, 0), (1, 69), (1, 138), (8, 136)):
            got = lattice_sweep(levels, ifnet.mlp, dims, rows, off, cfg.align_corners,
                                cfg.displacement)
            ref = lattice_sweep_plain(levels, ifnet.mlp, dims, rows, off, cfg.align_corners,
                                      cfg.displacement)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(got).all()), f"K2 non-finite logits at rows {off}+{rows}")
            print(f"K2 lattice_sweep rows [{off}, {off + rows}): max_abs_err {err:.3e} "
                  f"(|logit| <= {float(ref.abs().max()):.3f})", flush=True)
            k2_err = max(k2_err, err)
    check(k2_err <= K2_TOL, f"K2 disagrees with its plain version: {k2_err}")

    # -- phase 4: the serving path, through its entry points -----------------
    WORK.mkdir(parents=True, exist_ok=True)
    ckpt, intr_path = WORK / "scene_net.pt", WORK / "intrinsic.txt"
    torch.save(model.state_dict(), ckpt)
    intr_path.write_text(INTRINSICS)
    rgb = rng.uniform(-1.0, 1.0, (240, 320, 3)).astype(np.float32)
    args = build_parser().parse_args(
        ["--checkpoint", str(ckpt), "--rgb", "array", "--intrinsics", str(intr_path),
         "--device", "cuda"])

    scatter_voxels_cuda.launches = 0
    lattice_sweep.launches = 0
    served_config, served = load_model(args)
    vox, depth_np = predict(served_config, served, rgb=rgb)
    verts, tris = implicit_to_mesh(
        served.ifnet, vox, served_config.dims, args.threshold, WORK / "scene.obj",
        res_increase=served_config.inf_res)
    torch.cuda.synchronize()
    launches = {"scatter_voxels": scatter_voxels_cuda.launches,
                "lattice_sweep": lattice_sweep.launches}
    print(f"serving path: launches {launches}, depth {depth_np.shape} in "
          f"[{depth_np.min():.3f}, {depth_np.max():.3f}], mesh at {args.threshold}: "
          f"{len(verts)} verts {len(tris)} faces", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the serving path: {launches}")

    values = evaluate_on_grid(served.ifnet, vox, served_config.dims, transfer_dtype=torch.float32)
    check(values.shape == dims, f"value grid shape {values.shape}")
    check(bool(np.isfinite(values).all()) and values.min() >= 0 and values.max() <= 1,
          "value grid not finite in [0, 1]")
    median = float(np.median(values))
    _, smoke_tris = implicit_to_mesh(served.ifnet, vox, dims, 1.0 - median, WORK / "median.obj")
    print(f"value grid {values.shape} in [{values.min():.4f}, {values.max():.4f}]; smoke mesh "
          f"at the median level {1.0 - median:.4f}: {len(smoke_tris)} faces", flush=True)
    check(len(smoke_tris) > 0, "smoke mesh at the median level has no faces")

    # -- phase 5: the serving slice on the card against its plain CPU run ----
    small_cfg = Config(scale_factor=8, seed=0)
    small_gpu = seeded_scene_net(small_cfg, dev, seed=1)
    small_cpu = seeded_scene_net(small_cfg, "cpu", seed=1)
    grids = []
    for m in (small_gpu, small_cpu):
        v, _ = predict(small_cfg, m, rgb=rgb)
        grids.append(evaluate_on_grid(m.ifnet, v, small_cfg.dims, transfer_dtype=torch.float32))
    slice_err = float(np.abs(grids[0] - grids[1]).max())
    print(f"slice at scale_factor 8, card vs CPU plain: max_abs_err {slice_err:.3e} "
          f"(tol {SLICE_TOL:g})", flush=True)
    check(slice_err <= SLICE_TOL, f"card slice disagrees with the CPU slice: {slice_err}")

    # -- phase 6: serving timings --------------------------------------------
    with torch.inference_mode():
        k1_ms = cuda_ms(lambda: scatter_voxels_cuda(pts, dims))
        k1_plain_ms = cuda_ms(lambda: scatter_voxels(pts, dims))
        sweep_args = (levels, ifnet.mlp, dims, 1, 69, cfg.align_corners, cfg.displacement)
        k2_ms = cuda_ms(lambda: lattice_sweep(*sweep_args))
        k2_plain_ms = cuda_ms(lambda: lattice_sweep_plain(*sweep_args))
        n_pts = dims[0] * dims[1] * dims[2]
        sweep_ms = {
            rows: cuda_ms(lambda rows=rows: evaluate_on_grid_device(ifnet, levels, dims, 1, rows),
                          warmup=1, reps=5)
            for rows in (1, dims[0])
        }
    e2e = []
    for i in range(6):
        t0 = time.perf_counter()
        v, _ = predict(served_config, served, rgb=rgb)
        implicit_to_mesh(served.ifnet, v, served_config.dims, args.threshold, WORK / "t.obj")
        torch.cuda.synchronize()
        if i:  # the first run is warm-up
            e2e.append(time.perf_counter() - t0)
    print(f"serving timings on {smi}:", flush=True)
    print(f"  K1 scatter_voxels {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms "
          f"({pts.shape[1]} points)", flush=True)
    print(f"  K2 lattice_sweep {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms "
          f"(1 lattice row, {dims[1] * dims[2]} points)", flush=True)
    for rows, ms in sweep_ms.items():
        print(f"  dense sweep slab_rows={rows}: {ms:.3f} ms, {n_pts / (ms / 1e3):.4g} points/s",
              flush=True)
    print(f"  warm image->mesh: median {statistics.median(e2e):.4f} s over {len(e2e)} runs "
          f"({', '.join(f'{t:.4f}' for t in e2e)})", flush=True)
    del levels, served, vox

    # -- phase 7: training kernels against their plain versions -------------
    tk = train_kernel_checks(model, dev, rng)
    for name, (a, r, _) in tk.items():
        print(f"{name}: max_abs_err {a:.3e}, relative {r:.3e} (tol {TRAIN_KERNEL_RTOL[name]:g} "
              f"of the largest plain magnitude)", flush=True)
        check(r <= TRAIN_KERNEL_RTOL[name], f"{name} disagrees with its plain version: {r}")
    del model

    # -- phase 8: the training path, through the trainer's entry point -------
    data_root = write_smoke_dataset(WORK / "data")
    train_cfg = Config(seed=0, net_res=128, scale_factor=1, batch_size=4, num_points=2048,
                       subsample_points=4096, fused_query=True, splitsdir="overfit",
                       datasetdir=str(data_root), sanity_steps=0, val_check_interval=6,
                       experiment="smoke")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = SceneNetTrainer(train_cfg, device="cuda", experiment_dir=WORK / "train")
    state = trainer.fit(max_steps=12)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = {name: fn.launches for name, fn in counters.items()}
    recs = [json.loads(line) for line in
            (WORK / "train" / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    vals = [r["val_point_iou"] for r in recs if "val_point_iou" in r]
    print(f"training path: fit(max_steps=12) in {fit_s:.2f} s, launches {train_launches}, "
          f"logged train_loss {losses}, val_point_iou {vals}", flush=True)
    check(all(n > 0 for n in train_launches.values()),
          f"a kernel never ran on the training path: {train_launches}")
    check(state.step == 12 and len(losses) >= 2 and bool(np.isfinite(losses).all())
          and len(vals) == 2, "fit did not log finite losses and two validations")
    last = WORK / "train" / "checkpoints" / "last"
    check(last.exists(), "checkpoints/last was not written")
    resumed = SceneNetTrainer(train_cfg.replace(resume=str(last)), device="cuda",
                              experiment_dir=WORK / "train_resume")
    state_r = resumed.fit(max_steps=13)
    check(state_r.step == 13, f"resume: step {state_r.step} after one more step from 12")
    print("resume: checkpoints/last restored at step 12, one more step to 13", flush=True)
    del state, state_r

    # -- phase 9: the loss drops over 10 steps on one fixed batch ------------
    from sv3d_tpu.data.loader import collate

    ds = trainer.train_dataset()
    batch = collate([ds[i] for i in range(4)])
    state = trainer.build_state()
    gen = torch.Generator().manual_seed(0)
    fixed = [float(trainer.train_step(state, batch, gen)["train_loss"]) for _ in range(10)]
    print(f"10 steps on one batch: train_loss {', '.join(f'{x:.5f}' for x in fixed)}", flush=True)
    check(bool(np.isfinite(fixed).all()) and fixed[-1] < fixed[0], "the loss did not drop")

    # -- phase 10: one train step, card against CPU ---------------------------
    par = step_parity(dev, data_root)
    for run, res in par.items():
        print(f"train step at scale_factor 8, {run} f32 vs CPU float64, largest difference as a "
              "fraction of its bound (<= 1 passes): "
              + ", ".join(f"{k} {r:.3e} {n}" for k, (r, n) in res.items()), flush=True)
        check(max(r for r, _ in res.values()) <= 1.0,
              f"the {run}'s f32 train step disagrees with the float64 step: {res}")

    # -- phase 11: training timings ------------------------------------------
    step_ms = {}
    for fused in (True, False):
        t = SceneNetTrainer(train_cfg.replace(fused_query=fused), device="cuda",
                            experiment_dir=WORK / f"time_{fused}")
        st = t.build_state()
        step_ms[fused] = cuda_ms(lambda t=t, st=st: t.train_step(st, batch, gen), reps=5)
        del st
    levels, p, gs, ac, disp = tk["K4"][2]
    lv = list(levels)
    kernel_ms = {
        "K1b": (cuda_ms(lambda: scatter_voxels_bwd_cuda(*tk["K1b"][2])),
                cuda_ms(lambda: scatter_voxels_bwd(*tk["K1b"][2]))),
        "K4": (cuda_ms(lambda: [level_features_cuda(f, *p, d, ac, disp) for f, d in lv]),
               cuda_ms(lambda: [level_features_plain(f, *p, d, ac, disp) for f, d in lv])),
        "K7": (cuda_ms(lambda: [level_grad_points_cuda(f, *p, g, d, ac, disp)
                                for (f, d), g in zip(lv, gs)]),
               cuda_ms(lambda: [level_grad_points_plain(f, *p, g, d, ac, disp)
                                for (f, d), g in zip(lv, gs)])),
        "K8": (cuda_ms(lambda: [level_grad_vol_cuda(*p, g, d, ac, disp)
                                for (_, d), g in zip(lv, gs)]),
               cuda_ms(lambda: [level_grad_vol_plain(*p, g, d, ac, disp)
                                for (_, d), g in zip(lv, gs)])),
    }
    prof_lines = profile_train_step(trainer, batch, gen)
    print(f"training timings on {smi}:", flush=True)
    for fused, ms in step_ms.items():
        print(f"  full-width train step, B=4, 8192 query points, fused_query={fused}: "
              f"median {ms:.3f} ms of 5", flush=True)
    for name, (ms, plain) in kernel_ms.items():
        what = "80,896 points" if name == "K1b" else "all 6 levels, B=4 x 8192 points"
        print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms ({what})", flush=True)
    for line in prof_lines:
        print(f"  {line}", flush=True)

    kernels = [
        {"name": "scatter_voxels", "route": "cuda", "source": "sv3d_tpu_torch/csrc/voxelize.cu",
         "replaces": "sv3d_tpu/ops/pallas/voxelize.py:130",
         "launches": launches["scatter_voxels"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "lattice_sweep", "route": "cuda", "source": "sv3d_tpu_torch/csrc/sweep.cu",
         "replaces": "sv3d_tpu/ops/pallas/sweep.py:162",
         "launches": launches["lattice_sweep"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]
    for name, key, source, replaces in (
        ("scatter_voxels_bwd", "K1b", "voxelize.cu", "sv3d_tpu/ops/pallas/voxelize.py:224"),
        ("level_features", "K4", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:439"),
        ("level_grad_points", "K7", "point_query.cu",
         "sv3d_tpu/ops/pallas/point_query_bwd.py:172"),
        ("level_grad_vol", "K8", "point_query.cu", "sv3d_tpu/ops/pallas/point_query_bwd.py:365"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"sv3d_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": train_launches[key], "max_abs_err": tk[key][0],
            "ms": kernel_ms[key][0], "plain_ms": kernel_ms[key][1]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
