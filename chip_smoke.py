"""Smoke run of the PyTorch + CUDA port (sv3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from sv3d_tpu_torch/csrc, holds each against
its plain torch version at the serving path's shapes, serves one seeded
240x320 RGB array to a mesh through the port's own entry points
(load_model -> predict -> implicit_to_mesh) at the full-width serving
configuration (net_res 128, scale_factor 1, dims (139, 104, 112)) with
seeded random weights, checks that both kernels ran on that path, and times
kernels and path with CUDA events.  Imports nothing of JAX.  Exits non-zero
without CUDA, and when any phase fails.  The last line is
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
WORK = Path(__file__).resolve().parent / "build" / "sv3d_tpu_torch" / "smoke"


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


def seeded_scene_net(config, device, seed):
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    intr = parse_intrinsics(INTRINSICS)
    frustum = FrustumGrid.create(intr, voxel_size=0.05 * config.scale_factor)
    gen = torch.Generator().manual_seed(seed)
    return SceneNet(config, intr, frustum, device=device, generator=gen).eval()


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
    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep, lattice_sweep_plain
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels, scatter_voxels_cuda

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

    # -- phase 4: the main path, through the serving entry points ------------
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
    print(f"main path: launches {launches}, depth {depth_np.shape} in "
          f"[{depth_np.min():.3f}, {depth_np.max():.3f}], mesh at {args.threshold}: "
          f"{len(verts)} verts {len(tris)} faces", flush=True)
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the main path: {launches}")

    values = evaluate_on_grid(served.ifnet, vox, served_config.dims, transfer_dtype=torch.float32)
    check(values.shape == dims, f"value grid shape {values.shape}")
    check(bool(np.isfinite(values).all()) and values.min() >= 0 and values.max() <= 1,
          "value grid not finite in [0, 1]")
    median = float(np.median(values))
    _, smoke_tris = implicit_to_mesh(served.ifnet, vox, dims, 1.0 - median, WORK / "median.obj")
    print(f"value grid {values.shape} in [{values.min():.4f}, {values.max():.4f}]; smoke mesh "
          f"at the median level {1.0 - median:.4f}: {len(smoke_tris)} faces", flush=True)
    check(len(smoke_tris) > 0, "smoke mesh at the median level has no faces")

    # -- phase 5: the slice on the card against its plain CPU run (small) ----
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

    # -- phase 6: timings -------------------------------------------------------
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
    print(f"timings on {smi}:", flush=True)
    print(f"  K1 scatter_voxels {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms "
          f"({pts.shape[1]} points)", flush=True)
    print(f"  K2 lattice_sweep {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms "
          f"(1 lattice row, {dims[1] * dims[2]} points)", flush=True)
    for rows, ms in sweep_ms.items():
        print(f"  dense sweep slab_rows={rows}: {ms:.3f} ms, {n_pts / (ms / 1e3):.4g} points/s",
              flush=True)
    print(f"  warm image->mesh: median {statistics.median(e2e):.4f} s over {len(e2e)} runs "
          f"({', '.join(f'{t:.4f}' for t in e2e)})", flush=True)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
