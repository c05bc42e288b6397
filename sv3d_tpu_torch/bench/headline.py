"""The port's headline benchmark (port of the JAX package's bench.py):

    python -m sv3d_tpu_torch.bench [--sections NAME ...] [--n_timed 5]

Five sections, in bench.py's priority order and under its names:

  points_primary    dense-sweep throughput at res_increase 2 (the
                    278 x 208 x 224 lattice, 12,951,552 points, over the
                    full-scale 139 x 104 x 112 grid): IFNet net_res 128 from
                    a seeded init, a seeded occupancy grid with ~3% of its
                    voxels set, encoded once; the timed call is
                    evaluate_on_grid_device in the default bf16 class (K2
                    bf16) at slab_rows 8;
  rows_sweep        the same at slab_rows 1, 2, 4 and None (one launch, the
                    port's default, keyed "all"); the headline is the best;
  reference_scheme  the reference's dense evaluation on the same card: 4
                    chunks of 32,768 points, each a full re-encode, the
                    exact f32 gathers of IFNet.query and a sigmoid
                    (IFNet.forward, fused_query off); gives vs_baseline;
  scene             warm image->mesh through SceneNet on one seeded random
                    240x320 RGB: predict (UNetMini depth, back-projection,
                    K1 scatter) -> encode -> the sweep at res_increase 2 at
                    the best slab_rows -> u8 pull -> native marching cubes
                    -> OBJ, best of n_timed runs with the median beside it;
                    seeded weights (no checkpoint is read);
  arbitrary         262,144 points uniform in [-0.45, 0.45]^3 on the same
                    model and grid: device-resident query_fused in bf16
                    with bands=None (K5 and a bf16 matmul) and bands="auto"
                    (K6 bf16), and evaluate_points' host loop (one tile).

Rates are points/s from the median of n_timed host-clock runs, each ending
in torch.cuda.synchronize().  After each section one JSON line is printed,
each richer than the last; the last line printed is the result.  A section
that raises ends the run (non-zero exit) after the lines of the sections
before it.  On a CUDA device each section checks the launch counters of
the kernels it is meant to run (a section that ran a plain version
instead raises).

--device cpu runs the plain versions (the tests); --scale_factor shrinks
the grid by the config's scale factor and the point counts by its cube,
for tests.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from sv3d_tpu_torch.bench.timing import device_info, device_ms, host_ms, timed_runs

SECTIONS = ("points_primary", "rows_sweep", "reference_scheme", "scene", "arbitrary")
RES_INCREASE = 2
SLAB_ROWS = 8  # the primary measurement's slab_rows, as bench.py's
ROWS_SWEEP = (1, 2, 4, None)  # None: the whole lattice in one launch, keyed "all"
N_TIMED = 5
N_ARBITRARY = 262144  # bench.py's arbitrary-point count
CHUNK = 32768  # the reference's num_points 2048 x batch_size 16
N_CHUNKS = 4
# the kernels each section must launch on a CUDA device (launch_counters'
# names), and those it must not
SECTION_KERNELS = {
    "points_primary": (("K2",), ("K2f32",)),
    "rows_sweep": (("K2",), ("K2f32",)),
    "reference_scheme": ((), ("K4", "K5", "K6", "K6bf16")),
    "scene": (("K1", "K2"), ("K2f32",)),
    "arbitrary": (("K5", "K6bf16"), ("K4", "K6")),
}


def rows_key(slab_rows) -> str:
    return "all" if slab_rows is None else str(slab_rows)


def scaled_count(n: int, scale_factor: int) -> int:
    """A point count at a test's scale: n / scale_factor^3, at least 64."""
    return n if scale_factor == 1 else max(n // scale_factor ** 3, 64)


@dataclass
class Bench:
    """What every section shares: the device, the grid's dims, the seeded
    IF-Net and occupancy grid, and timed runs a measurement."""

    device: torch.device
    dims: tuple
    model: torch.nn.Module
    grid: torch.Tensor
    n_timed: int
    scale_factor: int
    out_dir: Path
    launches: dict = field(default_factory=dict)

    @property
    def lattice(self) -> tuple:
        return tuple(d * RES_INCREASE for d in self.dims)

    @property
    def n_points(self) -> int:
        r = self.lattice
        return r[0] * r[1] * r[2]

    def median_s(self, fn) -> float:
        return statistics.median(timed_runs(fn, self.device, self.n_timed))


def build_ifnet(dims, device, seed: int = 0):
    """IFNet net_res 128 from a seeded init, and a seeded (1, *dims, 1)
    occupancy grid with about 3% of its voxels set (bench.py:108-116)."""
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet

    model = IFNet(IFNetConfig.for_net_res(128), device=device,
                  generator=torch.Generator().manual_seed(seed)).eval()
    occ = np.random.default_rng(seed).uniform(size=(1, *dims, 1)) > 0.97
    return model, torch.tensor(occ.astype(np.float32), device=device)


def sweep(model, levels, dims, slab_rows, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The timed call of the sweep sections: the dense sigmoid lattice at
    res_increase 2, left on the device ((r0, r1, r2), r0 padded)."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid_device

    return evaluate_on_grid_device(model, levels, dims, RES_INCREASE, slab_rows, compute_dtype)


def bench_sweep(b: Bench, state: dict, rows_values) -> None:
    """points/s of the sweep at each slab_rows of rows_values into
    state["by_rows"]; on a CUDA device also the time one call takes to
    return (host_return_ms_by_slab_rows) and, for the one-launch sweep,
    its device time by torch.profiler (sweep_device_ms)."""
    with torch.inference_mode():
        levels = b.model.encode(b.grid)
        for rows in rows_values:
            run = lambda rows=rows: sweep(b.model, levels, b.dims, rows)
            key = rows_key(rows)
            state["by_rows"][key] = b.n_points / b.median_s(run)
            if b.device.type == "cuda":
                state["host_return_ms_by_slab_rows"][key] = host_ms(run, reps=b.n_timed)
                if rows is None:
                    state["sweep_device_ms"] = device_ms(run, ("lattice_sweep_bf16",),
                                                         steps=b.n_timed)


def reference_chunk(model, grid, points) -> torch.Tensor:
    """One chunk of the reference scheme: a full re-encode, the exact f32
    gathers and the sigmoid (IFNet.forward with fused_query off), pulled to
    the host as the reference's loop does."""
    if model.config.fused_query:
        raise ValueError("the reference scheme queries by the exact gathers (fused_query off)")
    return torch.sigmoid(model(grid, points)).cpu()


def bench_reference_scheme(b: Bench) -> float:
    chunk = scaled_count(CHUNK, b.scale_factor)
    pts = np.random.default_rng(0).uniform(-0.45, 0.45, (N_CHUNKS, 1, chunk, 3))
    pts = torch.tensor(pts.astype(np.float32), device=b.device)

    def run():
        for i in range(N_CHUNKS):
            reference_chunk(b.model, b.grid, pts[i])

    with torch.inference_mode():
        return N_CHUNKS * chunk / b.median_s(run)


def scene_config(scale_factor: int, seed: int = 0, **fields):
    """The scene section's Config: net_res 128 at the given scale factor,
    one image (fields override, e.g. a train step's)."""
    from sv3d_tpu_torch.config import Config

    return Config(seed=seed, num_points=8, batch_size=1, net_res=128,
                  scale_factor=scale_factor).replace(**fields)


def scene_model(config, device, seed: int = 0):
    """SceneNet of config from a seeded init, in eval mode."""
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet
    from sv3d_tpu_torch.quality.synthetic_scenes import INTRINSICS_TEXT

    intr = parse_intrinsics(INTRINSICS_TEXT)
    frustum = FrustumGrid.create(intr, voxel_size=0.05 * config.scale_factor)
    model = SceneNet(config, intr, frustum, device=device,
                     generator=torch.Generator().manual_seed(seed))
    return model.eval()


def scene_rgb(seed: int = 0) -> np.ndarray:
    """One seeded random 240x320 RGB, normalized to [-1, 1]."""
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (240, 320, 3)).astype(np.float32)


def scene_grid_u8(config, model, rgb, slab_rows=None) -> np.ndarray:
    """The device half of image->mesh: predict (depth, back-projection,
    voxelization), encode, the res_increase-2 sweep in bf16, then the uint8
    fixed point (sigmoid * 255 + 0.5, truncated) pulled to the host as
    (r0, r1, r2)."""
    from sv3d_tpu_torch.inference.predict import predict

    vox, _ = predict(config, model, rgb=rgb)
    with torch.inference_mode():
        value = sweep(model.ifnet, model.ifnet.encode(vox), config.dims, slab_rows)
        r0 = config.dims[0] * RES_INCREASE
        return (value[:r0] * 255.0 + 0.5).to(torch.uint8).cpu().numpy()


def bench_scene(b: Bench, slab_rows) -> dict:
    """Warm image->mesh: two untimed runs, then n_timed; the best run's
    total, device and marching-cubes seconds (bench.py:404-412), the
    median total beside it, and the mesh's face count."""
    from sv3d_tpu_torch.utils.visualize import visualize_sdf_u8

    config = scene_config(b.scale_factor)
    model = scene_model(config, b.device)
    rgb = scene_rgb()
    out_path = b.out_dir / "bench_scene_mesh.obj"

    def run():
        t0 = time.perf_counter()
        grid_u8 = scene_grid_u8(config, model, rgb, slab_rows)
        t1 = time.perf_counter()
        _, tris = visualize_sdf_u8(grid_u8, out_path, level=0.5)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, len(tris)

    run()
    run()
    runs = [run() for _ in range(b.n_timed)]
    totals = [d + m for d, m, _ in runs]
    best = int(np.argmin(totals))
    return {"total": totals[best], "device": runs[best][0], "mc": runs[best][1],
            "median": statistics.median(totals), "faces": runs[best][2]}


def bench_arbitrary(b: Bench) -> dict:
    """points/s of the three arbitrary-point routes; on a CUDA device each
    route is checked to launch its own kernel and no other point kernel."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_points
    from sv3d_tpu_torch.ops.cuda import launched, require

    n = scaled_count(N_ARBITRARY, b.scale_factor)
    pts_np = np.random.default_rng(0).uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    pts = torch.from_numpy(pts_np)[None].to(b.device)
    out = {}
    with torch.inference_mode():
        levels = b.model.encode(b.grid)
        routes = {
            # device-resident: points staged once, one query_fused call
            "device": (lambda: torch.sigmoid(b.model.query_fused(
                levels, pts, None, compute_dtype=torch.bfloat16)), "K5"),
            "banded": (lambda: torch.sigmoid(b.model.query_fused(
                levels, pts, "auto", compute_dtype=torch.bfloat16)), "K6bf16"),
            # the API path: encode, staging, the tile, the result to the host
            "host_loop": (lambda: evaluate_points(b.model, b.grid, pts_np, tile_points=n),
                          "K6bf16"),
        }
        for name, (run, kernel) in routes.items():
            ran = launched(lambda name=name, run=run: out.update({name: n / b.median_s(run)}))
            if b.device.type == "cuda":
                others = tuple(k for k in ("K4", "K5", "K6", "K6bf16") if k != kernel)
                require(ran, (kernel,), others, f"arbitrary {name}")
    return out


def check_launches(section: str, device, ran: dict) -> None:
    """On a CUDA device: the section launched each kernel it must and none
    it must not (SECTION_KERNELS)."""
    from sv3d_tpu_torch.ops.cuda import require

    if device.type == "cuda":
        require(ran, *SECTION_KERNELS[section], section)


def payload(b: Bench, state: dict) -> dict:
    """The result line (the keys of bench.py's emit(), without its V100
    estimate, plus the card and the port's extras)."""
    pps, ref_pps = state["value"], state["ref_pps"]
    scene = state["scene"]
    scene_s, mc_s = scene["total"], scene["mc"]
    # the same-card baseline for sec/scene: the reference scheme over the
    # same lattice, plus this run's own marching-cubes time
    ref_scene_s = b.n_points / ref_pps + mc_s if ref_pps > 0 else 0.0
    r = b.lattice
    return {
        "metric": f"occupancy query points/sec/GPU (dense {r[0]}x{r[1]}x{r[2]} sweep, "
                  "IF-Net-128)",
        "value": pps,
        "unit": "points/s",
        "vs_baseline": pps / ref_pps if ref_pps > 0 else 0.0,
        "reference_scheme_points_per_sec": ref_pps,
        "slab_rows_used": state["best_rows"],
        "points_per_sec_by_slab_rows": dict(state["by_rows"]),
        "sec_per_scene_image_to_mesh": scene_s,
        "sec_per_scene_device": scene["device"],
        "sec_per_scene_marching_cubes": mc_s,
        "sec_per_scene_vs_baseline": ref_scene_s / scene_s if scene_s > 0 else 0.0,
        "reference_scheme_sec_per_scene": ref_scene_s,
        "arbitrary_points_per_sec": state["arb"]["device"],
        "arbitrary_points_per_sec_banded": state["arb"]["banded"],
        "arbitrary_points_per_sec_host_loop": state["arb"]["host_loop"],
        "sections_completed": list(state["sections"]),
        "device": state["device"],
        "n_points": b.n_points,
        "n_timed": b.n_timed,
        "sec_per_scene_image_to_mesh_median": scene["median"],
        "scene_faces": scene["faces"],
        "scene_weights": "seeded init: no checkpoint is read (runs/ holds none) and no "
                         "fixture image (.fixture_data/ is absent)",
        "host_return_ms_by_slab_rows": dict(state["host_return_ms_by_slab_rows"]),
        "sweep_device_ms": state["sweep_device_ms"],
        "launches": dict(b.launches),
        "note": "vs_baseline = this sweep against the reference's own per-chunk "
                "re-encoding scheme (model/ifnet.py:215-229) run on the same card",
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="the port's headline benchmark")
    p.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS),
                   help="sections to run (in their fixed order)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    p.add_argument("--n_timed", type=int, default=N_TIMED, help="timed runs a measurement")
    p.add_argument("--scale_factor", type=int, default=1,
                   help="the grid's scale factor (1: full scale); above 1 the point counts "
                   "shrink by its cube (tests)")
    p.add_argument("--out_dir", default="build/sv3d_tpu_torch/bench",
                   help="where the scene section writes its mesh")
    return p


def main(argv=None) -> dict:
    """Run the sections; print one JSON line after each; return the last."""
    args = build_parser().parse_args(argv)

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.predict import resolve_device
    from sv3d_tpu_torch.ops.cuda import launched

    device = resolve_device(args.device)
    # full f32 convs and matmuls, as predict and the trainers run them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = Config(scale_factor=args.scale_factor).dims
    model, grid = build_ifnet(dims, device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    b = Bench(device, dims, model, grid, args.n_timed, args.scale_factor, out_dir)
    zero_scene = {"total": 0.0, "device": 0.0, "mc": 0.0, "median": 0.0, "faces": 0}
    state = {"value": 0.0, "best_rows": None, "by_rows": {}, "ref_pps": 0.0,
             "scene": zero_scene, "arb": {"device": 0.0, "banded": 0.0, "host_loop": 0.0},
             "sections": [], "device": device_info(device),
             "host_return_ms_by_slab_rows": {}, "sweep_device_ms": None}

    def primary():
        bench_sweep(b, state, (SLAB_ROWS,))
        state["best_rows"] = rows_key(SLAB_ROWS)
        state["value"] = state["by_rows"][state["best_rows"]]

    def rows_sweep():
        bench_sweep(b, state, ROWS_SWEEP)
        state["best_rows"] = max(state["by_rows"], key=state["by_rows"].get)
        state["value"] = state["by_rows"][state["best_rows"]]

    def reference_scheme():
        state["ref_pps"] = bench_reference_scheme(b)

    def scene():
        best = state["best_rows"]
        state["scene"] = bench_scene(b, None if best in (None, "all") else int(best))

    def arbitrary():
        state["arb"] = bench_arbitrary(b)

    steps = dict(zip(SECTIONS, (primary, rows_sweep, reference_scheme, scene, arbitrary)))
    line = payload(b, state)
    for name in SECTIONS:
        if name in args.sections:
            ran = launched(steps[name])
            check_launches(name, device, ran)
            b.launches[name] = ran
            state["sections"].append(name)
            line = payload(b, state)
            print(json.dumps(line), flush=True)
    return line
