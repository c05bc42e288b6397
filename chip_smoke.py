"""Smoke run of the PyTorch + CUDA port (sv3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from sv3d_tpu_torch/csrc (and the host
geometry library) and holds each kernel against its plain torch version at
the shapes of the path that runs it.  Then drives the port's paths through
their own entry points, at full width with seeded random weights, and checks
that each ran its kernels:

  serving   one seeded 240x320 RGB array to a mesh (load_model -> predict ->
            implicit_to_mesh), net_res 128, scale_factor 1, dims
            (139, 104, 112): kernels K1 (scatter) and K2 (dense sweep);
  points    evaluate_points on the served model and grid at 262,144 uniform
            points in [-0.45, 0.45]^3: kernel K6 (bands="auto", fc0 in the
            kernel), kernel K4 (bands=None) and the exact gather path, which
            must agree; then the unfused dense sweep
            (query_lattice(fused_tail=False)): kernel K3 (decoder);
  training  SceneNetTrainer(...).fit on a seeded one-scene dataset tree that
            the script writes, B=4, 2x2048 supervision + 4096 projected
            points, fused_query: kernels K1, K1b (scatter backward), K4
            (point features), K7 and K8 (their backward).

K5 (bf16 point features) is on no path of the port, as in the JAX package:
it is held against its plain version at the points path's and the training
path's shapes.  K4 and K5 read a channels-last copy of each level that
their wrappers stage (evaluate_points stages its pyramid once a call); the
script times the staging and the kernels apart,
at both shapes, and prints the layout in which cuDNN returns the conv
outputs that the levels come from.

It also resumes the fit from its checkpoint, checks that the loss drops over
10 steps on one fixed batch, holds one f32 train step on the card (kernels)
and on the CPU (plain versions) against the same step in float64 on the
CPU, and times kernels, paths and the train step with CUDA events, beside
each kernel's bound on the card and the time of one PyTorch library call that
computes the same function, where there is one.  Imports nothing of JAX.  Exits non-zero
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
K3_TOL = 1e-4  # f32 FMA vs plain f32 contractions: summation order only (csrc/mlp.cu)
K6_RTOL = 1e-5  # FMA order over at most 7 * 128 terms, of the largest |partial|
K5_ULP = 2.0 ** -7  # one bf16 ulp: |d| <= 2^-7 |ref| + 1e-6
POINTS_TOL = 1e-5  # the three evaluate_points routes, and card vs CPU, on the sigmoid
N_POINTS = 262144  # the JAX package's arbitrary-point measurement (bench.py)
# the H100 SXM's published peaks at its full 700 W limit (NVIDIA's data
# sheet): f32 outside the tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
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

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.data.splits import write_split
    from sv3d_tpu_torch.io.exr import write_exr
    from sv3d_tpu_torch.io.mesh import TriMesh, save_obj
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


def bound(n_bytes: float, flops: float) -> tuple:
    """The least time the card could take for work that moves n_bytes
    (each input read once, each output written once) and does flops f32
    operations: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gathered_bytes(levels, p, align_corners, displacement) -> int:
    """The least bytes that a gather of the 7 displaced copies x 8 corners
    of these points must read from the (B, C, G) f32 levels, on this run's
    points: per level, the distinct 32-byte sectors that hold the in-range
    corners' channels, with the level laid out channels-last (a corner's C
    channels one run: the layout that needs the fewest sectors).  Never
    more than the levels' own bytes."""
    from sv3d_tpu_torch.ops.grid_sample import displacement_axes

    pd = displacement_axes(p, displacement)  # three (B, 7N)
    total = 0
    with torch.no_grad():
        for flat, dims in levels:
            b, c, g = flat.shape
            idx, ok = [], []
            for q, size in zip(pd, dims):
                ix = ((q + 1.0) * 0.5 * (size - 1.0) if align_corners
                      else ((q + 1.0) * size - 1.0) * 0.5)
                i = torch.floor(ix).long()
                idx.append(torch.stack([i, i + 1]))  # (2, B, 7N): both corners
                ok.append((idx[-1] >= 0) & (idx[-1] < size))
            rows = (idx[0][:, None, None] * dims[1] + idx[1][None, :, None]) * dims[2] \
                + idx[2][None, None, :]  # (2, 2, 2, B, 7N)
            rows = rows + g * torch.arange(b, device=rows.device)[:, None]
            valid = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
            rows = torch.unique(rows[valid])  # sorted
            # a row's bytes [4C r, 4C (r + 1)) span sectors first..last; two
            # neighbouring rows may share one sector
            first, last = rows * (4 * c) // 32, ((rows + 1) * (4 * c) - 1) // 32
            sectors = int((last - first + 1).sum()) - int((last[:-1] == first[1:]).sum())
            total += min(32 * sectors, nbytes(flat))
    return total


def grid_sample_inputs(levels, p, align_corners, displacement) -> list:
    """The library yardstick's inputs for the point-query kernels: per level
    the (B, C, g0, g1, g2) volume and the (B, 1, 1, 7N, 3) grid of the
    displaced points, coordinates reversed to grid_sample's (x = axis 2,
    y = axis 1, z = axis 0)."""
    from sv3d_tpu_torch.ops.grid_sample import displacement_axes

    pd = displacement_axes(p, displacement)
    grid = torch.stack(pd[::-1], dim=-1)[:, None, None].contiguous()
    return [(flat.view(*flat.shape[:2], *dims), grid) for flat, dims in levels]


def grid_sample_ms(inputs, align_corners, backward=None) -> float:
    """CUDA-event median of F.grid_sample(bilinear, zeros) over every level;
    backward "points" or "level" times instead the backward of that call for
    the grid's or the volume's gradient alone, against a random cotangent."""
    import torch.nn.functional as F

    sample = lambda v, g: F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                        align_corners=align_corners)
    if backward is None:
        with torch.no_grad():
            return cuda_ms(lambda: [sample(v, g) for v, g in inputs])
    graphs = []
    with torch.enable_grad():
        for v, g in inputs:
            wrt = (g if backward == "points" else v).detach().requires_grad_()
            out = sample(wrt, g) if backward == "level" else sample(v, wrt)
            graphs.append((out, wrt, torch.randn_like(out)))
        return cuda_ms(lambda: [torch.autograd.grad(o, w, c, retain_graph=True)
                                for o, w, c in graphs])


def k5_error(got, ref) -> tuple:
    """(max abs error, max error as a fraction of the one-bf16-ulp bound)."""
    d = (got.float() - ref.float()).abs()
    return float(d.max()), float((d / (K5_ULP * ref.float().abs() + 1e-6)).max())


def point_kernel_checks(ifnet, levels, pts) -> dict:
    """K6, K5 and K4 against their plain versions on every level of the
    served pyramid at the points path's (1, N_POINTS) query.  Returns
    {name: (max abs err, max err as a fraction of its bound)}."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_fc0_cuda,
        level_features_banded_cuda,
        level_features_cuda,
    )
    from sv3d_tpu_torch.ops.point_query import (
        level_fc0_plain,
        level_features_banded_plain,
        level_features_plain,
    )

    cfg = ifnet.config
    p = tuple((2.0 * pts[..., i]).contiguous() for i in range(3))
    errs = {"K6": [0.0, 0.0], "K5": [0.0, 0.0], "K4": [0.0, 0.0]}

    def worst(name, a, frac):
        errs[name] = [max(errs[name][0], a), max(errs[name][1], frac)]

    with torch.inference_mode():
        for (flat, dims), w0l in zip(levels, [w.contiguous() for w in ifnet.fc0_blocks()]):
            args = (dims, cfg.align_corners, cfg.displacement)
            a, r = rel_err(level_fc0_cuda(flat, w0l, *p, *args),
                           level_fc0_plain(flat, w0l, *p, *args))
            worst("K6", a, r / K6_RTOL)
            worst("K5", *k5_error(level_features_banded_cuda(flat, *p, *args),
                                  level_features_banded_plain(flat, *p, *args)))
            a, r = rel_err(level_features_cuda(flat, *p, *args),
                           level_features_plain(flat, *p, *args))
            worst("K4", a, r / TRAIN_KERNEL_RTOL["K4"])
        torch.cuda.synchronize()
    return {k: tuple(v) for k, v in errs.items()}


def conv_output_layouts(ifnet, vox) -> list:
    """The memory layout in which cuDNN hands back each conv output of
    IFNet.encode, and each stage's output (what flatten_grid receives):
    "channels_last_3d", "contiguous" (NCDHW), "both" (C = 1 or a 1-voxel
    grid) or "other"."""
    def layout(x):
        cl = x.is_contiguous(memory_format=torch.channels_last_3d)
        return {(True, True): "both", (True, False): "contiguous",
                (False, True): "channels_last_3d"}.get((x.is_contiguous(), cl), "other")

    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o, name=name: seen.append(
        f"{name} C={o.shape[1]}: {layout(o)}"))
        for name, m in ifnet.stages.named_modules()
        if isinstance(m, torch.nn.Conv3d) or name.isdigit()]
    try:
        with torch.inference_mode():
            ifnet.encode(vox)
    finally:
        for h in hooks:
            h.remove()
    return seen


def feature_staging_ms(levels, p, args) -> dict:
    """K4 and K5 over every level, taken apart (CUDA-event medians): the
    staging alone (stage_channels_last, torch's transpose copy), and each
    kernel alone on levels that already lie channels-last (its wrapper
    reads them without staging)."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_banded_cuda,
        level_features_cuda,
        stage_channels_last,
    )

    cl = [(stage_channels_last(fl).transpose(1, 2), d) for fl, d in levels]
    return {
        # every level but a C = 1 one read once and written once
        "staging bound": bound(2 * nbytes(*(fl for fl, _ in levels if fl.shape[1] > 1)), 0)[0],
        "staging": cuda_ms(lambda: [stage_channels_last(fl) for fl, _ in levels]),
        "K4 kernel": cuda_ms(lambda: [level_features_cuda(v, *p, d, *args) for v, d in cl]),
        "K5 kernel": cuda_ms(lambda: [level_features_banded_cuda(v, *p, d, *args)
                                      for v, d in cl]),
    }


def print_staging(label: str, t: dict) -> None:
    print(f"  K4/K5 apart at the {label}: staging {t['staging']:.4f} ms over the 6 levels, "
          f"bound {t['staging bound']:.4f} ms (bytes); kernel alone on channels-last levels "
          f"K4 {t['K4 kernel']:.4f} ms, K5 {t['K5 kernel']:.4f} ms", flush=True)


def points_path(served, vox, pts_np, smi) -> dict:
    """The arbitrary-point path through evaluate_points: the three routes,
    their launches and agreement, K6/K5/K4/K3 checks and timings (K4 and K5
    with their staging apart), the layout of cuDNN's conv outputs, the
    unfused sweep through K3, and profiles.  Returns what the kernels line
    needs."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_points
    from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_fc0_cuda,
        level_features_banded_cuda,
        level_features_cuda,
        stage_channels_last,
    )
    from sv3d_tpu_torch.ops.lattice import slab_features
    from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain
    from sv3d_tpu_torch.ops.point_query import (
        level_fc0_plain,
        level_features_banded_plain,
        level_features_plain,
    )

    ifnet = served.ifnet
    cfg = ifnet.config
    dims = tuple(vox.shape[1:4])
    dev = vox.device
    n_tiles = -(-len(pts_np) // 65536)

    # -- the three routes through the entry point ---------------------------
    routes, launches, stagings = {}, {}, {}
    counters = (level_fc0_cuda, level_features_cuda, level_features_banded_cuda)
    for name, kw in (("K6", dict(bands="auto")), ("K4", dict(bands=None)),
                     ("gather", dict(use_kernel=False))):
        for counter in counters:
            counter.launches = 0
        stage_channels_last.copies = 0
        routes[name] = evaluate_points(ifnet, vox, pts_np, **kw)
        torch.cuda.synchronize()
        launches[name] = tuple(counter.launches for counter in counters)
        stagings[name] = stage_channels_last.copies
    diffs = {f"{a} vs {b}": float(np.abs(routes[a] - routes[b]).max())
             for a, b in (("K6", "gather"), ("K4", "gather"), ("K6", "K4"))}
    print(f"points path: evaluate_points at {len(pts_np)} points ({n_tiles} tiles of 65536), "
          f"launches (K6, K4, K5) by route {launches}, K4/K5 stagings by route {stagings}, "
          f"largest sigmoid differences {diffs} (tol {POINTS_TOL:g}), sigmoid in "
          f"[{routes['K6'].min():.4f}, {routes['K6'].max():.4f}]", flush=True)
    for name, v in routes.items():
        check(v.shape == (len(pts_np),) and v.dtype == np.float32 and bool(np.isfinite(v).all()),
              f"evaluate_points route {name}: {v.shape} {v.dtype}")
    check(max(diffs.values()) <= POINTS_TOL, f"evaluate_points routes disagree: {diffs}")
    n_levels = len(cfg.feature_channels)
    check(launches["K6"] == (n_levels * n_tiles, 0, 0)
          and launches["K4"] == (0, n_levels * n_tiles, 0)
          and launches["gather"] == (0, 0, 0), f"point kernels ran {launches}")
    # the K4 route stages its pyramid once a call: every level but C = 1
    staged_levels = sum(c > 1 for c in cfg.feature_channels)
    check(stagings == {"K6": 0, "K4": staged_levels, "gather": 0},
          f"K4/K5 stagings by route {stagings}, not {staged_levels} on the K4 route alone")

    # -- the kernels against their plain versions at full width -------------
    with torch.inference_mode():
        levels = ifnet.encode(vox)
    pts = torch.tensor(pts_np[None], device=dev)
    checks = point_kernel_checks(ifnet, levels, pts)
    what = {"K6": "1e-5 of the largest |partial|", "K5": "one bf16 ulp",
            "K4": "1e-5 of the largest |feature|"}
    for name, (a, frac) in checks.items():
        print(f"{name} on the served pyramid, {len(pts_np)} points: max_abs_err {a:.3e}, "
              f"{frac:.3f} of its bound ({what[name]})", flush=True)
        check(frac <= 1.0, f"{name} disagrees with its plain version: {frac} of its bound")
    print("cuDNN's conv outputs in IFNet.encode (served grid): "
          + ", ".join(conv_output_layouts(ifnet, vox)), flush=True)
    weights = [t.detach() for layer in ifnet.mlp for t in layer]
    with torch.inference_mode():
        f = slab_features(levels, dims, 1, 69, cfg.align_corners, cfg.displacement)[0]
        k3_err = float((fused_point_mlp(f, *weights) - fused_point_mlp_plain(f, *weights))
                       .abs().max())
    print(f"K3 fused_point_mlp on one full-width row, f {tuple(f.shape)}: max_abs_err "
          f"{k3_err:.3e} (tol {K3_TOL:g})", flush=True)
    check(k3_err <= K3_TOL, f"K3 disagrees with its plain version: {k3_err}")

    # -- the unfused sweep through K3, against the K2 default ---------------
    fused_point_mlp.launches = 0
    sweep_err = 0.0
    with torch.inference_mode():
        for rows, off in ((1, 0), (1, 69), (2, 137)):
            got = ifnet.query_lattice(levels, dims, 1, rows, off, fused_tail=False)
            ref = ifnet.query_lattice(levels, dims, 1, rows, off)
            check(bool(torch.isfinite(got).all()), f"unfused sweep non-finite at {off}+{rows}")
            sweep_err = max(sweep_err, float((got - ref).abs().max()))
        torch.cuda.synchronize()
    k3_launches = fused_point_mlp.launches
    print(f"unfused sweep: query_lattice(fused_tail=False) rows 0, 69, 137-138 against K2: "
          f"max_abs_err {sweep_err:.3e} (tol {K3_TOL:g}), K3 launches {k3_launches}", flush=True)
    check(sweep_err <= K3_TOL and k3_launches == 3, "the unfused sweep did not run through K3")

    # -- timings -------------------------------------------------------------
    p = tuple((2.0 * pts[..., i]).contiguous() for i in range(3))
    w0ls = [w.contiguous() for w in ifnet.fc0_blocks()]
    lv = list(levels)
    args = (cfg.align_corners, cfg.displacement)
    with torch.inference_mode():
        route_ms = {name: cuda_ms(lambda kw=kw: evaluate_points(ifnet, vox, pts_np, **kw),
                                  warmup=1, reps=3)
                    for name, kw in (("K6", dict(bands="auto")), ("K4", dict(bands=None)),
                                     ("gather", dict(use_kernel=False)))}
        timed = {
            "K6": (cuda_ms(lambda: [level_fc0_cuda(fl, w, *p, d, *args)
                                    for (fl, d), w in zip(lv, w0ls)]),
                   cuda_ms(lambda: [level_fc0_plain(fl, w, *p, d, *args)
                                    for (fl, d), w in zip(lv, w0ls)], warmup=1, reps=3)),
            "K5": (cuda_ms(lambda: [level_features_banded_cuda(fl, *p, d, *args) for fl, d in lv]),
                   cuda_ms(lambda: [level_features_banded_plain(fl, *p, d, *args)
                                    for fl, d in lv], warmup=1, reps=3)),
            "K3": (cuda_ms(lambda: fused_point_mlp(f, *weights)),
                   cuda_ms(lambda: fused_point_mlp_plain(f, *weights))),
        }
        k4_ms = (cuda_ms(lambda: [level_features_cuda(fl, *p, d, *args) for fl, d in lv]),
                 cuda_ms(lambda: [level_features_plain(fl, *p, d, *args) for fl, d in lv],
                         warmup=1, reps=3))
        staged = feature_staging_ms(lv, p, args)
    library = {"K5": grid_sample_ms(grid_sample_inputs(lv, p, *args), cfg.align_corners)}
    prof = profile_lines(lambda: evaluate_points(ifnet, vox, pts_np), steps=2)
    prof_k4 = profile_lines(lambda: evaluate_points(ifnet, vox, pts_np, bands=None), steps=2)
    print(f"points timings on {smi}:", flush=True)
    for name, ms in route_ms.items():
        print(f"  evaluate_points route {name}: median {ms:.3f} ms of 3, "
              f"{len(pts_np) / (ms / 1e3):.4g} points/s", flush=True)
    for name, (ms, plain) in timed.items():
        what = "1 row, 11,648 points" if name == "K3" else f"all 6 levels, {len(pts_np)} points"
        print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms ({what})", flush=True)
    # the levels' gathered sectors and the coordinates in; (1, N, 7 * sumC)
    # f32 out; 8 taps a feature
    lvl_bytes = gathered_bytes(lv, p, *args)
    pts_bytes = nbytes(*p)
    k4_bound = bound(lvl_bytes + pts_bytes + 4 * len(pts_np) * ifnet.feature_size,
                     16.0 * len(pts_np) * ifnet.feature_size)
    print(f"  K4 at the points shapes: {k4_ms[0]:.4f} ms, bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}), plain {k4_ms[1]:.4f} ms, F.grid_sample {library['K5']:.4f} ms "
          f"(all 6 levels, {len(pts_np)} points, B=1; gathered bytes {lvl_bytes} of the "
          f"levels' {nbytes(*(fl for fl, _ in lv))})", flush=True)
    print(f"  K5 library F.grid_sample over the 6 levels: {library['K5']:.4f} ms", flush=True)
    print_staging("points shapes, B=1", staged)
    for route, lines in (("bands=\"auto\"", prof), ("bands=None", prof_k4)):
        print(f"  profiled evaluate_points ({route}, {len(pts_np)} points):", flush=True)
        for line in lines:
            print(f"    {line}", flush=True)

    # -- bounds from this run's inputs ----------------------------------------
    n = len(pts_np)
    sum_c = sum(cfg.feature_channels)
    h0 = weights[0].shape[0]
    bounds = {
        # the levels' gathered sectors, fc0 blocks, coordinates in; six (1, N,
        # H) f32 partials out;
        # fc0 (2 * 7 * sumC * H a point) plus the features (16 a tap)
        "K6": bound(lvl_bytes + nbytes(*w0ls) + pts_bytes + 6 * n * h0 * 4,
                    2.0 * n * 7 * sum_c * h0 + 16.0 * n * 7 * sum_c),
        # the levels' gathered sectors and the coordinates in; (1, N, 7 *
        # sumC) bf16 out; 8 taps a feature
        "K5": bound(lvl_bytes + pts_bytes + n * 7 * sum_c * 2, 16.0 * n * 7 * sum_c),
        "K3": bound(nbytes(f, *weights) + f.shape[1] * 4,
                    2.0 * f.shape[1] * sum(w.shape[0] * w.shape[1] for w in weights[::2])),
    }
    del levels, f
    # K5 is on no route, as in the JAX package: its count over the three
    # routes, checked 0 above
    k5_launches = sum(route[2] for route in launches.values())
    return {"launches": {"K6": launches["K6"][0], "K5": k5_launches, "K3": k3_launches},
            "err": {"K6": checks["K6"][0], "K5": checks["K5"][0], "K3": k3_err},
            "ms": timed, "bounds": bounds, "library": library}


def _counters():
    from sv3d_tpu_torch.ops.cuda import point_query, voxelize

    return {"K1": voxelize.scatter_voxels_cuda, "K1b": voxelize.scatter_voxels_bwd_cuda,
            "K4": point_query.level_features_cuda, "K7": point_query.level_grad_points_cuda,
            "K8": point_query.level_grad_vol_cuda}


def train_kernel_checks(model, dev, rng) -> dict:
    """K1b, K4, K7 and K8 against their plain versions: the full-width
    net_res 128 pyramid (every level, align_corners False) at B=4 with 4096
    supervision + 4096 projected points, plus small dims with both
    align_corners conventions and channel counts that take K4's scalar path,
    its float4 path and its masked tail.  Returns {name: (max abs err, rel
    err, args)} with args the full-width arguments for the timings; and K5
    on the same levels, {"K5": (max abs err, fraction of one bf16 ulp)}."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_banded_cuda,
        level_features_cuda,
        level_grad_points_cuda,
        level_grad_vol_cuda,
    )
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_raw_cuda
    from sv3d_tpu_torch.ops.point_query import (
        level_features_banded_plain,
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
        k5 = [0.0, 0.0]
        cases = [(list(levels), gs, p, cfg.align_corners, cfg.displacement)]
        for c in (1, 3, 16, 64, 160):  # small dims, both conventions
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
                a, frac = k5_error(level_features_banded_cuda(flat, *pp, *args),
                                   level_features_banded_plain(flat, *pp, *args))
                k5 = [max(k5[0], a), max(k5[1], frac)]
        torch.cuda.synchronize()
    for name, (a, r) in errs.items():
        out[name] = (a, r, (levels, p, gs, cfg.align_corners, cfg.displacement))
    out["K5"] = tuple(k5)
    return out


def parity_config(data_root):
    """The configuration of the card-vs-CPU train step."""
    from sv3d_tpu_torch.config import Config

    return Config(seed=0, scale_factor=8, batch_size=2, num_points=256, subsample_points=512,
                  fused_query=True, datasetdir=str(data_root), splitsdir="overfit")


def parity_step(cfg, device, dtype=torch.float32, labels=None) -> dict:
    """One train step of cfg from its seeded weights on the first two samples
    and a fixed subsample, on device in dtype.  labels: the host labels of
    the subsample, or None (on the CPU) to label this run's eval-mode cloud,
    so that every run trains on one set of labels.  Returns the loss, the
    gradients, the state after the step (on the CPU) and the labels."""
    from sv3d_tpu_torch.data.loader import collate
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


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _profile(fn, steps: int):
    """torch.profiler over steps warm calls of fn (two warm-up calls first).
    Returns (profile, host-clock ms a call, device kernel ms a call, kernel
    events by device time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # the kernels themselves (device events), not the CPU ops that launched them
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _dev_us(e) > 0]
    events = sorted(kernels, key=_dev_us, reverse=True)
    return prof, wall, sum(_dev_us(e) for e in events) / 1e3 / steps, events


def _top_lines(events, device: float, steps: int, top: int = 15) -> list:
    lines = []
    for e in events[:top]:
        ms = _dev_us(e) / 1e3 / steps
        lines.append(f"  {ms:9.3f} ms {100.0 * ms / device:5.1f}%  x{e.count // steps:<4d} "
                     f"{e.key[:90]}")
    return lines


def profile_lines(fn, steps: int) -> list:
    """Host-clock ms, device kernel ms, the device's idle share and the top
    kernels by device time of one warm call of fn.  Returns printable lines."""
    _, wall, device, events = _profile(fn, steps)
    return [f"{wall:.3f} ms host clock, {device:.3f} ms device self time, device idle "
            f"{100.0 * (1.0 - device / wall):.1f}% (torch.profiler, {steps} calls)",
            *_top_lines(events, device, steps, top=10)]


def profile_train_step(trainer, batch, gen, steps: int = 3) -> list:
    """Where a warm full-width fused_query train step spends its time: the
    host-clock step, the summed device self time of torch.profiler's CUDA
    activity, the host labelling of the projected cloud alone, and the top
    kernels by device time.  Returns printable lines."""
    state = trainer.build_state()
    prof, wall, device, events = _profile(lambda: trainer.train_step(state, batch, gen), steps)
    pc = torch.tensor(np.random.default_rng(0).uniform(-0.5, 0.5, (4, 4096, 3)).astype(np.float32))
    label_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.label_cloud(pc, batch)
        label_ms.append((time.perf_counter() - t0) * 1e3)
    lines = [f"profiled fused_query step: {wall:.3f} ms host clock, {device:.3f} ms device self "
             f"time, device idle {100.0 * (1.0 - device / wall):.1f}%; host labelling of "
             f"4x4096 points {statistics.median(label_ms):.3f} ms (median of 5)"]
    lines += _top_lines(events, device, steps)
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

    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.dense_grid import (
        evaluate_on_grid,
        evaluate_on_grid_device,
        evaluate_points,
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
    from sv3d_tpu_torch import native

    geom = native.build()  # the host geometry library
    print(f"build: {lib.name} and {geom.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

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
    # arbitrary points on the CPU's grid: the card's K6 route against the CPU's gathers
    small_pts = np.random.default_rng(4).uniform(-0.45, 0.45, (16384, 3)).astype(np.float32)
    card_pts = evaluate_points(small_gpu.ifnet, v, small_pts, tile_points=4096)
    cpu_pts = evaluate_points(small_cpu.ifnet, v, small_pts, tile_points=4096)
    pts_err = float(np.abs(card_pts - cpu_pts).max())
    print(f"evaluate_points at scale_factor 8, 16384 points, card (K6) vs CPU plain: "
          f"max_abs_err {pts_err:.3e} (tol {POINTS_TOL:g})", flush=True)
    check(pts_err <= POINTS_TOL, f"card evaluate_points disagrees with the CPU's: {pts_err}")

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
    n_slab = dims[1] * dims[2]
    mlp_flops = 2.0 * n_slab * sum(w.shape[0] * w.shape[1] for w, _ in ifnet.mlp)
    bounds = {
        # points in, grid out; 8 corners of 4 flops a point
        "K1": bound(nbytes(pts, k1), 32.0 * pts.shape[1]),
        # levels and weights in, one row of logits out; the decoder plus 8
        # taps of 2 flops a feature
        "K2": bound(nbytes(*levels.flats, *(t for layer in ifnet.mlp for t in layer))
                    + n_slab * 4, mlp_flops + 16.0 * n_slab * ifnet.feature_size),
    }
    del levels

    # -- phase 6b: the arbitrary-point path on the served grid ----------------
    pts_np = np.random.default_rng(3).uniform(-0.45, 0.45, (N_POINTS, 3)).astype(np.float32)
    pp = points_path(served, vox, pts_np, smi)
    del served, vox

    # -- phase 7: training kernels against their plain versions -------------
    tk = train_kernel_checks(model, dev, rng)
    k5_train = tk.pop("K5")
    print(f"K5 at the training shapes: max_abs_err {k5_train[0]:.3e}, {k5_train[1]:.3f} of its "
          "bound (one bf16 ulp)", flush=True)
    check(k5_train[1] <= 1.0, f"K5 disagrees with its plain version: {k5_train[1]}")
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
    from sv3d_tpu_torch.data.loader import collate

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
    train_staged = feature_staging_ms(lv, p, (ac, disp))
    gs_inputs = grid_sample_inputs(lv, p, ac, disp)
    library = {"K4": grid_sample_ms(gs_inputs, ac), "K7": grid_sample_ms(gs_inputs, ac, "points"),
               "K8": grid_sample_ms(gs_inputs, ac, "level"), **pp["library"]}
    del gs_inputs
    n_feat = p[0].numel() * 7 * sum(f.shape[1] for f, _ in lv)  # B * N * 7 * sumC
    train_gathered = gathered_bytes(lv, p, ac, disp)
    print(f"  K4/K7 gathered bytes at the training shapes: {train_gathered} of the levels' "
          f"{nbytes(*levels.flats)}", flush=True)
    k1b_pts = tk["K1b"][2][0]
    bounds.update(pp["bounds"])
    bounds.update({
        # points, raw grid and cotangent in, the points' gradient out; 8
        # corners of 6 flops a point
        "K1b": bound(nbytes(*tk["K1b"][2], k1b_pts), 48.0 * k1b_pts.shape[0] * k1b_pts.shape[1]),
        # the levels' gathered sectors and the coordinates in, f32 features
        # out; 8 taps of 2 flops
        "K4": bound(train_gathered + nbytes(*p) + 4 * n_feat, 16.0 * n_feat),
        # the levels' gathered sectors, coordinates and cotangent in, (B, N,
        # 3) out; 8 taps of 8 flops
        "K7": bound(train_gathered + nbytes(*p, *gs) + 3 * 4 * p[0].numel(), 64.0 * n_feat),
        # coordinates and cotangent in, the levels' whole (dense) gradient
        # out; 8 taps of 2 flops
        "K8": bound(nbytes(*p, *gs, *levels.flats), 16.0 * n_feat),
    })
    prof_lines = profile_train_step(trainer, batch, gen)
    print(f"training timings on {smi}:", flush=True)
    for fused, ms in step_ms.items():
        print(f"  full-width train step, B=4, 8192 query points, fused_query={fused}: "
              f"median {ms:.3f} ms of 5", flush=True)
    for name, (ms, plain) in kernel_ms.items():
        what = "80,896 points" if name == "K1b" else "all 6 levels, B=4 x 8192 points"
        print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms ({what})", flush=True)
    print_staging("training shapes, B=4 x 8192", train_staged)
    for line in prof_lines:
        print(f"  {line}", flush=True)
    print(f"  library calls: K4 F.grid_sample {library['K4']:.4f} ms, its backward for the "
          f"points K7 {library['K7']:.4f} ms and for the levels K8 {library['K8']:.4f} ms "
          "(all 6 levels, B=4 x 8192 points)", flush=True)

    measured = {
        "K1": (launches["scatter_voxels"], k1_err, k1_ms, k1_plain_ms),
        "K2": (launches["lattice_sweep"], k2_err, k2_ms, k2_plain_ms),
        **{k: (train_launches[k], tk[k][0], *kernel_ms[k]) for k in ("K1b", "K4", "K7", "K8")},
        **{k: (pp["launches"][k], pp["err"][k], *pp["ms"][k]) for k in ("K3", "K5", "K6")},
    }
    kernels = []
    for key, name, source, replaces in (
        ("K1", "scatter_voxels", "voxelize.cu", "sv3d_tpu/ops/pallas/voxelize.py:130"),
        ("K1b", "scatter_voxels_bwd", "voxelize.cu", "sv3d_tpu/ops/pallas/voxelize.py:224"),
        ("K2", "lattice_sweep", "sweep.cu", "sv3d_tpu/ops/pallas/sweep.py:162"),
        ("K3", "fused_point_mlp", "mlp.cu", "sv3d_tpu/ops/pallas/mlp.py:41"),
        ("K4", "level_features", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:439"),
        ("K5", "level_features_banded", "point_query.cu",
         "sv3d_tpu/ops/pallas/point_query.py:692"),
        ("K6", "level_fc0", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:968"),
        ("K7", "level_grad_points", "point_query.cu",
         "sv3d_tpu/ops/pallas/point_query_bwd.py:172"),
        ("K8", "level_grad_vol", "point_query.cu", "sv3d_tpu/ops/pallas/point_query_bwd.py:365"),
    ):
        n, err, ms, plain = measured[key]
        kernels.append({
            "name": name, "route": "cuda", "source": f"sv3d_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library.get(key)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
