"""Smoke run of the PyTorch + CUDA port (sv3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from sv3d_tpu_torch/csrc (and the host
geometry library) and holds each kernel against its plain torch version at
the shapes of the path that runs it.  Then drives the port's paths through
their own entry points, at full width with seeded random weights, and checks
that each ran its kernels:

  serving   one seeded 240x320 RGB array to a mesh (load_model -> predict ->
            implicit_to_mesh), net_res 128, scale_factor 1, dims
            (139, 104, 112): kernels K1 (scatter) and K2 bf16 (dense sweep,
            the JAX package's compute dtype); K2 f32 (compute_dtype
            float32, the parity route) is held to its plain version, timed
            and run on the card-vs-CPU slice;
  points    evaluate_points on the served model and grid at 262,144 uniform
            points in [-0.45, 0.45]^3, five routes: bf16 (the default, the
            JAX package's class) through kernel K6 bf16 (bands="auto", fc0
            on the tensor cores in the kernel) or kernel K5 (bands=None);
            float32 through kernel K6 (f32) or kernel K4; and the exact
            gather path; the f32 routes must agree with the gathers, the
            bf16 ones within their class; then the unfused dense sweep
            (query_lattice(fused_tail=False)): kernel K3 (decoder), bf16
            on the tensor cores and f32, held on one full-width row against
            their plain versions and timed beside the cuBLAS bf16 and f32
            chains;
  training  SceneNetTrainer(...).fit on a seeded one-scene dataset tree that
            the script writes, B=4, 2x2048 supervision + 4096 projected
            points, fused_query: kernels K1, K1b (scatter backward), K4
            (point features), K7 and K8 (their backward);
  IF-Net-only workflow  a seeded raw tree (the box scene with its distance
            field, and a view past the far plane) through the preprocessing
            CLI (the bad view quarantined); ImplicitRefinementTrainer(...).fit
            on it at full width, B=16 x 4096 points, fused_query: kernels K4
            and K8 (the points are data, so no K7) and, in its meshed
            validations, K2 bf16; its meshes normalized (scaled_obj) and
            scored by the evaluation CLI; an analytic box pair of IoU 1/3;
  UNet-only DepthRegressorTrainer(...).fit, UNetMini (B=16) and UNet
            (resize_input), whose checkpoint warm-starts SceneNetTrainer.
  precision 16 (bf16 mixed precision, the UNet and IF-Net convs in bf16)
            serving: predict.main --precision 16 at full width (K1, K2 bf16
            on the bf16 pyramid), the scale-8 slice card vs CPU, image->mesh
            and evaluate_points (K6 bf16) beside precision 32; training: each
            trainer's fit at precision 16 (end to end B=4: K1, K1b, K4, K7,
            K8; IF-Net-only B=16: K4, K8; UNet-only), its loss drop, warm step,
            peak memory and top kernels beside f32, one step card vs CPU; and
            a short quality.overfit run in both precisions.
  bench     phase 23: K2 bf16 on the res_increase-2 lattice (278 x 208 x
            224, 12,952,576 points) held on three 8-row slabs against its
            plain version and timed; K1, K1b, K4, K7 and K8 held against
            their plain versions at the bench's B=8 shapes; then the port's
            bench in this process, headline.main (dense sweep per slab_rows,
            the reference scheme, image->mesh at res_increase 2, arbitrary
            points) and measure_step.main --set all (ops, the five train
            steps and the fused three with the cloud, the serving A/B), 3
            timed runs each: K1, K1b, K2 bf16, K4, K5, K6 bf16, K7, K8.
  multiscene  phase 24: quality.multiscene --stage all at full width, the
            scene-scaling protocol (--use_unet, B=4, precision 32) on 4
            train, 1 val and 1 test synthetic scene, 2 steps: the data
            stage, training (K1, K1b), validation, and the test scene meshed
            (K1, K2 bf16) and scored; its artifact's figures must be finite.
  wgrad     phase 25: the f32 conv weight-gradient kernel
            (csrc/conv3d_wgrad.cu) at the IF-Net 128 pyramid's nine shapes
            and the IF-Net 32 pyramid's six (B=4 on the 139x104x112 grid,
            channels-last as the step hands them), ConvONet's room_grid64
            U-Net's 14 (B=32 on 64^3 to 8^3) and four ragged ones,
            held to its plain version in float64 and to itself (equal
            bits), and timed beside its bound and cuDNN's weight gradient
            with and without cudnn.benchmark.  The f32 train steps'
            profiles (phases 11 and 18) must hold it and not cuDNN's direct
            weight-gradient kernel.
  dgrad     phase 26: the f32 conv input-gradient kernel
            (csrc/conv3d_dgrad.cu) at ConvONet's room_grid64 U-Net's 14
            shapes (B=32 on 64^3 to 8^3, NCDHW as the U-Net hands them) and
            four ragged ones, held to float64 by input channel and to itself
            (equal bits), and timed beside its bound (the weight gradient's:
            the same operations and bytes) and cuDNN's input gradient with
            and without cudnn.benchmark, on NCDHW and on channels-last dy;
            one f32 IF-Net 128 train step at B=4 shows which input
            gradients the route gives the kernel (a channels-last dy keeps
            cuDNN's), and where it takes any, their nine shapes are held and
            timed too.  One f32 ConvONet room_grid64 SceneNetTrainer step
            at B=32 must launch the dgrad and wgrad kernels 14 times each
            (the IF-Net fit paths above none of dgrad), and its warm step is
            timed as the port runs it, with dx from cuDNN on NCDHW, with the
            U-Net's input channels-last, and with every conv channels-last.

K1 and K1b are held against their plain versions on a uniform random
depth per pixel, on the rendered box scene of the training data and on a
degenerate input whose every warp adds to one voxel, and timed at B=1 and
B=4 (per call, and device time by part from torch.profiler) beside the
F.grid_sample call that computes each and the global atomics that K1
issues.  K5 is also held against its plain version at the training path's
shapes.
K4 and K5 read a channels-last copy of each level that their wrappers
stage (evaluate_points stages its pyramid once a call, rounded to bf16 on
the bf16 routes); the script times the staging and the kernels apart, at
both shapes, and prints the layout in which cuDNN returns the conv outputs
that the levels come from.  K8 is timed per level, with the count of global
atomic operations it issues.  K4, K7 and K8 are also held and timed at the
IF-Net-only trainer's shape.

It also resumes each fit from its checkpoint, checks that each trainer's
loss drops over 10 steps on one fixed batch, holds one f32 train step of
each trainer on the card (kernels) and on the CPU (plain versions) against
the same step in float64 on the CPU, and times kernels, paths and the train
steps with CUDA events, beside each kernel's bound on the card and the time
of one PyTorch library call that computes the same function, where there is
one.  The precision-16 phases (19-21) come last and fit 4 steps each; the
earlier paths keep their depth.  Imports nothing of JAX.  Raises (exit code
1) without CUDA, when
sv3d_tpu_torch is not beside it (the script copied alone) and when any phase
fails.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not (Path(__file__).resolve().parent / "sv3d_tpu_torch").is_dir():
    # the script copied without the repository: nothing to build or run
    raise RuntimeError("chip_smoke: sv3d_tpu_torch/ is not beside the script; run it from "
                       "the root of a checkout")

from sv3d_tpu_torch.bench.timing import (  # noqa: E402 (after the check above)
    PEAK_BF16_TENSOR_FLOPS,
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    dev_us,
    device_ms,
    host_ms,
    profile_calls,
    window_kernels,
)
from sv3d_tpu_torch.ops.cuda import rel_mean_err  # noqa: E402
from sv3d_tpu_torch.ops.cuda.conv3d_dgrad import DGRAD_RTOL  # noqa: E402
from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import WGRAD_RTOL  # noqa: E402
from sv3d_tpu_torch.ops.cuda.mlp import K3_BF16_REL_MEAN_TOL, K3_BF16_TOL, K3_TOL  # noqa: E402
from sv3d_tpu_torch.ops.cuda.point_query import (  # noqa: E402
    K4_RTOL,
    K5_ULP,
    K6_BF16_REL_MEAN_TOL,
    K6_BF16_TOL,
    K6_RTOL,
    K7_RTOL,
    K8_RTOL,
)
from sv3d_tpu_torch.ops.cuda.sweep import K2_BF16_REL_MEAN_TOL, K2_BF16_TOL, K2_TOL  # noqa: E402
from sv3d_tpu_torch.ops.cuda.voxelize import K1B_RTOL, K1_TOL, base_voxels, k1_raw_tol  # noqa: E402
from sv3d_tpu_torch.quality.box_scene import (  # noqa: E402
    INTRINSICS,
    degenerate_points,
    iou_box_pair,
    k1_atomics,
    k1_points,
    seeded_scene_net,
    write_raw_tree,
    write_smoke_dataset,
)

SLICE_TOL = 1e-4  # card vs CPU sigmoid grid of the small-scale slice, float32
# the same in bf16 (the default); measured 9.2e-5 on the H100, the JAX
# package's own mixed-precision bound is 2e-2
SLICE_BF16_TOL = 1e-3
TRAIN_KERNEL_RTOL = {"K1b": K1B_RTOL, "K4": K4_RTOL, "K7": K7_RTOL, "K8": K8_RTOL}
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
# the warm train step's peak device memory when the scatter's wrapper kept
# its raw grid for the backward (max_memory_allocated on an NVIDIA H100 80GB
# HBM3, 700.00 W, with one K1b check grid and cotangent of this script held)
PEAK_RAW_GRID_MIB = 5343.5
STEP_GRAD_RTOL = 1e-2
# Precision 16 (bf16 convs) on the card against the CPU port's precision 16:
# one program, the convs summed in another order.  Serving (eval mode): the
# scale-8 slice's logits within P16_LOGIT_RTOL of the largest |logit|, its
# sigmoid grid within the JAX package's mixed-precision bound 2e-2 (the CPU
# port is 3.6e-4 from the JAX package there, tests/test_torch_precision_e2e.py).
P16_LOGIT_RTOL = 2e-2
P16_SLICE_TOL = 2e-2
# One precision-16 train step, card and CPU, held to the CPU's f32 step of
# the same weights and batch with the error budget of the CPU's own bf16
# step, per gradient tensor: ||g_card16 - g_cpu32|| <= P16_GRAD_BUDGET *
# ||g_cpu16 - g_cpu32|| + P16_GRAD_FLOOR * ||g_cpu32||; the loss within
# P16_LOSS_RTOL of the CPU's bf16 loss.  A bf16 step at scale_factor 8 is
# chaotic (a 1e-6 change of the input moves the UNet's gradients as far), so
# two bf16 runs are compared through the f32 witness, as
# tests/test_torch_precision_e2e.py compares the CPU port with the JAX package.
P16_GRAD_BUDGET = 3.0
P16_GRAD_FLOOR = 2e-2
P16_LOSS_RTOL = 1e-2
GRID_GRAD_RTOL = 2e-2
# The biases of the UNetMini convs that feed a train-mode BatchNorm: their
# gradient is exactly 0 in exact arithmetic (the batch mean absorbs a constant
# shift), so two implementations compute different rounding residue there,
# held to 1e-4 of their weight's gradient, and step up to lr either way.
BN_FED_BIASES = ("unet.down.1.bias", "unet.down.2.bias", "unet.same.0.bias",
                 "unet.same.1.bias", "unet.same.2.bias")
POINTS_TOL = 1e-5  # the f32 evaluate_points routes and the gathers, and card vs CPU, on the sigmoid
# the bf16 routes (K6 bf16, K5) against the f32 gathers and against each
# other, on the sigmoid: the JAX package's bf16 point query is held to its
# exact path at ~1e-2 relative on logits; the CPU port's bf16 routes came
# within 4e-4 of the exact path at small dims (tests/test_torch_points.py)
POINTS_BF16_TOL = 2e-3
# the card's bf16 routes against the CPU port's (the same rounding points, f32
# sums in another order): on the sigmoid (measured up to 1.1e-4 on the H100
# at scale 8), and mean |logit difference| <= POINTS_BF16_REL_MEAN_TOL x mean
# |logit|.  A point passes some 4,600 bf16 roundings (features, fc0
# partials, hidden values), and sums in another order flip a few of them
# per point, so the card's bf16 routes sit at up to 7.2e-4 of the mean
# |logit| at scale 8 (1.1e-4 to 3.0e-4 at the card tests' dims), while a
# run in another class -- the f32 route, or a bf16 route with its tail in
# f32 -- is off at every point by 2.4e-3 (net_res 32 on the CPU) to 7.0e-3
# and fails (points_card_vs_cpu)
POINTS_BF16_CARD_TOL = 3e-4
POINTS_BF16_REL_MEAN_TOL = 1.5e-3
N_POINTS = 262144  # the JAX package's arbitrary-point measurement (bench.py)
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


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs error, max abs error / max(1e-30, max |ref|))."""
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def scatter_library_grid(points: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """F.grid_sample's (B, 1, 1, N, 3) grid for the scatter's library
    yardsticks: 2p with the axes reversed (x = axis 2), align_corners=True
    (then grid_sample's index (x + 1) / 2 (d - 1) is the scatter's
    (p + 0.5)(d - 1) in the same f32 steps), the points the scatter drops
    moved outside, where zeros padding drops all their corners."""
    kept = ((points > -0.5 + eps) & (points < 0.5 - eps)).all(dim=-1, keepdim=True)
    return torch.where(kept, 2.0 * points, 4.0).flip(-1)[:, None, None].contiguous()


def k1_library(points: torch.Tensor, dims, raw: torch.Tensor) -> tuple:
    """K1's library yardstick: F.grid_sample's backward for the volume (C =
    1, cotangent ones), which is the raw scatter.  Returns (CUDA-event ms of
    the backward alone, its max difference from raw relative to max |raw|)."""
    import torch.nn.functional as F

    grid = scatter_library_grid(points)
    with torch.enable_grad():
        vol = torch.zeros((points.shape[0], 1, *dims), device=points.device, requires_grad=True)
        out = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        ones = torch.ones_like(out)
        call = lambda: torch.autograd.grad(out, vol, ones, retain_graph=True)[0]
        err = rel_err(call()[:, 0], raw)[1]
        return cuda_ms(call), err


def k1b_library(points: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
                ref: torch.Tensor) -> tuple:
    """K1b's library yardstick: F.grid_sample's backward for the grid, on
    the cotangent masked where 0 < grid < 1 (cotangent ones): half of K1b's
    gradient with the axes reversed.  Returns (CUDA-event ms of the backward
    alone, its difference from ref, K1b's plain result, relative to max
    |ref|)."""
    import torch.nn.functional as F

    masked = torch.where((grid > 0.0) & (grid < 1.0), grad, 0.0)[:, None].contiguous()
    with torch.enable_grad():
        sgrid = scatter_library_grid(points).requires_grad_()
        out = F.grid_sample(masked, sgrid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        ones = torch.ones_like(out)
        call = lambda: torch.autograd.grad(out, sgrid, ones, retain_graph=True)[0]
        err = rel_err(2.0 * call()[:, 0, 0].flip(-1), ref)[1]
        return cuda_ms(call), err


def k1b_bytes(points: torch.Tensor, grid: torch.Tensor, grad: torch.Tensor,
              eps: float = 1e-6) -> int:
    """The least bytes K1b moves on these points: the distinct 32-byte
    sectors of the clamped grid and of the cotangent (in its own strides)
    that the kept points' in-range corners touch, the points in and the
    (B, N, 3) gradient out."""
    dims = grid.shape[1:]
    _, batch, i = base_voxels(points, dims, eps)
    sectors = 0
    for t in (grid, grad):
        sb, s0, s1, s2 = t.stride()
        addr = []
        for c0, c1, c2 in itertools.product((0, 1), repeat=3):
            a, bb, k = i[0] + c0, i[1] + c1, i[2] + c2
            ok = (a < dims[0]) & (bb < dims[1]) & (k < dims[2])
            addr.append((batch * sb + a * s0 + bb * s1 + k * s2)[ok])
        sectors += int(torch.unique(torch.cat(addr) // 8).numel())  # 8 floats a sector
    return 32 * sectors + 2 * nbytes(points)


def one_kernel_a_call(fn, part: str, counter, calls: int = 10, tries: int = 6) -> list:
    """Check that each call of fn launches one kernel, whose name holds
    part, and runs no other: in every profiled window (window_kernels)
    counter rises by `calls`, no other kernel shows, and that kernel shows
    no more often than counter counted; and one of up to `tries` windows
    holds every launch.  The profiler now and then loses device events
    (seen on the H100: 9 of 10 launches in a window, and in one run 2, 0
    and 0 of 10 in three windows in a row), never adds one, so a short
    window is profiled again.  Returns the windows profiled."""
    seen = []
    for _ in range(tries):
        kernels, launched = window_kernels(fn, calls, counter)
        seen.append((kernels, launched))
        check(launched == calls and all(part in k for k in kernels)
              and sum(kernels.values()) <= launched,
              f"{calls} calls ran other kernels than one {part} each: {seen}")
        if sum(kernels.values()) == launched:
            return seen
    check(False, f"no profiled window of {tries} held every launch of {part}: {seen}")


def bound(n_bytes: float, flops: float, tensor_flops: float = 0.0) -> tuple:
    """The least time the card could take for work that moves n_bytes
    (each input read once, each output written once), does flops f32
    operations outside the tensor cores and tensor_flops bf16 operations on
    them, the two units at work at once: (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, tensor_flops / PEAK_BF16_TENSOR_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gathered_bytes(levels, p, align_corners, displacement, itemsize: int = 4) -> int:
    """The least bytes that a gather of the 7 displaced copies x 8 corners
    of these points must read from the (B, C, G) levels held in itemsize
    bytes a value (4: f32, 2: bf16), on this run's
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
            run = itemsize * c
            first, last = rows * run // 32, ((rows + 1) * run - 1) // 32
            sectors = int((last - first + 1).sum()) - int((last[:-1] == first[1:]).sum())
            total += min(32 * sectors, flat.numel() * itemsize)
    return total


def touched_slices(levels, r, rows, row_offset, align_corners, displacement) -> list:
    """Per level, how many axis-0 slices the displaced axis-0 taps of nonzero
    weight of lattice rows [row_offset, row_offset + rows) touch."""
    from sv3d_tpu_torch.ops.cuda.sweep import sweep_tables

    chans = [flat.shape[1] for flat, _ in levels]
    meta, idx, w = sweep_tables(chans, [d for _, d in levels], r, rows, row_offset,
                                align_corners, displacement)
    blocks = [slice(m[4], m[4] + 3 * rows) for m in meta]
    return [len(np.unique(idx[b][w[b] != 0])) for b in blocks]


def separable_interp_flops(size_in, size_out) -> float:
    """The least f32 operations that resizing one channel of a level
    (size_in) to the 7 displaced copies of a lattice (size_out) needs: one
    axis at a time, as the JAX kernel's resize matrices do, 3 operations (a
    2-tap lerp) an output value, the copies sharing every pass they have in
    common (3 distinct results after the first axis, 5 after the second, 7
    after the third), in the cheapest axis order."""
    best = float("inf")
    for order in itertools.permutations(range(3)):
        size, ops = list(size_in), 0.0
        for copies, ax in zip((3, 5, 7), order):
            size[ax] = size_out[ax]
            ops += 3.0 * copies * math.prod(size)
        best = min(best, ops)
    return best


def sweep_bound(ifnet, levels, r, rows, row_offset, dtype) -> tuple:
    """K2's bound on this run's levels for lattice rows [row_offset,
    row_offset + rows): the levels' touched axis-0 slices (bf16 or f32) and
    the weights in, the logits out; the decoder's products (on the tensor
    cores in bf16, beside the f32 units) and the interpolation's f32
    operations at the separable minimum (separable_interp_flops)."""
    cfg = ifnet.config
    lv = list(levels)
    b = lv[0][0].shape[0]
    n = b * rows * r[1] * r[2]
    el = 2 if dtype == torch.bfloat16 else 4
    slices = touched_slices(lv, r, rows, row_offset, cfg.align_corners, cfg.displacement)
    weights = [t for layer in ifnet.mlp for t in layer]
    n_bytes = (sum(b * s * g1 * g2 * flat.shape[1] * el
                   for (flat, (_, g1, g2)), s in zip(lv, slices))
               + sum(w.numel() for w in weights[::2]) * el + nbytes(*weights[1::2]) + n * 4)
    mlp = 2.0 * n * sum(w.shape[0] * w.shape[1] for w, _ in ifnet.mlp)
    interp = sum(b * flat.shape[1] * separable_interp_flops((s, g1, g2), (rows, r[1], r[2]))
                 for (flat, (_, g1, g2)), s in zip(lv, slices))
    if dtype == torch.bfloat16:
        fc_out = 2.0 * n * ifnet.mlp[3][0].numel()
        return bound(n_bytes, interp + fc_out, mlp - fc_out)
    return bound(n_bytes, interp + mlp)


def plain_bf16_sweep(levels, mlp, r, rows, row_offset, align_corners, displacement,
                     skip=()) -> torch.Tensor:
    """lattice_sweep_plain's bf16 arithmetic with the rounding points named
    in skip left out: "feature" keeps the interpolated feature in f32,
    "hidden" the ReLU outputs.  With skip=() it is lattice_sweep_plain(...,
    torch.bfloat16) bit for bit; with a point left out, what a K2 bf16 that
    rounds at the wrong points would give, to show that K2's limits fail it."""
    from sv3d_tpu_torch.ops.lattice import slab_features

    rounded = lambda t: t.to(torch.bfloat16).float()
    keep = lambda t, point: t if point in skip else rounded(t)
    levels = [(rounded(flat), dims) for flat, dims in levels]
    mlp = [(rounded(w), b) for w, b in mlp]
    out = []
    for row in range(row_offset, row_offset + rows):
        h = keep(slab_features(levels, r, 1, row, align_corners, displacement), "feature")
        for i, (w, b) in enumerate(mlp):
            h = torch.einsum("hf,bfn->bhn", w, h) + b[:, None]
            if i < len(mlp) - 1:
                h = keep(torch.relu(h), "hidden")
        out.append(h[:, 0].reshape(h.shape[0], 1, r[1], r[2]))
    return torch.cat(out, dim=1)


def plain_bf16_fc0(flat, w0l, p, dims, align_corners, displacement, skip=()):
    """level_fc0_plain(..., torch.bfloat16) with the rounding points named in
    skip left out ("level", "feature", "partial"): with skip=() it is the
    plain bf16 partial bit for bit; with a point left out, what a K6 bf16
    that rounds at the wrong points would give, to show that K6 bf16's mean
    limit fails it."""
    from sv3d_tpu_torch.ops.point_query import level_features_plain

    rounded = lambda t: t.to(torch.bfloat16).float()
    keep = lambda t, point: t if point in skip else rounded(t)
    f = level_features_plain(keep(flat.float(), "level"), *p, dims, align_corners, displacement)
    return keep(keep(f, "feature") @ rounded(w0l.float()), "partial")


def plain_bf16_mlp(f, w0, b0, w1, b1, w2, b2, w3, b3, skip=()) -> torch.Tensor:
    """fused_point_mlp_plain(..., compute_dtype=torch.bfloat16) with the
    rounding points named in skip left out ("feature": the features f,
    "hidden": the ReLU outputs): with skip=() it is the plain bf16 decoder
    bit for bit; with a rounding point left out, what a K3 that ignores it
    would give, to show that K3 bf16's mean limit fails it."""
    rounded = lambda t: t.to(torch.bfloat16).float()
    layers = ((w0, b0), (w1, b1), (w2, b2), (w3, b3))
    h = f if "feature" in skip else rounded(f)
    for i, (w, b) in enumerate(layers):
        h = torch.einsum("hf,...fn->...hn", rounded(w), h) + b[:, None]
        if i < len(layers) - 1:
            h = torch.relu(h) if "hidden" in skip else rounded(torch.relu(h))
    return h[..., 0, :]


def logits_of(sigmoid: np.ndarray) -> np.ndarray:
    """The logits (f64) behind evaluate_points' f32 sigmoid values."""
    s = sigmoid.astype(np.float64)
    return np.log(s) - np.log1p(-s)


def points_card_vs_cpu(card, cpu, grid, pts, tile_points) -> dict:
    """evaluate_points on the card (IFNet card) against the CPU port (IFNet
    cpu, the same weights) on the same grid and points, route by route (K6
    bf16, K5 bf16, K6 f32, K4 f32; the card's gathers against the CPU's),
    each as (largest sigmoid difference, mean |logit difference| / mean
    |logit|); and, against the CPU's bf16 route of each bands, the mean
    measure of two runs in another precision class: the card's f32 route,
    and the CPU's bf16 route with its MLP tail in f32."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_points

    f32 = torch.float32
    routes = {"K6 bf16": dict(bands="auto"), "K5 bf16": dict(bands=None),
              "K6 f32": dict(bands="auto", compute_dtype=f32),
              "K4 f32": dict(bands=None, compute_dtype=f32), "gather": dict(use_kernel=False)}
    run = lambda model, kw: evaluate_points(model, grid, pts, tile_points=tile_points,
                                            **{"use_kernel": True, **kw})
    measure = lambda got, ref: (float(np.abs(got - ref).max()),
                                float(np.abs(logits_of(got) - logits_of(ref)).mean()
                                      / np.abs(logits_of(ref)).mean()))
    got = {name: measure(run(card, kw), run(cpu, kw)) for name, kw in routes.items()}
    wrong = {}
    for name in ("K6 bf16", "K5 bf16"):
        kw = routes[name]
        ref = run(cpu, kw)
        wrong[f"{name}: card f32"] = measure(run(card, {**kw, "compute_dtype": f32}), ref)[1]
        # the tail of a run in another class: fc1, fc2 and fc_out in f32
        cpu._mlp_tail = lambda h, compute_dtype=f32: type(cpu)._mlp_tail(cpu, h, f32)
        try:
            wrong[f"{name}: tail in f32"] = measure(run(cpu, kw), ref)[1]
        finally:
            del cpu._mlp_tail
    return {"routes": got, "wrong": wrong}


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
    served pyramid at the points path's (1, N_POINTS) query, K5 on the level
    rounded to bf16 and staged channels-last (as the bf16 bands=None route
    hands it).  Returns {name: (max abs err, max err as a fraction of its
    bound)}."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_fc0_cuda,
        level_features_banded_cuda,
        level_features_cuda,
        stage_channels_last,
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
        for (flat, dims), w0l in zip(levels, ifnet.fc0_operands(4, torch.float32)):
            args = (dims, cfg.align_corners, cfg.displacement)
            got = level_fc0_cuda(flat, w0l, *p, *args)
            a, r = rel_err(got, level_fc0_plain(flat, w0l, *p, *args))
            worst("K6", a, r / K6_RTOL)
            # K6 f32 reads the level channels-last: a staged view and the
            # channel-major flat (staged in the wrapper) give the same partial
            cl = stage_channels_last(flat).transpose(1, 2)
            check(torch.equal(level_fc0_cuda(cl, w0l, *p, *args), got),
                  f"K6 f32 gives another partial on a staged level (C {flat.shape[1]})")
            level16 = stage_channels_last(flat.to(torch.bfloat16)).transpose(1, 2)
            worst("K5", *k5_error(level_features_banded_cuda(level16, *p, *args),
                                  level_features_banded_plain(level16, *p, *args)))
            a, r = rel_err(level_features_cuda(flat, *p, *args),
                           level_features_plain(flat, *p, *args))
            worst("K4", a, r / TRAIN_KERNEL_RTOL["K4"])
        torch.cuda.synchronize()
    return {k: tuple(v) for k, v in errs.items()}


def k6_bf16_checks(ifnet, levels, pts) -> dict:
    """K6 bf16 against its plain bf16 version on every level of the served
    pyramid (staged bf16 channels-last, as evaluate_points does) at the
    points path's (1, N_POINTS) query: the largest error as a fraction of
    the largest |partial| (worst level), the mean error over all levels'
    partials as a fraction of their mean |partial|, and the same mean for
    the plain version with each rounding point left out (plain_bf16_fc0)."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        fc0_block_bf16,
        level_fc0_bf16_cuda,
        stage_channels_last,
    )

    cfg = ifnet.config
    p = tuple((2.0 * pts[..., i]).contiguous() for i in range(3))
    args = (cfg.align_corners, cfg.displacement)
    out = {"max": 0.0, "abs": 0.0}
    diff = ref_sum = 0.0
    wrong = {"level": 0.0, "feature": 0.0, "partial": 0.0}
    count = 0
    with torch.inference_mode():
        for (flat, dims), w0l in zip(levels, ifnet.fc0_blocks()):
            level = stage_channels_last(flat.to(torch.bfloat16)).transpose(1, 2)
            got = level_fc0_bf16_cuda(level, fc0_block_bf16(w0l), *p, dims, *args)
            ref = plain_bf16_fc0(flat, w0l, p, dims, *args)
            a, r = rel_err(got, ref)
            out["abs"], out["max"] = max(out["abs"], a), max(out["max"], r)
            diff += float((got - ref).abs().sum())
            ref_sum += float(ref.abs().sum())
            count += ref.numel()
            for skip in wrong:
                variant = plain_bf16_fc0(flat, w0l, p, dims, *args, skip=(skip,))
                wrong[skip] += float((variant - ref).abs().sum())
        torch.cuda.synchronize()
    out["mean"] = diff / ref_sum
    out["wrong"] = {k: v / ref_sum for k, v in wrong.items()}
    return out


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


def bf16_chain(f, w0t, b0, w1t, b1, w2t, b2, w3t, b3) -> torch.Tensor:
    """K3 bf16's library yardstick: the decoder as a chain of cuBLAS bf16
    products (ops/mlp.py::matmul_bf16: operands rounded to bf16, f32 out),
    bias and ReLU between them in f32, the next product rounding them, then
    the fc_out product; w_it the transposed weights already in bf16."""
    from sv3d_tpu_torch.ops.mlp import matmul_bf16

    h = f.t()
    for w, b in ((w0t, b0), (w1t, b1), (w2t, b2)):
        h = torch.relu(matmul_bf16(h, w) + b)
    return (matmul_bf16(h, w3t) + b3)[:, 0]


def f32_chain(f, w0, b0, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """K3 f32's library yardstick: the decoder as a chain of cuBLAS f32
    products (TF32 off, as the script runs), bias and ReLU between them."""
    import torch.nn.functional as F

    h = f.t()
    for w, b in ((w0, b0), (w1, b1), (w2, b2)):
        h = torch.relu(F.linear(h, w, b))
    return F.linear(h, w3, b3)[:, 0]


def k3_checks(f, weights) -> dict:
    """K3 on one full-width lattice row f (F, N): both kernels against their
    plain versions (bf16 also on the mean limit, which the plain bf16
    decoder with its hidden rounding left out must fail; the features left
    unrounded is printed beside it), with and without mlp_operands; the
    kernels of bf16 calls (one_kernel_a_call: K3's own, one a call, and
    nothing else); times (CUDA events, torch.profiler's device time),
    bounds and the cuBLAS bf16 chain."""
    from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp, mlp_operands
    from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain

    bf16, f32 = torch.bfloat16, torch.float32
    # points a block of K3 bf16 (csrc/mlp.cu: 64 at H0 256, 32 at H0 512)
    tile = 64 if weights[0].shape[0] == 256 else 32
    ops = {dt: mlp_operands(weights, dt) for dt in (f32, bf16)}
    wt = [w.t().to(bf16) if i % 2 == 0 else w for i, w in enumerate(weights)]
    err, ref = {}, {}
    with torch.inference_mode():
        for dt in (f32, bf16):
            got = fused_point_mlp(f, *weights, compute_dtype=dt, operands=ops[dt])
            check(torch.equal(got, fused_point_mlp(f, *weights, compute_dtype=dt)),
                  f"K3 {dt} differs with and without operands")
            ref[dt] = fused_point_mlp_plain(f, *weights, compute_dtype=dt)
            err[dt] = float((got - ref[dt]).abs().max())
        mean = rel_mean_err(got, ref[bf16])
        check(torch.equal(plain_bf16_mlp(f, *weights), ref[bf16]),
              "plain_bf16_mlp is not the plain bf16 decoder")
        wrong = {}
        for skip in ("hidden", "feature"):
            w = plain_bf16_mlp(f, *weights, skip=(skip,))
            wrong[skip] = (float((w - ref[bf16]).abs().max()), rel_mean_err(w, ref[bf16]))
        chain = bf16_chain(f, *wt)
        chain_err = (float((chain - ref[bf16]).abs().max()), rel_mean_err(chain, ref[bf16]))
        chain32_err = float((f32_chain(f, *weights) - ref[f32]).abs().max())
    torch.cuda.synchronize()
    print(f"K3 fused_point_mlp on one full-width row, f {tuple(f.shape)}: max_abs_err bf16 "
          f"{err[bf16]:.3e} (tol {K3_BF16_TOL:g}), mean_abs_err / mean |logit| {mean:.3e} (tol "
          f"{K3_BF16_REL_MEAN_TOL:g}); f32 {err[f32]:.3e} (tol {K3_TOL:g}); the plain bf16 "
          f"decoder with its hidden "
          f"rounding left out: max_abs_err {wrong['hidden'][0]:.3e}, mean "
          f"{wrong['hidden'][1]:.3e} (K3 bf16's mean limit fails it); with its features left "
          f"unrounded: {wrong['feature'][0]:.3e}, mean {wrong['feature'][1]:.3e} (the mean limit "
          f"{'fails' if wrong['feature'][1] > K3_BF16_REL_MEAN_TOL else 'does NOT fail'} it); "
          f"the cuBLAS bf16 chain: {chain_err[0]:.3e}, mean {chain_err[1]:.3e}; the cuBLAS f32 "
          f"chain against the plain f32 decoder {chain32_err:.3e} (tol {K3_TOL:g})", flush=True)
    check(err[f32] <= K3_TOL and err[bf16] <= K3_BF16_TOL and mean <= K3_BF16_REL_MEAN_TOL,
          f"K3 disagrees with its plain version: {err}, mean {mean}")
    check(wrong["hidden"][1] > K3_BF16_REL_MEAN_TOL,
          f"K3 bf16's mean limit would pass a decoder without its hidden rounding: {wrong}")
    check(chain32_err <= K3_TOL, f"the cuBLAS f32 chain disagrees with K3's plain f32: "
          f"{chain32_err}")

    call = lambda: fused_point_mlp(f, *weights, compute_dtype=bf16, operands=ops[bf16])
    call32 = lambda: fused_point_mlp(f, *weights, operands=ops[f32])
    with torch.inference_mode():
        windows = one_kernel_a_call(call, "fused_point_mlp_bf16",
                                    lambda: fused_point_mlp.launches)
        dev = device_ms(call, ["fused_point_mlp_bf16"])["fused_point_mlp_bf16"]
        # K3 f32's kernel is fused_point_mlp_kernel<kM, HP>, a name that the
        # bf16 kernel's does not hold
        windows32 = one_kernel_a_call(call32, "fused_point_mlp_kernel",
                                      lambda: fused_point_mlp.launches)
        dev32 = device_ms(call32, ["fused_point_mlp_kernel"])["fused_point_mlp_kernel"]
        ms = {
            "K3": (cuda_ms(call, reps=21),
                   cuda_ms(lambda: fused_point_mlp_plain(f, *weights, compute_dtype=bf16))),
            "K3f32": (cuda_ms(lambda: fused_point_mlp(f, *weights, operands=ops[f32])),
                      cuda_ms(lambda: fused_point_mlp_plain(f, *weights))),
        }
        call_ms = cuda_ms(lambda: fused_point_mlp(f, *weights, compute_dtype=bf16), reps=21)
        chain_ms = cuda_ms(lambda: bf16_chain(f, *wt), reps=21)
        chain32_ms = cuda_ms(lambda: f32_chain(f, *weights), reps=21)
        # the kernel and the chain in turns, K3, chain, chain, K3: 30 calls
        # back to back between two events, so the device, not the host,
        # sets the pace
        turns = {"K3": [], "chain": [], "K3f32": [], "chain32": []}
        for key in ("K3", "chain", "chain", "K3", "K3f32", "chain32", "chain32", "K3f32"):
            fn = {"K3": call, "chain": lambda: bf16_chain(f, *wt), "K3f32": call32,
                  "chain32": lambda: f32_chain(f, *weights)}[key]
            turns[key].append(cuda_ms(lambda fn=fn: [fn() for _ in range(30)], reps=5) / 30)
    n_feat, n = f.shape
    w, b = weights[::2], weights[1::2]
    macs = sum(x.shape[0] * x.shape[1] for x in w[:3])
    bounds = {
        # f32 features in once, the bf16 weights and f32 biases, the logits
        # out; fc0-fc2 on the tensor cores, fc_out's dot on the f32 units
        "K3": bound(nbytes(f, *b) + 2 * sum(x.numel() for x in w) + 4 * n,
                    2.0 * n * w[3].numel(), 2.0 * n * macs),
        # all in f32, every product on the f32 units
        "K3f32": bound(nbytes(f, *weights) + 4 * n,
                       2.0 * n * sum(x.shape[0] * x.shape[1] for x in w)),
    }
    print(f"  K3 bf16 (1 row, {n:,} points): {ms['K3'][0]:.4f} ms a call with mlp_operands "
          f"(CUDA events), {call_ms:.4f} ms with the operands made in the call; kernel "
          f"{dev:.4f} ms (torch.profiler), the only kernel of the call (K3 kernels / launches "
          f"by profiled window of 10 calls: "
          + ", ".join(f"{sum(k.values())}/{n}" for k, n in windows)
          + f"), {tile} points a block; bound "
          f"{bounds['K3'][0]:.4f} ms ({bounds['K3'][1]}); plain {ms['K3'][1]:.4f} ms; the "
          f"cuBLAS bf16 chain {chain_ms:.4f} ms a call", flush=True)
    print("  K3 bf16 back to back (ms a call, in turns): "
          + ", ".join(f"{t:.4f}" for t in turns["K3"]) + "; the cuBLAS bf16 chain "
          + ", ".join(f"{t:.4f}" for t in turns["chain"]), flush=True)
    print(f"  K3 f32 (1 row): {ms['K3f32'][0]:.4f} ms a call with mlp_operands (CUDA events), "
          f"kernel {dev32:.4f} ms (torch.profiler), the only kernel of the call (K3 kernels / "
          f"launches by profiled window of 10 calls: "
          + ", ".join(f"{sum(k.values())}/{n}" for k, n in windows32)
          + f"); bound {bounds['K3f32'][0]:.4f} ms ({bounds['K3f32'][1]}), plain "
          f"{ms['K3f32'][1]:.4f} ms; the cuBLAS f32 chain (TF32 off) {chain32_ms:.4f} ms a call",
          flush=True)
    print("  K3 f32 back to back (ms a call, in turns): "
          + ", ".join(f"{t:.4f}" for t in turns["K3f32"]) + "; the cuBLAS f32 chain "
          + ", ".join(f"{t:.4f}" for t in turns["chain32"]), flush=True)
    return {"err": err, "ms": ms, "bounds": bounds, "device_ms": dev, "device_ms_f32": dev32,
            "turns": turns, "library_ms": {"K3": chain_ms, "K3f32": chain32_ms}}


POINT_ROUTES = (
    ("K6 bf16", dict(bands="auto")),  # the default
    ("K5 bf16", dict(bands=None)),
    ("K6 f32", dict(bands="auto", compute_dtype=torch.float32)),
    ("K4 f32", dict(bands=None, compute_dtype=torch.float32)),
    ("gather", dict(use_kernel=False)),
)


def points_path(served, vox, pts_np, smi) -> dict:
    """The arbitrary-point path through evaluate_points: the five routes,
    their launches and agreement, K6 bf16/K6/K5/K4/K3 checks and timings (K4
    and K5 with their staging apart, K6 bf16 per level), the layout of
    cuDNN's conv outputs, the unfused sweep through K3 in both dtypes, and
    profiles of the two bf16 routes.  Returns what the kernels line needs."""
    from sv3d_tpu_torch.inference.dense_grid import evaluate_points
    from sv3d_tpu_torch.ops.cuda.mlp import fused_point_mlp
    from sv3d_tpu_torch.ops.cuda.point_query import (
        fc0_block_bf16,
        level_fc0_bf16_cuda,
        level_fc0_cuda,
        level_features_banded_cuda,
        level_features_cuda,
        stage_channels_last,
    )
    from sv3d_tpu_torch.ops.lattice import slab_features
    from sv3d_tpu_torch.ops.mlp import matmul_bf16
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

    # -- the five routes through the entry point -----------------------------
    routes, launches, stagings = {}, {}, {}
    counters = {"K6 bf16": level_fc0_bf16_cuda, "K6": level_fc0_cuda, "K4": level_features_cuda,
                "K5": level_features_banded_cuda}
    for name, kw in POINT_ROUTES:
        for counter in counters.values():
            counter.launches = 0
        stage_channels_last.copies = 0
        routes[name] = evaluate_points(ifnet, vox, pts_np, **kw)
        torch.cuda.synchronize()
        launches[name] = {k: counter.launches for k, counter in counters.items()}
        stagings[name] = stage_channels_last.copies
    diffs = {f"{a} vs {b}": float(np.abs(routes[a] - routes[b]).max())
             for a, b in (("K6 f32", "gather"), ("K4 f32", "gather"), ("K6 f32", "K4 f32"))}
    diffs_bf16 = {f"{a} vs {b}": float(np.abs(routes[a] - routes[b]).max())
                  for a, b in (("K6 bf16", "gather"), ("K5 bf16", "gather"),
                               ("K6 bf16", "K5 bf16"))}
    print(f"points path: evaluate_points at {len(pts_np)} points ({n_tiles} tiles of 65536), "
          f"launches by route {launches}, stagings by route {stagings}; largest sigmoid "
          f"differences f32 {diffs} (tol {POINTS_TOL:g}), bf16 {diffs_bf16} (tol "
          f"{POINTS_BF16_TOL:g}); sigmoid in [{routes['K6 bf16'].min():.4f}, "
          f"{routes['K6 bf16'].max():.4f}]", flush=True)
    for name, v in routes.items():
        check(v.shape == (len(pts_np),) and v.dtype == np.float32 and bool(np.isfinite(v).all()),
              f"evaluate_points route {name}: {v.shape} {v.dtype}")
    check(max(diffs.values()) <= POINTS_TOL, f"evaluate_points f32 routes disagree: {diffs}")
    check(max(diffs_bf16.values()) <= POINTS_BF16_TOL,
          f"evaluate_points bf16 routes disagree: {diffs_bf16}")
    n_levels = len(cfg.feature_channels)
    want = {"K6 bf16": "K6 bf16", "K5 bf16": "K5", "K6 f32": "K6", "K4 f32": "K4", "gather": None}
    for name, kernel in want.items():
        check(launches[name] == {k: n_levels * n_tiles if k == kernel else 0 for k in counters},
              f"route {name} launched {launches[name]}")
    # each kernel route stages its pyramid once a call: every level but the
    # C = 1 one
    staged = sum(c > 1 for c in cfg.feature_channels)
    check(stagings == {"K6 bf16": staged, "K5 bf16": staged, "K6 f32": staged, "K4 f32": staged,
                       "gather": 0}, f"stagings by route {stagings}")
    check(evaluate_points(ifnet, vox, pts_np[:0]).shape == (0,), "evaluate_points on no points")

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
    k6b = k6_bf16_checks(ifnet, levels, pts)
    print(f"K6 bf16 on the served pyramid, {len(pts_np)} points, against its plain bf16 version: "
          f"max_abs_err {k6b['abs']:.3e}, {k6b['max']:.3e} of the largest |partial| (tol "
          f"{K6_BF16_TOL:g}), mean_abs_err / mean |partial| {k6b['mean']:.3e} (tol "
          f"{K6_BF16_REL_MEAN_TOL:g}); the plain version with a rounding point left out: "
          + ", ".join(f"{k} {v:.3e}" for k, v in k6b["wrong"].items())
          + ": K6 bf16's mean limit fails each", flush=True)
    check(k6b["max"] <= K6_BF16_TOL and k6b["mean"] <= K6_BF16_REL_MEAN_TOL,
          f"K6 bf16 disagrees with its plain version: {k6b}")
    check(min(k6b["wrong"].values()) > K6_BF16_REL_MEAN_TOL,
          f"K6 bf16's mean limit would pass a wrong rounding: {k6b['wrong']}")
    print("cuDNN's conv outputs in IFNet.encode (served grid): "
          + ", ".join(conv_output_layouts(ifnet, vox)), flush=True)
    weights = [t.detach() for layer in ifnet.mlp for t in layer]
    with torch.inference_mode():
        f = slab_features(levels, dims, 1, 69, cfg.align_corners, cfg.displacement)[0]
    k3 = k3_checks(f, weights)


    # -- the unfused sweep through K3, against K2 of the same dtype ----------
    k3_launches = {}
    for dtype, tol in ((torch.float32, K3_TOL), (torch.bfloat16, K2_BF16_TOL)):
        fused_point_mlp.launches = 0
        sweep_err = 0.0
        with torch.inference_mode():
            for rows, off in ((1, 0), (1, 69), (2, 137)):
                got = ifnet.query_lattice(levels, dims, 1, rows, off, dtype, fused_tail=False)
                ref = ifnet.query_lattice(levels, dims, 1, rows, off, dtype)
                check(bool(torch.isfinite(got).all()),
                      f"unfused sweep non-finite at {off}+{rows}")
                sweep_err = max(sweep_err, float((got - ref).abs().max()))
            torch.cuda.synchronize()
        k3_launches[dtype] = fused_point_mlp.launches
        print(f"unfused sweep at {str(dtype)[6:]}: query_lattice(fused_tail=False) rows 0, 69, "
              f"137-138 against K2: max_abs_err {sweep_err:.3e} (tol {tol:g}), K3 launches "
              f"{k3_launches[dtype]}", flush=True)
        check(sweep_err <= tol and k3_launches[dtype] == 3,
              f"the unfused {dtype} sweep did not run through K3")

    # -- timings -------------------------------------------------------------
    p = tuple((2.0 * pts[..., i]).contiguous() for i in range(3))
    w0ls = ifnet.fc0_operands(4, torch.float32)
    w0ks = ifnet.fc0_operands(4, torch.bfloat16)
    lv = list(levels)
    lv16 = [(stage_channels_last(fl.to(torch.bfloat16)).transpose(1, 2), d) for fl, d in lv]
    args = (cfg.align_corners, cfg.displacement)
    h0 = weights[0].shape[0]
    with torch.inference_mode():
        # the five routes in one call, in turns: first to last, then back
        route_ms = {name: [] for name, _ in POINT_ROUTES}
        for name, kw in (*POINT_ROUTES, *POINT_ROUTES[::-1]):
            route_ms[name].append(cuda_ms(lambda kw=kw: evaluate_points(ifnet, vox, pts_np, **kw),
                                          warmup=1, reps=3))
        k6b_out = torch.zeros((1, len(pts_np), h0), device=dev)
        # as query_fused runs K6 f32 and K4 + matmul: on the pyramid staged
        # channels-last once (evaluate_points'), the six partials summed in
        # one buffer that starts as fc0's bias
        lvcl = [(stage_channels_last(fl).transpose(1, 2), d) for fl, d in lv]
        bias = ifnet.fc0.bias.detach()

        def k6_levels():
            h = bias.expand(1, len(pts_np), h0).contiguous()
            for (fl, d), w in zip(lvcl, w0ls):
                level_fc0_cuda(fl, w, *p, d, *args, out=h)
            return h

        def k4_matmul_levels():
            h = bias
            for (fl, d), w in zip(lvcl, ifnet.fc0_blocks()):
                h = h + torch.matmul(level_features_cuda(fl, *p, d, *args), w)
            return h

        k6_pair = {"K6": [], "K4+matmul": []}
        for key in ("K6", "K4+matmul", "K4+matmul", "K6"):
            k6_pair[key].append(cuda_ms(k6_levels if key == "K6" else k4_matmul_levels))

        # the same for K6 bf16, as query_fused runs it with bands set, and its
        # two-call route, as the bf16 bands=None route runs it: K5 on the
        # staged bf16 pyramid, then matmul_bf16 with the level's rounded fc0
        # block
        w0rs = ifnet.fc0_operands(None, torch.bfloat16)

        def k6b_levels():
            h = bias.expand(1, len(pts_np), h0).contiguous()
            for (fl, d), w in zip(lv16, w0ks):
                level_fc0_bf16_cuda(fl, w, *p, d, *args, out=h)
            return h

        def k5_matmul_levels():
            h = bias
            for (fl, d), w in zip(lv16, w0rs):
                h = h + matmul_bf16(level_features_banded_cuda(fl, *p, d, *args), w)
            return h

        k6b_pair = {"K6bf16": [], "K5+matmul_bf16": []}
        for key in ("K6bf16", "K5+matmul_bf16", "K5+matmul_bf16", "K6bf16"):
            k6b_pair[key].append(cuda_ms(k6b_levels if key == "K6bf16" else k5_matmul_levels))
        # K2 bf16's two-call route: the unfused bf16 sweep (slab_features +
        # K3 bf16) over the served lattice, a row at a time (after k3_checks'
        # profiled windows)
        unfused_bf16_ms = cuda_ms(lambda: [ifnet.query_lattice(
            levels, dims, 1, 1, row, torch.bfloat16, fused_tail=False)
            for row in range(dims[0])], warmup=1, reps=3)
        k6_cm = cuda_ms(lambda: [level_fc0_cuda(fl, w, *p, d, *args)
                                 for (fl, d), w in zip(lv, w0ls)])
        timed = {
            "K6": (statistics.median(k6_pair["K6"]),
                   cuda_ms(lambda: [level_fc0_plain(fl, w, *p, d, *args)
                                    for (fl, d), w in zip(lv, w0ls)], warmup=1, reps=3)),
            # as query_fused runs it: the six levels adding into one buffer
            "K6bf16": (cuda_ms(lambda: [level_fc0_bf16_cuda(fl, w, *p, d, *args, out=k6b_out)
                                        for (fl, d), w in zip(lv16, w0ks)]),
                       cuda_ms(lambda: [plain_bf16_fc0(fl, w, p, d, *args)
                                        for (fl, d), w in zip(lv16, ifnet.fc0_blocks())],
                               warmup=1, reps=3)),
            # as the bf16 bands=None route runs it: on the staged bf16 pyramid
            "K5": (cuda_ms(lambda: [level_features_banded_cuda(fl, *p, d, *args)
                                    for fl, d in lv16]),
                   cuda_ms(lambda: [level_features_banded_plain(fl, *p, d, *args)
                                    for fl, d in lv16], warmup=1, reps=3)),
        }
        k6b_levels = [cuda_ms(lambda fl=fl, d=d, w=w: level_fc0_bf16_cuda(fl, w, *p, d, *args,
                                                                         out=k6b_out))
                      for (fl, d), w in zip(lv16, w0ks)]
        k4_ms = (cuda_ms(lambda: [level_features_cuda(fl, *p, d, *args) for fl, d in lv]),
                 cuda_ms(lambda: [level_features_plain(fl, *p, d, *args) for fl, d in lv],
                         warmup=1, reps=3))
        staged = feature_staging_ms(lv, p, args)
    library = {"K5": grid_sample_ms(grid_sample_inputs(lv, p, *args), cfg.align_corners)}
    prof = profile_lines(lambda: evaluate_points(ifnet, vox, pts_np), steps=2)
    prof_k5 = profile_lines(lambda: evaluate_points(ifnet, vox, pts_np, bands=None), steps=2)
    print(f"points timings on {smi}:", flush=True)
    for name, ms in route_ms.items():
        med = statistics.median(ms)
        print(f"  evaluate_points route {name}: {', '.join(f'{t:.3f}' for t in ms)} ms (each a "
              f"median of 3, in turns), {len(pts_np) / (med / 1e3):.4g} points/s", flush=True)
    faster = min(("K6 bf16", "K5 bf16"), key=lambda k: statistics.median(route_ms[k]))
    print(f"  the faster bf16 route: {faster} (bands={'auto' if faster == 'K6 bf16' else None})",
          flush=True)
    for name, (ms, plain) in timed.items():
        print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms (all 6 levels, {len(pts_np)} points)",
              flush=True)
    print(f"  K6 f32 over the 6 levels as query_fused runs it (staged channels-last, adding "
          f"into one buffer), in turns: " + ", ".join(f"{t:.4f}" for t in k6_pair["K6"])
          + " ms; K4 + the f32 torch.matmul over the same levels (the bands=None route, two "
          f"calls a level): " + ", ".join(f"{t:.4f}" for t in k6_pair["K4+matmul"])
          + f" ms; K6 f32 on the channel-major flats (each staged in the wrapper) {k6_cm:.4f} ms",
          flush=True)
    print(f"  K2's two-call route, the unfused bf16 sweep (slab_features + K3 bf16) over the "
          f"whole lattice, {dims[0]} rows of slab_rows 1: {unfused_bf16_ms:.3f} ms", flush=True)
    print(f"  K6 bf16 over the 6 levels as query_fused runs it (adding into one buffer), in "
          f"turns: " + ", ".join(f"{t:.4f}" for t in k6b_pair["K6bf16"]) + " ms; K5 + "
          f"matmul_bf16 over the same levels (the bf16 bands=None route, two calls a level): "
          + ", ".join(f"{t:.4f}" for t in k6b_pair["K5+matmul_bf16"]) + " ms", flush=True)
    print(f"  K6 bf16 by level (C {[fl.shape[1] for fl, _ in lv]}): "
          + ", ".join(f"{t:.4f}" for t in k6b_levels) + " ms", flush=True)
    # the levels' gathered sectors and the coordinates in; (1, N, 7 * sumC)
    # f32 out; 8 taps a feature
    lvl_bytes = gathered_bytes(lv, p, *args)
    lvl_bytes16 = gathered_bytes(lv, p, *args, itemsize=2)
    pts_bytes = nbytes(*p)
    k4_bound = bound(lvl_bytes + pts_bytes + 4 * len(pts_np) * ifnet.feature_size,
                     16.0 * len(pts_np) * ifnet.feature_size)
    print(f"  K4 at the points shapes: {k4_ms[0]:.4f} ms, bound {k4_bound[0]:.4f} ms "
          f"({k4_bound[1]}), plain {k4_ms[1]:.4f} ms, F.grid_sample {library['K5']:.4f} ms "
          f"(all 6 levels, {len(pts_np)} points, B=1; gathered bytes {lvl_bytes} of the "
          f"levels' {nbytes(*(fl for fl, _ in lv))})", flush=True)
    print(f"  K5 library F.grid_sample over the 6 levels: {library['K5']:.4f} ms", flush=True)
    print_staging("points shapes, B=1", staged)
    for route, lines in (("bands=\"auto\", bf16", prof), ("bands=None, bf16", prof_k5)):
        print(f"  profiled evaluate_points ({route}, {len(pts_np)} points):", flush=True)
        for line in lines:
            print(f"    {line}", flush=True)

    # -- bounds from this run's inputs ----------------------------------------
    n = len(pts_np)
    sum_c = sum(cfg.feature_channels)
    bounds = {
        # the levels' gathered sectors, fc0 blocks, coordinates in; six (1, N,
        # H) f32 partials out;
        # fc0 (2 * 7 * sumC * H a point) plus the features (16 a tap)
        "K6": bound(lvl_bytes + nbytes(*w0ls) + pts_bytes + 6 * n * h0 * 4,
                    2.0 * n * 7 * sum_c * h0 + 16.0 * n * 7 * sum_c),
        # the bf16 levels' gathered sectors, bf16 fc0 blocks, coordinates
        # in, the six partials' sum (1, N, H) f32 out; fc0 on the tensor
        # cores, the features' taps on the f32 units
        "K6bf16": bound(lvl_bytes16 + 2 * 7 * sum_c * h0 + pts_bytes + n * h0 * 4,
                        16.0 * n * 7 * sum_c, 2.0 * n * 7 * sum_c * h0),
        # the bf16 levels' gathered sectors and the coordinates in; (1, N, 7 *
        # sumC) bf16 out; 8 taps a feature
        "K5": bound(lvl_bytes16 + pts_bytes + n * 7 * sum_c * 2, 16.0 * n * 7 * sum_c),
    }
    print(f"  K6 bf16 bound {bounds['K6bf16'][0]:.4f} ms ({bounds['K6bf16'][1]}; gathered bf16 "
          f"bytes {lvl_bytes16})", flush=True)
    del levels, f, lv16, k6b_out, lvcl
    return {"launches": {"K6": launches["K6 f32"]["K6"], "K6bf16": launches["K6 bf16"]["K6 bf16"],
                         "K5": launches["K5 bf16"]["K5"], "K3": k3_launches[torch.bfloat16],
                         "K3f32": k3_launches[torch.float32]},
            "err": {"K6": checks["K6"][0], "K6bf16": k6b["abs"], "K5": checks["K5"][0],
                    "K3": k3["err"][torch.bfloat16], "K3f32": k3["err"][torch.float32]},
            "ms": {**timed, **k3["ms"]}, "bounds": {**bounds, **k3["bounds"]},
            "library": {**library, **k3["library_ms"]}, "K3 device_ms": k3["device_ms"],
            "K3f32 device_ms": k3["device_ms_f32"], "K6 yardstick": k6_pair,
            "K6bf16 yardstick": k6b_pair, "K2 yardstick": unfused_bf16_ms}


def k1_timings(inputs: dict, dims) -> dict:
    """K1 on each {(kind, B): points} input: CUDA-event ms a call (median
    of 51), the host's ms to return from it, device ms
    by part (torch.profiler: the scatter kernel alone, the memset and the
    clamp apart), the plain version's ms, the F.grid_sample yardstick (ms,
    and its difference from K1's raw sums), the bound (points in, grid out;
    8 corners of 4 flops a point) and the global atomics that K1 issues
    beside one a corner."""
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda, scatter_voxels_raw_cuda
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels

    out = {}
    with torch.no_grad():
        for key, p in inputs.items():
            call = lambda p=p: scatter_voxels_cuda(p, dims)
            dev = device_ms(call, ("scatter_voxels_kernel", "emset", "clamp_unit"))
            lib_ms, lib_err = k1_library(p, dims, scatter_voxels_raw_cuda(p, dims))
            out[key] = {
                "ms": cuda_ms(call, reps=51), "host_ms": host_ms(call),
                "plain_ms": cuda_ms(lambda p=p: scatter_voxels(p, dims)),
                "device": dev["all"], "kernel": dev["scatter_voxels_kernel"],
                "memset": dev["emset"], "clamp": dev["clamp_unit"],
                "library_ms": lib_ms, "library_err": lib_err,
                "bound": bound(nbytes(p, call()), 32.0 * p.shape[0] * p.shape[1]),
                "atomics": k1_atomics(p, dims)}
    return out


def k1b_timings(args: dict) -> dict:
    """K1b on each {kind: (points, clamped grid, cotangent)}: CUDA-event ms
    a call (median of 51), the host's ms to return from it, device ms of
    the kernel alone (torch.profiler), the plain version's ms, the
    F.grid_sample yardstick (ms, and its difference from the plain result)
    and the bound (touched sectors; 8 corners of 6 flops a point)."""
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels_bwd

    out = {}
    with torch.no_grad():
        for kind, (p, grid, g) in args.items():
            call = lambda: scatter_voxels_bwd_cuda(p, grid, g)
            ref = scatter_voxels_bwd(p, grid, g)
            lib_ms, lib_err = k1b_library(p, grid, g, ref)
            out[kind] = {"ms": cuda_ms(call, reps=51), "host_ms": host_ms(call),
                         "kernel": device_ms(call, ("scatter_voxels_bwd",))["scatter_voxels_bwd"],
                         "plain_ms": cuda_ms(lambda: scatter_voxels_bwd(p, grid, g)),
                         "library_ms": lib_ms, "library_err": lib_err,
                         "bound": bound(k1b_bytes(p, grid, g), 48.0 * p.shape[0] * p.shape[1])}
    return out


def _counters():
    """The training path's kernels' wrappers (launch_counters' names; wgrad
    and dgrad are the f32 3x3x3 convs' weight and input gradients: the
    IF-Net's convs take the weight gradient's kernel alone, ConvONet's
    U-Net's both)."""
    from sv3d_tpu_torch.ops.cuda import launch_counters

    return {k: v for k, v in launch_counters().items()
            if k in ("K1", "K1b", "K4", "K7", "K8", "wgrad", "dgrad")}


def train_kernel_checks(model, dev, rng, k1b_points: dict, n_query: int = 4096) -> dict:
    """K1b, K4, K7 and K8 against their plain versions.  K1b on each of
    k1b_points ({kind: (B, N, 3) points}), given the clamped grid of the
    forward, with the cotangent in the strides that the blur's einsum
    backward hands it (batch and axis 0 swapped) and contiguous.  K4, K7,
    K8: the full-width net_res 128 pyramid (every level, align_corners
    False) at the batch of k1b_points (B=4 on the training path) with
    n_query supervision + n_query projected points a sample, plus small
    dims with both align_corners conventions and channel counts that take
    K4's scalar path, its float4 path and its masked tail; K8's gradient
    checked to lie channels-last.
    Returns {name: (max abs err, rel err, args)} with args the full-width
    arguments for the timings (K1b: {kind: (points, clamped grid,
    cotangent)}); and K5 on the same levels, {"K5": (max abs err, fraction
    of one bf16 ulp)}."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_banded_cuda,
        level_features_cuda,
        level_grad_points_cuda,
        level_grad_vol_cuda,
    )
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_cuda
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
        k1b, k1b_args = [0.0, 0.0], {}
        for kind, pts in k1b_points.items():
            grid = scatter_voxels_cuda(pts, dims)
            g = torch.randn((dims[0], pts.shape[0], *dims[1:]), device=dev).transpose(0, 1)
            for cot in (g, g.contiguous()):
                a, r = rel_err(scatter_voxels_bwd_cuda(pts, grid, cot),
                               scatter_voxels_bwd(pts, grid, cot))
                k1b = [max(k1b[0], a), max(k1b[1], r)]
            k1b_args[kind] = (pts, grid, g)
        out["K1b"] = (*k1b, k1b_args)

        pc = k1b_points["random"][:, :240 * 320]
        levels = model.ifnet.encode(model.project(pc))
        sub = torch.tensor(rng.choice(pc.shape[1], n_query, replace=False), device=dev)
        b = pc.shape[0]
        sup = torch.tensor(rng.uniform(-0.5, 0.5, (b, n_query, 3)).astype(np.float32),
                           device=dev)
        q = torch.cat([pc[:, sub], sup], dim=1)
        p = tuple((2.0 * q[..., i]).contiguous() for i in range(3))
        gs = [torch.randn((b, q.shape[1], 7 * flat.shape[1]), device=dev) for flat in levels.flats]
        errs = {"K4": [0.0, 0.0], "K7": [0.0, 0.0], "K8": [0.0, 0.0]}
        k5 = [0.0, 0.0]
        cases = [(list(levels), gs, p, cfg.align_corners, cfg.displacement)]
        for c in (1, 3, 16, 64, 128, 160):  # small dims, both conventions
            small = torch.randn((2, c, 12 * 9 * 10), device=dev)
            ps = tuple(torch.tensor(rng.uniform(-1.2, 1.2, (2, 300)).astype(np.float32),
                                    device=dev) for _ in range(3))
            gsm = torch.randn((2, 300, 7 * c), device=dev)
            for ac, disp in ((True, 0.035), (False, 0.0722)):
                cases.append(([(small, (12, 9, 10))], [gsm], ps, ac, disp))
        for lv, grads, pp, ac, disp in cases:
            for (flat, ldims), gl in zip(lv, grads):
                args = (ldims, ac, disp)
                gvol = level_grad_vol_cuda(*pp, gl, *args)
                b, c, g = gvol.shape
                # the kernel's layout; the plain version's (on the CPU) is its own
                check(dev.type != "cuda" or gvol.stride() == (g * c, 1, c),
                      f"K8's gradient is not channels-last: strides {gvol.stride()}")
                for name, got, ref in (
                    ("K4", level_features_cuda(flat, *pp, *args),
                     level_features_plain(flat, *pp, *args)),
                    ("K7", level_grad_points_cuda(flat, *pp, gl, *args),
                     level_grad_points_plain(flat, *pp, gl, *args)),
                    ("K8", gvol, level_grad_vol_plain(*pp, gl, *args)),
                ):
                    a, r = rel_err(got, ref)
                    errs[name] = [max(errs[name][0], a), max(errs[name][1], r)]
                a, frac = k5_error(level_features_banded_cuda(flat, *pp, *args),
                                   level_features_banded_plain(flat, *pp, *args))
                k5 = [max(k5[0], a), max(k5[1], frac)]
        if dev.type == "cuda":
            torch.cuda.synchronize()
    for name, (a, r) in errs.items():
        out[name] = (a, r, (levels, p, gs, cfg.align_corners, cfg.displacement))
    out["K5"] = tuple(k5)
    return out


def k8_levels(levels, p, gs, ac, disp) -> list:
    """K8 at the training shapes level by level: CUDA-event medians, each
    level held to the plain version at 1e-5 relative, and the count of global
    atomic operations it issues on this run's corners (one a (point, copy,
    corner, 4-channel chunk) of nonzero weight, one a channel for C % 4 != 0)
    beside the old channel-major kernel's (one a (point, copy, corner,
    channel)).  Returns one dict a level."""
    from sv3d_tpu_torch.ops.cuda.point_query import level_grad_vol_cuda
    from sv3d_tpu_torch.ops.point_query import level_grad_vol_plain

    out = []
    for (flat, dims), g in zip(levels, gs):
        c, gsize = flat.shape[1], flat.shape[2]
        ref = level_grad_vol_plain(*p, g, dims, ac, disp)
        got = level_grad_vol_cuda(*p, g, dims, ac, disp)
        corners = int(corner_voxels(p, dims, ac, disp)[1].sum())
        out.append({"C": c, "G": gsize, "err": rel_err(got, ref)[1],
                    "ms": cuda_ms(lambda g=g, dims=dims: level_grad_vol_cuda(*p, g, dims, ac,
                                                                             disp)),
                    "atomics": corners * (c // 4 if c % 4 == 0 else c),
                    "atomics old": corners * c})
    return out


def corner_voxels(p, dims, align_corners, displacement) -> tuple:
    """The voxel index of each of the 8 corners of the 7 displaced copies of
    each point, and whether the corner is in range with a nonzero weight:
    two (8, B, 7N) tensors."""
    from sv3d_tpu_torch.ops.grid_sample import displacement_axes

    pd = displacement_axes(p, displacement)
    idx, frac, ok = [], [], []
    for q, size in zip(pd, dims):
        ix = ((q + 1.0) * 0.5 * (size - 1.0) if align_corners
              else ((q + 1.0) * size - 1.0) * 0.5)
        i = torch.floor(ix)
        idx.append(torch.stack([i, i + 1]).long())
        frac.append(torch.stack([1.0 - (ix - i), ix - i]))
        ok.append((idx[-1] >= 0) & (idx[-1] < size))
    vox = ((idx[0][:, None, None] * dims[1] + idx[1][None, :, None]) * dims[2]
           + idx[2][None, None, :]).reshape(8, *idx[0].shape[1:])
    w = (frac[0][:, None, None] * frac[1][None, :, None] * frac[2][None, None, :])
    valid = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    return vox, (valid & (w != 0)).reshape(8, *idx[0].shape[1:])


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
    from sv3d_tpu_torch.training.trainer_scene_net import (
        TENSORS,
        SceneNetTrainer,
        to_device,
        train_step,
    )

    trainer = SceneNetTrainer(cfg, device=device, experiment_dir=WORK / f"parity_{device}")
    ds = trainer.train_dataset()
    batch = to_device(collate([ds[0], ds[1]]), device, TENSORS)
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


def _against_exact(cfg, run, exact, bn_fed=BN_FED_BIASES) -> dict:
    """The f32 run against the float64 run, each difference as a fraction of
    its bound (STEP_* above); bn_fed names the conv biases that feed a
    train-mode BatchNorm."""
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
        if n in bn_fed:
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


def _top_lines(events, device: float, steps: int, top: int = 15) -> list:
    lines = []
    for e in events[:top]:
        ms = dev_us(e) / 1e3 / steps
        lines.append(f"  {ms:9.3f} ms {100.0 * ms / device:5.1f}%  x{e.count // steps:<4d} "
                     f"{e.key[:90]}")
    return lines


def profile_lines(fn, steps: int) -> list:
    """Host-clock ms, device kernel ms, the device's idle share and the top
    kernels by device time of one warm call of fn.  Returns printable lines."""
    _, wall, device, events = profile_calls(fn, steps)
    return [f"{wall:.3f} ms host clock, {device:.3f} ms device self time, device idle "
            f"{100.0 * (1.0 - device / wall):.1f}% (torch.profiler, {steps} calls)",
            *_top_lines(events, device, steps, top=10)]


def check_wgrad_kernels(events, what: str) -> None:
    """An f32 train step's profiled kernels hold the conv weight-gradient
    kernel and not cuDNN's direct weight-gradient kernel, which it
    replaces."""
    keys = [e.key for e in events]
    check(any("conv3d_wgrad_kernel" in k for k in keys)
          and not any("wgrad2d_grouped_direct_kernel" in k for k in keys),
          f"{what}: the conv weight-gradient kernel did not replace cuDNN's: {keys[:12]}")


def profile_train_step(trainer, batch, gen, steps: int = 3) -> list:
    """Where a warm full-width fused_query train step spends its time: the
    host-clock step, the summed device self time of torch.profiler's CUDA
    activity, the host labelling of the projected cloud alone, and the top
    kernels by device time.  Returns printable lines."""
    state = trainer.build_state()
    prof, wall, device, events = profile_calls(lambda: trainer.train_step(state, batch, gen), steps)
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
    for name, part in (("K8", "level_grad_vol"), ("K1", "scatter_voxels_kernel"),
                       ("K1's clamp", "clamp_unit"), ("K1b", "scatter_voxels_bwd"),
                       ("wgrad", "conv3d_wgrad")):
        ms = sum(dev_us(e) for e in events if part in e.key) / 1e3 / steps
        lines.append(f"  {name} ({part}): {ms:.4f} ms a step, {100.0 * ms / device:.3f}% of "
                     "device time")
    check_wgrad_kernels(events, "the end-to-end f32 step")
    # which convolutions the backward time belongs to (device time of the
    # kernels each aten op launched, by input shapes)
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::convolution_backward"]
    total = lambda e: getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
    for e in sorted(convs, key=total, reverse=True)[:4]:
        lines.append(f"  conv backward {total(e) / 1e3 / steps:9.3f} ms, grad/input/weight "
                     f"shapes {e.input_shapes[:3]}")
    return lines


def _step_variants() -> dict:
    """The train step as the port runs it and with one of its choices
    undone, as {name: (module, attribute, autograd.Function)} to patch in
    (None: the port): K8's gradient made channel-major (K8's old layout: one
    transpose copy a level of C > 1); level_features saving the
    channels-last copy that K4 read instead of the flat; K1b's cotangent
    made contiguous before the kernel (K1b's old wrapper; a copy, since the
    blur's einsum backward hands it with the batch and axis-0 strides
    swapped)."""
    from sv3d_tpu_torch.ops.cuda import point_query as pq
    from sv3d_tpu_torch.ops.cuda import voxelize as vx

    lf, sv = pq._LevelFeatures, vx._ScatterVoxels

    class ChannelMajor(lf):
        @staticmethod
        def backward(ctx, g):
            gvol, *rest = lf.backward(ctx, g)
            return (gvol.contiguous(), *rest)

    class SavesCopy(lf):
        @staticmethod
        def forward(ctx, flat, p0, p1, p2, dims, align_corners, displacement):
            level = pq.stage_channels_last(flat).transpose(1, 2)
            ctx.save_for_backward(level, p0, p1, p2)
            ctx.args = (dims, align_corners, displacement)
            return pq.level_features_cuda(level, p0, p1, p2, dims, align_corners, displacement)

    class ContiguousCotangent(sv):
        @staticmethod
        def backward(ctx, g):
            return sv.backward(ctx, g.contiguous())


    return {"port": None,
            "K8's gradient channel-major": (pq, "_LevelFeatures", ChannelMajor),
            "level_features saves the channels-last copy": (pq, "_LevelFeatures", SavesCopy),
            "K1b's cotangent made contiguous": (vx, "_ScatterVoxels", ContiguousCotangent)}


def _run_variant(variant, fn):
    """fn() with the variant's autograd.Function patched in."""
    if variant is None:
        return fn()
    module, attr, cls = variant
    kept = getattr(module, attr)
    setattr(module, attr, cls)
    try:
        return fn()
    finally:
        setattr(module, attr, kept)


def step_copy_kernels(trainer, batch, gen, names, steps: int = 2) -> dict:
    """The copy kernels (device kernels whose name says copy) of a warm
    full-width train step and their device ms a step, for each of the
    _step_variants() named: {name: (count, ms)}.  A copy that the port's
    layout caused further down would count in the port's run alone."""
    variants = _step_variants()
    state = trainer.build_state()
    out = {}
    for name in names:
        _, _, _, events = _run_variant(variants[name], lambda: profile_calls(
            lambda: trainer.train_step(state, batch, gen), steps))
        cp = [e for e in events if "copy" in e.key.lower()]
        out[name] = (sum(e.count for e in cp) / steps, sum(dev_us(e) for e in cp) / 1e3 / steps)
    return out


def step_peak_memory(trainer, batch, gen, names) -> dict:
    """Peak device memory of one warm full-width train step, for each of the
    _step_variants() named: {name: (torch.cuda.max_memory_allocated, the
    step's own rise: that peak less the memory allocated just before the
    step, which holds the state and whatever the caller keeps)}."""
    variants = _step_variants()
    state = trainer.build_state()

    def peak():
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        top = torch.cuda.max_memory_allocated()
        return top, top - before

    return {name: _run_variant(variants[name], peak) for name in names}


def _new_trainer(kind: str):
    """(trainer class, its module) of the IF-Net-only ("ifnet") or UNet-only
    ("unet") trainer."""
    from sv3d_tpu_torch.training import trainer_ifnet, trainer_unet

    if kind == "ifnet":
        return trainer_ifnet.ImplicitRefinementTrainer, trainer_ifnet
    return trainer_unet.DepthRegressorTrainer, trainer_unet


def fixed_batch(trainer, n: int) -> dict:
    """The first n samples of the trainer's train split, collated (host)."""
    from sv3d_tpu_torch.data.loader import collate

    ds = trainer.train_dataset()
    return collate([ds[i] for i in range(n)])


def new_trainer_step(kind: str, cfg, device, dtype=torch.float32) -> dict:
    """One train step of the IF-Net-only or UNet-only trainer from its
    seeded weights on the first two samples, on device in dtype (its module's
    train_step on the batch's device tensors).  Returns the loss, the
    gradients and the state after the step (on the CPU), as parity_step."""
    cls, mod = _new_trainer(kind)
    trainer = cls(cfg, device=device, experiment_dir=WORK / f"parity_{kind}_{device}")
    host = fixed_batch(trainer, 2)
    batch = {k: torch.as_tensor(np.asarray(host[k]), dtype=dtype, device=device)
             for k in mod.TENSORS}
    state = trainer.build_state()
    state.model.to(dtype)
    metrics = mod.train_step(state, batch) if kind == "ifnet" else mod.train_step(state, batch,
                                                                                   cfg)
    model = state.model
    return {
        "loss": float(next(iter(metrics.values()))),
        "grads": {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()},
        "state": {k: v.detach().cpu().double() for k, v in model.state_dict().items()},
    }


def new_step_parity(dev, kind: str, cfg) -> dict:
    """new_trainer_step on the card (kernels, f32) and on the CPU (plain
    versions, f32), each held to the same step on the CPU in float64, as
    step_parity holds the scene step."""
    exact = new_trainer_step(kind, cfg, "cpu", torch.float64)
    bn_fed = tuple(b[len("unet."):] for b in BN_FED_BIASES) if kind == "unet" else ()
    return {run: _against_exact(cfg, new_trainer_step(kind, cfg, device), exact, bn_fed)
            for run, device in (("card", dev), ("cpu", "cpu"))}


def preprocessing_phase(root: Path, scale_factor: int = 1,
                        num_samples: int = 100000) -> tuple:
    """write_raw_tree at root, then the preprocessing CLI on it.  Checks the
    processed view's four files and the far view's quarantine.  Returns
    (root, seconds of the CLI, samples it walked)."""
    from sv3d_tpu_torch.preprocessing.process_sample import cli_main as preprocess

    shutil.rmtree(root, ignore_errors=True)
    write_raw_tree(root)
    t0 = time.perf_counter()
    processed, quarantined = preprocess(["--datasetdir", str(root), "--splitsdir", "overfit",
                                         "--scale_factor", str(scale_factor),
                                         "--num_samples", str(num_samples)])
    seconds = time.perf_counter() - t0
    out = root / "processed" / "overfit" / "00000" / "00"
    files = ("depth_grid.npz", "target.df", "occupancy_0.01.npz", "occupancy_0.10.npz")
    check(all((out / f).exists() for f in files), f"preprocessing wrote {sorted(out.iterdir())}")
    check([Path(q).name for q in quarantined] == ["01"] and len(processed) == 1
          and (root / "raw" / "quarantine" / "overfit" / "00000" / "01").is_dir()
          and not (root / "raw" / "overfit" / "00000" / "01").exists(),
          f"the far view was not quarantined: {processed}, {quarantined}")
    return root, seconds, len(processed) + len(quarantined)


def read_metrics(exp_dir: Path) -> list:
    return [json.loads(line) for line in (exp_dir / "logs" / "metrics.jsonl").read_text()
            .splitlines()]


def checkpoint_serving_phase(ckpt: Path, rgb: Path, intrinsics: Path, out: Path,
                             device: str = "cuda", extra=()) -> dict:
    """predict.main, the serving CLI, on a trainer's checkpoint (ckpt, its
    checkpoints/last) and one RGB image: first the served model's sigmoid
    grid (load_model, predict, evaluate_on_grid), for its median level (a
    short fit's weights need not cross 0.5); then main at that level, with
    the serving kernels' counts set to 0 just before it and read just after.
    extra: more CLI flags (the architecture's).  Returns the level, the
    counts and the written mesh's vertex and face counts."""
    from sv3d_tpu_torch.data.datasets import _load_normalized_rgb
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid
    from sv3d_tpu_torch.inference.predict import build_parser, load_model, main, predict
    from sv3d_tpu_torch.io.mesh import load_obj
    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep_bf16_cuda, lattice_sweep_f32_cuda
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda

    argv = ["--checkpoint", str(ckpt), "--rgb", str(rgb), "--intrinsics", str(intrinsics),
            "--device", device, "--out", str(out), *extra]
    config, model = load_model(build_parser().parse_args(argv))
    vox, _ = predict(config, model,
                     rgb=_load_normalized_rgb(rgb, False, config.resize_input, config.W))
    level = 1.0 - float(np.median(evaluate_on_grid(model.ifnet, vox, config.dims)))
    del model, vox
    counters = {"scatter_voxels": scatter_voxels_cuda, "lattice_sweep_bf16":
                lattice_sweep_bf16_cuda, "lattice_sweep_f32": lattice_sweep_f32_cuda}
    for fn in counters.values():
        fn.launches = 0
    main(argv + ["--threshold", repr(level)])
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    mesh = load_obj(out / f"{rgb.parent.name}.obj")
    return {"level": level, "launches": launches, "verts": len(mesh.vertices),
            "faces": len(mesh.faces)}


def ifnet_fit_phase(cfg, counters) -> dict:
    """The IF-Net-only fit through the trainer's entry point: fit(12) with
    the kernel counters read around it (K7 must stay at 0: the step takes no
    gradient of its points), its logs, its two meshed
    validations (the GT mesh at cfg.dims) and one resumed step.  Returns
    {"launches", "seconds", "trainer", "vis"}."""
    from sv3d_tpu_torch.io.mesh import load_obj
    from sv3d_tpu_torch.training.trainer_ifnet import ImplicitRefinementTrainer

    exp = WORK / "fit_ifnet"
    for d in (exp, WORK / "fit_ifnet_resume"):
        shutil.rmtree(d, ignore_errors=True)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = ImplicitRefinementTrainer(cfg, device="cuda", experiment_dir=exp)
    state = trainer.fit(max_steps=12)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    recs = read_metrics(exp)
    losses = [r["train_ce_loss"] for r in recs if "train_ce_loss" in r]
    vals = [r["val_ce_loss"] for r in recs if "val_ce_loss" in r]
    vis = exp / "vis" / "00000" / "00000"
    gt = load_obj(vis / "00_gt.obj")
    pred_lines = (vis / "00_predicted.obj").read_text().splitlines()
    pred_faces = sum(line.startswith("f ") for line in pred_lines)
    target = trainer.val_dataset()[0]["target"]
    print(f"IF-Net-only fit: fit(max_steps=12) at B={cfg.batch_size}, {2 * cfg.num_points} points "
          f"a sample, dims {cfg.dims}, fused_query={cfg.fused_query}, in {seconds:.2f} s; "
          f"launches {launches}; logged train_ce_loss {losses}, val_ce_loss {vals}; meshes: "
          f"predicted {pred_faces} faces (level 0.5), GT {len(gt.faces)} faces in "
          f"[{gt.vertices.min(axis=0).round(2).tolist()}, "
          f"{gt.vertices.max(axis=0).round(2).tolist()}] (target {target.shape})", flush=True)
    # the step asks no gradient of its points (data), so K7 has nothing to do;
    # the pyramid's convs hand their gradients channels-last, so dgrad neither
    check(all(n > 0 for k, n in launches.items() if k not in ("K7", "dgrad"))
          and launches.get("K7", 0) == 0 and launches.get("dgrad", 0) == 0,
          f"the IF-Net-only path did not run K4, K8 and K2 bf16 (and not K7 and dgrad): "
          f"{launches}")
    check(state.step == 12 and len(losses) == 2 and bool(np.isfinite(losses).all())
          and len(vals) == 2 and bool(np.isfinite(vals).all()),
          "the IF-Net-only fit did not log finite losses and two validations")
    check(len(gt.faces) > 0, "the GT validation mesh has no faces")
    check(target.shape == (*cfg.dims, 1) and (gt.vertices.min(axis=0) >= 0).all()
          and (gt.vertices.max(axis=0) <= np.asarray(cfg.dims) - 1).all(),
          f"the GT mesh is not at the grid's dims {cfg.dims}")
    last = exp / "checkpoints" / "last"
    check(last.exists(), "checkpoints/last was not written")
    resumed = ImplicitRefinementTrainer(cfg.replace(resume=str(last)), device="cuda",
                                        experiment_dir=WORK / "fit_ifnet_resume")
    check(resumed.fit(max_steps=13).step == 13, "IF-Net-only resume did not step 12 -> 13")
    print("IF-Net-only resume: checkpoints/last restored at step 12, one more step to 13",
          flush=True)
    return {"launches": launches, "seconds": seconds, "trainer": trainer, "vis": vis,
            "model": state.model, "pred_faces": pred_faces}


def unet_fit_phase(cfg) -> dict:
    """The UNet-only fits: UNetMini, 12 steps with two validations writing
    depth maps; UNet (resize_input), 3 steps; then SceneNetTrainer warm-
    started from the UNetMini checkpoint (--pretrain_unet) holds it bit for
    bit.  Returns {"seconds": {variant: s}, "trainer": the UNetMini one}."""
    from sv3d_tpu_torch.io.exr import read_exr
    from sv3d_tpu_torch.training.checkpoint import restore_tree
    from sv3d_tpu_torch.training.trainer_unet import DepthRegressorTrainer

    seconds = {}
    for name, c, steps in (("UNetMini", cfg, 12),
                           ("UNet", cfg.replace(resize_input=True, visualize=False), 3)):
        exp = WORK / f"fit_unet_{name}"
        shutil.rmtree(exp, ignore_errors=True)
        t0 = time.perf_counter()
        trainer = DepthRegressorTrainer(c, device="cuda", experiment_dir=exp)
        state = trainer.fit(max_steps=steps)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        recs = read_metrics(exp)
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        vals = [r["val_loss"] for r in recs if "val_loss" in r]
        print(f"UNet-only fit, {name}: fit(max_steps={steps}) at B={c.batch_size} in "
              f"{seconds[name]:.2f} s; logged train_loss {losses}, val_loss {vals}", flush=True)
        check(state.step == steps and len(losses) >= 1 and bool(np.isfinite(losses).all()),
              f"the UNet-only fit ({name}) did not log finite losses")
        if name == "UNetMini":
            depth = read_exr(exp / "vis" / "00000" / "00000" / "depth_map.exr")
            d = next(iter(depth.values()))
            check(len(vals) == 2 and d.shape == (240, 320) and bool(np.isfinite(d).all()),
                  f"the UNet-only fit did not validate twice with a depth map: {vals}")
            mini, ckpt = trainer, exp / "checkpoints" / "last"
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    scene = SceneNetTrainer(cfg.replace(pretrain_unet=str(ckpt), batch_size=4),
                            device="cuda", experiment_dir=WORK / "warm")
    sd = scene.build_state().model.state_dict()
    saved = restore_tree(ckpt, map_location="cuda")["model"]
    unet_keys = [k for k in sd if k.startswith("unet.")]
    same = all(torch.equal(sd[k], saved[k[len("unet."):]]) for k in unet_keys)
    print(f"--pretrain_unet: SceneNetTrainer's {len(unet_keys)} unet. tensors equal the "
          f"UNet-only checkpoint's bit for bit: {same}", flush=True)
    check(same and len(unet_keys) == len(saved), "the warm start changed a unet. tensor")
    return {"seconds": seconds, "trainer": mini}


def loss_drops(trainer) -> list:
    """The losses of 10 train steps of a fresh state on one fixed batch of
    16."""
    batch = fixed_batch(trainer, 16)
    state = trainer.build_state()
    gen = torch.Generator().manual_seed(0)
    return [float(next(iter(trainer.train_step(state, batch, gen).values())))
            for _ in range(10)]


def evaluation_phase(fit: dict, dims) -> dict:
    """scaled_obj on the IF-Net-only fit's validation meshes and the
    evaluation CLI on the normalized predicted meshes against the
    normalized GT meshes (in its own working directory); then the analytic
    pair (a box against itself shifted by half its width: IoU 1/3) at the
    default n_points.  Twelve steps from random weights may leave the
    prediction on one side of 0.5 everywhere (an empty mesh, which the
    evaluation cannot load): the predicted meshes scored are then the
    fitted model's on the same grid at the median of its occupancy field,
    as phase 4's smoke mesh is."""
    import os

    from sv3d_tpu_torch.evaluation.metrics import cli_main as evaluate
    from sv3d_tpu_torch.evaluation.metrics import eval_mesh
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid, implicit_to_mesh
    from sv3d_tpu_torch.io.mesh import TriMesh
    from sv3d_tpu_torch.preprocessing.scaled_obj import convert_tree

    out = WORK / "eval"
    shutil.rmtree(out, ignore_errors=True)
    vis = out / "meshes" / "00000"
    shutil.copytree(fit["vis"], vis)
    level = 0.5
    if not fit["pred_faces"]:
        model = fit["model"].eval()
        grid = torch.as_tensor(fit["trainer"].val_dataset()[0]["input"][None],
                               device=next(model.parameters()).device)
        values = evaluate_on_grid(model, grid, dims)
        level = 1.0 - float(np.median(values))
        print(f"  the fit's level-0.5 mesh is empty (occupancy field in [{values.min():.4f}, "
              f"{values.max():.4f}], median {1.0 - level:.4f}); scoring its mesh at the median "
              "level", flush=True)
        implicit_to_mesh(model, grid, dims, level, vis / "00_predicted.obj",
                         transfer_dtype=torch.float32)
    preds = convert_tree(vis, "*_predicted.obj", dims)
    preds = convert_tree(vis, "*_predicted.obj", dims)
    gts = convert_tree(vis, "*_gt.obj", dims)
    pf = out / "path_files"
    pf.mkdir(parents=True, exist_ok=True)
    (pf / "predicted.txt").write_text("".join(f"{p}\n" for p in preds))
    (pf / "gt.txt").write_text("".join(f"{p}\n" for p in gts))
    cwd = os.getcwd()
    os.chdir(out)
    try:
        t0 = time.perf_counter()
        results = evaluate(["--path_files", str(pf), "--experiment", "predicted.txt",
                            "--gt", "gt.txt"])
        seconds = (time.perf_counter() - t0) / len(preds)
    finally:
        os.chdir(cwd)
    check((out / "results" / "exp_predicted.txt").exists(), "the evaluation wrote no results")
    check(all(np.isfinite(results["mean"][k]) for k in ("chamfer_l2", "iou", "normals")),
          f"non-finite evaluation metrics: {results['mean']}")
    v, f = iou_box_pair()
    t0 = time.perf_counter()
    box = eval_mesh(TriMesh(v[0], f), TriMesh(v[1], f))
    box_s = time.perf_counter() - t0
    print(f"evaluation: {len(preds)} predicted mesh(es) (level {level:.4f}) against the GT, "
          f"{seconds:.3f} s a pair (100,000 points): "
          + ", ".join(f"{k} {x:.5g}" for k, x in results["mean"].items())
          + f"; the analytic pair (a box, and the box shifted by half its width) in {box_s:.3f}"
          f" s: IoU {box['iou']:.5f} (1/3 +- 0.01), chamfer_l2 {box['chamfer_l2']:.5g}",
          flush=True)
    check(abs(box["iou"] - 1.0 / 3.0) <= 0.01, f"the analytic pair's IoU is {box['iou']}")
    return {"mean": results["mean"], "seconds": seconds, "box_iou": box["iou"], "level": level}


def peak_step_mib(fn) -> float:
    """Peak device memory (MiB) of one warm call of fn."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def ifnet_kernel_timings(model, batch, smi) -> dict:
    """K4, K7 and K8 at the IF-Net-only path's shape (the seeded model's six
    levels of the batch's depth grids, B x 2 num_points points): each held
    to its plain version at 1e-5 relative, CUDA-event ms beside the plain
    version's, the bound (gathered sectors) and the F.grid_sample
    yardstick.  Returns {name: {"err", "ms", "plain_ms", "bound", "library_ms"}}."""
    from sv3d_tpu_torch.ops.cuda.point_query import (
        level_features_cuda,
        level_grad_points_cuda,
        level_grad_vol_cuda,
    )
    from sv3d_tpu_torch.ops.point_query import (
        level_features_plain,
        level_grad_points_plain,
        level_grad_vol_plain,
    )

    cfg = model.config
    ac, disp = cfg.align_corners, cfg.displacement
    dev = next(model.parameters()).device
    grid = torch.as_tensor(np.asarray(batch["input"]), device=dev)
    pts = torch.as_tensor(np.asarray(batch["points"]), device=dev)
    model.eval()
    with torch.no_grad():
        lv = list(model.encode(grid))
        p = tuple((2.0 * pts[..., i]).contiguous() for i in range(3))
        gen = torch.Generator(device=dev).manual_seed(0)
        gs = [torch.randn((*pts.shape[:2], 7 * f.shape[1]), device=dev, generator=gen)
              for f, _ in lv]
        calls = {
            "K4": (lambda: [level_features_cuda(f, *p, d, ac, disp) for f, d in lv],
                   lambda: [level_features_plain(f, *p, d, ac, disp) for f, d in lv]),
            "K7": (lambda: [level_grad_points_cuda(f, *p, g, d, ac, disp)
                            for (f, d), g in zip(lv, gs)],
                   lambda: [level_grad_points_plain(f, *p, g, d, ac, disp)
                            for (f, d), g in zip(lv, gs)]),
            "K8": (lambda: [level_grad_vol_cuda(*p, g, d, ac, disp) for (_, d), g in zip(lv, gs)],
                   lambda: [level_grad_vol_plain(*p, g, d, ac, disp)
                            for (_, d), g in zip(lv, gs)]),
        }
        out = {}
        for name, (kernel, plain) in calls.items():
            err = max(rel_err(a, b)[1] for a, b in zip(kernel(), plain()))
            torch.cuda.synchronize()
            out[name] = {"err": err, "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain, reps=3)}
        gathered = gathered_bytes(lv, p, ac, disp)
        n_feat = p[0].numel() * 7 * sum(f.shape[1] for f, _ in lv)
        out["K4"]["bound"] = bound(gathered + nbytes(*p) + 4 * n_feat, 16.0 * n_feat)
        out["K7"]["bound"] = bound(gathered + nbytes(*p, *gs) + 12 * p[0].numel(), 64.0 * n_feat)
        out["K8"]["bound"] = bound(nbytes(*p, *gs, *(f for f, _ in lv)), 16.0 * n_feat)
    inputs = grid_sample_inputs(lv, p, ac, disp)
    for name, backward in (("K4", None), ("K7", "points"), ("K8", "level")):
        out[name]["library_ms"] = grid_sample_ms(inputs, ac, backward)
    model.train()
    b, n = pts.shape[:2]
    print(f"  K4/K7/K8 at the IF-Net-only shape (6 levels, B={b} x {n} points; gathered bytes "
          f"{gathered} of the levels' {nbytes(*(f for f, _ in lv))}) on {smi}:", flush=True)
    for name, t in out.items():
        print(f"    {name}: {t['ms']:.4f} ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}), "
              f"plain {t['plain_ms']:.4f} ms, F.grid_sample{'' if name == 'K4' else ' backward'} "
              f"{t['library_ms']:.4f} ms; max rel err {t['err']:.2e} (tol "
              f"{TRAIN_KERNEL_RTOL[name]:g})", flush=True)
        check(t["err"] <= TRAIN_KERNEL_RTOL[name],
              f"{name} disagrees with its plain version at the IF-Net-only shape: {t['err']}")
    return out


# ragged shapes, (B, Cin, D, H, W) and Cout: W not a multiple of 4 (4-byte
# copies), channel counts that do not fill a tile, Cin 1 and 3 (the narrow
# instance), a grid of one row
WGRAD_RAGGED = (((3, 20, 5, 7, 9), 40), ((2, 1, 6, 5, 11), 24), ((2, 3, 4, 3, 8), 16),
                ((1, 16, 1, 1, 5), 32))


def pyramid_conv_shapes(net_res: int, dims: tuple, b: int) -> list:
    """[(name, (B, Cin, D, H, W), Cout)] of the IF-Net pyramid's convs, as
    IFNet.encode runs them on a (b, *dims) grid (floor max-pooling between
    stages)."""
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet

    model = IFNet(IFNetConfig.for_net_res(net_res), device="meta")
    out, dims = [], tuple(dims)
    for s, stage in enumerate(model.stages):
        for c, layer in enumerate(stage.convs):
            out.append((f"s{s}.{c}", (b, layer.in_channels, *dims), layer.out_channels))
        dims = tuple(max(1, d // 2) for d in dims)
    return out


def wgrad_bound(shape: tuple, cout: int) -> tuple:
    """bound() of one weight gradient: x and dy read once, dW written once,
    2 Cout Cin 27 B D H W f32 operations."""
    b, cin, *g = shape
    vox = b * math.prod(g)
    return bound(4 * (vox * (cin + cout) + cout * cin * 27), 2.0 * cout * cin * 27 * vox)


def unet3d_conv_shapes(b: int) -> list:
    """[(name, (B, Cin, D, H, W), Cout)] of the 3x3x3 convs of ConvONet's
    room_grid64 U-Net (models/convonet.py::UNet3D at ConvONetConfig's
    defaults), as its forward runs them on a batch of b feature grids: two a
    level down, the side halved a level; two a level up."""
    from sv3d_tpu_torch.config import ConvONetConfig
    from sv3d_tpu_torch.models.convonet import ConvONet

    model = ConvONet(ConvONetConfig())
    g, out = model.config.grid, []
    for part, levels in (("enc", model.unet3d.encoders), ("dec", model.unet3d.decoders)):
        for i, level in enumerate(levels):
            side = g >> (i if part == "enc" else len(levels) - 1 - i)
            for c, layer in enumerate(level):
                w = layer.conv.weight
                out.append((f"{part}{i}.{c}", (b, w.shape[1], side, side, side), w.shape[0]))
    return out


def wgrad_phase(smi, shapes: list, what: str, ragged: tuple = ()) -> dict:
    """The conv weight-gradient kernel at shapes ([(name, (B, Cin, D, H,
    W), Cout)], what names them) and at ragged: held to its plain version
    in float64 (each output channel within WGRAD_RTOL of its norm; the f32
    plain version's difference from both printed) and to itself (two calls,
    equal bits), one launch counted a call, on channels-last inputs as the
    step hands them; at shapes CUDA-event ms of calls back to back,
    in turns (kernel, plain = cuDNN's weight gradient as the port ran it
    before, cuDNN under cudnn.benchmark, kernel) and of one call alone,
    beside the bound.  Returns {name: row}."""
    from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import (
        conv3d_wgrad_cuda,
        conv3d_wgrad_plain,
        plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, shape, cout in shapes + [(f"ragged{i}", s, c) for i, (s, c) in
                                       enumerate(ragged)]:
        # channels-last, as cuDNN hands the step its conv outputs and gradients
        x = torch.randn(shape, device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last_3d)
        dy = torch.randn((shape[0], cout, *shape[2:]), device="cuda", generator=gen).contiguous(
            memory_format=torch.channels_last_3d)
        before = conv3d_wgrad_cuda.launches
        got = conv3d_wgrad_cuda(x, dy)
        again = conv3d_wgrad_cuda(x, dy)
        ref = conv3d_wgrad_plain(x, dy)
        torch.cuda.synchronize()
        per_co = lambda a, r: float(((a - r).flatten(1).norm(dim=1)
                                     / r.flatten(1).norm(dim=1).clamp_min(1e-30)).max())
        ref64 = conv3d_wgrad_plain(x.double(), dy.double())
        row = {"shape": shape, "cout": cout, "plan": plan(shape, cout, torch.cuda.
                                                          get_device_properties(0).
                                                          multi_processor_count),
               "err": per_co(got.double(), ref64), "err_f32": per_co(got, ref),
               "plain_err": per_co(ref.double(), ref64), "same_bits": bool(torch.equal(got, again)),
               "launches": conv3d_wgrad_cuda.launches - before}
        del ref64
        if not name.startswith("ragged"):
            kernel = lambda: conv3d_wgrad_cuda(x, dy)
            plain = lambda: conv3d_wgrad_plain(x, dy)
            # calls back to back between two CUDA events: the device's time
            # when the host keeps ahead (a lone call's time holds the launch path)
            k1 = cuda_ms(lambda: [kernel() for _ in range(20)], reps=3) / 20
            row["plain_ms"] = cuda_ms(lambda: [plain() for _ in range(3)], warmup=1, reps=3) / 3
            torch.backends.cudnn.benchmark = True
            try:
                row["library_ms"] = cuda_ms(lambda: [plain() for _ in range(3)], reps=3) / 3
            finally:
                torch.backends.cudnn.benchmark = False
            row["ms"] = cuda_ms(lambda: [kernel() for _ in range(20)], reps=3) / 20
            row["ms_turns"] = (k1, row["ms"])
            row["call_ms"] = cuda_ms(kernel)
            row["bound"] = wgrad_bound(shape, cout)
        rows[name] = row
        del x, dy, got, again, ref
    print(f"conv weight gradient (csrc/conv3d_wgrad.cu) on {smi}, f32 (TF32 off), {what}:",
          flush=True)
    for name, r in rows.items():
        line = (f"  {name} {r['shape']} -> {r['cout']}: plan (th, nsplit, parts) {r['plan']}; "
                f"max rel err by output channel against float64 {r['err']:.2e} (tol "
                f"{WGRAD_RTOL:g}; the f32 plain version's {r['plain_err']:.2e}, the kernel's "
                f"from it {r['err_f32']:.2e}); same bits {r['same_bits']}; launches "
                f"{r['launches']}")
        if "ms" in r:
            line += (f"; kernel {r['ms']:.4f} ms (turns {r['ms_turns'][0]:.4f}; one call "
                     f"alone {r['call_ms']:.4f}), bound "
                     f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, "
                     f"{100.0 * r['bound'][0] / r['ms']:.1f}%), plain (cuDNN) "
                     f"{r['plain_ms']:.4f} ms, cudnn.benchmark {r['library_ms']:.4f} ms")
        print(line, flush=True)
    timed = [r for r in rows.values() if "ms" in r]
    total = lambda key: sum(r[key] for r in timed)
    print(f"  the {len(timed)}: kernel {total('ms'):.4f} ms, bound "
          f"{sum(r['bound'][0] for r in timed):.4f} ms, plain {total('plain_ms'):.4f} ms, "
          f"cudnn.benchmark {total('library_ms'):.4f} ms", flush=True)
    for name, r in rows.items():
        check(r["err"] <= WGRAD_RTOL, f"the wgrad kernel disagrees with its plain version at "
                                      f"{name}: {r['err']}")
        check(r["same_bits"] and r["launches"] == 2,
              f"the wgrad kernel at {name}: same bits {r['same_bits']}, {r['launches']} launches "
              "for 2 calls")
    return rows


# ragged shapes for the input gradient, (B, Cin, D, H, W) and Cout: W not a
# multiple of 4 (4-byte copies), channel counts that fill no tile, both
# instances, one voxel
DGRAD_RAGGED = (((3, 20, 5, 7, 9), 40), ((2, 36, 3, 9, 12), 12), ((2, 128, 9, 7, 30), 64),
                ((1, 8, 1, 1, 1), 3))


def ifnet_dgrad_route(b: int = 4) -> dict:
    """The tracer's counters of one f32 IF-Net 128 train step's backward at
    B=b on the full grid: ifnet.dgrad (input gradients taken) and
    ifnet.dgrad_kernel (those the kernel computed)."""
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet
    from sv3d_tpu_torch.utils import profiling

    model = IFNet(IFNetConfig.for_net_res(128), device="cuda",
                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid = torch.rand((b, 139, 104, 112, 1), device="cuda", generator=gen).requires_grad_()
    points = torch.rand((b, 2048, 3), device="cuda", generator=gen) - 0.5
    profiling.reset()
    with profiling.enabled():
        model(grid, points).square().sum().backward()
    torch.cuda.synchronize()
    counters = profiling.records()["counters"]
    profiling.reset()
    return {k: counters.get(k, 0) for k in ("ifnet.dgrad", "ifnet.dgrad_kernel")}


def dgrad_phase(smi, shapes: list, what: str, ragged: tuple = ()) -> dict:
    """The conv input-gradient kernel at shapes ([(name, (B, Cin, D, H, W),
    Cout)], what names them) and at ragged, NCDHW: held to float64 (each
    input channel within DGRAD_RTOL of its norm; the f32 plain version's
    difference printed beside) and to itself (two calls, equal bits), one
    launch counted a call; at shapes CUDA-event ms of calls back to back, in
    turns (kernel, plain = cuDNN's input gradient as the port ran it before,
    cuDNN under cudnn.benchmark, cuDNN on channels-last dy and x as a
    channels-last U-Net would hand them, without and with cudnn.benchmark,
    kernel), beside the bound.  Returns {name: row}."""
    from sv3d_tpu_torch.models.wgrad import _aten_backward
    from sv3d_tpu_torch.ops.cuda.conv3d_dgrad import conv3d_dgrad_cuda, conv3d_dgrad_plain, plan

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_ci = lambda a, r: float(((a - r).transpose(0, 1).flatten(1).norm(dim=1)
                                 / r.transpose(0, 1).flatten(1).norm(dim=1).clamp_min(1e-30))
                                .max())
    rows = {}
    for name, shape, cout in shapes + [(f"ragged{i}", s, c) for i, (s, c) in
                                       enumerate(ragged)]:
        dy = torch.randn((shape[0], cout, *shape[2:]), device="cuda", generator=gen)
        w = torch.randn((cout, shape[1], 3, 3, 3), device="cuda", generator=gen)
        before = conv3d_dgrad_cuda.launches
        got = conv3d_dgrad_cuda(dy, w, shape)
        again = conv3d_dgrad_cuda(dy, w, shape)
        ref = conv3d_dgrad_plain(dy, w, shape)
        ref64 = conv3d_dgrad_plain(dy.double(), w.double(), shape)
        torch.cuda.synchronize()
        row = {"shape": shape, "cout": cout, "plan": plan(tuple(shape)),
               "err": per_ci(got.double(), ref64), "plain_err": per_ci(ref.double(), ref64),
               "same_bits": bool(torch.equal(got, again)),
               "launches": conv3d_dgrad_cuda.launches - before}
        del ref64, got, again, ref
        if not name.startswith("ragged"):
            kernel = lambda: conv3d_dgrad_cuda(dy, w, shape)
            plain = lambda: conv3d_dgrad_plain(dy, w, shape)
            k1 = cuda_ms(lambda: [kernel() for _ in range(10)], reps=3) / 10
            row["plain_ms"] = cuda_ms(lambda: [plain() for _ in range(3)], warmup=1, reps=3) / 3
            cl = torch.channels_last_3d
            x_cl = torch.empty(shape, device="cuda", memory_format=cl)
            dy_cl = dy.contiguous(memory_format=cl)
            cudnn_cl = lambda: _aten_backward(dy_cl, x_cl, w, [True, False, False])[0]
            check(cudnn_cl().is_contiguous(memory_format=cl),
                  f"cuDNN's input gradient at {name} on channels-last dy is not channels-last")
            row["cl_ms"] = cuda_ms(lambda: [cudnn_cl() for _ in range(3)], warmup=1, reps=3) / 3
            torch.backends.cudnn.benchmark = True
            try:
                row["library_ms"] = cuda_ms(lambda: [plain() for _ in range(3)], reps=3) / 3
                row["cl_library_ms"] = cuda_ms(lambda: [cudnn_cl() for _ in range(3)],
                                               reps=3) / 3
            finally:
                torch.backends.cudnn.benchmark = False
            del x_cl, dy_cl
            row["ms"] = cuda_ms(lambda: [kernel() for _ in range(10)], reps=3) / 10
            row["ms_turns"] = (k1, row["ms"])
            row["bound"] = wgrad_bound(shape, cout)
        rows[name] = row
        del dy, w
        torch.cuda.empty_cache()
    print(f"conv input gradient (csrc/conv3d_dgrad.cu) on {smi}, f32 (TF32 off), {what}:",
          flush=True)
    for name, r in rows.items():
        line = (f"  {name} {r['shape']} <- {r['cout']}: plan (ncg, td, th, wtile) {r['plan']}; "
                f"max rel err by input channel against float64 {r['err']:.2e} (tol "
                f"{DGRAD_RTOL:g}; cuDNN's f32 {r['plain_err']:.2e}); same bits "
                f"{r['same_bits']}; launches {r['launches']}")
        if "ms" in r:
            line += (f"; kernel {r['ms']:.4f} ms (turns {r['ms_turns'][0]:.4f}), bound "
                     f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, "
                     f"{100.0 * r['bound'][0] / r['ms']:.1f}%), plain (cuDNN) "
                     f"{r['plain_ms']:.4f} ms, cudnn.benchmark {r['library_ms']:.4f} ms; "
                     f"cuDNN channels-last {r['cl_ms']:.4f} ms, cudnn.benchmark "
                     f"{r['cl_library_ms']:.4f} ms")
        print(line, flush=True)
    timed = [r for r in rows.values() if "ms" in r]
    total = lambda key: sum(r[key] for r in timed)
    print(f"  the {len(timed)}: kernel {total('ms'):.4f} ms, bound "
          f"{sum(r['bound'][0] for r in timed):.4f} ms, plain {total('plain_ms'):.4f} ms, "
          f"cudnn.benchmark {total('library_ms'):.4f} ms; cuDNN channels-last "
          f"{total('cl_ms'):.4f} ms, cudnn.benchmark {total('cl_library_ms'):.4f} ms",
          flush=True)
    for name, r in rows.items():
        check(r["err"] <= DGRAD_RTOL, f"the dgrad kernel disagrees with float64 at {name}: "
                                      f"{r['err']}")
        check(r["same_bits"] and r["launches"] == 2,
              f"the dgrad kernel at {name}: same bits {r['same_bits']}, {r['launches']} "
              "launches for 2 calls")
    return rows


def _unet_layout_variants() -> dict:
    """ConvONet's train step as the port runs it and in three other layouts
    or routes of the U-Net's 3x3x3 convs, as {name: (object, attribute,
    value) to patch in} (None: the port): dx from cuDNN on the NCDHW dy (the
    route before the dgrad kernel); the U-Net's input made channels-last
    (the one-line layout change); every routed conv's x and dy made
    channels-last (copied where GroupNorm and the skips hand NCDHW), so that
    dx comes from cuDNN's channels-last path and the weight gradient's
    kernel reads both as they are."""
    from sv3d_tpu_torch.models import convonet
    from sv3d_tpu_torch.models.wgrad import WgradConv3d, _aten_backward
    from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import conv3d_wgrad

    cl = torch.channels_last_3d

    class AtenDgrad(WgradConv3d):
        @staticmethod
        def backward(ctx, dy):
            x, weight = ctx.saved_tensors
            return (_aten_backward(dy, x, weight, [True, False, False])[0],
                    conv3d_wgrad(x, dy), None, None)

    class ChannelsLast(WgradConv3d):
        @staticmethod
        def forward(ctx, x, weight, bias, prefix):
            return WgradConv3d.forward(ctx, x.contiguous(memory_format=cl), weight, bias, prefix)

        @staticmethod
        def backward(ctx, dy):
            return WgradConv3d.backward(ctx, dy.contiguous(memory_format=cl))

    unet_forward = convonet.UNet3D.forward
    return {"port": None,
            "dx from cuDNN, NCDHW": (convonet, "WgradConv3d", AtenDgrad),
            "U-Net input channels-last": (
                convonet.UNet3D, "forward",
                lambda self, x: unet_forward(self, x.contiguous(memory_format=cl))),
            "every conv channels-last": (convonet, "WgradConv3d", ChannelsLast)}


def convonet_step_phase(data_root: Path, smi, b: int = 32) -> dict:
    """ConvONet's room_grid64 (ConvONetConfig's widths) trained by
    SceneNetTrainer in f32 at B=b on the smoke tree: one train step with the
    launch counters set to 0 just before it and the tracer on, which must
    take all 14 of the U-Net's input and weight gradients from the kernels;
    then the warm step (CUDA events, median of 5 after 2 warm-ups) and its
    peak memory in each of _unet_layout_variants(), in turns with the port
    first and last, each with the tracer's count of the input gradients
    that took the kernel.  Returns {"launches", "route", "variants"}."""
    from sv3d_tpu_torch.config import Config, ConvONetConfig
    from sv3d_tpu_torch.data.loader import collate
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer
    from sv3d_tpu_torch.utils import profiling

    cfg = Config(seed=0, scale_factor=1, batch_size=b, num_points=1024, subsample_points=0,
                 fused_query=False, decoder="convonet_grid", convonet=ConvONetConfig(),
                 splitsdir="overfit", datasetdir=str(data_root), sanity_steps=0,
                 experiment="smoke_convonet")
    torch.cuda.empty_cache()
    trainer = SceneNetTrainer(cfg, device="cuda", experiment_dir=WORK / "convonet_step")
    ds = trainer.train_dataset()
    batch = collate([ds[i % len(ds)] for i in range(b)])
    state = trainer.build_state()
    gen = torch.Generator().manual_seed(0)
    step = lambda: trainer.train_step(state, batch, gen)

    def traced(fn) -> dict:
        profiling.reset()
        with profiling.enabled():
            fn()
        torch.cuda.synchronize()
        counters = profiling.records()["counters"]
        profiling.reset()
        return {k: counters.get(k, 0) for k in ("convonet.dgrad", "convonet.dgrad_kernel",
                                                 "convonet.wgrad", "convonet.wgrad_kernel")}

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    route = traced(step)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"ConvONet room_grid64 f32 train step at B={b} (SceneNetTrainer.train_step): "
          f"launches {launches}, tracer {route}", flush=True)
    check(launches["dgrad"] == 14 and launches["wgrad"] == 14
          and all(n == 14 for n in route.values()),
          f"the ConvONet step did not take its 14 input and weight gradients from the kernels: "
          f"launches {launches}, tracer {route}")

    variants = _unet_layout_variants()
    out = {}
    for name in ["port", *[k for k in variants if k != "port"], "port"]:
        def measure():
            kernel = traced(step)["convonet.dgrad_kernel"]
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, reps=5)
            return ms, torch.cuda.max_memory_allocated() / 2 ** 30, kernel
        ms, peak, kernel = _run_variant(variants[name], measure)
        row = out.setdefault(name, {"ms": [], "peak_gib": peak, "dgrad_kernel": kernel})
        row["ms"].append(ms)
    print(f"ConvONet's f32 step at B={b} on {smi}, by the U-Net convs' layout and route (CUDA "
          "events, median of 5, the port first and last):", flush=True)
    for name, r in out.items():
        print(f"  {name}: {', '.join(f'{m:.2f}' for m in r['ms'])} ms, peak {r['peak_gib']:.2f} "
              f"GiB, {r['dgrad_kernel']} of 14 input gradients the kernel's", flush=True)
    del trainer, state, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "route": route, "variants": out}


def serving_p16_phase(ckpt: Path, rgb_png: Path, intrinsics: Path, rgb, smi,
                      extra=()) -> dict:
    """Phase 19, serving at precision 16 (bf16 UNet and IF-Net convs): the
    serving CLI at full width (checkpoint_serving_phase with --precision 16:
    K1 and K2 bf16 once each, the K2 launch on the bf16 pyramid); the
    scale-8 slice's logits and sigmoid grid on the card against the CPU
    port's; warm image->mesh at precision 16 and 32 in turns, median of 5
    each; evaluate_points on the precision-16 model at N_POINTS points on the
    default route (K6 bf16), timed beside the precision-32 model's.  extra:
    more CLI flags (the checkpoint's architecture)."""
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.inference.dense_grid import (
        evaluate_on_grid,
        evaluate_points,
        implicit_to_mesh,
    )
    from sv3d_tpu_torch.inference.predict import build_parser, load_model, predict
    from sv3d_tpu_torch.ops.cuda.point_query import level_fc0_bf16_cuda

    served = checkpoint_serving_phase(ckpt, rgb_png, intrinsics, WORK / "served_p16",
                                      extra=["--precision", "16", *extra])
    print(f"precision 16 serving (predict.main --precision 16, full width, the mesh at the "
          f"grid's median level {served['level']:.4f}): launches {served['launches']}, "
          f"{served['verts']} verts {served['faces']} faces", flush=True)
    check(served["faces"] > 0, "the precision-16 served mesh has no faces")
    check(served["launches"] == {"scatter_voxels": 1, "lattice_sweep_bf16": 1,
                                 "lattice_sweep_f32": 0},
          f"precision-16 serving did not run K1 and K2 bf16 once each: {served['launches']}")

    # the scale-8 slice, card against CPU, both at precision 16
    small = Config(scale_factor=8, seed=0, precision=16)
    out = {}
    for device in ("cuda", "cpu"):
        m = seeded_scene_net(small, device, seed=1)
        v, _ = predict(small, m, rgb=rgb)
        with torch.inference_mode():
            lv = m.ifnet.encode(v)
            check(lv.flats[1].dtype == torch.bfloat16, "precision 16 gave f32 levels")
            logits = m.ifnet.query_lattice(lv, small.dims, 1, small.dims[0], 0)
        out[device] = (logits.cpu().double(), evaluate_on_grid(m.ifnet, v, small.dims,
                                                              transfer_dtype=torch.float32))
    logit_err = float((out["cuda"][0] - out["cpu"][0]).abs().max()
                      / out["cpu"][0].abs().max())
    sig_err = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    print(f"precision-16 slice at scale_factor 8, card vs CPU: logits max_abs_err / max |logit| "
          f"{logit_err:.3e} (tol {P16_LOGIT_RTOL:g}), sigmoid max_abs_err {sig_err:.3e} (tol "
          f"{P16_SLICE_TOL:g})", flush=True)
    check(logit_err <= P16_LOGIT_RTOL and sig_err <= P16_SLICE_TOL,
          f"the card's precision-16 slice disagrees with the CPU's: {logit_err}, {sig_err}")

    # warm image->mesh, the two precisions in turns
    models = {}
    for prec in ("32", "16"):
        args = build_parser().parse_args(
            ["--checkpoint", str(ckpt), "--rgb", str(rgb_png), "--intrinsics", str(intrinsics),
             "--device", "cuda", "--precision", prec, *extra])
        models[prec] = load_model(args)

    def serve(prec):
        cfg, m = models[prec]
        v, _ = predict(cfg, m, rgb=rgb)
        implicit_to_mesh(m.ifnet, v, cfg.dims, 0.5, WORK / f"t{prec}.obj")
        torch.cuda.synchronize()

    e2e = {"32": [], "16": []}
    for i in range(6):
        for prec in (("32", "16") if i % 2 else ("16", "32")):
            t0 = time.perf_counter()
            serve(prec)
            if i:  # the first round is warm-up
                e2e[prec].append(time.perf_counter() - t0)
    prof16 = profile_lines(lambda: serve("16"), steps=2)

    # arbitrary points on the precision-16 model: the default route (K6 bf16)
    cfg16, m16 = models["16"]
    pts_np = np.random.default_rng(3).uniform(-0.45, 0.45, (N_POINTS, 3)).astype(np.float32)
    vox, _ = predict(cfg16, m16, rgb=rgb)
    level_fc0_bf16_cuda.launches = 0
    p16 = evaluate_points(m16.ifnet, vox, pts_np)
    torch.cuda.synchronize()
    k6_launches = level_fc0_bf16_cuda.launches
    p32 = evaluate_points(models["32"][1].ifnet, vox, pts_np)
    points_ms = {prec: cuda_ms(lambda m=m: evaluate_points(m.ifnet, vox, pts_np), reps=3)
                 for prec, (_, m) in models.items()}
    print(f"precision-16 evaluate_points at {N_POINTS} points (the default route, bf16 K6): "
          f"K6 bf16 launches {k6_launches}, sigmoid in [{p16.min():.4f}, {p16.max():.4f}], "
          f"largest difference from the precision-32 model's on the same grid "
          f"{float(np.abs(p16 - p32).max()):.3e}", flush=True)
    check(p16.shape == (N_POINTS,) and bool(np.isfinite(p16).all()) and k6_launches > 0,
          f"precision-16 evaluate_points: {p16.shape}, K6 bf16 launches {k6_launches}")
    print(f"precision-16 serving timings on {smi}:", flush=True)
    for prec in ("32", "16"):
        print(f"  warm image->mesh at precision {prec}: median "
              f"{statistics.median(e2e[prec]):.4f} s over 5 runs ("
              f"{', '.join(f'{t:.4f}' for t in e2e[prec])}), in turns with the other", flush=True)
    for prec, ms in points_ms.items():
        print(f"  evaluate_points at precision {prec}, {N_POINTS} points, default route: "
              f"{ms:.3f} ms (median of 3), {N_POINTS / (ms / 1e3):.4g} points/s", flush=True)
    print("  profiled image->mesh at precision 16:", flush=True)
    for line in prof16:
        print(f"    {line}", flush=True)
    return {"launches": served["launches"], "points_launches": {"K6bf16": k6_launches}}


def p16_step_budget(card, cpu16, cpu32) -> dict:
    """One precision-16 train step on the card against the CPU's, each a
    parity_step / new_trainer_step result, held to the CPU's f32 step of the
    same weights and batch (cpu32) with the error budget of the CPU's own
    bf16 step: {"loss": |card - cpu16| / (P16_LOSS_RTOL |cpu16|), "grads":
    the worst tensor's ||card - cpu32|| / (P16_GRAD_BUDGET ||cpu16 - cpu32||
    + P16_GRAD_FLOOR ||cpu32||)}, each (ratio, where); <= 1 passes."""
    loss = abs(card["loss"] - cpu16["loss"]) / (P16_LOSS_RTOL * abs(cpu16["loss"]))
    worst = (0.0, "")
    for n, g32 in cpu32["grads"].items():
        bound = (P16_GRAD_BUDGET * float((cpu16["grads"][n] - g32).norm())
                 + P16_GRAD_FLOOR * float(g32.norm()))
        ratio = float((card["grads"][n] - g32).norm()) / max(bound, 1e-30)
        worst = max(worst, (ratio, n))
    return {"loss": (loss, ""), "grads": worst}


def training_p16_phase(cfgs: dict, batches: dict, f32: dict, parity: dict, smi) -> dict:
    """Phase 20, training at precision 16, each trainer through its entry
    point at full width: the end-to-end fit (B=4, fused_query), the
    IF-Net-only fit (B=16 x 4096 points; its validation meshes through K2
    bf16 on the bf16 pyramid) and the UNet-only fit (UNetMini, B=16), 4
    steps of fit each with the kernel counts set to 0 just before and read
    just after; the loss over 10 steps on one fixed batch; the warm
    step (CUDA events, median of 5 after 2 warm-ups) and its peak memory
    beside the f32 step's (f32: {name: (ms, MiB)} from phases 11 and 18);
    the top device kernels of the profiled step.  Then one step at
    scale_factor 8, card against CPU, held by p16_step_budget (parity: {name:
    (kind, f32 config)}).  Returns {name: launches}."""
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep_bf16_cuda

    classes = {"scene": SceneNetTrainer, "ifnet": _new_trainer("ifnet")[0],
               "unet": _new_trainer("unet")[0]}
    counters = {**_counters(), "K2": lattice_sweep_bf16_cuda}
    out = {}
    for name, (kind, cfg) in cfgs.items():
        exp = WORK / f"p16_{kind}"
        shutil.rmtree(exp, ignore_errors=True)
        for fn in counters.values():
            fn.launches = 0
        trainer = classes[kind](cfg, device="cuda", experiment_dir=exp)
        state = trainer.fit(max_steps=4)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        out[name] = launches
        want = {"scene": ("K1", "K1b", "K4", "K7", "K8"), "ifnet": ("K4", "K8", "K2"),
                "unet": ()}[kind]
        check(state.step == 4 and all(launches[k] > 0 for k in want)
              and (kind != "ifnet" or launches["K7"] == 0) and launches["wgrad"] == 0
              and launches["dgrad"] == 0,
              f"the precision-16 {name} fit did not run its kernels (and not the f32 wgrad "
              f"and dgrad): "
              f"{launches}")
        gen = torch.Generator().manual_seed(0)
        batch = batches[kind] if kind in batches else fixed_batch(trainer, cfg.batch_size)
        st = trainer.build_state()
        losses = [float(next(iter(trainer.train_step(st, batch, gen).values())))
                  for _ in range(10)]
        step = lambda: trainer.train_step(st, batch, gen)
        ms = cuda_ms(step, reps=5)
        peak = peak_step_mib(step)
        _, wall, device_t, events = profile_calls(step, 3)
        leader = events[0].key if events else ""
        print(f"precision-16 {name}: fit(max_steps=4) launches {launches}; 10 steps on one batch "
              f"of {cfg.batch_size}: loss {', '.join(f'{x:.5f}' for x in losses)}", flush=True)
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"the precision-16 {name} loss did not drop: {losses}")
        print(f"  on {smi}: warm step median {ms:.3f} ms of 5 (f32 {f32[name][0]:.3f} ms, "
              f"{f32[name][0] / ms:.2f}x); peak device memory {peak:.1f} MiB (f32 "
              f"{f32[name][1]:.1f} MiB); profiled {wall:.3f} ms host clock, {device_t:.3f} ms "
              f"device self time, device idle {100.0 * (1.0 - device_t / wall):.1f}%", flush=True)
        print(f"  the leader of the bf16 step (its convs are cuDNN's): {leader[:100]}", flush=True)
        for line in _top_lines(events, device_t, 3, top=8):
            print(f"  {line}", flush=True)
        del st, state, trainer

    for name, (kind, cfg32) in parity.items():
        cfg16 = cfg32.replace(precision=16)
        if kind == "scene":
            cpu32 = parity_step(cfg32, "cpu")
            runs = {"cpu16": parity_step(cfg16, "cpu", labels=cpu32["labels"]),
                    "card16": parity_step(cfg16, "cuda", labels=cpu32["labels"])}
        else:
            cpu32 = new_trainer_step(kind, cfg32, "cpu")
            runs = {"cpu16": new_trainer_step(kind, cfg16, "cpu"),
                    "card16": new_trainer_step(kind, cfg16, "cuda")}
        res = p16_step_budget(runs["card16"], runs["cpu16"], cpu32)
        print(f"precision-16 {name} train step at scale_factor 8, card vs CPU, each held to "
              "the CPU's f32 step with the CPU bf16 step's error budget, as a fraction of "
              "its bound (<= 1 passes): "
              + ", ".join(f"{k} {r:.3e} {n}" for k, (r, n) in res.items()), flush=True)
        check(max(r for r, _ in res.values()) <= 1.0,
              f"the card's precision-16 {name} step disagrees with the CPU's: {res}")
    return out


def quality_p16_phase(steps: int = 30, extra=()) -> dict:
    """Phase 21, the quality smoke: quality.overfit end to end (--use_unet) at
    full scale on one synthetic scene, steps steps at precision 32 and 16
    from the same seed; both IoUs printed.  The comparison that counts is a
    run of at least 1000 steps (README).  extra: more quality.overfit flags."""
    from sv3d_tpu_torch.quality import overfit

    results = {}
    for prec in ("32", "16"):
        exp = WORK / f"quality_p{prec}"
        shutil.rmtree(exp, ignore_errors=True)
        results[prec] = overfit.main([
            "--steps", str(steps), "--use_unet", "--precision", prec, "--eval_points", "20000",
            "--root", str(WORK / "quality_scene"), "--exp", str(exp), *extra])
        check(json.loads((exp / "quality.json").read_text()) == results[prec],
              f"quality.overfit at precision {prec} did not write its results")
    print(f"quality smoke (quality.overfit, end to end, one synthetic scene, {steps} steps): "
          + "; ".join(f"precision {p}: iou {r['iou']}, chamfer_l2 {r['chamfer_l2']}, normals "
                      f"{r['normals']}, {r['steps_per_sec']} steps/s"
                      + (f" (mesh failed: {r['failed']})" if "failed" in r else "")
                      for p, r in results.items()), flush=True)
    return results


# The world-2 phase: two ranks share the one card over gloo.  The dp=2 fit
# is held to the single-process fit on the card, which trains on the labels
# that the ranks gave their own rows' clouds (the projected cloud lies on
# the scene's surfaces, so the last bits of a depth that cuDNN computes
# with other algorithms at B=2 and B=4 flip some labels; the single process
# labels its cloud too, and at most WORLD2_FLIPS_MAX of them may differ).
# After the first step: the loss within STEP_RTOL, each gradient within
# GRID_GRAD_RTOL of the tensor's largest magnitude plus the step's floor
# (BN_FED_BIASES' residue within 1e-4 of their weight's gradient), the
# BatchNorm statistics within STEP_RTOL of their largest magnitude, and at
# least WORLD2_SAME_MIN of the parameters within 1e-6 (Adam's first step is
# about lr * sign(g)).  GRID_GRAD_RTOL and not STEP_GRAD_RTOL for every
# tensor: the f32 weight gradients of the IF-Net's early convs are
# ill-conditioned (tests/test_torch_cuda.py's IF-Net-only step), and two
# f32 steps whose convolutions cuDNN runs at B=2 and at B=4 moved stage 1's
# second conv's by 1.06e-2 of its largest magnitude on an H100 80GB HBM3
# at 700 W (two single-process runs on the same labels stayed within
# 4.8e-4 of every tensor's).  After the second step every
# parameter within 2 lr a step of the single-process one; that step's loss
# and its share of equal parameters are printed, not held: its forward runs
# on weights that Adam moved apart where a gradient was near 0, and two
# single-process runs keep only about half of their parameters within 1e-6
# there.  The lattice and the points are bit-equal.
WORLD2_SAME_MIN = 0.9
WORLD2_FLIPS_MAX = 0.01


def world2_run(spec: dict, sharded: bool, labels=None) -> dict:
    """The three sharded paths of the world-2 phase, in this process: two
    fused_query fit steps (dp=2 when sharded), the serving lattice (sp=2)
    and evaluate_points (both ranks).  Without sharding it is the
    single-process run they are held to; labels (each step's labels of the
    whole batch's cloud subsample) replace the trainer's own, which it still
    computes to count how many differ.  Each path's kernel counts are set to
    0 just before it and read just after.  Returns the fit's snapshots and
    labels, the lattice and the points on the host, and the counts.  spec: the fit's
    and the served model's configurations, the served grid's file, the
    points, and the device (default cuda; the CPU runs the plain versions
    and counts nothing), the thread count of the process that spawned the
    ranks, and the directory for the fit's experiment."""
    from sv3d_tpu_torch.data.loader import collate
    from sv3d_tpu_torch.inference.dense_grid import evaluate_on_grid_device, evaluate_points
    from sv3d_tpu_torch.ops.cuda.point_query import level_fc0_bf16_cuda
    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep_bf16_cuda
    from sv3d_tpu_torch.parallel import make_mesh, process_index
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    dev = torch.device(spec.get("device", "cuda"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rank = process_index()
    out = {"launches": {}}
    cfg = spec["fit_cfg"].replace(dp=2) if sharded else spec["fit_cfg"]
    trainer = SceneNetTrainer(cfg, device=dev,
                              experiment_dir=Path(spec["work"]) / f"world2_fit{int(sharded)}")
    state = trainer.distribute(trainer.build_state())
    ds = trainer.train_dataset()
    batch = collate([ds[i] for i in range(cfg.batch_size)])
    rows = trainer.mesh.batch_rows(cfg.batch_size) if sharded else slice(None)
    local = {k: v[rows] for k, v in batch.items()}
    own_labels = trainer.label_cloud
    out["labels"], out["label_flips"] = [], []

    def label_cloud(pc, b):
        own = own_labels(pc, b)
        given = own if labels is None else labels[len(out["labels"])].to(own)
        out["labels"].append(given.cpu())
        out["label_flips"].append(float((given != own).float().mean()))
        return given

    trainer.label_cloud = label_cloud
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out["fit"] = []
    for _ in range(2):
        metrics = trainer.train_step(state, local, trainer.generator)
        out["fit"].append({
            "loss": float(metrics["train_loss"]),
            "grads": {n: p.grad.detach().to("cpu", copy=True)
                      for n, p in state.model.named_parameters()},
            "state": {k: v.detach().to("cpu", copy=True)
                      for k, v in state.model.state_dict().items()}})
    sync()
    out["launches"]["fit_dp2"] = {k: fn.launches for k, fn in counters.items()}
    del trainer, state

    model = seeded_scene_net(spec["serve_cfg"], dev, seed=0)
    grid = torch.load(spec["grid"]).to(dev)
    dims = spec["serve_cfg"].dims
    mesh = make_mesh(1, 2) if sharded else None
    lattice_sweep_bf16_cuda.launches = 0
    with torch.inference_mode():
        levels = model.ifnet.encode(grid)
        lattice = evaluate_on_grid_device(model.ifnet, levels, dims, mesh=mesh)
        out["lattice"] = lattice[:dims[0]].cpu()
    sync()
    out["launches"]["serving_sp2"] = {"K2": lattice_sweep_bf16_cuda.launches}
    level_fc0_bf16_cuda.launches = 0
    out["points"] = evaluate_points(model.ifnet, grid, spec["points"], mesh=mesh)
    sync()
    out["launches"]["points_world2"] = {"K6bf16": level_fc0_bf16_cuda.launches}
    out["rank"] = rank
    return out


def _world2_rank(rank: int, world: int, init: str, spec: dict, out: str) -> None:
    """One rank of the world-2 phase (spawned): joins the gloo group through
    the file rendezvous, runs world2_run sharded, saves its results."""
    import torch.distributed as dist

    from sv3d_tpu_torch.parallel import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # this process's host arithmetic rounds as the single-process run's
    torch.set_num_threads(spec["threads"])
    initialize_distributed(f"file://{init}", world, rank, backend="gloo")
    try:
        torch.save(world2_run(spec, sharded=True), Path(out) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _world2_fit_errors(cfg, single: list, dist_run: list) -> dict:
    """The dp=2 fit against the single-process fit (bounds above): each
    kind's largest ratio to its bound and where; the second step's relative
    loss difference and the shares of parameters within 1e-6 after the
    first step and after both."""
    out = {"loss": (0.0, ""), "grads": (0.0, ""), "params": (0.0, ""), "bn": (0.0, "")}

    def worst(kind, ratio, where):
        if ratio > out[kind][0]:
            out[kind] = (ratio, where)

    first, last, got = single[0], single[-1], dist_run[-1]
    worst("loss", abs(dist_run[0]["loss"] - first["loss"]) / abs(first["loss"]) / STEP_RTOL,
          "step 1")
    out["loss_2"] = abs(got["loss"] - last["loss"]) / abs(last["loss"])
    floor = 1e-6 * max(float(g.abs().max()) for g in first["grads"].values())
    same = same_2 = total = 0
    for n, g in first["grads"].items():
        if n in BN_FED_BIASES:  # rounding residue in both runs (see BN_FED_BIASES)
            bound = 1e-4 * float(first["grads"][n[: -len("bias")] + "weight"].abs().max())
            got_g = float(dist_run[0]["grads"][n].abs().max())
            worst("grads", max(got_g, float(g.abs().max())) / bound, n)
        else:
            tol = GRID_GRAD_RTOL * float(g.abs().max()) + floor
            worst("grads", float((dist_run[0]["grads"][n] - g).abs().max()) / tol, n)
        lr = cfg.lr * (10.0 if n.startswith("project.") else 1.0)
        diff = (got["state"][n] - last["state"][n]).abs()
        worst("params", float(diff.max()) / (2 * lr * len(single) + 1e-6), n)
        same += int(((dist_run[0]["state"][n] - first["state"][n]).abs() <= 1e-6).sum())
        same_2 += int((diff <= 1e-6).sum())
        total += diff.numel()
    for k, v in first["state"].items():
        if k.endswith(("running_mean", "running_var")):
            diff = float((dist_run[0]["state"][k] - v).abs().max())
            worst("bn", diff / (STEP_RTOL * float(v.abs().max())), k)
    out["same"], out["same_2"] = same / total, same_2 / total
    return out


def world2_checks(w2: dict, counted: bool = True) -> None:
    """Fail unless every kernel of each world-2 path ran in each rank (when
    counted: on the card), K2 bf16 once a rank, the dp=2 fit agrees with
    the single-process fit and the lattice and the points are bit-equal."""
    if counted:
        for path, counts in w2["launches"].items():
            check(all(n > 0 for k, ns in counts.items() if k != "dgrad" for n in ns)
                  and not any(counts.get("dgrad", ())),
                  f"a kernel of the world-2 {path} path never ran in a rank (or the dgrad "
                  f"kernel ran: the IF-Net's convs keep cuDNN's): {counts}")
        check(w2["launches"]["serving_sp2"]["K2"] == [1, 1],
              f"K2 bf16 did not run once in each rank: {w2['launches']['serving_sp2']}")
    for e in w2["fit"]:
        check(max(e[k][0] for k in ("loss", "grads", "params", "bn")) <= 1.0
              and e["same"] >= WORLD2_SAME_MIN,
              f"the dp=2 fit disagrees with the single-process fit: {e}")
    check(max(w2["label_flips"]) <= WORLD2_FLIPS_MAX,
          f"the ranks' labels differ from the single process's: {w2['label_flips']}")
    check(all(w2["lattice_equal"]), f"the sp=2 lattice differs: {w2['lattice']}")
    check(all(w2["points_equal"]), f"evaluate_points at world 2 differs: {w2['points']}")


def world2_phase(fit_cfg, serve_cfg, grid_path: Path, pts: np.ndarray,
                 device: str = "cuda") -> dict:
    """The sharded paths on a world of 2 ranks that share the one card
    (gloo; NCCL refuses two ranks on one GPU), spawned by
    torch.multiprocessing and joined through a file:// rendezvous: the
    end-to-end fit at dp=2 (K1, K1b, K4, K7, K8 in each rank), the serving
    lattice at sp=2 (K2 bf16 once in each) and evaluate_points over both
    (K6 bf16), each held to the same run in this process.  A rank that
    fails fails the phase.  Returns each rank's counts and the comparisons."""
    import tempfile

    spec = {"fit_cfg": fit_cfg, "serve_cfg": serve_cfg, "grid": str(grid_path), "points": pts,
            "device": device, "threads": torch.get_num_threads(), "work": str(WORK)}
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        torch.multiprocessing.start_processes(
            _world2_rank, args=(2, str(Path(tmp) / "rendezvous"), spec, tmp), nprocs=2,
            join=True, start_method="spawn")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    check([r["rank"] for r in ranks] == [0, 1], "the world-2 ranks")
    # the single-process fit on the labels the ranks gave their rows
    single = world2_run(spec, sharded=False, labels=[
        torch.cat([r["labels"][step] for r in ranks]) for step in range(2)])
    errors = [_world2_fit_errors(fit_cfg, single["fit"], r["fit"]) for r in ranks]
    lattice = [float((r["lattice"] - single["lattice"]).abs().max()) for r in ranks]
    points = [float(np.abs(r["points"] - single["points"]).max()) for r in ranks]
    launches = {path: {k: [r["launches"][path][k] for r in ranks] for k in counts}
                for path, counts in ranks[0]["launches"].items()}
    return {"launches": launches, "fit": errors, "lattice": lattice, "points": points,
            "label_flips": single["label_flips"],
            "lattice_equal": [torch.equal(r["lattice"], single["lattice"]) for r in ranks],
            "points_equal": [bool(np.array_equal(r["points"], single["points"])) for r in ranks],
            "single_launches": single["launches"]}


def positive(values: dict, what: str, none_ok: bool = False) -> None:
    """Every number in values (nested dicts and lists too) is finite and
    above 0; None (a figure that only the card gives) fails unless none_ok."""
    from sv3d_tpu_torch.bench import bad_figures

    bad = bad_figures(values, what, none_ok)
    check(not bad, f"{what}: values not finite and positive: {bad}")


def multiscene_phase(device: str = "cuda", scale_factor: int = 1, steps: int = 2) -> dict:
    """Phase 24: quality.multiscene --stage all, the scene-scaling protocol
    (README; sv3d_tpu_torch/quality/scaling.py) at full width on 4 train (one
    batch of B=4), 1 val and 1 test scene of a tree made under WORK, with
    K1's, K1b's and K2 bf16's counts set to 0 just before it and read just
    after.  Checks that the artifact was written, that its figures are
    finite, and on the card that the three kernels launched.  Few steps:
    this protocol's field predicts no occupied point from about step 10 to
    step 30-130 (train point IoU 0.125 at step 1, 0.000-0.002 at step 20 in
    the three scaling arms on the H100), and a test mesh made then has no
    vertices (20 steps did so on the card).  Returns the artifact and the
    counts."""
    from sv3d_tpu_torch.ops.cuda.sweep import lattice_sweep_bf16_cuda
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_bwd_cuda, scatter_voxels_cuda
    from sv3d_tpu_torch.quality import multiscene

    root, exp, out = WORK / "multiscene_tree", WORK / "multiscene_exp", WORK / "multiscene.json"
    for path in (root, exp):
        shutil.rmtree(path, ignore_errors=True)
    out.unlink(missing_ok=True)
    counters = {"K1": scatter_voxels_cuda, "K1b": scatter_voxels_bwd_cuda,
                "K2": lattice_sweep_bf16_cuda}
    for fn in counters.values():
        fn.launches = 0
    multiscene.main([
        "--root", str(root), "--exp", str(exp), "--out", str(out), "--device", device,
        "--n_train", "4", "--n_val", "1", "--n_test", "1", "--use_unet",
        "--steps", str(steps), "--val_every", str(max(steps // 2, 1)),
        "--num_samples", "2000", "--eval_points", "20000", "--data_workers", "4",
        "--scale_factor", str(scale_factor)])
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counters.items()}
    check(out.is_file(), f"quality.multiscene wrote no artifact at {out}")
    result = json.loads(out.read_text())
    figures = [result[k] for k in ("iou", "chamfer_l2", "normals")] + [
        s[k] for s in result["per_scene"] for k in ("iou", "chamfer_l2", "normals")]
    check(len(result["per_scene"]) == 1 and result["n_failed"] == 0
          and all(isinstance(v, (int, float)) and math.isfinite(v) for v in figures),
          f"quality.multiscene's figures are not all finite: {result}")
    if device == "cuda":
        check(all(n > 0 for n in launches.values()),
              f"the multi-scene path did not launch each of K1, K1b and K2 bf16: {launches}")
    print(f"phase 24: quality.multiscene --stage all, {steps} steps on {result['device']}: "
          f"iou {result['iou']}, chamfer_l2 {result['chamfer_l2']}, normals "
          f"{result['normals']}, train {result['train_seconds']} s; launches {launches}",
          flush=True)
    return {"result": result, "launches": launches}


def bench_kernel_checks(device: str, scale_factor: int) -> dict:
    """The kernels of the bench's training paths against their plain
    versions at the shapes those paths give them (measure_step's ops and its
    B=8 steps): K1 (clamped and raw) and K1b on B=8 x 76,800 projected
    points of a random depth and of a wall; K4, K7 and K8 (and K5 beside
    them) on the full-width pyramid at B=8 x 8,192 query points, by
    train_kernel_checks.  Checks each at phase 2's and phase 7's limits;
    returns {kernel: (max abs err, relative err)}.  Above scale_factor 1
    the batch is 2 and the point counts shrink by its cube, as in
    measure_step."""
    from sv3d_tpu_torch.bench import headline, measure_step
    from sv3d_tpu_torch.ops.cuda.voxelize import scatter_voxels_cuda, scatter_voxels_raw_cuda
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels, scatter_voxels_raw

    dev = torch.device(device)
    b = 8 if scale_factor == 1 else 2
    model = headline.scene_model(headline.scene_config(scale_factor, batch_size=b), dev, seed=2)
    dims = model.config.dims
    rng = np.random.default_rng(23)
    n_vox = headline.scaled_count(240 * 320, scale_factor)
    pts = {kind: k1_points(model, kind, b, rng, outside=0)[:, :n_vox].contiguous()
           for kind in ("random", "plane")}
    k1, k1_raw = 0.0, {}
    with torch.no_grad():
        for kind, p in pts.items():
            k1 = max(k1, float((scatter_voxels_cuda(p, dims) - scatter_voxels(p, dims)).abs().max()))
            k1_raw[kind] = (rel_err(scatter_voxels_raw_cuda(p, dims),
                                    scatter_voxels_raw(p, dims))[1], k1_raw_tol(p, dims))
    tk = train_kernel_checks(model, dev, rng, pts,
                             headline.scaled_count(measure_step.N_POINTS, scale_factor))
    k5 = tk.pop("K5")
    # K1: (clamped max abs error, raw sums' largest relative error)
    errs = {"K1": (k1, max(e for e, _ in k1_raw.values())),
            **{k: (a, r) for k, (a, r, _) in tk.items()}}
    print(f"phase 23: the bench's training kernels at B={b} ({n_vox} scattered "
          f"points, {tk['K4'][2][1][0].shape[1]} query points a sample): K1 clamped "
          f"max_abs_err {k1:.3e} (tol {K1_TOL:g}), raw "
          + ", ".join(f"{kind} {e:.3e} (tol {t:.3e})" for kind, (e, t) in k1_raw.items())
          + "; " + "; ".join(f"{k} max_abs_err {a:.3e}, relative {r:.3e} (tol "
                             f"{TRAIN_KERNEL_RTOL[k]:g})" for k, (a, r) in errs.items() if k != "K1")
          + f"; K5 {k5[1]:.3f} of one bf16 ulp", flush=True)
    check(k1 <= K1_TOL, f"K1 at the bench's B=8 disagrees with its plain version: {k1}")
    check(all(e <= t for e, t in k1_raw.values()), f"K1's raw sums at B=8 disagree: {k1_raw}")
    for k in ("K1b", "K4", "K7", "K8"):
        check(errs[k][1] <= TRAIN_KERNEL_RTOL[k],
              f"{k} at the bench's B=8 disagrees with its plain version: {errs[k]}")
    check(k5[1] <= 1.0, f"K5 at the bench's B=8 disagrees with its plain version: {k5}")
    return errs


def bench_phase(device: str = "cuda", scale_factor: int = 1, n_timed: int = 3) -> dict:
    """Phase 23, the port's bench at full width: K2 bf16 on the
    res_increase-2 lattice (278 x 208 x 224) of the bench's seeded IF-Net
    and grid, held on three 8-row slabs (the first, the middle, the last)
    against its plain version at phase 3's limits, timed over the whole
    lattice in one launch beside its bound; K1, K1b, K4, K7 and K8 at the
    bench's B=8 shapes against their plain versions (bench_kernel_checks);
    then headline.main (all five sections) and measure_step.main (--set
    all) in this process with n_timed timed runs each, their meshes under
    WORK/bench, every count set to 0 just before each and read just after;
    then the f32 B=8 step of the gathers that measure_step's configurations
    leave out, for its peak memory.  Returns the K2 figures, the B=8
    kernels' errors, both results, each bench path's launches and that
    step.  device="cpu" and a scale_factor dry-run it (plain versions, no
    timing of K2)."""
    from sv3d_tpu_torch.bench import headline, measure_step
    from sv3d_tpu_torch.config import Config
    from sv3d_tpu_torch.ops.cuda import launch_counters, launch_counts
    from sv3d_tpu_torch.ops.cuda.sweep import SweepPlan, lattice_sweep, lattice_sweep_plain

    dims = Config(scale_factor=scale_factor).dims
    r = tuple(headline.RES_INCREASE * d for d in dims)
    offsets = (0, r[0] // 2 - 4, r[0] - 8)  # rows 0-7, 135-142 and 270-277 at full scale
    model, grid = headline.build_ifnet(dims, device)
    args = (model.config.align_corners, model.config.displacement)
    slabs = {}
    with torch.inference_mode():
        levels = model.encode(grid)
        plan = SweepPlan(levels, model.mlp, r, *args, torch.bfloat16)
        for off in offsets:
            got = lattice_sweep(plan, 8, off)
            ref = lattice_sweep_plain(levels, model.mlp, r, 8, off, *args, torch.bfloat16)
            check(bool(torch.isfinite(got).all()), f"K2 at res_increase 2: non-finite rows {off}+")
            slabs[off] = (float((got - ref).abs().max()), rel_mean_err(got, ref))
        whole = lattice_sweep(plan, r[0], 0)
        check(bool(torch.isfinite(whole).all()), "K2 at res_increase 2: non-finite logits")
        for off in offsets:
            check(torch.equal(lattice_sweep(plan, 8, off), whole[:, off:off + 8]),
                  f"K2 at res_increase 2: rows {off}+ differ from the whole-lattice launch")
        k2 = {"ms": cuda_ms(lambda: lattice_sweep(plan, r[0], 0), warmup=1, reps=5)
              if device == "cuda" else None,
              "bound": sweep_bound(model, levels, r, r[0], 0, torch.bfloat16),
              "max_abs_err": max(a for a, _ in slabs.values()),
              "rel_mean_err": max(m for _, m in slabs.values()), "slabs": slabs}
        del plan, whole, got, ref, levels
    print(f"phase 23: K2 bf16 on the {r} lattice ({math.prod(r)} points): rows "
          + "; ".join(f"{o}-{o + 7} max_abs_err {a:.3e}, mean_abs_err / mean |logit| {m:.3e}"
                      for o, (a, m) in slabs.items())
          + f" (tol {K2_BF16_TOL:g} and {K2_BF16_REL_MEAN_TOL:g}); the slabs equal the "
          f"whole-lattice launch bit for bit; one launch {k2['ms']} ms, bound "
          f"{k2['bound'][0]:.3f} ms ({k2['bound'][1]})", flush=True)
    for off, (a, m) in slabs.items():
        check(a <= K2_BF16_TOL and m <= K2_BF16_REL_MEAN_TOL,
              f"K2 bf16 at res_increase 2, rows {off}+, disagrees with its plain version: "
              f"{a}, {m}")
    del model, grid
    if device == "cuda":
        torch.cuda.empty_cache()
    train_errs = bench_kernel_checks(device, scale_factor)
    if device == "cuda":
        torch.cuda.empty_cache()

    bench_args = ["--n_timed", str(n_timed), "--device", device, "--scale_factor",
                  str(scale_factor), "--out_dir", str(WORK / "bench")]
    counters = launch_counters()
    runs = {}
    for name, fn in (("headline", lambda: headline.main(bench_args)),
                     ("measure_step", lambda: measure_step.main(["--set", "all", *bench_args]))):
        for wrapper in counters.values():
            wrapper.launches = 0
        result = fn()
        runs[name] = (result, {k: n for k, n in launch_counts().items() if n})
        if device == "cuda":
            torch.cuda.empty_cache()
    line, total = runs["headline"]
    check(line["sections_completed"] == list(headline.SECTIONS),
          f"the bench ran {line['sections_completed']}")
    positive({k: line[k] for k in (
        "value", "vs_baseline", "reference_scheme_points_per_sec", "points_per_sec_by_slab_rows",
        "sec_per_scene_image_to_mesh", "sec_per_scene_device", "sec_per_scene_marching_cubes",
        "sec_per_scene_vs_baseline", "reference_scheme_sec_per_scene",
        "sec_per_scene_image_to_mesh_median", "scene_faces", "arbitrary_points_per_sec",
        "arbitrary_points_per_sec_banded", "arbitrary_points_per_sec_host_loop",
        "host_return_ms_by_slab_rows", "sweep_device_ms")}, "headline", device != "cuda")
    check(line["n_points"] == math.prod(r), f"the bench swept {line['n_points']} points")
    sections = line["launches"]
    paths = {"bench_sweep": (sections["points_primary"], sections["rows_sweep"]),
             "bench_scene": (sections["scene"],), "bench_points": (sections["arbitrary"],)}
    by_path = {p: {k: sum(c.get(k, 0) for c in counts) for k in counters}
               for p, counts in paths.items()}
    check({k: sum(p[k] for p in by_path.values()) for k in counters
           if any(p[k] for p in by_path.values())} == total,
          f"the bench's launches by section {sections} do not add up to its counts {total}")
    step, step_total = runs["measure_step"]
    positive({k: step[k] for k in ("ops", "steps", "serving")}, "measure_step",
             device != "cuda")
    # the five configurations, and the three fused ones again with the cloud
    check(len(step["steps"]) == 8, f"measure_step ran {len(step['steps'])} step configurations")
    by_path["bench_step"] = step_total
    by_path = {p: {k: n for k, n in counts.items() if n} for p, counts in by_path.items()}
    print(f"phase 23: bench launches by path {by_path}", flush=True)
    # the f32 step at B=8 that the JAX package's measure_step left out for a
    # 16 GB card (its note: ~17 GB); its peak device memory in the port
    wide = measure_step.step_case(measure_step.Counted(torch.device(device), n_timed),
                                  8 if scale_factor == 1 else 2, 32, False, scale_factor,
                                  headline.scaled_count(measure_step.N_POINTS, scale_factor))
    print(f"phase 23: train step B={wide['B']}, f32, gathers: {wide['ms']:.3f} ms, peak "
          f"{wide['peak_mib']} MiB, mfu {wide['mfu']:.4f}", flush=True)
    return {"K2": k2, "train_kernels": train_errs, "headline": line, "measure_step": step,
            "launches": by_path, "step_b8_f32": wide}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: CUDA is not available")
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
        stage_channels_last,
    )
    from sv3d_tpu_torch.ops.cuda.sweep import (
        SweepPlan,
        lattice_sweep,
        lattice_sweep_bf16_cuda,
        lattice_sweep_f32_cuda,
        lattice_sweep_plain,
    )
    from sv3d_tpu_torch.ops.cuda.voxelize import (
        scatter_voxels,
        scatter_voxels_cuda,
        scatter_voxels_raw_cuda,
    )
    from sv3d_tpu_torch.ops.point_query import (
        level_features_plain,
        level_grad_points_plain,
        level_grad_vol_plain,
    )
    from sv3d_tpu_torch.ops.voxelize import scatter_voxels_raw
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
    # ptxas's registers and spills (store + load bytes) of the f32 FMA-core
    # kernels, from the build's report (build.resources)
    registers = {}
    for key, part in (("K2f32", "lattice_sweep_kernel"), ("K3f32", "fused_point_mlp_kernel"),
                      ("K6", "level_fc0_kernel")):
        res = build.resources(part)
        check(bool(res), f"no ptxas report of {part}")
        registers[key] = (max(r for r, _, _ in res.values()),
                          max(st + ld for _, st, ld in res.values()))
        print(f"registers: {part}: " + ", ".join(
            f"{name.split(part)[-1].split('EEEv')[0] or '<>'} {r} registers, spill stores "
            f"{st} B, loads {ld} B" for name, (r, st, ld) in sorted(res.items())), flush=True)

    config = Config(seed=0)  # net_res 128, scale_factor 1, inf_res 1, UNetMini
    dims = config.dims
    check(dims == (139, 104, 112), f"serving dims {dims}")
    model = seeded_scene_net(config, dev, seed=0)

    # -- phase 2: K1 against its plain version at the main-path shapes -------
    # a uniform random depth per pixel (no spatial coherence) and the rendered
    # box scene, at B=1 (serving) and B=4 (training); and a degenerate input
    # whose every warp adds to one voxel
    k1_in = {(kind, b): k1_points(model, kind, b, rng) for kind in ("random", "box")
             for b in (1, 4)}
    k1_in[("degenerate", 1)] = torch.tensor(degenerate_points(dims, 240 * 320 + 4096, rng),
                                            device=dev)
    k1_err, k1_raw = 0.0, {}
    with torch.no_grad():
        for key, p1 in k1_in.items():
            got = scatter_voxels_cuda(p1, dims)
            k1_err = max(k1_err, float((got - scatter_voxels(p1, dims)).abs().max()))
            k1_raw[key] = (rel_err(scatter_voxels_raw_cuda(p1, dims),
                                   scatter_voxels_raw(p1, dims))[1], k1_raw_tol(p1, dims))
        torch.cuda.synchronize()
    print(f"K1 scatter_voxels on {len(k1_in)} inputs of (B, {k1_in[('random', 1)].shape[1]}, 3) "
          f"-> (B, *{dims}): clamped max_abs_err {k1_err:.3e} (tol {K1_TOL:g}); raw sums, max "
          "error / max |raw| (tol 2 k 2^-24, k the most contributions to one voxel): "
          + "; ".join(f"{kind} B={b} {e:.3e} (tol {t:.3e})"
                      for (kind, b), (e, t) in k1_raw.items()),
          flush=True)
    check(k1_err <= K1_TOL, f"K1 disagrees with its plain version: {k1_err}")
    check(all(e <= t for e, t in k1_raw.values()), f"K1's raw sums disagree: {k1_raw}")
    k1_counts = {kind: k1_atomics(k1_points(model, kind, 1, np.random.default_rng(0), outside=0),
                                  dims) for kind in ("random", "box")}
    print("K1 global atomics on one 240x320 image (76,800 points), issued / one a corner: "
          + "; ".join(f"{kind} {n} / {old} ({old / n:.2f}x fewer)"
                      for kind, (n, old) in k1_counts.items()), flush=True)
    pts = k1_in[("random", 1)]

    # -- phase 3: K2, both routes, against their plain versions at full scale -
    ifnet = model.ifnet
    cfg = ifnet.config
    k2_err = {}
    sweep_args = (cfg.align_corners, cfg.displacement)
    slabs = ((1, 0), (1, 69), (1, 138), (8, 136))
    with torch.inference_mode():
        levels = ifnet.encode(model.project(pts))
        for key, dtype, tol in (("K2", torch.bfloat16, K2_BF16_TOL),
                                ("K2f32", torch.float32, K2_TOL)):
            plan = SweepPlan(levels, ifnet.mlp, dims, *sweep_args, dtype)
            # the serving path's launch: the whole lattice at once
            whole = lattice_sweep(plan, dims[0], 0)
            ref = lattice_sweep_plain(levels, ifnet.mlp, dims, dims[0], 0, *sweep_args, dtype)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(whole).all()), f"{key} non-finite logits")
            k2_err[key] = float((whole - ref).abs().max())
            rel_mean = rel_mean_err(whole, ref)
            for rows, off in slabs:
                got = lattice_sweep(plan, rows, off)
                inside = min(rows, dims[0] - off)
                check(torch.equal(got[:, :inside], whole[:, off:off + inside]),
                      f"{key} rows [{off}, {off + inside}) differ from the whole-lattice launch")
            mean_tol = (f" (tol {K2_BF16_REL_MEAN_TOL:g})" if dtype == torch.bfloat16 else "")
            print(f"{key} {str(dtype)[6:]} lattice_sweep over the whole {dims} lattice in one "
                  f"launch: max_abs_err {k2_err[key]:.3e} (tol {tol:g}), mean_abs_err / mean "
                  f"|logit| {rel_mean:.3e}{mean_tol}, |logit| <= {float(ref.abs().max()):.3f}, "
                  f"mean |logit| {float(ref.abs().mean()):.3e}; the slabs of rows {slabs} "
                  f"(rows, offset) equal it bit for bit", flush=True)
            check(k2_err[key] <= tol, f"{key} disagrees with its plain version: {k2_err[key]}")
            if dtype == torch.bfloat16:
                check(rel_mean <= K2_BF16_REL_MEAN_TOL,
                      f"K2 bf16's mean error is {rel_mean} of the mean logit")
                for skip in ("hidden", "feature"):
                    wrong = plain_bf16_sweep(levels, ifnet.mlp, dims, dims[0], 0, *sweep_args,
                                             (skip,))
                    wrong_err = (float((wrong - ref).abs().max()), rel_mean_err(wrong, ref))
                    print(f"  the plain bf16 sweep with its {skip} rounding left out, against "
                          f"the plain version: max_abs_err {wrong_err[0]:.3e}, mean_abs_err / "
                          f"mean |logit| {wrong_err[1]:.3e}: K2 bf16's limits fail it",
                          flush=True)
                    check(wrong_err[0] > tol or wrong_err[1] > K2_BF16_REL_MEAN_TOL,
                          f"K2 bf16's limits would pass a sweep without its {skip} rounding: "
                          f"{wrong_err}")
                del wrong
            del plan, whole, ref

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
    lattice_sweep_bf16_cuda.launches = 0
    lattice_sweep_f32_cuda.launches = 0
    served_config, served = load_model(args)
    vox, depth_np = predict(served_config, served, rgb=rgb)
    torch.save(vox.cpu(), WORK / "served_grid.pt")  # the world-2 phase's grid
    verts, tris = implicit_to_mesh(
        served.ifnet, vox, served_config.dims, args.threshold, WORK / "scene.obj",
        res_increase=served_config.inf_res)
    torch.cuda.synchronize()
    launches = {"scatter_voxels": scatter_voxels_cuda.launches,
                "lattice_sweep_bf16": lattice_sweep_bf16_cuda.launches,
                "lattice_sweep_f32": lattice_sweep_f32_cuda.launches}
    print(f"serving path: launches {launches}, depth {depth_np.shape} in "
          f"[{depth_np.min():.3f}, {depth_np.max():.3f}], mesh at {args.threshold}: "
          f"{len(verts)} verts {len(tris)} faces", flush=True)
    check(launches["scatter_voxels"] > 0 and launches["lattice_sweep_bf16"] > 0
          and launches["lattice_sweep_f32"] == 0,
          f"the serving path did not run K1 and K2 bf16 (alone): {launches}")

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
    grids, grids32 = [], []
    for m in (small_gpu, small_cpu):
        v, _ = predict(small_cfg, m, rgb=rgb)
        grids.append(evaluate_on_grid(m.ifnet, v, small_cfg.dims, transfer_dtype=torch.float32))
        with torch.inference_mode():
            g32 = evaluate_on_grid_device(m.ifnet, m.ifnet.encode(v), small_cfg.dims,
                                          compute_dtype=torch.float32)
        grids32.append(g32[:small_cfg.dims[0]].cpu().numpy())
    slice_err = float(np.abs(grids[0] - grids[1]).max())
    slice_err32 = float(np.abs(grids32[0] - grids32[1]).max())
    print(f"slice at scale_factor 8, card vs CPU plain: bf16 (the default) max_abs_err "
          f"{slice_err:.3e} (tol {SLICE_BF16_TOL:g}), float32 max_abs_err {slice_err32:.3e} "
          f"(tol {SLICE_TOL:g})", flush=True)
    check(slice_err <= SLICE_BF16_TOL, f"card bf16 slice disagrees with the CPU's: {slice_err}")
    check(slice_err32 <= SLICE_TOL, f"card f32 slice disagrees with the CPU's: {slice_err32}")
    # arbitrary points on the CPU's grid: the card's routes against the CPU
    # port's plain versions of the same routes
    small_pts = np.random.default_rng(4).uniform(-0.45, 0.45, (16384, 3)).astype(np.float32)
    pts_err = points_card_vs_cpu(small_gpu.ifnet, small_cpu.ifnet, v, small_pts, 4096)
    print("evaluate_points at scale_factor 8, 16384 points, card vs CPU plain (largest sigmoid "
          "difference; mean |logit difference| / mean |logit|): "
          + "; ".join(f"{k} {a:.3e}, {m:.3e}" for k, (a, m) in pts_err["routes"].items())
          + f" (tol bf16 {POINTS_BF16_CARD_TOL:g} and {POINTS_BF16_REL_MEAN_TOL:g}, f32 "
          f"{POINTS_TOL:g}); against the CPU's bf16 route, the card's f32 route and the CPU's "
          "bf16 route with its tail in f32: "
          + "; ".join(f"{k} {m:.3e}" for k, m in pts_err["wrong"].items())
          + ": the bf16 mean limit fails each", flush=True)
    for name, (a, m) in pts_err["routes"].items():
        ok = (a <= POINTS_TOL if "f32" in name or name == "gather"
              else a <= POINTS_BF16_CARD_TOL and m <= POINTS_BF16_REL_MEAN_TOL)
        check(ok, f"card evaluate_points route {name} disagrees with the CPU's: {a}, {m}")
    check(min(pts_err["wrong"].values()) > POINTS_BF16_REL_MEAN_TOL,
          f"the bf16 points' mean limit would pass another class: {pts_err['wrong']}")

    # -- phase 6: serving timings --------------------------------------------
    routes = (("K2", torch.bfloat16), ("K2f32", torch.float32))
    slab_sizes = (1, 8, dims[0])
    k1_t = k1_timings({k: v for k, v in k1_in.items() if k[0] != "degenerate"}, dims)
    with torch.inference_mode():
        plan_ms, k2_ms, k2_plain_ms, k2_whole_ms, k2_plain_whole_ms = {}, {}, {}, {}, {}
        for key, dtype in routes:
            plan_ms[key] = cuda_ms(lambda dtype=dtype: ifnet.sweep_plan(levels, dims, 1, dtype),
                                   warmup=1, reps=5)
            plan = ifnet.sweep_plan(levels, dims, 1, dtype)
            # the kernel alone on a prebuilt plan: one row, and the whole
            # lattice (the serving path's one launch)
            k2_ms[key] = cuda_ms(lambda plan=plan: lattice_sweep(plan, 1, 69))
            k2_whole_ms[key] = cuda_ms(lambda plan=plan: lattice_sweep(plan, dims[0], 0),
                                       warmup=1, reps=5)
            k2_plain_ms[key] = cuda_ms(lambda dtype=dtype: lattice_sweep_plain(
                levels, ifnet.mlp, dims, 1, 69, *sweep_args, dtype))
            k2_plain_whole_ms[key] = cuda_ms(lambda dtype=dtype: lattice_sweep_plain(
                levels, ifnet.mlp, dims, dims[0], 0, *sweep_args, dtype), warmup=0, reps=2)
            del plan
        # K2 f32's yardstick: the unfused f32 sweep (slab_features + K3 f32)
        # over the whole lattice, a row at a time
        unfused_f32_ms = cuda_ms(lambda: [ifnet.query_lattice(
            levels, dims, 1, 1, row, torch.float32, fused_tail=False) for row in range(dims[0])],
            warmup=1, reps=3)
        n_pts = dims[0] * dims[1] * dims[2]
        sweep_ms = {
            (key, rows): cuda_ms(lambda rows=rows, dtype=dtype: evaluate_on_grid_device(
                ifnet, levels, dims, 1, rows, dtype), warmup=1, reps=5)
            for key, dtype in routes for rows in slab_sizes
        }

    def serve():
        v, _ = predict(served_config, served, rgb=rgb)
        implicit_to_mesh(served.ifnet, v, served_config.dims, args.threshold, WORK / "t.obj")

    e2e = []
    for i in range(6):
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        if i:  # the first run is warm-up
            e2e.append(time.perf_counter() - t0)
    serve_prof = profile_lines(serve, steps=2)
    print(f"serving timings on {smi}:", flush=True)
    for (kind, b), t in k1_t.items():
        print(f"  K1 scatter_voxels, {kind} depth, B={b} x {pts.shape[1]} points: {t['ms']:.4f} ms "
              f"a call (the host returns in {t['host_ms']:.4f} ms); device {t['device']:.4f} ms "
              f"= kernel {t['kernel']:.4f} + memset {t['memset']:.4f} + clamp "
              f"{t['clamp']:.4f} (torch.profiler); bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}); plain {t['plain_ms']:.4f} ms; "
              f"F.grid_sample's backward for the volume {t['library_ms']:.4f} ms (its "
              f"difference from K1's raw sums {t['library_err']:.2e} of the largest); global "
              f"atomics {t['atomics'][0]} (one a corner: {t['atomics'][1]})", flush=True)
    bounds = {
        # points in, grid out; 8 corners of 4 flops a point (random depth, B=1)
        "K1": k1_t[("random", 1)]["bound"],
        # K2 at the serving path's shape: the whole lattice in one launch
        **{key: sweep_bound(ifnet, levels, dims, dims[0], 0, dtype) for key, dtype in routes},
    }
    row_bounds = {key: sweep_bound(ifnet, levels, dims, 1, 69, dtype) for key, dtype in routes}
    for key, dtype in routes:
        print(f"  {key} ({str(dtype)[6:]}) kernel alone on a prebuilt plan: one lattice row "
              f"({dims[1] * dims[2]} points, row 69) {k2_ms[key]:.4f} ms, bound "
              f"{row_bounds[key][0]:.4f} ms ({row_bounds[key][1]}), plain "
              f"{k2_plain_ms[key]:.4f} ms; the whole lattice in one launch "
              f"{k2_whole_ms[key]:.3f} ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]}), "
              f"plain {k2_plain_whole_ms[key]:.3f} ms; the plan's build {plan_ms[key]:.3f} ms",
              flush=True)
    print(f"  K2f32's yardstick, the unfused f32 sweep (query_lattice(fused_tail=False), "
          f"slab_features + K3 f32) over the whole lattice, {dims[0]} rows of slab_rows 1: "
          f"{unfused_f32_ms:.3f} ms, beside K2f32's one launch {k2_whole_ms['K2f32']:.3f} ms "
          f"and its bound {bounds['K2f32'][0]:.3f} ms ({bounds['K2f32'][0] / k2_whole_ms['K2f32']:.1%} "
          "of the bound)", flush=True)
    for (key, rows), ms in sweep_ms.items():
        print(f"  dense sweep {key} slab_rows={rows}: {ms:.3f} ms, "
              f"{n_pts / (ms / 1e3):.4g} points/s", flush=True)
    print(f"  warm image->mesh: median {statistics.median(e2e):.4f} s over {len(e2e)} runs "
          f"({', '.join(f'{t:.4f}' for t in e2e)})", flush=True)
    print("  profiled image->mesh (predict + implicit_to_mesh, the defaults):", flush=True)
    for line in serve_prof:
        print(f"    {line}", flush=True)
    del levels

    # -- phase 6b: the arbitrary-point path on the served grid ----------------
    pts_np = np.random.default_rng(3).uniform(-0.45, 0.45, (N_POINTS, 3)).astype(np.float32)
    pp = points_path(served, vox, pts_np, smi)
    del served, vox

    # -- phase 7: training kernels against their plain versions -------------
    tk = train_kernel_checks(model, dev, rng, {"random": k1_in[("random", 4)],
                                               "box": k1_in[("box", 4)],
                                               "degenerate": k1_in[("degenerate", 1)]})
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
    # the IF-Net's convs hand their gradients channels-last: cuDNN's input gradient
    check(all(n > 0 for k, n in train_launches.items() if k != "dgrad")
          and train_launches["dgrad"] == 0,
          f"a kernel never ran on the training path (or the dgrad kernel did): {train_launches}")
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

    # -- phase 8b: the fit's checkpoint served through the serving CLI -------
    ckpt_served = checkpoint_serving_phase(
        last, data_root / "raw" / "overfit" / "00000" / "rgb.png", data_root / "intrinsics.txt",
        WORK / "served_checkpoint")
    print(f"serving the fit's checkpoints/last (predict.main, --rgb, the mesh at the grid's "
          f"median level {ckpt_served['level']:.4f}): launches {ckpt_served['launches']}, "
          f"{ckpt_served['verts']} verts {ckpt_served['faces']} faces", flush=True)
    check(ckpt_served["faces"] > 0, "the served checkpoint's mesh has no faces")
    check(ckpt_served["launches"]["scatter_voxels"] > 0
          and ckpt_served["launches"]["lattice_sweep_bf16"] > 0
          and ckpt_served["launches"]["lattice_sweep_f32"] == 0,
          f"serving the checkpoint did not run K1 and K2 bf16 (alone): {ckpt_served['launches']}")

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
    lv_cl = [(stage_channels_last(f).transpose(1, 2), d) for f, d in lv]
    k1b_t = k1b_timings({k: v for k, v in tk["K1b"][2].items() if k != "degenerate"})
    tk["K1b"] = tk["K1b"][:2]  # free K1b's grids and cotangents before the step's peak
    peak = step_peak_memory(trainer, batch, gen, (
        "port", "level_features saves the channels-last copy"))
    kernel_ms = {
        "K4": (cuda_ms(lambda: [level_features_cuda(f, *p, d, ac, disp) for f, d in lv]),
               cuda_ms(lambda: [level_features_plain(f, *p, d, ac, disp) for f, d in lv])),
        # as the backward runs it: on the flat, the wrapper staging it
        "K7": (cuda_ms(lambda: [level_grad_points_cuda(f, *p, g, d, ac, disp)
                                for (f, d), g in zip(lv, gs)]),
               cuda_ms(lambda: [level_grad_points_plain(f, *p, g, d, ac, disp)
                                for (f, d), g in zip(lv, gs)])),
        "K8": (cuda_ms(lambda: [level_grad_vol_cuda(*p, g, d, ac, disp)
                                for (_, d), g in zip(lv, gs)]),
               cuda_ms(lambda: [level_grad_vol_plain(*p, g, d, ac, disp)
                                for (_, d), g in zip(lv, gs)])),
    }
    k8_rows = k8_levels(lv, p, gs, ac, disp)
    for row in k8_rows:
        check(row["err"] <= TRAIN_KERNEL_RTOL["K8"],
              f"K8 disagrees with its plain version on a level: {row}")
    copies = step_copy_kernels(trainer, batch, gen, ("port", "K8's gradient channel-major",
                                                     "K1b's cotangent made contiguous"))
    train_staged = feature_staging_ms(lv, p, (ac, disp))
    k7_kernel_ms = cuda_ms(lambda: [level_grad_points_cuda(f, *p, g, d, ac, disp)
                                    for (f, d), g in zip(lv_cl, gs)])
    gs_inputs = grid_sample_inputs(lv, p, ac, disp)
    library = {"K4": grid_sample_ms(gs_inputs, ac), "K7": grid_sample_ms(gs_inputs, ac, "points"),
               "K8": grid_sample_ms(gs_inputs, ac, "level"), **pp["library"],
               "K1": k1_t[("random", 1)]["library_ms"], "K1b": k1b_t["random"]["library_ms"]}
    del gs_inputs, lv_cl
    n_feat = p[0].numel() * 7 * sum(f.shape[1] for f, _ in lv)  # B * N * 7 * sumC
    train_gathered = gathered_bytes(lv, p, ac, disp)
    print(f"  K4/K7 gathered bytes at the training shapes: {train_gathered} of the levels' "
          f"{nbytes(*levels.flats)}", flush=True)
    bounds.update(pp["bounds"])
    bounds.update({
        # the touched sectors of the clamped grid and the cotangent, points
        # in, the points' gradient out; 8 corners of 6 flops a point (random
        # depth, B=4)
        "K1b": k1b_t["random"]["bound"],
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
        print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms (all 6 levels, B=4 x 8192 points)",
              flush=True)
    for kind, t in k1b_t.items():
        print(f"  K1b scatter_voxels_bwd, {kind} depth, B=4 x 80,896 points, the cotangent in the "
              f"blur backward's strides: {t['ms']:.4f} ms a call (the host returns in "
              f"{t['host_ms']:.4f} ms), kernel {t['kernel']:.4f} ms (torch.profiler); bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]}); plain "
              f"{t['plain_ms']:.4f} ms; F.grid_sample's backward for the grid "
              f"{t['library_ms']:.4f} ms (its difference from the plain result "
              f"{t['library_err']:.2e} of the largest); launches in the 12-step fit "
              f"{train_launches['K1b']}", flush=True)
    print_staging("training shapes, B=4 x 8192", train_staged)
    print("  K8 by level at the training shapes (CUDA-event medians; global atomic operations "
          "on this run's corners):", flush=True)
    for row in k8_rows:
        print(f"    C {row['C']}, G {row['G']}: {row['ms']:.4f} ms, {row['atomics']} atomics; the "
              f"old channel-major kernel's atomics {row['atomics old']}; max rel err "
              f"{row['err']:.2e}", flush=True)
    print(f"  K8 over the 6 levels: {kernel_ms['K8'][0]:.4f} ms, "
          f"{sum(r['atomics'] for r in k8_rows)} global atomic operations (the old kernel: "
          f"{sum(r['atomics old'] for r in k8_rows)}); "
          f"F.grid_sample's backward for the volume {library['K8']:.4f} ms; launches in the "
          f"12-step fit {train_launches['K8']}", flush=True)
    print("  copy kernels a warm train step (count, device ms): " + ", ".join(
        f"{k}: {n:g}, {ms:.3f}" for k, (n, ms) in copies.items()), flush=True)
    check(all(copies["port"][0] <= n for n, _ in copies.values()),
          f"a layout of the port added copy kernels: {copies}")
    print(f"  K7 apart at the training shapes: kernel alone on channels-last levels "
          f"{k7_kernel_ms:.4f} ms; the backward's K7 above stages the levels as K4 does",
          flush=True)
    print("  peak device memory of a warm fused_query train step (max_memory_allocated; the "
          f"step's own rise above what was allocated before it; with the raw grid kept "
          f"{PEAK_RAW_GRID_MIB} MiB): "
          + ", ".join(f"{k}: {top / 2**20:.1f} MiB, rise {rise / 2**20:.1f} MiB"
                      for k, (top, rise) in peak.items()), flush=True)
    for line in prof_lines:
        print(f"  {line}", flush=True)
    print(f"  library calls: K4 F.grid_sample {library['K4']:.4f} ms, its backward for the "
          f"points K7 {library['K7']:.4f} ms and for the levels K8 {library['K8']:.4f} ms "
          "(all 6 levels, B=4 x 8192 points)", flush=True)

    # -- phase 12: offline preprocessing, through its CLI ---------------------
    ifnet_root, pre_s, pre_n = preprocessing_phase(WORK / "ifnet_data")
    print(f"preprocessing: process_sample's CLI at --num_samples 100000, full dims: {pre_n} "
          f"samples (1 processed, 1 quarantined: IndexError past the far plane) in {pre_s:.3f} s, "
          f"{pre_s / pre_n:.3f} s a sample", flush=True)

    # -- phase 13: the IF-Net-only fit at full width, through its entry point -
    t_phase = time.perf_counter()
    ifnet_cfg = Config(seed=0, net_res=128, scale_factor=1, batch_size=16, num_points=2048,
                       fused_query=True, visualize=True, sanity_steps=0, val_check_interval=6,
                       datasetdir=str(ifnet_root), splitsdir="overfit", experiment="smoke_ifnet")
    ifnet_counters = {k: v for k, v in _counters().items()
                      if k in ("K4", "K7", "K8", "wgrad", "dgrad")}
    ifnet_counters["K2"] = lattice_sweep_bf16_cuda
    fit_ifnet = ifnet_fit_phase(ifnet_cfg, ifnet_counters)
    print(f"phase 13 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 14: the UNet-only fits --------------------------------------------
    t_phase = time.perf_counter()
    unet_cfg = Config(seed=0, batch_size=16, visualize=True, sanity_steps=0,
                      val_check_interval=6, datasetdir=str(data_root), splitsdir="overfit",
                      experiment="smoke_unet")
    fit_unet = unet_fit_phase(unet_cfg)
    print(f"phase 14 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 15: the loss drops over 10 steps on one fixed batch, each trainer
    t_phase = time.perf_counter()
    drops = {"IF-Net-only": loss_drops(fit_ifnet["trainer"]),
             "UNet-only": loss_drops(fit_unet["trainer"])}
    for name, losses in drops.items():
        print(f"10 {name} steps on one batch of 16: loss {', '.join(f'{x:.5f}' for x in losses)}",
              flush=True)
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"the {name} loss did not drop: {losses}")
    print(f"phase 15 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 16: one step of each new trainer, card against CPU ----------------
    t_phase = time.perf_counter()
    ifnet8_root, _, _ = preprocessing_phase(WORK / "ifnet_data8", scale_factor=8,
                                            num_samples=4000)
    shapes = {"IF-Net-only": "fused_query, scale_factor 8", "UNet-only": "UNetMini, 240x320"}
    new_par = {
        "IF-Net-only": new_step_parity(dev, "ifnet", Config(
            seed=0, scale_factor=8, batch_size=2, num_points=256, fused_query=True,
            datasetdir=str(ifnet8_root), splitsdir="overfit")),
        "UNet-only": new_step_parity(dev, "unet", Config(
            seed=0, batch_size=2, datasetdir=str(data_root), splitsdir="overfit")),
    }
    for kind, par_k in new_par.items():
        for run, res in par_k.items():
            print(f"{kind} train step ({shapes[kind]}, B=2), {run} f32 vs CPU float64, largest difference as a fraction of its "
                  "bound (<= 1 passes): "
                  + ", ".join(f"{k} {r:.3e} {n}" for k, (r, n) in res.items()), flush=True)
            check(max(r for r, _ in res.values()) <= 1.0,
                  f"the {run}'s f32 {kind} step disagrees with the float64 step: {res}")
    print(f"phase 16 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 17: evaluation ----------------------------------------------------
    t_phase = time.perf_counter()
    evaluation = evaluation_phase(fit_ifnet, ifnet_cfg.dims)
    print(f"phase 17 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 18: timings of the new paths ---------------------------------------
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    ifnet_batch = fixed_batch(fit_ifnet["trainer"], 16)
    new_step_ms, new_peak = {}, {}
    for name, trainer_kw, batch_of in (
        ("IF-Net-only fused_query=True", ("ifnet", ifnet_cfg), ifnet_batch),
        ("IF-Net-only fused_query=False", ("ifnet", ifnet_cfg.replace(fused_query=False)),
         ifnet_batch),
        ("UNet-only UNetMini", ("unet", unet_cfg), None),
        ("UNet-only UNet (resize_input)", ("unet", unet_cfg.replace(resize_input=True)), None),
    ):
        cls, _ = _new_trainer(trainer_kw[0])
        t = cls(trainer_kw[1], device="cuda", experiment_dir=WORK / "time_new")
        b = batch_of if batch_of is not None else fixed_batch(t, 16)
        st = t.build_state()
        new_step_ms[name] = cuda_ms(lambda t=t, st=st, b=b: t.train_step(st, b, gen), reps=5)
        new_peak[name] = peak_step_mib(lambda t=t, st=st, b=b: t.train_step(st, b, gen))
        if name == "IF-Net-only fused_query=True":
            fused_trainer, fused_state = t, st
        del st
    _, wall, device_t, events = profile_calls(
        lambda: fused_trainer.train_step(fused_state, ifnet_batch, gen), 3)
    ifnet_prof = [f"profiled IF-Net-only fused_query step (B=16, 4096 points a sample): "
                  f"{wall:.3f} ms host clock, {device_t:.3f} ms device self time, device idle "
                  f"{100.0 * (1.0 - device_t / wall):.1f}% (torch.profiler, 3 steps)",
                  *_top_lines(events, device_t, 3)]
    for kname, part in (("K4", "level_features_kernel"), ("K7", "level_grad_points"),
                        ("K8", "level_grad_vol"), ("wgrad", "conv3d_wgrad")):
        ms = sum(dev_us(e) for e in events if part in e.key) / 1e3 / 3
        ifnet_prof.append(f"  {kname} ({part}): {ms:.4f} ms a step, "
                          f"{100.0 * ms / device_t:.3f}% of device time")
    check_wgrad_kernels(events, "the IF-Net-only f32 step")
    del fused_state
    ifnet_k = ifnet_kernel_timings(fit_ifnet["trainer"].build_state().model, ifnet_batch, smi)
    print(f"IF-Net-only and UNet-only timings on {smi}:", flush=True)
    for name, ms in new_step_ms.items():
        print(f"  {name} train step, B=16: median {ms:.3f} ms of 5 (CUDA events, 2 warm-ups); "
              f"peak device memory {new_peak[name]:.1f} MiB", flush=True)
    for line in ifnet_prof:
        print(f"  {line}", flush=True)
    print(f"phase 18 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 19: serving at precision 16 ----------------------------------------
    t_phase = time.perf_counter()
    serve_p16 = serving_p16_phase(ckpt, data_root / "raw" / "overfit" / "00000" / "rgb.png",
                                  intr_path, rgb, smi)
    print(f"phase 19 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 20: training at precision 16, each trainer ---------------------------
    t_phase = time.perf_counter()
    fit_p16 = training_p16_phase(
        {"end to end": ("scene", train_cfg.replace(precision=16)),
         "IF-Net-only": ("ifnet", ifnet_cfg.replace(precision=16, val_check_interval=4)),
         "UNet-only UNetMini": ("unet", unet_cfg.replace(precision=16))},
        {"scene": batch, "ifnet": ifnet_batch},
        {"end to end": (step_ms[True], peak["port"][0] / 2**20),
         "IF-Net-only": (new_step_ms["IF-Net-only fused_query=True"],
                         new_peak["IF-Net-only fused_query=True"]),
         "UNet-only UNetMini": (new_step_ms["UNet-only UNetMini"],
                                new_peak["UNet-only UNetMini"])},
        {"end to end": ("scene", parity_config(data_root)),
         "IF-Net-only": ("ifnet", Config(seed=0, scale_factor=8, batch_size=2, num_points=256,
                                         fused_query=True, datasetdir=str(ifnet8_root),
                                         splitsdir="overfit")),
         "UNet-only": ("unet", Config(seed=0, batch_size=2, datasetdir=str(data_root),
                                      splitsdir="overfit"))},
        smi)
    print(f"phase 20 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 21: the quality smoke, both precisions ---------------------------------
    t_phase = time.perf_counter()
    quality_p16_phase()
    print(f"phase 21 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 22: the sharded paths on 2 ranks that share the card ---------------------
    t_phase = time.perf_counter()
    w2 = world2_phase(train_cfg.replace(val_check_interval=1000), config, WORK / "served_grid.pt",
                      pts_np)
    print(f"world 2 (two ranks on the one card, gloo): launches by rank {w2['launches']} "
          f"(single-process {w2['single_launches']}); the dp=2 fit against the single-process "
          "fit on the ranks' labels (of which a share of "
          f"{max(w2['label_flips']):.2e} differ from its own), largest difference as a "
          "fraction of its bound (<= 1 passes) by rank: "
          + "; ".join(", ".join(f"{k} {e[k][0]:.3e} {e[k][1]}" for k in ("loss", "grads",
                                                                         "params", "bn"))
                      + f", parameters within 1e-6 after step 1 {e['same']:.4f}; step 2's loss "
                      f"{e['loss_2']:.3e} apart, parameters within 1e-6 {e['same_2']:.4f}"
                      for e in w2["fit"])
          + f"; the sp=2 lattice bit-equal {w2['lattice_equal']} (max |diff| {w2['lattice']}), "
          f"evaluate_points bit-equal {w2['points_equal']} (max |diff| {w2['points']})",
          flush=True)
    world2_checks(w2)
    print(f"phase 22 in {time.perf_counter() - t_phase:.2f} s", flush=True)
    w2_total = {k: sum(n) for counts in w2["launches"].values() for k, n in counts.items()}

    # -- phase 23: the port's bench at full width ----------------------------------------
    t_phase = time.perf_counter()
    bench = bench_phase()
    print(f"phase 23 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 24: the multi-scene quality path at full width -----------------------------
    t_phase = time.perf_counter()
    multi = multiscene_phase()
    print(f"phase 24 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 25: the conv weight gradient at the two pyramids' and the U-Net's shapes ---
    t_phase = time.perf_counter()
    dims = (139, 104, 112)
    wgrad_rows = wgrad_phase(smi, pyramid_conv_shapes(128, dims, 4),
                             f"the IF-Net 128 pyramid, B=4 at {dims}", ragged=WGRAD_RAGGED)
    wgrad_rows.update({f"net32.{k}": r for k, r in wgrad_phase(
        smi, pyramid_conv_shapes(32, dims, 4), f"the IF-Net 32 pyramid, B=4 at {dims}").items()})
    wgrad_rows.update({f"convonet.{k}": r for k, r in wgrad_phase(
        smi, unet3d_conv_shapes(32), "ConvONet's room_grid64 U-Net, B=32").items()})
    print(f"phase 25 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    # -- phase 26: the conv input gradient at the U-Net's shapes, and the IF-Net's route --
    t_phase = time.perf_counter()
    dgrad_rows = {f"convonet.{k}": r for k, r in dgrad_phase(
        smi, unet3d_conv_shapes(32), "ConvONet's room_grid64 U-Net, B=32",
        ragged=DGRAD_RAGGED).items()}
    ifnet_route = ifnet_dgrad_route()
    print(f"the IF-Net 128's f32 step at B=4: {ifnet_route['ifnet.dgrad']} input gradients, "
          f"{ifnet_route['ifnet.dgrad_kernel']} of them the kernel's (the rest cuDNN's: "
          "channels-last dy)", flush=True)
    if ifnet_route["ifnet.dgrad_kernel"]:
        dgrad_rows.update({f"ifnet.{k}": r for k, r in dgrad_phase(
            smi, pyramid_conv_shapes(128, dims, 4), f"the IF-Net 128 pyramid, B=4 at {dims}")
            .items()})
    convonet_step = convonet_step_phase(data_root, smi)
    print(f"phase 26 in {time.perf_counter() - t_phase:.2f} s", flush=True)

    measured = {
        # the random depth at the serving shape, as the row has always been
        # read (the box scene's numbers are its "box" key); launches on both
        # main paths
        "K1": (launches["scatter_voxels"] + ckpt_served["launches"]["scatter_voxels"]
               + train_launches["K1"] + serve_p16["launches"]["scatter_voxels"]
               + fit_p16["end to end"]["K1"], k1_err,
               k1_t[("random", 1)]["ms"], k1_t[("random", 1)]["plain_ms"]),
        # at the serving path's shape: the whole lattice in one launch
        # K2 bf16 on the serving path and in the IF-Net-only fit's validations
        "K2": (launches["lattice_sweep_bf16"] + ckpt_served["launches"]["lattice_sweep_bf16"]
               + fit_ifnet["launches"]["K2"] + serve_p16["launches"]["lattice_sweep_bf16"]
               + fit_p16["IF-Net-only"]["K2"],
               k2_err["K2"],
               k2_whole_ms["K2"], k2_plain_whole_ms["K2"]),
        "K2f32": (launches["lattice_sweep_f32"], k2_err["K2f32"], k2_whole_ms["K2f32"],
                  k2_plain_whole_ms["K2f32"]),
        # the random depth at the training shape, as the row has always been read
        "K1b": (train_launches["K1b"] + fit_p16["end to end"]["K1b"], tk["K1b"][0],
                k1b_t["random"]["ms"],
                k1b_t["random"]["plain_ms"]),
        # both fits' launches; times at the end-to-end fit's shape, as the rows
        # have always been read (the IF-Net-only shape under "fit_ifnet")
        **{k: (train_launches[k] + fit_ifnet["launches"][k] + fit_p16["end to end"][k]
               + fit_p16["IF-Net-only"][k], tk[k][0], *kernel_ms[k])
           for k in ("K4", "K7", "K8")},
        **{k: (pp["launches"][k] + serve_p16["points_launches"].get(k, 0), pp["err"][k],
               *pp["ms"][k])
           for k in ("K3", "K3f32", "K5", "K6", "K6bf16")},
    }
    kernels = []
    for key, name, source, replaces in (
        ("K1", "scatter_voxels", "voxelize.cu", "sv3d_tpu/ops/pallas/voxelize.py:130"),
        ("K1b", "scatter_voxels_bwd", "voxelize.cu", "sv3d_tpu/ops/pallas/voxelize.py:224"),
        ("K2", "lattice_sweep_bf16", "sweep.cu", "sv3d_tpu/ops/pallas/sweep.py:162"),
        ("K2f32", "lattice_sweep_f32", "sweep.cu", "sv3d_tpu/ops/pallas/sweep.py:162"),
        ("K3", "fused_point_mlp_bf16", "mlp.cu", "sv3d_tpu/ops/pallas/mlp.py:41"),
        ("K3f32", "fused_point_mlp_f32", "mlp.cu", "sv3d_tpu/ops/pallas/mlp.py:41"),
        ("K4", "level_features", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:439"),
        ("K5", "level_features_banded", "point_query.cu",
         "sv3d_tpu/ops/pallas/point_query.py:692"),
        ("K6", "level_fc0", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:968"),
        ("K6bf16", "level_fc0_bf16", "point_query.cu", "sv3d_tpu/ops/pallas/point_query.py:968"),
        ("K7", "level_grad_points", "point_query.cu",
         "sv3d_tpu/ops/pallas/point_query_bwd.py:172"),
        ("K8", "level_grad_vol", "point_query.cu", "sv3d_tpu/ops/pallas/point_query_bwd.py:365"),
    ):
        n, err, ms, plain = measured[key]
        n += (w2_total.get(key, 0) + sum(c.get(key, 0) for c in bench["launches"].values())
              + multi["launches"].get(key, 0))
        kernels.append({
            "name": name, "route": "cuda", "source": f"sv3d_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": library.get(key)})
        if key == "K3":  # the kernel's device time, and what the library time is
            kernels[-1]["device_ms"] = pp["K3 device_ms"]
            kernels[-1]["library"] = "cuBLAS bf16 chain: 4 matmul_bf16 with bias and ReLU"
        if key == "K3f32":
            kernels[-1]["device_ms"] = pp["K3f32 device_ms"]
            kernels[-1]["library"] = "cuBLAS f32 chain (TF32 off): 4 F.linear with ReLU"
        if key == "K2f32":  # a two-call route, not a library call: library_ms stays null
            kernels[-1]["yardstick_ms"] = unfused_f32_ms
            kernels[-1]["yardstick"] = ("the unfused f32 sweep: slab_features + K3 f32, the "
                                        "lattice a row at a time")
        if key == "K6":  # a two-call route, not a library call: library_ms stays null
            kernels[-1]["yardstick_ms"] = pp["K6 yardstick"]["K4+matmul"]
            kernels[-1]["yardstick"] = "K4 + f32 torch.matmul over the same levels, in turns"
        if key == "K6bf16":  # a two-call route, not a library call: library_ms stays null
            kernels[-1]["yardstick_ms"] = pp["K6bf16 yardstick"]["K5+matmul_bf16"]
            kernels[-1]["route_ms"] = pp["K6bf16 yardstick"]["K6bf16"]
            kernels[-1]["yardstick"] = ("K5 + matmul_bf16 over the same six levels, in turns "
                                        "with K6 bf16 as query_fused runs it (route_ms)")
        if key == "K2":  # a two-call route, not a library call: library_ms stays null
            kernels[-1]["yardstick_ms"] = pp["K2 yardstick"]
            kernels[-1]["yardstick"] = ("the unfused bf16 sweep: slab_features + K3 bf16, the "
                                        "lattice a row at a time")
        if key in registers:
            kernels[-1]["registers"], kernels[-1]["spill_bytes"] = registers[key]
        if key == "K1":
            kernels[-1]["launches_by_path"] = {
                "serving": launches["scatter_voxels"],
                "serving_checkpoint": ckpt_served["launches"]["scatter_voxels"],
                "fit": train_launches["K1"],
                "serving_p16": serve_p16["launches"]["scatter_voxels"],
                "fit_p16": fit_p16["end to end"]["K1"]}
        if key == "K1b":
            kernels[-1]["launches_by_path"] = {"fit": train_launches["K1b"],
                                               "fit_p16": fit_p16["end to end"]["K1b"]}
        if key == "K6bf16":
            kernels[-1]["launches_by_path"] = {
                "points": pp["launches"]["K6bf16"],
                "points_p16": serve_p16["points_launches"]["K6bf16"]}
        if key == "K2":
            kernels[-1]["launches_by_path"] = {
                "serving": launches["lattice_sweep_bf16"],
                "serving_checkpoint": ckpt_served["launches"]["lattice_sweep_bf16"],
                "fit_ifnet": fit_ifnet["launches"]["K2"],
                "serving_p16": serve_p16["launches"]["lattice_sweep_bf16"],
                "fit_ifnet_p16": fit_p16["IF-Net-only"]["K2"]}
        if key in ("K4", "K7", "K8"):
            t = ifnet_k[key]
            kernels[-1]["launches_by_path"] = {"fit": train_launches[key],
                                               "fit_ifnet": fit_ifnet["launches"][key],
                                               "fit_p16": fit_p16["end to end"][key],
                                               "fit_ifnet_p16": fit_p16["IF-Net-only"][key]}
            kernels[-1]["fit_ifnet"] = {
                "max_abs_err_rel": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}
        # the world-2 phase's paths: the two ranks' launches summed here, and
        # each rank's under "world2_by_rank"
        for path, counts in w2["launches"].items():
            if key in counts:
                kernels[-1]["launches_by_path"][path] = sum(counts[key])
                kernels[-1].setdefault("world2_by_rank", {})[path] = counts[key]
        # phase 23's bench paths and phase 24's multi-scene path
        for path, counts in [*bench["launches"].items(), ("multiscene", multi["launches"])]:
            if key in counts:
                kernels[-1].setdefault("launches_by_path", {})[path] = counts[key]
        if key == "K2":  # the bench's lattice, res_increase 2, in one launch
            t = bench["K2"]
            kernels[-1]["r2"] = {"ms": t["ms"], "bound_ms": t["bound"][0],
                                 "bound_by": t["bound"][1], "max_abs_err": t["max_abs_err"],
                                 "rel_mean_err": t["rel_mean_err"]}
        if key in ("K1", "K1b"):  # device time, and the box scene beside the random depth
            by = {"K1": {kind: k1_t[(kind, 1)] for kind in ("random", "box")},
                  "K1b": k1b_t}[key]
            kernels[-1]["device_ms"] = by["random"]["device" if key == "K1" else "kernel"]
            t = by["box"]
            kernels[-1]["box"] = {
                "ms": t["ms"], "device_ms": t["device" if key == "K1" else "kernel"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"]}
    print(json.dumps({"kernels": kernels}), flush=True)
    # the conv weight gradient (replaces no TPU kernel): launches by path,
    # and its rows at the two pyramids' and the U-Net's shapes
    print(json.dumps({"wgrad": {
        "source": "sv3d_tpu_torch/csrc/conv3d_wgrad.cu",
        "replaces": "none in the JAX package: XLA's conv weight gradient",
        "launches_by_path": {"fit": train_launches["wgrad"],
                             "fit_ifnet": fit_ifnet["launches"]["wgrad"],
                             "fit_p16": fit_p16["end to end"]["wgrad"],
                             "fit_ifnet_p16": fit_p16["IF-Net-only"]["wgrad"]},
        "shapes": {name: {k: r[k] for k in ("shape", "cout", "err", "plain_err", "ms",
                                             "bound", "plain_ms", "library_ms") if k in r}
                   for name, r in wgrad_rows.items()}}}), flush=True)
    # the conv input gradient (replaces no TPU kernel): the IF-Net step's route
    # and its rows at the U-Net's shapes
    print(json.dumps({"dgrad": {
        "source": "sv3d_tpu_torch/csrc/conv3d_dgrad.cu",
        "replaces": "none in the JAX package: XLA's conv input gradient",
        "launches_by_path": {"fit": train_launches["dgrad"],
                             "fit_ifnet": fit_ifnet["launches"]["dgrad"],
                             "fit_p16": fit_p16["end to end"]["dgrad"],
                             "fit_ifnet_p16": fit_p16["IF-Net-only"]["dgrad"],
                             "fit_dp2": w2_total.get("dgrad", 0),
                             "convonet_step_b32": convonet_step["launches"]["dgrad"]},
        "ifnet_step_b4": ifnet_route,
        "convonet_step_b32": {"route": convonet_step["route"],
                              "layouts": convonet_step["variants"]},
        "shapes": {name: {k: r[k] for k in ("shape", "cout", "err", "plain_err", "ms",
                                             "bound", "plain_ms", "library_ms", "cl_ms",
                                             "cl_library_ms") if k in r}
                   for name, r in dgrad_rows.items()}}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
