"""Device time of the voxelization kernels K1 (scatter) and K1b (its
backward) of another checkout beside this one's, on the same inputs, in one
process on one card.

    python3 compare_voxelize.py --base DIR

DIR is the root of another checkout of the repository (a `git archive` of
an earlier commit, unpacked).  Each checkout's sv3d_tpu_torch/csrc/
voxelize.cu is compiled alone by nvcc (it has a plain C interface) into
build/sv3d_tpu_torch/compare/ and loaded with ctypes.  Two designs of its C
entries are known:

- "zeroed": sv3d_scatter_voxels scatters into a grid that the caller zeroed
  (the wrapper: torch.zeros, the scatter, then clamp(0, 1) into a second
  grid); sv3d_scatter_voxels_bwd reads the raw grid and a contiguous
  cotangent (the wrapper copied a strided one);
- "one call": sv3d_scatter_voxels zeroes, scatters and clamps in place
  (clamp=1) into one torch.empty grid; sv3d_scatter_voxels_bwd reads the
  clamped grid and the cotangent in its strides.

For each of chip_smoke.py's K1 inputs (a uniform random depth per pixel and
the rendered box scene, B=1 and B=4, 76,800 + 4,096 points an image), each
version's call is profiled (bench/timing.py::device_ms: torch.profiler over 50
warm calls) in the order base, this, this, base: the kernel alone and the
whole call's device time.  K1b runs on the cotangent as the train step's
blur backward strides it.  The two versions' outputs are held to each other
(K1 after the clamp at 1e-5, K1b at 1e-5 of the largest component).  Prints
one line an input and kernel, then one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "sv3d_tpu_torch" / "compare"
K1_TOL = 1e-5
K1B_RTOL = 1e-5

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "zeroed": {
        # points, grid, batch, n, d0, d1, d2, lo, hi, stream
        "sv3d_scatter_voxels": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
        # points, raw, grad, out, batch, n, d0, d1, d2, lo, hi, stream
        "sv3d_scatter_voxels_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    },
    "one call": {
        # points, grid, batch, n, d0, d1, d2, lo, hi, clamp, stream
        "sv3d_scatter_voxels": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P],
        # points, grid, grad, out, batch, n, d0, d1, d2, grad's 4 strides,
        # lo, hi, stream
        "sv3d_scatter_voxels_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _F,
                                    _F, _P],
    },
}


class Version:
    """One checkout's voxelize.cu, built alone and called as its wrapper
    calls it."""

    def __init__(self, label: str, lib: Path, design: str):
        self.label, self.design = label, design
        self.lib = ctypes.CDLL(str(lib))
        self.fns = {}
        for name, types in _ARGTYPES[design].items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = types, ctypes.c_int
            self.fns[name] = fn

    def scatter(self, p: torch.Tensor, dims, clamp: bool = True) -> torch.Tensor:
        b, n, _ = p.shape
        stream = torch.cuda.current_stream().cuda_stream
        lo, hi = -0.5 + 1e-6, 0.5 - 1e-6
        if self.design == "zeroed":
            grid = torch.zeros((b, *dims), device=p.device)
            rc = self.fns["sv3d_scatter_voxels"](p.data_ptr(), grid.data_ptr(), b, n, *dims,
                                                 lo, hi, stream)
            out = grid.clamp(0.0, 1.0) if clamp else grid
        else:
            out = torch.empty((b, *dims), device=p.device)
            rc = self.fns["sv3d_scatter_voxels"](p.data_ptr(), out.data_ptr(), b, n, *dims,
                                                 lo, hi, int(clamp), stream)
        if rc:
            raise RuntimeError(f"{self.label}: sv3d_scatter_voxels returned cudaError {rc}")
        return out

    def backward(self, p: torch.Tensor, grid: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """K1b on grid (raw for "zeroed", clamped for "one call") and the
        cotangent g, which the "zeroed" design needs contiguous."""
        b, n, _ = p.shape
        dims = tuple(grid.shape[1:])
        out = torch.empty((b, n, 3), device=p.device)
        stream = torch.cuda.current_stream().cuda_stream
        lo, hi = -0.5 + 1e-6, 0.5 - 1e-6
        args = (p.data_ptr(), grid.data_ptr(), g.data_ptr(), out.data_ptr(), b, n, *dims)
        if self.design == "zeroed":
            if not g.is_contiguous():
                raise ValueError(f"{self.label}: K1b reads a contiguous cotangent")
            rc = self.fns["sv3d_scatter_voxels_bwd"](*args, lo, hi, stream)
        else:
            rc = self.fns["sv3d_scatter_voxels_bwd"](*args, *g.stride(), lo, hi, stream)
        if rc:
            raise RuntimeError(f"{self.label}: sv3d_scatter_voxels_bwd returned cudaError {rc}")
        return out


def call_parts(fn, steps: int = 50) -> dict:
    """Device ms a call of fn by kernel (torch.profiler over `steps` warm
    calls), keyed by the kernel's whole name."""
    from sv3d_tpu_torch.bench.timing import dev_us, profile_calls

    _, _, _, events = profile_calls(fn, steps)
    return {e.key: dev_us(e) / 1e3 / steps for e in events}


def short(name: str) -> str:
    """A kernel's name cut to what tells the kernels of a call apart: torch's
    elementwise kernels by their functor."""
    for tag in ("clamp_unit_kernel", "scatter_voxels_kernel", "FillFunctor", "Memset", "clamp"):
        if tag in name:
            return tag
    return name[:60]


def design_of(source: str) -> str:
    entry = re.search(r"int\s+sv3d_scatter_voxels\s*\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no sv3d_scatter_voxels entry in the source")
    return "one call" if re.search(r"\bclamp\b", entry.group(1)) else "zeroed"


def build_alone(checkouts: dict, source: str) -> dict:
    """{label: checkout root} -> {label: (library, source text)}: each
    checkout's sv3d_tpu_torch/csrc/<source> compiled alone by nvcc (its
    headers beside it) into OUT_DIR, one nvcc each, all at once."""
    from sv3d_tpu_torch.ops.cuda import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, todo, libs = build._nvcc(), [], {}
    for label, root in checkouts.items():
        src = Path(root) / "sv3d_tpu_torch" / "csrc" / source
        text = src.read_text()
        headers = "".join(h.read_text() for h in sorted(src.parent.glob("*.cuh")))
        digest = hashlib.sha256((" ".join(build.NVCC_FLAGS) + text + headers).encode()
                                ).hexdigest()[:16]
        lib = OUT_DIR / f"lib{src.stem}_{digest}.so"
        if not lib.exists():
            todo.append([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)])
        libs[label] = (lib, text)
    build._run_all(todo)
    return libs


def build_versions(checkouts: dict) -> dict:
    """{label: checkout root} -> {label: Version}."""
    return {label: Version(label, lib, design_of(text))
            for label, (lib, text) in build_alone(checkouts, "voxelize.cu").items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_voxelize: CUDA is not available")
    import chip_smoke as smoke
    from sv3d_tpu_torch.config import Config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    versions = build_versions({"base": args.base, "this": ROOT})
    for v in versions.values():
        print(f"{v.label}: design {v.design!r}", flush=True)
    order = ("base", "this", "this", "base")

    config = Config(seed=0)
    dims = config.dims
    dev = torch.device("cuda")
    model = smoke.seeded_scene_net(config, dev, seed=0)
    rng = np.random.default_rng(0)
    inputs = {(kind, b): smoke.k1_points(model, kind, b, rng)
              for kind in ("random", "box") for b in (1, 4)}
    del model

    report = {"card": smi, "designs": {k: v.design for k, v in versions.items()},
              "order": list(order), "K1": {}, "K1b": {}}
    with torch.no_grad():
        for (kind, b), p in inputs.items():
            key = f"{kind} B={b}"
            grids = {label: v.scatter(p, dims) for label, v in versions.items()}
            err = float((grids["this"] - grids["base"]).abs().max())
            smoke.check(err <= K1_TOL, f"K1 of the two checkouts differ by {err} on {key}")
            k1 = {label: {"kernel": [], "call": []} for label in versions}
            for label in order:
                v = versions[label]
                t = smoke.device_ms(lambda v=v: v.scatter(p, dims), ("scatter_voxels_kernel",))
                k1[label]["kernel"].append(t["scatter_voxels_kernel"])
                k1[label]["call"].append(t["all"])
            parts = {label: call_parts(lambda v=v: v.scatter(p, dims))
                     for label, v in versions.items()}
            bnd = smoke.bound(smoke.nbytes(p, grids["this"]), 32.0 * b * p.shape[1])
            report["K1"][key] = {**k1, "parts": parts, "bound_ms": bnd[0], "bound_by": bnd[1],
                                 "max_abs_diff": err}
            print(f"K1 {key} x {p.shape[1]} points, device ms (base, this, this, base order; "
                  f"torch.profiler, 50 calls each): kernel base {k1['base']['kernel']}, this "
                  f"{k1['this']['kernel']}; the call's device time base {k1['base']['call']}, "
                  f"this {k1['this']['call']}; bound {bnd[0]:.4f} ms ({bnd[1]}); outputs "
                  f"differ by {err:.2e}", flush=True)
            for label, kernels in parts.items():
                print(f"  {label}'s call by kernel (device ms): "
                      + "; ".join(f"{short(k)} {ms:.4f}" for k, ms in kernels.items()),
                      flush=True)

            # the cotangent as the blur's einsum backward strides it
            g = torch.randn((dims[0], b, *dims[1:]), device=dev).transpose(0, 1)
            gc = g.contiguous()
            grid_in = {"base": versions["base"].scatter(p, dims, clamp=False)
                       if versions["base"].design == "zeroed" else grids["base"],
                       "this": versions["this"].scatter(p, dims, clamp=False)
                       if versions["this"].design == "zeroed" else grids["this"]}
            cot = {label: gc if versions[label].design == "zeroed" else g for label in versions}
            outs = {label: v.backward(p, grid_in[label], cot[label])
                    for label, v in versions.items()}
            rel = smoke.rel_err(outs["this"], outs["base"])[1]
            smoke.check(rel <= K1B_RTOL, f"K1b of the two checkouts differ by {rel} on {key}")
            k1b = {label: [] for label in versions}
            for label in order:
                v = versions[label]
                t = smoke.device_ms(lambda v=v, label=label: v.backward(p, grid_in[label],
                                                                       cot[label]),
                                    ("scatter_voxels_bwd",))
                k1b[label].append(t["scatter_voxels_bwd"])
            # a (1, ...) view with a swapped size-1 axis is contiguous already
            copy = 0.0 if g.is_contiguous() else smoke.device_ms(lambda: g.contiguous(),
                                                                 ("copy",))["copy"]
            bnd = smoke.bound(smoke.k1b_bytes(p, grids["this"], g), 48.0 * b * p.shape[1])
            report["K1b"][key] = {**k1b, "cotangent_copy": copy, "bound_ms": bnd[0],
                                  "bound_by": bnd[1], "rel_diff": rel}
            print(f"K1b {key} x {p.shape[1]} points, kernel device ms (base, this, this, base "
                  f"order): base {k1b['base']}, this {k1b['this']}; the cotangent's copy that a "
                  f"\"zeroed\" wrapper makes {copy:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); "
                  f"outputs differ by {rel:.2e} of the largest", flush=True)
            del grids, grid_in, outs, g, gc, cot
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
