"""Time of the f32 dense-sweep kernel K2 f32 (sv3d_tpu_torch/csrc/sweep.cu)
of another checkout beside this one's, on the same levels and weights, in
one process on one card.

    python3 compare_sweep.py --base DIR

DIR is the root of another checkout of the repository (a `git archive` of
an earlier commit, unpacked).  Each checkout's sweep.cu is compiled alone by
nvcc (compare_voxelize.build_alone) and loaded with ctypes.  Two designs of
its f32 entry sv3d_lattice_sweep are known:

- "column": one thread a pair of fc0 columns x 32 points, reading the
  channel-major levels and fc0 transposed to (in, out) in its natural
  column order (the design before the FMA core);
- "fma": the register-tiled f32 FMA core of csrc/fma_f32.cuh with a
  gathering A operand, reading the levels staged channels-last and fc0 in
  the plan's chunk order (ops/cuda/sweep.py::SweepPlan, the float32 plan).

The input is the serving lattice at net_res 128 (139 x 104 x 112, 1,619,072
points) over the pyramid of a seeded occupancy grid, with seeded weights.
Each version's layouts are made before the timing.  Each version is timed
in the order base, this, this, base: the whole lattice in one launch (CUDA
events, median of 3 after a warm-up) and one row (row 69, median of 7).
The two versions' logits are held to each other at chip_smoke.K2_TOL.
Prints one line, then one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DIMS = (139, 104, 112)  # the serving dims (Config().dims)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # vols, meta, n_levels, tap_idx, tap_w, w0t, b0, w1t, b1, w2t, b2, w3, b3, out,
    # batch, rows, row_offset, r0, r1, r2, sum_c, h0, max_c, stream
    "column": [_P, _P, _I] + [_P] * 11 + [_I] * 9 + [_P],
    # vols, meta, chunks, k0_chunks, tap_idx, tap_w, w0k, b0, w1t, b1, w2t, b2, w3, b3,
    # out, batch, rows, row_offset, r0, r1, r2, h0, stream
    "fma": [_P, _P, _P, _I] + [_P] * 11 + [_I] * 7 + [_P],
}


def design_of(source: str) -> str:
    entry = re.search(r"int\s+sv3d_lattice_sweep\s*\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no sv3d_lattice_sweep entry in the source")
    return "column" if "n_levels" in entry.group(1) else "fma"


class Version:
    """One checkout's sweep.cu, built alone and called as its wrapper calls
    it, on layouts made once (prepare)."""

    def __init__(self, label: str, lib: Path, design: str):
        self.label, self.design = label, design
        self.lib = ctypes.CDLL(str(lib))
        self.fn = self.lib.sv3d_lattice_sweep
        self.fn.argtypes, self.fn.restype = _ARGTYPES[design], ctypes.c_int

    def prepare(self, levels, mlp, align_corners, displacement) -> dict:
        """What this version's entry reads: the "fma" design this tree's
        float32 SweepPlan; the "column" one channel-major copies of the
        levels and fc0, fc1, fc2 transposed to (in, out)."""
        from sv3d_tpu_torch.ops.cuda.sweep import SweepPlan, sweep_tables

        if self.design == "fma":
            plan = SweepPlan(levels, mlp, DIMS, align_corners, displacement, torch.float32)
            return {"plan": plan}
        dev = levels.flats[0].device
        chans = [f.shape[1] for f in levels.flats]
        meta, tap_idx, tap_w = sweep_tables(chans, list(levels.dims), DIMS, DIMS[0], 0,
                                            align_corners, displacement)
        vols = [f.contiguous().clone() for f in levels.flats]
        (w0, b0), (w1, b1), (w2, b2), (w3, b3) = mlp
        return {
            "vols": vols, "ptrs": torch.tensor([v.data_ptr() for v in vols]).to(dev),
            "meta": torch.from_numpy(meta).to(dev), "tap_idx": torch.from_numpy(tap_idx).to(dev),
            "tap_w": torch.from_numpy(tap_w).to(dev),
            "weights": [w.t().contiguous() for w in (w0, w1, w2)] + [w3.contiguous()],
            "biases": [b0, b1, b2, b3], "sum_c": sum(chans), "max_c": max(chans),
            "h0": w0.shape[0], "batch": vols[0].shape[0],
        }

    def call(self, lay: dict, rows: int, row_offset: int) -> torch.Tensor:
        stream = torch.cuda.current_stream().cuda_stream
        if self.design == "fma":
            plan = lay["plan"]
            out = torch.empty((plan.batch, rows, DIMS[1], DIMS[2]), device=plan.device)
            (w0k, w1t, w2t, w3), (b0, b1, b2, b3) = plan.weights, plan.biases
            rc = self.fn(plan.ptrs.data_ptr(), plan.meta.data_ptr(), plan.chunks.data_ptr(),
                         plan.chunks.shape[0], plan.tap_idx.data_ptr(), plan.tap_w.data_ptr(),
                         w0k.data_ptr(), b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                         w2t.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
                         out.data_ptr(), plan.batch, rows, row_offset, *DIMS, plan.h0, stream)
        else:
            out = torch.empty((lay["batch"], rows, DIMS[1], DIMS[2]), device=lay["ptrs"].device)
            (w0t, w1t, w2t, w3), (b0, b1, b2, b3) = lay["weights"], lay["biases"]
            rc = self.fn(lay["ptrs"].data_ptr(), lay["meta"].data_ptr(), len(lay["vols"]),
                         lay["tap_idx"].data_ptr(), lay["tap_w"].data_ptr(), w0t.data_ptr(),
                         b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                         b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                         lay["batch"], rows, row_offset, *DIMS, lay["sum_c"], lay["h0"],
                         lay["max_c"], stream)
        if rc:
            raise RuntimeError(f"{self.label}: sv3d_lattice_sweep returned cudaError {rc}")
        return out


def serving_levels(device) -> tuple:
    """The IF-Net at net_res 128 with seeded weights and the pyramid of a
    seeded occupancy grid at the serving dims."""
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet

    cfg = IFNetConfig.for_net_res(128)
    model = IFNet(cfg, device=device, generator=torch.Generator().manual_seed(128)).eval()
    grid = (np.random.default_rng(128).uniform(0, 1, (1, *DIMS, 1)) > 0.9).astype(np.float32)
    with torch.inference_mode():
        levels = model.encode(torch.tensor(grid, device=device))
    return cfg, model, levels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_sweep: CUDA is not available")
    import chip_smoke as smoke
    from compare_voxelize import build_alone

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_alone({"base": args.base, "this": ROOT}, "sweep.cu")
    versions = {label: Version(label, lib, design_of(text))
                for label, (lib, text) in libs.items()}
    for v in versions.values():
        print(f"{v.label}: design {v.design!r}", flush=True)
    order = ("base", "this", "this", "base")
    cfg, model, levels = serving_levels(torch.device("cuda"))
    report = {"card": smi, "designs": {k: v.design for k, v in versions.items()},
              "order": list(order), "lattice": list(DIMS)}
    with torch.inference_mode():
        lays = {label: v.prepare(levels, model.mlp, cfg.align_corners, cfg.displacement)
                for label, v in versions.items()}
        outs = {label: v.call(lays[label], DIMS[0], 0) for label, v in versions.items()}
        diff = float((outs["this"] - outs["base"]).abs().max())
        smoke.check(bool(torch.isfinite(outs["this"]).all()), "this K2 f32: non-finite logits")
        smoke.check(diff <= smoke.K2_TOL, f"K2 f32 of the two checkouts differ by {diff}")
        del outs
        t = {label: {"lattice": [], "row": []} for label in versions}
        for label in order:
            v, lay = versions[label], lays[label]
            t[label]["lattice"].append(smoke.cuda_ms(
                lambda v=v, lay=lay: v.call(lay, DIMS[0], 0), warmup=1, reps=3))
            t[label]["row"].append(smoke.cuda_ms(lambda v=v, lay=lay: v.call(lay, 1, 69)))
    report.update(ms=t, max_abs_diff=diff)
    print(f"K2 f32, ms in the order base, this, this, base: the whole {DIMS} lattice in one "
          f"launch base {t['base']['lattice']}, this {t['this']['lattice']}; one row (row 69) "
          f"base {t['base']['row']}, this {t['this']['row']}; logits differ by {diff:.2e}",
          flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
