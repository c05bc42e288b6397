"""Device time of the decoder kernels K3 (sv3d_tpu_torch/csrc/mlp.cu) of
another checkout beside this one's, on the same inputs, in one process on
one card.

    python3 compare_mlp.py --base DIR

DIR is the root of another checkout of the repository (a `git archive` of
an earlier commit, unpacked).  Each checkout's mlp.cu is compiled alone by
nvcc (compare_voxelize.build_alone) and loaded with ctypes.  Three designs
of its C entries are known:

- "round_hidden": sv3d_fused_point_mlp (f32 FMA) takes a round_hidden flag;
  the bf16 class is that kernel with the flag set on features and weights
  that the wrapper rounded to bf16 in the call;
- "mma": sv3d_fused_point_mlp has no flag (f32 only, one output column a
  thread), and the bf16 class is sv3d_fused_point_mlp_bf16 (mma.sync, the
  features rounded on load) on ops/cuda/mlp.py::mlp_operands' layout;
- "fma": the C entries and layouts of "mma", with K3 f32 on the
  register-tiled f32 FMA core of csrc/fma_f32.cuh (mlp.cu includes it).

The input is one lattice row at net_res 128, as chip_smoke.py's k3_checks
takes it (2583 x 11,648: slab_features of a seeded occupancy grid's pyramid
at the serving dims).  For each compute dtype, each version is timed in the
order base, this, this, base: its kernel's device time and the call's
(bench/timing.py::device_ms: torch.profiler over 50 warm calls), and 30 calls
back to back between two CUDA events.  The weights' layouts are made before
the timing; the "round_hidden" bf16 call rounds f in the call, as its
wrapper did.  The two versions' logits are held to each other (f32 at
chip_smoke.K3_TOL, bf16 at K3_BF16_TOL).  Prints one line a dtype, then one
JSON object with every reading.
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
    "round_hidden": {
        # f, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, n_feat, n, h0, h1, h2,
        # round_hidden, stream
        "sv3d_fused_point_mlp": [_P] * 10 + [_I] * 6 + [_P],
    },
    "mma": {
        # f, w0t, b0, w1t, b1, w2t, b2, w3, b3, out, n_feat, n, h0, h1, h2, stream
        "sv3d_fused_point_mlp": [_P] * 10 + [_I] * 5 + [_P],
        # f, w0f, b0, w1f, b1, w2f, b2, w3, b3, out, n_feat, n, h0, stream
        "sv3d_fused_point_mlp_bf16": [_P] * 10 + [_I] * 3 + [_P],
    },
}
_ARGTYPES["fma"] = _ARGTYPES["mma"]
# the part of a kernel's name that the profiler's events are summed by
KERNEL = {("round_hidden", "f32"): "fused_point_mlp_kernel",
          ("round_hidden", "bf16"): "fused_point_mlp_kernel",
          ("mma", "f32"): "fused_point_mlp_kernel",
          ("mma", "bf16"): "fused_point_mlp_bf16_kernel",
          ("fma", "f32"): "fused_point_mlp_kernel",
          ("fma", "bf16"): "fused_point_mlp_bf16_kernel"}


def design_of(source: str) -> str:
    entry = re.search(r"int\s+sv3d_fused_point_mlp\s*\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no sv3d_fused_point_mlp entry in the source")
    if "round_hidden" in entry.group(1):
        return "round_hidden"
    return "fma" if '#include "fma_f32.cuh"' in source else "mma"


class Version:
    """One checkout's mlp.cu, built alone and called as its wrapper calls
    it, on weights laid out once (prepare)."""

    def __init__(self, label: str, lib: Path, design: str):
        self.label, self.design = label, design
        self.lib = ctypes.CDLL(str(lib))
        self.fns = {}
        for name, types in _ARGTYPES[design].items():
            fn = getattr(self.lib, name)
            fn.argtypes, fn.restype = types, ctypes.c_int
            self.fns[name] = fn

    def prepare(self, weights) -> dict:
        """{dtype: (weights, biases)} in the layouts this version reads."""
        from sv3d_tpu_torch.ops.cuda.mlp import mlp_operands
        from sv3d_tpu_torch.ops.mlp import rounded

        w0, b0, w1, b1, w2, b2, w3, b3 = weights
        f32 = [w.t().contiguous() for w in (w0, w1, w2)] + [w3.contiguous()]
        out = {"f32": (f32, [b0, b1, b2, b3])}
        if self.design == "round_hidden":
            out["bf16"] = ([rounded(w) for w in f32], [b0, b1, b2, b3])
        else:
            ops = mlp_operands(weights, torch.bfloat16)
            out["bf16"] = (list(ops.weights), list(ops.biases))
        return out

    def call(self, f: torch.Tensor, dtype: str, layout) -> torch.Tensor:
        from sv3d_tpu_torch.ops.mlp import rounded

        (w0, w1, w2, w3), (b0, b1, b2, b3) = layout
        n_feat, n = f.shape
        out = torch.empty((n,), dtype=torch.float32, device=f.device)
        stream = torch.cuda.current_stream().cuda_stream
        bf16 = dtype == "bf16"
        if bf16 and self.design != "round_hidden":
            name = "sv3d_fused_point_mlp_bf16"
            rc = self.fns[name](f.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                                b3.data_ptr(), out.data_ptr(), n_feat, n, b0.shape[0], stream)
        else:
            name = "sv3d_fused_point_mlp"
            src = rounded(f) if bf16 else f
            args = [src.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), out.data_ptr(),
                    n_feat, n, b0.shape[0], b1.shape[0], b2.shape[0]]
            if self.design == "round_hidden":
                args.append(int(bf16))
            rc = self.fns[name](*args, stream)
        if rc:
            raise RuntimeError(f"{self.label}: {name} returned cudaError {rc}")
        return out


def row_features(device) -> tuple:
    """The decoder's weights at net_res 128 and one lattice row's (F, N)
    features: slab_features of a seeded occupancy grid's pyramid, row 69."""
    from sv3d_tpu_torch.config import IFNetConfig
    from sv3d_tpu_torch.models.ifnet import IFNet
    from sv3d_tpu_torch.ops.lattice import slab_features

    cfg = IFNetConfig.for_net_res(128)
    model = IFNet(cfg, device=device, generator=torch.Generator().manual_seed(128)).eval()
    weights = [t.detach() for layer in model.mlp for t in layer]
    grid = (np.random.default_rng(128).uniform(0, 1, (1, *DIMS, 1)) > 0.9).astype(np.float32)
    with torch.inference_mode():
        levels = model.encode(torch.tensor(grid, device=device))
        f = slab_features(levels, DIMS, 1, 69, cfg.align_corners, cfg.displacement)[0]
    return f.contiguous(), weights


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", required=True, help="root of the other checkout")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("compare_mlp: CUDA is not available")
    import chip_smoke as smoke
    from compare_voxelize import build_alone

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_alone({"base": args.base, "this": ROOT}, "mlp.cu")
    versions = {label: Version(label, lib, design_of(text))
                for label, (lib, text) in libs.items()}
    for v in versions.values():
        print(f"{v.label}: design {v.design!r}", flush=True)
    order = ("base", "this", "this", "base")
    f, weights = row_features(torch.device("cuda"))
    layouts = {label: v.prepare(weights) for label, v in versions.items()}
    report = {"card": smi, "designs": {k: v.design for k, v in versions.items()},
              "order": list(order), "shape": list(f.shape)}
    tols = {"f32": smoke.K3_TOL, "bf16": smoke.K3_BF16_TOL}
    with torch.inference_mode():
        for dtype in ("f32", "bf16"):
            outs = {label: v.call(f, dtype, layouts[label][dtype])
                    for label, v in versions.items()}
            diff = float((outs["this"] - outs["base"]).abs().max())
            smoke.check(diff <= tols[dtype],
                        f"K3 {dtype} of the two checkouts differ by {diff}")
            t = {label: {"kernel": [], "call": [], "back_to_back": []} for label in versions}
            for label in order:
                v = versions[label]
                fn = lambda v=v, label=label: v.call(f, dtype, layouts[label][dtype])
                part = KERNEL[(v.design, dtype)]
                dev = smoke.device_ms(fn, (part,))
                t[label]["kernel"].append(dev[part])
                t[label]["call"].append(dev["all"])
                t[label]["back_to_back"].append(
                    smoke.cuda_ms(lambda fn=fn: [fn() for _ in range(30)], reps=5) / 30)
            report[dtype] = {**t, "max_abs_diff": diff}
            print(f"K3 {dtype} on one row {tuple(f.shape)}, ms (base, this, this, base order): "
                  f"kernel device time (torch.profiler, 50 calls) base {t['base']['kernel']}, "
                  f"this {t['this']['kernel']}; the call's device time base "
                  f"{t['base']['call']}, this {t['this']['call']}; 30 calls back to back "
                  f"(CUDA events) base {t['base']['back_to_back']}, this "
                  f"{t['this']['back_to_back']}; outputs differ by {diff:.2e}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
