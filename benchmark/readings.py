"""The readings that a cell's limits are set from, many seeds in one process
(set-up is paid once for the imports and the card, not once a seed):

    python3 benchmark/readings.py --workload sv3d128.train_b4 --seeds 1-12 --seconds 4
    python3 benchmark/readings.py --workload sv3d128.train_b4 --seeds 1-3 --seconds 4 \
        --control train

Each seed is one run of run.py's run_cell (a short window at the cell's own
load, then the comparison); one JSON line a seed gives the numbers compared
and the run's counts.  --control puts the reference, in a lower precision
or with a planted fault, in the program's place.  Not part of a timed run.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", choices=bench.CONTROLS, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_spec(args.workload)
    for seed in seeds(args.seeds):
        result, numbers, limits, diag = bench.run_cell(
            spec, seed, args.seconds, False, torch.device("cuda", 0), args.control,
            tmp_root=os.environ.get("TMPDIR"))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"], "numbers": numbers,
                          "diag": diag, "metrics": result["metrics"]}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    bench._fixed_caches()
    sys.exit(main())
