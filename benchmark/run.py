"""Run one cell of the benchmark of sv3d_tpu_torch on this machine's card.

    python3 benchmark/run.py --workload sv3d128.train_b4 --seed 7 --seconds 30 --trace 0

One process, one cell, one run: set-up (seeded weights and inputs, the
cell's shapes warmed up), then a measured window of --seconds, then the
comparison with the plain reference that decides `correct`.  The last line
of standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1), device, breakdown (--trace 1), and last the numbers compared,
each beside its limit (also the last lines of standard error).

Everything a cell is made of is found by name: BENCHMARK.json beside this
folder names the cell's configuration (benchmark/configs/<config>.json,
whose "arch" picks the architecture's file benchmark/arch/<arch>.py), its
traffic (benchmark/traffic/<traffic>.json, whose "kind" picks a driver
of benchmark/drivers/), its limits (benchmark/limits/<cell>.json) and its
per-layer metrics (benchmark/metrics/<metric>.py, each a read(ctx) that
returns a number or None).

--control serve|train|half_batch|sigma_lr puts the reference in a lower
precision, or with a planted fault, in the program's place after the
window, and compares it instead (the readings that the limits were set
from); sigma_lr only for an architecture with a scaled leaf.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

_IMPORTED = time.time()
ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sv3d_tpu"})
#: what --control may put in the program's place (see the drivers' numbers())
CONTROLS = ("serve", "train", "half_batch", "sigma_lr")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def process_age() -> float:
    """Seconds since this process started (Linux's /proc; the import of this
    module where that is not readable)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _IMPORTED


def _fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port builds into build/sv3d_tpu_torch/
    there by itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


if __name__ == "__main__":
    _fixed_caches()
    sys.path.insert(0, str(ROOT))

import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from contextlib import contextmanager, nullcontext  # noqa: E402


def load_spec(cell: str, bench: dict | None = None) -> dict:
    """The cell's entries, files and metrics, by name from BENCHMARK.json (or
    from `bench`, a dict of its form)."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    work = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if work is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m["workloads"] if "workloads" in m] + \
        [m for m in bench["per_layer"] if "workloads" not in m and m["moves"] in names]
    return {
        "cell": work,
        "cfg": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((ROOT / "benchmark" / "traffic" / f"{work['traffic']}.json")
                              .read_text()),
        "limits": json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text()),
        "end_to_end": e2e,
        "per_layer": layer,
    }


class Spans:
    """Host-clock durations of the benchmark's spans around its calls into
    the port, by name; in a traced run each is also a profiler annotation."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.times: dict = {}

    @contextmanager
    def __call__(self, name: str):
        import torch

        mark = torch.profiler.record_function(name) if self.traced else nullcontext()
        with mark:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.times.setdefault(name, []).append(time.perf_counter() - t0)


class Run:
    """What a driver and the metric readers share for one run."""

    def __init__(self, spec, seed, trace, device, tmp):
        from benchmark import arch

        self.cfg, self.traffic = spec["cfg"], spec["traffic"]
        self.arch = arch.load(self.cfg["arch"])
        self.seed, self.trace, self.device, self.tmp = int(seed), bool(trace), device, tmp
        self.span = Spans(self.trace)
        self.clock = time.perf_counter
        self.extra: dict = {}
        self.cleanups: list = []
        #: when the window closes, on run.clock (set as it opens)
        self.window_end = float("inf")
        #: seconds of set-up that the reference took (calibration), not set-up's own
        self.reference_setup_s = 0.0


class Context:
    """What a per-layer metric reads: spans (name -> [s]), trace (the
    reduced profiler trace or None), window_s, counts, work (operations of
    a request or step, from set-up), run (cfg, traffic), memory."""

    def __init__(self, run, summary, window_s, counts, memory):
        self.spans = run.span.times
        self.trace = summary
        self.window_s = window_s
        self.counts = counts
        self.work = run.extra
        self.cfg, self.traffic = run.cfg, run.traffic
        self.memory = memory


def read_metric(name: str, ctx: Context):
    """benchmark/metrics/<name>.py's read(ctx): a number, or None when the
    run holds nothing for it to read."""
    import importlib.util

    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def driver_class(kind: str):
    """benchmark/drivers/<kind>.py's Driver: the generator of a traffic kind."""
    import importlib

    return importlib.import_module(f"benchmark.drivers.{kind}").Driver


def _launches() -> dict:
    from sv3d_tpu_torch.ops.cuda import launch_counts

    return launch_counts()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, control=None,
             tmp_root=None) -> tuple:
    """One run: (result dict without "checks", numbers compared, limits,
    diagnostics).  device: torch.device; a CPU device runs the port's plain
    versions (the tests' rehearsal, never a measurement)."""
    import torch

    from benchmark.frozen import trace as trace_mod

    cuda = device.type == "cuda"
    tmp = Path(tempfile.mkdtemp(prefix="sv3d_bench_", dir=tmp_root))
    run = Run(spec, seed, trace, device, tmp)
    driver = driver_class(run.traffic["kind"])(run)
    failed = attempted = 0
    diag = {}
    try:
        driver.setup()
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age() - run.reference_setup_s
        before = _launches()
        prof = nullcontext()
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
        with prof:
            t0 = run.clock()
            run.window_end = t0 + seconds
            while True:
                attempted += 1
                try:
                    driver.step(attempted - 1)
                except Exception:  # a failed request or step counts; the window goes on
                    failed += 1
                    traceback.print_exc(file=sys.stderr)
                if run.clock() - t0 >= seconds:
                    break
            driver.finish()
            window_s = run.clock() - t0
        diag["launches"] = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        memory = {"peak_bytes": max(setup_peak, window_peak) if cuda else 0,
                  "window_peak_bytes": window_peak}
        summary = None
        if trace:
            t_red = run.clock()
            summary = trace_mod.summarize(prof.profiler.kineto_results.events(), driver.spans)
            diag["trace_reduce_s"] = run.clock() - t_red
            diag["device_events"] = summary["n_device_events"]
        counts = driver.counts()
        diag.update(counts)
        ctx = Context(run, summary, window_s, counts, memory)
        if trace:
            metrics = {}
            for m in spec["per_layer"]:
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = driver.end_to_end(window_s)
            e2e["setup_s"] = (setup_s, "s")
            metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                       for m in spec["end_to_end"]}
        driver.free()  # the program's state; the captures stay for the comparison
        if cuda:
            torch.cuda.empty_cache()
        t_ref = run.clock()
        numbers = driver.numbers(control)
        diag["reference_s"] = run.clock() - t_ref
        diag["reference_setup_s"] = run.reference_setup_s
        if getattr(driver, "detail", None):
            diag["detail"] = driver.detail
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": memory["peak_bytes"]}
        if trace:
            dev.update(busy_s=summary["busy_s"], window_s=window_s)
        result = {"correct": None, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if trace:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        limits = spec["limits"]
        result["correct"] = failed == 0 and all(
            numbers.get(k, float("nan")) <= v["limit"] for k, v in limits.items())
        return result, numbers, limits, diag
    finally:
        for undo in run.cleanups:
            undo()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=CONTROLS, default=None)
    args = p.parse_args(argv)

    import torch

    spec = load_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded before the run: {found}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result, numbers, limits, diag = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                                             torch.device("cuda", 0), args.control,
                                             tmp_root=os.environ.get("TMPDIR"))
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded by the run: {found}", file=sys.stderr)
        return 3
    print("diagnostics " + json.dumps(diag, default=str), file=sys.stderr)
    line, checks = result_line(result, numbers, limits)
    print("\n".join(checks), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def result_line(result: dict, numbers: dict, limits: dict) -> tuple:
    """(the result's JSON line, with the numbers compared beside their limits
    under "checks", its last key; those numbers as lines for stderr)."""
    out = dict(result)
    out["checks"] = {k: {"value": numbers.get(k), "limit": v["limit"]}
                     for k, v in limits.items()}
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in out["checks"].items()]
    return json.dumps(out), lines


if __name__ == "__main__":
    sys.exit(main())
