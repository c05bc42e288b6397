"""Profiling utilities (port of sv3d_tpu/utils/profiling.py; the reference
delegates to Lightning's --profiler flag, SURVEY.md §5): a step timer for
--profiler simple and torch.profiler traces for --profiler advanced."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path


class StepTimer:
    """Accumulates wall-clock per named section; 'simple' profiler output."""

    def __init__(self):
        self.totals: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def dump(self, path: str | Path):
        Path(path).write_text(json.dumps(self.summary(), indent=2))


@contextmanager
def trace(log_dir: str | Path, cuda: bool = False, write: bool = True):
    """torch.profiler trace context (the 'advanced' profiler): the host's
    activity, and the card's with cuda; on exit, with write, the trace goes
    to <log_dir>/trace.json (chrome://tracing or Perfetto load it).  Yields
    the profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if write:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
