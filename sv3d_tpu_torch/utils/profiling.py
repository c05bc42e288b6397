"""Step timer for --profiler simple (a copy of StepTimer from
sv3d_tpu/utils/profiling.py; the reference delegates to Lightning's
--profiler flag, SURVEY.md §5)."""

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

