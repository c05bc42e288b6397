"""Metric logging: JSONL (+ TensorBoard through tensorboardX when it is
installed).  A copy of sv3d_tpu/training/logging.py's MetricLogger.

A copy, not an import, because importing sv3d_tpu.training.logging runs
sv3d_tpu/training/__init__.py, which imports flax and optax, and the port
never imports jax or flax.  The class itself is unchanged; a multi-GPU
run's ranks other than 0 make theirs with enabled=False.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricLogger:
    def __init__(
        self, log_dir: str | Path, use_tensorboard: bool = True, enabled: bool = True
    ):
        """enabled=False turns the logger into a no-op (the ranks other than
        0 of a multi-GPU run; the PL rank-zero-only convention)."""
        self.enabled = enabled
        self.log_dir = Path(log_dir)
        self._jsonl = None
        self._tb = None
        if not enabled:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir))
            except Exception:
                self._tb = None

    def log(self, metrics: dict, step: int):
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
