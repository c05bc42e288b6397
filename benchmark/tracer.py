"""What the per-layer readers take from the port's tracer
(sv3d_tpu_torch/utils/profiling.py): its newest session of spans and
counters, which in a traced run is the measured window (set-up runs with
tracing off, so the window's first span opens a session).  An untraced run,
or a port without the tracer, reads None."""

from __future__ import annotations

import statistics


def window(ctx):
    """The tracer's records of the traced window, or None."""
    if not ctx.trace:
        return None
    from sv3d_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    return records() if records is not None else None


def median_ms(ctx, name: str, key: str):
    """The median of key ("host_ms" or "device_ms") over the window's spans
    called name, or None where none has it."""
    recs = window(ctx)
    if recs is None:
        return None
    values = [s[key] for s in recs["spans"] if s["name"] == name and s[key] is not None]
    return statistics.median(values) if values else None
