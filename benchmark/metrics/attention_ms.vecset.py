"""attention_ms.vecset: the median over the traced window's steps of the
stream milliseconds that a step's forward spends in attention: the sum of
its vecset.attention spans (models/vecset.py::Attention.forward, one around
each F.scaled_dot_product_attention call, 26 a forward), each the time
between the span's two CUDA events on the stream.  A step whose spans do not
all have a stream time is left out; None where none has.  Layer: step:
forward: transformer.  Moves train_samples_per_s."""

import statistics

from benchmark import tracer


def read(ctx):
    recs = tracer.window(ctx)
    if recs is None:
        return None
    steps = {}
    for s in recs["spans"]:
        if s["name"] == "vecset.attention":
            steps.setdefault(s["step"], []).append(s["device_ms"])
    sums = [sum(v) for v in steps.values() if None not in v]
    return statistics.median(sums) if sums else None
