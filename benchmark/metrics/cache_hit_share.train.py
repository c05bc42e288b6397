"""cache_hit_share.train: the share in % of the traced window's fetches
from data/datasets.py's decode cache that found their item decoded:
100 x (data.fetches - data.cache_misses) / data.fetches, the port's
counters.  Layer: data.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    recs = tracer.window(ctx)
    fetches = recs["counters"].get("data.fetches") if recs else None
    if not fetches:
        return None
    return 100.0 * (fetches - recs["counters"].get("data.cache_misses", 0)) / fetches
