"""batch_ms.train: the median host milliseconds of the port's span
data.batch (data/loader.py::DataLoader.__iter__: one batch's fetches from
data/datasets.py's decode cache, or the waits on prefetched ones, and
collate), measured inside the loader, over the traced window.  Layer:
data.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "data.batch", "host_ms")
