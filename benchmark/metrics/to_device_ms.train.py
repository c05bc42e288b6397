"""to_device_ms.train: the median host milliseconds of the port's span
train.to_device (training/loop.py::to_device: the batch's pageable copies
to the card, and any wait on the stream before them), over the traced
window.  Layer: host to device.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "train.to_device", "host_ms")
