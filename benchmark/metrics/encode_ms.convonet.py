"""encode_ms.convonet: the median stream milliseconds of the port's span
convonet.encode (models/convonet.py::ConvONet.forward: the local-pool
PointNet over the back-projected cloud, its four pools and the grid's
scatter-mean) over the traced window: the time between the span's two CUDA
events on the stream, its kernels and any wait of the stream on the host.
Layer: step: forward: encoder.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "convonet.encode", "device_ms")
