"""decode_ms.vecset: the median stream milliseconds of the port's span
vecset.decode (models/vecset.py::VecSet.forward: the query points' Fourier
embedding, their one-head cross-attention to the latents and the output
layer) over the traced window: the time between the span's two CUDA events
on the stream, its kernels and any wait of the stream on the host.  Layer:
step: forward: transformer.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "vecset.decode", "device_ms")
