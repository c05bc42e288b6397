"""encode_ms.vecset: the median stream milliseconds of the port's span
vecset.encode (models/vecset.py::VecSet.forward: the Fourier embedding of
the cloud's 2048-pixel lattice and its 512 seeds, the one-head
cross-attention into the latents and its feed-forward) over the traced
window: the time between the span's two CUDA events on the stream, its
kernels and any wait of the stream on the host.  Layer: step: forward:
transformer.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "vecset.encode", "device_ms")
