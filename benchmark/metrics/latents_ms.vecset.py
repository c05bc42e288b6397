"""latents_ms.vecset: the median stream milliseconds of the port's span
vecset.latents (models/vecset.py::VecSet.forward: the forward of the 24
self-attention blocks over the 512 latents, each LayerNorm, attention,
LayerNorm, GEGLU feed-forward and residuals) over the traced window: the
time between the span's two CUDA events on the stream, its kernels and any
wait of the stream on the host.  Layer: step: forward: transformer.  Moves
train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "vecset.latents", "device_ms")
