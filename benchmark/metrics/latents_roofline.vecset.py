"""latents_roofline.vecset: the latent blocks' forward share of its roofline
in %: the least seconds the 24 blocks' forward takes on the card, their
operations (benchmark/arch/vecset.py::latents_flops: the dense layers' and
the attention products', from the configuration and the traffic) at the f32
peak of 67 TFLOP/s, over latents_ms.vecset, the median stream time of the
span vecset.latents.  It counts the same work whatever computes it.  None
where the span has no stream time.  Layer: step: forward: transformer.
Moves train_samples_per_s."""

from benchmark import arch, tracer
from benchmark.frozen import bounds


def read(ctx):
    if not ctx.trace:
        return None
    ms = tracer.median_ms(ctx, "vecset.latents", "device_ms")
    flops = getattr(arch.load(ctx.cfg["arch"]), "latents_flops", None)
    if not ms or flops is None:
        return None
    return 100.0 * flops(ctx.cfg, ctx.traffic) / bounds.PEAK_F32_FLOPS / (ms * 1e-3)
