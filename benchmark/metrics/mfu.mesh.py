"""mfu.mesh: a whole request's share of the card's peak in %: its least
time at the published peaks (the f32 conv operations that FlopCounterMode
counts in predict and encode, and K1's, at 67 TFLOP/s; K2's decoder
products at 989 TFLOP/s on the tensor cores and its interpolation at
67 TFLOP/s) over the measured time of a request (the window over the
requests).  Layer: the whole request.  Moves mesh_s."""

from benchmark.frozen import bounds


def read(ctx):
    w = ctx.work
    n = ctx.counts.get("requests")
    if "conv_flops" not in w or not n:
        return None
    k2 = w["k2_work"]
    least = ((w["conv_flops"] + w["k1_flops"] + k2["flops"]) / bounds.PEAK_F32_FLOPS
             + k2["tensor_flops"] / bounds.PEAK_BF16_TENSOR_FLOPS)
    return 100.0 * least / (ctx.window_s / n)
