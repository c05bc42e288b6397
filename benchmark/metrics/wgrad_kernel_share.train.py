"""wgrad_kernel_share.train: the share in % of the traced window's f32
IF-Net pyramid conv weight gradients that the port's hand-written kernel
computed: 100 x ifnet.wgrad_kernel / ifnet.wgrad, the port's counters
(models/ifnet.py::_PyramidConv).  None where the port counts no weight
gradient.  Layer: step: backward (cuDNN's f32 wgrad), as BENCHMARK.json names
it.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    recs = tracer.window(ctx)
    taken = recs["counters"].get("ifnet.wgrad") if recs else None
    if not taken:
        return None
    return 100.0 * recs["counters"].get("ifnet.wgrad_kernel", 0) / taken
