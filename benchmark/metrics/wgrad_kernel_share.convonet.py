"""wgrad_kernel_share.convonet: the share in % of the traced window's f32
U-Net conv weight gradients of ConvONet that the port's hand-written kernel
computed: 100 x convonet.wgrad_kernel / convonet.wgrad, the port's counters
(models/wgrad.py::WgradConv3d).  None where the port counts none.  Layer:
step: backward.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    recs = tracer.window(ctx)
    taken = recs["counters"].get("convonet.wgrad") if recs else None
    if not taken:
        return None
    return 100.0 * recs["counters"].get("convonet.wgrad_kernel", 0) / taken
