"""fprop_kernel_share.convonet: the share in % of the traced window's f32
U-Net conv forwards of ConvONet that the port's hand-written kernel
computed: 100 x convonet.fprop_kernel / convonet.fprop, the port's counters
(models/wgrad.py::WgradConv3d).  None where the port counts none (a program
that leaves every forward to cuDNN uncounted).  Layer: step: forward: 3D
U-Net.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    recs = tracer.window(ctx)
    taken = recs["counters"].get("convonet.fprop") if recs else None
    if not taken:
        return None
    return 100.0 * recs["counters"].get("convonet.fprop_kernel", 0) / taken
