"""dgrad_roofline.convonet: the U-Net input gradients' share of their
roofline in %: the least seconds a step's 14 3x3x3 input gradients take,
over the device seconds a step of the kernels whose names hold conv3d_dgrad
in the traced window (the port's kernel and its once-a-call weight
transpose).  An input gradient has the operations and the bytes of the
weight gradient of the same conv (dx has x's size; 2 Cout Cin 27 B V
operations), so the bound is benchmark/arch/convonet_grid.py::wgrad_bound_s,
from the configuration and the traffic.  None where no such kernel ran (a
program that leaves the input gradients to cuDNN).  Layer: step: backward.
Moves train_samples_per_s."""

from benchmark import arch


def read(ctx):
    steps = ctx.counts.get("steps")
    if not ctx.trace or not steps:
        return None
    kernel_s = sum(s for name, s in ctx.trace["kernels"].items() if "conv3d_dgrad" in name)
    bound = getattr(arch.load(ctx.cfg["arch"]), "wgrad_bound_s", None)
    if kernel_s <= 0 or bound is None:
        return None
    return 100.0 * bound(ctx.cfg, ctx.traffic) * steps / kernel_s
