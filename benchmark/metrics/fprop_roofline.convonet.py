"""fprop_roofline.convonet: the U-Net forwards' share of their roofline in
%: the least seconds a step's 14 3x3x3 forwards take, over the device
seconds a step of the kernels whose names hold conv3d_fprop in the traced
window (the port's kernel and its once-a-call weight transpose).  A forward
has the operations and the bytes of the weight gradient of the same conv
(y has dy's size; 2 Cout Cin 27 B V operations), so the bound is
benchmark/arch/convonet_grid.py::wgrad_bound_s, from the configuration and
the traffic.  None where no such kernel ran (a program that leaves the
forwards to cuDNN).  Layer: step: forward: 3D U-Net.  Moves
train_samples_per_s."""

from benchmark import arch


def read(ctx):
    steps = ctx.counts.get("steps")
    if not ctx.trace or not steps:
        return None
    kernel_s = sum(s for name, s in ctx.trace["kernels"].items() if "conv3d_fprop" in name)
    bound = getattr(arch.load(ctx.cfg["arch"]), "wgrad_bound_s", None)
    if kernel_s <= 0 or bound is None:
        return None
    return 100.0 * bound(ctx.cfg, ctx.traffic) * steps / kernel_s
