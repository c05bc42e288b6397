"""wgrad_roofline.convonet: the U-Net weight gradients' share of their
roofline in %: the least seconds a step's 14 3x3x3 weight gradients take,
the sum over the convs of max(bytes / 3.35 TB/s, 2 Cout Cin 27 B V / 67
TFLOP/s) (benchmark/arch/convonet_grid.py::wgrad_bound_s, from the
configuration and the traffic), over the device seconds a step of the
kernels whose names hold conv3d_wgrad in the traced window: the partial
products (conv3d_wgrad_kernel*) and their sum over the splits
(conv3d_wgrad_sum).  The copies of x and dy to channels-last before the
kernel are aten's and cannot be told from other copies by name, so they
are left out.  Layer: step: backward.  Moves train_samples_per_s."""

from benchmark import arch


def read(ctx):
    steps = ctx.counts.get("steps")
    if not ctx.trace or not steps:
        return None
    kernel_s = sum(s for name, s in ctx.trace["kernels"].items() if "conv3d_wgrad" in name)
    bound = getattr(arch.load(ctx.cfg["arch"]), "wgrad_bound_s", None)
    if kernel_s <= 0 or bound is None:
        return None
    return 100.0 * bound(ctx.cfg, ctx.traffic) * steps / kernel_s
