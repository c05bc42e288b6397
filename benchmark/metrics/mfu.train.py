"""mfu.train: the steps' share of the card's f32 peak in %: the operations of
one step (FlopCounterMode over a warm-up step, plus K1's 32 and K1b's 48 a
projected point, which it cannot see) times the steps over the window, at
67 TFLOP/s.  Layer: the whole step.  Moves train_samples_per_s."""

from benchmark.frozen import bounds


def read(ctx):
    steps = ctx.counts.get("steps")
    if "step_flops" not in ctx.work or not steps:
        return None
    return 100.0 * ctx.work["step_flops"] * steps / ctx.window_s / bounds.PEAK_F32_FLOPS
