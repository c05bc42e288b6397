"""idle_share.train: the share of the traced window in % in which no
operation ran on the device.  Layer: device.  Moves train_samples_per_s."""


def read(ctx):
    if not ctx.trace or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.window_s)
