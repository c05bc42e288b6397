"""toy_steps.train: the window's steps, as the driver counts them; None where
the run counts none."""


def read(ctx):
    return ctx.counts.get("steps")
