"""step_ms.train: the median milliseconds of
training/trainer_scene_net.py::SceneNetTrainer.train_step (to_device,
forward, backward, Adam), synchronised with the device at its end in the
traced run.  Layer: step.  Moves train_samples_per_s."""

import statistics


def read(ctx):
    times = ctx.spans.get("step")
    return statistics.median(times) * 1e3 if times else None
