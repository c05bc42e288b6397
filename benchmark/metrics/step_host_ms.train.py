"""step_host_ms.train: the median host milliseconds of the port's span
train.step (training/trainer_scene_net.py::SceneNetTrainer.train_step: the
subsample draw, to_device, the step's forward, backward and Adam issued,
and whatever the host waits for inside), over the traced window.  Layer:
host.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "train.step", "host_ms")
