"""optimizer_ms.train: the median stream milliseconds of the port's span
train.optimizer (training/trainer_scene_net.py::train_step, around the
gradient mean under a mesh and Adam's step) over the traced window: the
time between the span's two CUDA events on the stream, which is Adam's
kernels and any time the stream waits for the host to issue them, not
the kernels' busy time alone.  Layer: step: Adam.  Moves
train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "train.optimizer", "device_ms")
