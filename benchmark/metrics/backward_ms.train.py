"""backward_ms.train: the median stream milliseconds of the port's span
train.backward (training/trainer_scene_net.py::train_step, around the
loss's backward(): cuDNN's f32 conv weight gradient, K1b) over the traced
window: the time between the span's two CUDA events on the stream, which
is the backward's kernels and any time the stream waits for the host to
issue them, not the kernels' busy time alone.  Layer: step: backward
(cuDNN's f32 wgrad).  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "train.backward", "device_ms")
