"""forward_ms.train: the median stream milliseconds of the port's span
train.forward (training/trainer_scene_net.py::train_step, around
scene_forward: UNetMini, K1, the IF-Net encoder, the gather query, the
losses) over the traced window: the time between the span's two CUDA
events on the stream, which is the forward's kernels and any time the
stream waits for the host to issue them, not the kernels' busy time
alone.  Layer: step: forward.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "train.forward", "device_ms")
