"""unet3d_ms.convonet: the median stream milliseconds of the port's span
convonet.unet3d (models/convonet.py::ConvONet.forward: the 3D U-Net's
forward over the 64^3 grid, its 14 3x3x3 convs, GroupNorms, pools and
upsamplings) over the traced window: the time between the span's two CUDA
events on the stream, its kernels and any wait of the stream on the host.
Layer: step: forward: 3D U-Net.  Moves train_samples_per_s."""

from benchmark import tracer


def read(ctx):
    return tracer.median_ms(ctx, "convonet.unet3d", "device_ms")
