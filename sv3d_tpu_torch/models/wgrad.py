"""The f32 3x3x3 convolutions of training, whose forward and both
gradients take the port's hand-written kernels: the weight gradient always
(ops/cuda/conv3d_wgrad.py), the input gradient where the output's gradient
arrives channel-major, NCDHW (ops/cuda/conv3d_dgrad.py; a channels-last one
keeps cuDNN's), the forward where the input arrives NCDHW with 32 output
channels or more (ops/cuda/conv3d_fprop.py; otherwise cuDNN's).  The IF-Net
pyramid's convs (models/ifnet.py) take the weight gradient's kernel alone,
ConvONet's U-Net's (models/convonet.py) all three."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sv3d_tpu_torch.ops.cuda.conv3d_dgrad import conv3d_dgrad
from sv3d_tpu_torch.ops.cuda.conv3d_fprop import conv3d_fprop
from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import conv3d_wgrad
from sv3d_tpu_torch.utils.profiling import count


def takes_fprop(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether WgradConv3d's forward goes through conv3d_fprop: x
    channel-major (NCDHW) with 32 output channels or more, so that no tile
    of the kernel is more than half empty, and on the card in float32 (the
    kernel's one dtype; a float64 CUDA x keeps aten's).  On the CPU the op
    runs F.conv3d itself."""
    return (x.is_contiguous() and weight.shape[0] >= 32
            and (not x.is_cuda or x.dtype == torch.float32))


def _aten_backward(dy, x, weight, mask):
    return torch.ops.aten.convolution_backward(
        dy, x, weight, [weight.shape[0]], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1, mask)


class WgradConv3d(torch.autograd.Function):
    """F.conv3d(x, weight, bias, padding=1), bias None or a tensor, whose
    output is conv3d_fprop's or aten's, by takes_fprop (x's layout and
    dtype, the output's width); weight gradient conv3d_wgrad's; input
    gradient conv3d_dgrad's where dy is contiguous (NCDHW), and aten's
    (cuDNN on the card) where it arrives in another layout (channels-last,
    as cuDNN hands the IF-Net pyramid's).  The ops run their plain versions
    on the CPU and their kernels on the card; the bias's gradient stays
    aten's.  The tracer counts <prefix>.fprop for each forward computed and
    <prefix>.fprop_kernel for each one the kernel computes, <prefix>.wgrad
    for each weight gradient taken and <prefix>.wgrad_kernel for each one
    the kernel computes, <prefix>.dgrad for each input gradient taken and
    <prefix>.dgrad_kernel for each one its kernel computes; prefix is the
    model's ("ifnet", "convonet")."""

    @staticmethod
    def forward(ctx, x, weight, bias, prefix):
        ctx.save_for_backward(x, weight)
        ctx.prefix = prefix
        count(f"{prefix}.fprop")
        if takes_fprop(x, weight):
            if x.is_cuda:
                count(f"{prefix}.fprop_kernel")
            return conv3d_fprop(x, weight, bias)
        return F.conv3d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x and dy.is_contiguous():
            dx = conv3d_dgrad(dy, weight, list(x.shape))
            if dy.is_cuda:
                count(f"{ctx.prefix}.dgrad_kernel")
            if need_b:
                db = _aten_backward(dy, x, weight, [False, False, True])[2]
        elif need_x or need_b:
            dx, _, db = _aten_backward(dy, x, weight, [need_x, False, need_b])
        if need_x:
            count(f"{ctx.prefix}.dgrad")
        if need_w:
            dw = conv3d_wgrad(x, dy)
            count(f"{ctx.prefix}.wgrad")
            if dy.is_cuda:
                count(f"{ctx.prefix}.wgrad_kernel")
        return dx, dw, db, None
