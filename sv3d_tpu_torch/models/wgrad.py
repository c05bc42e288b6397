"""The f32 3x3x3 convolutions of training whose weight gradient is the
port's hand-written kernel's (ops/cuda/conv3d_wgrad.py): the IF-Net
pyramid's (models/ifnet.py) and ConvONet's U-Net's (models/convonet.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import conv3d_wgrad
from sv3d_tpu_torch.utils.profiling import count


class WgradConv3d(torch.autograd.Function):
    """F.conv3d(x, weight, bias, padding=1), bias None or a tensor, whose
    weight gradient is conv3d_wgrad's (the plain version on the CPU, the
    kernel on the card); the input's and the bias's gradients stay aten's
    (cuDNN on the card).  The tracer counts <prefix>.wgrad for each weight
    gradient taken and <prefix>.wgrad_kernel for each one the kernel
    computes; prefix is the model's ("ifnet", "convonet")."""

    @staticmethod
    def forward(ctx, x, weight, bias, prefix):
        ctx.save_for_backward(x, weight)
        ctx.prefix = prefix
        return F.conv3d(x, weight, bias, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x or need_b:
            dx, _, db = torch.ops.aten.convolution_backward(
                dy, x, weight, [weight.shape[0]], [1] * 3, [1] * 3, [1] * 3, False, [0] * 3, 1,
                [need_x, False, need_b])
        if need_w:
            dw = conv3d_wgrad(x, dy)
            count(f"{ctx.prefix}.wgrad")
            if dy.is_cuda:
                count(f"{ctx.prefix}.wgrad_kernel")
        return dx, dw, db, None
