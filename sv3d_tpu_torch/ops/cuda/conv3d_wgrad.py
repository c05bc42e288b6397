"""Wrapper of the CUDA conv weight-gradient kernel (sv3d_tpu_torch/csrc/conv3d_wgrad.cu).

  conv3d_wgrad  the weight gradient (Cout, Cin, 3, 3, 3) of a 3x3x3,
                stride-1, pad-1 Conv3d from its input x (B, Cin, D, H, W)
                and its output's gradient dy (B, Cout, D, H, W)

It replaces no TPU kernel (the JAX package leaves its convolutions to XLA):
the IF-Net pyramid's f32 training step takes its convs' weight gradients
here instead of from cuDNN (models/ifnet.py::_PyramidConv).  A CPU tensor
of any float dtype runs the plain version, conv3d_wgrad_plain (aten's
convolution_backward for the weight alone); a CUDA float32 tensor launches
the kernel (conv3d_wgrad_cuda), and any other CUDA dtype raises.
conv3d_wgrad is a torch.library custom op whose flop formula is aten's for
the weight gradient, 2 Cout Cin 27 B D H W, so FlopCounterMode counts a step
the same whichever code computes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from sv3d_tpu_torch.ops.cuda import build

#: the kernel's two instances (csrc/conv3d_wgrad.cu, Wide and Narrow), picked
#: by Cin: (output channels, input channels, row lanes) a block, the voxels
#: of a step (th rows of W padded to a multiple of 4), and the blocks a
#: multiprocessor holds at most (registers)
WIDE, NARROW = (32, 16, 1, 128, 2), (16, 1, 4, 512, 3)
NARROW_BELOW_CIN = 16
#: shared memory of a multiprocessor (the H100's 228 KB; 1 KB of it is
#: reserved a block), and the most a block may take
SMEM_PER_SM, SMEM_PER_BLOCK = 228 * 1024, 227 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, dy, part, out, B, Cin, Cout, D, H, W, th, nsplit, parts, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _bind():
    fn = build.load().sv3d_conv3d_wgrad
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient (Cout, Cin, 3, 3, 3) of F.conv3d(x, w,
    padding=1) for the output gradient dy: aten's convolution_backward with
    only the weight's gradient asked for."""
    weight = (dy.shape[1], x.shape[1], 3, 3, 3)
    return torch.nn.grad.conv3d_weight(x, weight, dy, stride=1, padding=1)


def smem_bytes(cin: int, th: int, w: int) -> int:
    """The kernel's shared memory a block: two dy slices of th rows for the
    block's output channels and a ring of four x slices of th + 2 rows (the
    halo) for its input channels, channels-last, W padded to a multiple of
    4 (csrc/conv3d_wgrad.cu's dy_row and x_row)."""
    co_t, ci_t, rs = (NARROW if cin < NARROW_BELOW_CIN else WIDE)[:3]
    wp = -(-w // 4) * 4
    dy_row = wp * co_t + (16 if rs > 1 else 0)
    x_row = wp + 8 if ci_t == 1 else (wp + 2) * ci_t
    return 4 * (2 * th * dy_row + 4 * (th + 2) * x_row)


@functools.lru_cache(maxsize=256)
def plan(shape: tuple, cout: int, sms: int) -> tuple:
    """(rows a column th, splits nsplit, partials) of the kernel for an
    input of shape (B, Cin, D, H, W) and cout output channels on a card of
    sms streaming multiprocessors.  A step is th rows of one depth of one
    sample (about the instance's step voxels, th a multiple of its row
    lanes); the B ceil(H / th) D steps split over as many blocks as fill
    every multiprocessor once (as far as shared memory and registers let),
    and each block (and each row lane of it) writes its own partial."""
    b, cin, d, h, w = shape
    co_t, ci_t, rs, step, most = NARROW if cin < NARROW_BELOW_CIN else WIDE
    wp = -(-w // 4) * 4
    th = min(h, rs * max(1, step // (wp * rs)))
    per_sm = max(1, min(most, SMEM_PER_SM // (smem_bytes(cin, th, w) + 1024)))
    steps = b * d * -(-h // th)
    tiles = -(-cout // co_t) * -(-cin // ci_t)
    nsplit = max(1, min(steps, per_sm * sms // tiles))
    return th, nsplit, nsplit * rs


def conv3d_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The kernel: conv3d_wgrad_plain's result for float32 CUDA tensors x
    (B, Cin, D, H, W) and dy (B, Cout, D, H, W) on one device.  The kernel
    reads channels-last (channels_last_3d) memory, in which cuDNN hands the
    pyramid's conv outputs and their gradients; a tensor in another layout
    is copied to it first.  The sums run in a fixed order, so two calls on
    the same inputs give the same bits."""
    for name, t in (("x", x), ("dy", dy)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"conv3d_wgrad: {name} must be a float32 CUDA tensor, got "
                            f"{t.dtype} on {t.device}")
        if t.ndim != 5:
            raise ValueError(f"conv3d_wgrad: {name} must be (B, C, D, H, W), got "
                             f"{tuple(t.shape)}")
    if dy.device != x.device or dy.shape[0] != x.shape[0] or dy.shape[2:] != x.shape[2:]:
        raise ValueError(f"conv3d_wgrad: dy {tuple(dy.shape)} on {dy.device} does not match x "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.contiguous(memory_format=torch.channels_last_3d)
    dy = dy.contiguous(memory_format=torch.channels_last_3d)
    b, cin, d, h, w = x.shape
    cout = dy.shape[1]
    th, nsplit, parts = plan(tuple(x.shape), cout, _sm_count(x.device.index or 0))
    part = torch.empty((parts, cout * cin * 27), dtype=torch.float32, device=x.device)
    out = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _bind()(x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), b, cin, cout,
                 d, h, w, th, nsplit, parts, stream)
    build.check(rc, "sv3d_conv3d_wgrad")
    conv3d_wgrad_cuda.launches += 1
    return out


conv3d_wgrad_cuda.launches = 0


@torch.library.custom_op("sv3d_tpu_torch::conv3d_wgrad", mutates_args=())
def conv3d_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The weight gradient (Cout, Cin, 3, 3, 3) of a 3x3x3 stride-1 pad-1
    Conv3d: the plain version for a CPU tensor, the kernel for a CUDA one
    (float32 only)."""
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, dy)
    return conv3d_wgrad_cuda(x, dy)


@register_flop_formula(torch.ops.sv3d_tpu_torch.conv3d_wgrad)
def _conv3d_wgrad_flop(x_shape, dy_shape, *args, out_shape=None, **kwargs) -> int:
    """aten.convolution_backward's count for the weight gradient alone."""
    def t(shape):
        return [shape[1], shape[0], *shape[2:]]

    return conv_flop_count(t(x_shape), t(dy_shape), t(out_shape), transposed=False)
