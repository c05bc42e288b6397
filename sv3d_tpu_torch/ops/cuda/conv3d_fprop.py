"""Wrapper of the CUDA conv forward kernel (sv3d_tpu_torch/csrc/conv3d_fprop.cu).

  conv3d_fprop  F.conv3d(x, weight, bias, padding=1) of an input x (B, Cin,
                D, H, W) and a weight (Cout, Cin, 3, 3, 3): a 3x3x3,
                stride-1, pad-1 Conv3d

It replaces no TPU kernel (the JAX package leaves its convolutions to XLA):
the f32 training step takes the forward of ConvONet's U-Net convs, whose
inputs arrive channel-major (NCDHW), here instead of from cuDNN
(models/wgrad.py::WgradConv3d).  A CPU tensor of any float dtype runs the
plain version, conv3d_fprop_plain (F.conv3d); a CUDA float32 tensor launches
the kernel (conv3d_fprop_cuda), and any other CUDA dtype raises.
conv3d_fprop is a torch.library custom op whose flop formula is aten's for
the forward, 2 Cout Cin 27 B D H W, so FlopCounterMode counts a step the
same whichever code computes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from sv3d_tpu_torch.ops.cuda import build

#: the kernel's two instances (csrc/conv3d_fprop.cu): output channels a block,
#: groups of 8 voxels a block (256 threads, a thread 8 voxels by 8 channels)
NARROW, WIDE = (32, 64), (64, 32)
#: input channels (x) a chunk
KC = 8
#: the most shared memory a block may take (the H100's 227 KB)
SMEM_PER_BLOCK = 227 * 1024

# The conv forward kernel (csrc/conv3d_fprop.cu) against its plain version
# run in float64 on the same f32 inputs: each output channel's difference
# within FPROP_RTOL of that channel's norm.  The kernel sums Cin * 27 f32
# products a value in another order than cuDNN, whose f32 forward is printed
# beside it, not held to.
FPROP_RTOL = 1e-5

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, bias, wt, y, B, Cin, Cout, D, H, W, ncg, td, th, wtile, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _bind():
    fn = build.load().sv3d_conv3d_fprop
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def conv3d_fprop_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """F.conv3d(x, weight, bias, padding=1): aten's forward."""
    return F.conv3d(x, weight, bias, padding=1)


def instance(cout: int) -> tuple:
    """The kernel's instance for cout output channels: Wide (64 a block)
    where they come in whole tiles of 64, else Narrow (32): no tile is then
    more than half empty for cout >= 32 (ConvONet's 32 take Narrow; 64, 128
    and 256 Wide)."""
    return WIDE if cout % 64 == 0 else NARROW


def smem_bytes(cout: int, td: int, th: int, wtile: int) -> int:
    """The kernel's shared memory a block: two x slabs of KC channels by td
    + 2 depths by th + 2 rows by wtile * 8 + 8 floats (the halo), and two
    chunks of KC x 27 x NC weights."""
    nc = instance(cout)[0]
    return 4 * 2 * (KC * (td + 2) * (th + 2) * (wtile * 8 + 8) + KC * 27 * nc)


@functools.lru_cache(maxsize=256)
def plan(shape: tuple, cout: int) -> tuple:
    """(ncg, td, th, wtile) of the kernel for an input (and y) of spatial
    shape (B, C, D, H, W) and cout output channels: the instance's channel
    groups of 8, and a tile of voxels of td depths by th rows by wtile
    groups of 8 voxels along w that fills the instance's groups: the whole
    row, then rows, then, where one depth holds too few voxels, depths; half
    as many groups while the shared memory would not hold the tile's slabs
    (the input gradient's rule, ops/cuda/conv3d_dgrad.py::plan).  So a tile
    is 512 (Narrow) or 256 (Wide) voxels at every level of ConvONet's U-Net,
    and even its 8^3 level at B = 32 runs 128 blocks."""
    b, _, d, h, w = shape
    nc, groups = instance(cout)
    while True:
        wtile = min(-(-w // 8), groups)
        th = min(h, groups // wtile)
        td = min(d, groups // (wtile * th)) if th == h else 1
        if smem_bytes(cout, td, th, wtile) <= SMEM_PER_BLOCK or groups == 1:
            return nc // 8, td, th, wtile
        groups //= 2


def conv3d_fprop_cuda(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: conv3d_fprop_plain's result for float32 CUDA tensors x
    (B, Cin, D, H, W), weight (Cout, Cin, 3, 3, 3) and bias (Cout,) or None
    on one device.  It reads and writes channel-major (NCDHW) memory, in
    which ConvONet's U-Net hands its activations; an x in another layout is
    copied to it first (the route sends none).  The sums run in a fixed
    order, so two calls on the same inputs give the same bits."""
    named = (("x", x), ("weight", weight)) + ((("bias", bias),) if bias is not None else ())
    for name, t in named:
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"conv3d_fprop: {name} must be a float32 CUDA tensor, got "
                            f"{t.dtype} on {t.device}")
    if x.ndim != 5:
        raise ValueError(f"conv3d_fprop: x {tuple(x.shape)} must be (B, C, D, H, W)")
    b, cin, d, h, w = x.shape
    cout = weight.shape[0]
    if (weight.device != x.device or tuple(weight.shape) != (cout, cin, 3, 3, 3)
            or (bias is not None and (bias.device != x.device
                                      or tuple(bias.shape) != (cout,)))):
        raise ValueError(f"conv3d_fprop: x {tuple(x.shape)} on {x.device}, weight "
                         f"{tuple(weight.shape)} on {weight.device} and bias "
                         f"{None if bias is None else tuple(bias.shape)} do not match")
    x = x.contiguous()
    weight = weight.contiguous()
    bias = bias.contiguous() if bias is not None else None
    ncg, td, th, wtile = plan(tuple(x.shape), cout)
    wt = torch.empty((cin, 27, cout), dtype=torch.float32, device=x.device)
    y = torch.empty((b, cout, d, h, w), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _bind()(x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None,
                 wt.data_ptr(), y.data_ptr(), b, cin, cout, d, h, w, ncg, td, th, wtile, stream)
    build.check(rc, "sv3d_conv3d_fprop")
    conv3d_fprop_cuda.launches += 1
    return y


conv3d_fprop_cuda.launches = 0


@torch.library.custom_op("sv3d_tpu_torch::conv3d_fprop", mutates_args=())
def conv3d_fprop(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """F.conv3d(x, weight, bias, padding=1) of a 3x3x3 weight: the plain
    version for a CPU tensor, the kernel for a CUDA one (float32 only)."""
    if x.device.type == "cpu":
        return conv3d_fprop_plain(x, weight, bias)
    return conv3d_fprop_cuda(x, weight, bias)


@register_flop_formula(torch.ops.sv3d_tpu_torch.conv3d_fprop)
def _conv3d_fprop_flop(x_shape, w_shape, bias_shape=None, *args, out_shape=None,
                       **kwargs) -> int:
    """aten.convolution's count for the forward (the bias not counted)."""
    return conv_flop_count(list(x_shape), list(w_shape), list(out_shape), transposed=False)
