"""Wrapper of the CUDA conv input-gradient kernel (sv3d_tpu_torch/csrc/conv3d_dgrad.cu).

  conv3d_dgrad  the input gradient (B, Cin, D, H, W) of a 3x3x3, stride-1,
                pad-1 Conv3d from its output's gradient dy (B, Cout, D, H,
                W) and its weight (Cout, Cin, 3, 3, 3)

It replaces no TPU kernel (the JAX package leaves its convolutions to XLA):
the f32 training step takes the input gradients of ConvONet's U-Net convs,
whose gradients arrive channel-major (NCDHW), here instead of from cuDNN
(models/wgrad.py::WgradConv3d).  A CPU tensor of any float dtype runs the
plain version, conv3d_dgrad_plain (aten's convolution_backward for the input
alone); a CUDA float32 tensor launches the kernel (conv3d_dgrad_cuda), and
any other CUDA dtype raises.  conv3d_dgrad is a torch.library custom op whose
flop formula is aten's for the input gradient, 2 Cout Cin 27 B D H W, so
FlopCounterMode counts a step the same whichever code computes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from sv3d_tpu_torch.ops.cuda import build

#: the kernel's two instances (csrc/conv3d_dgrad.cu): input channels a block,
#: groups of 8 voxels a block (256 threads, a thread 8 voxels by 8 channels)
NARROW, WIDE = (32, 64), (64, 32)
#: output channels (dy) a chunk
KC = 8
#: the most shared memory a block may take (the H100's 227 KB)
SMEM_PER_BLOCK = 227 * 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
# dy, w, wt, dx, B, Cin, Cout, D, H, W, ncg, td, th, wtile, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]


@functools.lru_cache(maxsize=None)
def _bind():
    fn = build.load().sv3d_conv3d_dgrad
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def conv3d_dgrad_plain(dy: torch.Tensor, weight: torch.Tensor, x_shape) -> torch.Tensor:
    """The input gradient of F.conv3d(x, weight, padding=1), x of shape
    x_shape, for the output gradient dy: aten's convolution_backward with
    only the input's gradient asked for."""
    return torch.nn.grad.conv3d_input(list(x_shape), weight, dy, stride=1, padding=1)


def instance(cin: int) -> tuple:
    """The kernel's instance for cin input channels: Wide (64 a block) where
    they come in whole tiles of 64, else Narrow (32): no tile is then more
    than half empty for cin >= 32 (ConvONet's 96 and 32 take Narrow; 64,
    128, 192 and 384 Wide)."""
    return WIDE if cin % 64 == 0 else NARROW


def smem_bytes(cin: int, td: int, th: int, wtile: int) -> int:
    """The kernel's shared memory a block: two dy slabs of KC channels by td
    + 2 depths by th + 2 rows by wtile * 8 + 8 floats (the halo), and two
    chunks of KC x 27 x NC weights."""
    nc = instance(cin)[0]
    return 4 * 2 * (KC * (td + 2) * (th + 2) * (wtile * 8 + 8) + KC * 27 * nc)


@functools.lru_cache(maxsize=256)
def plan(shape: tuple) -> tuple:
    """(ncg, td, th, wtile) of the kernel for an input (and dx) of shape (B,
    Cin, D, H, W): the instance's channel groups of 8, and a tile of voxels
    of td depths by th rows by wtile groups of 8 voxels along w that fills
    the instance's groups: the whole row, then rows, then, where one depth
    holds too few voxels, depths; half as many groups while the shared
    memory would not hold the tile's slabs.  So a tile is 512 (Narrow) or
    256 (Wide) voxels at every level of ConvONet's U-Net, and even its 8^3
    level at B = 32 runs 128 blocks."""
    b, cin, d, h, w = shape
    nc, groups = instance(cin)
    while True:
        wtile = min(-(-w // 8), groups)
        th = min(h, groups // wtile)
        td = min(d, groups // (wtile * th)) if th == h else 1
        if smem_bytes(cin, td, th, wtile) <= SMEM_PER_BLOCK or groups == 1:
            return nc // 8, td, th, wtile
        groups //= 2


def conv3d_dgrad_cuda(dy: torch.Tensor, weight: torch.Tensor, x_shape) -> torch.Tensor:
    """The kernel: conv3d_dgrad_plain's result for float32 CUDA tensors dy
    (B, Cout, D, H, W) and weight (Cout, Cin, 3, 3, 3) on one device.  It
    reads and writes channel-major (NCDHW) memory, in which ConvONet's U-Net
    hands its gradients; a dy in another layout is copied to it first (the
    route sends none).  The sums run in a fixed order, so two calls on the
    same inputs give the same bits."""
    for name, t in (("dy", dy), ("weight", weight)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise TypeError(f"conv3d_dgrad: {name} must be a float32 CUDA tensor, got "
                            f"{t.dtype} on {t.device}")
    x_shape = tuple(int(s) for s in x_shape)
    if dy.ndim != 5 or len(x_shape) != 5:
        raise ValueError(f"conv3d_dgrad: dy {tuple(dy.shape)} and x {x_shape} must be "
                         f"(B, C, D, H, W)")
    b, cin, d, h, w = x_shape
    cout = dy.shape[1]
    if (weight.device != dy.device or tuple(weight.shape) != (cout, cin, 3, 3, 3)
            or dy.shape[0] != b or tuple(dy.shape[2:]) != x_shape[2:]):
        raise ValueError(f"conv3d_dgrad: dy {tuple(dy.shape)} on {dy.device}, weight "
                         f"{tuple(weight.shape)} on {weight.device} and x {x_shape} do not "
                         f"match")
    dy = dy.contiguous()
    weight = weight.contiguous()
    ncg, td, th, wtile = plan(x_shape)
    wt = torch.empty((cout, 27, cin), dtype=torch.float32, device=dy.device)
    dx = torch.empty(x_shape, dtype=torch.float32, device=dy.device)
    stream = torch.cuda.current_stream(dy.device).cuda_stream
    rc = _bind()(dy.data_ptr(), weight.data_ptr(), wt.data_ptr(), dx.data_ptr(), b, cin, cout,
                 d, h, w, ncg, td, th, wtile, stream)
    build.check(rc, "sv3d_conv3d_dgrad")
    conv3d_dgrad_cuda.launches += 1
    return dx


conv3d_dgrad_cuda.launches = 0


@torch.library.custom_op("sv3d_tpu_torch::conv3d_dgrad", mutates_args=())
def conv3d_dgrad(dy: torch.Tensor, weight: torch.Tensor, x_shape: list[int]) -> torch.Tensor:
    """The input gradient (B, Cin, D, H, W) of a 3x3x3 stride-1 pad-1
    Conv3d: the plain version for a CPU tensor, the kernel for a CUDA one
    (float32 only)."""
    if dy.device.type == "cpu":
        return conv3d_dgrad_plain(dy, weight, x_shape)
    return conv3d_dgrad_cuda(dy, weight, x_shape)


@register_flop_formula(torch.ops.sv3d_tpu_torch.conv3d_dgrad)
def _conv3d_dgrad_flop(dy_shape, w_shape, x_shape, *args, out_shape=None, **kwargs) -> int:
    """aten.convolution_backward's count for the input gradient alone."""
    return conv_flop_count(list(dy_shape), list(w_shape), list(out_shape), transposed=True)
