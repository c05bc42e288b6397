"""Rounding of operands to a lower precision than float32, for the controls:
the reference computed one precision below what a configuration states
(TF32 for float32 with TF32 off, fp8 for bfloat16), with float32 sums.

Both are emulated (operands rounded, then float32 arithmetic), so a control
reads the same on the CPU and on the card."""

from __future__ import annotations

import torch


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), kept float32."""
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 -> fp8 e4m3 with one scale for the whole tensor (its largest
    magnitude maps to 448, e4m3's largest), back to float32."""
    amax = t.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class _Operand(torch.autograd.Function):
    """Rounds in the forward pass; passes the gradient as it is."""

    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Result(torch.autograd.Function):
    """Passes the forward value as it is; rounds the incoming gradient, the
    operand of the backward products."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Precision:
    """Where a reference rounds: operand() and result() around every
    convolution and dense layer (the forward products' operands, and the
    backward products' incoming gradient); sweep(), the lattice sweep's
    levels, features, weights and hidden activations."""

    def __init__(self, conv=exact, sweep=exact):
        self.conv = conv
        self.sweep = sweep

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.conv is exact else _Operand.apply(t, self.conv)

    def result(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.conv is exact else _Result.apply(t, self.conv)


EXACT = Precision()
#: the serving control: TF32 in the f32 layers, fp8 in the bf16 sweep
SERVE_CONTROL = Precision(conv=tf32, sweep=fp8)
#: the training control: TF32 in every convolution and dense layer
TRAIN_CONTROL = Precision(conv=tf32)
