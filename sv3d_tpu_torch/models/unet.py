"""UNet depth regressors (port of sv3d_tpu/models/unet.py).

UNet: 8-down / 8-up for 256x256 inputs; UNetMini: 4-down / 4-up for unresized
240x320 inputs.  Encoder convs are k4 s2 p1 with LeakyReLU(0.2), decoder
convs k3 s1 p1 with ReLU after a bilinear 2x upsample, skip concats at every
level.  The public layout is NHWC (B, H, W, 3) -> (B, H, W, 1), as in the JAX
package; inside, the convs run NCHW.  BatchNorm is the port's flax-semantics
BatchNorm (models/batchnorm.py, eps=1e-5, momentum 0.9); train/eval is the
module's mode.
Weights are drawn from an explicit torch.Generator with flax's initializers,
then the module moves to device.

dtype=torch.bfloat16 (--precision 16) is the flax modules' dtype: the input
is cast to bf16, every conv and BatchNorm computes and returns bf16
(models/mixed.py, models/batchnorm.py), and the activations, upsamples and
skip concats run on bf16 tensors; the parameters stay f32 and the output is
bf16.  dtype=None computes in the parameters' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sv3d_tpu_torch.models.batchnorm import BatchNorm
from sv3d_tpu_torch.models.init import flax_init_
from sv3d_tpu_torch.models.mixed import conv


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel bilinear 2x, the same weights as jax.image.resize(...,
    "bilinear") for an upsample, edge rows included.  A bf16 input is
    resized as jax.image.resize resizes one: the width first, rounded to
    bf16, then the height."""
    h, w = x.shape[-2:]
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, size=(h, 2 * w), mode="bilinear", align_corners=False)
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)


def _down(cin, cout):
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1)


def _same(cin, cout):
    return nn.Conv2d(cin, cout, 3, padding=1)


def _bn(c, dtype):
    return BatchNorm(c, dtype=dtype)


class UNet(nn.Module):
    """Full 8-level UNet; (B, 256, 256, C_in) -> (B, 256, 256, C_out)."""

    def __init__(self, num_filters: int = 32, channels_in: int = 3, channels_out: int = 1,
                 device=None, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        nf = num_filters
        enc = [nf, nf * 2, nf * 4, nf * 8, nf * 8, nf * 8, nf * 8, nf * 8]
        self.down = nn.ModuleList(
            _down(cin, cout) for cin, cout in zip([channels_in] + enc[:-1], enc)
        )
        dec = [nf * 8, nf * 8, nf * 8, nf * 8, nf * 4, nf * 2, nf]
        dec_in = [enc[7]] + [2 * c for c in dec[:-1]]
        self.same = nn.ModuleList(
            [_same(cin, cout) for cin, cout in zip(dec_in, dec)]
            + [_same(2 * dec[-1], channels_out)]
        )
        # BN order follows the JAX module's creation order (_BN_0.._BN_12):
        # encoder e2..e7, then decoder d1..d7
        self.bn = nn.ModuleList(_bn(c, dtype) for c in enc[1:7] + dec)
        flax_init_(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # the first conv casts it to dt, as flax casts the input
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        e = [conv(self.down[0], x, dt)]
        for i in range(1, 8):
            h = conv(self.down[i], lrelu(e[-1]), dt)
            e.append(self.bn[i - 1](h) if i < 7 else h)
        d = e[7]
        for i in range(7):
            h = self.bn[6 + i](conv(self.same[i], _upsample2x(F.relu(d)), dt))
            d = torch.cat([h, e[6 - i]], dim=1)
        out = conv(self.same[7], _upsample2x(F.relu(d)), dt)
        return out.permute(0, 2, 3, 1)


class UNetMini(nn.Module):
    """4-level UNet for unresized inputs; (B, 240, 320, C_in) -> same spatial."""

    def __init__(self, num_filters: int = 32, channels_in: int = 3, channels_out: int = 1,
                 device=None, generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        nf = num_filters
        enc = [nf, nf * 2, nf * 4, nf * 8]
        self.down = nn.ModuleList(
            _down(cin, cout) for cin, cout in zip([channels_in] + enc[:-1], enc)
        )
        self.same = nn.ModuleList([
            _same(nf * 8, nf * 4), _same(nf * 8, nf * 2), _same(nf * 4, nf),
            _same(nf * 2, channels_out),
        ])
        # _BN_0.._BN_4: e2, e3, d5, d6, d7
        self.bn = nn.ModuleList(_bn(c, dtype) for c in (nf * 2, nf * 4, nf * 4, nf * 2, nf))
        flax_init_(self, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)  # the first conv casts it to dt, as flax casts the input
        lrelu = lambda v: F.leaky_relu(v, 0.2)
        e1 = conv(self.down[0], x, dt)                         # 120x160
        e2 = self.bn[0](conv(self.down[1], lrelu(e1), dt))     # 60x80
        e3 = self.bn[1](conv(self.down[2], lrelu(e2), dt))     # 30x40
        e4 = conv(self.down[3], lrelu(e3), dt)                 # 15x20 (no BN)
        up = lambda i, v: conv(self.same[i], _upsample2x(F.relu(v)), dt)
        d5 = torch.cat([self.bn[2](up(0, e4)), e3], dim=1)
        d6 = torch.cat([self.bn[3](up(1, d5)), e2], dim=1)
        d7 = torch.cat([self.bn[4](up(2, d6)), e1], dim=1)
        return up(3, d7).permute(0, 2, 3, 1)


def renormalize_depth(logits: torch.Tensor, min_z: float, max_z: float) -> torch.Tensor:
    """sigmoid, then rescale into the per-dataset depth range."""
    return torch.sigmoid(logits) * (max_z - min_z) + min_z


def resize_crop_depth(depthmap: torch.Tensor) -> torch.Tensor:
    """Undo the square-pad-resize of the input: (B, 256, 256, 1) -> bilinear
    to (B, 320, 320, 1) -> crop rows 40:280 -> (B, 240, 320, 1)."""
    x = depthmap.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(320, 320), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1)[:, 40:280]
