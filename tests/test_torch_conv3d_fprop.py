"""The f32 conv forward of training (sv3d_tpu_torch/ops/cuda/conv3d_fprop.py
and its route, models/wgrad.py::WgradConv3d, in ConvONet's U-Net and
models/ifnet.py::_ConvBlock): the plain version against a tap-by-tap sum in
float64 at the U-Net's shapes scaled down, where the route takes the op and
where it keeps aten's (on fake CUDA tensors too), the tracer's two
counters, a ConvONet step's counted operations with and without the route,
and the kernel's instance and tile plan at the U-Net's shapes.  The tests
marked ``cuda`` hold the kernel to float64 on the card (``python -m pytest
-m cuda tests/test_torch_conv3d_fprop.py``) and skip without one; this file
imports nothing of JAX."""

from __future__ import annotations

from contextlib import nullcontext

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from sv3d_tpu_torch.config import ConvONetConfig, IFNetConfig
from sv3d_tpu_torch.models import wgrad
from sv3d_tpu_torch.models.convonet import ConvONet
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.wgrad import WgradConv3d, takes_fprop
from sv3d_tpu_torch.ops.cuda.conv3d_fprop import (
    FPROP_RTOL,
    NARROW,
    SMEM_PER_BLOCK,
    WIDE,
    conv3d_fprop,
    conv3d_fprop_cuda,
    conv3d_fprop_plain,
    instance,
    plan,
    smem_bytes,
)
from sv3d_tpu_torch.utils import profiling

torch.set_num_threads(1)

#: (Cin, Cout, grid side) of the 14 3x3x3 convs of ConvONet's room_grid64
#: U-Net, as benchmark/arch/convonet_grid.py::unet_convs lists them
UNET = [(32, 32, 64), (32, 32, 64), (32, 32, 32), (32, 64, 32), (64, 64, 16), (64, 128, 16),
        (128, 128, 8), (128, 256, 8), (384, 128, 16), (128, 128, 16), (192, 64, 32),
        (64, 64, 32), (96, 32, 64), (32, 32, 64)]


def _taps(x, weight, bias=None):
    """y[b][co][p] = bias[co] + sum_{ci,k} x[b][ci][p + k - 1] W[co][ci][k],
    x zero outside the grid: the 27 shifted slabs of the padded input, each
    by its tap's weights."""
    d, h, w = x.shape[2:]
    xp = F.pad(x, (1, 1) * 3)
    y = sum(torch.einsum("bcdhw,oc->bodhw", xp[:, :, kd:kd + d, kh:kh + h, kw:kw + w],
                         weight[:, :, kd, kh, kw])
            for kd in range(3) for kh in range(3) for kw in range(3))
    return y if bias is None else y + bias.view(1, -1, 1, 1, 1)


@pytest.mark.parametrize("i", range(len(UNET)))
def test_plain_fprop_is_the_tap_sum(i):
    """The op's plain version (F.conv3d) at the U-Net's 14 shapes, the grid
    8 times smaller a side (at least 2), B = 2, with a bias on every other
    one: the sum the kernel computes, in float64."""
    cin, cout, side = UNET[i]
    s = max(side // 8, 2)
    gen = torch.Generator().manual_seed(i)
    x = torch.randn((2, cin, s, s + 1, s), dtype=torch.float64, generator=gen)
    weight = torch.randn((cout, cin, 3, 3, 3), dtype=torch.float64, generator=gen)
    bias = torch.randn(cout, dtype=torch.float64, generator=gen) if i % 2 else None
    want = _taps(x, weight, bias)
    torch.testing.assert_close(conv3d_fprop_plain(x, weight, bias), want, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(conv3d_fprop(x, weight, bias), want, rtol=1e-12, atol=1e-12)


def _count_fprops(monkeypatch) -> list:
    """The (device, dtype) of each x that WgradConv3d hands conv3d_fprop;
    the op's stand-in is F.conv3d, which fake tensors can run."""
    calls = []

    def counted(x, weight, bias=None):
        calls.append((x.device.type, x.dtype))
        return F.conv3d(x, weight, bias, padding=1)

    monkeypatch.setattr(wgrad, "conv3d_fprop", counted)
    return calls


@pytest.mark.parametrize("device,dtype,channels_last,cin,cout,routed", [
    ("cpu", torch.float32, False, 8, 32, True),
    ("cpu", torch.float64, False, 8, 32, True),
    ("cpu", torch.float32, True, 8, 32, False),
    ("cpu", torch.float32, False, 1, 16, False),
    ("cuda", torch.float32, False, 8, 32, True),
    ("cuda", torch.float32, False, 8, 64, True),
    ("cuda", torch.float64, False, 8, 32, False),
    ("cuda", torch.float32, True, 8, 64, False),
    ("cuda", torch.float32, False, 1, 16, False),
    ("cuda", torch.float32, True, 1, 16, False),
    ("cuda", torch.float32, False, 16, 16, False),
])
def test_forward_route(monkeypatch, device, dtype, channels_last, cin, cout, routed):
    """The op computes the forward where x is NCDHW with 32 output channels
    or more, on the card in float32 alone (CUDA tensors faked: no card
    here); channels-last x, the IF-Net's stage 0 (one input channel, so x
    is contiguous in both layouts, 16 output channels) and a float64 CUDA x
    keep aten's.  <prefix>.fprop counts every forward, <prefix>.fprop_kernel
    those the kernel takes (on the card)."""
    calls = _count_fprops(monkeypatch)
    profiling.reset()
    with profiling.enabled(), FakeTensorMode() if device == "cuda" else nullcontext():
        layout = torch.channels_last_3d if channels_last else torch.contiguous_format
        x = torch.empty((2, cin, 3, 4, 5), dtype=dtype, device=device, memory_format=layout)
        weight = torch.empty((cout, cin, 3, 3, 3), dtype=dtype, device=device)
        y = WgradConv3d.apply(x, weight, None, "convonet")
        assert tuple(y.shape) == (2, cout, 3, 4, 5) and takes_fprop(x, weight) == routed
        if cin == 1:
            assert x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last_3d)
    counters = profiling.records()["counters"]
    profiling.reset()
    assert calls == ([(device, dtype)] if routed else [])
    assert counters.get("convonet.fprop") == 1
    assert counters.get("convonet.fprop_kernel", 0) == (1 if routed and device == "cuda" else 0)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_function_forward_is_conv3ds(dtype, bias):
    """On the CPU the routed forward gives F.conv3d's bits, with and
    without a bias, and the three gradients are nn.Conv3d's."""
    gen = torch.Generator().manual_seed(3)
    layer = torch.nn.Conv3d(6, 40, 3, padding=1, bias=bias).to(dtype)
    x = torch.randn((2, 6, 5, 3, 7), dtype=dtype, generator=gen)
    dy = torch.randn((2, 40, 5, 3, 7), dtype=dtype, generator=gen)
    outs = []
    for run in (lambda x: WgradConv3d.apply(x, layer.weight, layer.bias, "convonet"), layer):
        layer.zero_grad()
        xi = x.clone().requires_grad_()
        y = run(xi)
        y.backward(dy)
        outs.append((y.detach(), xi.grad, layer.weight.grad.clone(),
                     layer.bias.grad.clone() if bias else None))
    (y, gx, gw, gb), (ry, rx, rw, rb) = outs
    assert torch.equal(y, ry)
    tol = {"rtol": 1e-12, "atol": 1e-12} if dtype == torch.float64 else {}
    torch.testing.assert_close(gx, rx, **tol)
    torch.testing.assert_close(gw, rw, **tol)
    if bias:
        torch.testing.assert_close(gb, rb, **tol)


def test_tracer_counts_the_forwards():
    """ConvONet's U-Net (room_grid64's widths on an 8-cell grid) counts all
    14 forwards under autograd (none without: its convs run F.conv3d
    there); the kernel counts none on the CPU.  The IF-Net counts its nine
    under its own prefix."""
    model = ConvONet(ConvONetConfig(grid=8), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    cloud = torch.rand(1, 200, 3, generator=gen) - 0.5
    points = torch.rand(1, 16, 3, generator=gen) - 0.5
    profiling.reset()
    with profiling.enabled():
        model(cloud, points).sum().backward()
        with torch.no_grad():
            model(cloud, points)
    counters = profiling.records()["counters"]
    profiling.reset()
    assert counters.get("convonet.fprop") == 14
    assert counters.get("convonet.fprop_kernel", 0) == 0
    assert not [k for k in counters if k.startswith("ifnet.")]

    ifnet = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(0))
    with profiling.enabled():
        ifnet(torch.rand(2, 9, 8, 10, 1), torch.rand(2, 16, 3) - 0.5).sum().backward()
    counters = profiling.records()["counters"]
    profiling.reset()
    assert counters.get("ifnet.fprop") == 9
    assert counters.get("ifnet.fprop_kernel", 0) == 0
    assert not [k for k in counters if k.startswith("convonet.")]


def test_convonet_step_counts_the_same(monkeypatch):
    """FlopCounterMode over a ConvONet forward and backward counts the same
    with the route as with aten's forward: the op's formula is aten's, 2
    Cout Cin 27 B D H W for each forward it takes.  (On the CPU GroupNorm
    keeps the encoder grid's channels-last layout, so the op takes the
    forwards from the U-Net's bottom level on; on the card GroupNorm hands
    every conv NCDHW.)"""
    model = ConvONet(ConvONetConfig(grid=8), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    cloud = torch.rand(2, 200, 3, generator=gen) - 0.5
    points = torch.rand(2, 16, 3, generator=gen) - 0.5
    route, taken = wgrad.takes_fprop, []

    def watched(x, weight):
        if route(x, weight):
            taken.append(2 * weight[0].numel() * weight.shape[0] * x[:, 0].numel())
            return True
        return False

    totals = []
    for rule in (watched, lambda x, weight: False):
        monkeypatch.setattr(wgrad, "takes_fprop", rule)
        with FlopCounterMode(display=False) as fc:
            model(cloud, points).sum().backward()
        totals.append((fc.get_total_flops(), fc.get_flop_counts()["Global"]))
    (routed, by_op), (plain, plain_by_op) = totals
    assert routed == plain
    assert torch.ops.sv3d_tpu_torch.conv3d_fprop not in plain_by_op
    assert len(taken) >= 8 and by_op[torch.ops.sv3d_tpu_torch.conv3d_fprop] == sum(taken)


@pytest.mark.parametrize("cin,cout,side", UNET)
def test_plan_at_the_unet_shapes(cin, cout, side):
    """Wide (64 channels a block) where Cout comes in tiles of 64, else
    Narrow (32); a tile of 512 or 256 voxels at every level (at 8^3 four
    depths), within the shared memory, and at least 128 blocks, the 8^3
    level's, at B = 32."""
    shape = (32, cin, side, side, side)
    nc, groups = instance(cout)
    assert (nc, groups) == (WIDE if cout in (64, 128, 256) else NARROW)
    ncg, td, th, wtile = plan(shape, cout)
    assert ncg * 8 == nc and td * th * wtile == groups
    assert (td > 1) == (side == 8) and wtile * 8 == min(side, 8 * groups)
    assert smem_bytes(cout, td, th, wtile) <= SMEM_PER_BLOCK
    blocks = 32 * -(-side // td) * -(-side // th) * -(-side // (wtile * 8)) * -(-cout // nc)
    assert blocks >= 128


@pytest.mark.parametrize("shape,cout", [((3, 20, 5, 7, 9), 40), ((1, 8, 1, 1, 1), 3),
                                        ((2, 64, 4, 200, 600), 64), ((1, 32, 3, 64, 8), 33),
                                        ((2, 128, 2, 2, 2000), 128)])
def test_plan_fits_the_kernel(shape, cout):
    """Ragged shapes: a tile within the instance's groups and the shared
    memory, however long the rows."""
    ncg, td, th, wtile = plan(shape, cout)
    _, _, d, h, w = shape
    assert 1 <= td <= d and 1 <= th <= h and 1 <= wtile <= -(-w // 8)
    assert td * th * wtile <= instance(cout)[1] and ncg * 8 == instance(cout)[0]
    assert smem_bytes(cout, td, th, wtile) <= SMEM_PER_BLOCK


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _per_channel_err(got, ref) -> float:
    g, r = got.double().transpose(0, 1).flatten(1), ref.transpose(0, 1).flatten(1)
    return float(((g - r).norm(dim=1) / r.norm(dim=1)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,side,bias", [(*s, False) for s in UNET]
                         + [(20, 40, 5, True), (3, 36, 7, False), (36, 12, 9, True),
                            (64, 64, 6, True)])
def test_kernel_matches_float64_on_card(cuda_device, cin, cout, side, bias):
    """The U-Net's 14 shapes at B = 2 (and ragged ones, W % 4 != 0, with a
    bias): within FPROP_RTOL of float64 by output channel, the same bits on
    two calls, float32 only."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, cin, side, side + 1 if side < 10 else side, side), device=cuda_device,
                    generator=gen)
    weight = torch.randn((cout, cin, 3, 3, 3), device=cuda_device, generator=gen)
    b = torch.randn(cout, device=cuda_device, generator=gen) if bias else None
    before = conv3d_fprop_cuda.launches
    got = conv3d_fprop(x, weight, b)
    again = conv3d_fprop_cuda(x, weight, b)
    assert conv3d_fprop_cuda.launches == before + 2
    # f32 sums of up to 27 x 384 products against float64 on the same inputs
    ref = conv3d_fprop_plain(x.double(), weight.double(), None if b is None else b.double())
    assert _per_channel_err(got, ref) <= FPROP_RTOL
    assert torch.equal(got, again)  # a fixed order of sums: the same bits
    with pytest.raises(TypeError):
        conv3d_fprop(x.double(), weight.double())


def _traced(fn) -> dict:
    profiling.reset()
    with profiling.enabled():
        fn()
    torch.cuda.synchronize()
    counters = profiling.records()["counters"]
    profiling.reset()
    return counters


@pytest.mark.cuda
def test_route_on_card(cuda_device, monkeypatch):
    """On the card ConvONet's U-Net (room_grid64's widths) takes the kernel
    for its 14 forwards, counted, its output within FPROP_RTOL of cuDNN's
    forward; the IF-Net 128's f32 step on the full grid takes it for none
    (stage 0 has 16 output channels, the later stages' x arrives
    channels-last from cuDNN)."""
    model = ConvONet(ConvONetConfig(), device=cuda_device,
                     generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    cloud = torch.rand((2, 4096, 3), device=cuda_device, generator=gen) - 0.5
    points = torch.rand((2, 256, 3), device=cuda_device, generator=gen) - 0.5
    before = conv3d_fprop_cuda.launches
    out = {}
    counters = _traced(lambda: out.update(y=model(cloud, points)))
    assert counters.get("convonet.fprop") == 14 and counters.get("convonet.fprop_kernel") == 14
    assert conv3d_fprop_cuda.launches - before == 14
    y = out["y"].detach()
    with monkeypatch.context() as m:
        m.setattr(wgrad, "takes_fprop", lambda x, weight: False)
        ref = model(cloud, points).detach()
    assert float((y - ref).norm() / ref.norm()) <= FPROP_RTOL

    ifnet = IFNet(IFNetConfig.for_net_res(128), device=cuda_device,
                  generator=torch.Generator().manual_seed(0))
    grid = torch.rand((1, 139, 104, 112, 1), device=cuda_device, generator=gen)
    pts = torch.rand((1, 2048, 3), device=cuda_device, generator=gen) - 0.5
    before = conv3d_fprop_cuda.launches
    counters = _traced(lambda: ifnet(grid.requires_grad_(), pts).square().sum().backward())
    assert counters.get("ifnet.fprop") == 9 and counters.get("ifnet.fprop_kernel", 0) == 0
    assert conv3d_fprop_cuda.launches == before
