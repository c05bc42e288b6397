"""The f32 conv input gradient of training (sv3d_tpu_torch/ops/cuda/
conv3d_dgrad.py and its route, models/wgrad.py::WgradConv3d, in ConvONet's
U-Net and models/ifnet.py::_ConvBlock): the plain version against
autograd's through F.conv3d in float64, the autograd Function's three
gradients against nn.Conv3d's in both layouts, where the route takes the
op and where it keeps aten's, the step's counted operations with and
without it, the tracer's two counters, and the kernel's instance and tile
plan at the U-Net's shapes.  The tests marked ``cuda`` hold the kernel to
float64 on the card (``python -m pytest -m cuda
tests/test_torch_conv3d_dgrad.py``) and skip without one; this file imports
nothing of JAX."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from sv3d_tpu_torch.config import ConvONetConfig, IFNetConfig
from sv3d_tpu_torch.models import wgrad
from sv3d_tpu_torch.models.convonet import ConvONet, _GcrConv
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.wgrad import WgradConv3d
from sv3d_tpu_torch.ops.cuda.conv3d_dgrad import (
    NARROW,
    SMEM_PER_BLOCK,
    WIDE,
    conv3d_dgrad,
    conv3d_dgrad_cuda,
    conv3d_dgrad_plain,
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


def _autograd_dgrad(dy, weight, x_shape):
    x = torch.zeros(x_shape, dtype=dy.dtype, requires_grad=True)
    F.conv3d(x, weight, padding=1).backward(dy)
    return x.grad


@pytest.mark.parametrize("b,cin,cout,grid", [(1, 1, 8, (1, 6, 7)), (3, 20, 12, (7, 5, 9)),
                                             (2, 32, 3, (3, 1, 1)), (1, 5, 40, (2, 3, 11))])
def test_plain_dgrad_is_autograds(b, cin, cout, grid):
    # the wrapper's argument plumbing (both sides are aten's on the CPU):
    # ragged channel counts, B 1 to 3, odd sizes and size-1 dims
    gen = torch.Generator().manual_seed(cin)
    dy = torch.randn((b, cout, *grid), dtype=torch.float64, generator=gen)
    weight = torch.randn((cout, cin, 3, 3, 3), dtype=torch.float64, generator=gen)
    x_shape = (b, cin, *grid)
    want = _autograd_dgrad(dy, weight, x_shape)
    torch.testing.assert_close(conv3d_dgrad_plain(dy, weight, x_shape), want, rtol=1e-12,
                               atol=1e-12)
    # the custom op runs the plain version on the CPU
    torch.testing.assert_close(conv3d_dgrad(dy, weight, list(x_shape)), want, rtol=1e-12,
                               atol=1e-12)


def _layout(t, channels_last):
    return t.contiguous(memory_format=torch.channels_last_3d) if channels_last else t


def _count_dgrads(monkeypatch) -> list:
    """The layouts of the dy that WgradConv3d hands conv3d_dgrad."""
    calls = []
    op = wgrad.conv3d_dgrad

    def counted(dy, weight, x_shape):
        calls.append(dy.is_contiguous())
        return op(dy, weight, x_shape)

    monkeypatch.setattr(wgrad, "conv3d_dgrad", counted)
    return calls


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_function_gradients_are_conv3ds(monkeypatch, dtype, bias, channels_last):
    """dx, dW and db as nn.Conv3d's autograd gives them, with and without a
    bias, for a dy in NCDHW (the op's route) and channels-last (aten's)."""
    calls = _count_dgrads(monkeypatch)
    gen = torch.Generator().manual_seed(5)
    layer = torch.nn.Conv3d(6, 10, 3, padding=1, bias=bias).to(dtype)
    x = _layout(torch.randn((2, 6, 5, 3, 7), dtype=dtype, generator=gen), channels_last)
    dy = _layout(torch.randn((2, 10, 5, 3, 7), dtype=dtype, generator=gen), channels_last)
    grads = []
    for run in (lambda x: WgradConv3d.apply(x, layer.weight, layer.bias, "convonet"), layer):
        layer.zero_grad()
        xi = x.clone().requires_grad_()
        run(xi).backward(dy)
        grads.append((xi.grad, layer.weight.grad.clone(),
                      layer.bias.grad.clone() if bias else None))
    (gx, gw, gb), (rx, rw, rb) = grads
    tol = {"rtol": 1e-12, "atol": 1e-12} if dtype == torch.float64 else {}
    torch.testing.assert_close(gx, rx, **tol)
    torch.testing.assert_close(gw, rw, **tol)
    if bias:
        torch.testing.assert_close(gb, rb, **tol)
    assert calls == ([] if channels_last else [True])


def test_no_input_gradient_without_need(monkeypatch):
    calls = _count_dgrads(monkeypatch)
    layer = torch.nn.Conv3d(4, 8, 3, padding=1)
    x = torch.randn(1, 4, 3, 4, 5)
    profiling.reset()
    with profiling.enabled():
        WgradConv3d.apply(x, layer.weight, layer.bias, "convonet").sum().backward()
    counters = profiling.records()["counters"]
    profiling.reset()
    assert calls == [] and "convonet.dgrad" not in counters
    assert counters.get("convonet.wgrad") == 1 and layer.bias.grad is not None


def _gcr_chain(cin: int, widths) -> torch.nn.ModuleList:
    chans = [cin, *widths]
    torch.manual_seed(0)
    return torch.nn.ModuleList(_GcrConv(a, b, 4) for a, b in zip(chans[:-1], chans[1:]))


def _unrouted(chain, x):
    for m in chain:
        x = F.relu(F.conv3d(m.norm(x), m.conv.weight, None, padding=1))
    return x


def test_counted_operations_unchanged():
    """FlopCounterMode over a forward and backward counts the same with the
    route as with aten's convs: the op's formula is aten's for the input
    gradient, 2 Cout Cin 27 B D H W."""
    chain = _gcr_chain(8, [16, 12])
    x = torch.randn(2, 8, 5, 4, 6, requires_grad=True)
    totals = []
    for fwd in (lambda x: _routed(chain, x), lambda x: _unrouted(chain, x)):
        with FlopCounterMode(display=False) as fc:
            fwd(x).sum().backward()
        totals.append((fc.get_total_flops(), fc.get_flop_counts()["Global"]))
    (routed, by_op), (plain, _) = totals
    assert routed == plain
    vox = 2 * 5 * 4 * 6
    assert by_op[torch.ops.sv3d_tpu_torch.conv3d_dgrad] == 2 * 27 * vox * (8 * 16 + 16 * 12)


def _routed(chain, x):
    for m in chain:
        x = m(x)
    return x


def test_tracer_counts_the_input_gradients():
    """ConvONet's U-Net (room_grid64's widths on an 8-cell grid) takes the
    op for all 14 input gradients, its first conv's too (the encoder
    trains); the kernel counts none on the CPU.  The IF-Net counts its own,
    under its prefix: eight, its first conv's input (the grid) asking
    none."""
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
    assert counters.get("convonet.dgrad") == 14
    assert counters.get("convonet.dgrad_kernel", 0) == 0
    assert not [k for k in counters if k.startswith("ifnet.")]

    ifnet = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(0))
    with profiling.enabled():
        ifnet(torch.rand(2, 9, 8, 10, 1), torch.rand(2, 16, 3) - 0.5).sum().backward()
    counters = profiling.records()["counters"]
    profiling.reset()
    assert counters.get("ifnet.dgrad") == 8
    assert counters.get("ifnet.dgrad_kernel", 0) == 0
    assert not [k for k in counters if k.startswith("convonet.")]


def test_channels_last_keeps_aten(monkeypatch):
    """A dy that arrives channels-last (as cuDNN hands the IF-Net pyramid's
    on the card) keeps aten's input gradient: the rule is on the layout,
    whatever the model."""
    calls = _count_dgrads(monkeypatch)
    chain = _gcr_chain(8, [16])
    x = torch.randn(2, 8, 4, 5, 6).contiguous(memory_format=torch.channels_last_3d)
    y = _routed(chain, x.requires_grad_())
    y.backward(torch.ones_like(y).contiguous(memory_format=torch.channels_last_3d))
    y = _routed(chain, x.detach().contiguous().requires_grad_())
    y.backward(torch.ones_like(y).contiguous())
    assert calls == [True]


@pytest.mark.parametrize("cin,cout,side", UNET)
def test_plan_at_the_unet_shapes(cin, cout, side):
    """Wide (64 channels a block) where Cin comes in tiles of 64, else
    Narrow (32); a tile of 512 or 256 voxels at every level (at 8^3 four
    depths), within the shared memory, and at least 128 blocks, the 8^3
    level's, at B = 32."""
    shape = (32, cin, side, side, side)
    nc, groups = instance(cin)
    assert (nc, groups) == (WIDE if cin in (64, 128, 192, 384) else NARROW)
    ncg, td, th, wtile = plan(shape)
    assert ncg * 8 == nc and td * th * wtile == groups
    assert (td > 1) == (side == 8) and wtile * 8 == min(side, 8 * groups)
    assert smem_bytes(cin, td, th, wtile) <= SMEM_PER_BLOCK
    blocks = 32 * -(-side // td) * -(-side // th) * -(-side // (wtile * 8)) * -(-cin // nc)
    assert blocks >= 128


@pytest.mark.parametrize("shape", [(3, 20, 5, 7, 9), (1, 8, 1, 1, 1), (2, 64, 4, 200, 600),
                                   (1, 32, 3, 64, 8), (2, 128, 2, 2, 2000)])
def test_plan_fits_the_kernel(shape):
    """Ragged shapes: a tile within the instance's groups and the shared
    memory, however long the rows."""
    ncg, td, th, wtile = plan(shape)
    _, cin, d, h, w = shape
    assert 1 <= td <= d and 1 <= th <= h and 1 <= wtile <= -(-w // 8)
    assert td * th * wtile <= instance(cin)[1] and ncg * 8 == instance(cin)[0]
    assert smem_bytes(cin, td, th, wtile) <= SMEM_PER_BLOCK


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
@pytest.mark.parametrize("cin,cout,side", UNET[:13]
                         + [(20, 40, 5), (3, 16, 7), (36, 12, 9)])
def test_kernel_matches_float64_on_card(cuda_device, cin, cout, side):
    """The U-Net's shapes at B = 2 (and ragged ones, W % 4 != 0): within
    1e-5 of float64 by input channel, the same bits on two calls."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x_shape = (2, cin, side, side + 1 if side < 10 else side, side)
    dy = torch.randn((2, cout, *x_shape[2:]), device=cuda_device, generator=gen)
    weight = torch.randn((cout, cin, 3, 3, 3), device=cuda_device, generator=gen)
    before = conv3d_dgrad_cuda.launches
    got = conv3d_dgrad(dy, weight, list(x_shape))
    again = conv3d_dgrad_cuda(dy, weight, x_shape)
    assert conv3d_dgrad_cuda.launches == before + 2
    # f32 sums of up to 27 x 256 products against float64 on the same inputs
    ref = conv3d_dgrad_plain(dy.double(), weight.double(), x_shape)
    assert _per_channel_err(got, ref) <= 1e-5
    assert torch.equal(got, again)  # a fixed order of sums: the same bits
    with pytest.raises(TypeError):
        conv3d_dgrad(dy.double(), weight.double(), list(x_shape))


@pytest.mark.cuda
def test_route_on_card(cuda_device):
    """On the card the U-Net's convs take the kernel, counted; a
    channels-last dy keeps cuDNN's."""
    chain = _gcr_chain(32, [64, 32]).to(cuda_device)
    ref = _gcr_chain(32, [64, 32]).to(cuda_device)
    x = torch.randn((4, 32, 12, 12, 12), device=cuda_device)
    before = conv3d_dgrad_cuda.launches
    xi = x.clone().requires_grad_()
    profiling.reset()
    with profiling.enabled():
        _routed(chain, xi).square().sum().backward()
    counters = profiling.records()["counters"]
    profiling.reset()
    assert counters.get("convonet.dgrad") == 2 and counters.get("convonet.dgrad_kernel") == 2
    assert conv3d_dgrad_cuda.launches - before == 2
    xr = x.clone().requires_grad_()
    _unrouted(ref, xr).square().sum().backward()
    assert float((xi.grad - xr.grad).norm() / xr.grad.norm()) <= 1e-5
    for a, b in zip(chain.parameters(), ref.parameters()):
        assert float((a.grad - b.grad).norm() / b.grad.norm()) <= 1e-5  # f32 sums in other orders
    # (GroupNorm hands the conv an NCDHW input on the card whatever its own
    # input's layout, so the conv is called here with channels-last tensors)
    before = conv3d_dgrad_cuda.launches
    xc = x.contiguous(memory_format=torch.channels_last_3d).requires_grad_()
    y = WgradConv3d.apply(xc, chain[0].conv.weight, None, "convonet")
    y.backward(torch.ones_like(y).contiguous(memory_format=torch.channels_last_3d))
    assert conv3d_dgrad_cuda.launches == before and xc.grad is not None
