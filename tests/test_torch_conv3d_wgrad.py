"""The IF-Net pyramid's conv weight gradient (sv3d_tpu_torch/ops/cuda/
conv3d_wgrad.py and its route in models/ifnet.py::_ConvBlock): the plain
version against autograd's through F.conv3d in float64, the autograd
Function's three gradients against nn.Conv3d's, where the route is taken
and where not, the step's counted operations with and without it, and the
tracer's two counters.  The test marked ``cuda`` holds the kernel to the
plain version on the card (``python -m pytest -m cuda
tests/test_torch_conv3d_wgrad.py``) and skips without one; this file
imports nothing of JAX."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.models import ifnet as ifnet_mod
from sv3d_tpu_torch.models.ifnet import IFNet, _ConvBlock
from sv3d_tpu_torch.ops.cuda.conv3d_wgrad import (
    NARROW,
    SMEM_PER_BLOCK,
    WIDE,
    conv3d_wgrad,
    conv3d_wgrad_cuda,
    conv3d_wgrad_plain,
    plan,
    smem_bytes,
)
from sv3d_tpu_torch.utils import profiling

torch.set_num_threads(1)

def _autograd_wgrad(x, dy):
    w = torch.zeros((dy.shape[1], x.shape[1], 3, 3, 3), dtype=x.dtype, requires_grad=True)
    F.conv3d(x, w, padding=1).backward(dy)
    return w.grad


@pytest.mark.parametrize("cin,b,grid", [(1, 1, (1, 6, 7)), (16, 3, (7, 5, 9)), (32, 1, (3, 1, 1))])
def test_plain_wgrad_is_autograds(cin, b, grid):
    # the wrapper's argument plumbing (both sides are aten's on the CPU): each
    # Cin of the pyramid's kinds, B 1 and 3, odd sizes and size-1 dims
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn((b, cin, *grid), dtype=torch.float64, generator=gen)
    dy = torch.randn((b, 8, *grid), dtype=torch.float64, generator=gen)
    want = _autograd_wgrad(x, dy)
    torch.testing.assert_close(conv3d_wgrad_plain(x, dy), want, rtol=1e-12, atol=1e-12)
    # the custom op runs the plain version on the CPU
    torch.testing.assert_close(conv3d_wgrad(x, dy), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("x_grad", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_function_gradients_are_conv3ds(dtype, x_grad):
    gen = torch.Generator().manual_seed(3)
    layer = torch.nn.Conv3d(4, 6, 3, padding=1).to(dtype)
    x = torch.randn((2, 4, 5, 3, 6), dtype=dtype, generator=gen)
    dy = torch.randn((2, 6, 5, 3, 6), dtype=dtype, generator=gen)
    grads = []
    for run in (ifnet_mod._PyramidConv.apply, lambda x, w, b: layer(x)):
        layer.zero_grad()
        xi = x.clone().requires_grad_(x_grad)
        run(xi, layer.weight, layer.bias).backward(dy)
        grads.append((xi.grad, layer.weight.grad.clone(), layer.bias.grad.clone()))
    (gx, gw, gb), (rx, rw, rb) = grads
    tol = {"rtol": 1e-12, "atol": 1e-12} if dtype == torch.float64 else {}
    if x_grad:
        torch.testing.assert_close(gx, rx, **tol)
    else:
        assert gx is None and rx is None
    torch.testing.assert_close(gw, rw, **tol)
    torch.testing.assert_close(gb, rb, **tol)


def _count_applies(monkeypatch) -> list:
    calls = []
    apply = ifnet_mod._PyramidConv.apply

    def counted(*args):
        calls.append(args[1].shape)
        return apply(*args)

    monkeypatch.setattr(ifnet_mod._PyramidConv, "apply", counted)
    return calls


def test_route_taken_in_f32_training(monkeypatch):
    calls = _count_applies(monkeypatch)
    block = _ConvBlock(1, [8, 8])
    block(torch.randn(2, 1, 4, 5, 6)).sum().backward()
    assert len(calls) == 2


def test_route_not_taken_without_grad_at_bf16_or_frozen(monkeypatch):
    calls = _count_applies(monkeypatch)
    x = torch.randn(2, 1, 4, 5, 6)
    block = _ConvBlock(1, [8, 8])
    with torch.no_grad():
        block(x)
    with torch.inference_mode():
        block(x)
    bf16 = _ConvBlock(1, [8, 8], dtype=torch.bfloat16)
    bf16(x).float().sum().backward()
    assert bf16.convs[0].weight.grad is not None
    frozen = _ConvBlock(1, [8, 8])
    frozen.requires_grad_(False)
    frozen(x.requires_grad_()).sum().backward()
    assert calls == []


def _unrouted_forward(block, x):
    for layer in block.convs:
        x = F.relu(layer(x))
    return block.bn(x)


@pytest.mark.parametrize("cin", [1, 16])
def test_counted_operations_unchanged(cin):
    block = _ConvBlock(cin, [8, 16])
    x = torch.randn(2, cin, 5, 4, 6, requires_grad=True)
    totals = []
    for fwd in (block.forward, lambda x: _unrouted_forward(block, x)):
        with FlopCounterMode(display=False) as fc:
            fwd(x).sum().backward()
        totals.append((fc.get_total_flops(), fc.get_flop_counts()["Global"]))
    (routed, by_op), (plain, _) = totals
    assert routed == plain
    # the weight gradients are counted by the custom op, 2 Cout Cin 27 B D H W
    vox = 2 * 5 * 4 * 6
    assert by_op[torch.ops.sv3d_tpu_torch.conv3d_wgrad] == 2 * 27 * vox * (8 * cin + 16 * 8)


def test_tracer_counts_the_convs_taken():
    model = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(0))
    grid = torch.rand(2, 9, 8, 10, 1)
    points = torch.rand(2, 16, 3) - 0.5
    profiling.reset()
    with profiling.enabled():
        model(grid, points).sum().backward()
        with torch.no_grad():
            model(grid, points)
    counters = profiling.records()["counters"]
    assert counters.get("ifnet.wgrad") == 9  # the 128 pyramid's nine convs
    assert counters.get("ifnet.wgrad_kernel", 0) == 0  # the plain version on the CPU
    profiling.reset()
    bf16 = IFNet(IFNetConfig.for_net_res(128), generator=torch.Generator().manual_seed(0),
                 dtype=torch.bfloat16)
    with profiling.enabled():
        bf16(grid, points).sum().backward()
    assert "ifnet.wgrad" not in profiling.records()["counters"]
    profiling.reset()


@pytest.mark.parametrize("shape,cout", [((4, 1, 139, 104, 112), 16), ((4, 16, 69, 52, 56), 32),
                                        ((4, 32, 139, 104, 112), 64), ((4, 64, 17, 13, 14), 128),
                                        ((4, 128, 8, 6, 7), 128), ((16, 1, 139, 104, 112), 16),
                                        ((3, 20, 5, 7, 9), 40), ((1, 3, 1, 1, 1), 8)])
def test_plan_fits_the_kernel(shape, cout):
    b, cin, d, h, w = shape
    co_t, ci_t, rs, _, _ = NARROW if cin < 16 else WIDE
    th, nsplit, parts = plan(shape, cout, 132)
    steps = b * d * -(-h // th)
    assert 1 <= th <= h and (th % rs == 0 or th == h)
    assert 1 <= nsplit <= min(steps, 65535) and parts == nsplit * rs
    assert smem_bytes(cin, th, w) <= SMEM_PER_BLOCK
    assert parts * cout * cin * 27 * 4 <= 60 * 2**20  # the partials' scratch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout", [((4, 1, 139, 104, 112), 16), ((4, 16, 69, 52, 56), 32),
                                        ((4, 128, 8, 6, 7), 128), ((3, 20, 5, 7, 9), 40)])
def test_kernel_matches_plain_on_card(cuda_device, shape, cout):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, device=cuda_device, generator=gen)
    dy = torch.randn((shape[0], cout, *shape[2:]), device=cuda_device, generator=gen)
    before = conv3d_wgrad_cuda.launches
    got = conv3d_wgrad(x, dy)
    assert conv3d_wgrad_cuda.launches == before + 1
    again = conv3d_wgrad_cuda(x, dy)
    assert conv3d_wgrad_cuda.launches == before + 2
    # held to the plain version in float64 on the same f32 inputs: the
    # kernel's f32 sums (split partials added in a fixed order) round, and
    # so does cuDNN's f32 weight gradient, by up to 1.1e-5 of a channel's
    # norm at stage 0's shape against float64 (the kernel: 1.4e-6)
    ref = conv3d_wgrad_plain(x.double(), dy.double())
    err = ((got.double() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).max()
    assert float(err) <= 1e-5
    assert torch.equal(got, again)  # a fixed order of sums: the same bits
    with pytest.raises(TypeError):
        conv3d_wgrad(x.double(), dy.double())


@pytest.mark.cuda
def test_route_on_card(cuda_device):
    torch.manual_seed(0)
    block = _ConvBlock(16, [32]).to(cuda_device)
    ref = _ConvBlock(16, [32]).to(cuda_device)
    ref.load_state_dict(block.state_dict())
    x = torch.randn((4, 16, 21, 20, 20), device=cuda_device)
    before = conv3d_wgrad_cuda.launches
    profiling.reset()
    with profiling.enabled():
        block(x).square().sum().backward()
    counters = profiling.records()["counters"]
    profiling.reset()
    assert counters.get("ifnet.wgrad") == 1
    assert counters.get("ifnet.wgrad_kernel") == 1
    assert conv3d_wgrad_cuda.launches - before == 1
    _unrouted_forward(ref, x).square().sum().backward()
    for a, b in zip(block.parameters(), ref.parameters()):
        err = float((a.grad - b.grad).norm() / b.grad.norm())
        assert err <= 1e-5  # f32 sums in other orders
