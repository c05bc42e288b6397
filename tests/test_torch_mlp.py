"""K3's operands and width check (sv3d_tpu_torch/ops/cuda/mlp.py) on the CPU.

mlp_operands lays the decoder's weights out as the K3 kernels read them:
un-permuting the bf16 fragment-order fc0 with layouts.py's index gives back
the rounded weight with zero pad rows; the operands do not change what the
wrapper computes, and operands made from other weights, or from weights
changed in place since, raise; bf16 takes IF-Net's widths only.  The kernels themselves
are held to the plain version on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from sv3d_tpu_torch.config import IFNetConfig
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.layouts import fragment_order, matches_record
from sv3d_tpu_torch.ops.cuda.mlp import check_bf16_widths, fused_point_mlp, mlp_operands
from sv3d_tpu_torch.ops.mlp import fused_point_mlp_plain, rounded

torch.set_num_threads(1)


def _decoder(net_res, seed=None):
    model = IFNet(IFNetConfig.for_net_res(net_res),
                  generator=torch.Generator().manual_seed(net_res if seed is None else seed)).eval()
    return model, [t.detach() for layer in model.mlp for t in layer]


def _unpermute(frags, n_out, k):
    """The (n_out, k) matrix whose mma_b_fragments are frags."""
    back = torch.zeros(n_out * k, dtype=frags.dtype)
    back[torch.from_numpy(fragment_order(n_out, k).reshape(-1))] = frags.reshape(-1)
    return back.reshape(n_out, k)


@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_operands_bf16_layout(net_res):
    """bf16: fc0 (2583 -> 256 or 2247 -> 512) rounded, padded to 2592 / 2256
    rows of K with zeros, in fragment order; fc1, fc2 likewise unpadded;
    fc_out's weight rounded and flat in f32; the biases f32 copies."""
    model, ws = _decoder(net_res)
    w0, b0, w1, b1, w2, b2, w3, b3 = ws
    ops = mlp_operands(ws, torch.bfloat16)
    h0, n_feat = w0.shape
    kpad = -(-n_feat // 16) * 16
    assert kpad % 16 == 0 and 0 < kpad - n_feat < 16  # F is no multiple of 16 here
    w0f, w1f, w2f, w3r = ops.weights
    assert w0f.dtype == torch.bfloat16 and w0f.shape == (kpad // 16, h0 // 16, 32, 8)
    w0u = _unpermute(w0f, h0, kpad)
    assert torch.equal(w0u[:, :n_feat].float(), rounded(w0))
    assert not w0u[:, n_feat:].float().any()
    for frag, w in ((w1f, w1), (w2f, w2)):
        assert torch.equal(_unpermute(frag, *w.shape).float(), rounded(w))
    assert w3r.dtype == torch.float32 and torch.equal(w3r, rounded(w3).reshape(-1))
    for got, b in zip(ops.biases, (b0, b1, b2, b3)):
        assert got.dtype == torch.float32 and got.is_contiguous() and torch.equal(got, b)
    assert ops.compute_dtype == torch.bfloat16
    assert len(ops.made_from) == 8
    assert all(matches_record(rec, t) for rec, t in zip(ops.made_from, ws))


@pytest.mark.parametrize("net_res", [128, 32])
def test_mlp_operands_f32_layout(net_res):
    """float32: the transposed (in, out) fc0, fc1, fc2, contiguous, and
    fc_out's weight as it is, all unrounded."""
    _, ws = _decoder(net_res)
    ops = mlp_operands(ws, torch.float32)
    for got, w in zip(ops.weights[:3], ws[0:6:2]):
        assert got.is_contiguous() and torch.equal(got, w.t())
    assert torch.equal(ops.weights[3], ws[6])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("net_res", [128, 32])
def test_operands_leave_the_cpu_result_unchanged(net_res, dtype):
    """fused_point_mlp with operands=mlp_operands(...) on CPU tensors equals
    the call without them and the plain version, bit for bit; operands made
    for the other dtype or other weights raise ValueError."""
    model, ws = _decoder(net_res)
    f = torch.tensor(np.random.default_rng(net_res).standard_normal(
        (model.feature_size, 1001)).astype(np.float32))
    with torch.inference_mode():
        ops = mlp_operands(ws, dtype)
        got = fused_point_mlp(f, *ws, compute_dtype=dtype, operands=ops)
        assert torch.equal(got, fused_point_mlp(f, *ws, compute_dtype=dtype))
        assert torch.equal(got, fused_point_mlp_plain(f, *ws, compute_dtype=dtype))
        other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
        with pytest.raises(ValueError, match="operands"):
            fused_point_mlp(f, *ws, compute_dtype=dtype, operands=mlp_operands(ws, other))
        _, ws_other = _decoder(128 if net_res == 32 else 32)
        with pytest.raises(ValueError, match="operands"):
            fused_point_mlp(f, *ws, compute_dtype=dtype,
                            operands=mlp_operands(ws_other, dtype))


@pytest.mark.parametrize("widths", [(128, 256, 256), (1024, 256, 256), (256, 512, 256),
                                    (512, 256, 128), (272, 256, 256)])
def test_bf16_width_check_raises(widths):
    """check_bf16_widths takes IF-Net's two decoders and raises ValueError on
    any other widths, as mlp_operands in bf16 does; float32 operands take
    them."""
    check_bf16_widths(256, 256, 256)
    check_bf16_widths(512, 256, 256)
    with pytest.raises(ValueError, match="hidden widths"):
        check_bf16_widths(*widths)
    h0, h1, h2 = widths
    rng = np.random.default_rng(0)
    ws = [torch.tensor(rng.standard_normal(s).astype(np.float32))
          for s in ((h0, 40), (h0,), (h1, h0), (h1,), (h2, h1), (h2,), (1, h2), (1,))]
    with pytest.raises(ValueError, match="hidden widths"):
        mlp_operands(ws, torch.bfloat16)
    assert mlp_operands(ws, torch.float32).weights[0].shape == (40, h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["other_weights", "in_place"])
def test_stale_operands_raise(case, dtype):
    """Operands made from the weights of another IF-Net of the same config
    (same shapes, other values), or from these weights before an in-place
    update, raise ValueError instead of decoding with the weights they
    hold; operands made anew after the update serve the call."""
    model, ws = _decoder(32)
    f = torch.tensor(np.random.default_rng(1).standard_normal(
        (model.feature_size, 70)).astype(np.float32))
    if case == "other_weights":
        _, ws_other = _decoder(32, seed=33)
        assert all(a.shape == b.shape for a, b in zip(ws, ws_other))
        stale = mlp_operands(ws_other, dtype)
    else:
        stale = mlp_operands(ws, dtype)
        with torch.no_grad():
            model.mlp[1][0].mul_(0.5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="stale"):
            fused_point_mlp(f, *ws, compute_dtype=dtype, operands=stale)
        got = fused_point_mlp(f, *ws, compute_dtype=dtype, operands=mlp_operands(ws, dtype))
        assert torch.equal(got, fused_point_mlp_plain(f, *ws, compute_dtype=dtype))
