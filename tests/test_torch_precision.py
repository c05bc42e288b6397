"""Port parity of precision 16 (bf16 mixed precision) module by module:
sv3d_tpu_torch's BatchNorm, UNetMini, UNet and IFNet built with
dtype=torch.bfloat16 against the JAX package's flax modules with
dtype=jnp.bfloat16, from the same converted f32 weights.

Tolerances are in bf16 ulps of the output's scale (ulp = 2**(floor(log2
max|ref|) - 7), the spacing of bf16 values at the reference's largest
magnitude), as a maximum and a mean over the output.  The two frameworks
cannot agree bit for bit:

- a bf16 conv sums its products in another order in XLA than in torch's
  CPU convs, so some outputs round to the neighbouring bf16 value;
- in train mode BatchNorm divides by batch statistics that those one-ulp
  differences move; the small test grids leave 2-4 values per channel in
  the deepest IF-Net levels, so there the differences grow level by level;
- XLA on the CPU keeps excess precision inside a fusion that ends in f32
  (the gather query's bf16 corner sum before the concat with level 0), so
  the JAX package's compiled query does not round where its program does.
  Its uncompiled (eager) query rounds as written, and the port's query
  equals that one to f32 summation order (test_query_bf16_rounds_as_jax_
  writes_it).

Gradients are held as the cosine of each tensor against JAX's bf16
gradients.  The dtypes are JAX's: the UNet and levels 1.. bf16, level 0 and
the logits f32, parameters and their gradients f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from sv3d_tpu.config import IFNetConfig as JIFNetConfig
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu.models.unet import UNet as JUNet
from sv3d_tpu.models.unet import UNetMini as JUNetMini
from sv3d_tpu.models.unet import _upsample2x as j_upsample2x
from sv3d_tpu_torch.config import Config, IFNetConfig
from sv3d_tpu_torch.convert import from_flax
from sv3d_tpu_torch.models.batchnorm import BatchNorm
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.models.unet import UNet, UNetMini, _upsample2x
from sv3d_tpu_torch.ops.grid_sample import Pyramid
from test_torch_unet import randomized

torch.set_num_threads(1)
BF16 = torch.bfloat16


def bf16_ulp(ref) -> float:
    """The spacing of bf16 values at the largest magnitude of ref."""
    scale = float(np.abs(np.asarray(ref, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def assert_ulps(got, ref, max_ulps: float, mean_ulps: float, what: str = ""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref) / bf16_ulp(ref)
    assert err.max() <= max_ulps and err.mean() <= mean_ulps, (
        what, float(err.max()), float(err.mean()))


def cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def jnp32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_bf16_matches_flax(train):
    """flax's BatchNorm(dtype=bf16) on one bf16 input: statistics in f32,
    the output rounded to bf16 (at most 1 ulp apart: f32 reductions in
    another order), the running statistics f32 and within 1e-6."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 7)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                            "bias": rng.normal(0, 0.1, 6).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}}
    fbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.bfloat16)
    # flax normalizes the last axis: NHWC there, NCHW here
    out = fbn.apply(variables, jnp.moveaxis(xb, 1, -1), mutable=["batch_stats"] if train
                    else False)
    ref, mutated = out if train else (out, None)
    assert ref.dtype == jnp.bfloat16

    bn = BatchNorm(6, dtype=BF16)
    bn.load_state_dict({"weight": torch.tensor(variables["params"]["scale"]),
                        "bias": torch.tensor(variables["params"]["bias"]),
                        "running_mean": torch.tensor(variables["batch_stats"]["mean"]),
                        "running_var": torch.tensor(variables["batch_stats"]["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.tensor(x).to(BF16))
    assert got.dtype == BF16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    assert_ulps(got.float().permute(0, 2, 3, 1).numpy(), jnp32(ref), 1.0, 0.02)
    if train:
        for k, v in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(mutated["batch_stats"][v]), atol=1e-6)


def test_upsample_bf16_rounds_as_jax_resize():
    """A bf16 bilinear 2x equals jax.image.resize's bit for bit: the width
    first, rounded to bf16, then the height."""
    x = np.random.default_rng(1).normal(size=(2, 15, 20, 8)).astype(np.float32)
    ref = jnp32(jax.jit(j_upsample2x)(jnp.asarray(x).astype(jnp.bfloat16)))
    got = _upsample2x(torch.tensor(x).permute(0, 3, 1, 2).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), ref)


# (max, mean) ulps of the output's scale.  Eval mode: the convs' summation
# order only (measured: UNetMini 1.5 / 0.24, UNet 2.0 / 0.10).  Train mode:
# every BatchNorm divides by statistics of the bf16 activations above it
# (measured UNetMini 4.3 / 0.63, UNet 7.0 / 1.3).
UNET_ULPS = {("mini", False): (4.0, 0.5), ("mini", True): (8.0, 1.0),
             ("full", False): (4.0, 0.5), ("full", True): (12.0, 2.0)}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["mini", "full"])
def test_unet_bf16_matches_jax(kind, train):
    """UNetMini at 48x64 and UNet at 256x256 (B=2), eval and train mode:
    bf16 output, f32 parameters, running statistics f32 (train mode: within
    4 bf16 ulps of flax's, whose statistics see one-ulp different inputs)."""
    jcls, tcls, hw = {"mini": (JUNetMini, UNetMini, (48, 64)),
                      "full": (JUNet, UNet, (256, 256))}[kind]
    x = np.random.default_rng(2).uniform(-1, 1, (2, *hw, 3)).astype(np.float32)
    init = jax.jit(lambda k: jcls(channels_out=1).init(k, jnp.asarray(x), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 5)
    jm = jcls(channels_out=1, dtype=jnp.bfloat16)
    fn = jax.jit(lambda v, a: jm.apply(v, a, train=train,
                                       mutable=["batch_stats"] if train else False))
    out = fn(variables, jnp.asarray(x))
    ref, mutated = out if train else (out, None)
    assert ref.dtype == jnp.bfloat16

    tm = tcls(channels_out=1, dtype=BF16)
    tm.load_state_dict(from_flax(variables))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    assert got.dtype == BF16 and got.shape == (2, *hw, 1)
    assert_ulps(got.float().numpy(), jnp32(ref), *UNET_ULPS[kind, train], kind)
    if train:
        want = from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                mutated["batch_stats"])})
        sd = tm.state_dict()
        for k in want:
            if k.endswith(("running_mean", "running_var")):
                assert sd[k].dtype == torch.float32
                assert_ulps(sd[k].numpy(), want[k].numpy(), 4.0, 0.5, k)


def _ifnet_case(fused=False, b=2, dims=(17, 16, 18), seed=0):
    rng = np.random.default_rng(seed)
    grid = (rng.uniform(size=(b, *dims, 1)) > 0.8).astype(np.float32)
    pts = rng.uniform(-0.45, 0.45, (b, 64, 3)).astype(np.float32)
    jcfg = JIFNetConfig.for_net_res(128, fused_query=fused)
    init = jax.jit(lambda k: JIFNet(jcfg).init(k, jnp.asarray(grid), jnp.asarray(pts),
                                               train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 3)
    tm = IFNet(IFNetConfig.for_net_res(128, fused_query=fused), dtype=BF16)
    tm.load_state_dict(from_flax(variables))
    return grid, pts, JIFNet(jcfg, dtype=jnp.bfloat16), variables, tm


# per level 1..5 (max, mean) ulps of the level's scale, train mode: the
# batch statistics of each level see the one-ulp differences of the level
# above; levels 4 and 5 normalize 4-8 and 2 values per channel at these dims
# (measured 0.125/0.0, 1.0/0.005, 1.1/0.04, 3.0/0.16, 30/0.93).
ENCODE_TRAIN_ULPS = ((1.0, 0.01), (2.0, 0.02), (4.0, 0.1), (8.0, 0.4), (64.0, 2.0))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ifnet_encode_bf16_levels(train):
    """Level 0 is the f32 input grid, levels 1-5 bf16, each level against
    JAX's: eval mode within one ulp (measured equal), train mode per level
    as ENCODE_TRAIN_ULPS; the running statistics f32."""
    grid, _, jm, variables, tm = _ifnet_case()
    fn = jax.jit(lambda v, g: jm.apply(v, g, train=train, method=JIFNet.encode,
                                       mutable=["batch_stats"] if train else False))
    out = fn(variables, jnp.asarray(grid))
    ref = out[0] if train else out
    tm.train(train)
    with torch.no_grad():
        got = tm.encode(torch.tensor(grid))
    assert got.dims == ref.dims
    assert [f.dtype for f in got.flats] == [torch.float32] + [BF16] * 5
    assert [f.dtype for f in ref.flats] == [jnp.float32] + [jnp.bfloat16] * 5
    np.testing.assert_array_equal(got.flats[0].numpy(), np.asarray(ref.flats[0]))
    for li in range(1, 6):
        lim = ENCODE_TRAIN_ULPS[li - 1] if train else (1.0, 0.01)
        assert_ulps(got.flats[li].float().numpy(), jnp32(ref.flats[li]), *lim, f"level {li}")
    assert all(b.dtype in (torch.float32, torch.long) for b in tm.buffers())


def _eval_pyramids(jm, variables, grid, tm):
    jlev = jax.jit(lambda v, g: jm.apply(v, g, train=False, method=JIFNet.encode))(
        variables, jnp.asarray(grid))
    tm.eval()
    with torch.no_grad():
        tlev = tm.encode(torch.tensor(grid))
    return jlev, tlev


def test_query_bf16_rounds_as_jax_writes_it():
    """query() on a bf16 pyramid: the port's logits (f32) equal JAX's
    uncompiled query, which rounds the bf16 corner sums where its program
    does, to 1e-6 (f32 matmul order), and JAX's compiled query within 2 ulps
    max / 0.5 mean (measured 0.97 / 0.23: XLA's excess precision in the
    fused corner sum)."""
    grid, pts, jm, variables, tm = _ifnet_case()
    jlev, tlev = _eval_pyramids(jm, variables, grid, tm)
    with torch.no_grad():
        got = tm.query(tlev, torch.tensor(pts))
    assert got.dtype == torch.float32
    eager = np.asarray(jm.apply(variables, jlev, jnp.asarray(pts), method=JIFNet.query))
    compiled = np.asarray(jax.jit(lambda v, lv, p: jm.apply(v, lv, p, method=JIFNet.query))(
        variables, jlev, jnp.asarray(pts)))
    np.testing.assert_allclose(got.numpy(), eager, atol=1e-6)
    assert_ulps(got.numpy(), compiled, 2.0, 0.5)


def test_query_fused_bf16_pyramid_forward_and_grads():
    """query_fused (the --fused_query path, plain K4/K7/K8 here) on a bf16
    pyramid casts it to f32 at its boundary, as JAX's query_fused does, and
    is then the port's exact f32 query: its logits equal JAX's exact query
    of the same pyramid widened to f32 to 1e-5 (f32 summation order).  The
    level's gradient comes back bf16; the parameters' gradients (f32) and the
    points' gradient are aligned with JAX's precision-16 fused path (its
    Pallas query in bf16 compute, interpret mode) by cosine > 0.98 each, the
    bound tests/test_torch_ifnet.py holds the f32 path's gradients to.  Eval
    mode, so the two pyramids are equal (test_ifnet_encode_bf16_levels)."""
    grid, pts, jm, variables, tm = _ifnet_case(fused=True)
    occ = (np.random.default_rng(5).uniform(size=pts.shape[:2]) > 0.5).astype(np.float32)

    def jloss(params, p):
        logits = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(grid), p, train=False)
        return jnp.mean((jax.nn.sigmoid(logits) - occ) ** 2)

    jg, jgp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables["params"], jnp.asarray(pts))
    jlev, _ = _eval_pyramids(jm, variables, grid, tm)
    widened = type(jlev)([f.astype(jnp.float32) for f in jlev.flats], jlev.dims)
    exact = np.asarray(jax.jit(lambda v, lv, p: jm.apply(v, lv, p, method=JIFNet.query))(
        variables, widened, jnp.asarray(pts)))

    p = torch.tensor(pts, requires_grad=True)
    levels = tm.encode(torch.tensor(grid))
    for f in levels.flats[1:]:
        f.retain_grad()
    logits = tm.query_fused(levels, p)
    torch.mean((torch.sigmoid(logits) - torch.tensor(occ)) ** 2).backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), exact, atol=1e-5)
    assert all(f.grad.dtype == BF16 for f in levels.flats[1:])
    want = from_flax({"params": jax.tree_util.tree_map(np.asarray, jg)})
    for name, prm in tm.named_parameters():
        assert prm.grad.dtype == torch.float32, name
        assert cosine(prm.grad.numpy(), want[name].numpy()) > 0.98, name
    assert cosine(p.grad.numpy(), np.asarray(jgp)) > 0.98


def test_query_lattice_bf16_pyramid():
    """The sweep on a bf16 pyramid: the bf16 plan reads it with no second
    rounding (the same logits as the f32-widened pyramid, bit for bit) and
    holds JAX's bf16 sweep of its own bf16 pyramid at 2e-2 on the sigmoid
    (the JAX package's mixed-precision bound); the f32 plan widens it."""
    dims = (17, 16, 18)
    grid, _, jm, variables, tm = _ifnet_case(b=1, dims=dims)
    jlev, tlev = _eval_pyramids(jm, variables, grid, tm)
    widened = Pyramid([f.float() for f in tlev.flats], tlev.dims)
    sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    with torch.inference_mode():
        got = tm.query_lattice(tlev, dims, 1, 4, 4)
        assert torch.equal(got, tm.query_lattice(widened, dims, 1, 4, 4))
        f32 = tm.query_lattice(tlev, dims, 1, 4, 4, torch.float32)
        assert torch.equal(f32, tm.query_lattice(widened, dims, 1, 4, 4, torch.float32))
    ref = np.asarray(jax.jit(lambda v, lv: jm.apply(v, lv, dims, 1, 4, 4,
                                                    method=JIFNet.query_lattice,
                                                    use_pallas_mlp=False, fused_tail=False))(
        variables, jlev))
    np.testing.assert_allclose(sig(got.numpy()), sig(ref), atol=2e-2)


# -- the port's counterparts of tests/test_precision.py ----------------------

def test_unet_bf16_compute_f32_params():
    model = UNetMini(channels_out=1, dtype=BF16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        y = model.eval()(torch.zeros((1, 240, 320, 3)))
    assert y.dtype == BF16 and torch.isfinite(y.float()).all()


def test_ifnet_bf16_close_to_f32():
    cfg = IFNetConfig.for_net_res(32)
    grid = torch.tensor(np.random.default_rng(0).normal(size=(1, 8, 8, 8, 1)), dtype=torch.float32)
    pts = torch.tensor(np.random.default_rng(1).uniform(-0.4, 0.4, (1, 16, 3)),
                       dtype=torch.float32)
    m32 = IFNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    m16 = IFNet(cfg, dtype=BF16).eval()
    m16.load_state_dict(m32.state_dict())
    with torch.no_grad():
        out32, out16 = m32(grid, pts), m16(grid, pts)
    assert out16.dtype == torch.float32
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), rtol=0.1, atol=0.1)


def test_config_precision_dtype():
    assert Config(precision=32).dtype == torch.float32
    assert Config(precision=16).dtype == BF16


def test_fused_query_accepts_bf16_pyramid():
    """precision 16 + fused_query: forward and gradients flow through the f32
    kernel interface, the loss close to the f32 model's, the gradients f32,
    finite and aligned with the f32 model's (cosine > 0.95)."""
    rng = np.random.default_rng(0)
    grid = torch.tensor((rng.uniform(size=(1, 18, 13, 14, 1)) > 0.9).astype(np.float32))
    pts0 = rng.uniform(-0.45, 0.45, (1, 64, 3)).astype(np.float32)
    occ = torch.tensor((rng.uniform(size=(1, 64)) > 0.5).astype(np.float32))
    cfg = IFNetConfig.for_net_res(32, fused_query=True)
    m32 = IFNet(cfg, generator=torch.Generator().manual_seed(3)).eval()
    m16 = IFNet(cfg, dtype=BF16).eval()
    m16.load_state_dict(m32.state_dict())
    out = {}
    for name, m in (("32", m32), ("16", m16)):
        p = torch.tensor(pts0, requires_grad=True)
        loss = torch.mean((torch.sigmoid(m(grid, p)) - occ) ** 2)
        loss.backward()
        out[name] = (float(loss), m.fc0.weight.grad, p.grad)
    assert np.isfinite(out["16"][0])
    np.testing.assert_allclose(out["16"][0], out["32"][0], rtol=0.05, atol=0.01)
    assert all(p.grad.dtype == torch.float32 for p in m16.parameters())
    assert torch.isfinite(out["16"][1]).all()
    assert cosine(out["16"][1].numpy(), out["32"][1].numpy()) > 0.95
    assert cosine(out["16"][2].numpy(), out["32"][2].numpy()) > 0.95
