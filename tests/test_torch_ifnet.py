"""Port parity: IF-Net encode, the point queries and the dense-lattice query
of sv3d_tpu_torch against sv3d_tpu, from converted weights.

The dims are those of tests/test_pallas_sweep.py: (17, 16, 18) at net_res 128
(align_corners=False) and (12, 9, 10) at net_res 32 (align_corners=True);
both pool a size-1 dim through the -inf pad.  Conv and contraction sums run
in another order than XLA's: atol 1e-4 on features and logits (the port's
sweep at compute_dtype=torch.float32).  Against JAX's default bf16 sweep the
bound is the JAX package's own mixed-precision one, atol 2e-2 on sigmoid
(tests/test_pallas_sweep.py), for the port's f32 sweep and for its bf16
sweep (the default, fused and unfused); the port's unfused bf16 sweep (K3 in
bf16) against JAX's unfused bf16 sweep at 2e-3.  A sweep plan refuses
levels or weights other than those it was made from.  The port's point
queries (the gather path and the f32 fused path) are held to JAX's exact
query() at 1e-5, and to JAX's bf16 fused path by gradient cosine > 0.98
(tests/test_pallas_query_bwd.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sv3d_tpu.config import IFNetConfig
from sv3d_tpu.models.ifnet import IFNet as JIFNet
from sv3d_tpu_torch.convert import from_flax
from test_torch_unet import randomized
from sv3d_tpu_torch.models.ifnet import IFNet
from sv3d_tpu_torch.ops.cuda.sweep import (
    SweepPlan,
    lattice_sweep,
    lattice_sweep_bf16_cuda,
    lattice_sweep_f32_cuda,
    lattice_sweep_plain,
)

torch.set_num_threads(1)

CASES = [(128, (17, 16, 18)), (32, (12, 9, 10))]


def _models(net_res, dims):
    cfg = IFNetConfig.for_net_res(net_res)
    grid = np.random.default_rng(net_res).normal(size=(1, *dims, 1)).astype(np.float32)
    jm = JIFNet(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(grid), jnp.zeros((1, 8, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 7)
    tm = IFNet(cfg)
    tm.load_state_dict(from_flax(variables))
    return cfg, grid, jm, variables, tm.eval()


@pytest.fixture(scope="module", params=CASES, ids=["net128", "net32"])
def case(request):
    net_res, dims = request.param
    cfg, grid, jm, variables, tm = _models(net_res, dims)
    jlev = jax.jit(lambda v, g: jm.apply(v, g, train=False, method=JIFNet.encode))(
        variables, jnp.asarray(grid))
    with torch.inference_mode():
        tlev = tm.encode(torch.tensor(grid))
    return dims, jm, variables, tm, jlev, tlev


def test_encode_levels(case):
    _, _, _, _, ref, got = case
    assert got.dims == ref.dims
    for (gf, _), (rf, _) in zip(got, ref):
        np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=1e-4)


def test_encode_pads_size_one_dims_before_pooling():
    """(17, 13, 14) pools to a (2, 1, 1) level, whose pooling needs the -inf
    pad to give a (1, 1, 1) level instead of an empty one."""
    _, grid, jm, variables, tm = _models(128, (17, 13, 14))
    ref = jm.apply(variables, jnp.asarray(grid), train=False, method=JIFNet.encode)
    with torch.inference_mode():
        got = tm.encode(torch.tensor(grid))
    assert got.dims == ref.dims
    assert got.dims[-2:] == ((2, 1, 1), (1, 1, 1))
    for (gf, _), (rf, _) in zip(got, ref):
        np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=1e-4)


def test_query_lattice_matches_both_jax_sweeps(case):
    """res_increase 2; slabs: interior (rows 2-3), the last full slab, and
    the last slab of 5, which runs past the lattice into padded rows (slab
    offsets are multiples of the slab size, as the sweep issues them)."""
    dims, jm, variables, tm, jlev, tlev = case
    r0 = 2 * dims[0]
    sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    sweeps = {}
    for slab, off in ((2, 2), (2, r0 - 2), (5, (-(-r0 // 5) - 1) * 5)):
        with torch.inference_mode():
            got = tm.query_lattice(tlev, dims, 2, slab, off, torch.float32).numpy()
        assert got.shape == (1, slab, 2 * dims[1], 2 * dims[2])
        for name, kw in (
            ("unfused", dict(compute_dtype=jnp.float32, fused_tail=False)),
            ("fused", dict(compute_dtype=jnp.float32, fused_tail=True)),  # Pallas, interpret
            ("bf16", dict(fused_tail=False)),  # the JAX default compute dtype
        ):
            key = (name, slab)
            if key not in sweeps:
                sweeps[key] = jax.jit(lambda v, lv, o, kw=kw, slab=slab: jm.apply(
                    v, lv, dims, 2, slab, o, method=JIFNet.query_lattice,
                    use_pallas_mlp=False, **kw))
            ref = np.asarray(sweeps[key](variables, jlev, jnp.asarray(off, jnp.int32)))
            if name == "bf16":
                np.testing.assert_allclose(sig(got), sig(ref), atol=2e-2, err_msg=f"{key} {off}")
            else:
                np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"{key} {off}")


def _jax_sweep(jm, variables, jlev, dims, slab, off, **kw):
    return np.asarray(jax.jit(lambda v, lv, o: jm.apply(
        v, lv, dims, 2, slab, o, method=JIFNet.query_lattice, use_pallas_mlp=False, **kw))(
            variables, jlev, jnp.asarray(off, jnp.int32)))


@pytest.mark.parametrize("fused_tail", [True, False], ids=["fused", "unfused"])
def test_query_lattice_bf16_matches_jax_bf16_sweeps(case, fused_tail):
    """The port's bf16 sweep (the default compute_dtype), fused (K2's plain
    version) and unfused (fused_tail=False), against JAX's bf16 sweep fused
    (Pallas, interpret) and unfused: atol 2e-2 on the sigmoid, the JAX
    package's own bound (tests/test_pallas_sweep.py); unfused against
    unfused, both rounding levels, features, weights and hidden activations
    to bf16 (the port's K3 in bf16), atol 2e-3 (measured up to 7.7e-4: JAX's
    resizes round after each axis, the port's feature once).  An interior
    slab and the last slab of 5, past the lattice end."""
    dims, jm, variables, tm, jlev, tlev = case
    r0 = 2 * dims[0]
    sig = lambda x: 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))
    for slab, off in ((2, 2), (5, (-(-r0 // 5) - 1) * 5)):
        with torch.inference_mode():
            got = tm.query_lattice(tlev, dims, 2, slab, off, fused_tail=fused_tail).numpy()
        assert got.shape == (1, slab, 2 * dims[1], 2 * dims[2]) and np.isfinite(got).all()
        for jax_fused in (True, False):
            ref = _jax_sweep(jm, variables, jlev, dims, slab, off, fused_tail=jax_fused)
            atol = 2e-3 if not (fused_tail or jax_fused) else 2e-2
            np.testing.assert_allclose(sig(got), sig(ref), atol=atol,
                                       err_msg=f"jax fused_tail={jax_fused} {slab}+{off}")


def test_cpu_levels_take_the_plain_sweep():
    """A plan on CPU levels runs the plain version of its compute dtype (no
    kernel launch counted), and query_lattice refuses a plan made for
    another dtype."""
    cfg, grid, _, _, tm = _models(*CASES[1])
    with torch.inference_mode():
        lev = tm.encode(torch.tensor(grid))
        before = (lattice_sweep_f32_cuda.launches, lattice_sweep_bf16_cuda.launches)
        for dtype in (torch.float32, torch.bfloat16):
            plan = SweepPlan(lev, tm.mlp, (12, 9, 10), cfg.align_corners, cfg.displacement, dtype)
            a = lattice_sweep(plan, 3, 4)
            b = lattice_sweep_plain(lev, tm.mlp, (12, 9, 10), 3, 4, cfg.align_corners,
                                    cfg.displacement, dtype)
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert (lattice_sweep_f32_cuda.launches, lattice_sweep_bf16_cuda.launches) == before
        with pytest.raises(ValueError):
            tm.query_lattice(lev, (12, 9, 10), 1, 3, 4, torch.float32, plan=plan)


def _plan_case(dtype):
    cfg, grid, _, _, tm = _models(*CASES[1])
    with torch.inference_mode():
        lev = tm.encode(torch.tensor(grid))
        plan = tm.sweep_plan(lev, (12, 9, 10), 1, dtype)
    return tm, lev, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stale_plan_raises_after_an_in_place_weight_update(dtype):
    """query_lattice(plan=) after an in-place update of a weight the plan was
    made from raises ValueError; the plan itself holds copies, so its own
    field is the one from before the update."""
    tm, lev, plan = _plan_case(dtype)
    with torch.inference_mode():
        before = tm.query_lattice(lev, (12, 9, 10), 1, 12, 0, dtype, plan=plan)
    with torch.no_grad():
        tm.fc1.weight.mul_(1.5)
    with torch.inference_mode(), pytest.raises(ValueError, match="stale"):
        tm.query_lattice(lev, (12, 9, 10), 1, 12, 0, dtype, plan=plan)
    with torch.inference_mode():
        assert torch.equal(lattice_sweep(plan, 12, 0), before)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_from_another_pyramid_raises(dtype):
    """A plan made from one pyramid refuses another one, even of the same
    shapes, and a level list of another length."""
    tm, lev, plan = _plan_case(dtype)
    with torch.inference_mode():
        other = tm.encode(torch.zeros((1, 12, 9, 10, 1)))
        for levels in (other, list(lev)[:-1]):
            with pytest.raises(ValueError, match="stale"):
                tm.query_lattice(levels, (12, 9, 10), 1, 12, 0, dtype, plan=plan)
        tm.query_lattice(lev, (12, 9, 10), 1, 12, 0, dtype, plan=plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fresh_plan_gives_the_updated_field(dtype):
    """After an in-place weight update a new plan gives the updated weights'
    field: the plain sweep's on the new weights, and not the old field."""
    tm, lev, plan = _plan_case(dtype)
    cfg = tm.config
    with torch.inference_mode():
        old = lattice_sweep(plan, 12, 0)
    with torch.no_grad():
        tm.fc0.bias.add_(0.25)
        tm.fc2.weight.mul_(-1.0)
    with torch.inference_mode():
        fresh = tm.sweep_plan(lev, (12, 9, 10), 1, dtype)
        got = tm.query_lattice(lev, (12, 9, 10), 1, 12, 0, dtype, plan=fresh)
        want = lattice_sweep_plain(lev, tm.mlp, (12, 9, 10), 12, 0, cfg.align_corners,
                                   cfg.displacement, dtype)
    assert torch.equal(got, want)
    assert not torch.equal(got, old)


def test_point_queries_match_jax_query(case):
    """query (gather) and query_fused (plain K4 on the CPU) against JAX's
    exact query(); points include some outside the volume."""
    dims, jm, variables, tm, jlev, tlev = case
    pts = np.random.default_rng(9).uniform(-0.55, 0.55, (1, 300, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, lv, p: jm.apply(v, lv, p, method=JIFNet.query))(
        variables, jlev, jnp.asarray(pts)))
    with torch.no_grad():
        for got in (tm.query(tlev, torch.tensor(pts)), tm.query_fused(tlev, torch.tensor(pts))):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_fused_forward_grads_match_jax_exact_and_fused():
    """IFNet.forward with fused_query True against JAX (the configuration of
    tests/test_pallas_query_bwd.py): the port's f32 fused path has the
    gradients of JAX's exact path (1e-4 relative), and is aligned with JAX's
    bf16 fused path (cosine > 0.98)."""
    grid = (np.random.default_rng(0).uniform(0, 1, (1, 18, 13, 14, 1)) > 0.9).astype(np.float32)
    pts = np.random.default_rng(1).uniform(-0.45, 0.45, (1, 64, 3)).astype(np.float32)
    occ = (np.random.default_rng(2).uniform(0, 1, (1, 64)) > 0.5).astype(np.float32)

    def jax_grads(fused):
        model = JIFNet(IFNetConfig.for_net_res(32, fused_query=fused))
        variables = model.init(jax.random.PRNGKey(3), jnp.asarray(grid), jnp.asarray(pts),
                               train=False)

        def loss(v, p):
            logits = model.apply(v, jnp.asarray(grid), p, train=False)
            return jnp.mean((jax.nn.sigmoid(logits) - occ) ** 2)

        g = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables, jnp.asarray(pts))
        return variables, np.asarray(g[0]["params"]["fc0_kernel"]), np.asarray(g[1])

    variables, fc0_exact, pts_exact = jax_grads(False)
    _, fc0_fused, pts_fused = jax_grads(True)

    tm = IFNet(IFNetConfig.for_net_res(32, fused_query=True))
    tm.load_state_dict(from_flax(variables))
    tm.eval()
    p = torch.tensor(pts, requires_grad=True)
    loss = torch.mean((torch.sigmoid(tm(torch.tensor(grid), p)) - torch.tensor(occ)) ** 2)
    loss.backward()
    got = {"fc0": tm.fc0.weight.grad.numpy(), "points": p.grad.numpy()}
    for name, exact, fused in (("fc0", fc0_exact, fc0_fused), ("points", pts_exact, pts_fused)):
        np.testing.assert_allclose(got[name], exact, atol=1e-4 * np.abs(exact).max(),
                                   err_msg=name)
        a, b = got[name].ravel(), fused.ravel()
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.98, name


def test_train_mode_encode_batch_stats_follow_flax():
    """One train-mode encode at B=2: levels agree (rtol/atol 1e-4: flax takes
    the batch variance as E[x^2] - E[x]^2, torch in two passes), and the
    running statistics equal flax's mutated batch_stats to 1e-6 (biased batch
    variance)."""
    cfg = IFNetConfig.for_net_res(128)
    grid = np.random.default_rng(6).normal(size=(2, 17, 16, 18, 1)).astype(np.float32)
    jm = JIFNet(cfg)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(grid), jnp.zeros((2, 8, 3)), train=False))
    variables = randomized(init(jax.random.PRNGKey(0)), 8)
    ref, mutated = jax.jit(lambda v, g: jm.apply(v, g, train=True, method=JIFNet.encode,
                                                 mutable=["batch_stats"]))(
        variables, jnp.asarray(grid))
    tm = IFNet(cfg)
    tm.load_state_dict(from_flax(variables))
    tm.train()
    with torch.no_grad():
        got = tm.encode(torch.tensor(grid))
    for (gf, _), (rf, _) in zip(got, ref):
        np.testing.assert_allclose(gf.numpy(), np.asarray(rf), rtol=1e-4, atol=1e-4)
    want = from_flax({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
    state = tm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 10
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)
