"""3DShape2VecSet's occupancy autoencoder in the port (models/vecset.py,
SceneNet and its trainer under Config(decoder="vecset")): held to the
benchmark's plain reference (benchmark/arch/vecset.py, with
reference/scene.py's UNetMini and back-projection and reference/train.py's
loss and Adam) in float64 on the CPU, where rounding leaves nothing to hide
a difference; the input lattice pinned at 320x240; the Fourier basis kept
out of the state dict; the CLI and the paths that serve the IF-Net's field
refusing it; the tracer's spans and counter; the benchmark's count of a
step's operations against FlopCounterMode's.  Imports nothing of JAX.  One
test needs the card: the fused attention computes in float32, not TF32."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.arch import vecset as ref_arch  # noqa: E402
from benchmark.frozen import scenes  # noqa: E402
from benchmark.frozen.weights import seeded_state_dict  # noqa: E402
from benchmark.reference import compare, scene  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference.lowp import EXACT, TRAIN_CONTROL  # noqa: E402
from sv3d_tpu_torch.config import Config, VecSetConfig  # noqa: E402
from sv3d_tpu_torch.geometry import FrustumGrid, parse_intrinsics  # noqa: E402
from sv3d_tpu_torch.models.scene_net import SceneNet  # noqa: E402
from sv3d_tpu_torch.models.vecset import VecSet, lattice_index, seed_index  # noqa: E402
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset  # noqa: E402
from sv3d_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)

DT = torch.float64
#: float64 on both sides: the same exact arithmetic in two orders
RTOL = 1e-10
#: the configuration at a size the CPU runs in seconds: 2 blocks of 2 x 16
#: heads at width 32, a 16 x 8 lattice (128 inputs, 32 latents), the frustum
#: at a quarter resolution
SMALL = dict(dim=32, depth=2, heads=2, dim_head=16, queries_dim=32, input_lattice=[16, 8],
             num_inputs=128, num_latents=32, dims=[35, 26, 28], voxel_size=0.2)
SMALL_VECSET = VecSetConfig(dim=32, depth=2, heads=2, lattice=(16, 8))
H, W = 240, 320


def _cfg(**kw) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "vecset_ae_d512_m512.json").read_text())
    return {**cfg, **SMALL, **kw}


def _rel(a, b, floor: float = 1e-300) -> float:
    return float((a - b).norm() / max(float(b.norm()), floor))


def test_vecset_matches_the_reference_in_float64():
    """A 320x240 cloud, B=2, 32 queries: the logits, every leaf's gradient
    and the cloud's."""
    cfg = _cfg()
    model = VecSet(SMALL_VECSET, generator=torch.Generator().manual_seed(0))
    sd = seeded_state_dict({f"vecset.{k}": v for k, v in model.state_dict().items()}, None, 5,
                           "cpu")
    model.load_state_dict({k[len("vecset."):]: v for k, v in sd.items()})
    model = model.to(DT)
    sd = {k: v.to(DT).requires_grad_(True) for k, v in sd.items()}
    gen = torch.Generator().manual_seed(1)
    cloud = torch.rand(2, H * W, 3, generator=gen, dtype=DT) - 0.5
    points = torch.rand(2, 32, 3, generator=gen, dtype=DT) - 0.5
    c_p, c_r = cloud.clone().requires_grad_(True), cloud.clone().requires_grad_(True)
    got = model(c_p, points, (H, W))
    want = ref_arch.occupancy_logits(sd, cfg, c_r, points)
    assert got.shape == (2, 32)
    assert _rel(got.detach(), want.detach()) < RTOL
    w = torch.randn(got.shape, generator=gen, dtype=DT)
    (got * w).sum().backward()
    (want * w).sum().backward()
    for k, p in model.named_parameters():
        assert _rel(p.grad, sd[f"vecset.{k}"].grad) < RTOL, k
    # only the lattice's pixels take a gradient
    assert int((c_p.grad.abs().sum(-1) > 0).sum()) == 2 * 128
    assert _rel(c_p.grad, c_r.grad) < RTOL


def test_trainer_step_matches_the_reference_in_float64(tmp_path):
    """One step of the trainer's train_step (the function SceneNetTrainer's
    calls on the loader's batch, to_device aside) through SceneNet with
    UNetMini on a batch of the benchmark's rooms, against
    reference/train.py's step from the same state: the loss, and each leaf's
    change under Adam."""
    from sv3d_tpu_torch.training.optim import build_optimizer
    from sv3d_tpu_torch.training.state import TrainState
    from sv3d_tpu_torch.training.trainer_scene_net import train_step

    cfg = _cfg()
    config = ref_arch.port_config(cfg, num_points=16, batch_size=2, seed=1)
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(config, intr, FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    ref_arch.check_widths(model, cfg)
    sd = seeded_state_dict(model.state_dict(), None, 12, "cpu")
    model.load_state_dict(sd)
    model = model.to(DT)
    state = TrainState(model, build_optimizer(config.lr, model))
    assert len(state.optimizer.param_groups) == 1  # no sigma group
    sd = {k: v.to(DT) if v.is_floating_point() else v for k, v in sd.items()}
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    rooms = scenes.write_train_tree(12, 2, tmp_path, "s", scale, shift, cfg["dims"], 300)
    hb = ref_train.batch_at(rooms, 12, 2, 16, scenes.FOCAL, 0)
    hb = {k: v.astype(np.float64) for k, v in hb.items()}
    batch = {"rgb": torch.as_tensor(hb["rgb"]), "depthmap_target": torch.as_tensor(hb["depth"]),
             "points": torch.as_tensor(hb["points"]),
             "occupancies": torch.as_tensor(hb["occupancies"])}
    metrics = train_step(state, batch, config)
    assert not [k for k in metrics if "sigma" in k]
    cam = (scenes.FOCAL, scenes.CX, scenes.CY, scale.astype(np.float64),
           shift.astype(np.float64))
    ref = ref_train.step_from(sd, {}, cfg, hb, cam, "cpu")
    loss_p = float(metrics["train_loss"])
    assert abs(loss_p - ref["loss"]) <= RTOL * abs(ref["loss"])
    change = {k: float((p.detach() - sd[k]).norm()) for k, p in model.named_parameters()}
    assert set(change) == set(ref["change_norms"])
    # the UNet biases before a train-mode BatchNorm have a gradient of
    # exactly 0; Adam divides the rounding residue on each side by its own
    # norm, so they move by noise (a millionth of the others) and are held
    # out as the benchmark holds them out (compare.kept_leaves)
    keep = compare.kept_leaves(ref["grad_norms"])
    largest = max(ref["change_norms"].values())
    for k, v in ref["change_norms"].items():
        if k in keep:
            assert abs(change[k] - v) <= RTOL * v, k
        else:
            assert k.startswith("unet.") and max(change[k], v) < 1e-6 * largest, k


def test_the_lattice_is_pinned_at_320x240():
    """The 2048 inputs: pixel (floor(7.5 i + 3.75), 5 j + 2), row-major over
    i < 32, j < 64; the 512 seeds those with i and j both even; the
    reference's own indices the same."""
    got = lattice_index(240, 320, 32, 64)
    want = [math.floor(7.5 * i + 3.75) * 320 + 5 * j + 2 for i in range(32) for j in range(64)]
    assert got.tolist() == want
    seeds = seed_index(32, 64)
    assert got[seeds].tolist() == [math.floor(7.5 * i + 3.75) * 320 + 5 * j + 2
                                   for i in range(0, 32, 2) for j in range(0, 64, 2)]
    full = json.loads((ROOT / "benchmark" / "configs" / "vecset_ae_d512_m512.json").read_text())
    inputs, ref_seeds = ref_arch.lattice(full)
    assert inputs == want and ref_seeds == got[seeds].tolist()
    assert (VecSetConfig().num_inputs, VecSetConfig().num_latents) == (2048, 512)
    # the first row and column, the last row and column
    assert (want[0], want[63], want[-64], want[-1]) == (3 * 320 + 2, 3 * 320 + 317,
                                                       236 * 320 + 2, 236 * 320 + 317)


def test_the_fourier_basis_is_a_constant_out_of_the_state_dict():
    model = VecSet(SMALL_VECSET, generator=torch.Generator().manual_seed(0))
    assert not [k for k in model.state_dict() if "basis" in k]
    assert [k for k, _ in model.named_buffers()] == ["point_embed.basis"]
    basis = model.point_embed.basis
    assert basis.dtype == DT
    freqs = math.pi * 2.0 ** torch.arange(8, dtype=DT)
    for a in range(3):
        assert torch.equal(basis[a, 8 * a:8 * (a + 1)], freqs)
        assert int((basis[a] != 0).sum()) == 8
    # a float32 model rounds it once, as the reference rounds its products'
    # factors (arch/vecset.py::_fourier)
    assert torch.equal(model.to(torch.float32).point_embed.basis, basis.float())
    # every matrix but the basis is a leaf the benchmark's draw reaches
    assert {k for k, v in model.state_dict().items() if v.ndim == 2} == {
        k for k, p in model.named_parameters() if p.ndim == 2}


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    return write_smoke_dataset(tmp_path_factory.mktemp("smoke"), scale_factor=8, n_points=2000)


def test_trainer_trains_and_refuses_to_serve(smoke_data, tmp_path):
    from sv3d_tpu_torch.inference.predict import predict
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    cfg = Config(seed=0, scale_factor=8, batch_size=2, num_points=16,
                 datasetdir=str(smoke_data), sanity_steps=1, val_check_interval=2,
                 experiment="v", decoder="vecset", vecset=SMALL_VECSET)
    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "a")
    state = trainer.fit(max_steps=2)
    assert state.step == 2
    assert not hasattr(state.model, "project") and not hasattr(state.model, "ifnet")
    recs = [json.loads(x) for x in (tmp_path / "a/logs/metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(recs[0]["train_loss"]) and "val_point_iou" in recs[-1]
    saved = torch.load(tmp_path / "a/checkpoints/last", weights_only=True)["model"]
    assert {k.split(".")[0] for k in saved} == {"unet", "vecset"}
    rgb = np.zeros((240, 320, 3), np.float32)
    with pytest.raises(ValueError, match="vecset"):
        predict(cfg, state.model, rgb=rgb)
    with pytest.raises(ValueError, match="vecset"):
        trainer.test(str(tmp_path / "a/checkpoints/last"), max_batches=1)
    with pytest.raises(ValueError, match="vecset"):
        trainer.visualize(state, None, tmp_path / "vis")
    with pytest.raises(ValueError, match="precision 32"):
        SceneNetTrainer(cfg.replace(precision=16), device="cpu",
                        experiment_dir=tmp_path / "d").build_state()


def test_cli_takes_the_decoder():
    from sv3d_tpu_torch.training.cli import build_parser, parse_config

    config, _ = parse_config(["--device", "cpu", "--decoder", "vecset"])
    assert config.decoder == "vecset" and config.vecset == VecSetConfig()
    assert "vecset" in build_parser().format_help()


def test_tracer_spans_and_counts_a_vecset_step():
    """Three spans a forward, an attention span inside them at each of the
    2 + depth attention calls, and the counter at as many."""
    model = VecSet(SMALL_VECSET, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(2)
    cloud = torch.rand(1, 12 * 20, 3, generator=gen) - 0.5
    points = torch.rand(1, 16, 3, generator=gen) - 0.5
    profiling.reset()
    with profiling.enabled():
        model(cloud, points, (12, 20)).sum().backward()
        with torch.no_grad():
            model(cloud, points, (12, 20))
    recs = profiling.records()
    profiling.reset()
    calls = 2 + SMALL_VECSET.depth
    assert recs["counters"] == {"vecset.attention": 2 * calls}
    spans = recs["spans"]
    tops = [s["name"] for s in spans if s["parent"] is None]
    assert tops == ["vecset.encode", "vecset.latents", "vecset.decode"] * 2
    names = {s["id"]: s["name"] for s in spans}
    parents = [names[s["parent"]] for s in spans if s["name"] == "vecset.attention"]
    assert parents == (["vecset.encode"] + ["vecset.latents"] * SMALL_VECSET.depth
                       + ["vecset.decode"]) * 2


@pytest.mark.parametrize("key,value", [("dim", 64), ("depth", 3), ("heads", 4),
                                       ("ff_mult", 2), ("num_freqs", 6),
                                       ("layer_norm_eps", 1e-6), ("input_lattice", [8, 16])])
def test_check_widths_holds_the_port_to_the_file(key, value):
    """The port's model against the configuration file: the file's own pass,
    a file with another width is refused."""
    cfg = _cfg()
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(ref_arch.port_config(cfg, seed=1), intr,
                     FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    ref_arch.check_widths(model, cfg)
    with pytest.raises(RuntimeError, match="not the configuration"):
        ref_arch.check_widths(model, {**cfg, key: value})


@pytest.mark.parametrize("change", [dict(heads=4), dict(num_latents=64),
                                    dict(input_lattice=[16, 16]),
                                    dict(reduced=["num_latents"])],
                         ids=["heads_width", "latents", "lattice", "width_reduced"])
def test_the_vecset_rule_rejects_wrong_widths(change):
    data = json.loads((ROOT / "benchmark" / "configs" / "vecset_ae_d512_m512.json").read_text())
    ref_arch.check_config(data)
    with pytest.raises(ValueError):
        ref_arch.check_config({**data, **change})


def test_step_flops_is_flop_counters_count():
    """A whole B=2 SceneNet training step under FlopCounterMode on the CPU:
    every dense layer and conv as arch/vecset.py::step_flops counts them
    (aten's CPU attention has no formula, so its products are left out on
    both sides here; on the card FlopCounterMode counts the fused ones)."""
    from torch.utils.flop_counter import FlopCounterMode

    from sv3d_tpu_torch.training.trainer_scene_net import scene_forward

    cfg = _cfg()
    traffic = {"batch_size": 2, "num_points": 16}
    config = ref_arch.port_config(cfg, num_points=16, batch_size=2, seed=1)
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(config, intr, FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    gen = torch.Generator().manual_seed(3)
    batch = {"rgb": torch.rand(2, H, W, 3, generator=gen) * 2 - 1,
             "depthmap_target": torch.rand(2, H, W, generator=gen) * 3 + 1,
             "points": torch.rand(2, 32, 3, generator=gen) - 0.5,
             "occupancies": (torch.rand(2, 32, generator=gen) > 0.5).float()}
    with FlopCounterMode(display=False) as fc:
        loss, _, _ = scene_forward(model.train(), config, batch)
        loss.backward()
    counted = fc.get_total_flops()
    assert counted == ref_arch.step_flops(cfg, traffic) - ref_arch.attention_step_flops(
        cfg, traffic)


def test_latents_flops_at_the_published_widths():
    """ae_d512_m512's block: 4.83 GFLOP a sample forward, 24 of them."""
    full = json.loads((ROOT / "benchmark" / "configs" / "vecset_ae_d512_m512.json").read_text())
    blk = ref_arch.block_flops(full)["block"]
    assert blk["dense"] == 2.0 * 512 * 512 * 512 * 16
    assert blk["attention"] == 4.0 * 512 * 512 * 512
    assert ref_arch.latents_flops(full, {"batch_size": 32}) == 32 * 24 * (
        blk["dense"] + blk["attention"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fused attention's float32 rounding is the card's)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _attention_ref(q, k, v, prec):
    """The reference's attention (arch/vecset.py::_attention) between its
    dense layers: both products rounded as prec rounds them."""
    scores = prec.result(prec.operand(q) @ prec.operand(k).transpose(-1, -2))
    attn = (scores / math.sqrt(q.shape[-1])).softmax(dim=-1)
    return prec.result(prec.operand(attn) @ prec.operand(v))


#: the cell's three attention shapes at B=4: (heads, query tokens, key
#: tokens, dim_head) of the encoder, a latent block and the decoder
CELL_SHAPES = [(1, 512, 2048, 512), (8, 512, 512, 64), (1, 2048, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("heads,nq,nk,dh", CELL_SHAPES)
def test_attention_computes_in_float32_on_card(cuda_device, heads, nq, nk, dh):
    """F.scaled_dot_product_attention as the port calls it (float32, TF32
    off), forward and the gradients of q, k and v, against float64: within
    a few times the plain float32 attention's own error, and at least ten
    times closer than the plain attention with TF32-rounded operands."""
    gen = torch.Generator(device="cuda").manual_seed(heads * nq + dh)
    q, k, v = (torch.randn(4, heads, n, dh, device=cuda_device, generator=gen)
               for n in (nq, nk, nk))
    w = torch.randn(4, heads, nq, dh, device=cuda_device, generator=gen)

    def run(fn, dtype):
        leaves = [t.detach().to(dtype, copy=True).requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        (out * w.to(dtype)).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    exact = run(lambda *t: _attention_ref(*t, EXACT), torch.float64)
    fused = run(F.scaled_dot_product_attention, torch.float32)
    plain = run(lambda *t: _attention_ref(*t, EXACT), torch.float32)
    low = run(lambda *t: _attention_ref(*t, TRAIN_CONTROL), torch.float32)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        e_fused, e_plain, e_low = (_rel(r[i].double(), exact[i]) for r in (fused, plain, low))
        assert e_fused <= 4.0 * e_plain, (name, e_fused, e_plain)
        assert e_low >= 10.0 * e_fused, (name, e_low, e_fused)
