"""Convolutional Occupancy Networks' grid decoder in the port
(models/convonet.py, ops/cell_pool.py, SceneNet and its trainer under
Config(decoder="convonet_grid")): held to the benchmark's plain reference
(benchmark/arch/convonet_grid.py, with reference/scene.py's UNetMini and
back-projection and reference/train.py's loss) in float64 on the CPU, where
rounding leaves nothing to hide a difference; the cell ops against loops
over the cells; the trainer's step, checkpoint and resume; the paths that
serve the IF-Net's field refusing it; the tracer's counters.  Imports
nothing of JAX."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.arch import convonet_grid as ref_arch  # noqa: E402
from benchmark.frozen import scenes  # noqa: E402
from benchmark.frozen.weights import seeded_state_dict  # noqa: E402
from benchmark.reference import scene  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from sv3d_tpu_torch.config import Config, ConvONetConfig  # noqa: E402
from sv3d_tpu_torch.geometry import FrustumGrid, parse_intrinsics  # noqa: E402
from sv3d_tpu_torch.models.convonet import ConvONet  # noqa: E402
from sv3d_tpu_torch.models.scene_net import SceneNet  # noqa: E402
from sv3d_tpu_torch.ops.cell_pool import (  # noqa: E402
    cell_index,
    local_max_pool,
    normalize_coordinate,
    scatter_mean,
)
from sv3d_tpu_torch.quality.box_scene import write_smoke_dataset  # noqa: E402
from sv3d_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)

DT = torch.float64
#: float64 on both sides: the same exact arithmetic in two orders
RTOL = 1e-10
#: the configuration at a size the CPU runs in seconds: a grid of 8 cells a
#: side, a 3-level U-Net of 8 channels, the frustum at a quarter resolution
SMALL = dict(grid_resolution=8, unet3d_f_maps=8, unet3d_num_levels=3, dims=[35, 26, 28],
             voxel_size=0.2)


def _cfg(**kw) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "convonet_grid64.json").read_text())
    return {**cfg, **SMALL, **kw}


def _rel(a, b, floor: float = 1e-300) -> float:
    return float((a - b).norm() / max(float(b.norm()), floor))


def test_convonet_matches_the_reference_in_float64():
    """500 cloud points, B=2: the logits, every leaf's gradient and the
    cloud's."""
    cfg = _cfg()
    model = ConvONet(ConvONetConfig(grid=8, unet_fmaps=8, unet_levels=3),
                     generator=torch.Generator().manual_seed(0))
    sd = seeded_state_dict({f"convonet.{k}": v for k, v in model.state_dict().items()}, None, 5,
                           "cpu")
    model.load_state_dict({k[len("convonet."):]: v for k, v in sd.items()})
    model = model.to(DT)
    sd = {k: v.to(DT).requires_grad_(True) for k, v in sd.items()}
    gen = torch.Generator().manual_seed(1)
    # a tenth of the cloud outside the unit cube, where the clamp holds it
    cloud = (torch.rand(2, 500, 3, generator=gen, dtype=DT) - 0.5) * 1.2
    points = torch.rand(2, 40, 3, generator=gen, dtype=DT) - 0.5
    c_p, c_r = cloud.clone().requires_grad_(True), cloud.clone().requires_grad_(True)
    got = model(c_p, points)
    want = ref_arch.occupancy_logits(sd, cfg, c_r, points)
    assert _rel(got.detach(), want.detach()) < RTOL
    w = torch.randn(got.shape, generator=gen, dtype=DT)
    (got * w).sum().backward()
    (want * w).sum().backward()
    for k, p in model.named_parameters():
        assert _rel(p.grad, sd[f"convonet.{k}"].grad) < RTOL, k
    assert _rel(c_p.grad, c_r.grad) < RTOL


def test_scene_net_step_matches_the_reference_in_float64(tmp_path):
    """One training batch through SceneNet with UNetMini (76,800 back-projected
    pixels a sample): the loss and every leaf's gradient against the
    reference's train.loss."""
    from sv3d_tpu_torch.training.trainer_scene_net import scene_forward

    cfg = _cfg()
    config = ref_arch.port_config(cfg, num_points=32, batch_size=2, seed=1)
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(config, intr, FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    ref_arch.check_widths(model, cfg)
    sd = seeded_state_dict(model.state_dict(), None, 12, "cpu")
    model.load_state_dict(sd)
    model = model.to(DT).train()
    sd = {k: v.to(DT) if v.is_floating_point() else v for k, v in sd.items()}
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    rooms = scenes.write_train_tree(12, 2, tmp_path, "s", scale, shift, cfg["dims"], 300)
    hb = ref_train.batch_at(rooms, 12, 2, 32, scenes.FOCAL, 0)
    batch = {k: torch.as_tensor(v, dtype=DT) for k, v in hb.items()}
    loss_p, metrics, _ = scene_forward(model, config, {
        "rgb": batch["rgb"], "depthmap_target": batch["depth"], "points": batch["points"],
        "occupancies": batch["occupancies"]})
    assert not [k for k in metrics if k.startswith("sigma")]
    loss_p.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()
              if ref_train.is_parameter(k)}
    cam = (scenes.FOCAL, scenes.CX, scenes.CY, scale.astype(np.float64),
           shift.astype(np.float64))
    loss_r = ref_train.loss({**sd, **params}, cfg, batch, cam)
    loss_r.backward()
    loss_p, loss_r = float(loss_p.detach()), float(loss_r.detach())
    assert abs(loss_p - loss_r) <= RTOL * abs(loss_r)
    grads = dict(model.named_parameters())
    assert set(grads) == set(params)
    # the biases of the UNet convs that feed a train-mode BatchNorm have a
    # gradient of exactly 0, and both sides compute rounding residue there
    # (1e-16 of the largest leaf's norm): each leaf is held against the
    # larger of its norm and a ten-thousandth of the largest leaf's
    floor = 1e-4 * max(float(p.grad.norm()) for p in params.values())
    for k, p in params.items():
        assert _rel(grads[k].grad, p.grad, floor) < RTOL, k


def _cells_and_features(seed: int, b=2, n=60, c=5, cells=10):
    gen = torch.Generator().manual_seed(seed)
    index = torch.randint(0, cells, (b, n), generator=gen)
    x = torch.randn(b, n, c, generator=gen, dtype=DT)
    return index, x


def test_local_max_pool_is_the_max_over_each_cell():
    index, x = _cells_and_features(0)
    x.requires_grad_(True)
    got = local_max_pool(x, index, 10)
    want = torch.empty_like(x)
    grad = torch.zeros_like(x)
    for b in range(x.shape[0]):
        for cell in index[b].unique():
            members = (index[b] == cell).nonzero()[:, 0]
            vals = x[b, members].detach()
            want[b, members] = vals.max(0).values
            # the max of each channel takes the gradient of every member's copy
            grad[b, members[vals.argmax(0)], torch.arange(x.shape[2])] = float(len(members))
    assert torch.equal(got.detach(), want)
    got.sum().backward()
    assert torch.equal(x.grad, grad)


def test_scatter_mean_is_the_mean_over_each_cell():
    g = 2
    index, x = _cells_and_features(1, cells=g ** 3 - 1)  # the last cell stays empty
    got = scatter_mean(x, index, g)
    assert got.shape == (2, 5, g, g, g)
    for b in range(x.shape[0]):
        for cell in range(g ** 3):
            members = index[b] == cell
            want = x[b, members].mean(0) if members.any() else torch.zeros(5, dtype=DT)
            z, y, xx = cell // (g * g), (cell // g) % g, cell % g
            torch.testing.assert_close(got[b, :, z, y, xx], want, rtol=1e-14, atol=1e-14)


def test_normalize_clamps_into_the_unit_cube():
    p = torch.tensor([[[0.6, 0.56, -0.6], [0.0, -0.5, 0.5]]], dtype=DT)
    n = normalize_coordinate(p, 0.1)
    want = torch.tensor([[[0.999, 0.999, 0.0], [0.5, 0.5 - 0.5 / 1.101, 0.5 + 0.5 / 1.101]]],
                        dtype=DT)
    torch.testing.assert_close(n, want, rtol=0, atol=1e-15)
    # the clamped face lies in the last cell, never one past it
    assert cell_index(n, 64)[0, 0] == 63 + 64 * (63 + 64 * 0)


def test_the_cell_layout_is_the_one_grid_sample_reads():
    """A point's cell x + g (y + g z) holds its features where grid_sample
    reads (x, y, z) coordinates: the decoder's sample of the encoder's grid
    at a cell's centre gives that cell's mean."""
    g = 4
    axes = torch.arange(g, dtype=DT)
    ijk = torch.stack(torch.meshgrid(axes, axes, axes, indexing="ij"), -1).reshape(1, -1, 3)
    # points inside cell (i, j, k) of x, y, z, features their three cell numbers
    n = (ijk + 0.5) / g
    p = (n - 0.5) * (1.0 + 0.1 + 1e-3)
    index = cell_index(normalize_coordinate(p, 0.1), g)
    grid = scatter_mean(ijk, index, g)
    # align_corners: cell i's sample coordinate is 2 i / (g - 1) - 1
    got = F.grid_sample(grid, (2.0 * ijk / (g - 1) - 1.0)[:, :, None, None], mode="bilinear",
                        padding_mode="border", align_corners=True)[:, :, :, 0, 0].transpose(1, 2)
    torch.testing.assert_close(got, ijk, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    return write_smoke_dataset(tmp_path_factory.mktemp("smoke"), scale_factor=8, n_points=2000)


def _convonet_config(root, **kw) -> Config:
    return Config(seed=0, scale_factor=8, batch_size=2, num_points=32, datasetdir=str(root),
                  sanity_steps=1, val_check_interval=2, experiment="c", decoder="convonet_grid",
                  convonet=ConvONetConfig(grid=8, unet_fmaps=8, unet_levels=3), **kw)


def test_trainer_steps_checkpoints_and_resumes(smoke_data, tmp_path):
    from sv3d_tpu_torch.inference.predict import predict
    from sv3d_tpu_torch.training.checkpoint import load_state_from_checkpoint
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    cfg = _convonet_config(smoke_data)
    trainer = SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "a")
    state = trainer.fit(max_steps=2)
    assert state.step == 2
    assert not hasattr(state.model, "project") and not hasattr(state.model, "ifnet")
    assert len(state.optimizer.param_groups) == 1  # no sigma group
    recs = [json.loads(x) for x in (tmp_path / "a/logs/metrics.jsonl").read_text().splitlines()]
    assert np.isfinite(recs[0]["train_loss"]) and "val_point_iou" in recs[-1]
    assert not [k for r in recs for k in r if k.startswith("sigma")]
    ckpt = tmp_path / "a/checkpoints/last"
    saved = torch.load(ckpt, weights_only=True)["model"]
    assert {k.split(".")[0] for k in saved} == {"unet", "convonet"}
    restored = load_state_from_checkpoint(trainer.build_state(), ckpt)
    assert restored.step == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    resumed = SceneNetTrainer(cfg.replace(resume=str(ckpt), sanity_steps=0), device="cpu",
                              experiment_dir=tmp_path / "b")
    assert resumed.fit(max_steps=3).step == 3

    rgb = np.zeros((240, 320, 3), np.float32)
    with pytest.raises(ValueError, match="convonet_grid"):
        predict(cfg, state.model, rgb=rgb)
    with pytest.raises(ValueError, match="convonet_grid"):
        trainer.test(str(ckpt), max_batches=1)
    with pytest.raises(ValueError, match="convonet_grid"):
        trainer.visualize(state, None, tmp_path / "vis")
    with pytest.raises(ValueError, match="precision 32"):
        SceneNetTrainer(cfg.replace(precision=16), device="cpu",
                        experiment_dir=tmp_path / "d").build_state()


def test_cli_takes_the_decoder():
    from sv3d_tpu_torch.training.cli import parse_config

    config, _ = parse_config(["--device", "cpu", "--decoder", "convonet_grid"])
    assert config.decoder == "convonet_grid" and config.convonet == ConvONetConfig()
    assert parse_config(["--device", "cpu"])[0].decoder == "ifnet"
    with pytest.raises(ValueError, match="decoder"):
        Config(seed=0, decoder="convonet_plane")


def test_tracer_counts_a_convonet_step():
    """At room_grid64's widths (on an 8-cell grid): the U-Net's 14 weight
    gradients, the four pools and the three spans; the kernel counts none on
    the CPU, and nothing is counted under the IF-Net's name."""
    model = ConvONet(ConvONetConfig(grid=8), generator=torch.Generator().manual_seed(0))
    assert sum(1 for k, v in model.state_dict().items() if v.ndim == 5 and v.shape[-1] == 3) == 14
    gen = torch.Generator().manual_seed(2)
    cloud = torch.rand(1, 200, 3, generator=gen) - 0.5
    points = torch.rand(1, 16, 3, generator=gen) - 0.5
    profiling.reset()
    with profiling.enabled():
        model(cloud, points).sum().backward()
        with torch.no_grad():
            model(cloud, points)
    recs = profiling.records()
    profiling.reset()
    counters = recs["counters"]
    assert counters.get("convonet.wgrad") == 14
    assert counters.get("convonet.wgrad_kernel", 0) == 0
    assert counters.get("convonet.pool") == 8  # four a forward, two forwards
    assert not [k for k in counters if k.startswith("ifnet.")]
    names = [s["name"] for s in recs["spans"]]
    assert names == ["convonet.encode", "convonet.unet3d", "convonet.decode"] * 2


@pytest.mark.parametrize("key,value", [("hidden_dim", 64), ("c_dim", 16),
                                       ("encoder_blocks", 4), ("decoder_blocks", 6),
                                       ("unet3d_num_groups", 4), ("padding", 0.2)])
def test_check_widths_holds_the_port_to_the_file(key, value):
    """The widths the port fixes (models/convonet.py's constants) against
    the configuration file: the file's own pass, a file with another width
    is refused."""
    cfg = _cfg()
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(ref_arch.port_config(cfg, seed=1), intr,
                     FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    ref_arch.check_widths(model, cfg)
    with pytest.raises(RuntimeError, match="not the configuration"):
        ref_arch.check_widths(model, {**cfg, key: value})


def test_smoke_times_the_convs_the_bound_counts():
    """chip_smoke.py's wgrad phase runs the kernel at the U-Net convs'
    shapes that the benchmark's wgrad_roofline.convonet bound sums over."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    got = sorted((shape[1], cout, shape[2]) for _, shape, cout in
                 chip_smoke.unet3d_conv_shapes(32))
    full = json.loads((ROOT / "benchmark" / "configs" / "convonet_grid64.json").read_text())
    assert len(got) == 14
    assert got == sorted(ref_arch.unet_convs(full))
