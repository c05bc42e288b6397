"""The plain reference computes what the port computes: in float64 on the
CPU, where rounding leaves nothing to hide a difference, the served
depth, voxel grid and lattice occupancy, and a training step's loss and
every gradient, agree to float64 rounding.  (The reference itself imports
nothing of the port; these tests hold the two side by side.)"""

import numpy as np
import pytest
import torch

from benchmark.arch.scene_ifnet import port_config
from benchmark.frozen import scenes
from benchmark.frozen.weights import seeded_state_dict
from benchmark.reference import scene, train

DT = torch.float64


def _model(spec, seed):
    from sv3d_tpu_torch.geometry.camera import parse_intrinsics
    from sv3d_tpu_torch.geometry.frustum import FrustumGrid
    from sv3d_tpu_torch.models.scene_net import SceneNet

    cfg = spec["cfg"]
    config = port_config(cfg, num_points=32, batch_size=2, seed=1)
    intr = parse_intrinsics(scenes.INTRINSICS_TEXT)
    model = SceneNet(config, intr, FrustumGrid.create(intr, voxel_size=cfg["voxel_size"]))
    sd = seeded_state_dict(model.state_dict(), cfg["sigma"], seed, "cpu")
    # BatchNorm statistics away from 0 and 1, so eval mode's use of them shows
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = torch.linspace(-0.2, 0.2, sd[k].numel())
        elif k.endswith("running_var"):
            sd[k] = torch.linspace(0.5, 2.0, sd[k].numel())
    model.load_state_dict(sd)
    sd64 = {k: v.to(DT) if v.is_floating_point() else v for k, v in sd.items()}
    return config, model.to(DT), sd64


def _cam(cfg):
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    return scenes.FOCAL, scenes.CX, scenes.CY, scale.astype(np.float64), shift.astype(np.float64)


@pytest.mark.parametrize("cell", ["sv3d128.mesh_r1", "sv3d32.mesh_r1"])
def test_served_field_agrees_in_float64(tiny, cell, tmp_path):
    spec = tiny(cell)
    cfg = spec["cfg"]
    config, model, sd = _model(spec, 11)
    model.eval()
    rgb = scenes.render(scenes.make_room(scenes.room_rng(11, 0)))[1]
    x = torch.as_tensor((rgb.astype(np.float64) / 255.0 - 0.5) / 0.5)[None]
    f, cx, cy, scale, shift = _cam(cfg)
    with torch.no_grad():
        d_p = model.predict_depth(x)
        vox_p = model.project(model.project_depth(d_p))[..., 0]
        levels_p = model.ifnet.encode(vox_p[..., None])
        d_r = scene.depth(sd, cfg, x, False)
        vox_r = scene.voxelize(scene.back_project(d_r, cfg, f, cx, cy, scale, shift), sd, cfg)
        levels_r = scene.encode(sd, cfg, vox_r, False)
        r = tuple(cfg["dims"])
        occ_r = scene.lattice_occupancy(sd, cfg, levels_r, r)
        axes = [torch.linspace(-0.5, 0.5, n, dtype=DT) for n in r]
        pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(1, -1, 3)
        occ_p = torch.sigmoid(model.ifnet.query(levels_p, pts)).reshape(r)
    assert float((d_p - d_r).abs().max()) < 1e-12
    assert float((vox_p - vox_r).abs().max()) < 1e-12
    for (flat, _), v in zip(levels_p, levels_r):
        assert float((flat - v.reshape(flat.shape)).abs().max()) < 1e-10
    assert float((occ_p - occ_r).abs().max()) < 1e-12


def test_training_step_agrees_in_float64(tiny, tmp_path):
    from sv3d_tpu_torch.training.trainer_scene_net import scene_forward

    spec = tiny("sv3d128.train_b4")
    cfg = spec["cfg"]
    config, model, sd = _model(spec, 12)
    model.train()
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    rooms = scenes.write_train_tree(12, 2, tmp_path, "s", scale, shift, cfg["dims"], 300)
    hb = train.batches(rooms, 12, 2, 32, scenes.FOCAL, 1)[0]
    batch = {k: torch.as_tensor(v, dtype=DT) for k, v in hb.items()}
    prog_batch = {"rgb": batch["rgb"], "depthmap_target": batch["depth"],
                  "points": batch["points"], "occupancies": batch["occupancies"]}
    loss_p, _, _ = scene_forward(model, config, prog_batch)
    loss_p.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items() if train.is_parameter(k)}
    loss_r = train.loss({**sd, **params}, cfg, batch, _cam(cfg))
    loss_r.backward()
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()), rel=1e-13)
    grads = dict(model.named_parameters())
    assert set(grads) == set(params)
    for k, p in params.items():
        g_p, g_r = grads[k].grad, p.grad
        scale_ = max(float(g_r.norm()), 1e-6)
        assert float((g_p - g_r).norm()) / scale_ < 1e-8, k


@pytest.mark.parametrize("prec", ["EXACT", "TRAIN_CONTROL"])
def test_training_loss_is_the_scene_composition(tiny, tmp_path, prec):
    """reference/train.py's loss for sv3d128 is, bit for bit, SceneNet
    composed from reference/scene.py: depth and back-projection, then the
    architecture's part, voxelization, the pyramid in train mode and the
    point query; in the control's precision as well."""
    import torch.nn.functional as F

    from benchmark.reference import lowp

    p = getattr(lowp, prec)
    spec = tiny("sv3d128.train_b4")
    cfg = spec["cfg"]
    sd = {k: v.float() if v.is_floating_point() else v for k, v in _model(spec, 14)[2].items()}
    f, cx, cy = scenes.FOCAL, scenes.CX, scenes.CY
    scale, shift = scene.frustum_transform(cfg, f, cx, cy)
    rooms = scenes.write_train_tree(14, 2, tmp_path, "s", scale, shift, cfg["dims"], 300)
    batch = {k: torch.as_tensor(v) for k, v in train.batch_at(rooms, 14, 2, 32, f, 0).items()}
    got = train.loss(sd, cfg, batch, (f, cx, cy, scale, shift), p)
    d = scene.depth(sd, cfg, batch["rgb"], True, p)
    cloud = scene.back_project(d, cfg, f, cx, cy, scale, shift)
    levels = scene.encode(sd, cfg, scene.voxelize(cloud, sd, cfg, p), True, p)
    logits = scene.query(sd, cfg, levels, batch["points"], p)
    want = F.binary_cross_entropy_with_logits(logits, batch["occupancies"]) \
        + torch.mean((d - batch["depth"]) ** 2)
    assert torch.equal(got, want)
