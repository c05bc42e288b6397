"""The traffic and the weights are the same for the same seed, and another
seed gives others; seeds past 32 bits are taken."""

import numpy as np
import torch

from benchmark.frozen import scenes
from benchmark.frozen.weights import seeded_state_dict
from benchmark.reference import scene, train

BIG = 2**31 + 987654321  # seeds may run past 32 signed bits


def _template():
    return {"unet.down.0.weight": torch.zeros(32, 3, 4, 4),
            "unet.down.0.bias": torch.zeros(32),
            "unet.bn.0.weight": torch.zeros(64),
            "unet.bn.0.running_var": torch.zeros(64),
            "unet.bn.0.num_batches_tracked": torch.zeros((), dtype=torch.long),
            "project.sigma": torch.zeros(3),
            "ifnet.fc0.weight": torch.zeros(256, 2583)}


def test_pool_is_deterministic(tmp_path):
    a = scenes.render_pool(BIG, 3, tmp_path / "a")
    b = scenes.render_pool(BIG, 3, tmp_path / "b")
    c = scenes.render_pool(BIG + 1, 3, tmp_path / "c")
    for (pa, ra), (pb, rb) in zip(a, b):
        assert pa.read_bytes() == pb.read_bytes()
        assert np.array_equal(ra, rb)
    assert not np.array_equal(a[0][1], c[0][1])


def test_train_tree_is_deterministic(tmp_path):
    cfg = {"image_size": [320, 240], "depth_min": 0.4, "depth_max": 6.0, "voxel_size": 0.05}
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    dims = (139, 104, 112)
    a = scenes.write_train_tree(BIG, 2, tmp_path / "a", "s", scale, shift, dims, 100)
    b = scenes.write_train_tree(BIG, 2, tmp_path / "b", "s", scale, shift, dims, 100)
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*")
                   if p.is_file())
    assert files
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()
    for k in a:
        (pa, oa), (pb, ob) = a[k][2][0], b[k][2][0]
        assert np.array_equal(pa, pb) and np.array_equal(oa, ob)
        assert 0.0 < oa.mean() < 1.0  # both labels occur


def test_exr_reads_back(tmp_path):
    """The benchmark's EXR writer gives what the port's reader reads."""
    from sv3d_tpu_torch.io.exr import read_exr_channel

    d = np.random.default_rng(0).uniform(0.4, 6.0, (240, 320)).astype(np.float32)
    scenes.write_exr(tmp_path / "d.exr", d)
    assert np.array_equal(read_exr_channel(tmp_path / "d.exr", "R"), d)


def test_weights_are_deterministic():
    a = seeded_state_dict(_template(), [1.5, 1.5, 1.5], BIG, "cpu")
    b = seeded_state_dict(_template(), [1.5, 1.5, 1.5], BIG, "cpu")
    c = seeded_state_dict(_template(), [1.5, 1.5, 1.5], BIG + 1, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["ifnet.fc0.weight"], c["ifnet.fc0.weight"])
    w = a["ifnet.fc0.weight"]
    # lecun normal truncated at two standard deviations: variance 1 / fan_in
    assert abs(float(w.var()) * 2583 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / 2583 ** 0.5 + 1e-6
    assert torch.equal(a["unet.bn.0.weight"], torch.ones(64))
    assert torch.equal(a["unet.down.0.bias"], torch.zeros(32))
    assert torch.equal(a["project.sigma"], torch.full((3,), 1.5))


def test_batches_follow_the_seed():
    rooms = {f"{i:03d}": (np.full((240, 320, 3), i, np.uint8),
                          np.full((240, 320), 2.0 + i, np.float32),
                          [(np.random.default_rng(i).random((50, 3)).astype(np.float32),
                            np.zeros(50, np.float32))] * 2)
             for i in range(6)}
    a = train.batches(rooms, BIG & 0x7FFFFFFF, 2, 8, scenes.FOCAL, 3)
    b = train.batches(rooms, BIG & 0x7FFFFFFF, 2, 8, scenes.FOCAL, 3)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    rows = [int(r[0, 0, 0]) for batch in a for r in batch["rgb"] * 0.5 * 255 + 127.5]
    assert len(set(rows)) == 6  # three batches of two, every room once


def test_reference_batches_are_the_loaders(tiny, tmp_path):
    """The reference's batch of every step, past the first epoch too, is the
    one the port's loader serves from the same tree (the batches of the
    window come from its decode cache)."""
    from sv3d_tpu_torch.data.loader import DataLoader
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    from benchmark.arch.scene_ifnet import port_config

    spec = tiny("sv3d128.train_b4", scenes=6, samples=200, batch_size=2, num_points=16)
    cfg, t = spec["cfg"], spec["traffic"]
    seed = BIG & 0x7FFFFFFF
    scale, shift = scene.frustum_transform(cfg, scenes.FOCAL, scenes.CX, scenes.CY)
    rooms = scenes.write_train_tree(BIG, t["scenes"], tmp_path, "s", scale, shift,
                                    cfg["dims"], t["samples"])
    config = port_config(cfg, datasetdir=str(tmp_path), splitsdir="s", seed=seed,
                         num_points=t["num_points"], batch_size=t["batch_size"],
                         subsample_points=0, flip_aug=False, num_workers=0)
    trainer = SceneNetTrainer(config, device="cpu", experiment_dir=tmp_path / "exp")
    loader = DataLoader(trainer.train_dataset(), batch_size=t["batch_size"], shuffle=True,
                        drop_last=True, num_workers=0, seed=seed)
    step = 0
    for _ in range(3):
        for got in loader:
            want = train.batch_at(rooms, seed, t["batch_size"], t["num_points"],
                                  scenes.FOCAL, step)
            assert np.array_equal(got["points"], want["points"])
            assert np.array_equal(got["occupancies"], want["occupancies"])
            assert np.allclose(got["rgb"], want["rgb"], atol=1e-6)
            assert np.allclose(got["depthmap_target"].squeeze(), want["depth"], rtol=1e-6)
            step += 1
    assert step == 3 * (t["scenes"] // t["batch_size"])
