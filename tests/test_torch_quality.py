"""The port's quality tooling (sv3d_tpu_torch.quality) on the CPU at toy
scale: the synthetic scene generator against scripts/make_synthetic_scenes.py
file for file, the multi-scene run's stages (the port's counterparts of
tests/test_quality_multiscene_script.py, in-process), its params stamp, the
overfit run in both precisions, its scoring of a mesh pair against the JAX
package's eval_mesh, and the per-scene diagnosis."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sv3d_tpu.evaluation.metrics import eval_mesh as j_eval_mesh
from sv3d_tpu.io.mesh import load_obj as j_load_obj
from sv3d_tpu_torch.io.exr import read_exr
from sv3d_tpu_torch.io.volume import read_df
from sv3d_tpu_torch.quality import compare_precision, diagnose, multiscene, overfit
from sv3d_tpu_torch.quality.scoring import score
from sv3d_tpu_torch.quality.synthetic_scenes import generate

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def test_synthetic_tree_matches_the_jax_script(tmp_path):
    """One good and one beyond-the-frustum scene of seed 3: the same files,
    the same EXR channels, distance fields, PNG pixels and camera poses, and
    the same intrinsics text, as scripts/make_synthetic_scenes.py writes."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from make_synthetic_scenes import generate as j_generate
    finally:
        sys.path.remove(str(REPO / "scripts"))
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    names = generate(ours, 1, bad_scenes=1, seed=3)
    assert names == j_generate(theirs, 1, bad_scenes=1, seed=3) == ["000/00000", "001/00000"]
    files = _files(ours)
    assert files == _files(theirs) and len(files) == 10
    for rel in files:
        a, b = ours / rel, theirs / rel
        if rel.suffix == ".exr":
            ra, rb = read_exr(a), read_exr(b)
            assert set(ra) == set(rb) == {"R"}
            np.testing.assert_array_equal(ra["R"], rb["R"])
        elif rel.suffix == ".df":
            np.testing.assert_array_equal(read_df(a), read_df(b))
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif rel.suffix == ".npy":
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert a.read_text() == b.read_text(), rel


def _common(tmp_path, *extra):
    return ["--root", str(tmp_path / "tree"), "--exp", str(tmp_path / "runs"), "--device", "cpu",
            "--n_train", "3", "--n_val", "1", "--n_test", "1", "--scale_factor", "8",
            "--net_res", "32", "--num_points", "8", "--num_samples", "400", "--batch_size", "1",
            "--steps", "8", "--eval_points", "1000", "--data_workers", "0", *extra]


def _check_artifact(path: Path, n_test: int, expected_ckpt: str, protocol: str) -> dict:
    art = json.loads(path.read_text())
    assert art["protocol"] == protocol
    assert art["n_train"] == 3 and art["n_val"] == 1 and art["n_test"] == n_test
    assert len(art["per_scene"]) == n_test
    assert isinstance(art["n_failed"], int) and 0 <= art["n_failed"] <= n_test
    # the mean IoU is never null: a failed scene scores the worst case 0.0
    assert art["iou"] is not None and 0.0 <= art["iou"] <= 1.0
    assert art["normals"] is not None
    for s in art["per_scene"]:
        assert "name" in s and "iou" in s
        if "failed" not in s:
            assert np.isfinite(s["chamfer_l2"])
    assert "HELD-OUT" in art["note"] and art["eval_checkpoint"] == expected_ckpt
    return art


def test_multiscene_stages_end_to_end(tmp_path, capsys):
    """--stage all (data, train with a validation every 2 steps, eval of the
    end-of-fit state), then --stage eval alone: the best validation
    checkpoint from the manifest, and the train stage's duration picked up;
    end to end (UNet on) at precision 16, then the per-scene diagnosis of
    that run with --full."""
    common = _common(tmp_path, "--use_unet", "--precision", "16")
    multiscene.main([*common, "--out", str(tmp_path / "all.json"), "--stage", "all"])
    _check_artifact(tmp_path / "all.json", 1, "end-of-fit state", "end_to_end_generalization")
    stats = json.loads((tmp_path / "runs" / "train_stats.json").read_text())
    assert stats["train_seconds"] > 0
    manifest = json.loads((tmp_path / "runs" / "checkpoints" / "manifest.json").read_text())
    assert manifest["scores"], "the fit validated but ranked no checkpoint"
    best = Path(manifest["scores"][0][1]).name

    capsys.readouterr()
    multiscene.main([*common, "--out", str(tmp_path / "eval.json"), "--stage", "eval"])
    assert "evaluating best-val checkpoint" in capsys.readouterr().out
    art = _check_artifact(tmp_path / "eval.json", 1, best, "end_to_end_generalization")
    assert art["train_seconds"] == stats["train_seconds"] and art["precision"] == 16

    summary = diagnose.main(["--exp", str(tmp_path / "runs"), "--root", str(tmp_path / "tree"),
                             "--net_res", "32", "--scale_factor", "8", "--precision", "16",
                             "--device", "cpu", "--full", "--eval_points", "1000"])
    (row,) = summary["scenes"]
    assert row["name"] == "004/00000" and 0.0 <= row["cloud_in_frustum_gt"] <= 1.0
    assert row["depth_mae"] >= 0.0 and {"iou_pred", "iou_gtdepth"} <= set(row)
    assert (tmp_path / "runs" / "diagnosis" / "004_00000_depth.png").exists()


def test_append_train_keeps_heldout_scenes_identical(tmp_path):
    """--append_train grows only the train split; val/test keep their scene
    ids and byte-identical raw and processed files."""
    data = ["--stage", "data", "--n_train", "2", "--n_val", "1", "--n_test", "1",
            "--scale_factor", "8", "--num_samples", "400", "--data_workers", "0"]
    base, grown = tmp_path / "base", tmp_path / "grown"
    multiscene.main(["--root", str(base), *data])
    multiscene.main(["--root", str(grown), *data, "--append_train", "2"])

    def split(root, name):
        return (root / "splits" / "synth" / name).read_text().split()

    assert split(grown, "train.txt") == ["000/00000", "001/00000", "004/00000", "005/00000"]
    assert split(grown, "val.txt") == split(base, "val.txt") == ["002/00000"]
    assert split(grown, "test.txt") == split(base, "test.txt") == ["003/00000"]
    for scene in ("002", "003"):
        for kind in ("raw", "processed"):
            b, g = base / kind / "synth" / scene, grown / kind / "synth" / scene
            files = _files(b)
            assert files and files == _files(g)
            for rel in files:
                assert (b / rel).read_bytes() == (g / rel).read_bytes(), rel


def test_a_tree_without_its_stamp_is_refused(tmp_path):
    """A root that holds a scene tree but no params stamp is refused, and not
    stamped after the fact; a root stamped with other parameters is refused;
    the same parameters pass."""
    root = tmp_path / "tree"
    multiscene.build_data(root, {"train": 1, "val": 0, "test": 0}, 8, 400, 0, 0)
    stamp = root / multiscene.STAMP
    assert json.loads(stamp.read_text()) == {"seed": 0, "num_samples": 400, "scale_factor": 8}
    multiscene.build_data(root, {"train": 1, "val": 0, "test": 0}, 8, 400, 0, 0)
    with pytest.raises(SystemExit, match="was generated with"):
        multiscene.build_data(root, {"train": 1, "val": 0, "test": 0}, 8, 800, 0, 0)
    stamp.unlink()
    with pytest.raises(SystemExit, match="no params_stamp.json"):
        multiscene.build_data(root, {"train": 1, "val": 0, "test": 0}, 8, 400, 0, 0)
    assert not stamp.exists()
    with pytest.raises(SystemExit, match="no params_stamp.json"):
        multiscene.main(["--root", str(root), "--stage", "train", "--device", "cpu"])


def test_a_train_split_smaller_than_a_batch_is_refused(tmp_path):
    """3 train scenes at B=4 make no batch (the loader drops a short last
    batch): the fit raises, where the JAX package's loop runs its epochs
    empty and returns the untrained state."""
    argv = _common(tmp_path, "--batch_size", "4")
    multiscene.main([*argv, "--stage", "data"])
    with pytest.raises(ValueError, match="fewer than a batch of 4"):
        multiscene.main([*argv, "--stage", "train"])


def test_overfit_runs_in_both_precisions(tmp_path):
    """compare_precision: a few steps of quality.overfit at scale_factor 8,
    end to end, at precision 32 and 16 on one synthetic scene (made once,
    then reused through its stamp): each run writes the results JSON of the
    JAX package's script, plus the precision and the device, and the
    comparison holds both."""
    keys = {"steps", "fused_query", "train_seconds", "steps_per_sec", "mesh_seconds_cold",
            "protocol", "scale_factor", "net_res", "iou", "chamfer_l2", "normals",
            "reference", "note", "precision", "device"}
    out = tmp_path / "compare.json"
    both = compare_precision.main([
        "--steps", "3", "--exp", str(tmp_path / "run"), "--out", str(out), "--",
        "--device", "cpu", "--scale_factor", "8", "--num_samples", "2000",
        "--eval_points", "2000", "--use_unet", "--root", str(tmp_path / "scene")])
    assert json.loads(out.read_text()) == both and both["device"] == "cpu"
    assert both["nvidia_smi_name_power_limit"] is None and both["steps"] == 3
    for precision in (32, 16):
        result = both["runs"][str(precision)]
        assert keys <= set(result) and result["precision"] == precision
        assert result["protocol"] == "end_to_end" and result["device"] == "cpu"
        exp = tmp_path / f"run_p{precision}"
        assert json.loads((exp / "quality.json").read_text()) == result
        assert (exp / "checkpoints" / "last").exists()
    assert both["iou_16_minus_32"] == round(both["runs"]["16"]["iou"] - both["runs"]["32"]["iou"],
                                            4)
    splits = tmp_path / "scene" / "splits" / "overfit"
    assert (splits / "train.txt").read_text().split() == ["000/00000"] * overfit.REPEATS


def test_scoring_matches_jax_eval_mesh(tmp_path):
    """score() of one pair in grid coordinates of (17, 13, 14): box_scene's
    analytic box pair, whose volumetric IoU is 1/3, moved there; it gives
    the JAX package's eval_mesh on the same normalized meshes, to the digits
    the results JSON keeps."""
    from sv3d_tpu_torch.io.mesh import save_obj
    from sv3d_tpu_torch.quality.box_scene import iou_box_pair

    verts, faces = iou_box_pair()
    dims = (17, 13, 14)
    d = np.asarray(dims, dtype=np.float64)
    pred, gt = tmp_path / "pred.obj", tmp_path / "gt.obj"
    for path, v in zip((pred, gt), verts):
        save_obj(path, v * d + d / 2, faces)
    got = score(pred, gt, dims, 3000)
    norm = lambda p: j_load_obj(p).apply_translation(-d / 2).apply_scale(1.0 / d)
    want = j_eval_mesh(norm(pred), norm(gt), -0.5, 0.5, n_points=3000)
    assert abs(got["iou"] - 1.0 / 3.0) < 0.02
    assert got == {"iou": round(float(want["iou"]), 4),
                   "chamfer_l2": round(float(want["chamfer_l2"]), 6),
                   "normals": round(float(want["normals"]), 4)}
