"""quality.scaling, one arm of the scene-scaling experiment: a CPU dry run
at scale 8 (two runs of the 32 arm, the eval of the first beside the
training of the second, and the served held-out image), and the comparison
decided in advance held on the JAX package's own round-5 figures."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from sv3d_tpu_torch.quality import scaling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_an_arm_runs_twice_and_serves_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    out = tmp_path / "arm.json"
    scaling.main(["--arm", "32", "--runs", "2", "--serve", "--device", "cpu",
                  "--root", "tree", "--exp", "runs/scaling", "--data_workers", "0",
                  "--out", str(out), "--",
                  "--device", "cpu", "--scale_factor", "8", "--num_samples", "400",
                  "--steps", "4", "--val_every", "2", "--n_train", "3", "--n_val", "1",
                  "--n_test", "2", "--net_res", "32", "--num_points", "8", "--batch_size", "1",
                  "--eval_points", "1000"])
    result = json.loads(out.read_text())
    assert result["arm"] == "32" and len(result["runs"]) == 2
    assert [r["exp"] for r in result["runs"]] == ["runs/scaling_32_r0", "runs/scaling_32_r1"]
    assert len(result["commands"]) == 5 and all(
        c.startswith("python -m sv3d_tpu_torch.quality.multiscene") for c in result["commands"])
    for r in result["runs"]:
        assert r["device"] == "cpu" and len(r["per_scene"]) == 2
        assert r["eval_checkpoint"].startswith("step_")
    # the tree's held-out scenes are not the round-5 ones: no comparison
    assert result["jax_reference"]["iou"] == 0.1419 and result["comparison"] is None
    served = result["serving"]
    assert served["faces"] > 0 and len(served["image_to_mesh_s"]) == 5
    assert served["command"].startswith("python -m sv3d_tpu_torch.inference.predict")
    assert (tmp_path / "runs" / "scaling_32_r0" / "served" / "00000.obj").is_file()


@pytest.mark.parametrize("arm", ["32", "96", "96f"])
def test_the_comparison_rule_on_the_jax_figures(arm):
    """Runs that repeat the JAX package's per-scene IoUs agree (paired
    differences 0); runs SE + 0.01 above it on every scene do not."""
    ref = scaling.jax_reference(REPO / f"QUALITY_SCALING_{arm}_r5.json")
    assert "train_seconds" not in ref

    def run(shift):
        scenes = [{"name": s["name"], "iou": s["iou"] + shift} for s in ref["per_scene"]]
        return {"iou": ref["iou"] + shift, "per_scene": scenes}

    same = scaling.compare([run(0.0), run(0.02)], ref)
    assert same["agrees"] and same["band"][0] <= ref["iou"] <= same["band"][1]
    assert all(d == 0.0 for d in same["paired_iou_differences"][0].values())
    assert same["mean_paired_iou_difference"] == [0.0, 0.02]
    far = scaling.compare([run(scaling.SE + 0.01)], ref)
    assert not far["agrees"]
