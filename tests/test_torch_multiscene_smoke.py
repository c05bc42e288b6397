"""chip_smoke.py's multi-scene phase (phase 24) on the CPU at scale 8, with
device="cpu": quality.multiscene --stage all on 4 train, 1 val and 1 test
synthetic scene under the script's work directory (4 steps of one batch), and the phase's own
checks of its artifact; the plain versions launch no kernel, so the path
counts none."""

import json
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_multiscene_phase_on_the_cpu(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    monkeypatch.setattr(smoke, "WORK", tmp_path)
    out = smoke.multiscene_phase(device="cpu", scale_factor=8, steps=4)
    assert out["launches"] == {"K1": 0, "K1b": 0, "K2": 0}
    result = out["result"]
    assert (result["n_train"], result["n_val"], result["n_test"]) == (4, 1, 1)
    logged = [json.loads(x) for x in
              (tmp_path / "multiscene_exp" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged if "train_loss" in r] == [1]
    assert [r["step"] for r in logged if "val_point_iou" in r] == [2, 4]
    assert (result["steps"], result["batch_size"], result["precision"]) == (4, 4, 32)
    assert result["protocol"] == "end_to_end_generalization" and result["device"] == "cpu"
    assert (tmp_path / "multiscene_exp" / "checkpoints" / "last").exists()
    assert (tmp_path / "multiscene_exp" / "test_meshes").is_dir()
