"""chip_smoke.py's bench phase (phase 23) on the CPU at scale 8, with
device="cpu": K2 bf16 on the res_increase-2 lattice held on its three
slabs, the bench's training kernels at its batch shapes
(bench_kernel_checks, at batch 2 here), headline.main and
measure_step.main with their meshes under the script's work directory,
and the phase's own checks of their lines; the plain versions launch no
kernel, so every bench path counts none."""

import sys
from pathlib import Path

import torch

from sv3d_tpu_torch.bench import headline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_bench_phase_on_the_cpu(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    monkeypatch.setattr(smoke, "WORK", tmp_path)
    out = smoke.bench_phase(device="cpu", scale_factor=8, n_timed=1)
    assert out["K2"]["ms"] is None and out["K2"]["max_abs_err"] == 0.0
    assert set(out["K2"]["slabs"]) == {0, 13, 26}
    # plain against plain on the CPU: every kernel's error is 0
    assert out["train_kernels"] == {k: (0.0, 0.0) for k in ("K1", "K1b", "K4", "K7", "K8")}
    assert out["headline"]["sections_completed"] == list(headline.SECTIONS)
    assert out["headline"]["n_points"] == 34 * 26 * 28
    assert len(out["measure_step"]["steps"]) == 8
    assert out["launches"] == {p: {} for p in ("bench_sweep", "bench_scene", "bench_points",
                                               "bench_step")}
    assert out["step_b8_f32"]["B"] == 2 and not out["step_b8_f32"]["fused_query"]
    # the meshes go under the work directory, none under the working directory
    assert (tmp_path / "bench" / "bench_scene_mesh.obj").is_file()
    assert (tmp_path / "bench" / "measure_serving.obj").is_file()
