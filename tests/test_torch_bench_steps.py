"""The port's train-step and op costs (sv3d_tpu_torch/bench/measure_step.py)
on the CPU at scale 8 (dims (17, 13, 14), batches of 2, 150 voxelized and
64 query points a sample, one timed run), running the plain versions:
every op, the five step configurations of scripts/measure_step.py (and
the fused ones again with the projected cloud) and the serving A/B give
finite positive figures (no peak memory on the CPU), the mfu follows its
FLOPs, and --set and --skip_ops pick what runs."""

import pytest
import torch

from sv3d_tpu_torch.bench import bad_figures, measure_step
from test_torch_bench import CPU, run_main

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def measure_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("measure")
    return run_main(measure_step.main, ["--set", "all", *CPU, "--out_dir", str(out_dir)])


def test_measure_step_all_sets_on_the_cpu(measure_run):
    result, lines = measure_run
    assert lines == [result]
    assert result["device"] == {"name": "cpu", "power_limit": None}
    assert set(result["ops"]) == {
        "scatter_K1", "scatter_plain", "scatter_grad_K1b", "voxelize", "query_gathers",
        "query_fused_K4", "encode", "query_grad_gathers", "query_grad_fused"}
    assert bad_figures({name: op["ms"] for name, op in result["ops"].items()}) == []
    steps = result["steps"]
    # the five configurations of scripts/measure_step.py at batch 2 at scale 8,
    # each fused one followed by its run with the projected cloud
    assert [(s["precision"], s["fused_query"], s["cloud"]) for s in steps] == [
        (32, False, False), (16, False, False), (32, True, False), (32, True, True),
        (16, True, False), (16, True, True), (16, True, False), (16, True, True)]
    for s in steps:
        assert s["B"] == 2 and s["peak_mib"] is None  # no device memory on the CPU
        assert s["workload"].startswith("device step") and "host labelling" in s["workload"]
        assert bad_figures({key: s[key] for key in ("ms", "samples_per_s", "tflops_per_s",
                                                    "mfu")}) == []
        kernels = s["flops"]["kernels"]
        assert set(kernels) == ({"K1", "K1b", "K4", "K7", "K8"} if s["cloud"] else
                                {"K1", "K1b", "K4", "K8"} if s["fused_query"] else
                                {"K1", "K1b"})
        assert bad_figures(s["flops"]["torch"]) == []
        assert s["flops"]["total"] == pytest.approx(s["flops"]["torch"] + sum(kernels.values()))
        peak = 67e12 if s["precision"] == 32 else 989e12
        assert s["mfu"] == pytest.approx(s["flops"]["total"] / (s["ms"] / 1e3) / peak)
    # the cloud's 64 points a sample add to the queries: more FLOPs than without
    for without, with_cloud in zip(steps[2::2], steps[3::2]):
        assert with_cloud["flops"]["torch"] > without["flops"]["torch"]
    serving = result["serving"]
    assert bad_figures({k: serving[k]["ms"] for k in ("f32", "f16", "u8")}) == []
    assert bad_figures([serving["marching_cubes_ms"], serving["faces"]]) == []


def test_measure_step_sets_and_skip_ops(tmp_path):
    result, _ = run_main(measure_step.main,
                         ["--set", "base", "--skip_ops", *CPU, "--out_dir", str(tmp_path)])
    assert "ops" not in result and "serving" not in result
    assert [(s["precision"], s["fused_query"]) for s in result["steps"]] == [
        (32, False), (16, False)]


