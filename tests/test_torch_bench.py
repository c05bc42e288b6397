"""The port's headline benchmark (sv3d_tpu_torch/bench/headline.py) on the
CPU at scale 8 (dims (17, 13, 14), the res_increase-2 lattice 34 x 26 x
28; 512 arbitrary points, chunks of 64, one timed run), running the plain
versions: every section gives finite positive figures, the result line
keeps bench.py's keys and arithmetic, a failing section ends the run, and
a CUDA device without a card raises (the headline and measure_step); the
launch-count and figure checks the bench's tools share.  measure_step on
the CPU: tests/test_torch_bench_steps.py; both against the JAX package:
tests/test_torch_bench_parity.py; chip_smoke.py's bench phase:
tests/test_torch_bench_smoke.py."""

import contextlib
import io
import json
import runpy

import pytest
import torch

from sv3d_tpu_torch.bench import bad_figures, headline, measure_step
from sv3d_tpu_torch.ops.cuda import launch_counters, launched, require

torch.set_num_threads(1)

CPU = ["--device", "cpu", "--scale_factor", "8", "--n_timed", "1"]
# the keys of bench.py's emit() that the port keeps (all but vs_v100_estimate
# and section_errors)
KEPT = ("metric", "value", "unit", "vs_baseline", "reference_scheme_points_per_sec",
        "slab_rows_used", "points_per_sec_by_slab_rows", "sec_per_scene_image_to_mesh",
        "sec_per_scene_device", "sec_per_scene_marching_cubes", "sec_per_scene_vs_baseline",
        "reference_scheme_sec_per_scene", "arbitrary_points_per_sec",
        "arbitrary_points_per_sec_banded", "arbitrary_points_per_sec_host_loop",
        "sections_completed", "note")
FIGURES = ("value", "vs_baseline", "reference_scheme_points_per_sec",
           "sec_per_scene_image_to_mesh", "sec_per_scene_device",
           "sec_per_scene_marching_cubes", "sec_per_scene_vs_baseline",
           "reference_scheme_sec_per_scene", "arbitrary_points_per_sec",
           "arbitrary_points_per_sec_banded", "arbitrary_points_per_sec_host_loop",
           "sec_per_scene_image_to_mesh_median", "scene_faces")


def run_main(main, argv):
    """(result, the JSON lines printed) of main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")]


@pytest.fixture(scope="module")
def headline_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("bench")
    return run_main(headline.main, CPU + ["--out_dir", str(out_dir)])


def test_headline_runs_every_section_on_the_cpu(headline_run):
    last, lines = headline_run
    assert lines[-1] == last
    # one line after each section, each listing the sections so far
    assert [ln["sections_completed"] for ln in lines] == [
        list(headline.SECTIONS[:i + 1]) for i in range(len(headline.SECTIONS))]
    assert bad_figures({key: last[key] for key in FIGURES}) == []
    assert set(last["points_per_sec_by_slab_rows"]) == {"8", "1", "2", "4", "all"}
    assert bad_figures(last["points_per_sec_by_slab_rows"]) == []
    assert last["value"] == max(last["points_per_sec_by_slab_rows"].values())
    assert last["points_per_sec_by_slab_rows"][last["slab_rows_used"]] == last["value"]
    assert last["n_points"] == 34 * 26 * 28
    assert last["metric"].startswith("occupancy query points/sec/GPU (dense 34x26x28 sweep")
    # the plain versions count no launches; only the card gives these
    assert last["launches"] == {name: {} for name in headline.SECTIONS}
    assert last["sweep_device_ms"] is None and last["host_return_ms_by_slab_rows"] == {}


def test_headline_line_keeps_bench_keys_and_arithmetic(headline_run):
    last, _ = headline_run
    assert set(KEPT) <= set(last)
    assert "vs_v100_estimate" not in last and "section_errors" not in last
    assert last["device"] == {"name": "cpu", "power_limit": None}
    # bench.py:458-479's arithmetic
    ref_pps, mc = last["reference_scheme_points_per_sec"], last["sec_per_scene_marching_cubes"]
    ref_scene = last["n_points"] / ref_pps + mc
    assert last["vs_baseline"] == pytest.approx(last["value"] / ref_pps, rel=1e-12)
    assert last["reference_scheme_sec_per_scene"] == pytest.approx(ref_scene, rel=1e-12)
    assert last["sec_per_scene_vs_baseline"] == pytest.approx(
        ref_scene / last["sec_per_scene_image_to_mesh"], rel=1e-12)
    assert last["sec_per_scene_image_to_mesh"] == pytest.approx(
        last["sec_per_scene_device"] + mc, rel=1e-12)


def test_a_failing_section_ends_the_run(monkeypatch, tmp_path):
    def broken(*args, **kwargs):
        raise RuntimeError("scene broke")

    monkeypatch.setattr(headline, "bench_scene", broken)
    out = io.StringIO()
    argv = CPU + ["--out_dir", str(tmp_path), "--sections", "reference_scheme", "scene",
                  "arbitrary"]
    # through the module's entry point, as python -m sv3d_tpu_torch.bench runs it:
    # the exception leaves the interpreter with a non-zero exit
    monkeypatch.setattr("sys.argv", ["sv3d_tpu_torch.bench", *argv])
    with contextlib.redirect_stdout(out), pytest.raises(RuntimeError, match="scene broke"):
        runpy.run_module("sv3d_tpu_torch.bench", run_name="__main__")
    lines = [json.loads(s) for s in out.getvalue().splitlines() if s.startswith("{")]
    assert [ln["sections_completed"] for ln in lines] == [["reference_scheme"]]


def test_launched_and_require():
    """launched counts what a call launched, by launch_counters' names;
    require names the kernels missing and those that should not have run."""
    counters = launch_counters()

    def fake_launch():
        counters["K4"].launches += 2
        counters["K7"].launches += 1

    before = {k: fn.launches for k, fn in counters.items()}
    try:
        ran = launched(fake_launch)
    finally:
        for k, fn in counters.items():
            fn.launches = before[k]
    assert ran == {"K4": 2, "K7": 1}
    assert launched(lambda: None) == {}
    require(ran, ("K4", "K7"), ("K8",), "both")
    with pytest.raises(RuntimeError, match=r"q: kernels \['K8'\] did not launch, \['K7'\] did"):
        require(ran, ("K4", "K8"), ("K7",), "q")


def test_bad_figures_walks_nested_values():
    assert bad_figures({"a": 1.0, "b": [2, {"c": 3.5}], "ok": True, "s": "x"}) == []
    bad = bad_figures({"a": 0.0, "b": [1.0, float("nan")], "c": {"d": -1},
                       "e": float("inf"), "f": None})
    assert [key for key, _ in bad] == ["a", "b[1]", "c.d", "e", "f"]
    assert bad_figures({"f": None}, "line", none_ok=True) == []
    assert bad_figures(2.0) == [] and bad_figures(0, "x") == [("x", 0)]


@pytest.mark.parametrize("main", [headline.main, measure_step.main],
                         ids=["headline", "measure_step"])
def test_cuda_without_a_card_raises(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--device", "cuda"])


