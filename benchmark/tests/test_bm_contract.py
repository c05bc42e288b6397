"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, architecture, traffic mix, limit and metric of it by
name; each configuration keeps to its own architecture's rule."""

import json
import math
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= metric["bound"] <= cap
    else:
        assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_reports_enough(cell):
    from benchmark import run as bench

    spec = bench.load_spec(cell["name"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    # every per-layer metric listed for the cell moves one of its metrics
    assert {m["moves"] for m in spec["per_layer"]} <= e2e


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_config_files(path):
    """Every configuration file keeps to its own architecture's rule, also the
    files of the cells kept without an entry (conftest.KEPT); an entry of
    BENCHMARK.json names the file once and agrees with it."""
    from benchmark import arch

    data = json.loads(path.read_text())
    assert len(data["reduced"]) <= 16
    # a cut names keys of the file, beside the deployment that it stands for
    if data["reduced"]:
        assert set(data["reduced"]) <= set(data) and data.get("deployment"), data["reduced"]
    assert not [k for k in data["reduced"] if k.endswith(("_dim", "_rank"))]
    # the widths the configuration states, by its architecture's own rule
    arch.load(data["arch"]).check_config(data)
    entries = [c for c in BENCH["configs"] if (ROOT / c["file"]) == path]
    assert len(entries) <= 1
    for config in entries:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(config["why"]) <= 200
        assert data["source"] == config["source"]
        assert data["reduced"] == config["reduced"]


@pytest.mark.parametrize("break_it", [
    lambda d: d["decoder"].__setitem__(0, d["decoder"][0] + 1),
    lambda d: d["stages"][-1].__setitem__(-1, 64),
    lambda d: d.update(reduced=["decoder"], deployment="one chip of eight"),
], ids=["decoder_input", "stage_width", "width_reduced"])
def test_the_ifnet_rule_rejects_wrong_widths(break_it):
    from benchmark import arch

    rule = arch.load("scene_ifnet").check_config
    data = json.loads((ROOT / "benchmark" / "configs" / "sv3d128.json").read_text())
    rule(data)
    break_it(data)
    with pytest.raises(ValueError):
        rule(data)


@pytest.mark.parametrize("name", ["no_such_arch", "../drivers/train", "", None])
def test_an_unknown_architecture_is_named(name):
    from benchmark import arch

    with pytest.raises(ValueError, match=re.escape(repr(name))):
        arch.load(name)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_limits_name_what_the_cell_compares(cell):
    """A cell's limits are exactly the numbers that its driver gives for its
    architecture: none that would always read NaN, none left unchecked."""
    from benchmark import arch
    from benchmark import run as bench

    spec = bench.load_spec(cell["name"])
    driver = bench.driver_class(spec["traffic"]["kind"])
    assert set(spec["limits"]) == set(driver.compared(arch.load(spec["cfg"]["arch"])))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    # each file lies where test_config_files finds it
    assert all(c["file"].startswith("benchmark/configs/") for c in BENCH["configs"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_harness_finds_cell_pieces(cell):
    """The configuration, traffic, limits and per-layer readers of a cell are
    found by name; each reader returns None where a run holds nothing."""
    from benchmark import run as bench

    from benchmark import arch

    spec = bench.load_spec(cell["name"])
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").exists()
    bench.driver_class(spec["traffic"]["kind"])
    arch.load(spec["cfg"]["arch"])
    assert spec["limits"] and all(math.isfinite(v["limit"]) for v in spec["limits"].values())

    class Empty:
        spans, trace, window_s, counts, work, memory = {}, None, 1.0, {}, {}, {}

    for m in spec["per_layer"]:
        assert bench.read_metric(m["name"], Empty()) is None, m["name"]
