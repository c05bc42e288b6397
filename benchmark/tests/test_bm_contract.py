"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every configuration, traffic mix, limit and metric of it by name."""

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


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(config["why"]) <= 200
    assert config["file"].startswith("benchmark/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    # the widths the configuration states: decoder input = 7 x sum of channels
    chans = [1] + [s[-1] for s in data["stages"]]
    assert data["decoder"][0] == 7 * sum(chans)
    assert sum(1 for c in BENCH["configs"] if c["file"] == config["file"]) == 1


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_harness_finds_cell_pieces(cell):
    """The configuration, traffic, limits and per-layer readers of a cell are
    found by name; each reader returns None where a run holds nothing."""
    from benchmark import run as bench

    spec = bench.load_spec(cell["name"])
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").exists()
    bench.driver_class(spec["traffic"]["kind"])
    assert spec["limits"] and all(math.isfinite(v["limit"]) for v in spec["limits"].values())

    class Empty:
        spans, trace, window_s, counts, work, memory = {}, None, 1.0, {}, {}, {}

    for m in spec["per_layer"]:
        assert bench.read_metric(m["name"], Empty()) is None, m["name"]
