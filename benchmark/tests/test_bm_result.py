"""The result line has exactly the contract's keys, the numbers compared
last; metrics carry a value and a unit."""

import json

import torch

from benchmark import run as bench

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(spec, trace):
    result, numbers, limits, diag = bench.run_cell(spec, 2**31 + 5, 0.1, trace,
                                                   torch.device("cpu"))
    line, checks = bench.result_line(result, numbers, limits)
    return json.loads(line), checks, spec, numbers


def test_untraced_line(tiny):
    out, checks, spec, numbers = _line(tiny("sv3d128.train_b4", scenes=6, samples=200, batch_size=2,
                                   num_points=32, warmup=4), False)
    assert list(out) == KEYS + ["checks"]
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(spec["limits"]) == set(numbers)
    assert len(checks) == len(spec["limits"])
    assert isinstance(out["correct"], bool)


def test_traced_line(tiny):
    out, _, spec, _ = _line(tiny("sv3d128.train_b4", scenes=6, samples=200, batch_size=2,
                              num_points=32, warmup=4), True)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in spec["per_layer"]}
    assert set(out["metrics"]) <= names
    # the spans' metrics read on any machine; the device's only on the card
    assert {"loader_wait_ms.train", "step_ms.train", "mfu.train"} <= set(out["metrics"])
