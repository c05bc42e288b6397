"""The per-layer metrics that read the port's tracer: a traced CPU rehearsal
of the training cell prints the host-side ones with values (the stream ms
of the step's spans read only on the card), the window reads every batch
from the decode cache, and an untraced run reads none of them."""

import json

import torch

from benchmark import run as bench

#: the metrics that read sv3d_tpu_torch/utils/profiling.py
HOST = {"step_host_ms.train", "to_device_ms.train", "batch_ms.train", "cache_hit_share.train"}
DEVICE = {"forward_ms.train", "backward_ms.train", "optimizer_ms.train"}


def test_traced_rehearsal_reads_the_tracer(tiny):
    spec = tiny("sv3d128.train_b4", scenes=6, samples=200, batch_size=2, num_points=32,
                warmup=4)
    assert HOST | DEVICE <= {m["name"] for m in spec["per_layer"]}
    result, numbers, limits, _ = bench.run_cell(spec, 2**31 + 11, 0.1, True,
                                                torch.device("cpu"))
    line, _ = bench.result_line(result, numbers, limits)
    metrics = json.loads(line)["metrics"]
    assert HOST <= set(metrics) and not DEVICE & set(metrics)
    assert metrics["cache_hit_share.train"] == {"value": 100.0, "unit": "%"}
    for name in HOST - {"cache_hit_share.train"}:
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] > 0, name
    # the port's step spans sit inside the benchmark's own
    assert metrics["step_host_ms.train"]["value"] <= metrics["step_ms.train"]["value"]
    assert metrics["batch_ms.train"]["value"] <= metrics["loader_wait_ms.train"]["value"]

    # an untraced run reads none of them, though the tracer still holds the window
    class Untraced:
        spans, trace, window_s, counts, work, memory = {}, None, 1.0, {}, {}, {}

    for name in sorted(HOST | DEVICE):
        assert bench.read_metric(name, Untraced()) is None, name
