"""The port's tracer (sv3d_tpu_torch/utils/profiling.py): spans and counters
inside the training step and the loader, on the profiler's clock, and
fit's --profiler simple|advanced on it.  CPU only: device ms reads None."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sv3d_tpu_torch.config import Config
from sv3d_tpu_torch.data.datasets import SceneNetDataset
from sv3d_tpu_torch.data.loader import DataLoader
from sv3d_tpu_torch.data.splits import write_split
from sv3d_tpu_torch.utils import profiling
from sv3d_tpu_torch.utils.profiling import count, records, span

torch.set_num_threads(1)

#: the step's spans as SceneNetTrainer.train_step nests them (no cloud labelling)
STEP_TREE = {"train.step": None, "train.to_device": "train.step",
             "train.forward": "train.step", "train.backward": "train.step",
             "train.optimizer": "train.step"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The smoke scene at scale 8, and a split "trio" of three copies of it,
    listed twice."""
    root = _chip_smoke().write_smoke_dataset(tmp_path_factory.mktemp("tracing") / "data",
                                             scale_factor=8, n_points=200)
    items = ["00000", "00001", "00002"]
    for kind in ("raw", "processed"):
        for item in items:
            shutil.copytree(root / kind / "overfit" / "00000", root / kind / "trio" / item)
    write_split(root, "trio", "train", items * 2)
    return root


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _trainer(root, tmp_path, **kw):
    from sv3d_tpu_torch.training.trainer_scene_net import SceneNetTrainer

    cfg = Config(seed=0, scale_factor=8, batch_size=1, num_points=16, skip_unet=True,
                 datasetdir=str(root), sanity_steps=0, **kw)
    return SceneNetTrainer(cfg, device="cpu", experiment_dir=tmp_path / "exp")


def _raise(*args, **kwargs):
    raise AssertionError("called while tracing is off")


def test_off_is_a_shared_noop_with_no_annotation_event_or_clock(tree, tmp_path, monkeypatch):
    trainer = _trainer(tree, tmp_path)
    state = trainer.build_state()
    batch = next(iter(trainer._loader(trainer.train_dataset(), shuffle=False, drop_last=True)))
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(profiling, "time_ns", _raise)
    assert span("a") is span("b")
    with span("a"), span("b"):
        count("c")
    trainer.train_step(state, batch, trainer.generator)
    assert records() == {"session": records()["session"], "spans": [], "counters": {}}


def test_nested_spans_record_parent_thread_step_and_the_profilers_clock():
    def worker():
        with span("thread.outer"), span("thread.inner"):
            time.sleep(0.001)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        with span("outer"):
            with span("inner"):
                torch.ones(32, 32) @ torch.ones(32, 32)
            with span("inner"):
                time.sleep(0.002)
        with span("outer"):
            pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    got = records()
    spans = got["spans"]
    assert [s["name"] for s in spans] == ["outer", "inner", "inner", "outer", "thread.outer",
                                          "thread.inner"]
    by_id = {s["id"]: s for s in spans}
    parents = [by_id[s["parent"]]["name"] if s["parent"] is not None else None for s in spans]
    assert parents == [None, "outer", "outer", None, None, "thread.outer"]
    steps = [s["step"] for s in spans]
    assert steps[0] == steps[1] == steps[2] and steps[4] == steps[5]
    assert len({steps[0], steps[3], steps[4]}) == 3
    main = threading.get_ident()
    assert [s["thread"] == main for s in spans] == [True] * 4 + [False] * 2
    outer = spans[0]
    assert outer["host_ms"] >= 2.0 and outer["device_ms"] is None
    assert outer["self_ms"] == pytest.approx(
        outer["host_ms"] - spans[1]["host_ms"] - spans[2]["host_ms"], abs=1e-6)
    # each span's host stamps within 200 us of its annotation on the trace
    # (the profiler annotates the threads it was started on)
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in {s["name"] for s in spans}:
            marks.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for s in spans[:4]:
        assert min(max(abs(s["start_ns"] - a), abs(s["end_ns"] - b))
                   for a, b in marks[s["name"]]) < 200_000, s["name"]
    assert got["counters"] == {}


def test_sessions_part_where_tracing_was_off():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("first"):
            count("n", 2)
    first = records()
    with span("outside"):
        count("n")
    with profile(activities=[ProfilerActivity.CPU]):
        with span("second"):
            count("n")
        with span("third"):
            pass
    second = records()
    assert [s["name"] for s in first["spans"]] == ["first"] and first["counters"] == {"n": 2}
    assert second["session"] == first["session"] + 1
    assert [s["name"] for s in second["spans"]] == ["second", "third"]
    assert second["counters"] == {"n": 1}


@pytest.mark.parametrize("how", ["profiler", "enabled"])
def test_a_scene_net_step_records_its_tree(tree, tmp_path, how):
    trainer = _trainer(tree, tmp_path)
    state = trainer.build_state()
    batch = next(iter(trainer._loader(trainer.train_dataset(), shuffle=False, drop_last=True)))
    on = profile(activities=[ProfilerActivity.CPU]) if how == "profiler" else profiling.enabled()
    with on:
        trainer.train_step(state, batch, trainer.generator)
    spans = records()["spans"]
    by_id = {s["id"]: s for s in spans}
    tree_of = {s["name"]: by_id[s["parent"]]["name"] if s["parent"] is not None else None
               for s in spans}
    assert len(spans) == len(STEP_TREE) and tree_of == STEP_TREE
    assert len({s["step"] for s in spans}) == 1
    assert all(s["device_ms"] is None and s["host_ms"] >= s["self_ms"] >= 0 for s in spans)


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self):
        pass


def test_cuda_events_only_on_device_spans_while_a_profiler_records(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with profiling.enabled():
        with span("host"), span("device", device=True):
            pass
    assert _FakeEvent.made == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with span("host"):
            pass
        assert _FakeEvent.made == 0
        with span("device", device=True):
            pass
    assert _FakeEvent.made == 2


def test_device_work_leaves_the_spans_out(tree, tmp_path, monkeypatch):
    from types import SimpleNamespace

    from sv3d_tpu_torch.bench import timing

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, device_type=cuda, us=5.0, annotation=False):
        return SimpleNamespace(key=key, device_type=device_type, self_device_time_total=us,
                               is_user_annotation=annotation)

    # the profiler mirrors a span on the device's timeline as a user
    # annotation with the device time of the work under it
    averages = [ev("wgrad2d_grouped_direct_kernel"), ev("train.step", us=900.0, annotation=True),
                ev("train.backward", us=800.0, annotation=True), ev("ProfilerStep#1", us=950.0),
                ev("aten::convolution", device_type=cpu), ev("idle_kernel", us=0.0)]
    assert [e.key for e in timing.device_work(averages)] == ["wgrad2d_grouped_direct_kernel"]

    # a train step profiled through profile_calls (the card's synchronise
    # made a no-op): the spans are user annotations, and none is returned
    trainer = _trainer(tree, tmp_path)
    state = trainer.build_state()
    batch = next(iter(trainer._loader(trainer.train_dataset(), shuffle=False, drop_last=True)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with warnings.catch_warnings():  # CUDA activity asked for without a card
        warnings.simplefilter("ignore")
        prof, _, _, events = timing.profile_calls(
            lambda: trainer.train_step(state, batch, trainer.generator), 2)
    marked = {e.key for e in prof.key_averages() if e.is_user_annotation}
    assert set(STEP_TREE) <= marked
    assert not {e.key for e in events} & marked


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_counts_fetches_and_decode_cache_misses(tree, num_workers):
    ds = SceneNetDataset("train", tree, 16, "trio", seed=0)
    loader = DataLoader(ds, batch_size=2, shuffle=True, num_workers=num_workers, seed=0)
    with profiling.enabled():
        epochs = []
        for _ in range(2):
            batches = sum(1 for _ in loader)
            epochs.append(records())
            profiling.reset()
    assert batches == 3
    assert [e["counters"].get("data.fetches") for e in epochs] == [6, 6]
    assert [e["counters"].get("data.cache_misses", 0) for e in epochs] == [3, 0]
    names = [[s["name"] for s in e["spans"]] for e in epochs]
    assert names[0].count("data.batch") == 3 and names[0].count("data.decode") == 3
    assert names[1] == ["data.batch"] * 3


def test_counters_lose_no_update_across_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.enabled():
            threads = [threading.Thread(target=lambda: [count("n") for _ in range(2000)])
                       for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert records()["counters"] == {"n": 16000}


@pytest.mark.parametrize("mode", ["simple", "advanced"])
def test_fit_under_the_profiler_writes_the_tracers_summary(tree, tmp_path, mode):
    _trainer(tree, tmp_path, profiler=mode).fit(max_steps=2)
    assert profiling.TRACER.forced == 0
    summ = json.loads((tmp_path / "exp" / "profile_simple.json").read_text())
    for name in STEP_TREE:
        s = summ["spans"][name]
        assert s["count"] == 2 and s["mean_ms"] == pytest.approx(s["total_ms"] / 2)
        assert 0 <= s["mean_self_ms"] <= s["mean_ms"]
    assert summ["spans"]["data.batch"]["count"] >= 2
    assert summ["counters"]["data.fetches"] >= 2
    trace = tmp_path / "exp" / "profile" / "trace.json"
    assert trace.exists() == (mode == "advanced")
    if mode == "advanced":
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert set(STEP_TREE) | {"data.batch"} <= names


def test_summary_merges_earlier_folds():
    recs = {"spans": [{"name": "a", "host_ms": 3.0, "self_ms": 1.0},
                      {"name": "a", "host_ms": 1.0, "self_ms": 1.0}], "counters": {"n": 2}}
    once = profiling.summary(recs)
    twice = profiling.summary(recs, once)
    assert once["spans"]["a"] == {"count": 2, "total_ms": 4.0, "self_ms": 2.0, "mean_ms": 2.0,
                                  "mean_self_ms": 1.0}
    assert twice["spans"]["a"]["count"] == 4 and twice["counters"] == {"n": 4}
    assert np.isclose(twice["spans"]["a"]["mean_ms"], 2.0)
