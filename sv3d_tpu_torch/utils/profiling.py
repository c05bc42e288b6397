"""The port's tracer (port of sv3d_tpu/utils/profiling.py; the reference
delegates to Lightning's --profiler flag, SURVEY.md §5): spans and counters
inside the training step and the loader, and torch.profiler traces for
--profiler advanced.

    with span("train.forward"):
        ...
    count("data.fetches")

Tracing is on while a torch.profiler records in the process, or inside
`enabled()` (fit's --profiler simple|advanced).  While it is off a span is a
flag check and a shared no-op context: no record_function, no allocation,
no clock read.  While it is on a span enters
torch.profiler.record_function(name) when a profiler records (a user
annotation on the trace's timeline) and stamps its host start and end with
time.time_ns() inside the annotation (the profiler's clock).  A span opened
with device=True (the step's forward, backward and optimizer) also records
a pair of CUDA timing events on the current stream, while a profiler
records and CUDA is initialised in the process: its device_ms is the
stream's time between them, the kernels it issued and any time the stream
waited for the host to issue them.  Under enabled() alone spans read host
time only.  No span synchronises: the events are read when the records
are, after the caller has synchronised (an event not yet reached reads
None).

Spans and counters stay in memory, grouped in sessions: a new session
starts at the first span or count after one that found tracing off.
`records()` reads the newest session, `reset()` clears it.  A span's parent
is the innermost span open on its thread; `step` is shared by a root span
and every span under it.
"""

from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager, nullcontext
from pathlib import Path
from time import time_ns

import torch
import torch.autograd.profiler as _autograd_profiler

_NOOP = nullcontext()


class _Record:
    __slots__ = ("id", "name", "parent", "thread", "step", "start_ns", "end_ns", "child_ns",
                 "events")

    def __init__(self, id_, name, parent, thread, step):
        self.id, self.name, self.parent, self.thread, self.step = id_, name, parent, thread, step
        self.start_ns = self.end_ns = None
        self.child_ns = 0
        self.events = None


class _Session:
    __slots__ = ("number", "spans", "counters")

    def __init__(self, number: int):
        self.number = number
        self.spans: list = []
        self.counters: dict = {}


class Tracer:
    """The spans and counters of one process (the module's functions use one
    Tracer, TRACER)."""

    def __init__(self):
        #: depth of enabled() contexts
        self.forced = 0
        #: the last span or count found tracing off (or none has run yet)
        self.stale = True
        self.session = _Session(0)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._steps = itertools.count()

    def _current(self) -> _Session:
        """The session a span or count that found tracing on goes into (call
        under self._lock)."""
        if self.stale:
            self.session = _Session(self.session.number + 1)
            self.stale = False
        return self.session

    def add(self, name: str, n: int) -> None:
        with self._lock:
            counters = self._current().counters
            counters[name] = counters.get(name, 0) + n

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def records(self) -> dict:
        """The newest session: {"session": its number, "spans": [{"id",
        "name", "parent" (the id of the span it is under, or None),
        "thread", "step", "start_ns", "end_ns", "host_ms", "self_ms" (host
        ms less its children's), "device_ms" (the stream's ms between the
        span's CUDA events; None without them or before the device reached
        the span's end)}] of its closed spans in the order they opened,
        "counters": {name: n}}."""
        session = self.session
        out = []
        for r in list(session.spans):
            if r.end_ns is None:
                continue
            host_ns = r.end_ns - r.start_ns
            device = None
            if r.events is not None and r.events[1].query():
                device = r.events[0].elapsed_time(r.events[1])
            out.append({"id": r.id, "name": r.name, "parent": r.parent, "thread": r.thread,
                        "step": r.step, "start_ns": r.start_ns, "end_ns": r.end_ns,
                        "host_ms": host_ns * 1e-6, "self_ms": (host_ns - r.child_ns) * 1e-6,
                        "device_ms": device})
        return {"session": session.number, "spans": out, "counters": dict(session.counters)}

    def reset(self) -> None:
        with self._lock:
            self.session = _Session(self.session.number)
            self.stale = True


class _Span:
    """One span while tracing is on (span())."""

    __slots__ = ("tracer", "name", "device", "mark", "rec")

    def __init__(self, tracer: Tracer, name: str, device: bool):
        self.tracer, self.name, self.device = tracer, name, device

    def __enter__(self):
        tracer = self.tracer
        stack = tracer._stack()
        parent = stack[-1] if stack else None
        with tracer._lock:
            session = tracer._current()
            rec = _Record(len(session.spans), self.name, parent.id if parent else None,
                          threading.get_ident(),
                          parent.step if parent else next(tracer._steps))
            session.spans.append(rec)
        self.mark = None
        if _autograd_profiler._is_profiler_enabled:
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        rec.start_ns = time_ns()
        if self.device and self.mark is not None and torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        self.rec = rec
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time_ns()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        stack = self.tracer._stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += rec.end_ns - rec.start_ns
        return False


TRACER = Tracer()


def span(name: str, device: bool = False):
    """A context manager: the span `name` while tracing is on, a shared no-op
    context while it is off.  device=True times it on the stream too, while
    a profiler records."""
    if TRACER.forced or _autograd_profiler._is_profiler_enabled:
        return _Span(TRACER, name, device)
    TRACER.stale = True
    return _NOOP


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` of the session while tracing is on."""
    if TRACER.forced or _autograd_profiler._is_profiler_enabled:
        TRACER.add(name, n)
    else:
        TRACER.stale = True


def records() -> dict:
    """The newest session's spans and counters (Tracer.records)."""
    return TRACER.records()


def reset() -> None:
    """Clears the spans and counters; the next span or count that finds
    tracing on opens a new session."""
    TRACER.reset()


@contextmanager
def enabled():
    """Tracing on for the body (fit's --profiler), whether or not a
    profiler records."""
    TRACER.forced += 1
    try:
        yield
    finally:
        TRACER.forced -= 1


def summary(recs: dict, into: dict | None = None) -> dict:
    """The per-span summary of records() (merged into `into`, an earlier
    summary, where given): {"spans": {name: {"count", "total_ms",
    "mean_ms", "self_ms", "mean_self_ms"}} (host ms), "counters"}."""
    spans = {k: dict(v) for k, v in (into or {}).get("spans", {}).items()}
    counters = dict((into or {}).get("counters", {}))
    for r in recs["spans"]:
        s = spans.setdefault(r["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += r["host_ms"]
        s["self_ms"] += r["self_ms"]
    for s in spans.values():
        s["mean_ms"] = s["total_ms"] / s["count"]
        s["mean_self_ms"] = s["self_ms"] / s["count"]
    for k, v in recs["counters"].items():
        counters[k] = counters.get(k, 0) + v
    return {"spans": spans, "counters": counters}


@contextmanager
def trace(log_dir: str | Path, cuda: bool = False, write: bool = True):
    """torch.profiler trace context (the 'advanced' profiler): the host's
    activity and the spans above, and the card's with cuda; on exit, with
    write, the trace goes to <log_dir>/trace.json (chrome://tracing or
    Perfetto load it).  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if write:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
