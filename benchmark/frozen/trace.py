"""Reduction of a torch.profiler trace of the measured window: the device's
busy time (the union of its activity intervals), the kernels that took the
most device time, and the longest idle gaps, each named by the innermost
benchmark span that the host was in (torch.profiler.record_function
annotations and device activity share the trace's clock)."""

from __future__ import annotations

import collections


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _is_annotation(e) -> bool:
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    return bool(getattr(e, "is_user_annotation", lambda: False)()) or "annotation" in kind


def summarize(events, span_names, top: int = 10) -> dict:
    """events: the profiler's raw events (prof.profiler.kineto_results.
    events()).  Returns {"busy_s", "kernels": {name: device s}, "device_ops":
    [[name, s]] (the top), "idle_gaps": [[span, s]] (the longest),
    "n_device_events"}; busy_s is 0 when the trace holds no device
    activity."""
    import torch

    device, spans = [], []
    for e in events:
        s = e.start_ns() * 1e-3
        end = s + e.duration_ns() * 1e-3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _is_annotation(e):
                device.append((s, end, e.name()))
        elif e.name() in span_names:
            spans.append((s, end, e.name()))
    merged = _merge((s, e) for s, e, _ in device)
    busy_us = sum(e - s for s, e in merged)
    per_kernel = collections.Counter()
    for s, e, name in device:
        per_kernel[name] += (e - s) * 1e-6
    longest = sorted(((s1 - e0, e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])),
                     reverse=True)[:top]
    spans.sort(key=lambda x: x[1] - x[0])  # innermost first
    gaps = []
    for length, e0, s1 in longest:
        mid = 0.5 * (e0 + s1)
        label = next((n for s, e, n in spans if s <= mid <= e), "outside_spans")
        gaps.append([label, length * 1e-6])
    return {
        "busy_s": busy_us * 1e-6,
        "kernels": dict(per_kernel),
        "device_ops": [[k, v] for k, v in per_kernel.most_common(top)],
        "idle_gaps": gaps,
        "n_device_events": len(device),
    }
