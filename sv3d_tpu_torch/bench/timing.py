"""Timing helpers of the port's measurement tools (the bench, measure_step
and chip_smoke.py), and the card's published peaks.

Host clock: timed_runs (each run ends in torch.cuda.synchronize(), the time
a caller waits for the result) and host_ms (the time a call takes to
return, the device synchronised outside the timed region).  Device clock:
profile_calls and device_ms (torch.profiler's CUDA activity by kernel
name, user annotations left out by device_work), window_kernels (the
kernels one profiled window holds, beside a launch counter).  device_info
names the card as nvidia-smi does.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# the H100 SXM's published peaks at its full 700 W limit (NVIDIA's data
# sheet): f32 outside the tensor cores, bf16 dense on the tensor cores, and
# device memory
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def device_info(device) -> dict:
    """{"name", "power_limit"} of the card as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or the CPU's name and no
    power limit for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_runs(fn, device, runs: int, warmup: int = 2) -> list:
    """Host-clock seconds of `runs` calls of fn after `warmup` untimed ones,
    each call ending in torch.cuda.synchronize() (on a CUDA device) inside
    its timed region."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return times


def host_ms(fn, reps: int = 51) -> float:
    """Median host-clock milliseconds that one call of fn takes to return
    (the wrapper's Python and its launches; the device is synchronised
    between calls, outside the timed region)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def dev_us(e) -> float:
    """A profiler event's own device microseconds."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_work(averages) -> list:
    """The events of a profile's key_averages() that are the device's own
    work (kernels, copies, sets): CUDA activity with device time, less the
    user annotations that the profiler mirrors on the device's timeline
    (record_function ranges: the program's spans, the schedule's
    ProfilerStep#), which would count the time of the work under them
    again."""
    return [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("ProfilerStep")]


def profile_calls(fn, steps: int):
    """torch.profiler over steps warm calls of fn (two warm-up calls first).
    Returns (profile, host-clock ms a call, device kernel ms a call, kernel
    events by device time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    # the kernels themselves (device events), not the CPU ops that launched them
    events = sorted(device_work(prof.key_averages()), key=dev_us, reverse=True)
    return prof, wall, sum(dev_us(e) for e in events) / 1e3 / steps, events


def device_ms(fn, parts, steps: int = 50, tries: int = 3) -> dict:
    """Device ms a call of fn, in all and by each part of a kernel's name
    (torch.profiler's CUDA activity over `steps` warm calls): {"all": ms,
    part: ms}.  A window in which a part shows no device time (seen on the
    H100: a window whose device events did not come back) is profiled
    again, up to `tries` times; a part still without device time raises."""
    for _ in range(tries):
        _, _, _, events = profile_calls(fn, steps)
        out = {part: sum(dev_us(e) for e in events if part in e.key) / 1e3 / steps
               for part in parts}
        if all(out.values()):
            break
    if not all(out.values()):
        raise RuntimeError(f"no device time for {[k for k, v in out.items() if not v]} in "
                           f"{tries} profiled windows of {steps} calls")
    out["all"] = sum(dev_us(e) for e in events) / 1e3 / steps
    return out


def window_kernels(fn, calls: int = 10, counter=None) -> tuple:
    """The kernels that torch.profiler records over `calls` calls of fn:
    ({kernel name: launches}, counter() at the window's end less at its
    start, or None).  One call before the window runs as the schedule's
    warm-up step, its events dropped, so that the device's tracing is
    running when the window starts; each call is synchronised inside its
    step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    done, start = [], None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls, repeat=1),
                 on_trace_ready=lambda p: done.append(p.key_averages())) as prof:
        for i in range(1 + calls):
            if i == 1 and counter is not None:
                start = counter()
            fn()
            torch.cuda.synchronize()
            prof.step()
    if len(done) != 1:
        raise RuntimeError(f"window_kernels: {len(done)} profiled windows came back, not 1")
    kernels = {e.key: e.count for e in device_work(done[0])}
    return kernels, None if counter is None else counter() - start
