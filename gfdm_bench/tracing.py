"""The traced window: a short stretch of the cell's own load under
torch.profiler, reduced to a device timeline.

The driver's ``trace_window(mark)`` drives a few more steps (or batches)
exactly as the measured window does, wrapping its host phases in
``mark(name)`` ranges. The profiler's Chrome trace (written to a temporary
directory under ``TMPDIR`` and deleted) gives:

- ``window_s``: the traced window, from its first host call to the moment
  its last output is on the host (the ``bench_window`` range);
- ``busy_s``: the union of every device kernel, copy and memset interval
  inside it; ``kernel_busy_s`` the union of kernels alone;
- ``kernels``: the number of kernels, and ``device_ops``: the ten device
  operations with the most time (by name, seconds summed);
- ``idle_gaps``: the device's idle time inside the window, each gap
  charged to the innermost host range (a ``mark``, else an operator or
  runtime call) running at the gap's start, the ten largest by name;
- ``event_s``: the same window timed by CUDA events on the stream, which
  the profiler's device time is checked against.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def _union(intervals: list) -> float:
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals: list, lo: float, hi: float) -> list:
    """Idle (start, end) gaps of the device inside [lo, hi]."""
    gaps, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def summarize(events: list, window_name: str = "bench_window") -> dict:
    """Reduce Chrome-trace events to the traced window's device timeline."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == window_name]
    if not win:
        return {}
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, kern, by_name = [], [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            kern.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in HOST_CATS and "dur" in e
                  and e.get("name") != window_name)
    starts = [h[0] for h in host]
    idle = {}
    for a, b in _gaps(dev, lo, hi):
        label = "host (no traced call)"
        # the innermost host range running at the gap's start: the latest
        # one to start before it that has not ended yet
        for i in range(bisect.bisect_right(starts, a) - 1, -1, -1):
            if host[i][1] > a:
                label = host[i][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a)

    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": _union(dev) * 1e-6,
        "kernel_busy_s": _union(kern) * 1e-6,
        "kernel_sum_s": sum(b - a for a, b in kern) * 1e-6,
        "kernels": len(kern),
        "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)},
    }


def traced(driver, run) -> dict:
    """Drive the cell's traced window under the profiler; see the module
    docstring for what comes back (plus the driver's own counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def mark(name):
        with record_function(name):
            yield

    stream = torch.cuda.current_stream(run.device)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(run.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench_window"):
            ev0.record(stream)
            counts = driver.trace_window(mark)
            ev1.record(stream)
            ev1.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    out = summarize(events)
    if not out or out["busy_s"] <= 0:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    out.update(counts)
    out["event_s"] = ev0.elapsed_time(ev1) * 1e-3
    out["info"] = {"trace": {k: out[k] for k in (
        "window_s", "busy_s", "kernel_busy_s", "kernel_sum_s", "kernels", "event_s")}
        | dict(counts)}
    return out
