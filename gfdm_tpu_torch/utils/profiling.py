"""Stage timing and profiler traces for the port's pipeline stages.

The port of ``gfdm_tpu.utils.profiling``: wall-clock stage timing with
completion fencing, derived throughput, and ``torch.profiler`` traces. A
stage whose result lives on a card is timed with CUDA events recorded on
its device's current stream around the stage (the device's time from the
stage's first enqueued work to its last); one whose result lives on the
host is timed with ``time.perf_counter``. CUDA calls return before the card
finishes, so a host clock without a synchronize would time the enqueue.

``span`` is the other kind: a host-only range for a hot path. It never
synchronizes, so it times what the host spent in the block (enqueueing,
copying, waiting), and while a ``torch.profiler`` records (``trace_to``)
it also opens a ``record_function`` range of the same name, which lies on
the profiler's clock beside the device's kernels and copies.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["StageTimer", "force", "profiled_spans", "span", "trace_to"]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _cuda_devices(tree) -> set:
    return {t.device.index if t.device.index is not None else torch.cuda.current_device()
            for t in _leaves(tree) if t.device.type == "cuda"}


def force(result) -> None:
    """Wait until every tensor in ``result`` (a tensor, or nested dicts,
    lists and tuples of them; other leaves are ignored) is computed:
    synchronize each CUDA device a leaf lives on. CPU leaves are computed
    when they are returned."""
    for index in _cuda_devices(result):
        torch.cuda.synchronize(index)


class _StageResult:
    """Mutable holder the ``stage()`` context yields; assign ``.value``."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None


class _Clock:
    """A host clock and, on each CUDA device already in use, a start event
    on its current stream; ``seconds(result)`` stops the clock the result's
    placement calls for and waits for the result."""

    def __init__(self):
        self.starts = {}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for index in range(torch.cuda.device_count()):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(index))
                self.starts[index] = ev
        self.t0 = time.perf_counter()

    def seconds(self, result) -> float:
        devices = _cuda_devices(result)
        if devices and devices <= set(self.starts):
            dt = 0.0
            for index in devices:
                stop = torch.cuda.Event(enable_timing=True)
                stop.record(torch.cuda.current_stream(index))
                stop.synchronize()
                dt = max(dt, self.starts[index].elapsed_time(stop) / 1e3)
            return dt
        force(result)  # first CUDA use inside the stage, or host work
        return time.perf_counter() - self.t0


@dataclass
class StageTimer:
    """Accumulates per-stage time with completion fencing.

    Usage:
        timer = StageTimer()
        with timer.stage("tx") as s:
            s.value = tx_step(data)   # assign so the fence sees the result
        print(timer.report(samples_per_call={"tx": batch * frame_len}))

    If ``s.value`` is left unassigned the stage measures the host's time to
    enqueue only (recorded in ``unfenced``).
    """

    times: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    unfenced: set = field(default_factory=set)

    def _add(self, name: str, seconds: float, calls: int) -> None:
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + calls

    @contextlib.contextmanager
    def stage(self, name: str):
        holder = _StageResult()
        clock = _Clock()
        yield holder
        if holder.value is None:
            self.unfenced.add(name)
            dt = time.perf_counter() - clock.t0
        else:
            dt = clock.seconds(holder.value)
        self._add(name, dt, 1)

    def timeit(self, name: str, fn, *args, iters: int = 5, warmup: int = 1):
        """Time ``fn(*args)`` over ``iters`` calls after ``warmup`` calls,
        fenced on the last result; returns seconds a call."""
        out = None
        for _ in range(warmup):
            out = fn(*args)
        force(out)
        clock = _Clock()
        for _ in range(iters):
            out = fn(*args)
        dt = clock.seconds(out) / iters
        self._add(name, dt * iters, iters)
        return dt

    def report(self, samples_per_call: dict | None = None) -> str:
        lines = [f"{'stage':<24}{'calls':>7}{'ms/call':>10}{'Msamp/s':>10}"]
        for name, total in sorted(self.times.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            per = total / n
            thr = ""
            if samples_per_call and name in samples_per_call:
                thr = f"{samples_per_call[name] / per / 1e6:10.1f}"
            mark = " (dispatch only)" if name in self.unfenced else ""
            lines.append(f"{name:<24}{n:>7}{per * 1e3:>10.3f}{thr:>10}{mark}")
        return "\n".join(lines)


_PROFILED: dict = {}  # span name -> host seconds while a profiler recorded


@contextlib.contextmanager
def span(name: str, into: dict | None = None, profiled: bool | None = None):
    """Time the block on the host clock (``time.perf_counter_ns``) and add
    its seconds to ``into[name]`` when ``into`` is given. While a
    ``torch.profiler`` records the calling thread the block is also a
    ``record_function(name)`` range, and its seconds go to
    ``profiled_spans()``. Makes no synchronize and touches no tensor: on a
    card it times the host's enqueue, not the device's work. The program's
    spans are named ``gfdm.<layer>.<phase>``.

    A profiler records only the thread that started it. A block that runs
    on a worker thread on behalf of another passes that thread's
    ``torch.autograd._profiler_enabled()``, read when the work was handed
    over, as ``profiled``: its seconds then go to ``profiled_spans()``
    while that thread's profiler records, though no range reaches the
    trace."""
    ranged = torch.autograd._profiler_enabled()
    if profiled is None:
        profiled = ranged
    t0 = time.perf_counter_ns()
    try:
        if ranged:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        dt = (time.perf_counter_ns() - t0) * 1e-9
        if into is not None:
            into[name] = into.get(name, 0.0) + dt
        if profiled:
            _PROFILED[name] = _PROFILED.get(name, 0.0) + dt


def profiled_spans() -> dict:
    """{span name: host seconds} of every ``span`` that ran while a
    ``torch.profiler`` recorded this process, summed since it started: the
    host split of exactly the profiled stretches."""
    return dict(_PROFILED)


@contextlib.contextmanager
def trace_to(logdir: str):
    """``torch.profiler`` trace of the block (host, and the cards when
    there are any), written as a Chrome trace to ``logdir/trace.json``
    (chrome://tracing, Perfetto). The program's ``span`` ranges appear in
    it as user annotations named ``gfdm.*``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
