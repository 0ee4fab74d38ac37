"""The reduction of a profiler timeline to the traced window's numbers, on
a hand-made Chrome trace (times in microseconds)."""
from __future__ import annotations

import pytest

from gfdm_bench.tracing import summarize


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_and_the_host_call_each_gap_is_charged_to():
    events = [
        _ev("user_annotation", "bench_window", 0, 100),
        _ev("user_annotation", "source", 0, 15),
        _ev("kernel", "k1", 10, 20),
        _ev("kernel", "k2", 20, 20),  # overlaps k1: the union counts it once
        _ev("cuda_runtime", "cudaMemcpyAsync", 40, 20),
        _ev("kernel", "k1", 60, 10),
        _ev("gpu_memcpy", "Memcpy DtoH", 80, 10),
        _ev("kernel", "late", 95, 50),  # clipped to the window
    ]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 10 + 5) * 1e-6)
    assert s["kernel_busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s["kernels"] == 4
    idle = dict(s["breakdown"]["idle_gaps"])
    assert idle["source"] == pytest.approx(10e-6)
    assert idle["cudaMemcpyAsync"] == pytest.approx(20e-6)
    assert idle["host (no traced call)"] == pytest.approx((10 + 5) * 1e-6)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(30e-6) and ops["late"] == pytest.approx(5e-6)


def test_no_window_reads_nothing():
    assert summarize([_ev("kernel", "k", 0, 1)]) == {}
