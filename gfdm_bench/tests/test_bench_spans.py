"""The program's spans in a traced window (``spans.reduce``), on a hand-made
Chrome trace (times in microseconds), and the span metrics' readers."""
from __future__ import annotations

import types

import pytest

from gfdm_bench import run as bench
from gfdm_bench.spans import reduce
from gfdm_bench.tracing import summarize

READERS = {
    "stage_ms_per_batch.service": ("gfdm.service.stage", "batches"),
    "enqueue_ms_per_batch.service": ("gfdm.service.step", "batches"),
    "decode_enqueue_ms_per_batch.service": ("gfdm.service.decode", "batches"),
    "fetch_wait_ms_per_batch.service": ("gfdm.service.fetch.wait", "batches"),
    "fetch_copy_ms_per_batch.service": ("gfdm.service.fetch.copy", "batches"),
    "enqueue_ms_per_step.link": ("gfdm.link.step", "steps"),
}


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def test_one_gap_is_shared_by_the_ranges_it_runs_through():
    events = [
        _ev("user_annotation", "bench_window", 0, 100),
        _ev("user_annotation", "source", 0, 100),  # not the program's: ignored
        _ev("kernel", "k", 0, 10),
        _ev("gpu_memcpy", "Memcpy HtoD", 90, 10),
        _ev("user_annotation", "gfdm.service.stage", -10, 15),  # clipped to [0, 5]
        _ev("user_annotation", "gfdm.service.fetch.copy", 5, 25),
        _ev("cuda_runtime", "cudaMemcpyAsync", 6, 20),  # not a span
        _ev("user_annotation", "gfdm.service.sink", 30, 20),
        _ev("user_annotation", "gfdm.service.pull", 50, 10),
        _ev("user_annotation", "gfdm.service.step", 60, 25),
        _ev("user_annotation", "gfdm.service.detect", 62, 8),  # nested in step
    ]
    r = reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["idle_s"] == pytest.approx(80e-6)  # the one gap, [10, 90]
    idle = r["idle_by_span"]
    assert idle["gfdm.service.fetch.copy"] == pytest.approx(20e-6)
    assert idle["gfdm.service.sink"] == pytest.approx(20e-6)
    assert idle["gfdm.service.pull"] == pytest.approx(10e-6)
    assert idle["gfdm.service.step"] == pytest.approx(17e-6)  # less its child
    assert idle["gfdm.service.detect"] == pytest.approx(8e-6)
    assert idle["unattributed"] == pytest.approx(5e-6)
    assert "gfdm.service.stage" not in idle  # the device was busy under it
    assert sum(idle.values()) == pytest.approx(r["idle_s"])
    assert r["spans"]["gfdm.service.stage"] == [pytest.approx(5e-6), 1]
    assert r["spans"]["gfdm.service.step"] == [pytest.approx(25e-6), 1]
    assert "source" not in r["spans"]
    # the gap-start reduction charges the whole gap to the innermost host
    # call at its start, and is left as it was
    assert dict(summarize(events)["breakdown"]["idle_gaps"]) == {
        "cudaMemcpyAsync": pytest.approx(80e-6)}


def test_idle_with_no_span_open_is_unattributed():
    events = [
        _ev("user_annotation", "bench_window", 0, 50),
        _ev("kernel", "k", 10, 10),
        _ev("user_annotation", "gfdm.service.step", 0, 10),  # the device idle under it
        _ev("user_annotation", "gfdm.service.step", 20, 5),
    ]
    r = reduce(events)
    assert r["idle_by_span"]["gfdm.service.step"] == pytest.approx(15e-6)
    assert r["idle_by_span"]["unattributed"] == pytest.approx(25e-6)
    assert r["spans"]["gfdm.service.step"] == [pytest.approx(15e-6), 2]


def test_no_window_reads_nothing():
    assert reduce([_ev("user_annotation", "gfdm.service.step", 0, 1)]) == {}


def _run(trace):
    return types.SimpleNamespace(trace=trace, window={})


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_the_profiled_span_over_the_window(metric, monkeypatch):
    from gfdm_tpu_torch.utils import profiling

    name, count = READERS[metric]
    read = bench.load_module("metrics", metric).read
    monkeypatch.setattr(profiling, "_PROFILED", {})
    assert read(_run({})) is None  # no traced window
    assert read(_run({count: 4})) is None  # the span never ran under the profiler
    monkeypatch.setattr(profiling, "_PROFILED", {name: 0.02})
    assert read(_run({count: 4})) == pytest.approx(5.0)
    assert read(_run({count: 0})) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_nothing_from_a_program_without_spans(metric, monkeypatch):
    """A program without ``profiled_spans`` (the parent of the spans) reads None."""
    from gfdm_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "profiled_spans")
    _name, count = READERS[metric]
    assert bench.load_module("metrics", metric).read(_run({count: 4})) is None


def test_every_reader_is_a_benchmark_metric():
    import json

    spec = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for metric in READERS:
        assert per_layer[metric]["source"] == "program_span"
        assert per_layer[metric]["workloads"]
