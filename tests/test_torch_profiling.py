"""The port's stage timer (gfdm_tpu_torch.utils.profiling) on CPU tensors:
tests/test_profiling.py's five cases, and the profiler trace; the host
spans (``span``): their sums, their profiler ranges and no synchronize.
The timer against CUDA events on a card is in tests/test_torch_gpu.py."""
import json
import time

import numpy as np
import pytest
import torch

from gfdm_tpu_torch.utils.profiling import StageTimer, force, profiled_spans, span, trace_to

torch.set_num_threads(1)


def test_stage_fences_on_assigned_result():
    timer = StageTimer()
    x = torch.ones((256, 256))

    def work(a):
        for _ in range(8):
            a = a @ a / 256.0
        return a

    work(x)
    with timer.stage("matmul") as s:
        s.value = work(x)
    assert timer.counts["matmul"] == 1
    assert "matmul" not in timer.unfenced
    assert torch.isfinite(s.value).all()
    assert timer.times["matmul"] > 0


def test_stage_without_assignment_is_flagged_unfenced():
    timer = StageTimer()
    with timer.stage("dispatch_only"):
        torch.ones(4) * 2
    assert "dispatch_only" in timer.unfenced
    assert "(dispatch only)" in timer.report()


def test_timeit_measures_execution_not_dispatch():
    """A deliberately slow stage shows its real duration."""
    timer = StageTimer()

    def slow(x):
        time.sleep(0.02)
        return x + 1

    dt = timer.timeit("slow", slow, torch.zeros(3), iters=3, warmup=1)
    assert dt >= 0.02
    assert timer.counts["slow"] == 3


def test_force_handles_pytrees_and_scalars():
    tree = {"a": torch.arange(6).reshape(2, 3), "b": (torch.tensor(1.5), None), "c": [1.0]}
    force(tree)  # must not raise on nested / scalar / None leaves
    force(None)
    force(np.zeros(3))  # non-tensor leaves are ignored


def test_report_throughput_column():
    timer = StageTimer()
    timer.timeit("stage_a", lambda: torch.zeros(8), iters=2, warmup=1)
    rep = timer.report(samples_per_call={"stage_a": 1_000_000})
    assert "stage_a" in rep and "Msamp/s" in rep
    assert rep.splitlines()[0].split() == ["stage", "calls", "ms/call", "Msamp/s"]


def test_trace_to_writes_a_chrome_trace(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def _annotations(path):
    """(name, ts, dur) of every gfdm.* user annotation of a Chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("gfdm.")]


def test_span_adds_its_seconds_into_and_nests():
    into = {}
    with span("gfdm.outer", into):
        with span("gfdm.inner", into):
            time.sleep(0.01)
        with span("gfdm.inner", into):
            pass
    assert set(into) == {"gfdm.outer", "gfdm.inner"}
    assert into["gfdm.inner"] >= 0.01
    assert into["gfdm.outer"] >= into["gfdm.inner"]
    with span("gfdm.bare"):  # no into: timed for the profiler alone
        pass
    assert "gfdm.bare" not in into


def test_span_counts_a_block_that_raises():
    into = {}
    try:
        with span("gfdm.raises", into):
            raise KeyError("x")
    except KeyError:
        pass
    assert into["gfdm.raises"] >= 0.0


@pytest.mark.parametrize("profiled", [False, True])
def test_span_opens_a_profiler_range_only_while_one_records(profiled, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    before = profiled_spans().get("gfdm.maybe", 0.0)
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with span("gfdm.maybe"):
                pass
    else:
        with span("gfdm.maybe"):
            pass
    assert opened == (["gfdm.maybe"] if profiled else [])
    grew = profiled_spans().get("gfdm.maybe", 0.0) > before
    assert grew == profiled


def test_span_makes_no_synchronize(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("span synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    into = {}
    with span("gfdm.quiet", into):
        torch.ones(8) + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("gfdm.quiet", into):
            torch.ones(8) + 1
    assert into["gfdm.quiet"] > 0


def test_trace_to_shows_spans_as_user_annotations(tmp_path):
    with trace_to(str(tmp_path / "trace")):
        with span("gfdm.outer"):
            for _ in range(3):
                with span("gfdm.inner"):
                    (torch.ones(16, 16) @ torch.ones(16, 16)).sum()
    got = _annotations(tmp_path / "trace" / "trace.json")
    names = [g[0] for g in got]
    assert names.count("gfdm.outer") == 1 and names.count("gfdm.inner") == 3
    (_, o_ts, o_dur), = [g for g in got if g[0] == "gfdm.outer"]
    for _, ts, dur in (g for g in got if g[0] == "gfdm.inner"):
        assert o_ts <= ts and ts + dur <= o_ts + o_dur


def test_a_worker_span_counts_with_the_callers_profiler_state():
    """A span on a worker thread, handed the recording thread's profiler
    state, counts in profiled_spans(); the same span without it does not
    (the profiler records only the thread that started it)."""
    from concurrent.futures import ThreadPoolExecutor

    def on_worker(name, profiled):
        with span(name, profiled=profiled):
            time.sleep(0.001)
        return torch.autograd._profiler_enabled()

    before = profiled_spans()
    with ThreadPoolExecutor(max_workers=1) as worker:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            state = torch.autograd._profiler_enabled()
            worker_state = worker.submit(on_worker, "gfdm.worker.handed", state).result()
            worker.submit(on_worker, "gfdm.worker.alone", None).result()
    assert state and not worker_state
    after = profiled_spans()
    assert after["gfdm.worker.handed"] >= before.get("gfdm.worker.handed", 0.0) + 1e-3
    assert after.get("gfdm.worker.alone") == before.get("gfdm.worker.alone")
