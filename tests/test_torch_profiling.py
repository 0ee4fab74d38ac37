"""The port's stage timer (gfdm_tpu_torch.utils.profiling) on CPU tensors:
tests/test_profiling.py's five cases, and the profiler trace. The timer
against CUDA events on a card is in tests/test_torch_gpu.py."""
import json
import time

import numpy as np
import torch

from gfdm_tpu_torch.utils.profiling import StageTimer, force, trace_to

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
