"""The coded 64-QAM cell ``service.qam64.coded`` at a size a test run holds,
its reference, its traced-window counter and its least-work count.

``conftest.SMALL`` sizes the cells it lists; this cell's small size is
``SMALL_QAM`` here, handed to ``conftest.dry_run`` through its ``over``
keywords on top of an empty entry for the cell. As in
``test_bench_control.py``: the program's readings lie within the cell's
limits and the control's fail at least one; a step that returns its state
unchanged, half the batch left out and one answer altered each turn
``correct`` false."""
from __future__ import annotations

import contextlib
import os
import types

import pytest
import torch

from conftest import SMALL, dry_run

from gfdm_bench import run as bench
from gfdm_bench.counts import gfdm as g
from gfdm_bench.counts import qam as cq
from gfdm_bench.counts.gfdm import RMUL

CELL = "service.qam64.coded"
SMALL_QAM = {"batch_chunks": 32}
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dry(**kw):
    SMALL.setdefault(CELL, {})
    return dry_run(CELL, **SMALL_QAM, **kw)


def test_program_passes_and_control_fails():
    got = _dry(control=True)
    assert got["correct"], got["checks"]
    limits = {k: c["limit"] for k, c in got["checks"].items()}
    failed = [k for k, lim in limits.items() if got["control"].get(k, 0.0) > lim]
    assert failed, (got["control"], limits)


def _fault(kind, monkeypatch):
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    fetch = StreamingReceiver._fetch

    def patch(mod):
        if kind == "half":
            def setup(self, _orig=mod.Driver.setup):
                _orig(self)
                inner = self.rx._step

                def halved(chunks):
                    chunks = chunks.clone()
                    chunks[chunks.shape[0] // 2 :] = 0.0
                    return inner(chunks)

                self.rx._step = halved

            monkeypatch.setattr(mod.Driver, "setup", setup)
            return
        first = {}

        def broken(self, outs, n, keys=()):
            got = fetch(self, outs, n, keys)
            if kind == "unchanged":
                return first.setdefault("out", got)
            i = int(got["found"].nonzero()[0][0])
            got["data"][i, 0, 0] += 0.5
            return got

        monkeypatch.setattr(StreamingReceiver, "_fetch", broken)

    return patch


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind):
    got = _dry(patch=_fault(kind, monkeypatch))
    assert not got["correct"], got["checks"]


def test_the_traced_window_counts_the_coded_bits():
    """trace_window over two batches: ``coded_bits`` is slots x 2,808 a
    batch."""
    drv = _dry(look=lambda d: d)["look"]
    drv.setup()
    drv.p["trace_batches"] = 2
    got = drv.trace_window(lambda name: contextlib.nullcontext())
    assert got == {"batches": 2, "coded_bits": 2 * 32 * 2808}


def test_a_program_without_the_counter_gives_no_key(monkeypatch):
    mod = bench.load_module("drivers", "service_qam")
    monkeypatch.setattr(mod.service.Driver, "trace_window", lambda self, mark: {"batches": 2})
    drv = mod.Driver.__new__(mod.Driver)
    drv.rx = types.SimpleNamespace(stats=types.SimpleNamespace(batches=0))
    assert drv.trace_window(None) == {"batches": 2}


def test_the_readers_read_nothing_without_the_span_or_the_counter():
    wl = bench.load_json("workloads", CELL)
    cfg = bench.load_json("configs", wl["config"])
    run = types.SimpleNamespace(workload=wl, config=cfg, window={},
                                trace={"batches": 6, "kernel_busy_s": 0.3})
    assert bench.load_module("metrics", "rx_step_roofline.qam").read(run) is None
    llr = bench.load_module("metrics", "llr_ms_per_batch.service")
    assert llr.read(types.SimpleNamespace(trace={})) is None
    run.trace["coded_bits"] = 6 * 4096 * 2808
    share = bench.load_module("metrics", "rx_step_roofline.qam").read(run)
    work = cq.qam_step_work(dict(cfg), 4096, 2048 + 752 + 16, 4096, 4, 1398, 64, 6)
    assert share == pytest.approx(100 * (work["bytes"] / 3.35e12) / 0.05)


def test_the_reference_imports_nothing_of_the_program():
    from test_bench_imports import FORBIDDEN, _top_level_imports

    for sub in ("reference", "counts"):
        path = os.path.join(BENCH, sub, "qam.py")
        assert not set(_top_level_imports(path)) & (FORBIDDEN | {"gfdm_tpu_torch"}), path


SHAPE = dict(timeslots=2, subcarriers=4, active_subcarriers=2, overlap=2, cp_len=2, cs_len=1)


def test_the_count_by_hand():
    """64 points: a symbol's 64 distances (a complex subtract, 2 flops, and
    a magnitude squared, 3), then a bit's two minima over 32 (31 compares
    each), a subtract and a scale: 320 + 6 x 64 = 704 flops a symbol.
    At 10 info bits a codeword is 32 coded bits: 32 / 6 symbols."""
    assert cq.llr_flops(64, 6) == 64 * 5 + 6 * (62 + 2) == 704
    base = g.rx_step_work(SHAPE, 5, 32, 3, 4, fec_info_bits=10)
    got = cq.qam_step_work(SHAPE, 5, 32, 3, 4, 10, 64, 6)
    assert got["bytes"] == base["bytes"]
    assert got["flops"] == pytest.approx(base["flops"] + 3 * (32 / 6 * 704 - 32 * 2))


def test_the_count_at_qpsk_is_the_receive_steps():
    for ic in (2, 4):
        assert cq.qam_step_work(SHAPE, 5, 32, 3, ic, 10, 4, 2) == g.rx_step_work(
            SHAPE, 5, 32, 3, ic, fec_info_bits=10)
    assert cq.llr_flops(4, 2) == 2 * RMUL
    assert cq.llr_flops(16, 4) == 16 * 5 + 4 * (14 + 2)


def test_a_near_tie_held_through_the_converged_passes_is_allowed():
    """The program's answer at a found burst replaced by the reference's
    with one decision flipped in the last two passes, where the
    cancellation has converged and the decision's margin is the same in
    both: correct where that margin lies within the cell's ``tie_margin``,
    and a wrong answer where it does not. The decision is one whose flip in
    either pass alone gives another answer, so a reference that flips a
    decision in one pass only would call it wrong too."""
    from gfdm_bench.reference import qam

    drv = _dry(look=lambda d: d)["look"]
    wf, det, front = drv.reference()
    i, out = drv.kept.items[0]
    f = drv.follow(i, out, det, wf, front)
    dr = f["r"]["data"].to(torch.complex128)
    den = (dr - qam.decide(dr)).abs().pow(2).mean(-1).sqrt()
    limit = drv.run.workload["limits"]["payload_gap"]
    shape = f["r"]["margins"].shape[2:]

    def flipped(j, pos, passes):
        flips = torch.ones((4, 1, shape.numel()), dtype=torch.int8)
        flips[list(passes), 0, pos] = -1
        return wf.receive(f["bursts"][j : j + 1], flips=flips.reshape((4, 1) + shape))["data"][0]

    def gap(j, a, b):
        return float((a - b).abs().pow(2).mean().sqrt() / den[j])

    pick = None
    for j in range(dr.shape[0]):
        flat = f["r"]["margins"][:, j].reshape(4, -1)
        same = (flat[2] - flat[3]).abs() < 1e-9  # converged there after pass 2
        for pos in torch.argsort(torch.where(same, flat[3], torch.inf))[:6].tolist():
            both = flipped(j, pos, (2, 3))
            if min(gap(j, both, flipped(j, pos, (p,))) for p in (2, 3)) > 10 * limit:
                pick = (j, pos, both, float(flat[2:, pos].max()))
                break
        if pick:
            break
    assert pick is not None
    j, pos, d, margin = pick
    answer = dict(out, data=out["data"].copy())
    answer["data"][int(f["idx"][j])] = torch.stack([d.real, d.imag]).numpy()
    drv.p["tie_margin"] = margin * 1.01
    assert drv._compare(i, answer, det, wf, front)["payload_gap"] <= limit
    drv.p["tie_margin"] = margin * 0.99
    assert drv._compare(i, answer, det, wf, front)["payload_gap"] > limit


def test_two_near_ties_in_one_burst_are_allowed():
    """The program's answer at a found burst replaced by the reference's
    with two decisions of the last pass flipped: correct where both lie
    within the cell's ``tie_margin`` of their boundary, a wrong answer
    where one does not."""
    drv = _dry(look=lambda d: d)["look"]
    wf, det, front = drv.reference()
    i, out = drv.kept.items[0]
    f = drv.follow(i, out, det, wf, front)
    limit = drv.run.workload["limits"]["payload_gap"]
    shape = f["r"]["margins"].shape[2:]
    j = 0
    last = f["r"]["margins"][3, j].reshape(-1)
    near = torch.argsort(last)[:2]
    flips = torch.ones((4, 1, shape.numel()), dtype=torch.int8)
    flips[3, 0, near] = -1
    d = wf.receive(f["bursts"][j : j + 1], flips=flips.reshape((4, 1) + shape))["data"][0]
    assert float((d - f["r"]["data"][j]).abs().max()) > 1e-3
    answer = dict(out, data=out["data"].copy())
    answer["data"][int(f["idx"][j])] = torch.stack([d.real, d.imag]).numpy()
    margin = float(last[near].max())
    drv.p["tie_margin"] = margin * 1.01
    assert drv._compare(i, answer, det, wf, front)["payload_gap"] <= limit
    drv.p["tie_margin"] = margin * 0.99
    assert drv._compare(i, answer, det, wf, front)["payload_gap"] > limit


def test_a_near_tie_that_a_flip_brings_back_two_passes_later_is_allowed():
    """The program's answer at a found burst replaced by the reference's
    with one decision flipped in pass 1 and again in pass 3, where the
    pass-1 flip, through the neighbours' pass-2 decisions, brings that
    decision back near its boundary; on the reference's own path it lies
    far from it in pass 3, and in pass 2 on either path. Correct where the
    two near margins lie within the cell's ``tie_margin``: a search that
    took its near ties from the reference's own path alone, or held a flip
    only while it stays near, would call it wrong. The burst is the first
    of the batch whose answer is wrong where the margin is just below them
    (another near tie may explain a flip's effect, and then no margin
    binds)."""
    from gfdm_bench.reference import qam

    drv = _dry(look=lambda d: d)["look"]
    wf, det, front = drv.reference()
    i, out = drv.kept.items[0]
    f = drv.follow(i, out, det, wf, front)
    dr = f["r"]["data"].to(torch.complex128)
    den = (dr - qam.decide(dr)).abs().pow(2).mean(-1).sqrt()
    limit = drv.run.workload["limits"]["payload_gap"]
    shape = f["r"]["margins"].shape[2:]

    def flipped(j, pos, passes):
        flips = torch.ones((4, len(pos), shape.numel()), dtype=torch.int8)
        for p in passes:
            flips[p, torch.arange(len(pos)), pos] = -1
        r = wf.receive(f["bursts"][j : j + 1].expand(len(pos), -1),
                       flips=flips.reshape((4, len(pos)) + shape), margins=True)
        return r["data"], r["margins"].reshape(4, len(pos), -1)

    def gap(j, a, b):
        return (a - b).abs().pow(2).mean(-1).sqrt() / den[j]

    def reads(j, d, tie):
        answer = dict(out, data=out["data"].copy())
        answer["data"][int(f["idx"][j])] = torch.stack([d.real, d.imag]).numpy()
        drv.p["tie_margin"] = tie
        return drv._compare(i, answer, det, wf, front)["payload_gap"]

    pick = None
    for j in range(dr.shape[0]):
        own = f["r"]["margins"][:, j].reshape(4, -1)
        pos = torch.argsort(own[1])[:12]
        once, path = flipped(j, pos, (1,))
        twice, thrice = flipped(j, pos, (1, 3))[0], flipped(j, pos, (1, 2, 3))[0]
        v = torch.arange(len(pos))
        near = torch.maximum(own[1, pos], path[3, v, pos])
        far = torch.minimum(path[2, v, pos], own[3, pos])
        apart = torch.minimum(gap(j, twice, once), gap(j, twice, thrice))
        for c in torch.nonzero((near * 1.5 < far) & (apart > 10 * limit))[:, 0].tolist():
            if reads(j, twice[c], float(near[c]) * 0.99) > limit:
                pick = (j, twice[c], float(near[c]))
                break
        if pick:
            break
    assert pick is not None
    j, d, margin = pick
    assert reads(j, d, margin * 1.01) <= limit
