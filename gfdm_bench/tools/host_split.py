"""Where a cell's host time goes, by the program's own spans, in one
process: measured windows timed from inside (``ServiceStats.host_s``) and
from outside (``service_windows._timed`` around ``_dispatch`` and
``_fetch``), then a traced window whose device idle time is split by the
innermost span open at each microsecond (``spans.reduce``) beside the
gap-start charge of ``tracing.summarize``.

    python3 -m gfdm_bench.tools.host_split --workload service.default.impaired \\
        --seed 4100000 --windows 2 --seconds 10 [--depths 2,1,2,1]

Prints one ``SPLIT`` JSON line:

- ``span_cost_us``: one empty span, with the profiler off and on;
- ``windows`` (service cells): each window's ``pipeline_depth`` (the
  cell's, or one of ``--depths`` a window), rate and batches, and per
  batch in ms: ``_dispatch`` and ``_fetch`` timed from outside, every
  ``gfdm.service.*`` span of ``host_s`` timed from inside, and the sums
  ``dispatch_spans`` (stage + h2d + step) and ``fetch_spans`` (wait + copy +
  account) that the outside times should match;
- ``traced``: the traced window's ms per batch (or step), each span's ms
  per batch (or step) and count, ``idle_by_span`` in ms per batch (or step)
  and as shares of the idle time, and ``idle_gaps``, ``tracing.summarize``'s
  gap-start labels.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

from gfdm_bench import run as bench
from gfdm_bench import spans, tracing
from gfdm_bench.tools.service_windows import _timed


def _span_cost_us(torch, n: int = 20000) -> dict:
    """Microseconds of one empty span, with the profiler off and on."""
    from torch.profiler import ProfilerActivity, profile

    from gfdm_tpu_torch.utils.profiling import span

    def per():
        into: dict = {}
        t0 = time.perf_counter()
        for _ in range(n):
            with span("gfdm.cost", into):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per()
    with profile(activities=[ProfilerActivity.CPU]):
        on = per()
    return {"off": off, "on": on}


def _window(driver, seconds: float, depth: int | None) -> dict:
    rx = driver.rx
    if depth is not None:
        rx.pipeline_depth = depth
    outside = {"_dispatch": [], "_fetch": []}
    for name, lst in outside.items():
        _timed(rx, name, lst)
    before = dict(rx.stats.host_s)
    w = driver.window(seconds)
    for name in outside:
        delattr(rx, name)
    n = max(len(outside["_fetch"]), 1)
    inside = {k: (v - before.get(k, 0.0)) * 1e3 / n for k, v in rx.stats.host_s.items()}

    def total(*names):
        return sum(inside.get(f"gfdm.service.{k}", 0.0) for k in names)

    return {"depth": rx.pipeline_depth, "rate": w["metrics"]["rx_samples_per_s"],
            "batches": w["batches"], "fetched": n,
            "dispatch_ms": sum(outside["_dispatch"]) * 1e3 / n,
            "fetch_ms": sum(outside["_fetch"]) * 1e3 / n,
            "dispatch_spans": total("stage", "h2d", "step"),
            "fetch_spans": total("fetch.wait", "fetch.copy", "account"),
            "spans_ms": dict(sorted(inside.items()))}


def _traced(driver, run, torch) -> dict:
    """``tracing.traced``'s window, its events kept and reduced twice."""
    from torch.profiler import ProfilerActivity, profile, record_function

    @contextlib.contextmanager
    def mark(name):
        with record_function(name):
            yield

    torch.cuda.synchronize(run.device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench_window"):
            counts = driver.trace_window(mark)
            torch.cuda.synchronize(run.device)
    wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    per = counts.get("batches") or counts.get("steps")
    s = tracing.summarize(events)
    r = spans.reduce(events)
    idle = r["idle_s"] or 1.0
    return {"counts": counts, "wall_ms_per": wall * 1e3 / per,
            "window_ms_per": r["window_s"] * 1e3 / per, "idle_ms_per": r["idle_s"] * 1e3 / per,
            "busy_ms_per": s["busy_s"] * 1e3 / per,
            "spans_ms_per": {k: [v[0] * 1e3 / per, v[1]] for k, v in sorted(r["spans"].items())},
            "idle_by_span_ms_per": {k: v * 1e3 / per for k, v in r["idle_by_span"].items()},
            "idle_by_span_share": {k: v / idle for k, v in r["idle_by_span"].items()},
            "idle_gaps_ms_per": [[k, v * 1e3 / per] for k, v in s["breakdown"]["idle_gaps"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="service.default.impaired")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--depths", default="",
                    help="comma-separated pipeline_depth of each window (replaces --windows)")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("host_split: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = bench.load_json("workloads", args.workload)
    cfg = bench.load_json("configs", wl["config"])
    run = bench.Run(wl, cfg, args.seed, args.seconds, True, device)
    driver = bench.load_module("drivers", wl["driver"]).Driver(run)
    driver.setup()
    out = {"workload": args.workload, "seed": args.seed, "span_cost_us": _span_cost_us(torch)}
    if hasattr(driver, "rx"):
        depths = ([int(d) for d in args.depths.split(",")] if args.depths
                   else [None] * args.windows)
        cell_depth = driver.rx.pipeline_depth
        out["windows"] = [_window(driver, args.seconds, d) for d in depths]
        driver.rx.pipeline_depth = cell_depth
    out["traced"] = _traced(driver, run, torch)
    print("SPLIT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
