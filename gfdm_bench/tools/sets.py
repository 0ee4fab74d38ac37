"""Run cells several times, each run a fresh process, and report spreads.

    python3 -m gfdm_bench.tools.sets --out chiprun_out/sets.jsonl \\
        --runs service.default.impaired:101:10:0,service.default.impaired:102:10:0

Each run is ``workload:seed:seconds:trace``; runs go one after another (one
process on the card at a time). Every run's result line, exit code, wall
time and the end of its standard error go to ``--out`` as one JSON line;
at the end a table gives, per workload and metric, the median and the
spread (interquartile range over median, ``statistics.quantiles(n=4)``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / med if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for spec in args.runs.split(","):
        wl, seed, seconds, trace = spec.split(":")
        cmd = [sys.executable, "-m", "gfdm_bench", "--workload", wl, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        wall = time.time() - t0
        lines = [ln for ln in so.strip().splitlines() if ln.startswith("{")]
        result = json.loads(lines[-1]) if lines else None
        row = {"workload": wl, "seed": int(seed), "seconds": float(seconds),
               "trace": int(trace), "rc": rc, "wall_s": wall, "result": result,
               "stderr_tail": se[-6000:]}
        rows.append(row)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        metrics = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        checks = {k: v["value"] for k, v in (result or {}).get("checks", {}).items()}
        print(f"{wl} seed {seed} trace {trace} rc {rc} wall {wall:.1f}s "
              f"correct {None if result is None else result['correct']} {metrics} {checks}",
              flush=True)
        if rc != 0:
            print(se[-3000:], flush=True)
    by: dict = {}
    for r in rows:
        for k, v in ((r["result"] or {}).get("metrics") or {}).items():
            by.setdefault((r["workload"], r["trace"], k), []).append(v["value"])
    for (wl, tr, k), vals in sorted(by.items()):
        print(f"SPREAD {wl} trace {tr} {k} n {len(vals)} median {statistics.median(vals)!r} "
              f"spread {spread(vals)!r} values {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
