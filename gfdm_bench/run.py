"""One run of one benchmark cell: load, warm up, measure, check, print.

    python -m gfdm_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell in ``workloads/<name>.json``, its
configuration in ``configs/<config>.json``, its driver in
``drivers/<driver>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``; ``BENCHMARK.json`` at the root lists the cells'
metrics. A run

1. refuses to start without a CUDA device (or with fewer than the cell's
   chips), printing no result;
2. has the driver build the program, the traffic and the weights-free
   constants, and warm up every shape of the cell (``setup_s``: from the
   start of the process to the start of the window);
3. runs the measured window of ``--seconds`` (the end-to-end metrics);
4. with ``--trace 1``, drives a short window more under torch.profiler and
   reads the per-layer metrics from its device timeline;
5. reads the peak memory, frees the program's state, and compares what the
   window delivered with the plain reference (``reference/``), each
   number beside its limit from the cell's file;
6. refuses to print a result if JAX, jaxlib, flax or the JAX package
   ``gfdm_tpu`` was loaded, compared by whole top-level module names;
7. prints the contract's JSON line last on standard output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gfdm_tpu")


def process_start_wall() -> float:
    """Wall-clock time at which this process started (Linux /proc), or now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / ticks
    except (OSError, ValueError, StopIteration):
        return time.time()


PROCESS_T0 = process_start_wall()
MARKS: dict = {}  # set-up phases, seconds after the process started


def mark(name: str) -> None:
    MARKS[name] = round(time.time() - PROCESS_T0, 3)


def load_json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"gfdm_bench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"gfdm_bench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"gfdm_bench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is exactly one of FORBIDDEN."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(workload: str) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metric entries of BENCHMARK.json
    (a metric without ``workloads`` is every cell's)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    build = ROOT / "build"
    os.environ.setdefault("GFDM_TPU_TORCH_BUILD_DIR", str(build / "gfdm_tpu_torch"))
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


class Run:
    """What one run knows, handed to the driver and the metric readers."""

    def __init__(self, workload: dict, config: dict, seed: int, seconds: float,
                 trace: bool, device):
        self.workload, self.config = workload, config
        self.seed, self.seconds, self.trace_on = int(seed), float(seconds), bool(trace)
        self.device = device
        self.window: dict = {}  # the driver's window results
        self.trace: dict = {}  # the traced window's timeline summary


def _card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(run: Run, driver_mod, control: bool = False, look=None) -> dict:
    """Set up, measure, trace, check; returns the result dict (no printing).
    ``control`` adds the control's readings, ``look(driver)`` numbers that
    no limit compares (``tools/readings.py``)."""
    import torch

    from . import common, tracing

    cuda = run.device.type == "cuda"
    driver = driver_mod.Driver(run)
    mark("driver")
    driver.setup()
    if cuda:
        torch.cuda.synchronize(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    t_window = time.time()
    setup_s = t_window - PROCESS_T0
    mark("window")
    run.window = driver.window(run.seconds)
    if run.trace_on:
        run.trace = tracing.traced(driver, run)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    driver.release()
    readings = driver.readings()
    checks = common.checks(readings, run.workload["limits"])
    got = {"setup_s": setup_s, "peak": peak, "checks": checks, "readings": readings}
    if control:
        got["control"] = driver.control()
    if look is not None:
        got["look"] = look(driver)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gfdm_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    mark("main")

    workload = load_json("workloads", args.workload)
    config = load_json("configs", workload["config"])
    driver_mod = load_module("drivers", workload["driver"])
    set_cache_dirs()
    import torch

    chips = int(workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gfdm_bench: the cell needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}, "
              f"devices: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    mark("torch")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    mark("cuda")
    # the program states its precisions: no TF32 unless it asks for it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(workload, config, args.seed, args.seconds, bool(args.trace), device)
    got = execute(run, driver_mod)
    checks = got["checks"]

    e2e, per_layer = cell_metrics(args.workload)
    metrics = {}
    if not args.trace:
        for m in e2e:
            value = (got["setup_s"] if m["name"] == "setup_s"
                     else run.window["metrics"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"gfdm_bench: refused, the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {
        "correct": bool(correct),
        "attempted": int(run.window["attempted"]),
        "failed": int(run.window["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": int(got["peak"])},
    }
    if args.trace:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = checks
    info = {"card": _card_line(), "setup_marks": MARKS, **run.window.get("info", {}),
            **run.trace.get("info", {})}
    print("gfdm_bench info " + json.dumps(info), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
