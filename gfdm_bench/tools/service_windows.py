"""Where a service cell's rate differs between processes: one process's
host copies timed alone, its pool's pages, and several measured windows
with the host time of the program's ``_dispatch`` and ``_fetch``.

    python3 -m gfdm_bench.tools.service_windows --workload service.default.impaired \\
        --seed 4100000 --windows 2 --seconds 10 [--pool-pages as-is|huge|small] [--drift 20]

Run it in several fresh processes one after another and compare the lines:
a cause of a per-process mode moves together with the rate. Prints one
``DIAG`` JSON line:

- ``system``: the transparent-huge-page settings, the NUMA nodes, the CPUs;
- ``pool``: each pool batch's address modulo 2 MiB and the kB of its pages
  that are huge (``/proc/self/smaps``). ``--pool-pages huge`` or ``small``
  first moves the pool into 2 MiB-aligned anonymous memory advised
  ``MADV_HUGEPAGE`` or ``MADV_NOHUGEPAGE``;
- ``alone_ms``: medians of ten, each copy as the program makes it: a pool
  batch into fresh pinned memory (``stage``), that pinned batch to the card
  (``h2d``), a data-sized output back into fresh pageable memory
  (``fetch``) and into pinned memory (``fetch_pinned``), and the kB of
  huge pages under the pinned and the pageable buffer;
- ``windows``: each window's rate and its host milliseconds a batch inside
  ``_dispatch`` and ``_fetch``;
- with ``--drift s``, ``drift``: three host copies timed in turn for s
  seconds, each second's medians (``_drift``).
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import mmap
import os
import statistics
import sys
import time

import numpy as np

from gfdm_bench import run as bench

_HUGE = 2 << 20


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return "unreadable"


def _system() -> dict:
    return {"thp_enabled": _read("/sys/kernel/mm/transparent_hugepage/enabled"),
            "thp_defrag": _read("/sys/kernel/mm/transparent_hugepage/defrag"),
            "numa_nodes": len(glob.glob("/sys/devices/system/node/node[0-9]*")),
            "cpus": len(os.sched_getaffinity(0))}


def _huge_kb(lo: int, hi: int) -> int:
    """kB of AnonHugePages in the mappings that overlap [lo, hi)."""
    total, inside = 0, False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()[0]
            if "-" in head and not head.endswith(":"):
                a, b = (int(x, 16) for x in head.split("-"))
                inside = a < hi and b > lo
            elif inside and head == "AnonHugePages:":
                total += int(line.split()[1])
    return total


def _address(a: np.ndarray) -> int:
    return a.__array_interface__["data"][0]


def _repage(a: np.ndarray, advice: int, keep: list) -> np.ndarray:
    """A copy of ``a`` in 2 MiB-aligned anonymous memory advised ``advice``."""
    size = -(-a.nbytes // _HUGE) * _HUGE
    m = mmap.mmap(-1, size + _HUGE, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    base = ctypes.addressof(ctypes.c_char.from_buffer(m))
    off = (-base) % _HUGE
    m.madvise(advice, off, size)
    out = np.frombuffer(m, dtype=a.dtype, count=a.size, offset=off).reshape(a.shape)
    out[...] = a
    keep.append(m)
    return out


def _median_ms(fn, n: int = 10) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _alone(driver, torch) -> dict:
    """The host copies of one batch, each timed by itself."""
    src = driver.pool[0]
    dev = driver.device

    def stage():
        host = torch.empty(src.shape, dtype=torch.float32, pin_memory=True)
        host.numpy()[...] = src
        return host

    pinned = stage()
    staged_huge_kb = _huge_kb(pinned.data_ptr(), pinned.data_ptr() + pinned.nbytes)

    def h2d():
        pinned.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)

    n_slots = int(driver.p["batch_chunks"]) * driver.k
    out = torch.zeros((n_slots, 2, int(driver.run.config["n_data_symbols"])), device=dev)
    back = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)

    def fetch_pinned():
        back.copy_(out)

    got = out.cpu()
    fetched_huge_kb = _huge_kb(got.data_ptr(), got.data_ptr() + got.nbytes)
    del got
    return {"stage": _median_ms(stage), "h2d": _median_ms(h2d),
            "fetch": _median_ms(lambda: out.cpu().numpy()),
            "fetch_pinned": _median_ms(fetch_pinned),
            "staged_huge_kb": staged_huge_kb, "fetched_huge_kb": fetched_huge_kb}


def _drift(driver, torch, seconds: float) -> list:
    """Three copies of a batch in turn for ``seconds``: the pool into one
    pinned buffer (``pinned``), the pool into pageable memory
    (``pageable``), and pageable memory into pageable memory, neither the
    pool (``plain``). Per second, each copy's median in ms: if all three
    move together, the host's memory bandwidth moves, not one buffer."""
    src = driver.pool[0]
    pinned = torch.empty(src.shape, dtype=torch.float32, pin_memory=True).numpy()
    pageable, other = np.ones_like(src), np.ones_like(src)
    copies = {"pinned": lambda: np.copyto(pinned, src),
              "pageable": lambda: np.copyto(pageable, src),
              "plain": lambda: np.copyto(other, pageable)}
    slots: list = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        slot = int(time.perf_counter() - t0)
        while len(slots) <= slot:
            slots.append({k: [] for k in copies})
        for name, fn in copies.items():
            t = time.perf_counter()
            fn()
            slots[slot][name].append((time.perf_counter() - t) * 1e3)
    return [{k: round(statistics.median(v), 2) for k, v in s.items() if v} for s in slots]


def _timed(rx, name: str, spent: list) -> None:
    inner = getattr(rx, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return inner(*a, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    setattr(rx, name, wrapper)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="service.default.impaired")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pool-pages", choices=("as-is", "huge", "small"), default="as-is")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="seconds of the three copies in turn (_drift), after the windows")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("service_windows: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = bench.load_json("workloads", args.workload)
    cfg = bench.load_json("configs", wl["config"])
    run = bench.Run(wl, cfg, args.seed, args.seconds, False, device)
    driver = bench.load_module("drivers", wl["driver"]).Driver(run)
    driver.setup()
    keep: list = []
    if args.pool_pages != "as-is":
        advice = mmap.MADV_HUGEPAGE if args.pool_pages == "huge" else mmap.MADV_NOHUGEPAGE
        driver.pool = [_repage(a, advice, keep) for a in driver.pool]
        driver._serve(lambda out: None, batches=len(driver.pool) + 2)
    pool = [{"mod_2mib": _address(a) % _HUGE,
             "huge_kb": _huge_kb(_address(a), _address(a) + a.nbytes),
             "kb": a.nbytes >> 10} for a in driver.pool]
    alone = _alone(driver, torch)
    windows = []
    for _ in range(args.windows):
        spent = {"_dispatch": [], "_fetch": []}
        for name, lst in spent.items():
            _timed(driver.rx, name, lst)
        w = driver.window(args.seconds)
        for name in spent:
            delattr(driver.rx, name)
        n = max(len(spent["_fetch"]), 1)
        windows.append({"rate": w["metrics"]["rx_samples_per_s"], "batches": w["batches"],
                        "dispatch_ms": sum(spent["_dispatch"]) * 1e3 / n,
                        "fetch_ms": sum(spent["_fetch"]) * 1e3 / n})
    drift = _drift(driver, torch, args.drift) if args.drift > 0 else None
    print("DIAG " + json.dumps({"seed": args.seed, "pool_pages": args.pool_pages,
                                "system": _system(), "pool": pool, "alone_ms": alone,
                                "windows": windows, "drift": drift}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
