"""The superseded receivers' kernels alone on the card, call by call and stage by stage.

Times, with CUDA events after two warm-up calls, each superseded receiver
(``rx_core_fused``, ``rx_ic_fused``, ``rx_full_fused``,
``rx_receiver_hybrid``; csrc/rx.cu) on noisy transmitted bursts: the whole
call over ``reps`` calls, then each launch of its plan
(``fused._variant_plan``: estimate, dft_zf, demod, cancel, hybrid) with an
event around it, the mean of ``reps`` calls. Beside them, the yardstick of
a part: rx_core's two N-point Gauss products as six ``torch.mm`` (TF32
off, cuBLAS's SGEMM; no ZF, no adds, no intermediates), and the fp32 FMA
bound of each call (its Gauss products' and IC's operations at 67
TFLOP/s). The configs: the canonical one at B = 65,536 and the dense
large-K configs (``entry.large_k_config``, M = 9) at K = 128, 256 and 512,
B = 4,096. Then ptxas's registers and spills of each rx.cu kernel (from
the build's log, names demangled where ``c++filt`` is found) and the
card's name and power limit.

Run it from the checkout to time (each checkout's own copy):

    python -m gfdm_tpu_torch.benchmarks.rx_variants [--ic 2] [--reps 10]
    PYTHONPATH=<checkout> python <checkout>/gfdm_tpu_torch/benchmarks/rx_variants.py

It needs a CUDA device and exits 1 without one.
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys

import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config, planar_payload
from gfdm_tpu_torch.kernels import cuda_lib, fused

CASES = (("canonical", 65536), ("K128", 4096), ("K256", 4096), ("K512", 4096))
KEYS = ("rx_core", "rx_ic", "rx_full", "rx_hybrid")
PEAK_FMA = 67e12  # H100 SXM fp32 FMA, no TF32


def _config(name: str) -> GfdmConfig:
    return GfdmConfig() if name == "canonical" else large_k_config(int(name[1:]))


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after two warm-ups."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def stage_ms(fn, reps: int) -> list:
    """Device ms of each launch of ``fn(events)``, which records an event
    before each launch and after the last: the mean of ``reps`` calls after
    a warm-up."""
    fn(None)
    ms = None
    for _ in range(reps):
        ev = []
        fn(ev)
        ev[-1].synchronize()
        one = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        ms = one if ms is None else [m + t for m, t in zip(ms, one)]
    return [m / reps for m in ms]


def bound_ms(key: str, cfg: GfdmConfig, batch: int, ic: int) -> float:
    """The call's Gauss products and IC at the fp32 FMA peak (ms)."""
    n, half, M, L = cfg.block_len, 2 * cfg.subcarriers, cfg.timeslots, cfg.overlap
    ops = 6.0 * n * n  # the N-point DFT
    if key != "rx_core" and key != "rx_ic":
        ops += 6.0 * half * n  # the estimate
    ops += 8.0 * n * (L + M) if key == "rx_hybrid" else 6.0 * n * n
    ops += ic * 8.0 * M * n
    return 1e3 * batch * ops / PEAK_FMA


def ptxas_lines(keys=("rxv",)) -> list:
    """'<kernel>: <ptxas line>' for the registers and spills of every
    kernel whose mangled name holds one of ``keys`` (default: rx.cu's) in
    the library's build log."""
    out, fn = [], None
    for ln in cuda_lib.build_info()["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in keys) and ("registers" in ln or "spill" in ln):
            out.append((fn, ln.split(":", 1)[-1].strip()))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True).stdout.split("\n")
        out = [(n or f, t) for (f, t), n in zip(out, names)]
    return [f"{f}: {t}" for f, t in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ic", type=int, default=2,
                    help="IC iterations of rx_ic, rx_full and rx_hybrid (default 2)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rx_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    amp = 2.0**-0.5
    for name, B in CASES:
        cfg = _config(name)
        n, fs = cfg.block_len, cfg.preamble_len + cfg.cp_len
        data = torch.from_numpy(planar_payload(cfg, B, 5)).to(dev)
        gen = torch.Generator(dev).manual_seed(6)
        bursts = fused.tx_frame_fused(cfg, data)
        bursts = (bursts + 0.01 * torch.randn(bursts.shape, device=dev, generator=gen))
        flat = bursts.reshape(B, -1)
        frames = bursts[..., fs : fs + n].reshape(B, -1).contiguous()
        chan = fused._rx_variant_cuda("rx_hybrid", cfg, flat, None, 0, amp)[0]
        del data
        for key in KEYS:
            ic = 0 if key == "rx_core" else args.ic
            x, c = (frames, chan) if key in ("rx_core", "rx_ic") else (flat, None)
            call = time_ms(lambda: fused._rx_variant_cuda(key, cfg, x, c, ic, amp), args.reps)
            ms = stage_ms(lambda ev: fused._rx_variant_cuda(key, cfg, x, c, ic, amp, events=ev),
                          args.reps)
            names = [s for s, _n, _it in fused._variant_plan(key, ic)]
            bound = bound_ms(key, cfg, B, ic)
            print(f"[rx_variants] {key} {name} B={B} ic={ic}: {call:.4f} ms, fp32 FMA bound "
                  f"{bound:.4f} ms = {bound / call:.1%}; stages "
                  + " ".join(f"{s} {t:.4f}" for s, t in zip(names, ms)), flush=True)
        k = fused._kernel_consts(cfg, dev)
        y = fused._rx_variant_cuda("rx_core", cfg, frames, chan, 0, amp)[1]  # any (B, 2N) rows
        mm_args = []
        for x, g in ((frames, k["F_G"]), (y, k["Bfd_G"])):
            xr, xi = x[:, :n].contiguous(), x[:, n:].contiguous()
            mm_args += [(xr, g[:n]), (xi, g[n : 2 * n]), (xr + xi, g[2 * n :])]
        mm = time_ms(lambda: [torch.mm(a, w) for a, w in mm_args], args.reps)
        print(f"[rx_variants] six torch.mm ({B}, {n}) @ ({n}, {n}) (rx_core's two Gauss "
              f"products), TF32 off, {name}: {mm:.4f} ms", flush=True)
        del bursts, flat, frames, chan, y, mm_args
        torch.cuda.empty_cache()
    for ln in ptxas_lines():
        print(f"[ptxas] {ln}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or 'nvidia-smi unavailable'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
