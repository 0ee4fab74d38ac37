"""Each CUDA kernel of the port timed on the card, beside its plain version.

    python -m gfdm_tpu_torch.benchmarks.kernels [--rows 5 6 7] [--reps 5]

The one place that times the kernels: PERF.md §6's rows 1-15 (``--rows``
picks some) at the main paths' shapes. Rows 1-4 and 8-11 run 65,536 bursts
of the canonical config (row 4 with shifts (0, 2), rows 9-11 at IC 2), rows
5 and 7 the large-K configs (``entry.large_k_config``: K = 256, 512 at
4,096 bursts, 1,024 at 2,048, and K = 512 at M = 5), row 6 K = 128 at 4,096
bursts, rows 12-13 the service's 4,096 friendly chunks, row 14 65,536 rows
of ``benchmarks/int8_gauss.py``'s chain, row 15 4,096 codewords of T = 468
and 1,404. Each case prints one line:

- kernel and plain ms: CUDA events around ``--reps`` calls after two
  warm-ups, in turns (plain, kernel, kernel, plain), the plain version on
  the card;
- the library yardstick, where PyTorch runs the function or a part of it;
- the bound: the larger of the operations over their type's peak
  (``PEAKS``) and the bytes (each input read once, each output written
  once) over the card's bandwidth, and which of the two bounds it;
- the launches in one run of the kernel's main path (:meth:`_Rows.main`:
  the entry step and link_step_fused, the CDD link, the large-K links, the
  service's and the coded service's step, the chain step; rows 8-11, which
  no user path runs, one call of the wrapper), its ``LAUNCHES`` counters
  set to zero just before;
- each launch's ms where the wrapper records events (rows 2, 3, 8-11, 14);
- the case's checks (:func:`checks`): the largest |kernel - plain| on the
  same inputs (row 15: the codewords whose bits differ from the plain
  version's on the CPU), then each checked value.

Then ptxas's registers and spills of every kernel, the card's name and
power limit, and a JSON line ``{"kernels": [...]}``, one entry a kernel.
:func:`checks` is the one table of each kernel against its plain version
at the main paths' shapes, which ``chip_smoke.py`` asserts in its phase 3;
``tests/test_torch_gpu.py`` (pytest ``-m gpu``) holds the kernels at every
other shape and option. ``chip_smoke.py`` times with the helpers here
(:func:`time_ms`, :func:`card_line`). To time a variant of a kernel, run
this module from a patched copy of the package.

It needs a CUDA device and nvcc, and exits 1 without a device.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

B = 65536  # bursts (rows) a main-path step
N_CHUNKS, CHUNK_LEN = 4096, 2048  # the service's batch
LARGE_K = ((256, 4096), (512, 4096), (1024, 2048))  # rows 5 and 7 (K, B)
K_FULL, K_ESTIMATOR, B_LARGE_K = 512, 128, 4096  # the JSON's rows 5 and 7; row 6
INT8_BATCHES = (8192, 32768)  # row 14's int8 chain at smaller batches too
VITERBI_T = (468, 1404)  # the coded QPSK and 64-QAM trellis lengths

# H100 SXM (NVIDIA's data sheet, dense rates, 700 W): fp32 FMA, TF32 and
# bf16 tensor cores, FP64 tensor cores, int8, HBM3 bytes/s
PEAKS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp64_tc": 67e12, "int8": 1979e12,
         "bytes": 3.35e12}
# kernels whose operations run at another peak than fp32 FMA: the chain's
# modes at their own; the Viterbi kernel's adds and compares, one an fp32
# lane a clock, half the FMA peak
PEAK_OPS = {"chain_bf16": PEAKS["bf16"], "chain_int8": PEAKS["int8"],
            **{f"viterbi_t{T}": PEAKS["fp32"] / 2 for T in VITERBI_T}}

# JSON key -> (name, port source, the TPU kernel it replaces)
SOURCES = {
    "tx": ("tx_frame_fused", "gfdm_tpu_torch/csrc/tx.cu", "gfdm_tpu/kernels/fused.py:1662"),
    "tx_cdd": ("tx_cdd_fused", "gfdm_tpu_torch/csrc/tx.cu", "gfdm_tpu/kernels/fused.py:1709"),
    "rx": ("rx_receiver_fused", "gfdm_tpu_torch/csrc/link.cu",
           "gfdm_tpu/kernels/fused.py:343"),
    "link": ("link_single_fused", "gfdm_tpu_torch/csrc/link.cu",
             "gfdm_tpu/kernels/fused.py:1403"),
    "detect_front": ("detect_front_fused", "gfdm_tpu_torch/csrc/detect.cu",
                     "gfdm_tpu/kernels/detect.py:71"),
    "detect_lean": ("detect_bursts_fused", "gfdm_tpu_torch/csrc/detect.cu",
                    "gfdm_tpu/kernels/detect.py:164"),
    "tx_factored": ("tx_frame_factored", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:1847"),
    "rx_factored": ("rx_receiver_factored(estimator=fused): rx_estimate_kernel + "
                    "rx_factored_kernel", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:849"),
    "rx_estimate": ("rx_receiver_factored(estimator=fused)'s estimator GEMM "
                    "(rx_estimate_kernel)", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:854"),
    "rx_factored_chan": ("rx_receiver_factored(estimator=fast)",
                         "gfdm_tpu_torch/csrc/factored.cu", "gfdm_tpu/kernels/fused.py:862"),
    "rx_core": ("rx_core_fused", "gfdm_tpu_torch/csrc/rx.cu", "gfdm_tpu/kernels/fused.py:143"),
    "rx_ic": ("rx_ic_fused", "gfdm_tpu_torch/csrc/rx.cu", "gfdm_tpu/kernels/fused.py:206"),
    "rx_full": ("rx_full_fused", "gfdm_tpu_torch/csrc/rx.cu", "gfdm_tpu/kernels/fused.py:684"),
    "rx_hybrid": ("rx_receiver_hybrid", "gfdm_tpu_torch/csrc/rx.cu",
                  "gfdm_tpu/kernels/fused.py:1074"),
    **{f"chain_{v}": (f"gemm_chain({v})", "gfdm_tpu_torch/csrc/chain.cu",
                      "benchmarks/int8_gauss.py:85") for v in ("f32", "bf16", "int8")},
    # no TPU kernel: the JAX decoder is lax.scan
    **{f"viterbi_t{T}": (f"viterbi_decode (kernels.viterbi.decode, T={T})",
                         "gfdm_tpu_torch/csrc/viterbi.cu", None) for T in VITERBI_T},
}


# ---------------------------------------------------------------------------
# timers, the card line, ptxas's report, the launch counters
# ---------------------------------------------------------------------------
def time_ms(fn, iters: int = 5) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after two warm-ups
    (CUDA events on the current stream)."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def timed(fn_k, fn_p, iters: int = 5) -> tuple:
    """Kernel and plain times in turns (plain, kernel, kernel, plain):
    (kernel ms, plain ms, "k1/k2", "p1/p2")."""
    p1, k1, k2, p2 = (time_ms(f, iters) for f in (fn_p, fn_k, fn_k, fn_p))
    return (k1 + k2) / 2, (p1 + p2) / 2, f"{k1:.3f}/{k2:.3f}", f"{p1:.3f}/{p2:.3f}"


def launch_ms(run, reps: int = 3) -> list:
    """Device ms of each launch of ``run(events)``, which records a CUDA
    event before each launch and after the last (the wrappers' ``events``
    argument): the mean of ``reps`` calls after a warm-up."""
    run(None)
    ms = None
    for _ in range(reps):
        ev = []
        run(ev)
        ev[-1].synchronize()
        one = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        ms = one if ms is None else [m + t for m, t in zip(ms, one)]
    return [m / reps for m in ms]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines() -> list:
    """'<kernel>: <registers / spills>' for every kernel in the kernel
    library's nvcc log (names demangled where c++filt is found)."""
    from gfdm_tpu_torch.kernels import cuda_lib

    out, fn = [], None
    for ln in cuda_lib.build_info()["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out.append((fn, ln.split(":", 1)[-1].strip()))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True).stdout.split("\n")
        out = [(n or f, t) for (f, t), n in zip(out, names)]
    return [f"{f}: {t}" for f, t in out]


def _counters() -> tuple:
    from gfdm_tpu_torch.kernels import chain, detect, fused, viterbi

    return fused.LAUNCHES, detect.LAUNCHES, chain.LAUNCHES, viterbi.LAUNCHES


def reset_launches() -> None:
    """Set every kernel wrapper's ``LAUNCHES`` counter to zero."""
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    """Every kernel wrapper's ``LAUNCHES`` counter, in one dict."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def _launches_of(fn) -> dict:
    """The counters after one call of ``fn``, each set to zero before."""
    reset_launches()
    fn()
    return launches()


# ---------------------------------------------------------------------------
# bounds: the least time the card could take at the timed shapes
# ---------------------------------------------------------------------------
def rx_bound(cfg, batch: int, ic_mode: str = "conv", fp64: bool = False) -> tuple:
    """The staged receiver's bound, stated as the link's: its four
    float32-stack Gauss products (estimate, preamble DFT, block DFT, demod)
    as three TF32 products each at 495 TFLOP/s (the card's fastest
    float32-accurate products; ``fp64``: at the FP64 tensor cores' 67
    TFLOP/s, where the kernel sums them), the bf16 IC operator at 989
    TFLOP/s or the conv IC's taps at the fp32 FMA rate, against its bytes
    (bursts in, channel, symbols and metrics out, constants once). Returns
    (bound ms, what bounds it, ms of the design's intermediates: Y, D0, the
    decisions and the preamble power, each written once and read by each
    stage that takes it)."""
    from gfdm_tpu_torch.kernels import fused

    n, half, M, fl = cfg.block_len, 2 * cfg.subcarriers, cfg.timeslots, cfg.frame_len
    met_w, it = fused._met_layout(cfg)[1], 2
    stacks = 6.0 * batch * (half * n + half * half + 2 * n * n)
    t_ops = stacks / PEAKS["fp64_tc"] if fp64 else 3 * stacks / PEAKS["tf32"]
    if ic_mode == "matmul":
        t_ops += it * 6.0 * batch * n * n / PEAKS["bf16"]
        ic_bytes = 2 * 3 * n * n
    else:
        t_ops += it * 8.0 * batch * M * n / PEAKS["fp32"]
        ic_bytes = 4 * 2 * M
    wbytes = 4 * 3 * (half * n + half * half + 2 * n * n)
    t_bytes = (4.0 * batch * (2 * fl + 4 * n + met_w) + wbytes + ic_bytes) / PEAKS["bytes"]
    inter = 4.0 * batch * (2 * 2 * n + (1 + it) * 2 * n + 2 * it * 2 * n + 2 * half)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * inter / PEAKS["bytes"])


def link_bound(cfg, batch: int, ic_mode: str = "matmul", dtype_name: str = "float32") -> tuple:
    """The staged link's bound: its operations at the tensor-core rate of
    their type - each float32-stack Gauss product as three TF32 products at
    495 TFLOP/s, the bf16 IC operator and the bf16 stacks at 989 TFLOP/s but
    those of the Tx and estimate stages, which sum in float64, at the FP64
    tensor cores' 67 TFLOP/s, the conv IC's taps at the fp32 FMA rate -
    against its bytes (payload, outputs and constants once). Returns (bound
    ms, what bounds it, ms of the design's intermediates: F, Y, D0, the
    decisions, each burst's preamble window and its power, each written
    once and read by each stage that takes it)."""
    from gfdm_tpu_torch.kernels import fused

    n, nd, half, M = cfg.block_len, cfg.n_data_symbols, 2 * cfg.subcarriers, cfg.timeslots
    met_w, it = fused._met_layout(cfg)[1], 2
    rounded = 6.0 * batch * (nd * n + half * n + n * n)  # Tx, estimate + DFT
    stacks = rounded + 6.0 * batch * (half * half + n * n)  # + preamble DFT, demod
    bf16 = dtype_name == "bfloat16"
    t_ops = (rounded / PEAKS["fp64_tc"] + (stacks - rounded) / PEAKS["bf16"] if bf16
             else 3 * stacks / PEAKS["tf32"])
    if ic_mode == "matmul":
        t_ops += it * 6.0 * batch * n * n / PEAKS["bf16"]
        ic_bytes = 2 * 3 * n * n
    else:
        t_ops += it * 8.0 * batch * M * n / PEAKS["fp32"]
        ic_bytes = 4 * 2 * M
    wbytes = (2 if bf16 else 4) * 3 * (nd * n + half * n + half * half + 2 * n * n)
    t_bytes = (4.0 * batch * (4 * nd + met_w) + wbytes + ic_bytes) / PEAKS["bytes"]
    inter = 4.0 * batch * (2 * 2 * n * 2 + 2 * n * (1 + it) + 2 * n * 2 * it + 2 * half
                           + 3 * 2 * half)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * inter / PEAKS["bytes"])


def _ols_flops(taps: int) -> float:
    """Operations an output of a ``taps``-tap complex cross-correlation as
    overlap-save FFTs: a forward and an inverse N-point FFT (5 N log2 N
    each) and N complex products (6 N) per N - taps + 1 outputs, at the
    best power-of-two N."""
    return min((10.0 * n * math.log2(n) + 6.0 * n) / (n - taps + 1)
               for n in (2 ** k for k in range(1, 24)) if n > taps)


def work(key: str, cfg, batch: int, ic_mode: str = "conv", ports: int = 1, T: int = 0,
         n_valid: int = 0, direct_dft: bool = False, detect_form: str = "least") -> tuple:
    """(fp32 operations, bytes) of one call of kernel ``key`` at these
    shapes: the kernel's sums as written (a real MAC is 2 operations, a
    complex MAC 8; a Gauss product of an (a, b) operator 3 a b real MACs),
    each input read once (constants included) and each output written once.
    The factored kernels' K-point stage counts as an FFT's 5 M K log2 K for K
    a power of two (what the kernels run), else, or with ``direct_dft``, as
    the direct DFT's 8 M K^2 (the count the kernels' bound used before they
    ran the FFT). The detection kernels' ``detect_form``: "least" counts the
    2K-tap cross-correlation at each gated position in its cheaper form,
    overlap-save FFTs (which the kernels do not run) or the direct FIR, and
    the other traces as window sums; "fir" the direct FIR (what the kernels
    run); "old" every sum taken anew at every position, as a kernel of one
    position a thread would."""
    from gfdm_tpu_torch.kernels import chain, fused

    if key.startswith("viterbi_"):  # radix 16 (k = 4), T trellis steps a codeword
        # a collapsed step: 2^(2k+1) - 2 pattern-sum adds, 64 x 2^k candidate
        # adds and 64 x (2^k - 1) compares; the LLRs in, the bits out, once
        k = 4
        return (batch * (T // k) * ((1 << (2 * k + 1)) - 2 + 64 * ((2 << k) - 1)),
                batch * (8.0 * T + T))
    if key.startswith("chain_"):  # x in, out, the weights once (4, 2 or 1 B)
        wbytes = {"chain_f32": 4, "chain_bf16": 2, "chain_int8": 1}[key]
        shapes = chain.CHAIN_SHAPES
        return (2.0 * batch * sum(a * b for a, b in shapes),
                4.0 * batch * (shapes[0][0] + shapes[-1][1])
                + wbytes * sum(a * b for a, b in shapes))

    n, nd, K, M, L = (cfg.block_len, cfg.n_data_symbols, cfg.subcarriers,
                      cfg.timeslots, cfg.overlap)
    half, fl, f4 = 2 * K, cfg.frame_len, 4
    met_w = fused._met_layout(cfg)[1]

    def g(a, b):  # operations and bytes of a float32 Gauss product
        return 6.0 * a * b, 12.0 * a * b

    conv_ic = 2 * 8.0 * M * n  # 2 iterations, M complex taps an output
    ic = (2 * g(n, n)[0], 6.0 * n * n) if ic_mode == "matmul" else (conv_ic, 8.0 * M)
    est, dft2, dft, bfd, tx = g(half, n), g(half, half), g(n, n), g(n, n), g(nd, n)
    rx_ops = est[0] + dft2[0] + dft[0] + bfd[0] + ic[0]
    rx_const = est[1] + dft2[1] + dft[1] + bfd[1] + ic[1]
    if key in ("tx", "tx_cdd"):
        return batch * tx[0], f4 * batch * (2 * nd + ports * 2 * fl) + tx[1]
    if key == "rx":
        return batch * rx_ops, f4 * batch * (2 * fl + 4 * n + met_w) + rx_const
    if key == "link":
        return batch * (tx[0] + rx_ops), f4 * batch * (4 * nd + met_w) + tx[1] + rx_const
    if key in ("rx_core", "rx_ic"):
        ops = dft[0] + bfd[0] + (conv_ic if key == "rx_ic" else 0.0)
        return batch * ops, f4 * batch * 6 * n + dft[1] + bfd[1]
    if key == "rx_full":
        ops = est[0] + dft[0] + bfd[0] + conv_ic
        return batch * ops, f4 * batch * (2 * fl + 2 * n) + est[1] + dft[1] + bfd[1]
    if key == "rx_hybrid":
        ops = est[0] + dft[0] + 8.0 * n * (L + M) + conv_ic
        return batch * ops, f4 * batch * (2 * fl + 4 * n) + est[1] + dft[1]
    if key == "rx_estimate":  # (B, 4K) @ (4K, 2N): bursts' windows, E_W, chan
        return 2.0 * batch * 4 * K * 2 * n, f4 * (batch * (4 * K + 2 * n) + 4 * K * 2 * n)
    fft = (K & (K - 1)) == 0 and not direct_dft
    kstage = 5.0 * M * K * math.log2(K) if fft else 8.0 * M * K * K
    if key in ("rx_factored", "rx_factored_chan"):
        ops = kstage + 8.0 * n * (2 * M + L) + conv_ic
        io = 2 * fl + 4 * n  # bursts in; chan in or out; symbols out
        if key == "rx_factored":
            return batch * (ops + 16.0 * K * n), f4 * batch * io + 32.0 * K * n
        return batch * ops, f4 * batch * io
    if key == "tx_factored":
        return batch * (kstage + 8.0 * n * (2 * M + L)), f4 * batch * (2 * nd + 2 * fl)
    if key in ("detect_front", "detect_lean"):
        # cc at each gated position: 2K complex MACs (16K operations) or
        # overlap-save FFTs, whichever is less; at every position p, e and ic as window sums, a
        # term in and a term out each (conj(a) b 6, |s|^2 3, in and out 6,
        # 2 / e and ac 3, |ac| 4, ic 3), |cc| / 2K and the gating 6: 31
        n_ac = T - 2 * K
        pos = n_ac if key == "detect_front" else n_valid
        out = 4 * n_ac + n_valid if key == "detect_front" else 2 * n_valid
        nbytes = f4 * batch * (2 * T + out)
        if detect_form == "old":
            return batch * pos * 32.0 * K, nbytes
        xc = 16.0 * K if detect_form == "fir" else min(16.0 * K, _ols_flops(2 * K))
        return batch * (n_valid * xc + pos * 31.0), nbytes
    raise KeyError(key)


def bound(key: str, cfg, batch: int, **kw) -> tuple:
    """The least time (ms) the card could take for kernel ``key``, and what
    bounds it."""
    ops, nbytes = work(key, cfg, batch, **kw)
    t_ops, t_bytes = ops / PEAK_OPS.get(key, PEAKS["fp32"]), nbytes / PEAKS["bytes"]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# ---------------------------------------------------------------------------
# the checks: each kernel against its plain version at the main paths' shapes
# ---------------------------------------------------------------------------
# float32 products summed in another order: bursts ~1e-6, and the receiver's
# ZF divide and IC amplify that by < 100; bf16 stacks against the plain
# version summed in float64 (sum64): an activation on the other side of a
# bf16 rounding boundary moves its burst by up to ~5e-3; the estimator GEMM
# against a float64 product, relative to its largest output (float32 sums of
# 4K terms); the chain relative to the plain version's largest output, int8
# bit for bit
CHECK_TOL = {"tx": 2e-5, "chan": 2e-4, "symbols": 5e-4, "data": 1e-4, "bf16_data": 1e-2,
             "snr_rel": 1e-3, "cnr_rel": 1e-2, "estimate64": 1e-5, "f32_rel": 1e-5,
             "bf16_rel": 1e-2}
# (atol, rtol) of the detection kernels: traces at the JAX package's
# Pallas-vs-reference limits (tests/test_detection.py), the detection dict's
# peak fields at tests/test_torch_detect.py's; the value checked is the
# excess over atol + rtol |plain| in units of atol, at most 1
TRACE_TOL, PEAK_TOL = (3e-5, 3e-3), (1e-6, 1e-4)


class Check(NamedTuple):
    """One case of a kernel against its plain version: ``err`` the largest
    |kernel - plain| (row 15: the codewords whose bits differ), ``parts``
    (name, value, limit) triples, each passing where value <= limit."""

    row: int
    key: str
    label: str
    err: float
    parts: list


def _max_rel(a, b) -> float:
    return float(((a - b).abs() / (b.abs() + 1e-12)).max())


def _excess(a, b, tol: tuple) -> float:
    """max(|a - b| - rtol |b|) / atol: <= 1 where a is within atol + rtol |b|."""
    return float(((a - b).abs() - tol[1] * b.abs()).max()) / tol[0]


def _detect_checks(row: int, key: str, cfg, s, n_valid: int, label: str) -> Check:
    """A detection kernel through its wrappers against its plain version:
    the traces (row 12 the front's four, row 13 the lean kernel's two) and,
    for the lean kernel, the detection dict on its traces (starts equal,
    the peak fields within PEAK_TOL, every value finite)."""
    from gfdm_tpu_torch.kernels import detect

    if key == "detect_front":
        got = detect.detect_front_fused(cfg, s, n_valid)
        ref, names = detect._detect_front_plain(cfg, s, n_valid), ("gated", "ac", "energy", "ic")
    else:
        got = detect._detect_lean_cuda(cfg, s, n_valid)
        ref, names = detect._detect_lean_plain(cfg, s, n_valid), ("gated", "ic")
    parts = [(name, _excess(g, r, TRACE_TOL) if g.shape == r.shape else math.inf, 1.0)
             for name, g, r in zip(names, got, ref)]
    err = max(_max_abs(g, r) for g, r in zip(got, ref))
    if key == "detect_lean":
        out = detect.detect_bursts_fused(cfg, s, n_valid)
        want = detect._lean_epilogue(cfg, s, *ref)
        parts.append(("starts_differing", float((out["start"] != want["start"]).sum()), 0.0))
        parts += [(f, _excess(out[f], want[f], PEAK_TOL), 1.0)
                  for f in ("cfo", "scale", "strength", "ac_peak", "noise_floor")]
        parts.append(("non_finite", float(not all(bool(torch.isfinite(v).all())
                                                  for v in out.values())), 0.0))
    return Check(row, key, label, err, parts)


def checks(dev, rows=range(1, 16)):
    """Each kernel through its public wrapper (the lean detection
    kernel's traces and the estimator GEMM through their launchers) on card
    tensors at the main paths' shapes, against its plain version on the
    same inputs: the cases that rows ``rows`` time (and the sp service's
    sub-chunk windows for rows 12-13), one :class:`Check` each, in row
    order. ``chip_smoke.py`` fails on any part over its limit;
    :class:`_Rows` prints each case's values beside its time."""
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.entry import large_k_config, planar_payload, service_stream
    from gfdm_tpu_torch.kernels import chain, fused, viterbi

    rows, tol = set(rows), CHECK_TOL
    cfg = GfdmConfig()
    if rows & {1, 2, 3, 4, 8, 9, 10, 11}:
        data = torch.from_numpy(planar_payload(cfg, B, seed=0)).to(dev)
        flat = data.reshape(B, -1)
    if 1 in rows:
        e = _max_abs(fused.tx_frame_fused(cfg, data), fused._tx_frame_plain(cfg, flat, 0))
        yield Check(1, "tx", f"tx B={B}", e, [("tx", e, tol["tx"])])
    if rows & {2, 8, 9, 10, 11}:
        noisy = _noisy(fused.tx_frame_fused(cfg, data), 1).contiguous()
        nflat = noisy.reshape(B, -1)
    if 2 in rows:
        sent, n_cnr = noisy.clone(), fused._met_layout(cfg)[0]
        for mode in ("conv", "matmul"):
            before = fused.LAUNCHES["rx"]
            chan, sym, met = fused.rx_receiver_fused(cfg, noisy, ic_mode=mode)
            n = fused.LAUNCHES["rx"] - before
            rchan, rsym, rmet = fused._rx_receiver_plain(cfg, nflat, 2, mode)
            ec, es = _max_abs(chan, rchan), _max_abs(sym, rsym)
            cnr = slice(1, 1 + n_cnr)
            yield Check(2, "rx", f"rx[{mode}] B={B}", max(ec, es), [
                ("chan", ec, tol["chan"]), ("symbols", es, tol["symbols"]),
                ("snr_rel", _max_rel(met[:, 0], rmet[:, 0]), tol["snr_rel"]),
                ("cnr_rel", _max_rel(met[:, cnr], rmet[:, cnr]), tol["cnr_rel"]),
                ("pad", float(met[:, 1 + n_cnr :].abs().max()), 0.0),
                ("launches-plan", float(abs(n - fused.rx_launches(2))), 0.0),
                ("bursts_written", float(not torch.equal(noisy, sent)), 0.0)])
            del chan, sym, met, rchan, rsym, rmet
        del sent
    if 3 in rows:
        for label, mode, dtype in (("matmul", "matmul", "float32"), ("conv", "conv", "float32"),
                                   ("bf16 stacks", "matmul", "bfloat16")):
            got = fused.link_single_fused(cfg, data, ic_mode=mode, dtype_name=dtype)[0]
            ref = fused._link_single_plain(cfg, flat, 2, mode, dtype_name=dtype,
                                           sum64=dtype == "bfloat16")[0]
            e = _max_abs(got, ref)
            name = "data" if dtype == "float32" else "bf16_data"
            yield Check(3, "link", f"link[{label}] B={B}", e, [(name, e, tol[name])])
            del got, ref
    if 4 in rows:
        cfg_c = cfg.replace(cyclic_shifts=(0, 2))
        e = _max_abs(fused.tx_cdd_fused(cfg_c, data), fused._tx_cdd_plain(cfg_c, flat))
        yield Check(4, "tx_cdd", f"tx_cdd B={B} shifts=(0, 2)", e, [("tx", e, tol["tx"])])
    if rows & {5, 7}:  # the factored Tx and receiver (estimator="fast") on noisy bursts
        for K, batch, M in tuple((K, b, 9) for K, b in LARGE_K) + ((K_FULL, B_LARGE_K, 5),):
            cfg_k = dataclasses.replace(large_k_config(K), timeslots=M)
            pay = torch.from_numpy(planar_payload(cfg_k, batch, seed=K)).to(dev)
            bursts = fused.tx_frame_factored(cfg_k, pay)
            e = _max_abs(bursts, fused._tx_factored_plain(cfg_k, pay, 0))
            tag = f"K={K} M={M} B={batch}"
            yield Check(5, "tx_factored", f"tx_factored {tag}", e, [("tx", e, tol["tx"])])
            noisy_k = _noisy(bursts, K)
            chan, sym = fused.rx_receiver_factored(cfg_k, noisy_k, estimator="fast")
            rchan, rsym = fused._rx_factored_plain(cfg_k, noisy_k,
                                                   fused._fast_channel(cfg_k, noisy_k), 2)
            ec, es = _max_abs(chan, rchan), _max_abs(sym, rsym)
            yield Check(7, "rx_factored_chan", f"rx_factored_chan {tag}", max(ec, es),
                        [("chan", ec, tol["chan"]), ("symbols", es, tol["symbols"])])
            del pay, bursts, noisy_k, chan, sym, rchan, rsym
    if 6 in rows:  # the receiver with its own estimator; the estimator GEMM alone
        K = K_ESTIMATOR
        cfg_k = large_k_config(K)
        pay = torch.from_numpy(planar_payload(cfg_k, B_LARGE_K, seed=K)).to(dev)
        noisy_k = _noisy(fused.tx_frame_factored(cfg_k, pay), K)
        for ic in (2, 0):
            chan, sym = fused.rx_receiver_factored(cfg_k, noisy_k, ic, estimator="fused")
            rchan, rsym = fused._rx_factored_plain(cfg_k, noisy_k, None, ic)
            ec, es = _max_abs(chan, rchan), _max_abs(sym, rsym)
            yield Check(6, "rx_factored", f"rx_factored K={K} B={B_LARGE_K} ic={ic}",
                        max(ec, es), [("chan", ec, tol["chan"]), ("symbols", es, tol["symbols"])])
        e_w = fused._estimator_op(cfg_k, dev)
        pre2 = noisy_k[..., cfg_k.cp_len : cfg_k.cp_len + 2 * K].reshape(B_LARGE_K, 4 * K)
        got = fused._rx_estimate_cuda(cfg_k, noisy_k)
        ref64 = (pre2.double() @ e_w.double()).reshape(got.shape)
        rel64 = _max_abs(got.double(), ref64) / float(ref64.abs().max())
        yield Check(6, "rx_estimate",
                    f"rx_estimate (the estimator GEMM alone) K={K} B={B_LARGE_K}",
                    _max_abs(got, fused._rx_estimate_plain(cfg_k, noisy_k)),
                    [("vs_float64", rel64, tol["estimate64"])])
        del pay, noisy_k, chan, sym, rchan, rsym, got, ref64
    if rows & {8, 9, 10, 11}:  # the superseded receivers at IC 2 (rx_core none)
        fs, n, amp = cfg.preamble_len + cfg.cp_len, cfg.block_len, 2.0**-0.5
        chan0 = fused._rx_receiver_plain(cfg, nflat, 0, "conv")[0]
        frames = noisy[..., fs : fs + n].contiguous()
        fflat, chan3 = frames.reshape(B, -1), chan0.reshape(B, 2, n)
        for row, key, it, run, x, c in (
                (8, "rx_core", 0, lambda: fused.rx_core_fused(cfg, frames, chan3), fflat, chan0),
                (9, "rx_ic", 2, lambda: fused.rx_ic_fused(cfg, frames, chan3), fflat, chan0),
                (10, "rx_full", 2, lambda: fused.rx_full_fused(cfg, noisy), nflat, None),
                (11, "rx_hybrid", 2, lambda: fused.rx_receiver_hybrid(cfg, noisy), nflat, None)):
            if row not in rows:
                continue
            before = fused.LAUNCHES[key]
            got = run()
            n_launch = fused.LAUNCHES[key] - before
            rchan, rsym = fused._rx_variant_plain(key, cfg, x, c, it, amp)
            parts = []
            if key == "rx_hybrid":
                parts.append(("chan", _max_abs(got[0], rchan), tol["chan"]))
                got = got[1]
            parts += [("symbols", _max_abs(got, rsym), tol["symbols"]),
                      ("launches-plan", float(abs(n_launch - fused.variant_launches(key, it))),
                       0.0),
                      ("non_finite", float(not bool(torch.isfinite(got).all())), 0.0)]
            yield Check(row, key, f"{key} B={B} ic={it}", max(v for _n, v, _l in parts[:-2]),
                        parts)
            del got, rchan, rsym
        del chan0, frames
    if rows & {1, 2, 3, 4, 8, 9, 10, 11}:
        del data, flat
    if rows & {2, 8, 9, 10, 11}:
        del noisy, nflat
    if rows & {12, 13}:  # the service's friendly chunks; the sp = 2 service's windows
        s = torch.from_numpy(service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, False,
                                            np.random.default_rng(0))[0]).to(dev)
        sub = CHUNK_LEN // 2
        width = sub + cfg.frame_len + cfg.cp_len
        windows = s.unfold(-1, width, sub).transpose(1, 2).reshape(-1, 2, width)
        for row, key in ((12, "detect_front"), (13, "detect_lean")):
            if row in rows:
                yield _detect_checks(row, key, cfg, s, CHUNK_LEN,
                                     f"{key} B={N_CHUNKS} T={s.shape[-1]}")
                yield _detect_checks(row, key, cfg, windows, sub,
                                     f"{key} sp windows B={windows.shape[0]} T={width}")
        del s, windows
    if 14 in rows:
        from gfdm_tpu_torch.benchmarks import int8_gauss

        weights, x_np, scales = int8_gauss.make_inputs(B, 2)
        xs = torch.from_numpy(x_np).to(dev) * float(scales[1])  # the main path's input
        for v in chain.VARIANTS:
            cw = chain.chain_weights_from_numpy(weights, v).to(dev)
            got, ref = chain.gemm_chain(xs, cw), chain._chain_plain(xs, cw)
            e = _max_abs(got, ref)
            part = (("values_differing", float((got != ref).sum()), 0.0) if v == "int8"
                    else (f"{v}_rel", e / float(ref.abs().max()), tol[f"{v}_rel"]))
            yield Check(14, f"chain_{v}", f"chain_{v} B={B}", e, [part])
            del got, ref
    if 15 in rows:
        for T in VITERBI_T:
            cpu = torch.from_numpy(_viterbi_llrs(N_CHUNKS, T, seed=T))
            differ = float((viterbi.decode(cpu.to(dev), 4).cpu() != viterbi._decode_plain(cpu, 4))
                           .any(dim=1).sum())
            yield Check(15, f"viterbi_t{T}", f"viterbi B={N_CHUNKS} T={T} radix 16", differ,
                        [("codewords_differing_vs_cpu", differ, 0.0)])


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------
def _max_abs(a, b) -> float:
    return float((a.reshape(b.shape) - b).abs().max())


def _noisy(bursts, seed: int, snr_db: float = 20.0):
    """bursts + AWGN at snr_db (noise drawn with numpy from ``seed``)."""
    sig_pow = float((bursts**2).sum(dim=1).mean())  # mean |x|^2 per sample
    sigma = (sig_pow / 10 ** (snr_db / 10) / 2) ** 0.5
    noise = np.random.default_rng(seed).standard_normal(tuple(bursts.shape), dtype=np.float32)
    return bursts + sigma * torch.from_numpy(noise).to(bursts.device)


class _Rows:
    """Runs the rows on the card; ``entries`` collects the JSON's, by key."""

    def __init__(self, dev, reps: int, card: str):
        from gfdm_tpu_torch import GfdmConfig
        from gfdm_tpu_torch.entry import planar_payload
        from gfdm_tpu_torch.kernels import fused

        self.dev, self.reps, self.card, self.entries = dev, reps, card, {}
        self.cfg = GfdmConfig()
        self.data = torch.from_numpy(planar_payload(self.cfg, B, seed=0)).to(dev)
        self.flat = self.data.reshape(B, -1)
        self.noisy = _noisy(fused.tx_frame_fused(self.cfg, self.data), 1).contiguous()
        self.checks, self._mains, self._chunks = {}, {}, None

    def case(self, row: int, label: str, fn_k, fn_p, *, key: str, main, counters=None,
             bound_at=None, library=None, note: str = "", record: bool = False) -> tuple:
        """Time one case of kernel ``key`` and print its line: its launches
        (the ``counters`` of LAUNCHES, default ``key``) in one run of its
        main path ``main``, the bound at ``bound_at`` = (cfg, batch, kw),
        the ``library`` (name, ms), the case's :func:`checks` parts.
        With ``record`` it is the JSON's entry of ``key``. Returns (kernel
        ms, the entry or None)."""
        k_ms, p_ms, ks, ps = timed(fn_k, fn_p, self.reps)
        run = _launches_of(main)
        n = sum(run[c] for c in counters or (key,))
        check = self.checks[label]
        parts = [f"kernel {k_ms:.3f} ms ({ks})", f"plain {p_ms:.3f} ms ({ps})"]
        if library is not None:
            parts.append(f"library ({library[0]}) {library[1]:.3f} ms")
        b_ms = b_by = None
        if bound_at is not None:
            b_ms, b_by = bound(key, bound_at[0], bound_at[1], **bound_at[2])
            parts.append(f"bound {b_ms:.3f} ms ({b_by}) = {b_ms / k_ms:.1%}")
        parts += [f"launches {n}", f"max |d| {check.err:.3e} ("
                  + " ".join(f"{name} {v:.3e}" for name, v, _lim in check.parts) + ")"]
        print(f"[row {row}] {label}: " + ", ".join(parts) + note + f" ({self.card})",
              flush=True)
        if not record:
            return k_ms, None
        name, source, replaces = SOURCES[key]
        entry = self.entries[key] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": check.err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        return k_ms, entry

    def main(self, name: str):
        """A callable that runs main path ``name`` once (built at first
        use), for the launches a kernel makes there: "link" the entry step
        (link_single_fused, matmul IC) and link_step_fused (the Tx kernel,
        the receiver's stages); "cdd" entry.cdd_link; "factored_fast" /
        "factored_fused" link_step_factored at K = 512 / 128 (B = 4,096);
        "service_pallas" / "service_pallas2" StreamingReceiver.step over
        the service's friendly chunks under that DETECT_IMPL; "coded_qpsk"
        / "coded_qam64" the same with fec="conv" under the default
        DETECT_IMPL (64-QAM with 4 IC passes): one decode of T = 468 /
        1,404."""
        if name not in self._mains:
            self._mains[name] = self._build_main(name)
        return self._mains[name]

    def _build_main(self, name: str):
        from gfdm_tpu_torch.entry import (cdd_link, entry, large_k_config, planar_payload,
                                          service_stream)
        from gfdm_tpu_torch.kernels import fused
        from gfdm_tpu_torch.ops import planar_pipeline as pp
        from gfdm_tpu_torch.runtime.service import StreamingReceiver

        cfg, data = self.cfg, self.data
        if name == "link":
            step, _example = entry(self.dev)
            return lambda: (step(data), fused.link_step_fused(cfg, data))
        if name == "cdd":
            return lambda: cdd_link(cfg.replace(cyclic_shifts=(0, 2)), data, 34.0, 9)
        if name.startswith("factored_"):
            est = name.split("_")[1]
            cfg_k = large_k_config(K_FULL if est == "fast" else K_ESTIMATOR)
            pay = torch.from_numpy(planar_payload(cfg_k, B_LARGE_K, seed=cfg_k.subcarriers))
            pay = pay.to(self.dev)
            return lambda: fused.link_step_factored(cfg_k, pay, estimator=est)
        if self._chunks is None:
            self._chunks = service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, False,
                                          np.random.default_rng(0))[0]
        impl, kw = pp.DETECT_IMPL, {}
        if name.startswith("service_"):
            impl = name.split("_")[1]
        elif name == "coded_qpsk":
            kw = {"fec": "conv"}
        else:
            kw = {"fec": "conv", "constellation": "qam64", "ic_iterations": 4}
        rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS, engine="fused",
                               device=self.dev, **kw)

        def run():
            default = pp.DETECT_IMPL
            pp.DETECT_IMPL = impl
            try:
                rx.step(self._chunks)
            finally:
                pp.DETECT_IMPL = default
        return run

    def per_launch(self, row: int, label: str, run, plan) -> None:
        """Each launch's ms of ``run(events)``, named by ``plan``."""
        names = [name if name != "ic" else f"ic{it}" for name, _s, it in plan]
        ms = launch_ms(run, self.reps)
        print(f"[row {row}] {label} a launch: "
              + " ".join(f"{n} {t:.3f}" for n, t in zip(names, ms))
              + f" = {sum(ms):.3f} ms ({self.card})", flush=True)

    def row1(self, rows) -> None:
        """The Tx; its core's three products as torch.mm (TF32 off, no
        framing: a part's yardstick)."""
        from gfdm_tpu_torch.kernels import fused

        cfg, data, flat = self.cfg, self.data, self.flat
        nd = cfg.n_data_symbols
        tg = fused._kernel_consts(cfg, self.dev)["T_G"]
        xr, xi = flat[:, :nd].contiguous(), flat[:, nd:].contiguous()
        s = xr + xi
        mm = time_ms(lambda: (torch.mm(xr, tg[:nd]), torch.mm(xi, tg[nd : 2 * nd]),
                              torch.mm(s, tg[2 * nd :])), self.reps)
        self.case(1, f"tx B={B}", lambda: fused.tx_frame_fused(cfg, data),
                  lambda: fused._tx_frame_plain(cfg, flat, 0), key="tx", main=self.main("link"),
                  bound_at=(cfg, B, {}), library=("the core's three torch.mm", mm), record=True)

    def row2(self, rows) -> None:
        """The staged receiver, conv IC (the JSON's) and matmul IC; its
        bound stated as the link's, the fp32 FMA and FP64 ones beside it;
        each launch at conv, matmul and conv with phase compensation."""
        from gfdm_tpu_torch.kernels import fused

        cfg, x = self.cfg, self.noisy
        xf = x.reshape(B, -1)
        ms = {}
        for mode in ("conv", "matmul"):
            ms[mode], entry = self.case(
                2, f"rx[{mode}] B={B}", lambda: fused.rx_receiver_fused(cfg, x, ic_mode=mode),
                lambda: fused._rx_receiver_plain(cfg, xf, 2, mode), key="rx",
                main=self.main("link"), record=mode == "conv")
            if entry is not None:
                rx_entry = entry
        fma = bound("rx", cfg, B)[0]
        b_ms, b_by, inter = rx_bound(cfg, B)
        mm_ms, mm_by, _ = rx_bound(cfg, B, "matmul")
        rx_entry.update(bound_ms=b_ms, bound_by=b_by, fma_bound_ms=fma)
        print(f"[row 2] rx bound as the link's {b_ms:.3f} ms ({b_by}) = {b_ms / ms['conv']:.1%} "
              f"(conv IC); fp32 FMA bound {fma:.3f} ms; FP64 tensor cores "
              f"{rx_bound(cfg, B, fp64=True)[0]:.3f} / "
              f"{rx_bound(cfg, B, 'matmul', fp64=True)[0]:.3f} ms; the design's "
              f"intermediates {inter:.3f} ms; matmul IC {mm_ms:.3f} ms ({mm_by}) = "
              f"{mm_ms / ms['matmul']:.1%} ({self.card})", flush=True)
        for mode, comp in (("conv", False), ("matmul", False), ("conv", True)):
            opts = fused._rx_options(2, mode, phase_compensation=comp)
            self.per_launch(2, f"rx[{mode}{',phase' if comp else ''}] B={B}",
                            lambda ev: fused._rx_receiver_cuda(cfg, xf, opts, events=ev),
                            fused._rx_plan(opts.ic_iterations, comp))

    def row3(self, rows) -> None:
        """The staged link: matmul IC (the JSON's, entry()'s), conv IC, bf16
        stacks; the tensor-core bound with the fp32 FMA one beside it; each
        launch in both IC modes and both stack dtypes."""
        from gfdm_tpu_torch.kernels import fused

        cfg, data, flat = self.cfg, self.data, self.flat
        ms = {}
        for label, mode, dtype in (("matmul", "matmul", "float32"), ("conv", "conv", "float32"),
                                   ("bf16 stacks", "matmul", "bfloat16")):
            kw = dict(ic_mode=mode, dtype_name=dtype)
            ms[label], entry = self.case(
                3, f"link[{label}] B={B}", lambda: fused.link_single_fused(cfg, data, **kw),
                lambda: fused._link_single_plain(cfg, flat, 2, mode, dtype_name=dtype),
                key="link", main=self.main("link"), record=label == "matmul")
            if entry is not None:
                link_entry = entry
        fma = bound("link", cfg, B, ic_mode="matmul")[0]
        b_ms, b_by, inter = link_bound(cfg, B)
        bf_ms, bf_by, _ = link_bound(cfg, B, dtype_name="bfloat16")
        link_entry.update(bound_ms=b_ms, bound_by=b_by, fma_bound_ms=fma)
        print(f"[row 3] link tensor-core bound {b_ms:.3f} ms ({b_by}) = "
              f"{b_ms / ms['matmul']:.1%}; fp32 FMA bound {fma:.3f} ms; the design's "
              f"intermediates {inter:.3f} ms; with bf16 stacks {bf_ms:.3f} ms ({bf_by}) = "
              f"{bf_ms / ms['bf16 stacks']:.1%} ({self.card})", flush=True)
        for dtype in ("float32", "bfloat16"):
            for mode in ("matmul", "conv"):
                opts = fused._rx_options(2, mode)
                self.per_launch(3, f"link[{mode},{dtype}] B={B}",
                                lambda ev: fused._link_single_cuda(cfg, flat, opts, dtype,
                                                                   events=ev),
                                fused._link_plan(opts.ic_iterations))

    def row4(self, rows) -> None:
        from gfdm_tpu_torch.kernels import fused

        cfg_c, data, flat = self.cfg.replace(cyclic_shifts=(0, 2)), self.data, self.flat
        self.case(4, f"tx_cdd B={B} shifts=(0, 2)", lambda: fused.tx_cdd_fused(cfg_c, data),
                  lambda: fused._tx_cdd_plain(cfg_c, flat), key="tx_cdd", main=self.main("cdd"),
                  bound_at=(cfg_c, B, {"ports": 2}), record=True)

    def _large_k(self, K: int, batch: int, M: int = 9) -> tuple:
        """(config, payload, its bursts through the factored Tx)."""
        from gfdm_tpu_torch.entry import large_k_config, planar_payload
        from gfdm_tpu_torch.kernels import fused

        cfg = dataclasses.replace(large_k_config(K), timeslots=M)
        data = torch.from_numpy(planar_payload(cfg, batch, seed=K)).to(self.dev)
        return cfg, data, fused.tx_frame_factored(cfg, data)

    def _factored_note(self, row: int, label: str, key: str, cfg, bursts, k_ms: float,
                       entry) -> None:
        """The direct DFT's bound, the shared memory a CTA, and cuFFT of the
        K-point stage alone on the payload rows ((B, M, K) complex64; a
        part's yardstick, which the port never calls)."""
        from gfdm_tpu_torch.kernels import cuda_lib, fused

        B_, K, M, n = bursts.shape[0], cfg.subcarriers, cfg.timeslots, cfg.block_len
        d_ms, d_by = bound(key, cfg, B_, direct_dft=True)
        if entry is not None:
            entry["dft_bound_ms"] = d_ms
        smem = cuda_lib.library().gfdm_factored_smem_bytes(
            ctypes.byref(fused._factored_dims(cfg, B_)))
        fs = cfg.preamble_len + cfg.cp_len
        x = bursts[..., fs : fs + n]
        rows = torch.complex(x[:, 0], x[:, 1]).reshape(B_, K, M).transpose(1, 2).contiguous()
        fft = time_ms(lambda: torch.fft.fft(rows, dim=-1), self.reps)
        print(f"[row {row}] {label}: with the K-point stage as the direct DFT the bound is "
              f"{d_ms:.3f} ms ({d_by}) = {d_ms / k_ms:.1%}; {smem} B of shared memory a CTA; "
              f"cuFFT of the K-point stage alone {fft:.3f} ms ({self.card})", flush=True)

    def _factored_row(self, row: int, key: str) -> None:
        """Rows 5 (the Tx) and 7 (the receiver on the torch-op channel,
        estimator="fast") at each large K and at K = 512, M = 5 (the
        kernels' instantiation for any M but 9); the JSON's at K = 512.
        Launches: row 5 both large-K links (the Tx in each), row 7 the
        estimator="fast" one."""
        from gfdm_tpu_torch.kernels import fused

        if key == "tx_factored":
            fast, fusd = self.main("factored_fast"), self.main("factored_fused")
            main = lambda: (fast(), fusd())  # noqa: E731
        else:
            main = self.main("factored_fast")
        for K, batch, M in tuple((K, b, 9) for K, b in LARGE_K) + ((K_FULL, B_LARGE_K, 5),):
            cfg, data, bursts = self._large_k(K, batch, M)
            if key == "tx_factored":
                fn_k = lambda: fused.tx_frame_factored(cfg, data)  # noqa: E731
                fn_p = lambda: fused._tx_factored_plain(cfg, data, 0)  # noqa: E731
            else:
                chan = fused._fast_channel(cfg, bursts)
                fn_k = lambda: fused._rx_factored_cuda(cfg, bursts, chan, 2)  # noqa: E731
                fn_p = lambda: fused._rx_factored_plain(cfg, bursts, chan, 2)  # noqa: E731
            label = f"{key} K={K} M={M} B={batch}"
            k_ms, entry = self.case(row, label, fn_k, fn_p, key=key, main=main,
                                    bound_at=(cfg, batch, {}),
                                    record=K == K_FULL and M == 9)
            self._factored_note(row, label, key, cfg, bursts, k_ms, entry)
            del data, bursts
            torch.cuda.empty_cache()

    def row5(self, rows) -> None:
        self._factored_row(5, "tx_factored")

    def row7(self, rows) -> None:
        self._factored_row(7, "rx_factored_chan")

    def row6(self, rows) -> None:
        """The receiver with its own estimator at K = 128 (two launches: the
        estimator GEMM, then the receiver kernel on its channel), at IC 2
        (the JSON's) and 0; the GEMM alone beside torch.mm of the same
        product (TF32 off); launches on the estimator="fused" link."""
        from gfdm_tpu_torch.kernels import fused

        cfg, _data, bursts = self._large_k(K_ESTIMATOR, B_LARGE_K)
        K, Bk, main = K_ESTIMATOR, B_LARGE_K, self.main("factored_fused")
        for ic in (2, 0):
            label = f"rx_factored K={K} B={Bk} ic={ic}"
            k_ms, entry = self.case(
                6, label, lambda: fused.rx_receiver_factored(cfg, bursts, ic, estimator="fused"),
                lambda: fused._rx_factored_plain(cfg, bursts, None, ic), key="rx_factored",
                main=main, counters=("rx_factored", "rx_factored_chan"),
                bound_at=(cfg, Bk, {}) if ic == 2 else None, record=ic == 2)
            if entry is not None:
                run = _launches_of(main)
                entry["launches_by_kernel"] = {"rx_estimate_kernel": run["rx_factored"],
                                               "rx_factored_kernel": run["rx_factored_chan"]}
                self._factored_note(6, label, "rx_factored", cfg, bursts, k_ms, entry)
        e_w = fused._estimator_op(cfg, self.dev)
        pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(Bk, 4 * K).contiguous()
        lib = time_ms(lambda: torch.mm(pre2, e_w), self.reps)
        _k, entry = self.case(
            6, f"rx_estimate (the estimator GEMM alone) K={K} B={Bk}",
            lambda: fused._rx_estimate_cuda(cfg, bursts),
            lambda: fused._rx_estimate_plain(cfg, bursts), key="rx_estimate", main=main,
            counters=("rx_factored",), bound_at=(cfg, Bk, {}),
            library=("torch.mm(pre2, E_W)", lib), record=True)
        entry["library_ms"] = lib

    def rows8_11(self, rows) -> None:
        """The superseded receivers at IC 2 (rx_core none) on the noisy
        bursts, each launch timed too, launches of one call (no user path
        runs them); rx_core's two Gauss products as six torch.mm (TF32 off;
        no ZF, adds or intermediates: a part's yardstick)."""
        from gfdm_tpu_torch.kernels import fused

        cfg, x = self.cfg, self.noisy
        fs, n = cfg.preamble_len + cfg.cp_len, cfg.block_len
        nflat = x.reshape(B, -1)
        chan = fused._rx_receiver_plain(cfg, nflat, 0, "conv")[0]
        frames = x[..., fs : fs + n].contiguous()
        fflat, chan3, amp = frames.reshape(B, -1), chan.reshape(B, 2, n), 2.0**-0.5
        cases = {
            "rx_core": (8, 0, lambda: fused.rx_core_fused(cfg, frames, chan3), fflat, chan),
            "rx_ic": (9, 2, lambda: fused.rx_ic_fused(cfg, frames, chan3), fflat, chan),
            "rx_full": (10, 2, lambda: fused.rx_full_fused(cfg, x), nflat, None),
            "rx_hybrid": (11, 2, lambda: fused.rx_receiver_hybrid(cfg, x), nflat, None),
        }
        for key, (row, it, fn_k, r, c) in cases.items():
            if row not in rows:
                continue
            fn_p = lambda key=key, it=it, r=r, c=c: fused._rx_variant_plain(  # noqa: E731
                key, cfg, r, c, it, amp)
            library = None
            if key == "rx_core":
                k = fused._kernel_consts(cfg, self.dev)
                y = fused._rx_variant_plain("rx_core", cfg, fflat, chan, 0, amp)[1]
                mm_args = []
                for a, g in ((fflat, k["F_G"]), (y, k["Bfd_G"])):
                    ar, ai = a[:, :n].contiguous(), a[:, n:].contiguous()
                    mm_args += [(ar, g[:n]), (ai, g[n : 2 * n]), (ar + ai, g[2 * n :])]
                library = ("its two Gauss products as six torch.mm",
                           time_ms(lambda: [torch.mm(a, w) for a, w in mm_args], self.reps))
                del y, mm_args
            _k, entry = self.case(row, f"{key} B={B} ic={it}", fn_k, fn_p, key=key, main=fn_k,
                                  bound_at=(cfg, B, {}), library=library, record=True)
            if key == "rx_core":
                entry["mm_yardstick_ms"] = library[1]
            self.per_launch(row, f"{key} B={B} ic={it}",
                            lambda ev, key=key, r=r, c=c, it=it: fused._rx_variant_cuda(
                                key, cfg, r, c, it, amp, events=ev),
                            fused._variant_plan(key, it))

    def rows12_13(self, rows) -> None:
        """Both detection kernels on the service's friendly chunks (seed 0,
        T = 2,816, n_valid 2,048), launches on the service's step under
        "pallas" / "pallas2"; the bound by the least count (the
        cross-correlation as overlap-save FFTs, which the kernels do not
        run), the direct FIR they run and every sum anew at every position
        beside it; conv1d (cuDNN, TF32 off) of the cross-correlation alone
        (a part's yardstick, which the kernels never call)."""
        from gfdm_tpu_torch.entry import service_stream
        from gfdm_tpu_torch.kernels import detect
        from gfdm_tpu_torch.ops.planar_pipeline import _conv_xcorr

        cfg = self.cfg
        if self._chunks is None:
            self._chunks = service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, False,
                                          np.random.default_rng(0))[0]
        s = torch.from_numpy(self._chunks).to(self.dev)
        T, kw = s.shape[-1], {"T": s.shape[-1], "n_valid": CHUNK_LEN}
        w = detect._consts(cfg, self.dev)["conv"]
        conv = time_ms(lambda: _conv_xcorr(s, w), self.reps)
        for row, key, kern, plain, impl in (
                (12, "detect_front", detect._detect_front_cuda, detect._detect_front_plain,
                 "pallas"),
                (13, "detect_lean", detect._detect_lean_cuda, detect._detect_lean_plain,
                 "pallas2")):
            if row not in rows:
                continue
            k_ms, entry = self.case(
                row, f"{key} B={N_CHUNKS} T={T}", lambda: kern(cfg, s, CHUNK_LEN),
                lambda: plain(cfg, s, CHUNK_LEN), key=key, main=self.main(f"service_{impl}"),
                bound_at=(cfg, N_CHUNKS, kw),
                library=("conv1d of the cross-correlation alone", conv), record=True)
            fir, fir_by = bound(key, cfg, N_CHUNKS, detect_form="fir", **kw)
            old = bound(key, cfg, N_CHUNKS, detect_form="old", **kw)[0]
            entry.update(fir_bound_ms=fir, old_bound_ms=old)
            print(f"[row {row}] {key}: the bound counts the cross-correlation as overlap-save "
                  f"FFTs (not run); as the direct FIR the kernels run {fir:.3f} ms ({fir_by}) "
                  f"= {fir / k_ms:.1%}; every sum anew at every position {old:.3f} ms; "
                  f"{N_CHUNKS * T / (k_ms / 1e3):.4e} samples/s ({self.card})", flush=True)

    def row14(self, rows) -> None:
        """The GEMM chain in each mode on int8_gauss's inputs, launches of
        its step (``int8_gauss.chain_step``): the library's calls (three
        torch.mm TF32 off; three torch.mm with float32 output; torch._int_mm
        x3 with torch-op quantization between) and the error against a
        float64 chain; the int8 call launch by launch, its clusters,
        torch._int_mm x3 on operands quantized beforehand (the GEMMs alone)
        and the int8 call at smaller batches; multi_dot as a note (it
        reassociates: not the chain's function)."""
        from gfdm_tpu_torch.benchmarks import int8_gauss
        from gfdm_tpu_torch.kernels import chain

        weights, x_np, scales = int8_gauss.make_inputs(B, 2)
        x = torch.from_numpy(x_np).to(self.dev)
        xs = x * float(scales[1])  # the main path's input
        w64 = [torch.from_numpy(np.asarray(w, dtype=np.float64)).to(self.dev) for w in weights]
        ref64 = xs.double() @ w64[0] @ w64[1] @ w64[2]
        del w64
        for v in chain.VARIANTS:
            key, cw = f"chain_{v}", chain.chain_weights_from_numpy(weights, v).to(self.dev)
            got = chain.gemm_chain(xs, cw)
            rel64 = float((got.double() - ref64).abs().max() / ref64.abs().max())
            del got
            lib = time_ms(lambda: _chain_library(v, xs, cw), self.reps)
            k_ms, entry = self.case(
                14, f"{key} B={B}", lambda: chain.gemm_chain(xs, cw),
                lambda: chain._chain_plain(xs, cw), key=key,
                main=lambda: int8_gauss.chain_step(x, scales[1], cw), bound_at=(None, B, {}),
                library=("the same products in order", lib),
                note=f", rel-err vs a float64 chain {rel64:.3e}", record=True)
            entry["library_ms"] = lib
            print(f"[row 14] {key}: {work(key, None, B)[0] / (k_ms * 1e-3) / 1e12:.1f} "
                  f"TF(OP)/s ({self.card})", flush=True)
            if v == "int8":
                self.per_launch(14, f"{key} B={B}",
                                lambda ev: chain._chain_cuda(xs, cw, events=ev),
                                [(n, None, 0) for n in chain.INT8_LAUNCHES])
                qs = _quantized_operands(xs, cw)
                entry["int_mm_yardstick_ms"] = pre = time_ms(
                    lambda: [torch._int_mm(q, w) for q, w in zip(qs, cw.w)], self.reps)
                cl = chain.int8_clusters(self.dev)
                print(f"[row 14] {key}: torch._int_mm x3 on operands quantized beforehand "
                      f"{pre:.3f} ms (the GEMMs alone); stages 1-2 as {cl['active_clusters']} "
                      f"clusters of {cl['cluster']} CTAs at once ({self.card})", flush=True)
                del qs
            if v == "f32":
                md = time_ms(lambda: torch.linalg.multi_dot([xs, *cw.w]), self.reps)
                print(f"[row 14] note: torch.linalg.multi_dot {md:.3f} ms, not a yardstick: it "
                      f"reassociates (W1 W2 W3 first, then one GEMM over the batch) "
                      f"({self.card})", flush=True)
        del ref64, xs, x
        for batch in INT8_BATCHES:
            weights, x_np, _s = int8_gauss.make_inputs(batch, 1)
            cw = chain.chain_weights_from_numpy(weights, "int8").to(self.dev)
            x = torch.from_numpy(x_np).to(self.dev)
            differ = int((chain.gemm_chain(x, cw) != chain._chain_plain(x, cw)).sum())
            b_ms, b_by = bound("chain_int8", None, batch)
            k_ms = time_ms(lambda: chain.gemm_chain(x, cw), self.reps)
            print(f"[row 14] chain_int8 B={batch}: kernel {k_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}) = {b_ms / k_ms:.1%}, values differing from plain {differ} "
                  f"({self.card})", flush=True)

    def row15(self, rows) -> None:
        """The Viterbi kernel (radix 16) at 4,096 noisy codewords of each T;
        plain: the torch-op decoder on the card; launches on the coded
        service's step (QPSK at T = 468, 64-QAM at 1,404)."""
        from gfdm_tpu_torch.kernels import viterbi

        for T, main in zip(VITERBI_T, ("coded_qpsk", "coded_qam64")):
            lp = torch.from_numpy(_viterbi_llrs(N_CHUNKS, T, seed=T)).to(self.dev)
            self.case(15, f"viterbi B={N_CHUNKS} T={T} radix 16",
                      lambda: viterbi.decode(lp, 4), lambda: viterbi._decode_plain(lp, 4),
                      key=f"viterbi_t{T}", main=self.main(main), counters=("viterbi",),
                      bound_at=(None, N_CHUNKS, {"T": T}), record=True)

    def run(self, rows) -> None:
        """The rows asked for, in order (rows 8-11 and 12-13 share inputs),
        after their checks (:func:`checks`), whose values the lines print."""
        self.checks = {c.label: c for c in checks(self.dev, rows)}
        torch.cuda.empty_cache()
        steps = {1: self.row1, 2: self.row2, 3: self.row3, 4: self.row4, 5: self.row5,
                 6: self.row6, 7: self.row7, 14: self.row14, 15: self.row15,
                 **dict.fromkeys((8, 9, 10, 11), self.rows8_11),
                 **dict.fromkeys((12, 13), self.rows12_13)}
        done = []
        for row in sorted(rows):
            if steps[row] not in done:
                done.append(steps[row])
                steps[row](rows)
                torch.cuda.empty_cache()


def _chain_library(variant: str, x, cw):
    """The chain as PyTorch's own calls, the same products in the same
    order: three torch.mm with TF32 off (f32: cuBLAS's SGEMMs), three
    torch.mm with float32 output (bf16), torch._int_mm x3 with torch-op
    int8 quantization between (int8)."""
    from gfdm_tpu_torch.kernels import chain

    if variant == "f32":
        with chain._no_tf32(x.device):
            return torch.mm(torch.mm(torch.mm(x, cw.w[0]), cw.w[1]), cw.w[2])
    if variant == "int8":
        return _int_mm_chain(x, cw)
    a = x
    for w in cw.w:
        a = torch.mm(a.to(torch.bfloat16), w, out_dtype=torch.float32)
    return a


def _quantized_operands(x: torch.Tensor, cw) -> list:
    """The three int8 stages' operands as the plain version quantizes them
    (each a (B, d) int8 tensor)."""
    from gfdm_tpu_torch.kernels import chain

    qs, a = [], x
    for wq, inv in zip(cw.w, cw.inv):
        q, _m = chain._quantize_groups(a)
        qs.append(q.reshape(a.shape[0], -1).to(torch.int8))
        a = chain._int8_stage(a, wq, inv)
    return qs


def _int_mm_chain(x: torch.Tensor, cw) -> torch.Tensor:
    """The int8 chain as torch._int_mm x3 with torch-op quantization
    between, the kernels' function (the plain version's steps)."""
    from gfdm_tpu_torch.kernels import chain

    a = x
    for i, w in enumerate(cw.w):
        g = a.reshape(a.shape[0] // chain.GROUP, chain.GROUP, -1)
        m = torch.clamp(g.abs().amax(dim=(1, 2), keepdim=True), min=1e-20)
        q = torch.clamp(torch.round(g * (torch.full_like(m, 127.0) / m)), -127, 127)
        acc = torch._int_mm(q.to(torch.int8).reshape(a.shape[0], -1), w)
        a = (acc.reshape(g.shape[0], chain.GROUP, -1).float()
             * (m * chain._dequant_const(cw.inv[i]))).reshape(a.shape[0], -1)
    return a


def _viterbi_llrs(batch: int, T: int, seed: int, snr_db: float = 1.0) -> np.ndarray:
    """(batch, T, 2) float32 LLRs of random zero-terminated codewords in
    AWGN at ``snr_db`` Es/N0 (4 / variance times the received value)."""
    from gfdm_tpu_torch.coding import CONV_TAIL_BITS, conv_encode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, T - CONV_TAIL_BITS)).astype(np.uint8)
    var = 10 ** (-snr_db / 10)
    y = 1.0 - 2.0 * conv_encode(bits) + np.sqrt(var / 2) * rng.standard_normal((batch, 2 * T))
    return (2.0 * y / (var / 2)).astype(np.float32).reshape(batch, T, 2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=list(range(1, 16)),
                    choices=range(1, 16), metavar="ROW", help="rows of PERF.md §6 (default all)")
    ap.add_argument("--reps", type=int, default=5, help="calls a timing (default 5)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernels: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    runs = _Rows(torch.device("cuda", 0), args.reps, card)
    runs.run(set(args.rows))
    for ln in ptxas_lines():
        print(f"[ptxas] {ln}")
    print(card)
    print(json.dumps({"kernels": [runs.entries[k] for k in SOURCES if k in runs.entries]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
