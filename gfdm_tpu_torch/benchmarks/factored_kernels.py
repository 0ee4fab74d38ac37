"""The factored (large-K) kernels alone on the card, at each IC depth.

Times, with CUDA events around ``reps`` calls after two warm-up calls, the
kernels of ``csrc/factored.cu`` at the large-K link's configs
(``entry.large_k_config``, M = 9): the Tx kernel (``tx_frame_factored``)
and the receiver kernel with the channel read (the launch behind
``rx_receiver_factored(estimator="fast")``, without the torch-op estimate)
at K = 256, 512 (B = 4,096) and 1,024 (B = 2,048), and at K = 512 with M =
5 (the kernels' instantiation for any M other than 9); at K = 128, B =
4,096 the receiver with its own dense estimator (``estimator="fused"``: the
estimator GEMM, then the receiver kernel on its channel), the GEMM alone
(beside ``torch.mm`` of the same product, TF32 off) and the receiver kernel
alone on the GEMM's channel; each receiver at every IC depth asked for. One
line a (kernel, K, IC depth) and a line a K with the shared memory of the
Tx's and the receiver's CTA; then ptxas's registers and spills of each
factored kernel and of the estimator GEMM (from the build's log, names
demangled where ``c++filt`` is found), and the card's name and power limit.
With the threads a CTA (the receiver's 128 at K <= 128, else the kernels'
``factored_threads``), these say how many CTAs an SM holds.

Run it from the checkout to time (each checkout's own copy: the GEMM alone
came with it):

    python -m gfdm_tpu_torch.benchmarks.factored_kernels [--ic 0 2] [--reps 20]
    PYTHONPATH=<checkout> python <checkout>/gfdm_tpu_torch/benchmarks/factored_kernels.py

It needs a CUDA device and exits 1 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys

import torch

from gfdm_tpu_torch.entry import large_k_config, planar_payload
from gfdm_tpu_torch.kernels import cuda_lib, fused

# (K, M, B) of the Tx and the fast receiver
CASES = ((256, 9, 4096), (512, 9, 4096), (1024, 9, 2048), (512, 5, 4096))
K_ESTIMATOR = 128  # the estimator GEMM's K (its E_W: 4.7 MB)


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


def ptxas_lines() -> list:
    """'<kernel>: <ptxas line>' for the registers and spills of every
    factored kernel and of the estimator GEMM in the library's build log."""
    out, fn = [], None
    for ln in cuda_lib.build_info()["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and ("factored" in fn or "rx_estimate" in fn) and (
                "registers" in ln or "spill" in ln):
            out.append((fn, ln.split(":", 1)[-1].strip()))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(f for f, _ in out),
                               capture_output=True, text=True).stdout.split("\n")
        out = [(n or f, t) for (f, t), n in zip(out, names)]
    return [f"{f}: {t}" for f, t in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ic", type=int, nargs="+", default=[0, 2],
                    help="IC iterations of the receivers (default 0 2)")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("factored_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cuda_lib.library()
    for K, M, B in CASES + ((K_ESTIMATOR, 9, 4096),):
        cfg = dataclasses.replace(large_k_config(K), timeslots=M)
        data = torch.from_numpy(planar_payload(cfg, B, K)).to(dev)
        bursts = fused.tx_frame_factored(cfg, data)
        dims = fused._factored_dims(cfg, B)
        print(f"[factored] K={K} M={M}: shared memory a CTA "
              f"{lib.gfdm_factored_smem_bytes(ctypes.byref(dims))} B", flush=True)
        runs = []
        if K != K_ESTIMATOR:
            chan = fused._fast_channel(cfg, bursts)
            runs.append(("tx_factored", None, lambda: fused.tx_frame_factored(cfg, data)))
        else:
            chan = fused._rx_estimate_cuda(cfg, bursts)
            runs += [("rx_factored", ic,
                      lambda ic=ic: fused.rx_receiver_factored(cfg, bursts, ic,
                                                               estimator="fused"))
                     for ic in args.ic]
            pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(B, 4 * K).contiguous()
            e_w = fused._estimator_op(cfg, dev)
            runs += [("rx_estimate (the estimator GEMM alone)", None,
                      lambda: fused._rx_estimate_cuda(cfg, bursts)),
                     ("torch.mm(pre2, E_W), TF32 off", None, lambda: torch.mm(pre2, e_w))]
        runs += [("rx_factored_chan", ic,
                  lambda ic=ic: fused._rx_factored_cuda(cfg, bursts, chan, ic))
                 for ic in args.ic]
        for name, ic, fn in runs:
            depth = "" if ic is None else f" ic={ic}"
            print(f"[factored] {name} K={K} M={M} B={B}{depth}: "
                  f"{time_ms(fn, args.reps):.4f} ms", flush=True)
        del bursts, chan
    for ln in ptxas_lines():
        print(f"[ptxas] {ln}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip() or 'nvidia-smi unavailable'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
