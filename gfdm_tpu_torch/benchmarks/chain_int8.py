"""The int8 GEMM chain alone on the card, call by call and launch by launch.

Times ``gemm_chain`` with int8 weights (csrc/chain.cu) at B = 8,192,
32,768 and 65,536 on :mod:`gfdm_tpu_torch.benchmarks.int8_gauss`'s inputs:
the whole call (CUDA events around ``reps`` calls after two warm-ups) and
each of its launches (``chain.INT8_LAUNCHES``: x's pass, three stages; an
event before each launch and after the last, the mean of ``reps`` calls).
Beside them two yardsticks, both of PyTorch's
own int8 GEMM: ``torch._int_mm`` x3 on operands quantized beforehand (the
GEMMs alone, the quantization out of the window) and ``torch._int_mm`` x3
with torch-op quantization between (the chain's function; chip_smoke.py's
library time), and the bound: the chain's operations at the 1,979 TOP/s of
dense int8 (H100 SXM). Last the clusters of the int8 stage the card holds
at once (``cudaOccupancyMaxActiveClusters``, six CTAs each), ptxas's
registers and spills of the int8 kernels, and the card's name and power
limit.

    python -m gfdm_tpu_torch.benchmarks.chain_int8 [--reps 20]
    PYTHONPATH=<checkout> python <checkout>/gfdm_tpu_torch/benchmarks/chain_int8.py

It needs a CUDA device and exits 1 without one.
"""
from __future__ import annotations

import argparse
import sys

import torch

from gfdm_tpu_torch.benchmarks.int8_gauss import card_line, make_inputs
from gfdm_tpu_torch.benchmarks.rx_variants import ptxas_lines, stage_ms, time_ms
from gfdm_tpu_torch.kernels import chain

BATCHES = (8192, 32768, 65536)
PEAK_INT8 = 1979e12  # H100 SXM dense int8, operations a second


def quantized_operands(x: torch.Tensor, cw) -> list:
    """The three stages' int8 operands as the plain version quantizes them
    (each a (B, d) int8 tensor)."""
    qs, a = [], x
    for wq, inv in zip(cw.w, cw.inv):
        q, _m = chain._quantize_groups(a)
        qs.append(q.reshape(a.shape[0], -1).to(torch.int8))
        a = chain._int8_stage(a, wq, inv)
    return qs


def int_mm_chain(x: torch.Tensor, cw) -> torch.Tensor:
    """The chain as torch._int_mm x3 with torch-op quantization between,
    the same function as the kernels' (the plain version's steps)."""
    a = x
    for i, w in enumerate(cw.w):
        g = a.reshape(a.shape[0] // chain.GROUP, chain.GROUP, -1)
        m = torch.clamp(g.abs().amax(dim=(1, 2), keepdim=True), min=1e-20)
        q = torch.clamp(torch.round(g * (torch.full_like(m, 127.0) / m)), -127, 127)
        acc = torch._int_mm(q.to(torch.int8).reshape(a.shape[0], -1), w)
        a = (acc.reshape(g.shape[0], chain.GROUP, -1).float()
             * (m * chain._dequant_const(cw.inv[i]))).reshape(a.shape[0], -1)
    return a


def bound_ms(batch: int) -> float:
    """The chain's operations at the dense int8 peak (ms)."""
    return 1e3 * 2.0 * batch * sum(a * b for a, b in chain.CHAIN_SHAPES) / PEAK_INT8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_int8: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    for batch in BATCHES:
        weights, x_np, _s = make_inputs(batch, 1)
        cw = chain.chain_weights_from_numpy(weights, "int8").to(dev)
        x = torch.from_numpy(x_np).to(dev)
        ref = chain._chain_plain(x, cw)
        bound = bound_ms(batch)
        differ = int((chain._chain_cuda(x, cw) != ref).sum())
        call = time_ms(lambda: chain._chain_cuda(x, cw), args.reps)
        ms = stage_ms(lambda ev: chain._chain_cuda(x, cw, events=ev), args.reps)
        print(f"[chain_int8] B={batch}: {call:.4f} ms, bound {bound:.4f} ms (operations) = "
              f"{bound / call:.1%}, values_differing={differ}; launches "
              + " ".join(f"{n} {t:.4f}" for n, t in zip(chain.INT8_LAUNCHES, ms)), flush=True)
        qs, ws = quantized_operands(x, cw), list(cw.w)
        pre = time_ms(lambda: [torch._int_mm(q, w) for q, w in zip(qs, ws)], args.reps)
        full = time_ms(lambda: int_mm_chain(x, cw), args.reps)
        print(f"[chain_int8] torch._int_mm x3 B={batch}: on operands quantized beforehand "
              f"{pre:.4f} ms (the GEMMs alone), with torch-op quantization between {full:.4f} "
              f"ms (the function)", flush=True)
        del qs, x, ref
        torch.cuda.empty_cache()
    cl = chain.int8_clusters(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[chain_int8] clusters: {cl['active_clusters']} of {cl['cluster']} CTAs at once "
          f"({cl['active_clusters'] * cl['cluster']} of {sms} SMs), {cl['smem_bytes']} B of "
          f"shared memory a CTA, one CTA an SM", flush=True)
    for ln in ptxas_lines(("chain_int8", "chain_quantize")):
        print(f"[ptxas] {ln}")
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
