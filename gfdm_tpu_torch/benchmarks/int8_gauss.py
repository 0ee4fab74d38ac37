"""The link's GEMM chain on the card in f32, bf16 and int8.

The port's counterpart of ``benchmarks/int8_gauss.py``: the one-kernel
link's chain shapes, (B, 936) -> 1152 -> 1152 -> 1152, through the CUDA
chain kernels (:mod:`gfdm_tpu_torch.kernels.chain`), one mode at a time.
The inputs are the script's ``default_rng(0)`` draws (the three weights,
then x), and each iteration scales x by its own s = 1 + 1e-6 i, as the
script varies its input (the scales taken in turn). Times are CUDA events
around ``iters`` calls after two warm-up calls
(:func:`gfdm_tpu_torch.benchmarks.kernels.time_ms`), not the script's host
fetch. Each mode prints one line: ms, TF(OP)/s and the max error relative
to the f32 output (of a call at the last scale), as the script does; then
the card's name and power limit.

    python -m gfdm_tpu_torch.benchmarks.int8_gauss [batch] [iters]   # 32768 10

It needs a CUDA device and exits 1 without one.
"""
from __future__ import annotations

import itertools
import sys

import numpy as np
import torch

from ..kernels.chain import CHAIN_SHAPES, VARIANTS, chain_weights_from_numpy, gemm_chain
from .kernels import card_line, time_ms


def make_inputs(batch: int, iters: int):
    """The script's draws: (weights (float64 numpy under numpy >= 2, as
    there), x (batch, 936) float32, the iterations' scales (float32))."""
    rng = np.random.default_rng(0)
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
               for s in CHAIN_SHAPES]
    x = rng.standard_normal((batch, CHAIN_SHAPES[0][0])).astype(np.float32)
    scales = [np.float32(1.0 + 1e-6 * i) for i in range(iters)]
    return weights, x, scales


def chain_step(x: torch.Tensor, s, weights):
    """One call as the script times it: the input scaled by s, then the
    chain (the script's ``call(x * s, *w)``)."""
    return gemm_chain(x * float(s), weights)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 32768
    iters = int(argv[1]) if len(argv) > 1 else 10
    if not torch.cuda.is_available():
        print("int8_gauss: needs a CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    weights, x, scales = make_inputs(batch, iters)
    xd = torch.from_numpy(x).to(dev)
    ops = 2 * batch * sum(a * b for a, b in CHAIN_SHAPES)
    ref, failed = None, False
    for variant in VARIANTS:
        try:
            cw = chain_weights_from_numpy(weights, variant).to(dev)
            s = itertools.cycle(scales)
            ms = time_ms(lambda: chain_step(xd, next(s), cw), iters)
            out = chain_step(xd, scales[-1], cw)
            if variant == "f32":
                ref, err = out, 0.0
            else:
                err = float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-9))
            print(f"{variant:>5}: {ms:8.3f} ms  {ops / (ms * 1e-3) / 1e12:6.2f} TF(OP)/s   "
                  f"rel-err {err:.2e}  probe {float(out[0, 0]):+.3f}", flush=True)
        except Exception as exc:  # report a failing mode and go on to the next
            failed = True
            print(f"{variant:>5}: FAILED - {type(exc).__name__}: {str(exc)[:200]}", flush=True)
    print(card_line())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
