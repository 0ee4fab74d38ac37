"""Viterbi test LLRs, shared by the CPU and the card tests.

``dyadic_llrs``: every LLR is a multiple of 1/8 in [-16, 16], so every
sum the decoder forms is exact in float32 whatever its order: the JAX
package, the port's CPU run and its card run must then take the same
decisions, ties included. ``noisy_llrs``: continuous float32 LLRs of noisy
codewords, where the order of the sums matters.
"""
import numpy as np

from gfdm_tpu_torch.coding import conv_encode


def dyadic_llrs(n_info: int, rows: int, seed: int):
    """(rows, 2 (n_info + 6)) float32 LLRs and the (rows, n_info) uint8 info
    bits they encode: row i is noiseless where i % 3 == 0, at 0 dB Es/N0
    where i % 3 == 1 and at -2 dB where i % 3 == 2 (antipodal +-1 in noise
    of variance 10^(-snr/10) / 2, scaled by 4), and all zero (every
    candidate ties) where i % 8 == 7."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, n_info)).astype(np.uint8)
    sym = 1.0 - 2.0 * conv_encode(bits).astype(np.float64)
    sd = np.array([0.0, 0.5**0.5, (10**0.2 / 2) ** 0.5])[np.arange(rows) % 3, None]
    llr = np.clip(np.round(4.0 * (sym + sd * rng.standard_normal(sym.shape)) * 8.0) / 8.0,
                  -16.0, 16.0)
    llr[np.arange(rows) % 8 == 7] = 0.0
    return llr.astype(np.float32), bits


def noisy_llrs(batch: int, T: int, seed: int, snr_db: float = 1.0) -> np.ndarray:
    """(batch, T, 2) float32 LLRs of random zero-terminated codewords of T
    trellis steps in AWGN at ``snr_db`` Es/N0 (4 / variance times the
    received value)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, T - 6)).astype(np.uint8)
    sym = 1.0 - 2.0 * conv_encode(bits).astype(np.float64)
    var = 10 ** (-snr_db / 10)
    y = sym + np.sqrt(var / 2) * rng.standard_normal(sym.shape)
    return (2.0 * y / (var / 2)).astype(np.float32).reshape(batch, T, 2)
