"""Correlation primitives used by synchronization (golden model).

Parity target: gr-gfdm/python/pygfdm/correlation.py:34-119 — but
vectorized (FFT-based) rather than loop-based.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "auto_correlate_halves",
    "cross_correlate_valid",
    "cross_correlate_full",
    "moving_sum",
]


def auto_correlate_halves(s: np.ndarray) -> complex:
    """sum(conj(first half) * second half)."""
    pivot = s.size // 2
    return complex(np.sum(np.conjugate(s[:pivot]) * s[pivot : 2 * pivot]))


def moving_sum(x: np.ndarray, window: int) -> np.ndarray:
    """Sliding-window sum; output[i] = sum(x[i:i+window])."""
    c = np.concatenate(([0], np.cumsum(x)))
    return c[window:] - c[: x.size - window + 1]


def cross_correlate_valid(s: np.ndarray, p: np.ndarray) -> np.ndarray:
    """np.correlate(s, p, 'valid') computed via FFT (len = len(s)-len(p)+1)."""
    n = s.size
    S = np.fft.fft(s)
    P = np.conjugate(np.fft.fft(p, n))
    cf = np.fft.ifft(S * P)[: n - p.size + 1]
    if not (np.iscomplexobj(s) or np.iscomplexobj(p)):
        cf = cf.real
    return cf


def cross_correlate_full(s: np.ndarray, p: np.ndarray) -> np.ndarray:
    """np.correlate(s, p, 'full') via zero-padded FFT."""
    n = s.size + p.size - 1
    S = np.fft.fft(s, n)
    P = np.conjugate(np.fft.fft(p, n))
    cf = np.fft.ifft(S * P)
    cf = np.roll(cf, p.size - 1)
    if not (np.iscomplexobj(s) or np.iscomplexobj(p)):
        cf = cf.real
    return cf
