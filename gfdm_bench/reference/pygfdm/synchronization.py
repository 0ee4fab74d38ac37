"""Schmidl&Cox-style burst synchronization (golden model, vectorized NumPy).

The reference delegates online sync to the external XFDMSync OOT module and
keeps the algorithm as research code
(gr-gfdm/python/pygfdm/synchronization.py:132-263). This framework is
self-contained: the same algorithm - running autocorrelation of the repeated
preamble halves, CP-length integration, CFO estimate from the autocorrelation
angle, and an autocorrelation-gated cross-correlation peak - is provided here
(golden) and as a batched JAX op (gfdm_tpu.ops.sync).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .correlation import cross_correlate_valid, moving_sum

__all__ = [
    "autocorrelate_preamble",
    "integrate_abs",
    "autocorrelation_sync",
    "cross_correlation_peak",
    "find_frame_start",
    "threshold_factor",
    "cfo_to_phase_increment",
    "correct_frequency_offset",
    "SyncResult",
]


def autocorrelate_preamble(s: np.ndarray, half_len: int) -> np.ndarray:
    """Normalized running autocorrelation of s[i:i+N] vs s[i+N:i+2N].

    ac[i] = 2 * sum_j conj(s[i+j]) s[i+j+N] / energy(s[i:i+2N]),  N=half_len.
    (synchronization.py:132-143 vectorized via moving sums.)
    """
    n = half_len
    if s.size < 2 * n + 1:
        raise ValueError("signal shorter than one preamble")
    c = np.conjugate(s[:-n]) * s[n:]
    p = moving_sum(c, n)[: s.size - 2 * n]
    energy = moving_sum(np.abs(s) ** 2, 2 * n)[: s.size - 2 * n]
    return 2.0 * p / np.maximum(energy, 1e-30)


def integrate_abs(ac_mag: np.ndarray, cp_len: int) -> np.ndarray:
    """Moving average over the trailing cp_len+1 samples (plateau removal).

    ic[i] = mean(ac_mag[i-cp_len : i+1])  (synchronization.py:146-151).
    """
    w = cp_len + 1
    padded = np.concatenate((np.zeros(cp_len), ac_mag))
    return moving_sum(padded, w) / w


def autocorrelation_sync(s: np.ndarray, half_len: int, cp_len: int):
    """(coarse index, cfo, integrated metric, raw autocorrelation)."""
    ac = autocorrelate_preamble(s, half_len)
    ic = integrate_abs(np.abs(ac), cp_len)
    nm = int(np.argmax(ic))
    cfo = float(np.angle(ac[nm]) / (2.0 * np.pi))
    return nm, cfo, ic, ac


def cfo_to_phase_increment(cfo: float, fft_len: int) -> float:
    return 2.0 * np.pi * cfo / float(fft_len)


def correct_frequency_offset(s: np.ndarray, cfo: float, fft_len: float = 1.0) -> np.ndarray:
    """Multiply by e^{j 2 pi cfo n / fft_len} (synchronization.py:187-190)."""
    inc = cfo_to_phase_increment(cfo, fft_len)
    return s * np.exp(1j * inc * np.arange(s.size))


def cross_correlation_peak(
    s: np.ndarray, preamble: np.ndarray, ac_gate: np.ndarray
) -> tuple[int, np.ndarray]:
    """Cross-correlation peak gated by the autocorrelation magnitude.

    (synchronization.py:173-184.)
    """
    cc = cross_correlate_valid(s, preamble) / preamble.size
    acc = np.abs(cc)
    n = min(acc.size, ac_gate.size)
    gated = acc[:n] * ac_gate[:n]
    return int(np.argmax(gated)), gated


def threshold_factor(false_alarm_prob: float) -> float:
    """Detection threshold from a false-alarm probability (s.py:239-243)."""
    if not false_alarm_prob < 1.0:
        raise ValueError("false alarm probability must be < 1.0")
    return float(np.sqrt(-(4.0 / np.pi) * np.log(false_alarm_prob)))


@dataclass
class SyncResult:
    frame_start: int
    cfo: float
    coarse_peak: int
    ac_metric: np.ndarray
    gated_xcorr: np.ndarray


def find_frame_start(
    s: np.ndarray, x_preamble: np.ndarray, fft_len: int, cp_len: int
) -> SyncResult:
    """Full sync pipeline (synchronization.py:246-263): coarse AC stage, CFO
    fix, gated cross-correlation fine stage."""
    x = x_preamble / np.sqrt(np.mean(np.abs(x_preamble) ** 2))
    nm, cfo, ic, _ac = autocorrelation_sync(s, fft_len, cp_len)
    # cfo is relative to the subcarrier spacing (autocorrelation lag fft_len)
    s_fixed = correct_frequency_offset(s, -cfo, fft_len)
    nc, gated = cross_correlation_peak(s_fixed, x, ic)
    return SyncResult(frame_start=nc, cfo=cfo, coarse_peak=nm, ac_metric=ic, gated_xcorr=gated)
