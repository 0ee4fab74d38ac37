"""Constellations and bit <-> symbol mapping (QA-grade, not throughput-grade).

Parity target: gr-gfdm/python/pygfdm/symbolmapping.py:20-47.
"""
from __future__ import annotations

import numpy as np

__all__ = ["constellation", "bits_to_symbols", "symbols_to_bits", "hard_decide"]

def _gray_levels(nbits: int) -> dict[int, float]:
    """Per-axis Gray code -> odd amplitude level for 2**nbits levels.

    Binary-reflected Gray order walks the levels monotonically, so adjacent
    levels differ in one bit and a per-axis quantizer equals nearest-point.
    """
    n = 1 << nbits
    return {(i ^ (i >> 1)): float(2 * i - (n - 1)) for i in range(n)}


def _gray_square_qam(order: int) -> np.ndarray:
    """Gray-coded square QAM, unit average energy; index = `order` bits with
    the msb half selecting the I level and the lsb half the Q level.

    order=4 reproduces the classic Gray 16-QAM (00,01,11,10 -> -3,-1,+1,+3);
    order=6 is Gray 64-QAM."""
    half = order // 2
    levels = _gray_levels(half)
    mask = (1 << half) - 1
    pts = np.empty(1 << order, dtype=np.complex128)
    for idx in range(1 << order):
        pts[idx] = levels[(idx >> half) & mask] + 1j * levels[idx & mask]
    energy = np.mean(np.abs(pts) ** 2)  # 10 for 16-QAM, 42 for 64-QAM
    return pts / np.sqrt(energy)


_CONSTELLATIONS = {
    1: np.array([1.0 + 0.0j, -1.0 + 0.0j]),
    2: np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0),
    4: _gray_square_qam(4),
    6: _gray_square_qam(6),
}


def constellation(order: int) -> np.ndarray:
    """Points for 2**order-ary mapping (1=BPSK, 2=QPSK, 4=Gray 16-QAM, 6=Gray 64-QAM)."""
    return _CONSTELLATIONS[order].copy()


def bits_to_symbols(bits: np.ndarray, points: np.ndarray) -> np.ndarray:
    order = int(np.log2(points.size))
    b = np.asarray(bits).reshape(-1, order)
    idx = b.dot(1 << np.arange(order - 1, -1, -1))
    return points[idx]


def hard_decide(symbols: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Nearest-constellation-point decision (returns points, not indices)."""
    d = np.abs(symbols.reshape(-1, 1) - points.reshape(1, -1)) ** 2
    return points[np.argmin(d, axis=1)].reshape(np.shape(symbols))


def symbols_to_bits(symbols: np.ndarray, points: np.ndarray) -> np.ndarray:
    order = int(np.log2(points.size))
    d = np.abs(np.asarray(symbols).reshape(-1, 1) - points.reshape(1, -1)) ** 2
    idx = np.argmin(d, axis=1)
    shifts = np.arange(order - 1, -1, -1)
    return ((idx.reshape(-1, 1) >> shifts) & 1).flatten()
