"""Zadoff-Chu sequences (constant amplitude, ideal cyclic autocorrelation).

Parity target: gr-gfdm/python/pygfdm/zadoff_chu.py:11-24.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["zadoff_chu_sequence"]


def zadoff_chu_sequence(seq_length: int, u: int, shift: int = 0) -> np.ndarray:
    """ZC sequence x[n] = exp(-j pi u n (n + cf + 2 q) / N), cf = N mod 2."""
    if math.gcd(seq_length, u) != 1:
        raise ValueError(f"gcd(N_ZC={seq_length}, u={u}) != 1")
    if not 0 < u < seq_length:
        raise ValueError(f"require 0 < u={u} < N_ZC={seq_length}")
    cf = seq_length % 2
    n = np.arange(seq_length)
    phase = np.pi * u * n * (n + cf + 2 * shift) / seq_length
    return np.exp(-1j * phase)
