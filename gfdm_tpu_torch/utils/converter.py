"""IQ sample format conversion: interleaved sc16 <-> complex float.

The port's copy of ``gfdm_tpu.utils.converter`` (NumPy only), the
counterpart of the reference's USRP capture converter
(gr-gfdm/python/pygfdm/converter.py:31-56): sc16 is the interleaved int16
I/Q wire format of USRP-class radios.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sc16_to_cf64", "cf64_to_sc16", "SC16_SCALE"]

SC16_SCALE = 2**15 - 1


def sc16_to_cf64(raw: np.ndarray, scale: float = SC16_SCALE) -> np.ndarray:
    """Interleaved int16 [I0,Q0,I1,Q1,...] -> complex128 in [-1, 1]."""
    raw = np.asarray(raw, dtype=np.int16).reshape(-1, 2).astype(np.float64)
    return (raw[:, 0] + 1j * raw[:, 1]) / scale


def cf64_to_sc16(samples: np.ndarray, scale: float = SC16_SCALE) -> np.ndarray:
    """Complex samples in [-1, 1] -> interleaved int16 [I0,Q0,...]."""
    samples = np.asarray(samples)
    out = np.empty(2 * samples.size, dtype=np.int16)
    out[0::2] = np.clip(np.round(samples.real * scale), -32768, 32767)
    out[1::2] = np.clip(np.round(samples.imag * scale), -32768, 32767)
    return out
