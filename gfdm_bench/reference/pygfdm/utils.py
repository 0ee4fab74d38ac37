"""Small numeric helpers shared by the golden model and tests.

Fresh implementation of the helper surface provided by the reference's
``pygfdm/utils.py`` (see gr-gfdm/python/pygfdm/utils.py:26-117):
seeded random QPSK/symbol sources, energy measures and AWGN dimensioning.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "generate_seed",
    "random_qpsk",
    "random_samples",
    "demodulate_qpsk_bits",
    "qpsk_hard_map",
    "magnitude_squared",
    "signal_energy",
    "average_signal_energy",
    "awgn_noise_variance",
    "complex_noise",
    "evm",
]


def generate_seed(text: str) -> int:
    """Deterministic positive 32-bit seed derived from a string.

    Unlike the reference (which uses the salted builtin ``hash``,
    gr-gfdm/python/pygfdm/utils.py:26-28) we use a stable FNV-1a hash
    so seeds are reproducible across interpreter runs.
    """
    h = np.uint64(0xCBF29CE484222325)
    for ch in text.encode("utf-8"):
        h = np.uint64((int(h) ^ ch) * 0x100000001B3 % (1 << 64))
    return int(h % (2**32))


def random_qpsk(n: int, seed: int | None = None, dtype=np.complex128) -> np.ndarray:
    """Unit-average-energy random QPSK symbols (Gray, +-1/sqrt2 components)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 2 * n) * -2.0 + 1.0
    re, im = bits[:n], bits[n:]
    return ((re + 1j * im) / np.sqrt(2.0)).astype(dtype)


def random_samples(n: int, seed: int | None = None, dtype=np.complex128) -> np.ndarray:
    """Complex standard-normal samples."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(2 * n)
    return (d[:n] + 1j * d[n:]).astype(dtype)


def demodulate_qpsk_bits(syms: np.ndarray) -> np.ndarray:
    """Hard QPSK decision to interleaved bits (re-bit, im-bit per symbol)."""
    t = np.array([syms.real, syms.imag]) < 0.0
    return t.astype(int).T.flatten()


def qpsk_hard_map(syms: np.ndarray) -> np.ndarray:
    """Map noisy symbols to nearest QPSK constellation point."""
    e = 1.0 / np.sqrt(2.0)
    return e * (np.sign(syms.real) + 1j * np.sign(syms.imag))


def magnitude_squared(x: np.ndarray) -> np.ndarray:
    return x.real**2 + x.imag**2


def signal_energy(x: np.ndarray) -> float:
    return float(np.sum(magnitude_squared(x)))


def average_signal_energy(x: np.ndarray) -> float:
    return signal_energy(x) / x.size


def awgn_noise_variance(x: np.ndarray, snr_db: float, rate: float = 1.0) -> float:
    """Per-component noise variance for a target SNR over signal ``x``.

    Mirrors the convention of gr-gfdm/python/pygfdm/utils.py:106-110.
    """
    snr_lin = 10.0 ** (snr_db / 10.0)
    return average_signal_energy(x) / (2.0 * rate * snr_lin)


def complex_noise(n: int, noise_variance: float, seed: int | None = None) -> np.ndarray:
    if noise_variance == 0.0:
        return np.zeros(n, dtype=np.complex128)
    rng = np.random.default_rng(seed)
    s = np.sqrt(noise_variance)
    return s * rng.standard_normal(n) + 1j * s * rng.standard_normal(n)


def evm(rx: np.ndarray, ref: np.ndarray) -> float:
    """Error-vector magnitude (rms, linear) between two symbol vectors."""
    err = np.asarray(rx) - np.asarray(ref)
    return float(np.sqrt(signal_energy(err) / max(signal_energy(ref), 1e-30)))
