"""GFDM modulation golden model (NumPy, float64).

Two independent implementations:

1. :func:`modulation_matrix` — the O(N^2) definition of GFDM: every symbol
   (k, m) rides on a circularly shifted, frequency-shifted copy of the
   prototype pulse. Ground truth (parity target:
   gr-gfdm/python/pygfdm/modulation.py:27-62).

2. :func:`modulate_block` — the low-complexity sparse-frequency-domain
   modulator: per-subcarrier M-point FFT, sparse FD filtering with overlap L,
   circular overlap-add into the M*K spectrum, block IFFT. Algorithmic parity
   target: gr-gfdm/lib/modulator_kernel_cc.cc:98-141 and
   gr-gfdm/python/pygfdm/gfdm_modulation.py:108-131 (compat_mode=False).

Both operate on the framework's (K, M) subcarrier-major grid convention.
"""
from __future__ import annotations

import numpy as np

from .filters import frequency_domain_filter, normalize_taps_energy
from .mapping import map_to_resources, subcarrier_map

__all__ = [
    "modulation_matrix",
    "modulate_block",
    "modulate_mapped_block",
    "spectrum_from_grid",
]


def modulation_matrix(
    filter_taps: np.ndarray,
    timeslots: int,
    subcarriers: int,
    subcarrier_major: bool = True,
) -> np.ndarray:
    """Dense N x N GFDM modulation matrix A (N = M*K).

    Column for symbol (k, m) is ``roll(g * e^{2pi i k n / K}, m*K)`` with the
    prototype pulse ``g`` centered via a half-length roll.

    If ``subcarrier_major`` the columns are ordered to act on flat frames
    ``d[k*M + m]`` (framework convention); otherwise on ``d[m*K + k]``.
    """
    n_total = timeslots * subcarriers
    g = np.roll(np.asarray(filter_taps, dtype=np.complex128), n_total // 2)
    n = np.arange(n_total)
    A = np.empty((n_total, n_total), dtype=np.complex128)
    for m in range(timeslots):
        for k in range(subcarriers):
            f_mod = np.exp(2j * np.pi * (k / subcarriers) * n)
            col = np.roll(g * f_mod, m * subcarriers)
            if subcarrier_major:
                A[:, k * timeslots + m] = col
            else:
                A[:, m * subcarriers + k] = col
    return A


def spectrum_from_grid(grid: np.ndarray, sparse_taps: np.ndarray, overlap: int) -> np.ndarray:
    """Sparse-FD synthesis: (K, M) grid -> length M*K spectrum (DC on bin 0).

    Each subcarrier's M-point FFT is repeated L times, weighted by the sparse
    taps, and circularly overlap-added with its neighbours at stride M:

      X[j*M : (j+1)*M] = sum_i W[(j - (i - L//2)) mod K] * taps_part[(i+L//2)%L]

    which is the roll-free restatement of the scatter loop in
    gr-gfdm/lib/modulator_kernel_cc.cc:107-134.
    """
    subcarriers, timeslots = grid.shape
    sparse_taps = np.asarray(sparse_taps, dtype=np.complex128)
    if sparse_taps.size != timeslots * overlap:
        raise ValueError("need M*L sparse frequency taps")

    W = np.fft.fft(grid, axis=1)  # (K, M) per-subcarrier spectra
    parts = sparse_taps.reshape(overlap, timeslots)
    X = np.zeros((subcarriers, timeslots), dtype=np.complex128)
    for i in range(overlap):
        part = parts[(i + overlap // 2) % overlap]
        X += np.roll(W, i - overlap // 2, axis=0) * part[None, :]
    return X.reshape(-1)


def modulate_block(grid: np.ndarray, sparse_taps: np.ndarray, overlap: int) -> np.ndarray:
    """Low-complexity GFDM modulation of one (K, M) grid -> M*K samples.

    Output scaling matches the reference kernel: plain ``numpy.fft.ifft`` of
    the synthesized spectrum (the FFTW backward transform scaled by 1/(M*K),
    gr-gfdm/lib/modulator_kernel_cc.cc:137-140).
    """
    return np.fft.ifft(spectrum_from_grid(grid, sparse_taps, overlap))


def modulate_mapped_block(
    data: np.ndarray,
    timeslots: int,
    subcarriers: int,
    active_subcarriers: int,
    overlap: int,
    alpha: float,
    dc_free: bool = False,
    per_timeslot: bool = True,
    filtertype: str = "rrc",
) -> np.ndarray:
    """Map data onto active subcarriers and modulate (energy-normalized taps).

    Parity target: gr-gfdm/python/pygfdm/gfdm_modulation.py:161-170.
    """
    smap = subcarrier_map(subcarriers, active_subcarriers, dc_free=dc_free)
    grid = map_to_resources(data, timeslots, subcarriers, smap, per_timeslot=per_timeslot)
    taps = frequency_domain_filter(filtertype, alpha, timeslots, subcarriers, overlap)
    taps = normalize_taps_energy(taps, timeslots)
    return modulate_block(grid, taps, overlap)
