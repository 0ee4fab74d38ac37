"""Legacy-compatible components (golden model).

The reference keeps two historical pieces alive that the modern chain
superseded but still builds and tests:

  - ``rrc_filter_sparse``: in-C++ sparse FD RRC tap generation that only
    supports overlap=2 and leaves the (M)-th bin zero
    (gr-gfdm/lib/gfdm_utils.cc:33-56)
  - ``modulator_cc``: oversampled tagged-stream modulator with a centered
    spectrum in an fft_len >= M*K grid and optional inline sync-symbol
    passthrough (gr-gfdm/lib/modulator_cc_impl.cc:115-199)

Both are reproduced here for API/waveform parity.
"""
from __future__ import annotations

import numpy as np

from .filters import time_taps

__all__ = ["sparse_taps_legacy", "modulate_oversampled_block"]


def sparse_taps_legacy(
    filtertype: str, alpha: float, timeslots: int, subcarriers: int
) -> np.ndarray:
    """Overlap-2 sparse FD taps, legacy layout: [H[0..M), 0, conj(H[M-1..1])].

    Differs from the modern layout [H[0..M), H[-M..0)] in the bin mapping of
    the second half (index M stays zero, gfdm_utils.cc:51-55). Taps are NOT
    energy-normalized (the legacy modulator consumes them raw).
    """
    M = timeslots
    n = M * subcarriers
    h = time_taps(filtertype, alpha, M, subcarriers)
    H = np.fft.fft(np.roll(h, n // 2))
    taps = np.zeros(2 * M, dtype=np.complex128)
    taps[:M] = H[:M]
    for i in range(M - 1):
        taps[i + M + 1] = np.conjugate(taps[M - 1 - i])
    return taps


def modulate_oversampled_block(
    grid: np.ndarray, sparse_taps: np.ndarray, fft_len: int
) -> np.ndarray:
    """Oversampled GFDM modulation of a (K, M) grid into fft_len samples.

    Mirror of modulator_cc_impl::modulate_gfdm_frame
    (modulator_cc_impl.cc:115-153): per-subcarrier M-point FFT, filter-width-2
    tap multiply, circular placement at a CENTERED spectrum offset

      offset_k = (fft_len/2 + (fft_len - N)/2 - M/2 + k*M) mod fft_len

    with the source vector rotated by M (the L*M/2 half-rotation), then a
    full fft_len IFFT scaled by 1/N.
    """
    K, M = grid.shape
    n = M * K
    L = sparse_taps.size // M  # filter width (2)
    if fft_len < n:
        raise ValueError("fft_len must be >= timeslots * subcarriers")

    W = np.fft.fft(grid, axis=1)  # (K, M)
    X = np.zeros(fft_len, dtype=np.complex128)
    lm = L * M
    for k in range(K):
        sc_tmp = (np.tile(W[k], L) * sparse_taps).astype(np.complex128)
        offset = (fft_len // 2 + (fft_len - n) // 2 - ((L - 1) * M) // 2 + k * M) % fft_len
        src = np.roll(sc_tmp, -(lm // 2))
        idx = (offset + np.arange(lm)) % fft_len
        np.add.at(X, idx, src)
    # unnormalized inverse FFT scaled by 1/N (fft_complex_rev * 1/N)
    return np.fft.ifft(X) * (fft_len / n)
