"""GFDM demodulation golden model (NumPy, float64).

Sparse-frequency-domain receiver per "Low Complexity GFDM Receiver Based On
Sparse Frequency Domain Processing" [Gaspar+13]:

  block FFT -> (optional ZF equalization) -> per-subcarrier gather of the L
  tap-weighted M-bin segments -> fold/superposition (downsample in FD) ->
  per-subcarrier M-point IFFT.

Algorithmic parity targets:
  - gr-gfdm/lib/receiver_kernel_cc.cc:165-225,301-334 (kernel)
  - gr-gfdm/python/pygfdm/gfdm_receiver.py:34-123 (golden)
  - IC taps + interference cancellation: receiver_kernel_cc.cc:56-63,274-299
  - matrix receivers (MF/ZF): gfdm_receiver.py:202-237

Framework convention: frames and outputs are subcarrier-major, grids (K, M).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "fd_filter_downsample",
    "demodulate_block",
    "demodulate_block_fd",
    "equalize_fd",
    "ic_filter_taps",
    "cancel_sc_interference",
    "subcarriers_to_time",
    "matrix_receiver",
]


def _fold_gather(spectrum_blocks: np.ndarray, sparse_taps: np.ndarray, overlap: int) -> np.ndarray:
    """Adjoint of the modulator's scatter: gather + weight + fold.

    S[k] = sum_i X[(k + i - L//2) mod K] * taps_part[(i + L//2) % L]

    (receiver_kernel_cc.cc:165-192 restated roll-free.)
    """
    subcarriers, timeslots = spectrum_blocks.shape
    parts = np.asarray(sparse_taps, dtype=np.complex128).reshape(overlap, timeslots)
    S = np.zeros((subcarriers, timeslots), dtype=np.complex128)
    for i in range(overlap):
        part = parts[(i + overlap // 2) % overlap]
        S += np.roll(spectrum_blocks, -(i - overlap // 2), axis=0) * part[None, :]
    return S


def fd_filter_downsample(frame: np.ndarray, sparse_taps: np.ndarray, overlap: int) -> np.ndarray:
    """Time-domain frame -> per-subcarrier folded FD symbols, (K, M)."""
    timeslots = sparse_taps.size // overlap
    subcarriers = frame.size // timeslots
    X = np.fft.fft(frame).reshape(subcarriers, timeslots)
    return _fold_gather(X, sparse_taps, overlap)


def equalize_fd(frame: np.ndarray, channel_fd: np.ndarray) -> np.ndarray:
    """Zero-forcing FD equalization: FFT then element-wise divide.

    (receiver_kernel_cc.cc:309-320 — note the reference divides by the
    channel estimate stream.)
    """
    return np.fft.fft(frame) / np.asarray(channel_fd, dtype=np.complex128)


def subcarriers_to_time(S: np.ndarray) -> np.ndarray:
    """Per-subcarrier M-point IFFT of the folded FD symbols, (K, M) -> (K, M).

    numpy ifft normalization == FFTW backward * 1/M
    (receiver_kernel_cc.cc:211-225).
    """
    return np.fft.ifft(S, axis=1)


def demodulate_block(
    frame: np.ndarray,
    rx_sparse_taps: np.ndarray,
    overlap: int,
    channel_fd: np.ndarray | None = None,
) -> np.ndarray:
    """Matched-filter (or ZF-equalized) demodulation of one M*K frame.

    Returns the flat subcarrier-major symbol estimate d[k*M+m].
    """
    timeslots = rx_sparse_taps.size // overlap
    subcarriers = frame.size // timeslots
    if channel_fd is None:
        X = np.fft.fft(frame)
    else:
        X = equalize_fd(frame, channel_fd)
    S = _fold_gather(X.reshape(subcarriers, timeslots), rx_sparse_taps, overlap)
    return subcarriers_to_time(S).reshape(-1)


def demodulate_block_fd(
    S: np.ndarray,
) -> np.ndarray:
    """Folded FD symbols (K, M) -> flat time-domain symbol estimates."""
    return subcarriers_to_time(S).reshape(-1)


def ic_filter_taps(rx_sparse_taps: np.ndarray, timeslots: int, overlap: int) -> np.ndarray:
    """Interference-cancellation taps: first part x last part, length M.

    (receiver_kernel_cc.cc:56-63.)
    """
    t = np.asarray(rx_sparse_taps, dtype=np.complex128)
    return t[:timeslots] * t[timeslots * (overlap - 1) :]


def cancel_sc_interference(
    detected_td: np.ndarray,
    folded_fd: np.ndarray,
    ic_taps: np.ndarray,
) -> np.ndarray:
    """One interference-cancellation pass.

    For each subcarrier k: subtract FFT(detected[k-1] + detected[k+1]) * ic_taps
    from the folded FD symbols (receiver_kernel_cc.cc:274-299).

    ``detected_td``: (K, M) hard-decided time-domain symbols.
    ``folded_fd``: (K, M) folded FD symbols (pre-IFFT receiver state).
    Returns the cleaned folded FD symbols (K, M).
    """
    neighbors = np.roll(detected_td, 1, axis=0) + np.roll(detected_td, -1, axis=0)
    V = np.fft.fft(neighbors, axis=1)
    return folded_fd - V * ic_taps[None, :]


def matrix_receiver(A: np.ndarray, frame: np.ndarray, kind: str = "mf") -> np.ndarray:
    """Reference O(N^2) receivers from the modulation matrix A.

    kind='mf': matched filter A^H r; kind='zf': A^-1 r.
    (gfdm_receiver.py:202-237.)
    """
    if kind == "mf":
        return A.conj().T @ frame
    if kind == "zf":
        return np.linalg.solve(A, frame)
    raise ValueError("kind must be 'mf' or 'zf'")
