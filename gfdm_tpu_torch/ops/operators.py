"""Linear-operator factory: golden-model stages as dense matrices.

A copy of ``gfdm_tpu.ops.operators`` (NumPy only), so that the PyTorch port
builds exactly the operators the JAX package builds without importing it.
The reference decomposes GFDM into per-subcarrier FFT loops; this package
exports every linear stage - modulation, demodulation, FFT,
channel-estimation smoothing/interpolation, CP insertion, windowing, resource
mapping - as a dense operator, built *column-by-column from the golden model*
(so operator parity with the reference is inherited by construction, in
float64), then composed and cast to the compute dtype
(gr-gfdm/python/pygfdm/modulation.py:27-62 is the reference's matrix form).

All functions are cached per GfdmConfig and return NumPy arrays; the torch
modules turn them into device tensors once per (config, dtype, device).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..config import GfdmConfig
from ..ref import demodulation as demod_ref
from ..ref import modulation as mod_ref
from ..ref.channel_estimation import PreambleChannelEstimator

__all__ = [
    "dft_matrix",
    "idft_matrix",
    "modulation_operator",
    "demodulation_fd_operator",
    "demodulation_operator",
    "tx_core_operator",
    "tx_frame_operator",
    "channel_estimation_operator",
    "cnr_interpolation_operator",
    "cp_indices",
    "cp_window",
    "demap_indices",
]


def _apply_columnwise(fn, n_in: int, n_out: int) -> np.ndarray:
    """Build the matrix of a linear map by probing with basis vectors."""
    A = np.empty((n_out, n_in), dtype=np.complex128)
    e = np.zeros(n_in, dtype=np.complex128)
    for j in range(n_in):
        e[j] = 1.0
        A[:, j] = fn(e)
        e[j] = 0.0
    return A


@lru_cache(maxsize=32)
def dft_matrix(n: int) -> np.ndarray:
    """Unnormalized DFT matrix F with F[j,k] = exp(-2pi i jk/n)."""
    jk = np.outer(np.arange(n), np.arange(n))
    return np.exp(-2j * np.pi * jk / n)


@lru_cache(maxsize=32)
def idft_matrix(n: int) -> np.ndarray:
    """Normalized inverse DFT matrix (matches numpy.fft.ifft)."""
    return np.conjugate(dft_matrix(n)) / n


@lru_cache(maxsize=16)
def modulation_operator(cfg: GfdmConfig) -> np.ndarray:
    """(N, N): subcarrier-major grid symbols -> time-domain frame.

    Column j is the golden modulator's response to basis symbol j
    (parity with gr-gfdm/lib/modulator_kernel_cc.cc:98-141 by
    construction).
    """
    n = cfg.block_len
    taps = cfg.tx_filter_taps

    def fn(d):
        return mod_ref.modulate_block(d.reshape(cfg.subcarriers, cfg.timeslots), taps, cfg.overlap)

    return _apply_columnwise(fn, n, n)


@lru_cache(maxsize=16)
def demodulation_fd_operator(cfg: GfdmConfig) -> np.ndarray:
    """(N, N): block-FFT spectrum -> demodulated symbols (MF taps).

    The sparse gather/fold + per-subcarrier IFFT stage
    (receiver_kernel_cc.cc:165-225) as one operator. Keeping the FD entry
    point separate lets the ZF path divide by the channel estimate between
    the block FFT and this operator, exactly like
    fft_equalize_filter_downsample (receiver_kernel_cc.cc:309-320).
    """
    n = cfg.block_len
    taps = cfg.rx_filter_taps

    def fn(X):
        S = demod_ref._fold_gather(
            X.reshape(cfg.subcarriers, cfg.timeslots), taps, cfg.overlap
        )
        return demod_ref.subcarriers_to_time(S).reshape(-1)

    return _apply_columnwise(fn, n, n)


@lru_cache(maxsize=16)
def demodulation_operator(cfg: GfdmConfig) -> np.ndarray:
    """(N, N): time-domain frame -> demodulated symbols (MF receiver)."""
    return demodulation_fd_operator(cfg) @ dft_matrix(cfg.block_len)


@lru_cache(maxsize=16)
def mapping_matrix(cfg: GfdmConfig) -> np.ndarray:
    """(N, n_data) 0/1 scatter matrix for the resource mapper."""
    n_data = cfg.n_data_symbols
    A = np.zeros((cfg.block_len, n_data), dtype=np.complex128)
    smap = cfg.subcarrier_map
    M = cfg.timeslots
    for j in range(n_data):
        if cfg.per_timeslot:
            tidx, aidx = divmod(j, smap.size)
        else:
            aidx, tidx = divmod(j, M)
        A[M * smap[aidx] + tidx, j] = 1.0
    return A


@lru_cache(maxsize=16)
def tx_core_operator(cfg: GfdmConfig) -> np.ndarray:
    """(N, n_data): data symbols -> modulated core frame (map + modulate)."""
    return modulation_operator(cfg) @ mapping_matrix(cfg)


def cp_indices(cfg: GfdmConfig, cyclic_shift: int = 0) -> np.ndarray:
    """Gather indices implementing CP+CS insertion with a cyclic shift.

    out[i] = core[idx[i]] reproduces add_cyclic_prefix_cc.cc:78-90.
    """
    n = cfg.block_len
    head = np.arange(n - cfg.cp_len - cyclic_shift, n)
    body = np.arange(n)
    tail = np.arange(0, cfg.cs_len - cyclic_shift)
    return np.concatenate((head, body, tail))


def cp_window(cfg: GfdmConfig) -> np.ndarray:
    """Full window vector (1s in the flat top, RC ramps at the edges)."""
    w = np.ones(cfg.window_len, dtype=np.float64)
    r = cfg.ramp_len
    if r > 0:
        w[:r] = cfg.window_taps[:r]
        w[-r:] = cfg.window_taps[-r:]
    return w


@lru_cache(maxsize=16)
def tx_frame_operator(cfg: GfdmConfig, cyclic_shift: int = 0) -> np.ndarray:
    """(window_len, n_data): data -> windowed CP-framed core frame.

    The whole per-shift Tx chain minus the preamble concat as one matmul
    (transmitter_kernel.cc:78-98 without insert_preamble).
    """
    core = tx_core_operator(cfg)
    framed = core[cp_indices(cfg, cyclic_shift), :]
    return framed * cp_window(cfg)[:, None]


@lru_cache(maxsize=16)
def channel_estimation_operator(cfg: GfdmConfig) -> np.ndarray:
    """(M*K, 2K): received core preamble -> full-frame channel estimate.

    Steps 1-3 of the preamble estimator (per-half FFT x inverse reference,
    Gaussian smoothing, per-subcarrier linear interpolation,
    preamble_channel_estimator_cc.cc:111-294) are all linear in the received
    preamble, so the whole estimator collapses into one dense operator.
    """
    est = PreambleChannelEstimator(
        cfg.timeslots,
        cfg.subcarriers,
        cfg.active_subcarriers,
        cfg.dc_free,
        cfg.core_preamble,
    )
    return _apply_columnwise(est.estimate_frame, 2 * cfg.subcarriers, cfg.block_len)


@lru_cache(maxsize=16)
def cnr_interpolation_operator(cfg: GfdmConfig) -> np.ndarray:
    """(M*K, n_active) real: per-subcarrier CNRs -> per-bin CNRs (FFT order).

    Runs the estimator's own smoothing + interpolation stages (steps 2-3 of
    preamble_channel_estimator_cc.cc:145-274) over the CNR vector so a
    per-bin MMSE weight aligned with the full-frame channel estimate can be
    formed. Input ordering matches estimate_snr's concat(positive-frequency,
    negative-frequency) CNR layout (preamble_channel_estimator_cc.cc:187-235).
    Capability beyond the reference, which only tags the raw scalar snr_lin
    and CNR vector (channel_estimator_cc_impl.cc:99-114).
    """
    est = PreambleChannelEstimator(
        cfg.timeslots,
        cfg.subcarriers,
        cfg.active_subcarriers,
        cfg.dc_free,
        cfg.core_preamble,
    )
    K = cfg.subcarriers
    half = cfg.active_subcarriers // 2
    offset = 1 if cfg.dc_free else 0
    bins = np.concatenate(
        (np.arange(half) + offset, np.arange(half) + (K - half))
    )

    def fn(c):
        full = np.zeros(K, dtype=np.complex128)
        full[bins] = c
        return est.interpolate_frame(est.filter_preamble_estimate(full))

    return _apply_columnwise(fn, 2 * half, cfg.block_len).real


def demap_indices(cfg: GfdmConfig) -> np.ndarray:
    """Frame positions of the data symbols (inverse of the resource mapper)."""
    Amap = mapping_matrix(cfg)
    rows, cols = np.nonzero(Amap.real)
    out = np.empty(cfg.n_data_symbols, dtype=np.int32)
    out[cols] = rows
    return out


def _interference_matrix(cfg: GfdmConfig) -> np.ndarray:
    """(M, M) time-domain IC operator C = idft_M . diag(ic_taps) . dft_M."""
    return (
        idft_matrix(cfg.timeslots)
        @ np.diag(demod_ref.ic_filter_taps(cfg.rx_filter_taps, cfg.timeslots, cfg.overlap))
        @ dft_matrix(cfg.timeslots)
    )
