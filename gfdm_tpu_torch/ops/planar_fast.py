"""Structure-exploiting (factorized) planar pipeline - the 'fast' method.

The port of ``gfdm_tpu.ops.planar_fast`` as plain torch ops. The dense
path (:mod:`.planar_pipeline`) applies (2N, 2N) realified matmuls for the
block DFT and the FD demodulation stage. For N = K*M those have
Cooley-Tukey structure: a K-point stage, a twiddle multiply, and an M-point
stage. Likewise the sparse filter fold/scatter is L rolls + elementwise tap
multiplies instead of a dense matmul. No O(N^2) operator exists anywhere, so
K >= 1024 configs stay practical.

Decomposition used (N = K*M, n = M*n2 + n1, X index = K*k1 + k2 with
n1,k1 in [0,M), n2,k2 in [0,K)):

  X[K*k1 + k2] = sum_n1 W_M^{n1 k1} * T[n1,k2] * sum_n2 x[M*n2+n1] W_K^{n2 k2}

with twiddle T[n1,k2] = exp(-2pi i n1 k2 / N); the result is the plain DFT
in natural order.

The constants are built in NumPy float64 once per (config, dtype) exactly as
the JAX package builds them (:func:`_fft_consts`, :func:`_est_consts`) and
uploaded once per device (:func:`fast_consts`); every function here takes
that tensor dict as ``consts``. The factored CUDA kernels
(:mod:`gfdm_tpu_torch.kernels.fused`) read the same tables.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import resolve_device
from . import operators
from .planar import (
    bf16_operator, host_dtype, pabs2, pdiv, pmatmul, pmul, real_operator, to_planar,
)

__all__ = [
    "fast_consts",
    "fast_fft_n",
    "fast_ifft_n",
    "demod_fast",
    "modulate_core_fast",
    "estimate_channel_fast",
    "snr_power_fast",
]


@lru_cache(maxsize=16)
def _fft_consts(cfg: GfdmConfig, dtype_name: str):
    dt = host_dtype(dtype_name)
    K, M = cfg.subcarriers, cfg.timeslots
    N = K * M
    n1 = np.arange(M).reshape(M, 1)
    k2 = np.arange(K).reshape(1, K)
    tw = np.exp(-2j * np.pi * n1 * k2 / N)  # (M, K)
    itw = np.conjugate(tw)
    return {
        "FK_W": real_operator(operators.dft_matrix(K).T, dt),
        "iFK_W": real_operator(operators.idft_matrix(K).T, dt),
        "FM_W": real_operator(operators.dft_matrix(M).T, dt),
        "iFM_W": real_operator(operators.idft_matrix(M).T, dt),
        "tw": to_planar(tw, dtype=dt),  # (M, 2, K)
        "itw": to_planar(itw, dtype=dt),
        "tx_parts": to_planar(
            cfg.tx_filter_taps.reshape(cfg.overlap, M), dtype=dt
        ),  # (L, 2, M)
        "rx_parts": to_planar(
            cfg.rx_filter_taps.reshape(cfg.overlap, M), dtype=dt
        ),
    }


@lru_cache(maxsize=16)
def _est_consts(cfg: GfdmConfig, dtype_name: str):
    """Factorized channel/SNR estimation constants.

    The dense (2N, 4K) channel-estimation operator (planar_pipeline E_W) is
    the composition interpolate . smooth . per-half-FFT-times-inverse
    (preamble_channel_estimator_cc.cc:111-294). Factorized form: two K-point
    DFT matmuls + elementwise inverse-preamble multiply, one small real
    (K, n_est) smoothing matmul, and a 2-tap gather/lerp for the linear
    interpolation - O(K^2) state instead of O(K*N).
    """
    from ..ref.channel_estimation import PreambleChannelEstimator

    dt = host_dtype(dtype_name)
    # only the K-point DFT is bf16 in the bfloat16 mode
    rdt = np.float32 if dtype_name == "bfloat16" else dt
    K = cfg.subcarriers
    est = PreambleChannelEstimator(
        cfg.timeslots, K, cfg.active_subcarriers, cfg.dc_free, cfg.core_preamble
    )
    n_est = cfg.active_subcarriers + (1 if cfg.dc_free else 0)
    # The reference's 0.5/FFT(preamble half) inverse is +-inf at unused
    # subcarriers (preamble energy 0 there); the smoothing stage never reads
    # those bins, but in factorized form 0 * inf would poison the matmul -
    # mask the inverse to the active band the smoother actually reads.
    half = cfg.active_subcarriers // 2
    offset = 1 if cfg.dc_free else 0
    read_mask = np.zeros(K)
    read_mask[offset : offset + half] = 1.0
    read_mask[K - half : K] = 1.0
    inv0 = np.where(read_mask > 0, est.inv_freq_preamble0, 0.0)
    inv1 = np.where(read_mask > 0, est.inv_freq_preamble1, 0.0)
    # smoothing (step 2) as a small real matrix, probed column-wise
    S = np.zeros((K, n_est), dtype=np.float64)
    e = np.zeros(K, dtype=np.complex128)
    for j in range(K):
        e[j] = 1.0
        S[j, :] = est.filter_preamble_estimate(e).real
        e[j] = 0.0
    # interpolation (step 3) as gather + lerp: probe with arange so each
    # output bin encodes (left index + fractional weight) exactly
    p1 = est.interpolate_frame(np.arange(n_est, dtype=np.float64)).real
    idxA = np.floor(p1 + 1e-9).astype(np.int32)
    t = (p1 - idxA).astype(rdt)
    idxB = np.minimum(idxA + 1, n_est - 1).astype(np.int32)
    k2 = np.arange(2 * K)
    return {
        "FK_W": real_operator(operators.dft_matrix(K).T, dt),
        "inv0": to_planar(inv0, dtype=rdt),  # (2, K), masked to active band
        "inv1": to_planar(inv1, dtype=rdt),
        "S_T": S.astype(rdt),  # (K, n_est)
        "idxA": idxA,
        "idxB": idxB,
        "t": t,
        "tw2": to_planar(np.exp(-2j * np.pi * k2 / (2 * K)), dtype=rdt),
    }


_DEVICE_CACHE: dict = {}


def fast_consts(cfg: GfdmConfig, dtype_name: str = "float32", device=None) -> dict:
    """:func:`_fft_consts` and :func:`_est_consts` as tensors on ``device``
    (the card unless ``device="cpu"``), uploaded once per (config, dtype,
    device); index arrays as int32. Both
    sets hold the same ``FK_W``. With ``dtype_name="bfloat16"`` every table
    of :func:`_fft_consts` (and so ``FK_W``) is bf16, the estimator's other
    tables float32, as in the JAX package."""
    device = resolve_device(device, "fast_consts")
    key = (cfg, dtype_name, str(device))
    hit = _DEVICE_CACHE.get(key)
    if hit is None:
        fft = _fft_consts(cfg, dtype_name)
        arrays = {**fft, **_est_consts(cfg, dtype_name)}
        bf16 = set(fft) if dtype_name == "bfloat16" else set()
        hit = _DEVICE_CACHE[key] = {
            name: (bf16_operator(a) if name in bf16 else torch.from_numpy(np.ascontiguousarray(
                a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) else a
            ))).to(device)
            for name, a in arrays.items()
        }
    return hit


def _perm(x: torch.Tensor, order: tuple) -> torch.Tensor:
    """Permute the trailing ``len(order)`` axes of ``x`` by ``order``."""
    nl = x.ndim - len(order)
    return x.permute(tuple(range(nl)) + tuple(nl + i for i in order))


def estimate_channel_fast(cfg: GfdmConfig, rx_pre, consts):
    """Factorized channel estimate: (..., 2, 2K) preamble -> (..., 2, N).

    Matches pmatmul(rx_pre, E_W) (the dense estimator) element-wise.
    """
    K = cfg.subcarriers
    r0, r1 = rx_pre[..., :K], rx_pre[..., K:]
    e = pmul(pmatmul(r0, consts["FK_W"]), consts["inv0"]) + pmul(
        pmatmul(r1, consts["FK_W"]), consts["inv1"]
    )
    f = e @ consts["S_T"]  # real smoothing, per plane
    fA = f[..., consts["idxA"]]
    fB = f[..., consts["idxB"]]
    t = consts["t"]
    return fA * (1.0 - t) + fB * t


def snr_power_fast(cfg: GfdmConfig, rx_pre, consts):
    """|FFT_2K(preamble)|^2 via a radix-2 split: two K-point stages.

    Matches pabs2(pmatmul(rx_pre, F2_W)) without the (4K, 4K) dense DFT.
    """
    ev, od = rx_pre[..., 0::2], rx_pre[..., 1::2]
    A = pmatmul(ev, consts["FK_W"])
    Bv = pmatmul(od, consts["FK_W"])
    A2 = torch.cat([A, A], dim=-1)
    B2 = pmul(consts["tw2"], torch.cat([Bv, Bv], dim=-1))
    return pabs2(A2 + B2)


def fast_fft_n(cfg: GfdmConfig, x, consts):
    """Factorized N-point DFT of planar (..., 2, N) -> (..., 2, N).

    Matches pmatmul(x, F_W) (natural-order DFT) element-wise.
    """
    K, M = cfg.subcarriers, cfg.timeslots
    lead = x.shape[:-2]
    # n = M*n2 + n1  ->  (..., 2, K(n2), M(n1))
    xr = x.reshape(lead + (2, K, M))
    # inner K-point DFTs over n2 for each n1: arrange (..., M(n1), 2, K(n2))
    Z = pmatmul(_perm(xr, (2, 0, 1)), consts["FK_W"])  # (..., M, 2, K)
    Z = pmul(Z, consts["tw"])  # twiddle (M, 2, K) broadcast
    # outer M-point DFTs over n1: arrange (..., K(k2), 2, M(n1))
    Xr = pmatmul(_perm(Z, (2, 1, 0)), consts["FM_W"])  # (..., K(k2), 2, M(k1))
    # X index = K*k1 + k2 -> layout (..., 2, M(k1), K(k2))
    return _perm(Xr, (1, 2, 0)).reshape(lead + (2, K * M))


def fast_ifft_n(cfg: GfdmConfig, X, consts):
    """Inverse of fast_fft_n (matches numpy ifft normalization)."""
    K, M = cfg.subcarriers, cfg.timeslots
    lead = X.shape[:-2]
    # X index = K*k1 + k2 -> (..., 2, M(k1), K(k2))
    Xr = X.reshape(lead + (2, M, K))
    # undo outer stage: arrange (..., K(k2), 2, M(k1)), inverse M-DFT
    Z = pmatmul(_perm(Xr, (2, 0, 1)), consts["iFM_W"])  # (..., K, 2, M) k1 -> n1
    # undo twiddle: arrange (..., M(n1), 2, K(k2))
    Zt = pmul(_perm(Z, (2, 1, 0)), consts["itw"])
    xr = pmatmul(Zt, consts["iFK_W"])  # (..., M(n1), 2, K(n2)) over k2 -> n2
    # n = M*n2 + n1 -> (..., 2, K(n2), M(n1))
    return _perm(xr, (1, 2, 0)).reshape(lead + (2, K * M))


def _fold_rx(cfg: GfdmConfig, X, consts):
    """Sparse-filter gather/fold: spectrum (..., 2, N) -> (..., K, 2, M)."""
    K, M, L = cfg.subcarriers, cfg.timeslots, cfg.overlap
    lead = X.shape[:-2]
    # (..., K, 2, M): planes adjacent to the M axis for pmul/pmatmul
    Xb = torch.movedim(X.reshape(lead + (2, K, M)), -3, -2)
    S = None
    parts = consts["rx_parts"]  # (L, 2, M)
    for i in range(L):
        contrib = pmul(
            torch.roll(Xb, -(i - L // 2), dims=-3), parts[(i + L // 2) % L]
        )
        S = contrib if S is None else S + contrib
    return S


def _scatter_tx(cfg: GfdmConfig, W, consts):
    """Sparse-filter scatter: per-SC spectra (..., K, 2, M) -> (..., 2, N)."""
    K, M, L = cfg.subcarriers, cfg.timeslots, cfg.overlap
    lead = W.shape[:-3]
    X = None
    parts = consts["tx_parts"]
    for i in range(L):
        contrib = torch.roll(
            pmul(W, parts[(i + L // 2) % L]), i - L // 2, dims=-3
        )
        X = contrib if X is None else X + contrib
    return torch.movedim(X, -2, -3).reshape(lead + (2, K * M))


def demod_fast(cfg: GfdmConfig, frames, channel, consts, equalize=True):
    """Factorized ZF demod: (..., 2, N) frames -> (..., K, 2, M) symbols.

    Equivalent to the dense F_W / Bfd_W path of planar_pipeline.
    """
    X = fast_fft_n(cfg, frames, consts)
    if equalize:
        X = pdiv(X, channel)
    S = _fold_rx(cfg, X, consts)
    return pmatmul(S, consts["iFM_W"])  # per-SC M-point IFFT


def modulate_core_fast(cfg: GfdmConfig, grid, consts):
    """Factorized modulator: (..., 2, N) grid symbols -> (..., 2, N) samples."""
    K, M = cfg.subcarriers, cfg.timeslots
    lead = grid.shape[:-2]
    g = grid.reshape(lead + (2, K, M))
    gk = torch.movedim(g, -3, -2)  # (..., K, 2, M)
    W = pmatmul(gk, consts["FM_W"])  # per-SC M-point FFT
    X = _scatter_tx(cfg, W, consts)
    return fast_ifft_n(cfg, X, consts)
