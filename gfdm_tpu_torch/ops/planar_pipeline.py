"""Complex-free (planar) GFDM link as plain torch ops.

The twin of ``gfdm_tpu.ops.planar_pipeline`` (the JAX package's XLA path):
the same math on real float32 tensors in the planar layout of
:mod:`gfdm_tpu_torch.ops.planar`. Every complex matmul is one real matmul
against a realified operator; divides, decisions and angles are explicit
real arithmetic. The hand-written CUDA kernels (:mod:`gfdm_tpu_torch.kernels`)
are held against this module's results in the tests.

Operators are built once per (config, dtype) in NumPy float64 from the
golden model and uploaded once per device (:func:`prepare`). The kernels'
Gauss stacks (:func:`_np_gauss_stacks`) are built here too but uploaded
only by the kernels' own cache.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..ref.demodulation import ic_filter_taps as _ic_taps_ref
from . import operators
from .planar import gauss_stack, pabs2, pdiv, pmatmul, real_operator, to_planar

__all__ = [
    "prepare",
    "transmit_planar",
    "receive_bursts_planar",
    "link_step_planar",
    "qpsk_constellation",
]

qpsk_constellation = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0)


# ---------------------------------------------------------------------------
# operator matrices: NumPy once per config, tensors once per device
# ---------------------------------------------------------------------------
@lru_cache(maxsize=16)
def _np_mats(cfg: GfdmConfig, dtype_name: str):
    dt = np.dtype(dtype_name)
    K = cfg.subcarriers
    return {
        # full per-shift Tx operators with CP gather + window folded in:
        # one matmul emits the windowed framed burst directly
        "TF_W": np.stack(
            [
                real_operator(operators.tx_frame_operator(cfg, s).T, dt)
                for s in cfg.cyclic_shifts
            ]
        ),
        "E_W": real_operator(operators.channel_estimation_operator(cfg).T, dt),
        # real (n_active, N) CNR->per-bin interpolation for per-bin MMSE
        "CNRI_T": np.ascontiguousarray(
            operators.cnr_interpolation_operator(cfg).T.astype(dt)
        ),
        "F_W": real_operator(operators.dft_matrix(cfg.block_len).T, dt),
        "Bfd_W": real_operator(operators.demodulation_fd_operator(cfg).T, dt),
        "F2_W": real_operator(operators.dft_matrix(2 * K).T, dt),
        # interference operator: time-domain form of fft -> x ic_taps -> ifft
        "C_W": real_operator(operators._interference_matrix(cfg).T, dt),
    }


@lru_cache(maxsize=16)
def _np_gauss_stacks(cfg: GfdmConfig, dtype_name: str):
    """Gauss 3-matmul stacks for the fused kernels (kernels/fused.py)."""
    dt = np.dtype(dtype_name)
    K = cfg.subcarriers
    return {
        "T_G": gauss_stack(operators.tx_core_operator(cfg).T, dt),
        "E_G": gauss_stack(operators.channel_estimation_operator(cfg).T, dt),
        "F_G": gauss_stack(operators.dft_matrix(cfg.block_len).T, dt),
        "Bfd_G": gauss_stack(operators.demodulation_fd_operator(cfg).T, dt),
        "F2_G": gauss_stack(operators.dft_matrix(2 * K).T, dt),
    }


@lru_cache(maxsize=16)
def _small_consts(cfg: GfdmConfig, dtype_name: str):
    dt = np.dtype(dtype_name)
    K = cfg.subcarriers
    c = {
        "cp_idx": np.stack([operators.cp_indices(cfg, s) for s in cfg.cyclic_shifts]),
        "win": operators.cp_window(cfg).astype(dt),
        "preambles": to_planar(cfg.full_preambles, dtype=dt),
        "ic_taps": to_planar(_ic_taps_ref(cfg.rx_filter_taps, cfg.timeslots, cfg.overlap), dt),
        "demap_idx": operators.demap_indices(cfg),
    }
    active = np.zeros(K, dtype=bool)
    active[cfg.subcarrier_map] = True
    c["active"] = active
    half = cfg.active_subcarriers // 2
    offset = 1 if cfg.dc_free else 0
    hi = 2 * (np.arange(half) + offset)
    unused_half = (K - cfg.active_subcarriers) // 2
    lo = 2 * (np.arange(half) + unused_half + K // 2)
    c["sig_idx"] = np.concatenate((hi, lo))
    c["noise_idx"] = np.concatenate((hi + 1, lo + 1))
    return c


_DEVICE_MATS_CACHE: dict = {}


def _device_mats(cfg: GfdmConfig, dtype_name: str = "float32", device="cpu"):
    """The planar path's operators and small constants as tensors on
    ``device``, built once per (config, dtype, device). Index arrays become
    int32 tensors."""
    device = torch.device(device)
    key = (cfg, dtype_name, str(device))
    hit = _DEVICE_MATS_CACHE.get(key)
    if hit is not None:
        return hit
    arrays = {**_np_mats(cfg, dtype_name), **_small_consts(cfg, dtype_name)}
    mats = {name: _to_tensor(a, device) for name, a in arrays.items()}
    _DEVICE_MATS_CACHE[key] = mats
    return mats


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """NumPy constant -> tensor on ``device``; integer arrays become int32."""
    a = np.ascontiguousarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def prepare(cfg: GfdmConfig, dtype_name: str = "float32", device="cpu") -> None:
    """Eagerly build and upload all operators for ``device``."""
    _device_mats(cfg, dtype_name, device)


def _mats_for(cfg: GfdmConfig, x: torch.Tensor) -> dict:
    """The operator cache for the dtype and device of ``x``."""
    return _device_mats(cfg, str(x.dtype).removeprefix("torch."), x.device)


def _check_planar(x: torch.Tensor, n: int, fn: str, what: str) -> None:
    if x.ndim < 2 or x.shape[-2] != 2 or x.shape[-1] != n:
        raise ValueError(
            f"{fn}: expected a planar (..., 2, {n}) tensor ({what}), "
            f"got shape {tuple(x.shape)}"
        )


# ---------------------------------------------------------------------------
# Tx
# ---------------------------------------------------------------------------
def transmit_planar(cfg: GfdmConfig, data: torch.Tensor) -> torch.Tensor:
    """(..., 2, n_data) planar payload -> (..., n_shifts, 2, frame_len).

    Computes in the payload's dtype on the payload's device.
    """
    _check_planar(data, cfg.n_data_symbols, "transmit_planar",
                  "timeslots*active_subcarriers")
    mats = _mats_for(cfg, data)
    TF_W = mats["TF_W"]  # (n_shifts, 2*n_data, 2*window_len)
    flat = data.reshape(data.shape[:-2] + (2 * data.shape[-1],))
    framed = torch.einsum("...i,sij->...sj", flat, TF_W)
    framed = framed.reshape(framed.shape[:-1] + (2, cfg.window_len))
    pre = mats["preambles"].expand(framed.shape[:-2] + mats["preambles"].shape[-2:])
    return torch.cat([pre, framed], dim=-1)


# ---------------------------------------------------------------------------
# Rx (channel estimation + SNR + equalizer + IC + demap)
# ---------------------------------------------------------------------------
def _is_qpsk(points: np.ndarray) -> bool:
    if points.size != 4:
        return False
    a = np.abs(points[0].real)
    return bool(
        np.allclose(np.abs(points.real), a) and np.allclose(np.abs(points.imag), a)
        and len({(np.sign(p.real), np.sign(p.imag)) for p in points}) == 4
    )


def _decide_kc(d, points_pl, active_mask, qpsk_amp=None):
    """Nearest-point decision in (..., K, 2, M) layout, zero off active SCs.

    When ``qpsk_amp`` is set (QPSK-shaped constellation) the decision is two
    sign selects instead of a distance tensor over all points.
    """
    r, i = d[..., 0, :], d[..., 1, :]
    if qpsk_amp is not None:
        a = float(qpsk_amp)
        hr = torch.where(r >= 0, a, -a).to(d.dtype)
        hi_ = torch.where(i >= 0, a, -a).to(d.dtype)
    else:
        pr = points_pl[:, 0].reshape((-1,) + (1,) * r.ndim)
        pi = points_pl[:, 1].reshape((-1,) + (1,) * r.ndim)
        dist = (r[None] - pr) ** 2 + (i[None] - pi) ** 2
        idx = torch.argmin(dist, dim=0)
        hr = points_pl[:, 0][idx]
        hi_ = points_pl[:, 1][idx]
    m = active_mask[..., 0, :]
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.stack([torch.where(m, hr, zero), torch.where(m, hi_, zero)], dim=-2)


def receive_bursts_planar(
    cfg: GfdmConfig,
    bursts: torch.Tensor,
    ic_iterations: int = 2,
    equalize: bool = True,
    constellation=qpsk_constellation,
    phase_compensation: bool = False,
    equalizer: str = "zf",
):
    """Planar receiver chain: (..., 2, >=frame_len) -> dict of planar outputs.

    bursts are aligned at the full-preamble start; the chain computes in
    their dtype on their device. equalizer="mmse"
    regularizes the per-bin inversion with the estimated SNR;
    equalizer="mmse_cnr" uses the per-subcarrier CNR vector interpolated to
    every FD bin. Returns data, symbols, channel, snr_lin and cnrs.
    """
    if equalizer not in ("zf", "mmse", "mmse_cnr"):
        raise ValueError(f"unknown equalizer {equalizer!r}")
    mats = _mats_for(cfg, bursts)
    K, M = cfg.subcarriers, cfg.timeslots
    points = np.asarray(constellation)
    points_pl = torch.from_numpy(
        np.ascontiguousarray(to_planar(points).T)
    ).to(bursts.device, bursts.dtype)  # (P, 2)
    qpsk_amp = float(np.abs(points[0].real)) if _is_qpsk(points) else None
    n_active = cfg.subcarrier_map.size

    rx_pre = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K]
    channel = pmatmul(rx_pre, mats["E_W"])  # (..., 2, N)
    # SNR from the 2K preamble FFT
    p = pabs2(pmatmul(rx_pre, mats["F2_W"]))
    cnrs = p[..., mats["sig_idx"]]
    sym = torch.sum(cnrs, dim=-1)
    noise = torch.sum(p[..., mats["noise_idx"]], dim=-1)
    snr_lin = (sym - noise) / noise
    cnrs = cnrs * (snr_lin / (sym / cnrs.shape[-1]))[..., None]

    start = cfg.preamble_len + cfg.cp_len
    frame = bursts[..., start : start + cfg.block_len]
    if equalize and equalizer == "mmse":
        # divide by H then shrink by |H|^2/(|H|^2+1/snr)
        h2 = pabs2(channel)
        w = h2 / (h2 + (1.0 / torch.clamp(snr_lin, min=1e-6))[..., None])
        channel_eff = channel / w[..., None, :]
    elif equalize and equalizer == "mmse_cnr":
        cnr_bins = torch.clamp(cnrs, min=0.0) @ mats["CNRI_T"]
        cnr_bins = torch.clamp(cnr_bins, min=1e-6)
        w = cnr_bins / (cnr_bins + 1.0)
        channel_eff = channel / w[..., None, :]
    else:
        channel_eff = channel

    X = pmatmul(frame, mats["F_W"])
    if equalize:
        X = pdiv(X, channel_eff)
    S = pmatmul(X, mats["Bfd_W"])  # (..., 2, N) symbol estimates
    # IC in (..., K, 2, M) layout: d_{k+1} = d0 - neighbors_k @ C with
    # C = idft_M . diag(ic_taps) . dft_M, one small planar matmul
    d0 = S.reshape(S.shape[:-1] + (K, M)).movedim(-3, -2)
    active_mask = mats["active"][:, None, None]  # over K

    def cancel(d0_ref, hard):
        neighbors = torch.roll(hard, 1, dims=-3) + torch.roll(hard, -1, dims=-3)
        return d0_ref - pmatmul(neighbors, mats["C_W"])

    remaining = ic_iterations
    if phase_compensation and ic_iterations > 0:
        # iteration-0 decisions come from the UNROTATED estimates; the phase
        # fix applies to the receiver state before the first cancellation
        hard0 = _decide_kc(d0, points_pl, active_mask, qpsk_amp)
        nz = (hard0[..., 0, :] ** 2 + hard0[..., 1, :] ** 2) > 0
        ang_h = torch.atan2(hard0[..., 1, :], hard0[..., 0, :])
        ang_d = torch.atan2(d0[..., 1, :], d0[..., 0, :])
        diff = torch.where(active_mask[..., 0, :] & nz, ang_h - ang_d,
                           torch.zeros((), dtype=d0.dtype, device=d0.device))
        phase = torch.sum(diff, dim=(-2, -1)) / (n_active * M)
        cr = torch.cos(phase)[..., None, None]
        ci = torch.sin(phase)[..., None, None]
        r0, i0 = d0[..., 0, :], d0[..., 1, :]
        d0 = torch.stack([r0 * cr - i0 * ci, r0 * ci + i0 * cr], dim=-2)
        d = cancel(d0, hard0)
        remaining = ic_iterations - 1
    else:
        d = d0
    for _ in range(remaining):
        d = cancel(d0, _decide_kc(d, points_pl, active_mask, qpsk_amp))

    symbols = d.movedim(-2, -3).reshape(bursts.shape[:-2] + (2, cfg.block_len))
    data = symbols[..., mats["demap_idx"]]
    return {
        "data": data,
        "symbols": symbols,
        "channel": channel,
        "snr_lin": snr_lin,
        "cnrs": cnrs,
    }


# ---------------------------------------------------------------------------
# Full link step
# ---------------------------------------------------------------------------
def evm(data_hat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Error-vector magnitude of the whole batch (scalar tensor)."""
    err = torch.sum((data_hat - data) ** 2)
    ref = torch.clamp(torch.sum(data**2), min=1e-30)
    return torch.sqrt(err / ref)


def link_step_planar(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int = 2):
    """Planar end-to-end: payload -> Tx -> Rx -> (data_hat, snr, evm)."""
    bursts = transmit_planar(cfg, data)[..., 0, :, :]
    out = receive_bursts_planar(cfg, bursts, ic_iterations=ic_iterations)
    return out["data"], out["snr_lin"], evm(out["data"], data)
