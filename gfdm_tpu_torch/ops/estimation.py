"""Batched channel and SNR estimation on complex tensors (the port of
``gfdm_tpu.ops.estimation``).

The whole preamble channel estimator (per-half FFT x inverse reference,
Gaussian smoothing, linear frame interpolation) is linear in the received
preamble and is applied as one (M*K, 2K) matmul built in
:mod:`.operators`. SNR estimation is the quadratic even/odd-bin energy split
of gr-gfdm/lib/preamble_channel_estimator_cc.cc:187-235.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import device_const
from . import operators
from ._complex import DEFAULT_DTYPE, as_complex, const, mm
from ._validate import check_last_dim

__all__ = ["estimate_frame", "estimate_snr", "prepare_for_zf", "mmse_channel"]


def estimate_frame(cfg: GfdmConfig, rx_preamble, dtype=DEFAULT_DTYPE, device=None):
    """(..., 2K) received core preamble -> (..., M*K) FD channel estimate."""
    rx_preamble = as_complex(rx_preamble, dtype, device, "estimate_frame")
    check_last_dim(rx_preamble, 2 * cfg.subcarriers, "estimate_frame",
                   "2*subcarriers (core preamble)")
    E_T = const("est.E_T", cfg, dtype, rx_preamble.device,
                lambda: operators.channel_estimation_operator(cfg).T)
    return mm(rx_preamble, E_T)


def prepare_for_zf(frame_estimate: torch.Tensor) -> torch.Tensor:
    """conj(1/H): divide-free ZF form (preamble_channel_estimator_cc.cc:276-282)."""
    return torch.conj(1.0 / frame_estimate).resolve_conj()


def _snr_idx(cfg: GfdmConfig) -> dict:
    K = cfg.subcarriers
    half = cfg.active_subcarriers // 2
    offset = 1 if cfg.dc_free else 0
    hi = 2 * (np.arange(half) + offset)
    unused_half = (K - cfg.active_subcarriers) // 2
    lo = 2 * (np.arange(half) + unused_half + K // 2)
    return {"sig": np.concatenate((hi, lo)), "noise": np.concatenate((hi + 1, lo + 1))}


def estimate_snr(cfg: GfdmConfig, rx_preamble, dtype=DEFAULT_DTYPE, device=None):
    """(..., 2K) preamble -> ((...,) linear SNR, (..., active) CNRs)."""
    rx_preamble = as_complex(rx_preamble, dtype, device, "estimate_snr")
    dev = rx_preamble.device
    F2_T = const("est.F2_T", cfg, dtype, dev,
                 lambda: operators.dft_matrix(2 * cfg.subcarriers).T)
    idx = device_const(("est.snr_idx", cfg), dev, lambda: _snr_idx(cfg))
    p = mm(rx_preamble, F2_T).abs() ** 2
    cnrs = p.index_select(-1, idx["sig"])
    sym = cnrs.sum(dim=-1)
    noise = p.index_select(-1, idx["noise"]).sum(dim=-1)
    snr_lin = (sym - noise) / noise
    scale = snr_lin / (sym / cnrs.shape[-1])
    return snr_lin, cnrs * scale[..., None]


def _real(x, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor, an array or a number."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def mmse_channel(cfg: GfdmConfig, channel_fd, snr_lin=None, cnrs=None,
                 dtype=DEFAULT_DTYPE, device=None):
    """Effective channel for MMSE equalization via the ZF divide path.

    Dividing the block FFT by the returned channel (exactly like
    receiver_kernel_cc.cc:315-316 does with the plain estimate) realizes the
    MMSE-shrunk inversion. With ``cnrs`` (from :func:`estimate_snr`) the
    shrinkage is per-bin (frequency-selective); with only ``snr_lin`` it is
    the scalar-SNR MMSE.
    """
    if cnrs is None and snr_lin is None:
        raise ValueError("mmse_channel needs snr_lin or cnrs")
    channel_fd = as_complex(channel_fd, dtype, device, "mmse_channel")
    dev = channel_fd.device
    if cnrs is not None:
        cnrs = _real(cnrs, dev)
        CNRI_T = device_const(("est.CNRI_T", cfg), dev, lambda: np.ascontiguousarray(
            operators.cnr_interpolation_operator(cfg).T.astype(np.float32)))
        cnr_bins = torch.clamp_min(mm(torch.clamp_min(cnrs, 0.0), CNRI_T), 1e-6)
        w = cnr_bins / (cnr_bins + 1.0)
    else:
        snr_lin = _real(snr_lin, dev)
        h2 = channel_fd.abs() ** 2
        w = h2 / (h2 + (1.0 / torch.clamp_min(snr_lin, 1e-6))[..., None])
    return channel_fd / w.to(torch.float32)
