"""Batched receiver ops on complex tensors (the port of ``gfdm_tpu.ops.rx``).

Matched-filter and ZF-equalized demodulation as dense matmuls, plus the
decision-directed interference-cancellation loop (a Python loop over the
iterations, the JAX package's ``fori_loop``) with a vectorized
nearest-point constellation decision; and the named-constellation lookup
the streaming service takes.

Reference call stacks being replaced:
  - simple_receiver_cc_impl::work -> receiver_kernel_cc::generic_work
    (gr-gfdm/lib/receiver_kernel_cc.cc:301-334)
  - advanced_receiver_kernel_cc::generic_work[_equalize] + perform_ic_iterations
    (gr-gfdm/lib/advanced_receiver_kernel_cc.cc:56-107)
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import device_const
from ..ref.demodulation import ic_filter_taps as _ic_taps_ref
from . import operators
from ._complex import DEFAULT_DTYPE, as_complex, const, mm, np_dtype
from ._validate import check_last_dim
from .planar_pipeline import qpsk_constellation
from .tx import demap_indices

__all__ = [
    "remove_cyclic_prefix",
    "demodulate",
    "demodulate_equalized",
    "fd_filter_downsample",
    "subcarriers_to_time",
    "cancel_interference",
    "ic_receiver",
    "demap_resources",
    "qpsk_constellation",
    "constellation_points",
]


def constellation_points(name: str) -> np.ndarray:
    """Named constellation -> complex points ('qpsk' | 'qam16' | 'qam64').

    The points come from the golden model (ref.symbolmapping) so decisions
    agree across the planar path, the kernels and the NumPy model.
    """
    if name == "qpsk":
        return qpsk_constellation
    if name in ("qam16", "qam64"):
        from ..ref.symbolmapping import constellation

        return constellation({"qam16": 4, "qam64": 6}[name])
    raise ValueError(
        f"unknown constellation {name!r} (use 'qpsk', 'qam16' or 'qam64')"
    )


def remove_cyclic_prefix(cfg: GfdmConfig, framed):
    """(..., window_len) -> (..., M*K): drop CP and CS."""
    return framed[..., cfg.cp_len : cfg.cp_len + cfg.block_len]


def demodulate(cfg: GfdmConfig, frames, dtype=DEFAULT_DTYPE, device=None):
    """MF demodulation: (..., M*K) samples -> (..., M*K) symbol estimates."""
    frames = as_complex(frames, dtype, device, "demodulate")
    check_last_dim(frames, cfg.block_len, "demodulate", "timeslots*subcarriers")
    B_T = const("rx.B_T", cfg, dtype, frames.device,
                lambda: operators.demodulation_operator(cfg).T)
    return mm(frames, B_T)


def _F_T(cfg, dtype, device):
    return const("rx.F_T", cfg, dtype, device, lambda: operators.dft_matrix(cfg.block_len).T)


def _Bfd_T(cfg, dtype, device):
    return const("rx.Bfd_T", cfg, dtype, device,
                 lambda: operators.demodulation_fd_operator(cfg).T)


def _Fm_T(cfg, dtype, device):
    return const("rx.Fm_T", cfg, dtype, device, lambda: operators.dft_matrix(cfg.timeslots).T)


def _iFm_T(cfg, dtype, device):
    return const("rx.iFm_T", cfg, dtype, device,
                 lambda: operators.idft_matrix(cfg.timeslots).T)


def _ic_taps(cfg, dtype, device):
    return const("rx.ic_taps", cfg, dtype, device, lambda: _ic_taps_ref(
        cfg.rx_filter_taps, cfg.timeslots, cfg.overlap))


def demodulate_equalized(cfg: GfdmConfig, frames, channel_fd, dtype=DEFAULT_DTYPE,
                         device=None):
    """ZF demodulation: block FFT, divide by channel estimate, MF demod.

    ``channel_fd``: (..., M*K) full-frame FD channel estimate
    (matches receiver_kernel_cc::fft_equalize_filter_downsample).
    """
    frames = as_complex(frames, dtype, device, "demodulate_equalized")
    channel_fd = as_complex(channel_fd, dtype, frames.device, "demodulate_equalized")
    X = mm(frames, _F_T(cfg, dtype, frames.device)) / channel_fd
    return mm(X, _Bfd_T(cfg, dtype, frames.device))


def fd_filter_downsample(cfg: GfdmConfig, frames, channel_fd=None, dtype=DEFAULT_DTYPE,
                         device=None):
    """(..., M*K) frame -> (..., K, M) folded FD symbols (optional ZF).

    The step-wise receiver API mirrors the reference's pybind Demodulator
    surface (fft_filter_downsample / transform_subcarriers_to_td /
    cancel_sc_interference, python/bindings/demodulator_python.cc:31-206).
    """
    K, M, L = cfg.subcarriers, cfg.timeslots, cfg.overlap
    frames = as_complex(frames, dtype, device, "fd_filter_downsample")
    dev = frames.device
    X = mm(frames, _F_T(cfg, dtype, dev))
    if channel_fd is not None:
        X = X / as_complex(channel_fd, dtype, dev, "fd_filter_downsample")
    parts = const("rx.parts", cfg, dtype, dev, lambda: cfg.rx_filter_taps.reshape(L, M))
    Xb = X.reshape(X.shape[:-1] + (K, M))
    S = torch.zeros_like(Xb)
    for i in range(L):
        S = S + torch.roll(Xb, -(i - L // 2), dims=-2) * parts[(i + L // 2) % L]
    return S


def subcarriers_to_time(cfg: GfdmConfig, folded, dtype=DEFAULT_DTYPE, device=None):
    """(..., K, M) folded FD symbols -> (..., M*K) time-domain symbols."""
    S = as_complex(folded, dtype, device, "subcarriers_to_time")
    out = mm(S, _iFm_T(cfg, dtype, S.device))
    return out.reshape(S.shape[:-2] + (cfg.subcarriers * cfg.timeslots,))


def cancel_interference(cfg: GfdmConfig, detected, folded, dtype=DEFAULT_DTYPE,
                        device=None):
    """One IC pass: subtract FFT(neighbor sum) x ic_taps from folded FD."""
    detected = as_complex(detected, dtype, device, "cancel_interference")
    folded = as_complex(folded, dtype, detected.device, "cancel_interference")
    dev = detected.device
    grid = detected.reshape(detected.shape[:-1] + (cfg.subcarriers, cfg.timeslots))
    neighbors = torch.roll(grid, 1, dims=-2) + torch.roll(grid, -1, dims=-2)
    return folded - mm(neighbors, _Fm_T(cfg, dtype, dev)) * _ic_taps(cfg, dtype, dev)


def _decide(d: torch.Tensor, points: torch.Tensor, active: torch.Tensor, K: int, M: int):
    """Nearest constellation point on active subcarriers, 0 elsewhere: (...,
    K*M) estimates -> (..., K, M) decisions. ``argmin`` takes the first of
    tied distances, as ``jnp.argmin`` does."""
    grid = d.reshape(d.shape[:-1] + (K, M))
    dist = (grid[..., None] - points).abs() ** 2
    hard = points[torch.argmin(dist, dim=-1)]
    return torch.where(active[:, None], hard, torch.zeros((), dtype=hard.dtype,
                                                            device=hard.device))


def ic_receiver(
    cfg: GfdmConfig,
    frames,
    channel_fd=None,
    ic_iterations: int = 2,
    constellation=qpsk_constellation,
    phase_compensation: bool = False,
    dtype=DEFAULT_DTYPE,
    device=None,
):
    """Advanced receiver: (optional ZF) demod + decision-directed IC loop.

    Mirrors advanced_receiver_kernel_cc (decisions only on active
    subcarriers, neighbor-pair cancellation with ic taps, optional one-shot
    common-phase-offset compensation before the first iteration).
    """
    K, M = cfg.subcarriers, cfg.timeslots
    frames = as_complex(frames, dtype, device, "ic_receiver")
    dev = frames.device
    points_np = np.asarray(constellation)
    points = device_const(("rx.points", points_np.tobytes(), str(dtype)), dev,
                          lambda: points_np.astype(np_dtype(dtype)))
    active = device_const(("rx.active", cfg), dev, lambda: np.isin(
        np.arange(K), cfg.subcarrier_map))
    Fm_T, iFm_T = _Fm_T(cfg, dtype, dev), _iFm_T(cfg, dtype, dev)
    ic_taps = _ic_taps(cfg, dtype, dev)

    X = mm(frames, _F_T(cfg, dtype, dev))
    if channel_fd is not None:
        X = X / as_complex(channel_fd, dtype, dev, "ic_receiver")
    # symbol-domain estimates, then their per-subcarrier FFT: the folded-FD
    # state the cancellation works on
    S = mm(X, _Bfd_T(cfg, dtype, dev)).reshape(frames.shape[:-1] + (K, M))
    folded_fd = mm(S, Fm_T)
    d = S.reshape(frames.shape)

    if phase_compensation and ic_iterations > 0:
        # iteration 0 with common-phase-offset correction of the FD state
        grid = d.reshape(frames.shape[:-1] + (K, M))
        hard = _decide(d, points, active, K, M)
        mask = active[:, None] & (hard.abs() > 0)
        diff = torch.where(mask, torch.angle(hard) - torch.angle(grid),
                           torch.zeros((), dtype=grid.real.dtype, device=dev))
        phase = diff.sum(dim=(-2, -1)) / (cfg.subcarrier_map.size * M)
        rot = torch.exp(1j * phase)[..., None, None].to(folded_fd.dtype)
        folded_fd = folded_fd * rot

    for _ in range(int(ic_iterations)):
        hard = _decide(d, points, active, K, M)
        neighbors = torch.roll(hard, 1, dims=-2) + torch.roll(hard, -1, dims=-2)
        cleaned = folded_fd - mm(neighbors, Fm_T) * ic_taps
        d = mm(cleaned, iFm_T).reshape(d.shape)
    return d


def demap_resources(cfg: GfdmConfig, symbols):
    """(..., M*K) symbol frame -> (..., n_data) payload symbols."""
    idx = device_const(("rx.demap_idx", cfg), symbols.device,
                       lambda: demap_indices(cfg).astype(np.int64))
    return symbols.index_select(-1, idx)
