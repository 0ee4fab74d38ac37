"""Soft-output demapping: per-bit log-likelihood ratios.

The port of ``gfdm_tpu.ops.softbits`` as torch ops on the symbols' device,
with the reference's arithmetic: max-log LLRs from squared distances to the
constellation points, the minimum over each bit's half of the points taken
with the other half masked by +1e30, over ``max(noise_var, 1e-12)``. A
tensor stays on its own device; a NumPy array goes to ``device`` (default:
the card; without one it raises). Positive LLR favors bit 0.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, device_const

__all__ = ["qpsk_llrs", "qpsk_llrs_planar", "maxlog_llrs", "maxlog_llrs_planar"]

_SQRT2 = 2.0**0.5
_BIG = 1e30


def _noise_scale(noise_var: torch.Tensor, like: torch.Tensor, num: float):
    """num / max(noise_var, 1e-12) as a float32 division on ``like``'s device."""
    nv = noise_var.to(device=like.device, dtype=torch.float32).clamp_min(1e-12)
    return torch.full_like(nv, num) / nv


def qpsk_llrs(symbols, noise_var, device=None):
    """(..., n) complex symbols -> (..., n, 2) LLRs (I-bit, Q-bit).

    Convention: bit 0 maps to +1/sqrt2, bit 1 to -1/sqrt2 per component.
    Positive LLR favors bit 0.
    """
    s = as_tensor(symbols, device, "qpsk_llrs")
    k = _noise_scale(as_tensor(noise_var, s.device, "qpsk_llrs"), s, 2.0 * _SQRT2)
    k = k[..., None]
    return torch.stack([s.real * k, s.imag * k], dim=-1)


def qpsk_llrs_planar(symbols_pl, noise_var, device=None):
    """(..., 2, n) planar symbols -> (..., n, 2) LLRs."""
    s = as_tensor(symbols_pl, device, "qpsk_llrs_planar")
    k = _noise_scale(as_tensor(noise_var, s.device, "qpsk_llrs_planar"), s,
                     2.0 * _SQRT2)[..., None]
    return torch.stack([s[..., 0, :] * k, s[..., 1, :] * k], dim=-1)


def _tables(points, device: torch.device) -> dict:
    """The constellation's points (complex64 and planar float32) and the
    1e30 penalties of the max-log minimum, from the (order, P) masks: 1
    where point index i has bit b set, MSB first."""
    pts = np.asarray(points).astype(np.complex64)

    def build():
        order = int(np.log2(pts.size))
        shifts = np.arange(order - 1, -1, -1)
        masks = ((np.arange(pts.size)[None, :] >> shifts[:, None]) & 1).astype(np.float32)
        return {"points": pts, "pr": pts.real.astype(np.float32),
                "pi": pts.imag.astype(np.float32),
                "pen1": (1.0 - masks) * np.float32(_BIG), "pen0": masks * np.float32(_BIG)}

    return device_const(("maxlog", tuple(pts.tolist())), device, build)


def _maxlog(d: torch.Tensor, tab: dict, noise_var: torch.Tensor) -> torch.Tensor:
    """(..., n, P) squared distances -> (..., n, order) max-log LLRs."""
    dm = d[..., None, :]
    d1 = torch.amin(dm + tab["pen1"], dim=-1)
    d0 = torch.amin(dm + tab["pen0"], dim=-1)
    nv = noise_var.to(device=d.device, dtype=torch.float32).clamp_min(1e-12)
    return (d1 - d0) / nv[..., None]


def maxlog_llrs(symbols, points, noise_var, device=None):
    """Generic max-log LLRs for any labeled constellation.

    ``points``: (2**order,) complex, index = MSB-first bit label (the
    ref.symbolmapping convention). (..., n) complex64 symbols ->
    (..., n, order) LLRs; positive favors bit 0. For Gray QPSK this reduces
    to :func:`qpsk_llrs`.
    """
    s = as_tensor(symbols, device, "maxlog_llrs")
    tab = _tables(points, s.device)
    d = torch.abs(s[..., None] - tab["points"]) ** 2
    return _maxlog(d, tab, as_tensor(noise_var, s.device, "maxlog_llrs"))


def maxlog_llrs_planar(symbols_pl, points, noise_var, device=None):
    """:func:`maxlog_llrs` on (..., 2, n) planar symbols (no complex dtype:
    the form the streaming service's FEC path uses). Returns
    (..., n, order); positive favors bit 0."""
    s = as_tensor(symbols_pl, device, "maxlog_llrs_planar")
    tab = _tables(points, s.device)
    dr = s[..., 0, :, None] - tab["pr"]
    di = s[..., 1, :, None] - tab["pi"]
    d = dr * dr + di * di
    return _maxlog(d, tab, as_tensor(noise_var, s.device, "maxlog_llrs_planar"))
