"""Prototype pulse shaping filters and their sparse frequency-domain form.

GFDM uses one circular prototype filter of length M*K (M timeslots, K
subcarriers). The low-complexity modem only ever touches its frequency
response truncated to the M*L bins around DC ("sparse taps", overlap L).

Behavioral parity targets (conventions, not code):
  - time-domain RRC/RC pulse: gr-gfdm/python/pygfdm/filters.py:27-33
    (the reference delegates to commpy; here the closed forms are implemented
    directly and self-checked against the analytic sinc*tapered-cosine form,
    filters.py:57-87)
  - FD transform + truncation: filters.py:36-44
  - energy normalization to M: filters.py:47-54 and
    gr-gfdm/lib/modulator_kernel_cc.cc:71-90
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "rrc_time_taps",
    "rc_time_taps",
    "time_taps",
    "freq_taps",
    "sparse_freq_taps",
    "frequency_domain_filter",
    "normalize_taps_energy",
]


def rrc_time_taps(n_taps: int, alpha: float, sps: float) -> np.ndarray:
    """Root-raised-cosine pulse, ``n_taps`` samples, ``sps`` samples/symbol.

    Centered at n_taps/2 (matches the commpy convention used by the
    reference: h[x] evaluated at t=(x - N/2)/sps).
    """
    t = (np.arange(n_taps) - n_taps / 2.0) / float(sps)
    h = np.zeros(n_taps, dtype=np.float64)

    if alpha == 0.0:
        h = np.sinc(t)
        h[t == 0.0] = 1.0
        return h

    zero = t == 0.0
    # singular points t = +-1/(4 alpha)
    sing = np.isclose(np.abs(t), 1.0 / (4.0 * alpha))
    reg = ~(zero | sing)

    tr = t[reg]
    num = np.sin(np.pi * tr * (1.0 - alpha)) + 4.0 * alpha * tr * np.cos(
        np.pi * tr * (1.0 + alpha)
    )
    den = np.pi * tr * (1.0 - (4.0 * alpha * tr) ** 2)
    h[reg] = num / den
    h[zero] = 1.0 - alpha + 4.0 * alpha / np.pi
    h[sing] = (alpha / np.sqrt(2.0)) * (
        (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * alpha))
        + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * alpha))
    )
    return h


def rc_time_taps(n_taps: int, alpha: float, sps: float) -> np.ndarray:
    """Raised-cosine pulse, same sampling convention as :func:`rrc_time_taps`."""
    t = (np.arange(n_taps) - n_taps / 2.0) / float(sps)
    h = np.zeros(n_taps, dtype=np.float64)

    if alpha == 0.0:
        h = np.sinc(t)
        h[t == 0.0] = 1.0
        return h

    zero = t == 0.0
    sing = np.isclose(np.abs(t), 1.0 / (2.0 * alpha))
    reg = ~(zero | sing)
    tr = t[reg]
    h[reg] = np.sinc(tr) * np.cos(np.pi * alpha * tr) / (1.0 - (2.0 * alpha * tr) ** 2)
    h[zero] = 1.0
    h[sing] = (np.pi / 4.0) * np.sinc(1.0 / (2.0 * alpha))
    return h


def time_taps(filtertype: str, alpha: float, timeslots: int, subcarriers: int) -> np.ndarray:
    """Length M*K prototype pulse (one GFDM block long)."""
    n = timeslots * subcarriers
    if filtertype == "rrc":
        return rrc_time_taps(n, alpha, subcarriers)
    if filtertype == "rc":
        return rc_time_taps(n, alpha, subcarriers)
    raise ValueError(f"unknown filtertype {filtertype!r} (use 'rrc' or 'rc')")


def freq_taps(h: np.ndarray) -> np.ndarray:
    """Full frequency response with the pulse center moved to sample 0."""
    return np.fft.fft(np.roll(h, h.shape[-1] // 2))


def sparse_freq_taps(H: np.ndarray, timeslots: int, overlap: int) -> np.ndarray:
    """Keep the M*L bins around DC: [0 .. ML/2) and [-ML/2 .. 0)."""
    half = (timeslots * overlap) // 2
    return np.concatenate((H[:half], H[-half:]))


def normalize_taps_energy(taps: np.ndarray, timeslots: int) -> np.ndarray:
    """Scale taps so their total energy equals ``timeslots``.

    Same normalization every reference kernel applies on construction
    (gr-gfdm/lib/modulator_kernel_cc.cc:80-85).
    """
    energy = float(np.sum(np.abs(taps) ** 2))
    return taps / np.sqrt(energy / timeslots)


def frequency_domain_filter(
    filtertype: str, alpha: float, timeslots: int, subcarriers: int, overlap: int
) -> np.ndarray:
    """Energy-normalized sparse FD taps (length M*L), DC on bin 0."""
    h = time_taps(filtertype, alpha, timeslots, subcarriers)
    H = sparse_freq_taps(freq_taps(h), timeslots, overlap)
    return normalize_taps_energy(H, timeslots)


def analytic_rc_pulse(t: np.ndarray, alpha: float) -> np.ndarray:
    """Analytic sinc * tapered-cosine RC pulse used for self-validation."""
    d = 1.0 - 4.0 * (alpha**2) * (t**2)
    sing = np.isclose(d, 0.0)
    d = np.where(sing, 1.0, d)
    f = np.cos(np.pi * alpha * t) / d
    # removable singularity at |t| = 1/(2 alpha): limit of the cosine factor is pi/4
    f = np.where(sing, np.pi / 4.0, f)
    s = np.sinc(t)
    return s * f
