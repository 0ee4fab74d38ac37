"""Cyclic prefix/suffix insertion, cyclic-shift diversity, block windowing.

Parity targets:
  - ramps and pinching: gr-gfdm/python/pygfdm/cyclic_prefix.py:39-90
  - CP/CS with per-output cyclic shift (cyclic delay diversity) and
    raised-cosine edge "pinching": gr-gfdm/lib/add_cyclic_prefix_cc.cc:61-104
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "window_len",
    "window_ramp",
    "raised_cosine_ramp",
    "root_raised_cosine_ramp",
    "fourth_order_raised_cosine_ramp",
    "add_cyclic_extension",
    "add_cyclic_prefix",
    "remove_cyclic_prefix",
    "pinch_edges",
    "pinch_block",
]


def window_len(block_len: int, cp_len: int, cs_len: int = 0) -> int:
    return block_len + cp_len + cs_len


def window_ramp(ramp_len: int, total_len: int) -> np.ndarray:
    """Linear 1->0 head ramp and 0->1 tail ramp argument vector."""
    if ramp_len < 1:
        r = np.array([])
    else:
        r = np.arange(0, 1, 1.0 / ramp_len)
    return np.concatenate((1.0 - r, np.zeros(total_len - 2 * ramp_len), r))


def raised_cosine_ramp(ramp_len: int, total_len: int) -> np.ndarray:
    return 0.5 * (1.0 + np.cos(np.pi * window_ramp(ramp_len, total_len)))


def root_raised_cosine_ramp(ramp_len: int, total_len: int) -> np.ndarray:
    return np.sqrt(raised_cosine_ramp(ramp_len, total_len))


def fourth_order_raised_cosine_ramp(ramp_len: int, total_len: int) -> np.ndarray:
    x = window_ramp(ramp_len, total_len)
    p = (x**4) * (35 - 84 * x + 70 * x**2 - 20 * x**3)
    return 0.5 * (1.0 + np.cos(np.pi * p))


def add_cyclic_extension(
    block: np.ndarray, cp_len: int, cs_len: int, cyclic_shift: int = 0
) -> np.ndarray:
    """CP + CS insertion with an embedded cyclic shift.

    out = [ block[-cp-shift:], block, block[:cs-shift] ]

    which equals a cyclic shift of the block followed by plain CP/CS
    (add_cyclic_prefix_cc.cc:78-90). Requires cs_len >= cyclic_shift >= 0.
    """
    n = block.size
    head = block[n - cp_len - cyclic_shift :]
    tail = block[: cs_len - cyclic_shift]
    return np.concatenate((head, block, tail))


def pinch_edges(frame: np.ndarray, window_taps: np.ndarray, ramp_len: int) -> np.ndarray:
    """Multiply the first/last ramp_len samples with the window edges.

    ``window_taps`` may be the full window or just the 2*ramp_len edge taps
    (add_cyclic_prefix_cc.cc:42-57,92-98).
    """
    if ramp_len <= 0:
        return frame.copy()
    out = frame.astype(np.complex128).copy()
    out[:ramp_len] *= window_taps[:ramp_len]
    out[out.size - ramp_len :] *= window_taps[window_taps.size - ramp_len :]
    return out


def pinch_block(frame: np.ndarray, window_taps: np.ndarray) -> np.ndarray:
    """Full-length window multiply (pygfdm.cyclic_prefix.pinch_block)."""
    return frame * window_taps


def add_cyclic_prefix(
    block: np.ndarray,
    cp_len: int,
    cs_len: int,
    window_taps: np.ndarray | None = None,
    ramp_len: int = 0,
    cyclic_shift: int = 0,
) -> np.ndarray:
    """CP/CS insertion + optional edge window: the full prefixer kernel."""
    out = add_cyclic_extension(block, cp_len, cs_len, cyclic_shift)
    if window_taps is not None and ramp_len > 0:
        out = pinch_edges(out, window_taps, ramp_len)
    return out


def remove_cyclic_prefix(frame: np.ndarray, cp_len: int, block_len: int) -> np.ndarray:
    """Drop CP (and implicitly CS): frame[cp : cp+block]."""
    return frame[cp_len : cp_len + block_len]
