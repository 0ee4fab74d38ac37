"""Schmidl&Cox-style GFDM preamble generation.

A preamble is a 2-timeslot GFDM block whose two halves repeat exactly: the
pn/ZC symbols are mapped to active subcarriers, duplicated on both timeslots
with ``per_timeslot`` (stream) ordering, modulated as an M=2 GFDM block, then
CP + CS extended, cyclically shifted (for cyclic-delay-diversity Tx antennas)
and edge-windowed.

Parity targets:
  - gr-gfdm/python/pygfdm/preamble.py:91-132 (mapped_preamble,
    get_sync_symbol, generate_sync_symbol)
  - the half-repetition property check: preamble.py:135-148
"""
from __future__ import annotations

import numpy as np

from .cyclic_prefix import add_cyclic_extension, pinch_block, raised_cosine_ramp, window_len
from .filters import frequency_domain_filter, normalize_taps_energy
from .mapping import map_to_resources
from .modulation import modulate_block
from .utils import random_qpsk
from .zadoff_chu import zadoff_chu_sequence

__all__ = ["core_preamble", "windowed_preamble", "mapped_preamble", "symmetric_mapped_preamble"]

PREAMBLE_TIMESLOTS = 2  # fixed: two repeating halves


def core_preamble(
    pn_symbols_on_grid: np.ndarray,
    subcarriers: int,
    overlap: int,
    alpha: float,
    filtertype: str = "rrc",
) -> np.ndarray:
    """Modulate one K-vector of FD pilot symbols as a repeated 2-slot block.

    ``pn_symbols_on_grid``: length-K vector with pilots on active bins.
    Returns the 2*K time-domain core preamble (x_preamble).
    """
    taps = frequency_domain_filter(filtertype, alpha, PREAMBLE_TIMESLOTS, subcarriers, overlap)
    taps = normalize_taps_energy(taps, PREAMBLE_TIMESLOTS)
    # same pilot on both timeslots of each subcarrier -> halves repeat
    grid = np.tile(pn_symbols_on_grid.reshape(subcarriers, 1), (1, PREAMBLE_TIMESLOTS))
    return modulate_block(grid, taps, overlap)


def windowed_preamble(
    x_preamble: np.ndarray,
    cp_len: int,
    ramp_len: int,
    cyclic_shift: int = 0,
) -> np.ndarray:
    """CP/CS + roll + raised-cosine pinching of a core preamble.

    Note the reference applies the cyclic shift by rolling the *extended*
    symbol (preamble.py:118-119), and uses cs_len == ramp_len.
    """
    sym = add_cyclic_extension(x_preamble, cp_len, ramp_len, 0)
    sym = np.roll(sym, cyclic_shift)
    win = raised_cosine_ramp(ramp_len, window_len(x_preamble.size, cp_len, ramp_len))
    return pinch_block(sym, win)


def mapped_preamble(
    seed: int | None,
    filtertype: str,
    alpha: float,
    active_subcarriers: int,
    subcarriers: int,
    smap: np.ndarray,
    overlap: int,
    cp_len: int,
    ramp_len: int,
    use_zadoff_chu: bool = False,
    cyclic_shift: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """(full windowed preamble, core x_preamble) for a given pilot source."""
    if use_zadoff_chu:
        # the reference's ZC generator ignores its u argument (effectively
        # u=1, gr-gfdm/python/pygfdm/zadoff_chu.py:21-23); u=1 keeps
        # waveform parity
        pn_vals = zadoff_chu_sequence(active_subcarriers, 1)
    else:
        pn_vals = random_qpsk(active_subcarriers, seed)
    grid = map_to_resources(pn_vals, 1, subcarriers, smap, per_timeslot=True)[:, 0]
    x_pre = core_preamble(grid, subcarriers, overlap, alpha, filtertype)
    return windowed_preamble(x_pre, cp_len, ramp_len, cyclic_shift), x_pre


def symmetric_mapped_preamble(
    seed: int | None,
    filtertype: str,
    alpha: float,
    active_subcarriers: int,
    subcarriers: int,
    smap: np.ndarray,
    overlap: int,
    cp_len: int,
    ramp_len: int,
) -> tuple[tuple[np.ndarray, np.ndarray], np.ndarray]:
    """Preamble from a conjugate-symmetric pilot vector (preamble.py:104-109)."""
    half = random_qpsk(active_subcarriers // 2, seed)
    pn_vals = np.concatenate((half, np.conj(half[::-1])))
    grid = map_to_resources(pn_vals, 1, subcarriers, smap, per_timeslot=True)[:, 0]
    x_pre = core_preamble(grid, subcarriers, overlap, alpha, filtertype)
    return (windowed_preamble(x_pre, cp_len, ramp_len, 0), x_pre), pn_vals
