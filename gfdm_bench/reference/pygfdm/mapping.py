"""Resource mapping: data symbols <-> the (K subcarriers x M timeslots) grid.

Framework convention: a GFDM frame grid is an array ``D`` of shape ``(K, M)``
(subcarrier-major); its flat form is ``D.reshape(-1)``, i.e. ``d[k*M + m]``.
This matches the layout the reference's optimized kernels consume
(gr-gfdm/lib/modulator_kernel_cc.cc:98-134,
gr-gfdm/lib/resource_mapper_kernel_cc.cc:108-134).

Supported symbol orders when serializing user data:
  - ``per_timeslot=True``: symbol stream fills active subcarriers of timeslot 0,
    then timeslot 1, ... (resource_mapper_kernel_cc.cc:108-120)
  - ``per_timeslot=False``: stream fills all timeslots of the first active
    subcarrier, then the next, ... (resource_mapper_kernel_cc.cc:122-134)
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "subcarrier_map",
    "map_to_resources",
    "demap_from_resources",
    "data_matrix",
    "flatten_grid",
]


def subcarrier_map(subcarriers: int, active_subcarriers: int, dc_free: bool = False) -> np.ndarray:
    """Indices of active subcarriers, split around DC.

    Mirrors gr-gfdm/python/pygfdm/mapping.py:78-81.
    """
    half = active_subcarriers // 2
    if dc_free:
        return np.concatenate(
            (np.arange(1, half + 1), np.arange(subcarriers - half, subcarriers))
        )
    return np.concatenate((np.arange(0, half), np.arange(subcarriers - half, subcarriers)))


def _validated_map(smap: np.ndarray, subcarriers: int) -> np.ndarray:
    smap = np.sort(np.asarray(smap, dtype=np.int64))
    if smap.size != np.unique(smap).size:
        raise ValueError("subcarrier_map entries must be unique")
    if smap.size and (smap.min() < 0 or smap.max() >= subcarriers):
        raise ValueError("subcarrier_map entries must lie in [0, subcarriers)")
    return smap


def map_to_resources(
    symbols: np.ndarray,
    timeslots: int,
    subcarriers: int,
    smap: np.ndarray,
    per_timeslot: bool = True,
) -> np.ndarray:
    """Scatter up to ``timeslots*len(smap)`` data symbols into a (K, M) grid.

    Missing symbols are zero-padded, inactive subcarriers stay zero.
    """
    smap = _validated_map(smap, subcarriers)
    n_active = smap.size
    capacity = timeslots * n_active
    if symbols.size > capacity:
        raise ValueError(
            f"got {symbols.size} symbols but frame capacity is {capacity}"
        )
    s = np.zeros(capacity, dtype=np.complex128)
    s[: symbols.size] = symbols
    grid = np.zeros((subcarriers, timeslots), dtype=np.complex128)
    if per_timeslot:
        # stream order: (timeslot, active-subcarrier)
        grid[smap, :] = s.reshape(timeslots, n_active).T
    else:
        grid[smap, :] = s.reshape(n_active, timeslots)
    return grid


def demap_from_resources(
    grid: np.ndarray,
    timeslots: int,
    smap: np.ndarray,
    per_timeslot: bool = True,
    n_symbols: int | None = None,
) -> np.ndarray:
    """Gather data symbols back out of a (K, M) grid (adjoint of map)."""
    smap = _validated_map(smap, grid.shape[0])
    active = grid[smap, :]  # (n_active, M)
    if per_timeslot:
        out = active.T.reshape(-1)
    else:
        out = active.reshape(-1)
    if n_symbols is not None:
        out = out[:n_symbols]
    return out


def data_matrix(flat: np.ndarray, subcarriers: int) -> np.ndarray:
    """Reshape a subcarrier-major flat frame d[k*M+m] into a (K, M) grid."""
    return np.asarray(flat).reshape(subcarriers, -1)


def flatten_grid(grid: np.ndarray) -> np.ndarray:
    """(K, M) grid -> subcarrier-major flat frame."""
    return np.asarray(grid).reshape(-1)
