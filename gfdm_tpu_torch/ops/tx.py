"""Batched transmitter ops on complex tensors (the port of ``gfdm_tpu.ops.tx``).

The unit of work is a batch of bursts: shape (..., n_data_symbols) in,
(..., n_shifts, frame_len) out. Everything is one dense complex matmul plus
gathers and elementwise work; the operators are built once per (config,
dtype, device) from the NumPy builders of :mod:`.operators`.

Reference call stack being replaced: transmitter_cc_impl::general_work ->
transmitter_kernel::modulate/add_frame
(gr-gfdm/lib/transmitter_cc_impl.cc:130-195,
gr-gfdm/lib/transmitter_kernel.cc:78-107).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import device_const
from . import operators
from ._complex import DEFAULT_DTYPE, as_complex, const, mm
from ._validate import check_last_dim
from .operators import demap_indices

__all__ = [
    "modulate",
    "map_resources",
    "demap_indices",
    "add_cyclic_prefix",
    "transmit",
    "transmit_core",
]


def modulate(cfg: GfdmConfig, grid_flat, dtype=DEFAULT_DTYPE, device=None):
    """(..., M*K) subcarrier-major grid symbols -> (..., M*K) time samples."""
    grid_flat = as_complex(grid_flat, dtype, device, "modulate")
    check_last_dim(grid_flat, cfg.block_len, "modulate", "timeslots*subcarriers")
    A_T = const("tx.A_T", cfg, dtype, grid_flat.device,
                lambda: operators.modulation_operator(cfg).T)
    return mm(grid_flat, A_T)


def _map_idx(cfg: GfdmConfig) -> np.ndarray:
    """Gather index of the resource map: frame position -> data index, the
    out-of-range index n_data (a zero slot) where no data symbol sits."""
    idx = np.full(cfg.block_len, cfg.n_data_symbols, dtype=np.int64)
    rows, cols = np.nonzero(operators.mapping_matrix(cfg).real)
    idx[rows] = cols
    return idx


def map_resources(cfg: GfdmConfig, data, dtype=DEFAULT_DTYPE, device=None):
    """(..., n_data) -> (..., M*K) flat subcarrier-major resource grid."""
    data = as_complex(data, dtype, device, "map_resources")
    check_last_dim(data, cfg.n_data_symbols, "map_resources",
                   "timeslots*active_subcarriers")
    idx = device_const(("tx.map_idx", cfg), data.device, lambda: _map_idx(cfg))
    padded = torch.cat([data, data.new_zeros(data.shape[:-1] + (1,))], dim=-1)
    return padded.index_select(-1, idx)


def add_cyclic_prefix(cfg: GfdmConfig, core, cyclic_shift: int = 0,
                      dtype=DEFAULT_DTYPE, device=None):
    """(..., M*K) -> (..., window_len): CP/CS + cyclic shift + RC window."""
    core = as_complex(core, dtype, device, "add_cyclic_prefix")
    idx = device_const(("tx.cp_idx", cfg, int(cyclic_shift)), core.device,
                       lambda: operators.cp_indices(cfg, cyclic_shift).astype(np.int64))
    win = const("tx.cp_window", cfg, dtype, core.device, lambda: operators.cp_window(cfg))
    return core.index_select(-1, idx) * win


def _frame_consts(cfg: GfdmConfig, dtype, device) -> tuple:
    T_T = const("tx.T_T", cfg, dtype, device, lambda: operators.tx_core_operator(cfg).T)
    cp_idx = device_const(("tx.cp_idx_all", cfg), device, lambda: np.stack(
        [operators.cp_indices(cfg, s) for s in cfg.cyclic_shifts]).astype(np.int64))
    win = const("tx.cp_window", cfg, dtype, device, lambda: operators.cp_window(cfg))
    pre = const("tx.preambles", cfg, dtype, device, lambda: cfg.full_preambles)
    return T_T, cp_idx, win, pre


def transmit_core(cfg: GfdmConfig, data, dtype=DEFAULT_DTYPE, device=None):
    """(..., n_data) -> (..., M*K): map + modulate (no CP, no preamble)."""
    data = as_complex(data, dtype, device, "transmit_core")
    return mm(data, _frame_consts(cfg, dtype, data.device)[0])


def transmit(cfg: GfdmConfig, data, dtype=DEFAULT_DTYPE, device=None):
    """Full multi-antenna Tx: (..., n_data) -> (..., n_shifts, frame_len).

    Modulates once, then emits one cyclically-shifted, CP-framed, windowed,
    preamble-prefixed burst per configured cyclic shift (cyclic delay
    diversity, transmitter_cc_impl.cc:165-177).
    """
    data = as_complex(data, dtype, device, "transmit")
    check_last_dim(data, cfg.n_data_symbols, "transmit", "timeslots*active_subcarriers")
    T_T, cp_idx, win, pre = _frame_consts(cfg, dtype, data.device)
    core = mm(data, T_T)  # (..., N)
    framed = core[..., cp_idx] * win  # (..., n_shifts, W)
    pre = pre.expand(framed.shape[:-2] + pre.shape)
    return torch.cat([pre, framed], dim=-1)
