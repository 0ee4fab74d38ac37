"""Legacy oversampled modulator on complex tensors (the port of
``gfdm_tpu.ops.legacy``).

The reference's modulator_cc block (gr-gfdm/lib/modulator_cc_impl.cc:115-153):
the whole oversampled modulation (per-subcarrier FFT, width-2 filtering,
centered circular placement, fft_len IFFT) is one dense (fft_len, N)
operator built from the golden model in :mod:`..ref.legacy`, uploaded once
per (config, fft_len, dtype, device) and applied as one complex product in
full float32 (no TF32) on a card.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..config import GfdmConfig
from ..ref import legacy as legacy_ref
from ._complex import DEFAULT_DTYPE, as_complex, const, mm
from ._validate import check_last_dim

__all__ = ["modulate_oversampled", "legacy_taps"]


@lru_cache(maxsize=16)
def legacy_taps(cfg: GfdmConfig) -> np.ndarray:
    return legacy_ref.sparse_taps_legacy(
        cfg.filtertype, cfg.filteralpha, cfg.timeslots, cfg.subcarriers
    )


@lru_cache(maxsize=16)
def _legacy_operator(cfg: GfdmConfig, fft_len: int) -> np.ndarray:
    n = cfg.block_len
    taps = legacy_taps(cfg)
    A = np.empty((fft_len, n), dtype=np.complex128)
    e = np.zeros(n, dtype=np.complex128)
    for j in range(n):
        e[j] = 1.0
        A[:, j] = legacy_ref.modulate_oversampled_block(
            e.reshape(cfg.subcarriers, cfg.timeslots), taps, fft_len
        )
        e[j] = 0.0
    return A


def modulate_oversampled(cfg: GfdmConfig, grid_flat, fft_len: int | None = None,
                         dtype=DEFAULT_DTYPE, device=None):
    """(..., M*K) grid symbols -> (..., fft_len) oversampled centered frame.

    A NumPy grid goes to ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card and without ``device`` it raises)."""
    fft_len = cfg.block_len if fft_len is None else int(fft_len)
    if fft_len < cfg.block_len:
        raise ValueError("fft_len must be >= timeslots * subcarriers")
    x = as_complex(grid_flat, dtype, device, "modulate_oversampled")
    check_last_dim(x, cfg.block_len, "modulate_oversampled", "timeslots*subcarriers")
    A_T = const(("legacy.A_T", fft_len), cfg, dtype, x.device,
                lambda: _legacy_operator(cfg, fft_len).T)
    return mm(x, A_T)
