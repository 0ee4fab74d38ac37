"""GfdmConfig: the single source of truth for one GFDM waveform setup.

A copy of ``gfdm_tpu.config`` for the PyTorch port. All derived artifacts
(filter taps, window, subcarrier map, per-shift preambles, padding) are
precomputed once in NumPy float64 at construction time and turned into
device tensors by the torch modules.

Parity target: the reference's canonical configuration factory
gr-gfdm/python/pygfdm/configurator.py:39-82 (defaults M=9, K=64,
active=52, L=2, cp=16, cs=8, ZC preamble, rrc alpha=0.2).
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from .ref import cyclic_prefix as cp_ref
from .ref import filters as filters_ref
from .ref import mapping as mapping_ref
from .ref import preamble as preamble_ref

__all__ = ["GfdmConfig", "round_up_power_of_2", "padding_lengths"]

PREAMBLE_SEED = 3660365253  # fixed seed, configurator.py:36


def round_up_power_of_2(value: int) -> int:
    return int(2 ** np.ceil(np.log2(float(value))))


def padding_lengths(frame_len: int) -> tuple[int, int]:
    """(pre, post) zero padding rounding the frame to a power of two.

    Mirror of configurator.py:22-33.
    """
    padded = round_up_power_of_2(frame_len)
    if padded - frame_len < 500:
        padded *= 2
    total = padded - frame_len
    pre, post = 256, 128
    while pre + post < total:
        pre += 128
        post += 128
    post -= pre + post - total
    return pre, post


@dataclasses.dataclass(frozen=True)
class GfdmConfig:
    """Immutable GFDM waveform configuration + derived artifacts."""

    timeslots: int = 9  # M
    subcarriers: int = 64  # K
    active_subcarriers: int = 52
    overlap: int = 2  # L
    cp_len: int = 16
    cs_len: int = 8
    filtertype: str = "rrc"
    filteralpha: float = 0.2
    cyclic_shifts: tuple[int, ...] = (0,)
    dc_free: bool = True
    per_timeslot: bool = True
    seed: int = PREAMBLE_SEED
    use_zadoff_chu: bool = True

    # ---- scalar derived quantities ----------------------------------------
    @property
    def ramp_len(self) -> int:
        return self.cs_len

    @property
    def block_len(self) -> int:
        """Core frame: M*K samples."""
        return self.timeslots * self.subcarriers

    @property
    def window_len(self) -> int:
        """Core frame + CP + CS."""
        return self.block_len + self.cp_len + self.cs_len

    @property
    def n_data_symbols(self) -> int:
        """Payload capacity per frame."""
        return self.timeslots * self.active_subcarriers

    @property
    def preamble_len(self) -> int:
        return int(self.full_preambles.shape[1])

    @property
    def core_preamble_len(self) -> int:
        return 2 * self.subcarriers

    @property
    def frame_len(self) -> int:
        """Full over-the-air burst: preamble + windowed core frame."""
        return self.window_len + self.preamble_len

    @property
    def pre_padding_len(self) -> int:
        return padding_lengths(self.frame_len)[0]

    @property
    def post_padding_len(self) -> int:
        return padding_lengths(self.frame_len)[1]

    @property
    def padded_frame_len(self) -> int:
        return self.pre_padding_len + self.frame_len + self.post_padding_len

    # ---- derived arrays (all NumPy, trace-time constants) -----------------
    @cached_property
    def subcarrier_map(self) -> np.ndarray:
        return mapping_ref.subcarrier_map(
            self.subcarriers, self.active_subcarriers, dc_free=self.dc_free
        )

    @cached_property
    def tx_filter_taps(self) -> np.ndarray:
        """Energy-normalized sparse FD taps, length M*L."""
        return filters_ref.frequency_domain_filter(
            self.filtertype, self.filteralpha, self.timeslots, self.subcarriers, self.overlap
        )

    @cached_property
    def rx_filter_taps(self) -> np.ndarray:
        """Matched-filter taps: conjugate of the Tx taps (configurator.py:79)."""
        return np.conjugate(self.tx_filter_taps)

    @cached_property
    def window_taps(self) -> np.ndarray:
        """Raised-cosine pinching window over the whole CP+block+CS frame."""
        return cp_ref.raised_cosine_ramp(self.ramp_len, self.window_len)

    @cached_property
    def _preamble_pairs(self) -> list[tuple[np.ndarray, np.ndarray]]:
        return [
            preamble_ref.mapped_preamble(
                self.seed,
                self.filtertype,
                self.filteralpha,
                self.active_subcarriers,
                self.subcarriers,
                self.subcarrier_map,
                self.overlap,
                self.cp_len,
                self.ramp_len,
                use_zadoff_chu=self.use_zadoff_chu,
                cyclic_shift=shift,
            )
            for shift in self.cyclic_shifts
        ]

    @cached_property
    def full_preambles(self) -> np.ndarray:
        """(n_shifts, preamble_len) windowed preambles, one per cyclic shift."""
        return np.stack([p[0] for p in self._preamble_pairs])

    @cached_property
    def core_preamble(self) -> np.ndarray:
        """Un-windowed 2*K core preamble (channel-estimation reference)."""
        return self._preamble_pairs[0][1]

    def __post_init__(self):
        if self.overlap < 2:
            raise ValueError("overlap must be >= 2 (receiver requirement)")
        if self.active_subcarriers > self.subcarriers:
            raise ValueError("active_subcarriers must be <= subcarriers")
        if any(s < 0 or s > self.cs_len for s in self.cyclic_shifts):
            raise ValueError("cyclic shifts must lie in [0, cs_len]")

    def replace(self, **kwargs) -> "GfdmConfig":
        return dataclasses.replace(self, **kwargs)
