"""Timed-transmission scheduling: cycle-grid quantization for burst Tx.

A copy of ``gfdm_tpu.runtime.timing`` (pure Python), kept in the port so it
imports nothing of the JAX package. Pure-function port of the
short_burst_shaper's USRP timing logic
(gr-gfdm/lib/short_burst_shaper_impl.cc:184-233 and the tick helpers in
short_burst_shaper_impl.h:60-77): given the current radio time, quantize
the next transmission onto a cycle-interval grid (aligned to the receiver's
rx_time phase), apply a timing advance, and emit (full_secs, frac_secs)
``tx_time`` stamps plus rx-gain gating windows.

No radio hardware is assumed; these functions produce the timestamps/command
payloads a UHD-style radio interface consumes.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["BurstScheduler", "ticks_from_timespec", "timespec_from_ticks"]

_TICKS_PER_SEC = 1_000_000_000


def ticks_from_timespec(full_secs: int, frac_secs: float) -> int:
    return _TICKS_PER_SEC * int(full_secs) + int(_TICKS_PER_SEC * frac_secs)


def timespec_from_ticks(ticks: int) -> tuple[int, float]:
    return int(ticks // _TICKS_PER_SEC), float(ticks % _TICKS_PER_SEC) / _TICKS_PER_SEC


@dataclass
class BurstScheduler:
    """Stateful next-slot calculator (one per transmit chain)."""

    cycle_interval_secs: float
    timing_advance_secs: float
    rx_time_ticks: int = 0  # phase reference from the receiver
    last_tx_ticks: int = 0

    @property
    def cycle_interval_ticks(self) -> int:
        return int(self.cycle_interval_secs * _TICKS_PER_SEC)

    @property
    def timing_advance_ticks(self) -> int:
        return int(self.timing_advance_secs * _TICKS_PER_SEC)

    def next_tx_time(self, now_full_secs: int, now_frac_secs: float) -> tuple[int, float]:
        """Quantize the next Tx onto the cycle grid (impl.cc:185-200).

        Returns the (full_secs, frac_secs) ``tx_time`` stamp including the
        timing advance; successive calls never schedule into the past.
        """
        fts = ticks_from_timespec(now_full_secs, now_frac_secs)
        ci = self.cycle_interval_ticks
        fts -= fts % ci
        fts += ci
        while fts <= self.last_tx_ticks:
            fts += ci
        fts += self.rx_time_ticks % ci
        self.last_tx_ticks = fts
        fts += self.timing_advance_ticks
        return timespec_from_ticks(fts)

    def rx_gain_windows(
        self, tx_full_secs: int, tx_frac_secs: float, packet_len: int, samp_rate: float,
        guard_secs: float = 1.0e-4, off_gain: float = 0.0, on_gain: float = 65.0,
    ):
        """Rx gain gating commands around a transmission (impl.cc:122-140).

        Returns two (full_secs, frac_secs, gain) tuples: mute slightly before
        the burst, restore after it ends.
        """
        t0 = ticks_from_timespec(tx_full_secs, tx_frac_secs) - int(
            guard_secs * _TICKS_PER_SEC
        )
        t1 = ticks_from_timespec(tx_full_secs, tx_frac_secs) + int(
            (guard_secs + packet_len / samp_rate) * _TICKS_PER_SEC
        )
        return (
            (*timespec_from_ticks(t0), off_gain),
            (*timespec_from_ticks(t1), on_gain),
        )
