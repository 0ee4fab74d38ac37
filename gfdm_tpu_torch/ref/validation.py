"""Deterministic reference-frame generators for OTA / capture validation.

Golden-model parity with gr-gfdm/python/pygfdm/validation_utils.py:81-141:
seeded, fully reproducible GFDM frames (preamble + windowed payload) that an
over-the-air capture — or any other implementation — can be validated against.
The reference's ``frame_estimator`` class (validation_utils.py:33-78) lives
here as :class:`~gfdm_tpu_torch.ref.channel_estimation.PreambleChannelEstimator`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .cyclic_prefix import (
    add_cyclic_extension,
    pinch_block,
    raised_cosine_ramp,
    window_len,
)
from .filters import frequency_domain_filter, normalize_taps_energy
from .mapping import subcarrier_map
from .modulation import modulate_mapped_block
from .preamble import mapped_preamble
from .utils import generate_seed, random_qpsk

__all__ = ["ReferenceFrame", "generate_reference_frame", "embed_frame_in_noise"]

PREAMBLE_SEED_TEXT = "awesome preamble"
FRAME_SEED_TEXT = "awesome frame"


class ReferenceFrame(NamedTuple):
    """Everything needed to validate a capture against the golden model."""

    frame: np.ndarray  # full Tx frame: windowed preamble + windowed payload
    modulated_payload: np.ndarray  # payload before CP/window (M*K samples)
    x_preamble: np.ndarray  # 2*K core preamble (channel-estimator reference)
    data: np.ndarray  # the seeded QPSK data symbols
    freq_taps: np.ndarray  # energy-normalized sparse FD filter taps


def generate_reference_frame(
    timeslots: int,
    subcarriers: int,
    active_subcarriers: int,
    cp_len: int,
    cs_len: int,
    alpha: float = 0.2,
    filtertype: str = "rrc",
) -> ReferenceFrame:
    """Seeded preamble + QPSK payload frame (validation_utils.py:81-99).

    Seeds derive from the reference's fixed strings so frames are
    reproducible across runs and machines.
    """
    p_seed = generate_seed(PREAMBLE_SEED_TEXT)
    f_seed = generate_seed(FRAME_SEED_TEXT)
    smap = subcarrier_map(subcarriers, active_subcarriers, dc_free=True)
    overlap = 2

    frame_preamble, x_preamble = mapped_preamble(
        p_seed, filtertype, alpha, active_subcarriers, subcarriers, smap,
        overlap, cp_len, cs_len,
    )
    data = random_qpsk(timeslots * active_subcarriers, f_seed)
    payload = modulate_mapped_block(
        data, timeslots, subcarriers, active_subcarriers, overlap, alpha,
        dc_free=True, filtertype=filtertype,
    )
    symbol = add_cyclic_extension(payload, cp_len, cs_len)
    ramp = raised_cosine_ramp(cs_len, window_len(payload.size, cp_len, cs_len))
    windowed = pinch_block(symbol, ramp)

    taps = normalize_taps_energy(
        frequency_domain_filter(filtertype, alpha, timeslots, subcarriers, overlap),
        timeslots,
    )
    return ReferenceFrame(
        frame=np.concatenate((frame_preamble, windowed)),
        modulated_payload=payload,
        x_preamble=x_preamble,
        data=data,
        freq_taps=taps,
    )


def embed_frame_in_noise(
    frame: np.ndarray,
    n_pre: int = 1000,
    n_post: int = 1000,
    scale: float = 1e-3,
    seed: int | None = None,
) -> np.ndarray:
    """Surround a frame with low-power noise (validation_utils.py:149-151's
    test-capture construction) — a synthetic 'capture' for sync testing."""
    rng = np.random.default_rng(seed)
    mk = lambda n: scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
    return np.concatenate((mk(n_pre), frame, mk(n_post)))
