"""Burst-detection decision rule: the CFAR threshold and sliding sums.

The port of the framework-free part of ``gfdm_tpu.ops.sync``: the
constant-false-alarm-rate threshold derived from the golden model's
``threshold_factor`` and the cumulative-sum sliding window of the ``conv``
detection front end. The complex-dtype detectors of that module
(``detect_bursts``, ``detect_bursts_topk``) wait for ROADMAP.md Queue 1
item 8; the planar detectors live in :mod:`.planar_pipeline`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "RAYLEIGH_MEDIAN_TO_MEAN",
    "detection_threshold",
    "detection_valid",
    "moving_sum",
]

# Under noise the integrated autocorrelation magnitude is Rayleigh-
# distributed; detectors report its per-chunk MEDIAN as the noise floor
# (robust to a burst plateau contaminating a chunk mean). The false-alarm
# calibration of ref.synchronization.threshold_factor is stated against the
# Rayleigh MEAN, so convert: median/mean = sqrt(2 ln 2)/sqrt(pi/2).
RAYLEIGH_MEDIAN_TO_MEAN = float(np.sqrt(2.0 * np.log(2.0)) / np.sqrt(np.pi / 2.0))


def detection_threshold(false_alarm_prob: float, noise_floor):
    """Absolute detection threshold on the integrated-autocorrelation peak.

    ``noise_floor`` is the per-chunk median of the integrated
    autocorrelation trace (returned by the detectors). For a
    Rayleigh-distributed noise metric with mean m,
    P(X > lambda * m) = exp(-pi lambda^2 / 4), so
    lambda = sqrt(-(4/pi) ln Pfa) (gr-gfdm/python/pygfdm/synchronization.py:239-243).
    """
    from ..ref.synchronization import threshold_factor

    return threshold_factor(false_alarm_prob) * noise_floor / RAYLEIGH_MEDIAN_TO_MEAN


def detection_valid(detection: dict, false_alarm_prob: float):
    """Boolean mask: which detections exceed the false-alarm threshold.

    The autocorrelation peak (``ac_peak``, in [0, 1]) against the per-chunk
    noise floor; top-k slots (one more axis) share their chunk's floor.
    """
    thr = detection_threshold(false_alarm_prob, detection["noise_floor"])
    ac_peak = detection["ac_peak"]
    if hasattr(ac_peak, "ndim") and hasattr(thr, "ndim") and thr.ndim < ac_peak.ndim:
        thr = thr[..., None]
    return ac_peak > thr


def moving_sum(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing-window sliding sum along the last axis (valid part)."""
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    c = torch.cat([zero, torch.cumsum(x, dim=-1)], dim=-1)
    return c[..., window:] - c[..., : x.shape[-1] - window + 1]
