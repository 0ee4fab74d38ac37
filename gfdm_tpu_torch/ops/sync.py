"""Batched burst synchronization on complex tensors and its decision rule.

The port of ``gfdm_tpu.ops.sync``: the self-contained replacement for the
external XFDMSync OOT the reference depends on (examples/hier_gfdm_fastsync.grc:
sc_delay_corr -> sc_tagger -> xcorr_tagger). For each fixed-length stream
chunk it produces the detection metadata the reference carried in stream
tags (gr-gfdm/lib/extract_burst_cc_impl.cc:149-213): burst start index, CFO
phase rotation, power-normalization scale and a detection strength, all
with static shapes. Coarse: running Schmidl & Cox autocorrelation over the
repeated preamble halves plus CP integration; fine: the
autocorrelation-gated FFT cross-correlation with the core preamble. Also the
constant-false-alarm-rate threshold derived from the golden model's
``threshold_factor`` and the cumulative-sum sliding window. The planar
detectors of the service live in :mod:`.planar_pipeline`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import device_const
from ._complex import DEFAULT_DTYPE, as_complex, np_dtype, real_dtype

__all__ = [
    "detect_bursts",
    "detect_bursts_topk",
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


def _preamble_fft(cfg: GfdmConfig, n_fft: int, dtype, device) -> torch.Tensor:
    """conj(FFT_n_fft(unit-power core preamble)) in ``dtype`` on ``device``."""

    def build():
        x_pre = cfg.core_preamble
        x_pre = x_pre / np.sqrt(np.mean(np.abs(x_pre) ** 2))
        return np.conjugate(np.fft.fft(x_pre, n_fft)).astype(np_dtype(dtype))

    return device_const(("sync.Xp", cfg, n_fft, str(dtype)), device, build)


def _front(cfg: GfdmConfig, s: torch.Tensor, search_limit: int):
    """The detectors' shared traces: (ac, energy, ic, gated, n_valid)."""
    K, cp_len, p_len = cfg.subcarriers, cfg.cp_len, 2 * cfg.subcarriers
    T = s.shape[-1]
    n_fft = int(2 ** np.ceil(np.log2(T)))
    # coarse: running autocorrelation of the two preamble halves
    c = torch.conj(s[..., :-K]) * s[..., K:]
    p = moving_sum(c, K)[..., : T - 2 * K]
    energy = moving_sum(s.abs().to(real_dtype(s.dtype)) ** 2, 2 * K)[..., : T - 2 * K]
    ac = 2.0 * p / torch.clamp_min(energy, 1e-30).to(s.dtype)
    ac_mag = ac.abs()
    pad = ac_mag.new_zeros(ac_mag.shape[:-1] + (cp_len,))
    ic = moving_sum(torch.cat([pad, ac_mag], dim=-1), cp_len + 1) / (cp_len + 1)
    # fine: FFT cross-correlation with the core preamble
    S = torch.fft.fft(s, n_fft, dim=-1)
    Xp = _preamble_fft(cfg, n_fft, s.dtype, s.device)
    cc = torch.fft.ifft(S * Xp, dim=-1)[..., : T - p_len] / p_len
    n_valid = min(T - 2 * K, int(search_limit))
    gated = cc[..., :n_valid].abs() * ic[..., :n_valid]
    return ac, energy, ic, gated, n_valid


def _at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per leading row (take_along_axis on the last axis)."""
    return torch.gather(x, -1, idx)


def detect_bursts(cfg: GfdmConfig, stream, search_limit: int | None = None,
                  dtype=DEFAULT_DTYPE, device=None):
    """(..., T) IQ stream chunks -> per-chunk burst detection metadata.

    ``start`` indexes the first sample of the 2K core preamble; the full
    windowed preamble begins cp_len samples earlier. When the chunk carries a
    lookahead halo (so boundary-straddling bursts are complete), pass
    ``search_limit=chunk_len`` to restrict the detection argmax to positions
    this chunk owns. ``argmax`` takes the first of tied values, as
    ``jnp.argmax`` does.
    """
    from .planar_pipeline import _median

    s = as_complex(stream, dtype, device, "detect_bursts")
    T = s.shape[-1]
    limit = T if search_limit is None else int(search_limit)
    ac, energy, ic, gated, n_valid = _front(cfg, s, limit)
    nc = torch.argmax(gated, dim=-1, keepdim=True)
    ic_v = ic[..., :n_valid]
    return {
        "start": nc[..., 0],  # core-preamble start within the chunk
        "cfo": torch.angle(_at(ac, nc))[..., 0] / (2.0 * np.pi),  # of the spacing
        "scale": torch.sqrt(2 * cfg.subcarriers / torch.clamp_min(_at(energy, nc), 1e-30))[
            ..., 0],
        "strength": _at(gated, nc)[..., 0],  # gated correlation peak
        # normalized autocorrelation at the peak + per-chunk Rayleigh noise
        # floor: the inputs of the false-alarm decision rule (detection_valid)
        "ac_peak": _at(ic_v, nc)[..., 0],
        "noise_floor": _median(ic_v),
        "ac_metric": ic,  # full integrated autocorrelation trace
    }


def detect_bursts_topk(
    cfg: GfdmConfig,
    stream,
    max_bursts: int,
    search_limit: int | None = None,
    min_distance: int | None = None,
    dtype=DEFAULT_DTYPE,
    device=None,
):
    """Detect up to ``max_bursts`` bursts per chunk, strongest first.

    Iterative peak picking with +-min_distance suppression (defaults to one
    frame length), a Python loop over the slots where the JAX package scans:
    the static-shape counterpart of the reference processing several
    detector tags per work() call (extract_burst_cc_impl.cc:131-149).
    Entries beyond the real burst count have near-zero ``strength``.
    """
    from .planar_pipeline import _median

    s = as_complex(stream, dtype, device, "detect_bursts_topk")
    T = s.shape[-1]
    limit = T if search_limit is None else int(search_limit)
    if min_distance is None:
        min_distance = cfg.frame_len
    ac, energy, ic, g, n_valid = _front(cfg, s, limit)
    pos = torch.arange(n_valid, device=s.device)
    ncs, peaks = [], []
    for _ in range(int(max_bursts)):
        nc = torch.argmax(g, dim=-1, keepdim=True)
        peaks.append(_at(g, nc))
        ncs.append(nc)
        # suppress +- min_distance around the found peak
        g = torch.where((pos - nc).abs() < int(min_distance), torch.zeros_like(g), g)
    ncs = torch.cat(ncs, dim=-1)  # (..., max_bursts)
    ic_v = ic[..., :n_valid]
    return {
        "start": ncs,
        "cfo": torch.angle(_at(ac, ncs)) / (2.0 * np.pi),
        "scale": torch.sqrt(2 * cfg.subcarriers / torch.clamp_min(_at(energy, ncs), 1e-30)),
        "strength": torch.cat(peaks, dim=-1),
        "ac_peak": _at(ic_v, ncs),
        "noise_floor": _median(ic_v),
    }
