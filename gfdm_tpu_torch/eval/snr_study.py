"""Monte-Carlo accuracy study of the preamble SNR estimator.

The port of ``gfdm_tpu.eval.snr_study``, the counterpart of the reference's
gr-gfdm/python/pygfdm/simulation.py:58-127: sweep true SNR, run many noisy
preambles through the estimator, report bias and spread. The noise comes
from NumPy as in the JAX package (a seed draws the same noise in both); the
estimate is ``ops.estimation.estimate_snr`` on ``device`` (default: the
card; without one it raises), every trial of an SNR point one row of a
batch.
"""
from __future__ import annotations

import numpy as np

from ..config import GfdmConfig
from ..device import resolve_device
from ..ops import estimation
from ..ref import utils

__all__ = ["snr_estimator_study"]


def snr_estimator_study(
    cfg: GfdmConfig, snrs_db, trials: int = 200, seed: int = 0, in_band: bool = True,
    device=None,
):
    """Returns dict with per-SNR mean/std of the estimate (dB).

    With in_band=True the noise is scaled the way the reference QA does
    (active-band SNR convention, gr-gfdm/python/qa_python_bindings.py:51-56).
    """
    dev = resolve_device(device, "snr_estimator_study")
    x_pre = cfg.core_preamble.astype(np.complex128)
    sig_energy = utils.signal_energy(x_pre)
    n = x_pre.size
    active_ratio = cfg.subcarriers / cfg.active_subcarriers
    rng = np.random.default_rng(seed)

    means, stds = [], []
    for snr_db in np.asarray(snrs_db, dtype=np.float64):
        snr_lin = 10.0 ** (snr_db / 10.0)
        if in_band:
            nscale = np.sqrt(active_ratio * 2.0 * sig_energy / n / snr_lin)
            raw = rng.standard_normal((trials, n)) + 1j * rng.standard_normal((trials, n))
            noise = raw / np.abs(raw) * nscale
        else:
            nvar = utils.awgn_noise_variance(x_pre, snr_db)
            noise = np.sqrt(nvar) * (
                rng.standard_normal((trials, n)) + 1j * rng.standard_normal((trials, n))
            )
        rx = x_pre[None, :] + noise
        est, _ = estimation.estimate_snr(cfg, rx.astype(np.complex64), device=dev)
        est_db = 10.0 * np.log10(np.maximum(est.cpu().numpy(), 1e-12))
        means.append(float(np.mean(est_db)))
        stds.append(float(np.std(est_db)))
    return {
        "snr_db": np.asarray(snrs_db, dtype=np.float64),
        "est_mean_db": np.asarray(means),
        "est_std_db": np.asarray(stds),
    }
