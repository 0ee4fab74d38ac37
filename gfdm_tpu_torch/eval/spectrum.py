"""Out-of-band emission and PAPR evaluation (the port of
``gfdm_tpu.eval.spectrum``).

Spectral containment is GFDM's raison d'etre: the per-subcarrier RRC/RC
pulse shaping plus the ramped cyclic-prefix window suppress out-of-band
leakage relative to plain rectangular-pulse OFDM on the same resource
grid. The reference keeps PAPR experiments in its Zadoff-Chu module
(gr-gfdm/python/pygfdm/zadoff_chu.py, __main__ block) and PSD plotting in
gfdm_plot_utils.py; this module makes both first-class measurements:

- welch_psd: averaged-periodogram PSD over a sample stream.
- oob_attenuation: in-band vs out-of-band mean PSD ratio (dB).
- spectrum_study: GFDM (windowed frame and bare core) vs plain OFDM on
  identical payload grids - asserts nothing, returns the numbers.
- papr_ccdf: per-burst peak-to-average power ratio CCDF.

The signals are built by the float64 golden model in NumPy, as in the JAX
package; the measures (the Welch PSD's segment FFTs, batched over the
segments, the PAPR and its CCDF) run as float64 torch ops on ``device``
(default: the card; without one it raises; a tensor input stays on its
own device). Results come back as NumPy arrays and floats.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import as_tensor, resolve_device
from ..ref import mapping as ref_mapping
from ..ref import modulation as ref_modulation
from ..ref import utils as ref_utils

__all__ = [
    "welch_psd",
    "oob_attenuation",
    "papr",
    "papr_ccdf",
    "spectrum_study",
]


def _f64(x, device, who: str) -> torch.Tensor:
    """``x`` as a float64 or complex128 tensor (see device.as_tensor)."""
    t = as_tensor(x, device, who)
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _welch(x: torch.Tensor, nfft: int, hop: int | None) -> torch.Tensor:
    """Welch PSD of a 1-D float64 / complex128 tensor, fftshifted."""
    hop = hop or nfft // 2
    n_seg = max(1, (x.numel() - nfft) // hop + 1)
    win = torch.from_numpy(np.hanning(nfft)).to(x.device)
    scale = 1.0 / (float(np.sum(np.hanning(nfft) ** 2)) * n_seg)
    segs = x.unfold(0, nfft, hop)[:n_seg] * win  # (n_seg, nfft)
    acc = torch.sum(torch.fft.fft(segs, dim=-1).abs() ** 2, dim=0)
    return torch.fft.fftshift(acc) * scale


def _freqs(nfft: int) -> np.ndarray:
    return np.linspace(-0.5, 0.5, nfft, endpoint=False)


def welch_psd(samples, nfft: int = 1024, hop: int | None = None, device=None):
    """Averaged modified periodogram (Hann window), fftshifted.

    Returns (freqs in cycles/sample on [-0.5, 0.5), PSD linear) as NumPy
    float64 arrays.
    """
    x = _f64(samples, device, "welch_psd").reshape(-1)
    return _freqs(nfft), _welch(x, nfft, hop).cpu().numpy()


def oob_attenuation(samples, occupied: float, guard: float = 0.05,
                    nfft: int = 1024, device=None) -> float:
    """Mean in-band over mean out-of-band PSD, in dB.

    ``occupied``: one-sided edge of the occupied band in cycles/sample
    (active_subcarriers / (2 * subcarriers) for a DC-centred allocation).
    ``guard``: transition region excluded from the out-of-band average.
    """
    x = _f64(samples, device, "oob_attenuation").reshape(-1)
    p = _welch(x, nfft, None)
    f = np.abs(_freqs(nfft))
    inband = p[torch.from_numpy(f < occupied).to(p.device)]
    oob = p[torch.from_numpy(f > occupied + guard).to(p.device)]
    return float(10.0 * torch.log10(torch.mean(inband) / torch.mean(oob)))


def _papr(b: torch.Tensor) -> torch.Tensor:
    pwr = b.abs() ** 2
    return 10.0 * torch.log10(pwr.amax(dim=-1) / pwr.mean(dim=-1))


def papr(bursts, device=None) -> np.ndarray:
    """Per-burst peak-to-average power ratio in dB. bursts: (n, L) complex."""
    return _papr(_f64(bursts, device, "papr")).cpu().numpy()


def papr_ccdf(bursts, thresholds_db=None, device=None):
    """CCDF of the per-burst PAPR: P(PAPR > threshold).

    Returns (thresholds_db, ccdf) - the standard waveform comparison curve
    (the reference's zadoff_chu PAPR experiment, made a library function).
    """
    p = _papr(_f64(bursts, device, "papr_ccdf"))
    if thresholds_db is None:
        thresholds_db = np.arange(4.0, 12.5, 0.5)
    t = np.asarray(thresholds_db, dtype=np.float64)
    tt = torch.from_numpy(t).to(p.device)
    ccdf = (p.reshape(-1)[None, :] > tt[:, None]).to(torch.float64).mean(dim=-1)
    return t, ccdf.cpu().numpy()


def _payload_grids(cfg: GfdmConfig, n_bursts: int, seed: int):
    """Random QPSK payloads mapped to (K, M) resource grids (NumPy)."""
    d = ref_utils.random_qpsk(n_bursts * cfg.n_data_symbols, seed=seed)
    d = d.reshape(n_bursts, -1)
    return np.stack(
        [
            ref_mapping.map_to_resources(
                row, cfg.timeslots, cfg.subcarriers, cfg.subcarrier_map
            )
            for row in d
        ]
    )


def _ofdm_modulate(grids: np.ndarray) -> np.ndarray:
    """Plain OFDM on the same (K, M) resource grids: one K-point IFFT per
    timeslot, rectangular pulse, concatenated - the no-filter baseline the
    GFDM pulse shaping is measured against (NumPy)."""
    sym = np.fft.ifft(np.swapaxes(grids, -1, -2), axis=-1)  # (n, M, K)
    return sym.reshape(grids.shape[0], -1)


def spectrum_study(cfg: GfdmConfig | None = None, n_bursts: int = 64,
                   seed: int = 7, nfft: int = 1024, device=None) -> dict:
    """OOB attenuation + PAPR for GFDM vs plain OFDM on identical payloads.

    Returns a dict with, per waveform ('gfdm_frame' = pulse-shaped core +
    ramped CP window, 'gfdm_core' = bare pulse-shaped block, 'ofdm' =
    rectangular pulse), the OOB attenuation in dB and the median PAPR in
    dB, plus the PAPR CCDFs. Expected ordering: gfdm_frame > gfdm_core >
    ofdm in containment. The signals are the golden model's (NumPy); the
    measures run on ``device`` (default: the card).
    """
    from ..ref import cyclic_prefix as ref_cp

    dev = resolve_device(device, "spectrum_study")
    cfg = cfg or GfdmConfig()
    grids = _payload_grids(cfg, n_bursts, seed)
    gfdm_core = np.stack(
        [ref_modulation.modulate_block(g, cfg.tx_filter_taps, cfg.overlap)
         for g in grids]
    )
    framed = np.stack(
        [
            ref_cp.add_cyclic_prefix(
                b, cfg.cp_len, cfg.cs_len, cfg.window_taps, cfg.ramp_len
            )
            for b in gfdm_core
        ]
    )
    ofdm = _ofdm_modulate(grids)
    occ = cfg.active_subcarriers / (2.0 * cfg.subcarriers)
    out = {}
    for name, sig in (("gfdm_frame", framed), ("gfdm_core", gfdm_core),
                      ("ofdm", ofdm)):
        s = _f64(sig, dev, "spectrum_study")
        t, ccdf = papr_ccdf(s)
        out[name] = {
            "oob_attenuation_db": oob_attenuation(s, occ, nfft=nfft),
            "papr_median_db": float(np.median(papr(s))),
            "papr_thresholds_db": t,
            "papr_ccdf": ccdf,
        }
    return out
