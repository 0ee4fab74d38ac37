"""Plot helpers for link evaluation (matplotlib optional).

The port of ``gfdm_tpu.eval.plotting``, the counterpart of the reference's
gfdm_plot_utils.py; import-safe without matplotlib (functions raise only
when called). Inputs may be NumPy arrays or tensors on any device (copied
to the host).
"""
from __future__ import annotations

import numpy as np

__all__ = ["plot_constellation", "plot_ber_curve", "plot_spectrum"]


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def plot_constellation(symbols, ref_points=None, ax=None, title="constellation"):
    plt = _plt()
    ax = ax or plt.gca()
    s = _host(symbols).reshape(-1)
    ax.scatter(s.real, s.imag, s=4, alpha=0.4)
    if ref_points is not None:
        rp = _host(ref_points)
        ax.scatter(rp.real, rp.imag, marker="x", s=100, c="red")
    ax.set_xlabel("I"); ax.set_ylabel("Q"); ax.set_title(title); ax.grid(True)
    return ax


def plot_ber_curve(result: dict, ax=None):
    """Plot the dict returned by gfdm_tpu_torch.eval.ber_sweep."""
    plt = _plt()
    ax = ax or plt.gca()
    ax.semilogy(result["snr_db"], np.maximum(result["ber"], 1e-9), "o-")
    ax.set_xlabel("SNR [dB]"); ax.set_ylabel("BER"); ax.grid(True, which="both")
    return ax


def plot_spectrum(samples, ax=None, fft_len=1024):
    plt = _plt()
    ax = ax or plt.gca()
    s = _host(samples).reshape(-1)
    n = (s.size // fft_len) * fft_len
    spec = np.fft.fftshift(
        np.mean(np.abs(np.fft.fft(s[:n].reshape(-1, fft_len), axis=1)) ** 2, axis=0)
    )
    ax.plot(np.linspace(-0.5, 0.5, fft_len), 10 * np.log10(spec + 1e-12))
    ax.set_xlabel("normalized frequency"); ax.set_ylabel("PSD [dB]"); ax.grid(True)
    return ax
