"""Preamble-based frequency-domain channel + SNR estimation (golden model).

Pipeline for one received 2*K repeated preamble:
  1. per-half K-point FFT x precomputed 0.5/FFT(ref half), averaged
  2. 9-tap Gaussian smoothing across the (fftshifted) active band with DC
     interpolation and edge replication
  3. per-subcarrier linear interpolation up to the full M*K frame estimate
  4. optional SNR/CNR estimate from a 2K FFT (even bins: signal+noise,
     odd bins: noise only)

Exact behavioral mirror of
gr-gfdm/lib/preamble_channel_estimator_cc.cc:86-294.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PreambleChannelEstimator", "gaussian_taps"]


def gaussian_taps(n_taps: int = 9, sigma_sq: float = 1.0) -> np.ndarray:
    """Normalized sampled Gaussian (preamble_channel_estimator_cc.cc:86-100)."""
    i = np.arange(n_taps, dtype=np.float64)
    t = np.exp(-0.5 * (i - n_taps // 2) ** 2 / sigma_sq)
    return t / t.sum()


class PreambleChannelEstimator:
    """Golden-model estimator bound to one core preamble.

    Parameters mirror the reference ctor
    (preamble_channel_estimator_cc.cc:34-78). ``which_estimator`` is accepted
    for API parity but, like the reference (its ZF switch is commented out,
    :291-293), does not change :meth:`estimate_frame`.
    """

    N_GAUSSIAN = 9

    def __init__(
        self,
        timeslots: int,
        fft_len: int,
        active_subcarriers: int,
        is_dc_free: bool,
        x_preamble: np.ndarray,
        which_estimator: int = 0,
    ):
        self.timeslots = timeslots
        self.fft_len = fft_len
        self.active_subcarriers = active_subcarriers
        self.is_dc_free = bool(is_dc_free)
        self.which_estimator = which_estimator
        x_preamble = np.asarray(x_preamble, dtype=np.complex128)
        if x_preamble.size != 2 * fft_len:
            raise ValueError("x_preamble must have length 2*fft_len")
        # inactive preamble bins are exactly zero; their inverses are never
        # read by the active-band smoother, so zero them instead of carrying
        # the reference's inf/NaN bins (preamble_channel_estimator_cc.cc:111-119)
        f0 = np.fft.fft(x_preamble[:fft_len])
        f1 = np.fft.fft(x_preamble[fft_len:])
        with np.errstate(divide="ignore", invalid="ignore"):
            self.inv_freq_preamble0 = np.where(f0 == 0, 0, 0.5 / f0)
            self.inv_freq_preamble1 = np.where(f1 == 0, 0, 0.5 / f1)
        self.taps = gaussian_taps(self.N_GAUSSIAN, 1.0)

    # -- step 1 -------------------------------------------------------------
    def estimate_preamble_channel(self, rx_preamble: np.ndarray) -> np.ndarray:
        """Average of the two per-half FD channel estimates, length fft_len."""
        K = self.fft_len
        e0 = np.fft.fft(rx_preamble[:K]) * self.inv_freq_preamble0
        e1 = np.fft.fft(rx_preamble[K : 2 * K]) * self.inv_freq_preamble1
        return e0 + e1

    # -- step 2 -------------------------------------------------------------
    def filter_preamble_estimate(self, estimate: np.ndarray) -> np.ndarray:
        """Gaussian-smoothed active-band estimate, fftshifted ordering.

        Output index 0 is the most negative active frequency; length
        active_subcarriers (+1 if dc_free, for the interpolated DC bin).
        """
        half = self.active_subcarriers // 2
        ng2 = self.N_GAUSSIAN // 2
        offset = 1 if self.is_dc_free else 0
        K = self.fft_len

        pieces = [
            np.full(ng2, estimate[K - half]),  # left edge replication
            estimate[K - half : K],  # negative-frequency half
        ]
        if self.is_dc_free:
            pieces.append(np.array([(estimate[K - 1] + estimate[1]) / 2.0]))
        pieces.append(estimate[offset : offset + half])  # positive-frequency half
        pieces.append(np.full(ng2, estimate[offset + half - 1]))  # right edge
        intermediate = np.concatenate(pieces)

        n_out = self.active_subcarriers + offset
        out = np.empty(n_out, dtype=np.complex128)
        for i in range(n_out):
            out[i] = np.dot(intermediate[i : i + self.N_GAUSSIAN], self.taps)
        return out

    # -- step 3 -------------------------------------------------------------
    def interpolate_frame(self, filtered: np.ndarray) -> np.ndarray:
        """Linear interpolation up to M*fft_len bins, FFT (DC-first) order.

        Mirror of preamble_channel_estimator_cc.cc:238-274.
        """
        M = self.timeslots
        n_est = self.active_subcarriers + (1 if self.is_dc_free else 0)
        center = self.fft_len * M // 2
        dead = self.fft_len - self.active_subcarriers
        # pre-fill with the last estimate: for fully-active configs (dead==0)
        # the reference's loops leave a bin range uninitialized (C++ reads
        # uninitialized memory, preamble_channel_estimator_cc.cc:238-274);
        # nearest-value fill makes that range well-defined here
        frame = np.full(self.fft_len * M, filtered[n_est - 1], dtype=np.complex128)

        frame[center : center + M * dead // 2] = filtered[0]
        frame[M * self.active_subcarriers // 2 : center] = filtered[n_est - 1]

        j = np.arange(M)
        for i in range(n_est // 2):
            inc = (filtered[i + 1] - filtered[i]) / M
            start = center + M * dead // 2 + i * M
            frame[start : start + M] = filtered[i] + j * inc
        for i in range(n_est // 2, n_est - 1):
            inc = (filtered[i + 1] - filtered[i]) / M
            start = (i - n_est // 2) * M
            frame[start : start + M] = filtered[i] + j * inc
        return frame

    # -- composite ----------------------------------------------------------
    def estimate_frame(self, rx_preamble: np.ndarray) -> np.ndarray:
        e = self.estimate_preamble_channel(rx_preamble)
        f = self.filter_preamble_estimate(e)
        return self.interpolate_frame(f)

    def prepare_for_zf(self, frame_estimate: np.ndarray) -> np.ndarray:
        """conj(1/H) over the full frame (prepare_for_zf, :276-282)."""
        return np.conj(1.0 / frame_estimate)

    # -- SNR ----------------------------------------------------------------
    def estimate_snr(self, rx_preamble: np.ndarray) -> tuple[float, np.ndarray]:
        """(snr_linear, per-subcarrier CNRs) from the repeated preamble.

        Mirror of preamble_channel_estimator_cc.cc:187-235: in the 2K FFT of
        the repeated preamble even bins carry signal+noise, odd bins noise.
        """
        K = self.fft_len
        F = np.fft.fft(rx_preamble[: 2 * K])
        p = np.abs(F) ** 2
        half = self.active_subcarriers // 2
        offset = 1 if self.is_dc_free else 0

        hi = 2 * (np.arange(half) + offset)  # positive-frequency active bins
        unused_half = (K - self.active_subcarriers) // 2
        lo = 2 * (np.arange(half) + unused_half + K // 2)  # negative-frequency bins

        cnrs = np.concatenate((p[hi], p[lo]))
        sym_energy = float(np.sum(p[hi]) + np.sum(p[lo]))
        noise_energy = float(np.sum(p[hi + 1]) + np.sum(p[lo + 1]))
        snr_lin = (sym_energy - noise_energy) / noise_energy
        scale = snr_lin / (sym_energy / cnrs.size)
        return snr_lin, cnrs * scale
