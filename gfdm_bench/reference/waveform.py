"""A batched plain GFDM link restated from the pygfdm golden modules.

``Waveform(shape)`` derives every constant of one configuration from the
frozen golden copy (``reference.pygfdm``) in NumPy float64: filter taps,
subcarrier map, window, preamble, the preamble channel estimator. Its
methods run the golden model's stages on a batch in PyTorch, one precision
(``reference.precision``) for every linear stage:

- ``transmit``: map (per-timeslot order), the sparse-FD modulator
  (per-subcarrier M-point FFT, L-tap overlap-add, N-point IFFT), CP + CS,
  the raised-cosine window, the preamble in front
  (modulation.modulate_block, cyclic_prefix, preamble.mapped_preamble);
- ``receive``: the preamble channel estimate (channel_estimation's three
  linear steps as one operator), the SNR from the 2K preamble FFT
  (estimate_snr), the block FFT, zero-forcing divide, the matched filter
  fold and per-subcarrier M-point IFFT (demodulation.demodulate_block),
  ``ic_iterations`` interference cancellations on QPSK decisions
  (cancel_sc_interference), the data symbols gathered back out.

``ic_operand`` names the precision a configuration states for the
cancellation's operator (``None``: the golden taps as they are).

Bursts are complex (B, frame_len), payloads complex (B, n_data) or planar
float (B, 2, n_data). Nothing here imports the program under test.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .precision import compute_dtype, rounder
from .pygfdm import channel_estimation, cyclic_prefix, demodulation, filters, mapping
from .pygfdm import preamble as preamble_ref

SHAPE_KEYS = ("timeslots", "subcarriers", "active_subcarriers", "overlap", "cp_len",
              "cs_len", "filtertype", "filteralpha", "dc_free", "per_timeslot",
              "preamble_seed", "use_zadoff_chu")
QPSK_AMP = 2.0**-0.5


def _columns(fn, n_in: int) -> np.ndarray:
    """The matrix of the linear map ``fn`` (n_in -> n_out), probed column by
    column with basis vectors."""
    cols = []
    e = np.zeros(n_in, dtype=np.complex128)
    for j in range(n_in):
        e[j] = 1.0
        cols.append(np.asarray(fn(e), dtype=np.complex128))
        e[j] = 0.0
    return np.stack(cols, axis=1)


class Waveform:
    """The constants and batched stages of one GFDM configuration."""

    def __init__(self, shape: dict, device="cpu", precision: str = "float64",
                 ic_operand: str | None = None):
        missing = [k for k in SHAPE_KEYS if k not in shape]
        if missing:
            raise ValueError(f"configuration lacks {missing}")
        s = shape
        self.M, self.K, self.L = int(s["timeslots"]), int(s["subcarriers"]), int(s["overlap"])
        self.n_active = int(s["active_subcarriers"])
        self.cp, self.cs = int(s["cp_len"]), int(s["cs_len"])
        self.N = self.M * self.K
        self.n_data = self.M * self.n_active
        self.window_len = self.N + self.cp + self.cs
        self.device = torch.device(device)
        self.precision = precision
        self.rnd = rounder(precision)
        self.cdt = compute_dtype(precision)
        self.rdt = torch.float64 if self.cdt == torch.complex128 else torch.float32
        M, K, L = self.M, self.K, self.L

        self.smap = np.sort(mapping.subcarrier_map(K, self.n_active, dc_free=bool(s["dc_free"])))
        self.per_timeslot = bool(s["per_timeslot"])
        tx_taps = filters.frequency_domain_filter(s["filtertype"], float(s["filteralpha"]),
                                                  M, K, L)
        rx_taps = np.conjugate(tx_taps)
        win = np.ones(self.window_len)
        ramp = cyclic_prefix.raised_cosine_ramp(self.cs, self.window_len)
        if self.cs > 0:
            win[: self.cs] = ramp[: self.cs]
            win[-self.cs :] = ramp[-self.cs :]
        full_pre, core_pre = preamble_ref.mapped_preamble(
            int(s["preamble_seed"]), s["filtertype"], float(s["filteralpha"]), self.n_active,
            K, self.smap, L, self.cp, self.cs, use_zadoff_chu=bool(s["use_zadoff_chu"]),
            cyclic_shift=0)
        self.preamble_len = full_pre.size
        self.frame_len = self.preamble_len + self.window_len
        self.core_preamble = core_pre
        self.cp_idx = np.concatenate([np.arange(self.N - self.cp, self.N), np.arange(self.N),
                                      np.arange(0, self.cs)])
        est = channel_estimation.PreambleChannelEstimator(M, K, self.n_active,
                                                          bool(s["dc_free"]), core_pre)
        half = self.n_active // 2
        offset = 1 if s["dc_free"] else 0
        hi = 2 * (np.arange(half) + offset)
        lo = 2 * (np.arange(half) + (K - self.n_active) // 2 + K // 2)
        act = np.zeros(K, dtype=bool)
        act[self.smap] = True

        def t(a, dtype=None):
            return torch.as_tensor(a, device=self.device, dtype=dtype)

        self.tx_parts = self.rnd(t(tx_taps.reshape(L, M)))
        self.rx_parts = self.rnd(t(rx_taps.reshape(L, M)))
        ic_taps = demodulation.ic_filter_taps(rx_taps, M, L)
        if ic_operand is not None:
            # the cancellation as an M-tap circulant whose taps, the
            # decision amplitude folded in, are rounded to ``ic_operand``:
            # the IC operator of a configuration that states its precision
            c = rounder(ic_operand)(t(np.fft.ifft(ic_taps) * QPSK_AMP)).to(torch.complex128)
            ic_taps = (torch.fft.fft(c) / QPSK_AMP).cpu().numpy()
        self.ic_taps = self.rnd(t(ic_taps))
        self.win = t(win, self.rdt)
        self.preamble = self.rnd(t(full_pre))
        self.est_op = self.rnd(t(self._estimator(est)))  # (2K, N): y = pre @ op
        self.sig_idx = t(np.concatenate((hi, lo)))
        self.noise_idx = t(np.concatenate((hi + 1, lo + 1)))
        self.active = t(act)
        self.cp_idx_t = t(self.cp_idx)
        self.smap_t = t(self.smap)

    # -- constants ----------------------------------------------------------
    def _estimator(self, est) -> np.ndarray:
        """The golden estimator's three linear steps as one (2K, N) operator:
        step 1 (per-half FFT x 0.5/FFT(reference half)), the Gaussian smoother
        and the linear interpolation, each probed on basis vectors."""
        K = self.K
        step1 = _columns(est.estimate_preamble_channel, 2 * K)  # (K, 2K)
        smooth = _columns(est.filter_preamble_estimate, K)  # (n_est, K)
        n_est = smooth.shape[0]
        interp = _columns(est.interpolate_frame, n_est)  # (N, n_est)
        return (interp @ smooth @ step1).T

    # -- layout -------------------------------------------------------------
    def grid_from_data(self, data: torch.Tensor) -> torch.Tensor:
        """(B, n_data) complex -> (B, K, M) grid (map_to_resources)."""
        B = data.shape[0]
        grid = torch.zeros((B, self.K, self.M), dtype=data.dtype, device=data.device)
        if self.per_timeslot:
            grid[:, self.smap_t, :] = data.reshape(B, self.M, self.n_active).transpose(1, 2)
        else:
            grid[:, self.smap_t, :] = data.reshape(B, self.n_active, self.M)
        return grid

    def data_from_grid(self, grid: torch.Tensor) -> torch.Tensor:
        """(B, K, M) -> (B, n_data) (demap_from_resources)."""
        act = grid[:, self.smap_t, :]
        if self.per_timeslot:
            return act.transpose(1, 2).reshape(grid.shape[0], -1)
        return act.reshape(grid.shape[0], -1)

    @staticmethod
    def complex_payload(planar: torch.Tensor) -> torch.Tensor:
        """(B, 2, n) float planar -> (B, n) complex128."""
        p = planar.to(torch.float64)
        return torch.complex(p[:, 0], p[:, 1])

    # -- transmitter --------------------------------------------------------
    def modulate(self, grid: torch.Tensor) -> torch.Tensor:
        """(B, K, M) -> (B, N): modulation.modulate_block on each grid."""
        L, r = self.L, self.rnd
        W = torch.fft.fft(r(grid), dim=-1)
        X = torch.zeros_like(W)
        for i in range(L):
            part = self.tx_parts[(i + L // 2) % L]
            X = X + torch.roll(r(W), i - L // 2, dims=-2) * part
        return torch.fft.ifft(r(X.reshape(grid.shape[0], self.N)), dim=-1)

    def transmit(self, data: torch.Tensor) -> torch.Tensor:
        """(B, 2, n_data) planar or (B, n_data) complex payload -> (B,
        frame_len) bursts."""
        if not data.is_complex():
            data = self.complex_payload(data)
        core = self.modulate(self.grid_from_data(data.to(self.device, self.cdt)))
        framed = core[:, self.cp_idx_t] * self.win
        pre = self.preamble.expand(core.shape[0], -1)
        return torch.cat([pre, framed], dim=-1)

    # -- receiver -----------------------------------------------------------
    def estimate(self, bursts: torch.Tensor):
        """(B, frame_len) -> channel (B, N) in FFT order, snr_lin (B,)."""
        r, K = self.rnd, self.K
        pre = bursts[:, self.cp : self.cp + 2 * K]
        chan = r(pre) @ self.est_op
        p = torch.fft.fft(r(pre), dim=-1).abs() ** 2
        sym = p[:, self.sig_idx].sum(-1)
        noise = p[:, self.noise_idx].sum(-1)
        return chan, (sym - noise) / noise

    def decide(self, d: torch.Tensor) -> torch.Tensor:
        """QPSK decisions at amplitude 1/sqrt(2) (>= 0 -> +1), zero off the
        active subcarriers; (B, K, M)."""
        one = torch.ones((), dtype=self.rdt, device=d.device)
        re = torch.where(d.real >= 0, one, -one)
        im = torch.where(d.imag >= 0, one, -one)
        q = torch.complex(re, im) * QPSK_AMP
        return q * self.active[:, None]

    def demodulate(self, frame: torch.Tensor, chan: torch.Tensor, ic_iterations: int,
                   flips: torch.Tensor | None = None, margins: list | None = None):
        """(B, N) frames, (B, N) channel -> (B, K, M) symbol estimates:
        ZF, fold, M-point IFFTs, then the IC passes. ``flips``
        (ic_iterations, B, K, M, 2) of +-1 multiplies each pass's decisions,
        real and imaginary part; ``margins``, a list, gets each pass's
        (B, K, M, 2) distances of the decided estimates from their
        boundaries (|Re|, |Im|; inf off the active subcarriers)."""
        r, L, B = self.rnd, self.L, frame.shape[0]
        X = torch.fft.fft(r(frame), dim=-1) / r(chan)
        Xg = r(X).reshape(B, self.K, self.M)
        S = torch.zeros_like(Xg)
        for i in range(L):
            part = self.rx_parts[(i + L // 2) % L]
            S = S + torch.roll(Xg, -(i - L // 2), dims=-2) * part
        S = r(S)
        d = torch.fft.ifft(S, dim=-1)
        for it in range(ic_iterations):
            hard = self.decide(d)
            if margins is not None:
                m = torch.view_as_real(d.to(torch.complex128)).abs()
                margins.append(torch.where(self.active[:, None, None], m, math.inf))
            if flips is not None:
                f = flips[it].to(self.rdt)
                hard = torch.complex(hard.real * f[..., 0], hard.imag * f[..., 1])
            nb = torch.roll(hard, 1, dims=-2) + torch.roll(hard, -1, dims=-2)
            V = torch.fft.fft(r(nb), dim=-1) * self.ic_taps
            d = torch.fft.ifft(r(S - V), dim=-1)
        return d

    def receive(self, bursts: torch.Tensor, ic_iterations: int = 2,
                flips: torch.Tensor | None = None, margins: bool = False) -> dict:
        """(B, frame_len) bursts aligned at the full-preamble start -> data
        (B, n_data), snr_lin (B,), channel (B, N); ``flips`` and, with
        ``margins``, the decisions' margins (ic_iterations, B, K, M, 2) as
        ``demodulate`` has them."""
        bursts = bursts.to(self.device, self.cdt)
        chan, snr = self.estimate(bursts)
        fs = self.preamble_len + self.cp
        kept = [] if margins else None
        d = self.demodulate(bursts[:, fs : fs + self.N], chan, ic_iterations, flips, kept)
        out = {"data": self.data_from_grid(d), "snr_lin": snr, "channel": chan}
        if margins:
            out["margins"] = torch.stack(kept) if kept else None
        return out

    def tie_variants(self, bursts: torch.Tensor, margins: torch.Tensor, tie: float,
                     most: int = 8, ic_iterations: int = 2) -> tuple:
        """The answers a receiver that rounds differently may give as well:
        for each decision of a burst within ``tie`` of its boundary (at most
        ``most`` a burst and IC pass, the nearest first), the burst received
        again with that one decision flipped. Returns (burst index (V,),
        IC pass (V,), data (V, n_data)); V may be 0."""
        n_pass, B = margins.shape[:2]
        m = margins.reshape(n_pass, B, -1)
        near, order = torch.sort(m, dim=-1)
        near, order = near[..., :most], order[..., :most]
        passes, which, rank = torch.nonzero(near < tie, as_tuple=True)
        if not which.numel():
            return which, passes, torch.zeros((0, self.n_data), dtype=self.cdt,
                                              device=self.device)
        V = which.numel()
        flips = torch.ones((n_pass, V, m.shape[-1]), dtype=torch.int8, device=m.device)
        flips[passes, torch.arange(V, device=m.device), order[passes, which, rank]] = -1
        flips = flips.reshape((n_pass, V) + tuple(margins.shape[2:]))
        got = self.receive(bursts[which], ic_iterations, flips=flips)
        return which, passes, got["data"]

    def link(self, data: torch.Tensor, ic_iterations: int = 2) -> dict:
        """The clean loopback: transmit, then receive."""
        return self.receive(self.transmit(data), ic_iterations)
