"""Plain burst detection, extraction and CFO refinement on chunk batches.

The golden model's Schmidl & Cox detector (``pygfdm.synchronization``) on a
batch of halo-extended chunks, with the receive service's decisions stated
plainly:

- the K-lag autocorrelation over a K window, normalized by the 2K-window
  energy (``ac = 2 P / E``), its magnitude integrated over cp_len + 1
  positions (``ic``), the 2K-tap cross-correlation with the unit-power core
  preamble (``cc``), the gated metric ``|cc| ic`` over the owned positions;
- up to ``k`` picks a chunk, strongest first, each suppressing the
  positions within one frame length of it;
- at each pick the CFO ``angle(ac) / 2 pi`` (subcarrier fractions), the
  scale ``sqrt(2K / E)``, the found decision: owned and ``ic`` above the
  false-alarm threshold (synchronization.threshold_factor) times the
  chunk's noise floor, the median of every eighth ``ic`` value, over the
  Rayleigh median-to-mean ratio;
- extraction of ``frame_len`` samples from ``cp_len`` before the pick
  (zeros outside the chunk), scaled and derotated by the CFO, then the
  fine CFO from the payload block's cyclic prefix (its second half against
  the block's end, an N-lag phase) taken out.

Every stage runs in float64 on the samples as the configuration's front-end
precision rounds them (``precision.rounder``); with ``trace_precision``
the three running sums (autocorrelation, energy, CP integration) are
rounded to it as well, where a front end that states that precision keeps
its traces in it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .precision import rounder
from .pygfdm.synchronization import threshold_factor
from .waveform import Waveform

RAYLEIGH_MEDIAN_TO_MEAN = math.sqrt(2.0 * math.log(2.0)) / math.sqrt(math.pi / 2.0)
FLOOR_STRIDE = 8


def _moving_sum(x: torch.Tensor, w: int, n_out: int) -> torch.Tensor:
    """out[n] = sum_{j=n}^{n+w-1} x[j], n < n_out (x along the last axis)."""
    c = torch.cumsum(torch.nn.functional.pad(x, (1, 0)), dim=-1)
    return c[..., w : w + n_out] - c[..., :n_out]


def _median_mid(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values."""
    v = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


class Detector:
    """Detection and extraction for one configuration at a chunk length."""

    def __init__(self, wf: Waveform, chunk_len: int, false_alarm_prob: float = 1e-5,
                 trace_precision: str | None = None):
        self.wf = wf
        r = rounder(trace_precision) if trace_precision else None
        self.rnd = (lambda x: r(x).to(torch.complex128 if x.is_complex() else torch.float64)
                    ) if r else (lambda x: x)
        self.chunk_len = int(chunk_len)
        self.threshold = threshold_factor(false_alarm_prob) / RAYLEIGH_MEDIAN_TO_MEAN
        p = wf.core_preamble / np.sqrt(np.mean(np.abs(wf.core_preamble) ** 2))
        self.pn = torch.as_tensor(p, device=wf.device)

    def traces(self, s: torch.Tensor) -> dict:
        """(n, T) complex128 chunks -> ac, energy, ic (n, T - 2K), gated
        (n, n_valid)."""
        K, cp = self.wf.K, self.wf.cp
        T = s.shape[-1]
        n_ac = T - 2 * K
        c = torch.conj(s[..., : T - K]) * s[..., K:]
        p = self.rnd(_moving_sum(c, K, n_ac))
        energy = self.rnd(_moving_sum(s.abs() ** 2, 2 * K, n_ac)).clamp_min(1e-30)
        ac = 2.0 * p / energy
        mag = torch.nn.functional.pad(ac.abs(), (cp, 0))
        ic = self.rnd(_moving_sum(mag, cp + 1, n_ac)) / (cp + 1)
        n_fft = 1 << int(math.ceil(math.log2(T + 2 * K)))
        spec = torch.fft.fft(s, n_fft, dim=-1) * torch.conj(torch.fft.fft(self.pn, n_fft))
        cc = torch.fft.ifft(spec, dim=-1)[..., : T - 2 * K + 1] / (2 * K)
        n_valid = min(n_ac, self.chunk_len)
        gated = cc[..., :n_valid].abs() * ic[..., :n_valid]
        return {"ac": ac, "energy": energy, "ic": ic, "gated": gated}

    def detect(self, s: torch.Tensor, k: int) -> dict:
        """(n, T) complex128 chunks -> per-slot (n * k,) start, cfo, scale,
        found, chunk-major, and the chunks' ``traces``."""
        tr = self.traces(s)
        g = tr["gated"].clone()
        pos = torch.arange(g.shape[-1], device=g.device)
        picks = []
        for _ in range(int(k)):
            nc = torch.argmax(g, dim=-1, keepdim=True)
            picks.append(nc)
            g = torch.where((pos - nc).abs() < self.wf.frame_len, 0.0, g)
        nc = torch.cat(picks, dim=-1)  # (n, k)
        ac = torch.gather(tr["ac"], -1, nc)
        energy = torch.gather(tr["energy"], -1, nc)
        ic_v = tr["ic"][..., : tr["gated"].shape[-1]]
        floor = _median_mid(ic_v[..., ::FLOOR_STRIDE])
        peak = torch.gather(ic_v, -1, nc)
        found = (nc < self.chunk_len) & (peak > self.threshold * floor[:, None])
        return {
            "start": nc.reshape(-1),
            "cfo": (torch.angle(ac) / (2 * math.pi)).reshape(-1),
            "scale": torch.sqrt(2 * self.wf.K / energy).reshape(-1),
            "found": found.reshape(-1),
            "traces": tr,
        }

    def at(self, tr: dict, slot_chunk: torch.Tensor, start: torch.Tensor) -> dict:
        """CFO and scale from the traces of chunk ``slot_chunk`` at ``start``
        (per slot): the detection's fields at a given position."""
        idx = start.reshape(-1, 1).clamp(0, tr["ac"].shape[-1] - 1)
        ac = torch.gather(tr["ac"][slot_chunk], -1, idx)[:, 0]
        energy = torch.gather(tr["energy"][slot_chunk], -1, idx)[:, 0]
        return {"cfo": torch.angle(ac) / (2 * math.pi),
                "scale": torch.sqrt(2 * self.wf.K / energy)}

    def extract(self, s: torch.Tensor, slot_chunk: torch.Tensor, start: torch.Tensor,
                scale: torch.Tensor, cfo: torch.Tensor) -> torch.Tensor:
        """(n, T) chunks -> (slots, frame_len) bursts from ``start - cp_len``,
        scaled, derotated by the CFO, then by the fine CFO."""
        wf = self.wf
        T, L = s.shape[-1], wf.frame_len
        padded = torch.nn.functional.pad(s, (wf.cp, L))
        st = start.clamp(0, T)
        idx = st[:, None] + torch.arange(L, device=s.device)
        burst = torch.gather(padded[slot_chunk], -1, idx) * scale[:, None]
        n = torch.arange(L, device=s.device, dtype=torch.float64)
        burst = burst * torch.exp(-2j * math.pi * cfo[:, None] * n / wf.K)
        return self.refine(burst)

    def refine(self, burst: torch.Tensor) -> torch.Tensor:
        wf = self.wf
        cp0 = wf.preamble_len + wf.cp // 2
        cp1 = wf.preamble_len + wf.cp
        z = torch.sum(torch.conj(burst[:, cp0:cp1]) * burst[:, cp0 + wf.N : cp1 + wf.N], dim=-1)
        fine = torch.angle(z) * (wf.K / (2 * math.pi * wf.N))
        n = torch.arange(burst.shape[-1], device=burst.device, dtype=torch.float64)
        return burst * torch.exp(-2j * math.pi * fine[:, None] * n / wf.K)
