"""Coded 64-QAM: the Gray map, the receiver deciding on it, max-log soft
bits over its 64 points, and the coded 64-QAM service's traffic.

Restated from the definitions, in PyTorch float64:

- the map: square Gray 64-QAM, 6 coded bits a symbol, most significant
  first; the first three choose the in-phase level, the last three the
  quadrature level; the level of 3-bit label g is -7 + 2 i where i is the
  level's place from the bottom and g = i ^ (i >> 1) (binary-reflected
  Gray: neighbouring levels differ in one bit), all over sqrt(42), the
  mean energy of the odd-integer 8 x 8 grid, for unit mean energy;
- ``QamWaveform``: ``waveform.Waveform`` with the interference
  cancellation deciding on that grid (each part sliced to the nearest odd
  level of -7..7, the level at or above an even boundary taken), four
  passes unless told otherwise; a decision's margin is its part's
  distance to the nearest level boundary (the even integers -6..6 over
  sqrt(42)), and a flipped decision is the level on the other side of
  that boundary; ``QamWaveform.nearest_answer`` gives the answer nearest
  a given one among the reference's own and those with a few near-tie
  decisions flipped;
- ``maxlog_llrs``: per coded bit, the least squared distance to a point
  whose label has the bit set less the least to one with it clear, over
  the noise variance 1 / max(snr, 1e-6) (positive favours 0);
- ``coded_qam_chunks``: the service's stream, ``coding``'s CRC-32
  framing, K = 7 rate-1/2 code and interleaver over 6 n_data coded bits.

Where this departs from gr-gfdm: gr-gfdm's advanced receiver decides with
a gr-digital constellation object (lib/advanced_receiver_kernel_cc.cc:
109-123), which picks the nearest point of the whole constellation: on a
square grid that is the same point as slicing each part, except for
which side an exact boundary value goes to. gr-gfdm has no soft demapper
or channel code; the LLRs, the code and the framing are the receive
service's users' (the command-line modem's ``--fec conv``), and the Gray
labelling is the one pygfdm's square QAM mapping uses.

Nothing here imports the program under test. TF32 is off for every
product this module runs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import coding
from .waveform import Waveform

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BITS = 6  # coded bits a symbol
AXIS_BITS = BITS // 2
TOP = (1 << AXIS_BITS) - 1  # the outermost odd level, 7
SCALE = math.sqrt(42.0)  # sqrt of the mean energy of the odd-integer grid
IC_ITERATIONS = 4


def axis_levels() -> np.ndarray:
    """(8,) the odd level of each 3-bit Gray label."""
    levels = np.empty(1 << AXIS_BITS)
    for i in range(1 << AXIS_BITS):
        levels[i ^ (i >> 1)] = 2 * i - TOP
    return levels


def points() -> np.ndarray:
    """(64,) complex128 unit-energy points, index = the 6-bit label."""
    lv = axis_levels()
    idx = np.arange(1 << BITS)
    return (lv[idx >> AXIS_BITS] + 1j * lv[idx & ((1 << AXIS_BITS) - 1)]) / SCALE


def labels() -> np.ndarray:
    """(64, 6) the bits of each point's label, most significant first."""
    shifts = np.arange(BITS - 1, -1, -1)
    return (np.arange(1 << BITS)[:, None] >> shifts) & 1


def map_bits(coded: np.ndarray) -> np.ndarray:
    """(B, 6 n) bits -> (B, 2, n) float32 planar symbols."""
    b = np.asarray(coded, np.int64).reshape(coded.shape[0], -1, BITS)
    idx = b @ (1 << np.arange(BITS - 1, -1, -1))
    s = points()[idx]
    return np.stack([s.real, s.imag], axis=1).astype(np.float32)


def slice_levels(x: torch.Tensor) -> torch.Tensor:
    """Real values in level units -> the nearest odd level, clamped to
    +-7; a value on an even boundary goes to the level above."""
    return (2.0 * torch.floor(x / 2.0) + 1.0).clamp(-TOP, TOP)


def boundaries(x: torch.Tensor) -> torch.Tensor:
    """Real values in level units -> the nearest level boundary (an even
    integer in -6..6)."""
    return (2.0 * torch.round(x / 2.0)).clamp(1 - TOP, TOP - 1)


def decide(d: torch.Tensor) -> torch.Tensor:
    """Complex estimates -> the nearest grid points (unit energy)."""
    s = torch.view_as_real(d.to(torch.complex128)) * SCALE
    return torch.view_as_complex(slice_levels(s).contiguous()) / SCALE


class QamWaveform(Waveform):
    """The reference link with 64-QAM decisions in the cancellation, over
    ``ic_iterations`` passes unless a call says otherwise."""

    def __init__(self, shape: dict, device="cpu", precision: str = "float64",
                 ic_operand: str | None = None, ic_iterations: int = IC_ITERATIONS):
        super().__init__(shape, device, precision, ic_operand)
        self.ic_iterations = int(ic_iterations)

    def decide(self, d: torch.Tensor) -> torch.Tensor:
        """64-QAM decisions, zero off the active subcarriers; (B, K, M)."""
        return (decide(d).to(d.dtype) * self.active[:, None])

    def demodulate(self, frame: torch.Tensor, chan: torch.Tensor, ic_iterations: int,
                   flips: torch.Tensor | None = None, margins: list | None = None,
                   held: torch.Tensor | None = None, tie: float = 0.0):
        """``Waveform.demodulate`` on the 64-QAM grid: a margin is a part's
        distance to its nearest level boundary, and a flip (-1) moves that
        part's decision to the level across that boundary. ``held`` (bool,
        shaped as ``flips``) flips a part in those passes where its margin,
        on the path the passes take, lies within ``tie``."""
        r, L, B = self.rnd, self.L, frame.shape[0]
        X = torch.fft.fft(r(frame), dim=-1) / r(chan)
        Xg = r(X).reshape(B, self.K, self.M)
        S = torch.zeros_like(Xg)
        for i in range(L):
            part = self.rx_parts[(i + L // 2) % L]
            S = S + torch.roll(Xg, -(i - L // 2), dims=-2) * part
        S = r(S)
        d = torch.fft.ifft(S, dim=-1)
        act = self.active[:, None, None]
        for it in range(ic_iterations):
            x = torch.view_as_real(d.to(torch.complex128)) * SCALE  # (B, K, M, 2)
            level = slice_levels(x)
            edge = boundaries(x)
            margin = torch.where(act, (x - edge).abs() / SCALE, math.inf)
            if margins is not None:
                margins.append(margin)
            flip = torch.zeros_like(level, dtype=torch.bool)
            if flips is not None:
                flip |= flips[it] < 0
            if held is not None:
                flip |= held[it] & (margin < tie)
            level = torch.where(flip, 2.0 * edge - level, level)
            hard = torch.view_as_complex(level.contiguous()).to(d.dtype) / SCALE
            hard = hard * self.active[:, None]
            nb = torch.roll(hard, 1, dims=-2) + torch.roll(hard, -1, dims=-2)
            V = torch.fft.fft(r(nb), dim=-1) * self.ic_taps
            d = torch.fft.ifft(r(S - V), dim=-1)
        return d

    def receive(self, bursts: torch.Tensor, ic_iterations: int | None = None,
                flips: torch.Tensor | None = None, margins: bool = False) -> dict:
        ic = self.ic_iterations if ic_iterations is None else ic_iterations
        return super().receive(bursts, ic, flips, margins)

    def _answer(self, bursts: torch.Tensor, flips: torch.Tensor, held: torch.Tensor,
                tie: float) -> tuple:
        """``receive``'s data, and the margins on the path taken, with
        ``flips`` and ``held`` as ``demodulate`` takes them."""
        bursts = bursts.to(self.device, self.cdt)
        chan, _snr = self.estimate(bursts)
        fs = self.preamble_len + self.cp
        kept: list = []
        d = self.demodulate(bursts[:, fs : fs + self.N], chan, self.ic_iterations, flips, kept,
                            held, tie)
        return self.data_from_grid(d), torch.stack(kept)

    def nearest_answer(self, bursts: torch.Tensor, data: torch.Tensor,
                       margins: torch.Tensor, target: torch.Tensor, tie: float,
                       most: int = 8, flips: int = 4, rows: int = 4096) -> torch.Tensor:
        """The answers a receiver that rounds otherwise may give, nearest
        (rms) to ``target``: for each of the S ``bursts`` ((S, frame_len);
        ``data`` and ``margins`` ((n_pass, S, K, M, 2)) from ``receive``),
        its own answer or one with up to ``flips`` near-tie decisions
        flipped, added one at a time while each brings the answer nearer.

        A near tie is a decision within ``tie`` of its boundary on the path
        the passes take with the flips chosen so far (``most`` a pass, the
        nearest first): a flip moves the neighbours' estimates in the next
        pass, and so may make or unmake a near tie in the passes after it.
        Each is tried flipped in its own pass alone, and flipped there and
        in every later pass where it is again within ``tie`` (held): where
        the cancellation repeats an estimate, its near tie recurs, in the
        next pass once it has converged or every other pass while the
        neighbours' decisions alternate, and a receiver that rounds it the
        other way does so each time. Returns (S, n_data)."""
        n_pass, S = margins.shape[:2]
        shape = tuple(margins.shape[2:])
        dev = margins.device
        now = margins.reshape(n_pass, S, -1).transpose(0, 1).clone()  # (S, n_pass, P)
        P = now.shape[-1]
        fixed = torch.zeros((S, n_pass, P), dtype=torch.bool, device=dev)
        hold = torch.zeros_like(fixed)
        best = data.to(torch.complex128).clone()
        dist = (target - best).abs().pow(2).mean(-1)
        open_ = torch.ones(S, dtype=torch.bool, device=dev)
        passes = torch.arange(n_pass, device=dev)
        for _ in range(flips):
            near, order = torch.sort(torch.where(fixed | hold, math.inf, now), dim=-1)
            ok = (near[..., :most] < tie) & open_[:, None, None]
            s_idx, t_idx, r_idx = torch.nonzero(ok, as_tuple=True)
            if not s_idx.numel():
                break
            p_idx = order[s_idx, t_idx, r_idx]
            V = s_idx.numel()
            s2, t2, p2 = s_idx.repeat(2), t_idx.repeat(2), p_idx.repeat(2)
            v = torch.arange(2 * V, device=dev)
            fx, hd = fixed[s2], hold[s2]
            fx[v, t2, p2] = True
            later = (passes[None, :] > t2[:, None]) & (v >= V)[:, None]  # (2V, n_pass)
            hd[v[:, None], passes[None, :], p2[:, None]] |= later
            got_d, got_m = [], []
            for r0 in range(0, 2 * V, rows):
                fl = torch.where(fx[r0 : r0 + rows], -1, 1).to(torch.int8).transpose(0, 1)
                hl = hd[r0 : r0 + rows].transpose(0, 1)
                d_, m_ = self._answer(bursts[s2[r0 : r0 + rows]],
                                      fl.reshape((n_pass, fl.shape[1]) + shape),
                                      hl.reshape((n_pass, hl.shape[1]) + shape), tie)
                got_d.append(d_)
                got_m.append(m_.reshape(n_pass, -1, P).transpose(0, 1))
            alt = torch.cat(got_d).to(torch.complex128)
            d = (target[s2] - alt).abs().pow(2).mean(-1)
            low = torch.full((S,), math.inf, dtype=d.dtype, device=dev).scatter_reduce(
                0, s2, d, reduce="amin")
            win = torch.nonzero((d == low[s2]) & (d < dist[s2]), as_tuple=True)[0]
            s_win = torch.unique(s2[win])
            open_ &= torch.isin(torch.arange(S, device=dev), s_win)
            if not s_win.numel():
                break
            keep = torch.full((S,), 2 * V, dtype=torch.long, device=dev).scatter_reduce(
                0, s2[win], win, reduce="amin")[s_win]  # the first nearest a slot
            fixed[s_win], hold[s_win] = fx[keep], hd[keep]
            best[s_win], dist[s_win] = alt[keep], d[keep]
            now[s_win] = torch.cat(got_m)[keep]
        return best

    def link(self, data: torch.Tensor, ic_iterations: int | None = None) -> dict:
        return super().link(data, ic_iterations)


def maxlog_llrs(data: torch.Tensor, snr_lin: torch.Tensor, rows: int = 512) -> torch.Tensor:
    """(B, n) complex symbols, (B,) SNRs -> (B, 6 n) float64 max-log LLRs
    over the noise variance 1 / max(snr, 1e-6), in blocks of ``rows``."""
    dev = data.device
    pts = torch.as_tensor(points(), device=dev)
    has = torch.as_tensor(labels().T.astype(bool), device=dev)  # (6, 64)
    far = torch.tensor(math.inf, dtype=torch.float64, device=dev)
    nv = 1.0 / snr_lin.to(torch.float64).clamp_min(1e-6)
    out = []
    for r0 in range(0, data.shape[0], rows):
        s = data[r0 : r0 + rows].to(torch.complex128)
        dist = (s[..., None] - pts).abs().pow(2)[..., None, :]  # (b, n, 1, 64)
        d1 = torch.where(has, dist, far).amin(-1)
        d0 = torch.where(~has, dist, far).amin(-1)
        llr = (d1 - d0) / nv[r0 : r0 + rows, None, None]
        out.append(llr.reshape(s.shape[0], -1))
    return torch.cat(out) if out else torch.zeros((0, BITS * data.shape[1]),
                                                  dtype=torch.float64, device=dev)


def coded_qam_chunks(wf: Waveform, n_chunks: int, chunk_len: int, gen: torch.Generator,
                     snr_db: float = 20.0, cfo_max: float = 0.2,
                     payload_bytes: int = 170) -> dict:
    """One batch of the coded 64-QAM service's stream: a CRC-framed burst
    (``coding.frames``, ``conv_encode``, ``interleaver`` over 6 n_data
    coded bits, ``map_bits``) at the start of every ``chunk_len``-sample
    cycle, delayed by an offset drawn once a batch from [0, chunk_len -
    frame_len); each burst turned by its own CFO, uniform in
    +-``cfo_max`` subcarrier spacings from its first sample; AWGN at
    ``snr_db`` over the bursts' mean sample power; cut into ``n_chunks``
    chunks with the lookahead halo (frame_len + cp_len) of the next
    cycle's samples.

    Returns ``chunks`` (n_chunks, 2, chunk_len + halo) float32, ``chunk``
    and ``pos`` (per burst, one a chunk) and ``info`` (n_chunks, n_info)
    uint8, the info bits each burst carries.
    """
    dev = gen.device
    L, cp, K = wf.frame_len, wf.cp, wf.K
    halo = L + cp
    n_coded = BITS * wf.n_data
    n_info = coding.info_bits(n_coded)
    data = torch.randint(0, 256, (n_chunks, payload_bytes), generator=gen, device=dev)
    info = coding.frames(data.to(torch.uint8).cpu().numpy(), n_info)
    coded = coding.conv_encode(info)[:, coding.interleaver(n_coded)]
    payload = torch.from_numpy(map_bits(coded)).to(dev)
    bursts = wf.transmit(payload).to(torch.complex128)
    cfo = (torch.rand(n_chunks, generator=gen, device=dev, dtype=torch.float64) * 2 - 1) * cfo_max
    n = torch.arange(L, device=dev, dtype=torch.float64)
    bursts = bursts * torch.exp(2j * math.pi * cfo[:, None] * n / K)
    offset = int(torch.randint(0, chunk_len - L, (1,), generator=gen, device=dev))
    sig_power = float((bursts.abs() ** 2).mean())
    noise_amp = (sig_power * 10 ** (-snr_db / 10) / 2) ** 0.5
    total = (n_chunks + 1) * chunk_len
    stream = noise_amp * torch.randn((2, total), generator=gen, device=dev, dtype=torch.float64)
    at = (torch.arange(n_chunks, device=dev) * chunk_len + offset)[:, None] + n.long()
    stream[0].index_add_(0, at.reshape(-1), bursts.real.reshape(-1))
    stream[1].index_add_(0, at.reshape(-1), bursts.imag.reshape(-1))
    chunks = stream.unfold(1, chunk_len + halo, chunk_len)[:, :n_chunks].transpose(0, 1)
    return {"chunks": chunks.to(torch.float32).contiguous(),
            "chunk": torch.arange(n_chunks, device=dev),
            "pos": torch.full((n_chunks,), offset, device=dev), "info": info}
