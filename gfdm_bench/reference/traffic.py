"""The benchmark's traffic: payloads and burst-bearing chunk streams.

Everything is drawn from a ``torch.Generator`` seeded with the run's seed,
on the device the generator lives on, in a few large calls; every burst is
built by the reference modulator (``waveform.Waveform.transmit``), so both
the program and the reference are handed the same samples.

``impaired_chunks`` is the receive service's impaired stream (the stream
``gfdm_tpu_torch.entry.service_stream`` makes, rewritten here on the
reference modulator): per burst an 8-tap Rayleigh multipath with a 0.5 per
tap power-delay decay, normalized to unit energy, a residual CFO uniform in
+-``cfo_max`` subcarriers, AWGN at ``snr_db`` over the bursts' mean sample
power; per chunk 0, 1 or 2 bursts. Unlike ``service_stream``, which draws
each chunk's count, a batch holds the counts in the fixed shares
``density`` (a quarter empty, half one burst, a quarter two), shuffled by
the seed, so every seed serves the same number of bursts. A lone burst
starts anywhere in [0, chunk_len - cp_len); of two, the first in [0,
chunk_len / 3 - cp_len), the second in [chunk_len / 2 + frame_len / 2,
chunk_len - cp_len): every burst's preamble lies in the owned part, its
tail may run into the halo.
"""
from __future__ import annotations

import math

import torch

from .waveform import QPSK_AMP, Waveform


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % (1 << 64))
    return g


def qpsk_payload(batch: int, n_data: int, gen: torch.Generator,
                 device=None) -> torch.Tensor:
    """(batch, 2, n_data) float32 planar QPSK symbols +-1/sqrt(2)."""
    device = gen.device if device is None else device
    bits = torch.randint(0, 2, (batch, 2, n_data), generator=gen, device=device)
    return (bits.to(torch.float32) * 2.0 - 1.0) * QPSK_AMP


def _counts(n_chunks: int, density, gen: torch.Generator) -> torch.Tensor:
    """Per-chunk burst counts in the fixed shares ``density``, shuffled."""
    dev = gen.device
    sizes = [int(round(f * n_chunks)) for f in density]
    sizes[0] += n_chunks - sum(sizes)
    counts = torch.cat([torch.full((n,), c, dtype=torch.int64, device=dev)
                        for c, n in enumerate(sizes)])
    return counts[torch.randperm(n_chunks, generator=gen, device=dev)]


def impaired_chunks(wf: Waveform, n_chunks: int, chunk_len: int, gen: torch.Generator,
                    snr_db: float = 20.0, cfo_max: float = 0.2, taps: int = 8,
                    tap_decay: float = 0.5, density=(0.25, 0.5, 0.25)) -> dict:
    """One batch of halo-extended chunks.

    Returns ``chunks`` (n_chunks, 2, chunk_len + frame_len + cp_len) float32
    on the generator's device, and per burst, in placement order (chunk
    ascending, earlier position first): ``chunk``, ``pos`` (the burst's
    first sample in its chunk), ``payload`` (n_bursts, 2, n_data) float32.
    """
    dev = gen.device
    L, cp, K = wf.frame_len, wf.cp, wf.K
    ext = chunk_len + L + cp
    max_off = chunk_len - cp
    counts = _counts(n_chunks, density, gen)
    n_b = int(counts.sum())
    payload = qpsk_payload(n_b, wf.n_data, gen, dev)
    bursts = wf.transmit(payload).to(torch.complex128)  # (n_b, L)
    h = torch.complex(torch.randn((n_b, taps), generator=gen, device=dev, dtype=torch.float64),
                      torch.randn((n_b, taps), generator=gen, device=dev, dtype=torch.float64))
    h = h * (tap_decay ** torch.arange(taps, device=dev, dtype=torch.float64)) / math.sqrt(2.0)
    h = h / torch.linalg.vector_norm(h, dim=1, keepdim=True)
    n_fft = L + taps
    bc = torch.fft.ifft(torch.fft.fft(bursts, n_fft) * torch.fft.fft(h, n_fft))[:, : L + taps - 1]
    cfo = (torch.rand(n_b, generator=gen, device=dev, dtype=torch.float64) * 2 - 1) * cfo_max
    n = torch.arange(bc.shape[1], device=dev, dtype=torch.float64)
    bc = bc * torch.exp(2j * math.pi * cfo[:, None] * n / K)
    sig_power = float((bc.abs() ** 2).mean())
    noise_amp = math.sqrt(sig_power * 10 ** (-snr_db / 10) / 2)
    stream = noise_amp * torch.randn((n_chunks, 2, ext), generator=gen, device=dev,
                                     dtype=torch.float64)
    # positions: a lone burst anywhere it is owned, two split left / right
    u = torch.rand((n_chunks, 2), generator=gen, device=dev, dtype=torch.float64)
    lone = (u[:, 0] * max_off).long()
    first = (u[:, 0] * (chunk_len // 3 - cp)).long()
    lo2 = chunk_len // 2 + L // 2
    second = lo2 + (u[:, 1] * (max_off - lo2)).long()
    chunk = torch.repeat_interleave(torch.arange(n_chunks, device=dev), counts)
    rank = torch.arange(n_b, device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    two = counts[chunk] == 2
    pos = torch.where(two, torch.where(rank == 0, first[chunk], second[chunk]), lone[chunk])
    blen = bc.shape[1]
    flat = (chunk[:, None] * 2 * ext + pos[:, None] + torch.arange(blen, device=dev))
    view = stream.reshape(-1)
    view.index_add_(0, flat.reshape(-1), bc.real.reshape(-1))
    view.index_add_(0, (flat + ext).reshape(-1), bc.imag.reshape(-1))
    return {"chunks": stream.to(torch.float32), "chunk": chunk, "pos": pos,
            "payload": payload, "counts": counts}


def coded_chunks(wf: Waveform, n_chunks: int, chunk_len: int, gen: torch.Generator,
                 snr_db: float = 10.0, payload_bytes: int = 53) -> dict:
    """One batch of the coded service's stream: a CRC-framed, coded QPSK
    burst (``coding``) at the start of every ``chunk_len``-sample cycle,
    delayed by an offset drawn once a batch from [0, chunk_len - frame_len),
    AWGN at ``snr_db`` over the bursts' mean sample power, cut into
    ``n_chunks`` chunks with the lookahead halo (frame_len + cp_len) of the
    next cycle's samples.

    Returns ``chunks`` (n_chunks, 2, chunk_len + halo) float32, ``chunk``
    and ``pos`` (per burst, one a chunk) and ``info`` (n_chunks, n_info)
    uint8, the info bits each burst carries.
    """
    from . import coding

    dev = gen.device
    L, cp = wf.frame_len, wf.cp
    halo = L + cp
    n_coded = 2 * wf.n_data
    n_info = coding.info_bits(n_coded)
    data = torch.randint(0, 256, (n_chunks, payload_bytes), generator=gen, device=dev)
    info = coding.frames(data.to(torch.uint8).cpu().numpy(), n_info)
    coded = coding.conv_encode(info)[:, coding.interleaver(n_coded)]
    payload = torch.from_numpy(coding.qpsk_symbols(coded)).to(dev)
    bursts = wf.transmit(payload).to(torch.complex128)
    offset = int(torch.randint(0, chunk_len - L, (1,), generator=gen, device=dev))
    sig_power = float((bursts.abs() ** 2).mean())
    noise_amp = (sig_power * 10 ** (-snr_db / 10) / 2) ** 0.5
    total = (n_chunks + 1) * chunk_len
    stream = noise_amp * torch.randn((2, total), generator=gen, device=dev, dtype=torch.float64)
    at = (torch.arange(n_chunks, device=dev) * chunk_len + offset)[:, None] + torch.arange(
        L, device=dev)
    stream[0].index_add_(0, at.reshape(-1), bursts.real.reshape(-1))
    stream[1].index_add_(0, at.reshape(-1), bursts.imag.reshape(-1))
    chunks = stream.unfold(1, chunk_len + halo, chunk_len)[:, :n_chunks].transpose(0, 1)
    return {"chunks": chunks.to(torch.float32).contiguous(),
            "chunk": torch.arange(n_chunks, device=dev),
            "pos": torch.full((n_chunks,), offset, device=dev), "info": info}
