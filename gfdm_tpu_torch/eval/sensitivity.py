"""Modem sensitivity: the CODED SERVICE path swept over SNR.

The port of ``gfdm_tpu.eval.sensitivity``. This sweeps the actual modem -
StreamingReceiver(engine="fused", fec="conv"): detection, extraction, CFO
correction, channel estimation, equalization, IC, LLRs, Viterbi, CRC - over
burst SNR and reports, per point, the burst-detection rate, the CRC success
rate and the info-BER. The payloads, taps, CFOs, offsets and noise come
from NumPy in the reference's order, so a seed draws the same ones in both
packages. The bursts come from the port's transmit_planar on ``device``
(default: the card; without one it raises).
"""
from __future__ import annotations

import numpy as np

from ..config import GfdmConfig

__all__ = ["modem_sensitivity"]


def modem_sensitivity(
    cfg: GfdmConfig | None = None,
    snr_db=(4.0, 6.0, 8.0, 10.0, 12.0),
    bursts_per_point: int = 64,
    chunk_len: int = 2048,
    constellation: str = "qpsk",
    seed: int = 0,
    cfo_range: float = 0.0,
    channel: str = "awgn",
    n_channel_taps: int = 8,
    equalizer: str = "zf",
    device=None,
) -> dict:
    """Sweep the coded service over SNR.

    Returns {"snr_db", "found_rate", "crc_rate", "info_ber"} arrays. One
    burst per chunk at a random owned offset; CRC per the CLI conv framing;
    info-BER counted against the transmitted info bits over ALL transmitted
    bursts (a missed burst counts half its bits wrong).

    Impairments: ``cfo_range`` applies a per-burst uniform CFO in
    [-cfo_range, +cfo_range] subcarriers; ``channel="multipath"`` convolves
    each burst with an independent ``n_channel_taps``-tap exponential-PDP
    Rayleigh channel (pair with ``equalizer="mmse_cnr"``).
    """
    import torch

    from ..cli import burst_capacity_bytes, payload_to_symbols
    from ..coding import info_bits_for_block
    from ..device import resolve_device
    from ..ops.planar_pipeline import transmit_planar
    from ..ops.rx import constellation_points
    from ..runtime.service import StreamingReceiver
    from ..utils.framing import attach_crc32, check_crc32, pack_bits, unpack_bits

    dev = resolve_device(device, "modem_sensitivity")
    cfg = cfg or GfdmConfig()
    rng = np.random.default_rng(seed)
    order = int(np.log2(constellation_points(constellation).size))
    cap = burst_capacity_bytes(cfg, order, "conv")
    n_bits = order * cfg.n_data_symbols
    n_info = info_bits_for_block(n_bits)

    payload = bytes(rng.integers(0, 256, bursts_per_point * cap, dtype=np.uint8))
    syms, n_bursts = payload_to_symbols(cfg, payload, constellation, fec="conv")
    if n_bursts != bursts_per_point:
        raise RuntimeError(f"{n_bursts} bursts framed, expected {bursts_per_point}")
    tx_info = np.stack(
        [
            np.concatenate([
                unpack_bits(attach_crc32(payload[i * cap : (i + 1) * cap])),
                np.zeros(n_info - (cap + 4) * 8, np.uint8),
            ])
            for i in range(n_bursts)
        ]
    )
    planar = np.stack([syms.real, syms.imag], axis=1).astype(np.float32)
    bursts = transmit_planar(cfg, torch.from_numpy(planar).to(dev))[:, 0].cpu().numpy()
    bc0 = bursts[:, 0] + 1j * bursts[:, 1]
    halo = cfg.frame_len + cfg.cp_len

    rx = StreamingReceiver(cfg, chunk_len=chunk_len, batch_chunks=n_bursts,
                           engine="fused", fec="conv", constellation=constellation,
                           equalizer=equalizer, device=dev)
    found_rate, crc_rate, info_ber = [], [], []
    for snr in snr_db:
        bc = bc0
        if channel == "multipath":
            taps = (
                rng.standard_normal((n_bursts, n_channel_taps))
                + 1j * rng.standard_normal((n_bursts, n_channel_taps))
            ) * (0.5 ** np.arange(n_channel_taps)) / np.sqrt(2.0)
            taps /= np.linalg.norm(taps, axis=1, keepdims=True)
            L = bc.shape[1]
            H = np.fft.fft(taps, L + n_channel_taps, axis=1)
            bc = np.fft.ifft(
                np.fft.fft(bc, L + n_channel_taps, axis=1) * H, axis=1
            )[:, : L + n_channel_taps - 1]
        if cfo_range:
            f = rng.uniform(-cfo_range, cfo_range, n_bursts)
            bc = bc * np.exp(
                2j * np.pi * f[:, None] * np.arange(bc.shape[1]) / cfg.subcarriers
            )
        blen = bc.shape[1]
        sig = float(np.mean(np.abs(bc) ** 2))  # per-sample signal power
        na = np.sqrt(sig * 10 ** (-float(snr) / 10) / 2)
        chunks = (na * rng.standard_normal((n_bursts, 2, chunk_len + halo))
                  ).astype(np.float32)
        offs = rng.integers(0, chunk_len - cfg.cp_len, n_bursts)
        for i in range(n_bursts):
            chunks[i, 0, offs[i] : offs[i] + blen] += bc[i].real.astype(np.float32)
            chunks[i, 1, offs[i] : offs[i] + blen] += bc[i].imag.astype(np.float32)
        out = rx.step(chunks)
        found, bits = out["found"], out["bits"]
        errs = 0
        ok = 0
        for i in range(n_bursts):
            if not found[i]:
                errs += n_info // 2  # erased burst: half the bits wrong
                continue
            errs += int((bits[i] != tx_info[i]).sum())
            ok += check_crc32(pack_bits(bits[i][: (cap + 4) * 8]))[0]
        found_rate.append(found.mean())
        crc_rate.append(ok / n_bursts)
        info_ber.append(errs / (n_bursts * n_info))
    return {
        "snr_db": np.asarray(snr_db, dtype=np.float64),
        "found_rate": np.asarray(found_rate),
        "crc_rate": np.asarray(crc_rate),
        "info_ber": np.asarray(info_ber),
    }
