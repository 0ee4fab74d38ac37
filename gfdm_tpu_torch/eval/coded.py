"""Coded-link evaluation: conv-coded GFDM bursts, soft-decision decoding.

The port of ``gfdm_tpu.eval.coded``: ops.softbits produces max-log LLRs,
coding.viterbi_decode consumes them, and this harness measures the coded
BER against the uncoded link at equal Eb/N0 - the coding gain that
justifies the soft-output receiver. One burst carries one zero-terminated
codeword (468 QPSK symbols = 936 coded bits = 462 info bits at rate 1/2),
batched on ``device`` (default: the card; without one it raises): the
planar torch-op link, then the LLRs and the Viterbi decoder as torch ops.
The interleaver spreads faded-subcarrier error bursts under the multipath
channel. As in :mod:`.ber`, the info bits come from NumPy (the same bits
as the JAX package for a seed) and the taps and noise from a CPU
``torch.Generator`` seeded by ``seed + 17``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..coding import conv_encode, info_bits_for_block, interleaver, viterbi_decode
from ..config import GfdmConfig
from ..device import device_const, resolve_device
from ..ops.planar_pipeline import prepare, receive_bursts_planar, transmit_planar
from ..ops.softbits import qpsk_llrs_planar
from .ber import _add_noise, _apply_multipath, _unit_normal

__all__ = ["coded_ber_point", "coded_vs_uncoded"]

_SQRT2 = np.float32(2.0**0.5)


@lru_cache(maxsize=16)
def _coded_fn(cfg: GfdmConfig, ic_iterations: int, equalizer: str,
              channel: str, n_channel_taps: int):
    """The per-point coded link: ``(llrs_fn, fn, n_info, perm)``.

    ``llrs_fn(snr_db, coded_bits, noise, taps=None)``: (B, n_coded)
    interleaved coded bits -> planar QPSK -> Tx -> channel -> AWGN -> Rx ->
    deinterleaved (B, n_coded) LLRs; ``fn`` the same followed by the
    Viterbi decoder -> (B, n_info) bits. ``noise``: the (B, 2, frame_len)
    unit normal draws (the link runs on their device); ``taps``: the (B, 2,
    n_channel_taps) ones with channel="multipath"."""
    n_coded = 2 * cfg.n_data_symbols  # QPSK: 2 coded bits per symbol
    n_info = info_bits_for_block(n_coded)
    perm = interleaver(n_coded)
    inv_perm = np.argsort(perm)

    def llrs_fn(snr_db, coded_bits, noise, taps=None):
        dev = noise.device
        coded = torch.as_tensor(coded_bits, device=dev)
        pairs = coded.reshape(coded.shape[0], -1, 2)
        data = torch.movedim(1.0 - 2.0 * pairs.to(torch.float32), -1, -2)
        data = data / torch.tensor(_SQRT2, device=dev)  # (B, 2, n_data)
        bursts = transmit_planar(cfg, data)[:, 0, :, :]
        if channel == "multipath":
            bursts = _apply_multipath(taps, bursts, n_channel_taps)
        out = receive_bursts_planar(
            cfg, _add_noise(bursts, snr_db, noise), ic_iterations=ic_iterations,
            equalizer=equalizer,
        )
        # max-log LLRs from the estimated in-band SNR (unit-power QPSK)
        noise_var = 1.0 / torch.clamp(out["snr_lin"], min=1e-6)
        llrs = qpsk_llrs_planar(out["data"], noise_var)
        llrs = llrs.reshape(llrs.shape[0], -1)  # (B, n_coded)
        inv = device_const(("coded.inv_perm", n_coded), dev, lambda: inv_perm)
        return llrs.index_select(-1, inv)  # deinterleave

    def fn(snr_db, coded_bits, noise, taps=None):
        return viterbi_decode(llrs_fn(snr_db, coded_bits, noise, taps), n_info)

    return llrs_fn, fn, n_info, perm


def coded_ber_point(
    cfg: GfdmConfig,
    ebn0_db: float,
    bursts: int = 256,
    ic_iterations: int = 2,
    equalizer: str = "zf",
    channel: str = "awgn",
    n_channel_taps: int = 8,
    seed: int = 0,
    device=None,
) -> float:
    """Coded BER at one Eb/N0 point (dB), on ``device`` (default: the card).

    Es/N0 accounting: rate-1/2 QPSK carries 1 info bit per symbol, so
    Es/N0 = Eb/N0 and the channel SNR equals ``ebn0_db`` (the uncoded QPSK
    link at equal Eb/N0 runs 3 dB hotter: Es = 2 Eb).
    """
    dev = resolve_device(device, "coded_ber_point")
    prepare(cfg, device=dev)
    _, fn, n_info, perm = _coded_fn(cfg, int(ic_iterations), equalizer,
                                    str(channel), int(n_channel_taps))
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (bursts, n_info)).astype(np.uint8)
    coded = conv_encode(bits)[..., perm]  # interleave
    gen = torch.Generator().manual_seed(int(seed) + 17)
    taps = (_unit_normal(gen, (bursts, 2, n_channel_taps), dev)
            if channel == "multipath" else None)
    noise = _unit_normal(gen, (bursts, 2, cfg.frame_len), dev)
    dec = fn(float(ebn0_db), coded, noise, taps).cpu().numpy()
    return float(np.mean(dec != bits))


def coded_vs_uncoded(
    cfg: GfdmConfig,
    ebn0_db,
    bursts: int = 256,
    ic_iterations: int = 2,
    equalizer: str = "zf",
    channel: str = "awgn",
    n_channel_taps: int = 8,
    seed: int = 0,
    device=None,
):
    """Coded and uncoded BER over Eb/N0 points (equal-energy comparison).

    Returns dict with 'ebn0_db', 'coded_ber', 'uncoded_ber'. Uncoded QPSK
    at Eb/N0 x runs at channel SNR x + 3.01 dB (2 info bits per symbol).
    """
    from .ber import ber_sweep

    ebn0 = np.asarray(ebn0_db, dtype=np.float64)
    coded = [
        coded_ber_point(cfg, float(e), bursts=bursts,
                        ic_iterations=ic_iterations, equalizer=equalizer,
                        channel=channel, n_channel_taps=n_channel_taps,
                        seed=seed + i, device=device)
        for i, e in enumerate(ebn0)
    ]
    un = ber_sweep(cfg, ebn0 + 10 * np.log10(2.0), bursts_per_point=bursts,
                   ic_iterations=ic_iterations, equalizer=equalizer,
                   channel=channel, n_channel_taps=n_channel_taps, seed=seed,
                   device=device)
    return {
        "ebn0_db": ebn0,
        "coded_ber": np.asarray(coded),
        "uncoded_ber": un["ber"],
    }
