"""CRC-framed, convolutionally coded payloads, and a plain soft Viterbi.

The framing of the coded receive service's users (the command-line modem's
``--fec conv``): each burst carries ``payload_bytes`` bytes followed by
their CRC-32 (zlib's polynomial, little-endian), as MSB-first bits, padded
with zeros to the code's info length, encoded by the rate-1/2 K = 7
convolutional code (generators 133, 171 octal, zero-terminated), the coded
bits permuted by the golden-ratio interleaver and mapped two to a QPSK
symbol (first bit on the real part, second on the imaginary, 0 -> +).

The receiver side: max-log LLRs of QPSK symbols (positive favors 0), the
inverse permutation, and a plain Viterbi over the 64-state trellis, one
trellis step at a time, batched over bursts, in float64; a CRC check of
the decoded frame. Nothing here imports the program under test.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

K = 7
G = (0o133, 0o171)
TAIL = K - 1
N_STATES = 1 << (K - 1)


def info_bits(n_coded: int) -> int:
    """The longest info block whose zero-terminated codeword fits."""
    return n_coded // 2 - TAIL


def interleaver(n: int, seed: int = 0x1EAF) -> np.ndarray:
    """Golden-ratio stride permutation (coprime to n) rotated by ``seed``;
    coded[..., perm] interleaves."""
    if n <= 1:
        return np.arange(max(n, 0))
    stride = max(1, round(n * (np.sqrt(5.0) - 1.0) / 2.0))
    while np.gcd(stride, n) != 1:
        stride -= 1
    return (seed + stride * np.arange(n, dtype=np.int64)) % n


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """(..., n) info bits -> (..., 2 (n + 6)) coded bits c0[0] c1[0] c0[1] ...;
    generator bit j taps the input j steps back."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    pad = np.zeros(bits.shape[:-1] + (K - 1,), np.uint8)
    x = np.concatenate([pad, bits, pad], axis=-1)
    T = n + TAIL
    out = np.zeros(bits.shape[:-1] + (T, 2), np.uint8)
    for ci, g in enumerate(G):
        for j in range(K):
            if (g >> j) & 1:
                out[..., ci] ^= x[..., K - 1 - j : K - 1 - j + T]
    return out.reshape(bits.shape[:-1] + (2 * T,))


def frames(payloads: np.ndarray, n_info: int) -> np.ndarray:
    """(B, payload_bytes) uint8 -> (B, n_info) info bits: payload ++ CRC-32,
    MSB first, zero padded."""
    B = payloads.shape[0]
    crc = np.array([zlib.crc32(p.tobytes()) for p in payloads], dtype="<u4")
    framed = np.concatenate([payloads, crc.view(np.uint8).reshape(B, 4)], axis=1)
    bits = np.unpackbits(framed, axis=1)
    if bits.shape[1] > n_info:
        raise ValueError("payload and CRC exceed the code's info length")
    return np.concatenate([bits, np.zeros((B, n_info - bits.shape[1]), np.uint8)], axis=1)


def crc_ok(info: np.ndarray, payload_bytes: int) -> np.ndarray:
    """(B, n_info) decoded bits -> (B,) whether the frame's CRC-32 holds."""
    n = 8 * (payload_bytes + 4)
    framed = np.packbits(np.asarray(info, np.uint8)[:, :n], axis=1)
    return np.array([zlib.crc32(f[:-4].tobytes()).to_bytes(4, "little") == f[-4:].tobytes()
                     for f in framed])


def qpsk_symbols(coded: np.ndarray) -> np.ndarray:
    """(B, 2 n) bits -> (B, 2, n) float32 planar QPSK, +-1/sqrt(2)."""
    b = coded.reshape(coded.shape[0], -1, 2).astype(np.float32)
    return np.stack([1 - 2 * b[..., 0], 1 - 2 * b[..., 1]], axis=1) * np.float32(2**-0.5)


def qpsk_llrs(data: torch.Tensor, snr_lin: torch.Tensor) -> torch.Tensor:
    """(B, n) complex symbols, (B,) SNRs -> (B, 2 n) max-log LLRs over the
    noise variance 1 / max(snr, 1e-6): for Gray QPSK 2 sqrt(2) x / var."""
    nv = 1.0 / snr_lin.clamp_min(1e-6)
    k = (2.0 * 2**0.5 / nv.clamp_min(1e-12))[:, None]
    return torch.stack([data.real * k, data.imag * k], dim=-1).reshape(data.shape[0], -1)


def _trellis():
    """For each next state ns: its two predecessors and their outputs."""
    ns = np.arange(N_STATES)
    b = ns & 1
    prev = np.stack([ns >> 1, (ns >> 1) | (N_STATES >> 1)], axis=1)
    w = (prev << 1) | b[:, None]

    def parity(x):
        return np.array([bin(v).count("1") & 1 for v in x.reshape(-1)]).reshape(x.shape)

    outs = np.stack([parity(w & g) for g in G], axis=-1)  # (64, 2 preds, 2 outputs)
    return prev, outs, b


def viterbi(llrs: torch.Tensor, n_info: int) -> torch.Tensor:
    """(B, 2 (n_info + 6)) LLRs -> (B, n_info) uint8 ML bits of a
    zero-terminated codeword (max-log branch metrics: a coded bit c adds
    +llr/2 for 0 and -llr/2 for 1)."""
    dev = llrs.device
    prev, outs, bit = (torch.as_tensor(a, device=dev) for a in _trellis())
    sgn = (1.0 - 2.0 * outs.to(torch.float64))  # (64, 2, 2)
    T = n_info + TAIL
    lp = llrs.to(torch.float64).reshape(-1, T, 2)
    B = lp.shape[0]
    pm = torch.full((B, N_STATES), -1e300, dtype=torch.float64, device=dev)
    pm[:, 0] = 0.0
    decisions = []
    for t in range(T):
        bm = 0.5 * torch.einsum("bc,spc->bsp", lp[:, t], sgn)  # (B, 64, 2)
        cand = pm[:, prev] + bm
        choice = torch.argmax(cand, dim=-1)  # ties to the first predecessor
        pm = torch.gather(cand, -1, choice[..., None])[..., 0]
        decisions.append(choice)
    state = torch.zeros(B, dtype=torch.long, device=dev)
    out = []
    for t in range(T - 1, -1, -1):
        out.append(bit[state])
        c = decisions[t].gather(1, state[:, None])[:, 0]
        state = prev[state, c]
    bits = torch.stack(out[::-1], dim=1)[:, :n_info]
    return bits.to(torch.uint8)
