"""Channel coding: rate-1/2 constraint-length-7 convolutional code + Viterbi.

The port of ``gfdm_tpu.coding``. The encoder, the interleaver and the
trellis tables are NumPy copies of the reference's; the interleaver is
arithmetic, not a PRNG stream, so a transmitter and a receiver on either
package derive the same permutation bit for bit. The soft-decision decoder
hands every mode's trellis to ``kernels.viterbi.decode``: on a card one
CUDA kernel runs the add-compare-select recursion and the traceback; on
the CPU its plain version runs the torch ops here, a loop over (collapsed)
trellis steps carrying the 64 path metrics of every codeword of the batch
as one (B, 64) tensor, the decisions stored as a uint8 (steps, B, 64)
tensor, then a ``torch.gather`` traceback. Both give the same bits. The
reference's TPU workarounds (G-step unrolled scan groups, the one-hot
gather-free traceback) are not ported; the decisions are the same.

Code: industry-standard polynomials (133, 171) octal, K=7, zero-terminated
(6 tail bits). Tap convention: bit j of the generator taps input x[t-j]
(LSB = current input); generator reversal preserves the distance spectrum
(free distance 10).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .device import as_tensor, device_const
from .kernels import viterbi as _kernel

__all__ = [
    "CONV_RATE",
    "CONV_TAIL_BITS",
    "conv_encode",
    "viterbi_decode",
    "interleaver",
    "coded_bits_per_block",
    "info_bits_for_block",
]

# windowed-decoder defaults: span = body + 2*overlap trellis steps per
# window; overlap 38 > the 5*K=35 truncation depth of the K=7 code
WINDOW_BODY = 52
WINDOW_OVERLAP = 38

_G = (0o133, 0o171)  # generator polynomials, LSB taps the current input
_K = 7
_NSTATES = 1 << (_K - 1)  # 64
CONV_RATE = 0.5
CONV_TAIL_BITS = _K - 1
_NEG = -1e30  # the metric of an unreachable state, as in the reference


def _parity(x: np.ndarray) -> np.ndarray:
    p = np.zeros_like(x)
    for _ in range(_K):
        p ^= x & 1
        x >>= 1
    return p


@lru_cache(maxsize=1)
def _trellis():
    """Predecessor/output tables indexed by NEXT state.

    state s = last 6 input bits, newest at LSB; consuming b:
    ns = ((s << 1) | b) & 63, so ns's LSB is the decoded bit and its two
    predecessors are (ns >> 1) and (ns >> 1) | 32.
    """
    ns = np.arange(_NSTATES)
    b = ns & 1
    prev = np.stack([ns >> 1, (ns >> 1) | (_NSTATES >> 1)], axis=1)  # (64, 2)
    w = (prev << 1) | b[:, None]  # 7-bit window for each transition
    outs = np.stack([_parity(w & g) for g in _G], axis=-1)  # (64, 2, 2)
    return prev.astype(np.int32), outs.astype(np.float32), b.astype(np.int32)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """(..., n) info bits {0,1} -> (..., 2*(n+6)) coded bits, interleaved
    c0[0] c1[0] c0[1] c1[1] ...; zero-terminated (the decoder assumes it)."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    x = np.concatenate(
        [
            np.zeros(bits.shape[:-1] + (_K - 1,), np.uint8),
            bits,
            np.zeros(bits.shape[:-1] + (_K - 1,), np.uint8),
        ],
        axis=-1,
    )
    T = n + CONV_TAIL_BITS
    out = np.zeros(bits.shape[:-1] + (T, 2), np.uint8)
    for ci, g in enumerate(_G):
        c = np.zeros(bits.shape[:-1] + (T,), np.uint8)
        for j in range(_K):
            if (g >> j) & 1:
                # tap x[t-j]; x is left-padded by K-1 zeros
                c ^= x[..., _K - 1 - j : _K - 1 - j + T]
        out[..., ci] = c
    return out.reshape(bits.shape[:-1] + (2 * T,))


@lru_cache(maxsize=8)
def _radix_tables(k: int):
    """Collapsed-trellis tables for radix-2^k ACS.

    Composing k trellis steps is exact (max-plus associativity): the state
    after k inputs is ns = ((p << k) | b_0..b_{k-1}) & 63 with the oldest
    new bit at the field's MSB, so ns has 2^k predecessors enumerated by the
    k bits j shifted out of p: p = (ns >> k) | (j << (6-k)). The table holds
    the 2k coded-bit signs each (ns, j) transition emits; the branch metric
    is their dot product with the 2k LLRs of the collapsed step. k = 1 is
    the plain trellis: its signs are 1 - 2 * _trellis()[1].
    """
    assert 1 <= k <= _K - 1
    ns = np.arange(_NSTATES)[:, None]
    j = np.arange(1 << k)[None, :]
    p = (ns >> k) | (j << ((_K - 1) - k))
    sgn = np.zeros((_NSTATES, 1 << k, 2 * k), np.float32)
    state = np.broadcast_to(p, (_NSTATES, 1 << k)).copy()
    for i in range(k):
        b = (ns >> (k - 1 - i)) & 1  # chronological: oldest new bit first
        w = (state << 1) | b
        for ci, g in enumerate(_G):
            sgn[..., 2 * i + ci] = 1.0 - 2.0 * _parity(w & g)
        state = w & (_NSTATES - 1)
    return sgn


@lru_cache(maxsize=8)
def _pattern_index(k: int) -> np.ndarray:
    """(64 * 2^k,) index of each (ns, j) transition's sign pattern among the
    2^(2k) columns of ``_pattern_sums``: bit 2k-1-m set where term m is
    negative."""
    neg = (_radix_tables(k) < 0).astype(np.int64)
    return (neg << np.arange(2 * k - 1, -1, -1)).sum(-1).reshape(-1)


def _pattern_sums(lt: torch.Tensor) -> torch.Tensor:
    """(S, B, m) LLRs -> (S, B, 2^m): column q holds the sum of the m LLRs
    with term i negated where bit m-1-i of q is set, added in the order
    i = 0, 1, ..., m-1. The signs are +-1, so every product is exact and
    the order is the only rounding; on LLRs of a dyadic grid every order
    gives the same sums."""
    p = lt[..., :1]
    p = torch.cat([p, -p], dim=-1)
    for i in range(1, lt.shape[-1]):
        li = lt[..., i : i + 1]
        p = torch.stack([p + li, p - li], dim=-1).flatten(-2)
    return p


def _forward(pat: torch.Tensor, idx: torch.Tensor, k: int, pm: torch.Tensor):
    """Radix-2^k add-compare-select over the S collapsed steps of ``pat``
    ((S, B, 4^k) pattern sums). Returns the final (B, 64) metrics and the
    (S, B, 64) uint8 decisions: the first j of the maxima (the reference's
    argmax; at k = 1 predecessor 0 on equal candidates)."""
    S, B = pat.shape[:2]
    n_hi, n_j = _NSTATES >> k, 1 << k
    decs = torch.empty((S, B, _NSTATES), dtype=torch.uint8, device=pat.device)
    for s in range(S):
        # branch metrics (B, hi, lo, j) for ns = (hi << k) | lo
        bm = pat[s].index_select(1, idx).view(B, n_hi, n_j, n_j)
        # predecessor p = (ns >> k) | (j << (6-k)) depends on (hi, j) only
        a = pm.view(B, n_j, n_hi).transpose(1, 2).unsqueeze(2)
        pm, dec = torch.max((a + bm).reshape(B, _NSTATES, n_j), dim=-1)
        decs[s].copy_(dec)
    return pm, decs


def _traceback(decs: torch.Tensor, state: torch.Tensor, k: int) -> torch.Tensor:
    """Trace the survivors back from ``state`` ((B,) int64, the state after
    the last step) through the (S, B, 64) decisions -> (B, S*k) uint8 bits,
    each step's k bits oldest first."""
    S, B = decs.shape[:2]
    states = torch.empty((S, B), dtype=torch.int64, device=decs.device)
    states[S - 1] = state
    for s in range(S - 1, 0, -1):
        j = decs[s].gather(1, states[s].unsqueeze(1)).squeeze(1)
        torch.bitwise_or(states[s] >> k, j << (_K - 1 - k), out=states[s - 1])
    shifts = torch.arange(k - 1, -1, -1, device=decs.device)
    bits = (states.t().unsqueeze(-1) >> shifts) & 1
    return bits.reshape(B, S * k).to(torch.uint8)


def _initial_metrics(B: int, device) -> torch.Tensor:
    pm = torch.full((B, _NSTATES), _NEG, dtype=torch.float32, device=device)
    pm[:, 0] = 0.0
    return pm


@lru_cache(maxsize=8)
def _window_plan(T: int, body: int, overlap: int) -> dict:
    """The windowed decoder's index tables (the reference's, as NumPy)."""
    span = body + 2 * overlap
    W = -(-T // body)  # windows, bodies tile [0, T)
    starts = np.clip(np.arange(W) * body - overlap, 0, T - span)
    t = np.arange(T)
    w_of_t = np.minimum(t // body, W - 1)
    pinned = starts == 0  # exact state-0 start (trellis origin)
    return {
        "span": span,
        "W": W,
        "time_idx": starts[:, None] + np.arange(span)[None, :],  # (W, span)
        "w_of_t": w_of_t,
        "pos_of_t": t - starts[w_of_t],
        # pinned windows concentrate on state 0; interior ones start uniform
        "pm0": np.where(pinned[:, None] & (np.arange(_NSTATES) != 0)[None, :],
                        np.float32(_NEG), np.float32(0.0)).astype(np.float32),
        # windows ending before T trace back from their best state; those
        # ending at T from the zero-terminated state 0
        "interior": starts + span != T,
    }


def _decode_windowed(lp: torch.Tensor, n_info: int, body: int, overlap: int):
    """Block-parallel (windowed) decoding: overlapping windows of
    ``body + 2*overlap`` trellis steps folded into the batch, each decoded
    by the one-step decoder; each output step comes from its owner window's
    body. Interior windows trace back from the first arg-max of their last
    metrics, windows ending at T from the zero-terminated state 0."""
    B, T = lp.shape[:2]
    plan = _window_plan(T, body, overlap)
    width, W, dev = plan["span"], plan["W"], lp.device

    def const(name):
        return device_const(("window", T, body, overlap, name), dev, lambda: plan[name])

    wl = lp[:, const("time_idx")].reshape(B * W, width, 2)  # windows folded into the batch
    pm0 = const("pm0").expand(B, W, _NSTATES).reshape(B * W, _NSTATES)
    from_argmax = const("interior").expand(B, W).reshape(B * W)
    bits = _kernel.decode(wl, 1, pm0, from_argmax).view(B, W, width)
    return bits[:, const("w_of_t"), const("pos_of_t")][:, :n_info]


def viterbi_decode(llrs, n_info: int, mode: str = "auto", device=None):
    """Soft-decision Viterbi: (..., 2*(n_info+6)) LLRs -> (..., n_info) bits.

    LLR convention: positive favors bit 0 (ops.softbits). The sequence must
    be zero-terminated (conv_encode appends the 6 tail bits). Returns a
    uint8 tensor on the LLRs' device: a tensor stays where it is, anything
    else goes to ``device`` (default: the card; without one it raises).
    Path metrics are float32 whatever the LLRs' dtype.

    ``mode``:
    - "radix" (= "auto" when a k in (4, 3, 2) divides the trellis length
      T = n_info + 6; the first that does): radix-2^k collapsed ACS, exact
      ML decisions in T/k steps. "radix" raises ValueError where none
      divides T.
    - "full": one trellis step a step (exact ML); the "auto" fallback.
    - "sm": the reference's state-major TPU layout, whose decisions equal
      "full"'s; here it runs the "full" code.
    - "windowed": block-parallel truncated decoding (WINDOW_BODY /
      WINDOW_OVERLAP); ValueError for T < WINDOW_BODY + 2*WINDOW_OVERLAP.
    """
    n_info = int(n_info)
    T = n_info + CONV_TAIL_BITS
    if mode in ("auto", "radix"):
        k = next((kk for kk in (4, 3, 2) if T % kk == 0), 1)
        if k == 1 and mode == "radix":
            raise ValueError(f"no radix k in (4,3,2) divides T={T}")
    elif mode in ("full", "sm"):
        k = 1
    elif mode == "windowed":
        if T < WINDOW_BODY + 2 * WINDOW_OVERLAP:
            raise ValueError(f"trellis too short for windowed decoding (T={T})")
    else:
        raise ValueError(f"unknown viterbi mode {mode!r}")
    x = as_tensor(llrs, device, "viterbi_decode")
    lead = tuple(x.shape[:-1])
    if x.shape[-1] != 2 * T:
        raise ValueError(
            f"viterbi_decode: {x.shape[-1]} LLRs a codeword, expected 2*(n_info+6) = {2 * T}"
        )
    lp = x.to(torch.float32).reshape(-1, T, 2).contiguous()
    if mode == "windowed":
        bits = _decode_windowed(lp, n_info, WINDOW_BODY, WINDOW_OVERLAP)
    else:
        bits = _kernel.decode(lp, k)[:, :n_info]
    return bits.reshape(lead + (n_info,))


def interleaver(n: int, seed: int = 0x1EAF) -> np.ndarray:
    """Fixed interleaver permutation of length n.

    Spreads a faded subcarrier's burst errors across the codeword so the
    Viterbi decoder sees near-independent errors. Apply as coded[..., perm];
    invert with np.argsort(perm).

    Computed arithmetically (golden-ratio coprime stride + seed rotation),
    NOT from a PRNG stream: a tx and rx on different NumPy versions must
    derive the identical permutation over a real link. Adjacent coded bits
    land ~0.382*n apart - the best-possible low-discrepancy spacing for a
    fixed stride."""
    if n <= 1:
        return np.arange(max(n, 0))
    stride = max(1, round(n * (np.sqrt(5.0) - 1.0) / 2.0))
    while np.gcd(stride, n) != 1:
        stride -= 1
    return (seed + stride * np.arange(n, dtype=np.int64)) % n


def coded_bits_per_block(n_info: int) -> int:
    """Codeword length for ``n_info`` info bits (rate 1/2 + 6 tail bits)."""
    return 2 * (n_info + CONV_TAIL_BITS)


def info_bits_for_block(n_coded: int) -> int:
    """Largest info-bit count whose codeword fits in ``n_coded`` bits."""
    return n_coded // 2 - CONV_TAIL_BITS
