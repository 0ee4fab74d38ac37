"""The least work a GFDM link step or receive-service step needs.

Worked out from a configuration's shapes alone: every K-, M-, N- and 2K-point
transform counts as an FFT, every sliding correlation of the detector as
running sums or overlap-save FFTs, every input byte is read once and every
output byte written once. No intermediate (the framed burst of a loopback,
a detection trace) counts as traffic: an implementation may keep it on chip.
So a later implementation of another kind (an FFT stage for a dense GEMM,
an estimate fused into a kernel) moves the time and leaves the count.

Flop counts, per the usual conventions: a complex n-point FFT
``34/9 n log2 n`` (the split-radix count, the lowest published for a power
of two, used for every n as an idealization); a complex multiply 6, a
complex add 2, a complex multiply by a real 2, a magnitude squared 3, a
complex divide 11 (a multiply by the conjugate, the magnitude, two real
divides).

Nothing here imports the program under test.
"""
from __future__ import annotations

import math

CMUL, CADD, RMUL, ABS2, CDIV = 6, 2, 2, 3, 11
FLOAT_BYTES = 4


def fft_flops(n: int) -> float:
    """A complex n-point FFT, split-radix count."""
    return 34.0 / 9.0 * n * math.log2(n) if n > 1 else 0.0


def _dims(shape: dict) -> dict:
    M, K, L = int(shape["timeslots"]), int(shape["subcarriers"]), int(shape["overlap"])
    n_active = int(shape["active_subcarriers"])
    cp, cs = int(shape["cp_len"]), int(shape["cs_len"])
    N = M * K
    pre = 2 * K + cp + cs
    return {"M": M, "K": K, "L": L, "N": N, "n_active": n_active, "cp": cp, "cs": cs,
            "n_data": M * n_active, "frame_len": pre + N + cp + cs, "n_est": n_active + 1}


def tx_flops(shape: dict) -> float:
    """One burst's transmitter: the active subcarriers' M-point FFTs, the
    L-tap overlap-add, the N-point IFFT, the window's two ramps."""
    d = _dims(shape)
    M, N, L = d["M"], d["N"], d["L"]
    return (d["n_active"] * fft_flops(M) + L * N * CMUL + (L - 1) * N * CADD
            + fft_flops(N) + 2 * d["cs"] * RMUL)


def rx_flops(shape: dict, ic_iterations: int) -> float:
    """One burst's receiver: the preamble estimate (two K-point FFTs, the
    reference division, a 9-tap smoother, linear interpolation), the SNR
    (a 2K-point FFT, magnitudes), the block FFT, the ZF divide, the L-tap
    fold, K M-point IFFTs, and each IC pass (decisions, neighbour sums, K
    M-point FFTs, the tap product, the subtraction, K M-point IFFTs)."""
    d = _dims(shape)
    M, K, N, L = d["M"], d["K"], d["N"], d["L"]
    est = 2 * fft_flops(K) + 2 * K * CMUL + d["n_est"] * 9 * (RMUL + CADD) + N * (CADD + RMUL)
    snr = fft_flops(2 * K) + 2 * K * ABS2
    demod = fft_flops(N) + N * CDIV + L * N * CMUL + (L - 1) * N * CADD + K * fft_flops(M)
    ic = N + 2 * N * CADD + 2 * K * fft_flops(M) + N * CMUL + N * CADD
    return est + snr + demod + ic_iterations * ic


def link_work(shape: dict, batch: int, ic_iterations: int = 2,
              outputs: tuple = ("data", "snr")) -> dict:
    """A loopback link step over ``batch`` payloads: flops, and bytes read
    (the payload) and written (``outputs``: the data estimate, and where the
    step returns one the SNR a burst)."""
    d = _dims(shape)
    flops = batch * (tx_flops(shape) + rx_flops(shape, ic_iterations))
    payload = batch * 2 * d["n_data"] * FLOAT_BYTES
    written = payload if "data" in outputs else 0
    if "snr" in outputs:
        written += batch * FLOAT_BYTES
    return {"flops": flops, "bytes": payload + written}


def detect_flops(shape: dict, length: int) -> float:
    """One chunk of ``length`` samples through the detector: the K-lag
    products and three running sums (autocorrelation, energy, CP
    integration), the normalization, and the 2K-tap cross-correlation as
    one forward and one inverse FFT of the next power of two."""
    d = _dims(shape)
    K = d["K"]
    n_ac = length - 2 * K
    n_fft = 1 << int(math.ceil(math.log2(length + 2 * K)))
    running = length * CMUL + 2 * n_ac * CADD + length * ABS2 + 2 * n_ac + 2 * n_ac
    norm = n_ac * (2 * RMUL + ABS2 + 1)
    xcorr = 2 * fft_flops(n_fft) + n_fft * CMUL + n_ac * (ABS2 + 1)
    return running + norm + xcorr


def decode_flops(n_info: int, constraint: int = 7) -> float:
    """A zero-terminated rate-1/2 codeword's soft decoding: QPSK max-log
    LLRs (a scale a coded bit) and, a trellis step, the four branch metrics
    (an add each) and for each of the 2^(K-1) states two adds and a
    compare; the traceback does no arithmetic."""
    steps = n_info + constraint - 1
    states = 1 << (constraint - 1)
    return 2 * steps * RMUL + steps * (4 + 3 * states)


def rx_step_work(shape: dict, n_chunks: int, length: int, n_bursts: int,
                 ic_iterations: int = 2, fec_info_bits: int | None = None) -> dict:
    """A receive-service step: ``n_chunks`` halo-extended chunks of
    ``length`` samples read once and detected; ``n_bursts`` bursts
    extracted (scale and CFO derotation), refined (the N-lag CP
    correlation and a second derotation) and received, and with
    ``fec_info_bits`` soft-decoded; written: each burst's data estimate, its
    start, CFO, SNR and found flag, and its decoded bits (a byte each, as
    the service hands them over)."""
    d = _dims(shape)
    F, cp = d["frame_len"], d["cp"]
    flops = n_chunks * detect_flops(shape, length)
    per_burst = (F * (RMUL + CMUL) + (cp // 2) * (CMUL + CADD) + F * CMUL
                 + rx_flops(shape, ic_iterations))
    written = n_bursts * (2 * d["n_data"] + 4) * FLOAT_BYTES
    if fec_info_bits:
        per_burst += decode_flops(fec_info_bits)
        written += n_bursts * fec_info_bits
    flops += n_bursts * per_burst
    read = n_chunks * 2 * length * FLOAT_BYTES
    return {"flops": flops, "bytes": read + written}
