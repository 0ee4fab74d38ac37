"""The least work of a coded receive-service step whose soft bits come
from a max-log demapper over a whole constellation.

``counts.gfdm.rx_step_work`` counts the coded service's decoder with QPSK's
soft bits: Gray QPSK's max-log LLR of a bit is its symbol part scaled, one
real multiply a coded bit. A denser constellation has no such closed form
in the program: its max-log demapper computes, a symbol, the squared
distance to each of its ``points`` (a complex subtract and a magnitude
squared each), then, a coded bit, the least distance over the points whose
label has the bit set and over those with it clear (``points / 2 - 1``
compares each), their difference and its scale by the noise variance (a
subtract and a multiply). ``qam_step_work`` is ``rx_step_work`` with that
in place of QPSK's scale; given QPSK's 4 points and 2 bits it counts the
scale again, so it equals ``rx_step_work``. The LLRs are an intermediate:
no byte is counted for them.

Nothing here imports the program under test.
"""
from __future__ import annotations

from .gfdm import ABS2, CADD, RMUL, rx_step_work

QPSK = (4, 2)


def llr_flops(points: int, bits: int) -> float:
    """One symbol's max-log LLRs over ``points`` points, ``bits`` bits a
    symbol; Gray QPSK's closed form, a scale a bit, at (4, 2)."""
    if (points, bits) == QPSK:
        return bits * RMUL
    return points * (CADD + ABS2) + bits * (2 * (points // 2 - 1) + 2)


def qam_step_work(shape: dict, n_chunks: int, length: int, n_bursts: int,
                  ic_iterations: int, fec_info_bits: int, points: int, bits: int) -> dict:
    """``rx_step_work`` with ``fec_info_bits`` a codeword and each of the
    codeword's symbols demapped over ``points`` points (``llr_flops``) in
    place of QPSK's scale."""
    work = dict(rx_step_work(shape, n_chunks, length, n_bursts, ic_iterations, fec_info_bits))
    n_coded = 2 * (fec_info_bits + 6)
    qpsk = n_coded * RMUL  # what rx_step_work counted for the soft bits
    work["flops"] += n_bursts * (n_coded / bits * llr_flops(points, bits) - qpsk)
    return work
