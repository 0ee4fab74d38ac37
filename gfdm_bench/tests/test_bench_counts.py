"""The least-work counts at one small shape, against values worked by hand.

Shape: M = 2, K = 4, L = 2, 2 active, cp 2, cs 1, so N = 8, 4 data symbols,
frame_len 22. The split-radix FFT counts: F(2) = 34/9 * 2 = 68/9,
F(4) = 34/9 * 8 = 272/9, F(8) = 34/9 * 24 = 816/9, F(64) = 34/9 * 384.
"""
from __future__ import annotations

import pytest

from gfdm_bench.counts import gfdm as g
from gfdm_bench.counts.peaks import H100_SXM, least_seconds

SHAPE = dict(timeslots=2, subcarriers=4, active_subcarriers=2, overlap=2, cp_len=2, cs_len=1)
F2, F4, F8, F64 = 68 / 9, 272 / 9, 816 / 9, 34 / 9 * 384


def test_fft():
    assert g.fft_flops(8) == pytest.approx(F8)
    assert g.fft_flops(1) == 0


def test_transmitter():
    # 2 active M-point FFTs, 2 x 8 complex multiplies, 8 complex adds,
    # the N-point IFFT, two ramp samples times a real each
    assert g.tx_flops(SHAPE) == pytest.approx(2 * F2 + 96 + 16 + F8 + 4)


def test_receiver():
    est = 2 * F4 + 8 * 6 + 3 * 9 * 4 + 8 * 4  # 2 K-FFTs, 2K products, 9-tap smoother, interp
    snr = F8 + 8 * 3
    demod = F8 + 8 * 11 + 2 * 8 * 6 + 8 * 2 + 4 * F2
    ic = 8 + 2 * 8 * 2 + 2 * 4 * F2 + 8 * 6 + 8 * 2
    assert g.rx_flops(SHAPE, 2) == pytest.approx(est + snr + demod + 2 * ic)


def test_link_step():
    w = g.link_work(SHAPE, 3, 2, outputs=("data", "snr"))
    assert w["bytes"] == 3 * 2 * 4 * 4 * 2 + 3 * 4  # payload in, estimate out, an SNR each
    assert w["flops"] == pytest.approx(3 * (g.tx_flops(SHAPE) + g.rx_flops(SHAPE, 2)))
    assert g.link_work(SHAPE, 3, 2, outputs=("data",))["bytes"] == 3 * 2 * 4 * 4 * 2


def test_detector_and_decoder():
    # 32 samples: 24 positions; the xcorr as two 64-point FFTs
    running = 32 * 6 + 2 * 24 * 2 + 32 * 3 + 48 + 48
    assert g.detect_flops(SHAPE, 32) == pytest.approx(running + 24 * 8 + 2 * F64 + 64 * 6 + 24 * 4)
    # 10 info bits: 16 trellis steps of 4 branch metrics and 64 x 3 state operations
    assert g.decode_flops(10) == 2 * 16 * 2 + 16 * (4 + 192)


def test_service_step_and_least_time():
    w = g.rx_step_work(SHAPE, 5, 32, 3, 2, fec_info_bits=10)
    assert w["bytes"] == 5 * 2 * 32 * 4 + 3 * (2 * 4 + 4) * 4 + 3 * 10
    t, bound = least_seconds({"flops": 165e12, "bytes": 1.0})
    assert (t, bound) == (pytest.approx(1.0), "flops")
    t, bound = least_seconds({"flops": 1.0, "bytes": 3.35e12})
    assert (t, bound) == (pytest.approx(1.0), "bytes")
    assert H100_SXM["fp32_accurate_flops"] == pytest.approx(495e12 / 3)
