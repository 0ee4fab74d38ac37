"""The traffic generator: the same seed gives the same inputs, another seed
other ones; every seed places the same number of bursts; the coded stream's
truth decodes."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from gfdm_bench.reference import coding, traffic
from gfdm_bench.reference.waveform import Waveform

HERE = os.path.dirname(os.path.abspath(__file__))


def _wf():
    with open(os.path.join(HERE, "..", "configs", "gfdm-default.json")) as f:
        return Waveform(json.load(f))


def test_payload_is_a_function_of_the_seed():
    big = 2**31 + 123456789  # more than 32 signed bits hold
    a = traffic.qpsk_payload(16, 468, traffic.generator(big, "cpu"))
    b = traffic.qpsk_payload(16, 468, traffic.generator(big, "cpu"))
    c = traffic.qpsk_payload(16, 468, traffic.generator(big + 1, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a.abs()).tolist()) == {np.float32(2**-0.5)}


def test_impaired_stream_is_a_function_of_the_seed():
    wf = _wf()
    a = traffic.impaired_chunks(wf, 16, 2048, traffic.generator(7, "cpu"))
    b = traffic.impaired_chunks(wf, 16, 2048, traffic.generator(7, "cpu"))
    c = traffic.impaired_chunks(wf, 16, 2048, traffic.generator(8, "cpu"))
    for key in ("chunks", "chunk", "pos", "payload"):
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["chunks"], c["chunks"])
    assert a["chunks"].shape == (16, 2, 2048 + 752 + 16)


def test_every_seed_places_the_same_bursts_in_the_owned_range():
    wf = _wf()
    for seed in (1, 2, 3):
        b = traffic.impaired_chunks(wf, 64, 2048, traffic.generator(seed, "cpu"))
        counts = b["counts"]
        assert [int((counts == k).sum()) for k in (0, 1, 2)] == [16, 32, 16]
        assert int(b["pos"].min()) >= 0 and int(b["pos"].max()) < 2048 - wf.cp
        two = counts[b["chunk"]] == 2
        first = b["pos"][two][0::2]
        second = b["pos"][two][1::2]
        assert bool((second - first >= wf.frame_len).all())


def test_coded_stream_truth_is_framed_and_decodable():
    wf = _wf()
    a = traffic.coded_chunks(wf, 8, 2048, traffic.generator(11, "cpu"))
    b = traffic.coded_chunks(wf, 8, 2048, traffic.generator(11, "cpu"))
    assert torch.equal(a["chunks"], b["chunks"]) and np.array_equal(a["info"], b["info"])
    assert coding.crc_ok(a["info"], 53).all()
    n = a["info"].shape[1]
    llrs = torch.from_numpy(1.0 - 2.0 * coding.conv_encode(a["info"]).astype(np.float64))
    assert np.array_equal(coding.viterbi(llrs, n).numpy(), a["info"])
