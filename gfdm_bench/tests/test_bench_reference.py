"""The plain reference against the program's plain (CPU) paths at small
sizes: the transmitter, the loopback links, detection with its starts, the
coded framing and the Viterbi decoder. The tests may import the program;
the reference does not."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from gfdm_bench.reference import coding, traffic
from gfdm_bench.reference.precision import rounder
from gfdm_bench.reference.sync import Detector
from gfdm_bench.reference.waveform import Waveform

HERE = os.path.dirname(os.path.abspath(__file__))


def _config(name):
    with open(os.path.join(HERE, "..", "configs", f"{name}.json")) as f:
        return json.load(f)


def _planar(z):
    return torch.complex(z[:, 0].double(), z[:, 1].double())


def _program(name):
    from gfdm_bench.common import program_config

    return program_config(_config(name))


def test_sizes_match_the_program():
    for name in ("gfdm-default", "gfdm-largek512"):
        c, cfg, wf = _config(name), _program(name), Waveform(_config(name))
        assert (wf.frame_len, wf.N, wf.n_data, wf.preamble_len) == (
            cfg.frame_len, cfg.block_len, cfg.n_data_symbols, cfg.preamble_len)
        assert (c["frame_len"], c["block_len"], c["n_data_symbols"]) == (
            cfg.frame_len, cfg.block_len, cfg.n_data_symbols)


def test_transmitter_matches_the_program():
    from gfdm_tpu_torch.ops.planar_pipeline import transmit_planar

    cfg, wf = _program("gfdm-default"), Waveform(_config("gfdm-default"))
    data = traffic.qpsk_payload(8, wf.n_data, traffic.generator(3, "cpu"))
    gap = (_planar(transmit_planar(cfg, data)[:, 0]) - wf.transmit(data)).abs().max()
    assert float(gap) < 1e-6


def test_dense_link_matches_the_program_with_its_bf16_ic_operator():
    from gfdm_tpu_torch.kernels.fused import link_single_fused

    cfg = _program("gfdm-default")
    data = traffic.qpsk_payload(8, cfg.n_data_symbols, traffic.generator(4, "cpu"))
    d_hat, _snr, _evm = link_single_fused(cfg, data, ic_iterations=2, ic_mode="matmul")
    ref = Waveform(_config("gfdm-default"), ic_operand="bfloat16").link(data)["data"]
    plain = Waveform(_config("gfdm-default")).link(data)["data"]
    assert float((_planar(d_hat) - ref).abs().max()) < 1e-5
    # the bf16 IC operator is what separates the program from the golden taps
    assert float((_planar(d_hat) - plain).abs().max()) > 1e-4


def test_factored_link_matches_the_program():
    from gfdm_tpu_torch.kernels.fused import link_step_factored

    cfg = _program("gfdm-largek512")
    data = traffic.qpsk_payload(2, cfg.n_data_symbols, traffic.generator(5, "cpu"))
    d_hat, _evm = link_step_factored(cfg, data, ic_iterations=2, estimator="fast")
    ref = Waveform(_config("gfdm-largek512")).link(data)["data"]
    assert float((_planar(d_hat) - ref).abs().max()) < 1e-5


def test_detection_starts_and_payload_match_the_program_service():
    """The starts, checked by themselves: the reference's own picks equal
    the program's on a small impaired stream; the payload at those starts
    agrees to float32."""
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    c = _config("gfdm-default")
    wf = Waveform(c)
    b = traffic.impaired_chunks(wf, 24, 2048, traffic.generator(2**31 + 9, "cpu"))
    rx = StreamingReceiver(_program("gfdm-default"), chunk_len=2048, batch_chunks=24,
                           max_bursts_per_chunk=2, engine="fused", device="cpu")
    out = rx.step(b["chunks"].numpy())
    s = rounder("bfloat16")(b["chunks"]).double()
    s = torch.complex(s[:, 0], s[:, 1])
    det = Detector(wf, 2048, trace_precision="bfloat16")
    ref = det.detect(s, 2)
    found = torch.from_numpy(out["found"])
    assert torch.equal(found, ref["found"])
    assert torch.equal(torch.from_numpy(out["start"]).long()[found], ref["start"][found])
    idx = torch.nonzero(found)[:, 0]
    bursts = det.extract(s, idx // 2, ref["start"][idx], ref["scale"][idx], ref["cfo"][idx])
    r = wf.receive(bursts)
    assert float((_planar(torch.from_numpy(out["data"])[idx]) - r["data"]).abs().max()) < 1e-4


def test_coded_framing_and_decoder_match_the_program():
    from gfdm_tpu_torch import coding as pc
    from gfdm_tpu_torch.cli import payload_to_symbols

    cfg = _program("gfdm-default")
    rng = np.random.default_rng(1)
    info = rng.integers(0, 2, (4, 462)).astype(np.uint8)
    assert (coding.conv_encode(info) == pc.conv_encode(info)).all()
    assert (coding.interleaver(936) == pc.interleaver(936)).all()
    payload = rng.integers(0, 256, (3, 53)).astype(np.uint8)
    syms, _n = payload_to_symbols(cfg, payload.tobytes(), fec="conv")
    coded = coding.conv_encode(coding.frames(payload, 462))[:, coding.interleaver(936)]
    mine = coding.qpsk_symbols(coded)
    assert np.array_equal(mine[:, 0] + 1j * mine[:, 1], syms)
    llrs = torch.from_numpy(rng.standard_normal((6, 936)) * 3)
    assert np.array_equal(coding.viterbi(llrs, 462).numpy(),
                          pc.viterbi_decode(llrs.float(), 462, device="cpu").numpy())
    assert coding.crc_ok(coding.frames(payload, 462), 53).all()
