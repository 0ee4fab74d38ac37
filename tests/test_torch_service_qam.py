"""The port's coded 64-QAM receive service against the benchmark's plain
64-QAM reference (``gfdm_bench/reference/qam.py``, float64, nothing of the
port), on the CPU at a small size.

The reference's Gray map and max-log LLRs against the port's; then
``StreamingReceiver(engine="fused", fec="conv", constellation="qam64",
ic_iterations=4)`` on 16 chunks of ``coded_qam_chunks`` at 20 dB and CFO
up to 0.2 subcarrier spacings: at every slot the reference follows the
port's start (its own detection traces read there, the burst extracted
and received by ``QamWaveform`` with four passes of 64-QAM decisions), and
the port's data estimates, CFO and SNR lie within the tolerances below of
the reference's; every burst is found and decoded to the info bits it
carries. A receiver that decides QPSK, or runs 2 passes, misses the data
tolerance. Then the decoder's span and counter over a served stream.
"""
import json
import os

import numpy as np
import pytest
import torch

from gfdm_bench.reference import coding, qam, traffic
from gfdm_bench.reference.precision import rounder
from gfdm_bench.reference.sync import Detector
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.ops.rx import constellation_points
from gfdm_tpu_torch.ops.softbits import maxlog_llrs_planar
from gfdm_tpu_torch.ref.symbolmapping import bits_to_symbols
from gfdm_tpu_torch.runtime.service import StreamingReceiver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "gfdm_bench", "configs", "gfdm-qam64.json")) as f:
    CONFIG = json.load(f)
TC = GfdmConfig()
CHUNK, N_CHUNKS, SEED = 2048, 16, 2**31 + 25
# The program keeps its front end in bfloat16 and the reference rounds the
# samples and its detection traces the same way (the cell's
# front_reference), so what is left between the two is float32 against
# float64 arithmetic:
# - data: the float32 receiver (ZF over a 20 dB preamble estimate, four IC
#   passes) lies ~1e-6 off the float64 one at unit-energy symbols; 1e-4
#   leaves two decades of room, while one 64-QAM decision taken otherwise
#   in an IC pass moves its neighbours' estimates by ~1e-2, so a QPSK
#   slicer or 2 passes where 4 are asked misses it (test below);
# - CFO: the program's K-lag sums run in bfloat16 in another order than
#   the reference's rounded sums (~6e-4 quantization, the priced budget of
#   the service's dtype_name default), so 2e-3;
# - SNR: the preamble's power sums, float32 against float64: 1e-3 dB.
TOL = {"data": 1e-4, "cfo": 2e-3, "snr_db": 1e-3}


def _stream():
    wf = qam.QamWaveform(CONFIG, "cpu")
    b = qam.coded_qam_chunks(wf, N_CHUNKS, CHUNK, traffic.generator(SEED, "cpu"),
                             snr_db=20.0, cfo_max=0.2, payload_bytes=170)
    return wf, b


@pytest.fixture(scope="module")
def stream():
    return _stream()


def _rx(constellation="qam64", ic_iterations=4, fec="conv", batch=N_CHUNKS):
    return StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=batch, engine="fused", fec=fec,
                             constellation=constellation, ic_iterations=ic_iterations,
                             device="cpu")


def _follow(wf, chunks, out):
    """The reference at the port's starts: CFO, SNR and data estimates."""
    det = Detector(wf, CHUNK, trace_precision="bfloat16")
    s = rounder("bfloat16")(chunks).to(torch.float64)
    s = torch.complex(s[:, 0], s[:, 1])
    tr = det.traces(s)
    idx = torch.arange(chunks.shape[0])
    start = torch.as_tensor(out["start"]).long()
    at = det.at(tr, idx, start)
    r = wf.receive(det.extract(s, idx, start, at["scale"], at["cfo"]))
    return at["cfo"], r


def _data_gap(out, r):
    dp = torch.as_tensor(out["data"]).double()
    return float((torch.complex(dp[:, 0], dp[:, 1]) - r["data"]).abs().max())


def test_the_gray_map_is_the_ports():
    pts = constellation_points("qam64")
    np.testing.assert_array_equal(qam.points(), pts)
    labels = qam.labels()
    np.testing.assert_array_equal(bits_to_symbols(labels.reshape(-1), pts), qam.points())
    bits = np.random.default_rng(3).integers(0, 2, (4, 6 * 10))
    sym = qam.map_bits(bits)
    want = bits_to_symbols(bits.reshape(-1), pts).reshape(4, 10)
    np.testing.assert_array_equal(sym[:, 0] + 1j * sym[:, 1], want.astype(np.complex64))


@pytest.mark.parametrize("snr_lin", [1.0, 10.0, 100.0])
def test_maxlog_llrs_at_qam64_are_the_references(snr_lin):
    """Float32 rounding: the port's squared distances (up to ~10 at the
    noise used here) carry ~1e-6 of themselves, over the noise variance."""
    g = torch.Generator().manual_seed(11)
    s = (torch.randn((3, 2, 40), generator=g, dtype=torch.float64) * 0.7).to(torch.float32)
    nv = torch.full((3,), 1.0 / snr_lin, dtype=torch.float32)
    got = maxlog_llrs_planar(s, constellation_points("qam64"), nv[:, None]).reshape(3, -1)
    ref = qam.maxlog_llrs(torch.complex(s[:, 0].double(), s[:, 1].double()),
                          torch.full((3,), snr_lin, dtype=torch.float64))
    d_max = float((torch.complex(s[:, 0], s[:, 1]).abs() + 1.1).pow(2).max())
    tol = 4 * float(torch.finfo(torch.float32).eps) * d_max * snr_lin
    assert float((got.double() - ref).abs().max()) <= tol
    assert torch.equal(got > 0, ref > 0)


def test_the_coded_qam64_service_against_the_reference(stream):
    wf, b = stream
    chunks = b["chunks"].to(torch.float32)
    out = _rx().step(chunks.numpy())
    assert out["found"].all()
    truth = (b["pos"] + wf.cp).numpy()
    assert np.abs(out["start"] - truth).max() <= 8
    cfo_r, r = _follow(wf, chunks, out)
    assert _data_gap(out, r) <= TOL["data"]
    assert float((torch.as_tensor(out["cfo"]).double() - cfo_r).abs().max()) <= TOL["cfo"]
    snr_db = 10 * np.log10(out["snr_lin"].astype(np.float64) / r["snr_lin"].numpy())
    assert np.abs(snr_db).max() <= TOL["snr_db"]
    np.testing.assert_array_equal(out["bits"], b["info"])
    assert coding.crc_ok(out["bits"], 170).all()


@pytest.mark.parametrize("constellation,ic_iterations", [("qpsk", 4), ("qam64", 2)])
def test_qpsk_decisions_or_two_passes_miss_the_data_tolerance(stream, constellation,
                                                              ic_iterations):
    wf, b = stream
    chunks = b["chunks"].to(torch.float32)
    out = _rx(constellation, ic_iterations, fec="none").step(chunks.numpy())
    _cfo, r = _follow(wf, chunks, out)
    assert _data_gap(out, r) > 10 * TOL["data"]


def test_the_decoder_spans_and_counts_each_served_batch(stream, tmp_path):
    """serve() over 2 batches of 8 chunks: one ``gfdm.fec.llr`` range a
    batch inside ``gfdm.service.decode`` on the profiler's timeline, its
    seconds in ``host_s``, and ``coded_bits`` 8 slots x 2,808 a batch."""
    from gfdm_tpu_torch.utils.profiling import trace_to

    _wf, b = stream
    batches = iter(np.split(b["chunks"].to(torch.float32).numpy()[:16], 2))
    rx = _rx(batch=8)
    with trace_to(str(tmp_path / "trace")):
        stats = rx.serve(lambda: next(batches, None), lambda out: None)
    assert stats.batches == 2 and stats.coded_bits == 2 * 8 * 2808
    assert stats.host_s["gfdm.fec.llr"] > 0.0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in ("gfdm.fec.llr",
                                                               "gfdm.service.decode"):
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert len(ranges["gfdm.fec.llr"]) == 2
    for a, z in ranges["gfdm.fec.llr"]:
        assert any(pa <= a and z <= pz for pa, pz in ranges["gfdm.service.decode"])
