"""The port's streaming receive path against the JAX package's, on the CPU.

Same numpy-seeded float32 chunk streams into both packages' stream helpers
and StreamingReceiver; on the CPU the port's fused engine runs its
kernels' plain versions (the JAX package's Pallas receiver runs in
interpret mode). Found slots must agree exactly; payloads within the
receiver tolerance of tests/test_torch_fused.py. The loop's host spans
(``ServiceStats.host_s``, the profiler's ``gfdm.service.*`` ranges) last.
"""
import json
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import planar as jax_planar
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu.ops import tx as jax_tx
from gfdm_tpu.ref import utils
from gfdm_tpu.runtime import service as jax_service
from gfdm_tpu.runtime import stream as jax_stream
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import service_stream
from gfdm_tpu_torch.kernels import detect, fused
from gfdm_tpu_torch.ops import planar_pipeline as pp
from gfdm_tpu_torch.runtime import service, stream

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
CHUNK = 2048
HALO = TC.frame_len + TC.cp_len
DATA_ATOL = 1e-4  # tests/test_torch_fused.py: receive_bursts_fused data


def _bench_stream(n, impaired, seed=0):
    return bench._service_stream(JC, n, CHUNK, 20.0, impaired, np.random.default_rng(seed))


def _assert_outputs(got, ref):
    """found and start equal; payloads of found slots within DATA_ATOL.
    (Slots that are not found hold noise picks, where the ZF divide
    amplifies float noise without bound.)"""
    np.testing.assert_array_equal(got["found"], ref["found"])
    np.testing.assert_array_equal(got["start"], ref["start"])
    f = ref["found"]
    np.testing.assert_allclose(got["data"][f], ref["data"][f], atol=DATA_ATOL)
    np.testing.assert_allclose(got["cfo"], ref["cfo"], atol=1e-6)
    np.testing.assert_allclose(got["snr_lin"][f], ref["snr_lin"][f], rtol=1e-3)


@pytest.mark.parametrize("impaired", [False, True])
def test_service_stream_matches_bench(impaired):
    ref, counts_ref = _bench_stream(24, impaired, seed=4)
    got, counts, payload = service_stream(TC, 24, CHUNK, 20.0, impaired,
                                          np.random.default_rng(4))
    np.testing.assert_array_equal(counts, counts_ref)
    assert got.dtype == np.float32 and got.shape == (24, 2, CHUNK + HALO)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert payload.shape == (counts.sum(), 2, TC.n_data_symbols)
    assert set(np.unique(payload * np.sqrt(2.0)).round(6)) == {-1.0, 1.0}


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("k", [1, 2])
def test_streaming_receiver_matches_jax(engine, k):
    chunks, counts = _bench_stream(12, impaired=k > 1, seed=1)
    kw = dict(chunk_len=CHUNK, batch_chunks=8, engine=engine, max_bursts_per_chunk=k)
    ref = jax_service.StreamingReceiver(JC, **kw).step(chunks)
    rx = service.StreamingReceiver(TC, device="cpu", **kw)
    before = (dict(fused.LAUNCHES), dict(detect.LAUNCHES))
    got = rx.step(chunks)
    assert (dict(fused.LAUNCHES), dict(detect.LAUNCHES)) == before
    assert rx.device.type == "cpu" and got["data"].shape == ref["data"].shape
    _assert_outputs(got, ref)
    assert got["found"].sum() == counts.sum()
    assert rx.stats.chunks == 12 and rx.stats.bursts_found == counts.sum()


@pytest.mark.parametrize("impl,k", [("pallas2", 1), ("pallas", 1), ("pallas", 2)])
def test_fused_engine_under_detection_kernels_matches_jax(impl, k, monkeypatch):
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", impl)
    chunks, counts = _bench_stream(8, impaired=k > 1, seed=2)
    kw = dict(chunk_len=CHUNK, batch_chunks=8, engine="fused", max_bursts_per_chunk=k)
    ref = jax_service.StreamingReceiver(JC, **kw).step(chunks)
    got = service.StreamingReceiver(TC, device="cpu", **kw).step(chunks)
    _assert_outputs(got, ref)
    assert got["found"].sum() == counts.sum()


def test_service_uses_cfar_rule():
    """test_detection.py::test_service_uses_cfar_rule on the port: empty
    chunks rejected, real bursts found; min_strength still overrides."""
    data = np.stack([utils.random_qpsk(JC.n_data_symbols, seed=500 + i)
                     for i in range(4)]).astype(np.complex64)
    bursts = np.asarray(jax_tx.transmit(JC, data))[:, 0, :]
    sigma = np.sqrt(np.mean(np.abs(bursts) ** 2) / 10 ** 1.5)
    rng = np.random.default_rng(500 + 7777)
    burst_chunks = sigma / np.sqrt(2.0) * rng.standard_normal((4, 2, CHUNK + HALO))
    burst_chunks[:, 0, 300 : 300 + TC.frame_len] += bursts.real
    burst_chunks[:, 1, 300 : 300 + TC.frame_len] += bursts.imag
    noise = 0.02 / np.sqrt(2.0) * np.random.default_rng(501).standard_normal(
        (4, 2, CHUNK + HALO))
    chunks = np.concatenate([burst_chunks, noise]).astype(np.float32)
    out = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=8,
                                     device="cpu").step(chunks)
    np.testing.assert_array_equal(out["found"], [True] * 4 + [False] * 4)
    ref = jax_service.StreamingReceiver(JC, chunk_len=CHUNK, batch_chunks=8).step(chunks)
    np.testing.assert_array_equal(out["found"], ref["found"])
    rx2 = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=8, min_strength=10.0,
                                   device="cpu")
    assert not rx2.step(chunks)["found"].any()


def test_receive_chunks_and_long_stream_match_jax():
    data = np.stack([utils.random_qpsk(JC.n_data_symbols, seed=300 + i)
                     for i in range(3)]).astype(np.complex64)
    bursts = np.asarray(jax_tx.transmit(JC, data))[:, 0, :]
    rng = np.random.default_rng(17)
    rec = 0.005 * (rng.standard_normal(6 * CHUNK) + 1j * rng.standard_normal(6 * CHUNK))
    for b, off in zip(bursts, [150, 2 * CHUNK + 400, 5 * CHUNK + 50]):
        rec[off : off + TC.frame_len] += b
    planar = jax_planar.to_planar(rec.astype(np.complex64))
    ref_chunks = np.asarray(jax_stream.chunk_with_lookahead(jnp.asarray(planar), CHUNK, HALO))
    got_chunks = stream.chunk_with_lookahead(torch.from_numpy(planar), CHUNK, HALO)
    np.testing.assert_array_equal(got_chunks.numpy(), ref_chunks)

    ref = jax_stream.receive_long_stream_planar(JC, jnp.asarray(planar), CHUNK)
    got = stream.receive_long_stream_planar(TC, torch.from_numpy(planar), CHUNK)
    f = np.asarray(ref["found"])
    np.testing.assert_array_equal(got["found"].numpy(), f)
    assert f.sum() == 3
    np.testing.assert_array_equal(got["detection"]["start"].numpy(),
                                  np.asarray(ref["detection"]["start"]))
    np.testing.assert_allclose(got["data"].numpy()[f], np.asarray(ref["data"])[f],
                               atol=DATA_ATOL)

    chunks = np.ascontiguousarray(np.moveaxis(ref_chunks, -2, -3))
    for k in (1, 2):
        ref = jax_stream.receive_chunks_planar(JC, jnp.asarray(chunks), CHUNK,
                                               max_bursts_per_chunk=k,
                                               detect_dtype_name="bfloat16")
        got = stream.receive_chunks_planar(TC, torch.from_numpy(chunks), CHUNK,
                                           max_bursts_per_chunk=k,
                                           detect_dtype_name="bfloat16")
        f = np.asarray(ref["found"])
        np.testing.assert_array_equal(got["found"].numpy(), f)
        assert f.sum() == 3
        np.testing.assert_allclose(got["data"].numpy()[f], np.asarray(ref["data"])[f],
                                   atol=DATA_ATOL)


class _Ring:
    """A duck-typed ring: ``pull(n) -> (chunks, base)`` and a drop counter,
    like the native StreamBuffer."""

    def __init__(self, chunks, chunk_len):
        self.chunks, self.chunk_len, self.pos, self.dropped = chunks, chunk_len, 0, 3

    def pull(self, n):
        got = self.chunks[self.pos : self.pos + n]
        base = self.pos * self.chunk_len
        self.pos += got.shape[0]
        self.dropped += 1
        return got, base


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_serve_depths_agree(engine):
    """pipeline_depth 1 and 2 give the same stats and outputs in the same
    order, from a ring (super-batched) and from a callable source."""
    chunks, counts = _bench_stream(10, impaired=False, seed=5)
    runs = []
    for depth in (1, 2):
        rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=2,
                                       max_batch_chunks=4, engine=engine,
                                       pipeline_depth=depth, device="cpu")
        outs = []
        stats = rx.serve(_Ring(chunks, CHUNK), outs.append)
        runs.append((stats, outs))
    (s1, o1), (s2, o2) = runs
    assert s1 == s2
    assert s1.batches == 3 and s1.chunks == 10 and s1.bursts_found == counts.sum()
    assert s1.dropped_ring == 4  # one per pull, none from before the call
    assert s1.samples == 10 * CHUNK and s1.mean_snr_db > 10.0
    for a, b in zip(o1, o2):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    starts = np.concatenate([o["start_abs"][o["found"]] for o in o1])
    direct = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=10,
                                       engine=engine, device="cpu").step(chunks)
    np.testing.assert_array_equal(starts, direct["start"] + np.arange(10) * CHUNK)

    it = iter(range(0, 10, 4))
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=4, engine=engine,
                                   device="cpu")
    outs = []
    stats = rx.serve(lambda: (None if (i := next(it, None)) is None
                              else chunks[i : i + 4]), outs.append, max_batches=2)
    assert stats.batches == 2 and stats.chunks == 8
    assert all(o["base_offset"] == -1 for o in outs)


def test_batch_ladder_and_host_ranges_match_jax():
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=3,
                                   max_batch_chunks=12, device="cpu")
    # the port runs on one device: the JAX ladder on a one-device mesh
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    jrx = jax_service.StreamingReceiver(JC, chunk_len=CHUNK, batch_chunks=3,
                                        max_batch_chunks=12, mesh=mesh)
    for n in range(1, 13):
        assert rx._padded_batch(n) == jrx._padded_batch(n)
    np.testing.assert_array_equal(rx._slot_offsets(5), jrx._slot_offsets(5))
    for total, hosts in ((10, 3), (7, 7), (5, 8)):
        for h in range(hosts):
            assert (service.host_chunk_range(total, hosts, h)
                    == jax_service.host_chunk_range(total, hosts, h))


def test_unported_options_raise():
    # sp_shards > 1 needs a mesh whose devices divide into it (one device
    # does not), as in the JAX package
    with pytest.raises(ValueError, match="1 devices not divisible by sp_shards=2"):
        service.StreamingReceiver(TC, sp_shards=2, engine="fused", device="cpu")
    # fec="conv" builds since the coded modem was ported
    assert service.StreamingReceiver(TC, fec="conv", device="cpu").fec_info_bits == 462
    with pytest.raises(ValueError, match="batch_chunks"):
        service.StreamingReceiver(TC, batch_chunks=0, device="cpu")
    with pytest.raises(ValueError, match="max_batch_chunks"):
        service.StreamingReceiver(TC, batch_chunks=4, max_batch_chunks=2, device="cpu")
    with pytest.raises(ValueError, match="fec"):
        service.StreamingReceiver(TC, fec="ldpc", device="cpu")
    with pytest.raises(ValueError, match="equalizer"):
        service.StreamingReceiver(TC, engine="fused", equalizer="lmmse", device="cpu")


def test_service_without_a_device_never_falls_back_to_the_cpu(monkeypatch):
    """No device argument: the card, or an error naming device='cpu' when
    there is none; the CPU only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("xla", "fused"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            service.StreamingReceiver(TC, engine=engine)
        assert service.StreamingReceiver(TC, engine=engine, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("k", [1, 2])
def test_streaming_receiver_fast_method_matches_jax(k):
    """engine="xla", method="fast": the factorized receiver behind the
    service step, on 16 chunks of the bench stream (friendly for k = 1,
    impaired for k = 2), against the JAX service."""
    chunks, counts = _bench_stream(16, impaired=k > 1, seed=6)
    kw = dict(chunk_len=CHUNK, batch_chunks=16, engine="xla", method="fast",
              max_bursts_per_chunk=k)
    jkw = dict(kw)
    kw["device"] = "cpu"
    ref = jax_service.StreamingReceiver(JC, **jkw).step(chunks)
    got = service.StreamingReceiver(TC, **kw).step(chunks)
    _assert_outputs(got, ref)
    assert got["found"].sum() == counts.sum()
    dense = service.StreamingReceiver(TC, **{**kw, "method": "dense"}).step(chunks)
    f = dense["found"]
    np.testing.assert_array_equal(got["found"], f)
    np.testing.assert_allclose(got["data"][f], dense["data"][f], atol=DATA_ATOL)


def test_defaults_match_jax():
    for name in ("chunk_len", "batch_chunks", "max_batch_chunks", "ic_iterations",
                 "max_bursts_per_chunk", "min_strength", "false_alarm_prob",
                 "equalizer", "constellation", "fec", "method", "refine_cfo",
                 "dtype_name", "engine", "sp_shards", "pipeline_depth"):
        assert (getattr(service.StreamingReceiver, name)
                == getattr(jax_service.StreamingReceiver, name)), name
    assert service.StreamingReceiver.dtype_name == "bfloat16"


SPAN_PHASES = ("stage", "stage.wait", "h2d", "step", "detect", "extract", "refine_cfo", "receive",
               "fetch.wait", "fetch.copy", "account", "sink")
STEP_CHILDREN = ("detect", "extract", "refine_cfo", "receive", "decode")


@pytest.mark.parametrize("case", ["fused", "xla", "conv", "sp"])
def test_serve_spans_every_phase_once_a_batch(case, tmp_path):
    """serve() over N batches: host_s holds every phase of the loop, the
    profiler's trace holds N ranges of each (N + 1 pulls: the last finds
    the source dry), and the step's stages lie inside the step's range.
    The stage runs on serve()'s stager thread, which the profiler does not
    record: its seconds reach profiled_spans(), and no range the trace."""
    from gfdm_tpu_torch.parallel.mesh import make_mesh
    from gfdm_tpu_torch.utils.profiling import profiled_spans, trace_to

    n_batches = 3
    chunks, _ = _bench_stream(2 * n_batches, impaired=False, seed=6)
    kw = dict(chunk_len=CHUNK, batch_chunks=2, engine="xla" if case == "xla" else "fused")
    if case == "conv":
        kw["fec"] = "conv"
    if case == "sp":
        kw.update(sp_shards=2, mesh=make_mesh(["cpu"] * 2, dp=1, sp=2))
    else:
        kw["device"] = "cpu"
    rx = service.StreamingReceiver(TC, **kw)
    batches = iter(np.split(chunks, n_batches))
    before = profiled_spans().get("gfdm.service.stage", 0.0)
    with trace_to(str(tmp_path / "trace")):
        stats = rx.serve(lambda: next(batches, None), lambda out: None)
    phases = SPAN_PHASES + (("decode",) if case == "conv" else ())
    llr = {"gfdm.fec.llr"} if case == "conv" else set()
    assert set(stats.host_s) == {f"gfdm.service.{p}" for p in phases + ("pull",)} | llr
    assert all(v >= 0.0 for v in stats.host_s.values())
    assert profiled_spans()["gfdm.service.stage"] > before

    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"].startswith("gfdm."):
            ranges.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert "gfdm.service.stage" not in ranges
    for p in phases:
        if p != "stage":
            assert len(ranges[f"gfdm.service.{p}"]) == n_batches, p
    assert len(ranges["gfdm.service.pull"]) == n_batches + 1
    if case == "conv":  # the decoder's LLRs and Viterbi inside its span; on the
        # CPU (the plain path) the Viterbi's ACS and traceback inside that
        children = {"gfdm.fec.llr": "gfdm.service.decode",
                    "gfdm.fec.viterbi": "gfdm.service.decode",
                    "gfdm.fec.acs": "gfdm.fec.viterbi",
                    "gfdm.fec.traceback": "gfdm.fec.viterbi"}
    else:
        children = {}
    children.update({f"gfdm.service.{c}": "gfdm.service.step" for c in STEP_CHILDREN
                     if c in phases})
    for child, parent in children.items():
        assert len(ranges[child]) == n_batches
        for a, b in ranges[child]:
            assert any(pa <= a and b <= pb for pa, pb in ranges[parent]), child


def _stager_threads():
    return [t for t in threading.enumerate() if t.name.startswith("gfdm-stage")]


def test_serve_over_one_reused_array_matches_step(monkeypatch):
    """A source that refills one array on every call: serve() delivers what
    step() gives on copies of the batches, since the stager finishes a
    batch before the next pull. The stage is slowed and the interpreter
    switches threads often, so a pull made during a stage would show."""
    chunks, _ = _bench_stream(8, impaired=False, seed=7)
    batches = np.split(chunks, 4)
    kw = dict(chunk_len=CHUNK, batch_chunks=2, engine="fused", device="cpu")
    direct = service.StreamingReceiver(TC, **kw)
    want = [direct.step(b.copy()) for b in batches]

    rx = service.StreamingReceiver(TC, **kw)
    stage = rx._stage

    def slow_stage(*a):
        time.sleep(0.02)
        return stage(*a)

    monkeypatch.setattr(rx, "_stage", slow_stage)
    shared = np.empty_like(batches[0])
    it = iter(batches)

    def source():
        b = next(it, None)
        if b is None:
            return None
        shared[...] = b
        return shared

    outs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats = rx.serve(source, outs.append)
    finally:
        sys.setswitchinterval(interval)
    assert stats.batches == len(batches) == len(outs)
    for got, ref in zip(outs, want):
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])


@pytest.mark.parametrize("max_batches", [0, 1, 3])
def test_serve_pulls_exactly_max_batches(max_batches):
    """With max_batches = m the source is called m times (pulling ahead
    never pulls an m + 1st batch), and every pulled batch is delivered."""
    chunks, _ = _bench_stream(10, impaired=False, seed=5)
    calls = []

    def source():
        calls.append(1)
        return chunks[2 * (len(calls) - 1) : 2 * len(calls)]

    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=2, device="cpu")
    outs = []
    stats = rx.serve(source, outs.append, max_batches=max_batches)
    assert len(calls) == stats.batches == len(outs) == max_batches
    assert stats.chunks == 2 * max_batches


def test_a_stager_exception_is_raised_from_serve():
    """A wrong-shaped batch fails on the stager; serve() raises it and
    leaves no stager thread running."""
    chunks, _ = _bench_stream(4, impaired=False, seed=5)
    it = iter([chunks[:2], chunks[2:, :, :-1]])
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=2, device="cpu")
    outs = []
    with pytest.raises(ValueError, match=f"a batch is \\(n, 2, {CHUNK + HALO}\\)"):
        rx.serve(lambda: next(it, None), outs.append)
    assert outs == [] and not _stager_threads()
    # the receiver serves again afterwards
    assert rx.serve(lambda: chunks[:2], outs.append, max_batches=1).batches == 1
    assert len(outs) == 1 and not _stager_threads()


def test_serve_times_the_stage_and_its_wait():
    """host_s holds the stage (timed on the stager) and the loop's wait for
    it; staged_ahead counts at most every batch."""
    chunks, _ = _bench_stream(6, impaired=False, seed=6)
    batches = iter(np.split(chunks, 3))
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=2, device="cpu")
    stats = rx.serve(lambda: next(batches, None), lambda out: None)
    assert stats.batches == 3
    assert stats.host_s["gfdm.service.stage"] > 0.0
    assert stats.host_s["gfdm.service.stage.wait"] >= 0.0
    assert 0 <= stats.staged_ahead <= stats.batches
