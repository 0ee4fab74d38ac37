"""The port's coded modem through both services against the JAX package, on the CPU.

StreamingReceiver(fec="conv") on both engines (the port's kernels run
their plain versions on CPU tensors, the JAX package's Pallas receiver runs
in interpret mode), modem_sensitivity, and StreamingTransmitter on the same
numpy-seeded inputs: decoded bits of found slots equal, every payload
CRC-clean, the transmitter's samples within TOL["tx"] (2e-5, as
tests/test_torch_gpu.py holds the Tx kernel). The counterparts of
tests/test_stream_eval.py's device-FEC tests and tests/test_transmit_service.py.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.eval.sensitivity import modem_sensitivity as jax_sensitivity
from gfdm_tpu.ops.planar_pipeline import prepare as jax_prepare
from gfdm_tpu.ops.planar_pipeline import transmit_planar as jax_transmit
from gfdm_tpu.runtime import service as jax_service
from gfdm_tpu.runtime import timing as jax_timing
from gfdm_tpu.runtime import transmit_service as jax_tx_service
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.cli import burst_capacity_bytes, payload_to_symbols
from gfdm_tpu_torch.eval.sensitivity import modem_sensitivity
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops.planar_pipeline import transmit_planar
from gfdm_tpu_torch.runtime import service, stream, timing
from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter, TxStats
from gfdm_tpu_torch.utils.framing import check_crc32, pack_bits

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
CHUNK = 2048
HALO = TC.frame_len + TC.cp_len
TX_TOL = 2e-5  # chip_smoke.py TOL["tx"]


def _coded_chunks(name, order, snr_db, n_bursts=3, offs=(100, 700, 1200), seed=23):
    """The device-FEC test's stream (tests/test_stream_eval.py:447-492): a
    coded payload, its bursts placed in n_bursts of n_bursts + 1 chunks."""
    cap = burst_capacity_bytes(TC, order, "conv")
    payload = (bytes(range(256)) * ((n_bursts * cap) // 256 + 1))[: n_bursts * cap - 17]
    syms, n = payload_to_symbols(TC, payload, name, fec="conv")
    assert n == n_bursts
    jax_prepare(JC)
    planar = np.stack([syms.real, syms.imag], axis=1).astype(np.float32)
    bursts = np.asarray(jax_transmit(JC, planar)[:, 0])
    rng = np.random.default_rng(seed)
    sig = float(np.mean(np.sum(bursts**2, axis=1)))
    na = np.sqrt(sig * 10 ** (-snr_db / 10) / 2)
    chunks = (na * rng.standard_normal((n_bursts + 1, 2, CHUNK + HALO))).astype(np.float32)
    for i in range(n_bursts):
        chunks[i, :, offs[i] : offs[i] + TC.frame_len] += bursts[i]
    return chunks, payload, cap


def _payloads(bits_rows, cap):
    """CRC-checked payloads of decoded info-bit rows; every CRC must pass."""
    parts = []
    for bits in bits_rows:
        ok, part = check_crc32(pack_bits(bits[: (cap + 4) * 8]))
        assert ok, "CRC failed on a decoded burst"
        parts.append(part)
    return b"".join(parts)


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("name,order,snr_db",
                         [("qpsk", 2, 10.0), ("qam16", 4, 16.0), ("qam64", 6, 24.0)])
def test_coded_service_matches_jax(name, order, snr_db, engine):
    chunks, payload, cap = _coded_chunks(name, order, snr_db)
    kw = dict(chunk_len=CHUNK, batch_chunks=4, engine=engine, fec="conv",
              constellation=name)
    ref = jax_service.StreamingReceiver(JC, **kw).step(chunks)
    rx = service.StreamingReceiver(TC, device="cpu", **kw)
    got = rx.step(chunks)
    assert rx.fec_info_bits == (order * TC.n_data_symbols) // 2 - 6
    assert got["found"].tolist() == ref["found"].tolist() == [True, True, True, False]
    assert got["bits"].dtype == np.uint8 and got["bits"].shape == (4, rx.fec_info_bits)
    f = ref["found"]
    np.testing.assert_array_equal(got["bits"][f], ref["bits"][f])
    assert _payloads(got["bits"][:3], cap)[: len(payload)] == payload


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_serve_delivers_the_steps_bits(engine):
    """serve() + sink: the decoded bits flow through the fetch with slot
    trimming (a padded batch of 3 of 4 chunks), equal to step()'s and to
    the JAX service's serve() (tests/test_stream_eval.py:850-889)."""
    chunks, payload, cap = _coded_chunks("qpsk", 2, 12.0, n_bursts=2, offs=(200, 600),
                                         seed=41)
    kw = dict(chunk_len=CHUNK, batch_chunks=4, engine=engine, fec="conv")
    outs, refs = [], []
    it = iter([chunks])
    service.StreamingReceiver(TC, device="cpu", **kw).serve(lambda: next(it, None),
                                                             outs.append)
    it = iter([chunks])
    jax_service.StreamingReceiver(JC, **kw).serve(lambda: next(it, None), refs.append)
    assert len(outs) == len(refs) == 1
    out = outs[0]
    assert out["found"].tolist() == [True, True, False] and out["bits"].shape[0] == 3
    np.testing.assert_array_equal(out["bits"][:2], refs[0]["bits"][:2])
    direct = service.StreamingReceiver(TC, device="cpu", **kw).step(chunks)
    np.testing.assert_array_equal(out["bits"], direct["bits"])
    assert _payloads(out["bits"][:2], cap)[: len(payload)] == payload


def test_fec_options_and_default():
    rx = service.StreamingReceiver(TC, fec="conv", device="cpu")
    assert rx.fec_info_bits == 462
    assert service.StreamingReceiver.fec == "none"
    assert "bits" not in service.StreamingReceiver(TC, device="cpu").step(
        np.zeros((1, 2, CHUNK + HALO), np.float32))


def test_modem_sensitivity_matches_jax():
    """tests/test_stream_eval.py::test_modem_sensitivity_sweep's limits, and
    the JAX sweep's numbers on the same seed."""
    kw = dict(snr_db=(4.0, 10.0), bursts_per_point=32, seed=2)
    got = modem_sensitivity(TC, device="cpu", **kw)
    ref = jax_sensitivity(JC, **kw)
    assert np.all(got["found_rate"] == 1.0)
    assert got["crc_rate"][1] >= got["crc_rate"][0]
    assert got["crc_rate"][0] >= 0.9
    assert got["crc_rate"][1] >= 0.95
    np.testing.assert_array_equal(got["snr_db"], ref["snr_db"])
    np.testing.assert_array_equal(got["found_rate"], ref["found_rate"])
    np.testing.assert_allclose(got["crc_rate"], ref["crc_rate"], atol=1 / 32)
    np.testing.assert_allclose(got["info_ber"], ref["info_ber"], atol=1e-3)


def _tx_payloads(batch, seed):
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, (batch, 2, TC.n_data_symbols)) * 2 - 1)
            / np.sqrt(2.0)).astype(np.float32)


@pytest.mark.parametrize("shift_index", [0, 1])
def test_transmitter_serve_matches_jax(shift_index):
    cfg_j, cfg_t = JaxConfig(cyclic_shifts=(0, 4)), GfdmConfig(cyclic_shifts=(0, 4))
    pls = _tx_payloads(6, seed=2 + shift_index)
    kw = dict(batch_bursts=3, sample_rate=1e6, scale=0.7, cyclic_shift_index=shift_index,
              timing_advance_secs=2e-6)
    runs = []
    for tx in (jax_tx_service.StreamingTransmitter(cfg_j, **kw),
               StreamingTransmitter(cfg_t, device="cpu", **kw)):
        batches, outs = iter([pls[:3], pls[3:]]), []
        stats = tx.serve(lambda: next(batches, None), outs.append)
        runs.append((stats, outs))
    (s_ref, ref), (s_got, got) = runs
    assert (s_got.batches, s_got.bursts, s_got.samples) == (
        s_ref.batches, s_ref.bursts, s_ref.samples) == (2, 6, 6 * TC.padded_frame_len)
    assert isinstance(s_got, TxStats)
    for a, b in zip(got, ref):
        assert a["tx_times"] == b["tx_times"]
        assert a["samples"].dtype == np.float32 and a["samples"].shape == b["samples"].shape
        np.testing.assert_allclose(a["samples"], b["samples"], rtol=0, atol=TX_TOL)
        np.testing.assert_allclose(a["bursts"], b["bursts"], rtol=0, atol=TX_TOL)


def test_transmitter_step_and_grid():
    """step() is the Tx kernel's wrapper times scale (its plain version on
    the CPU, no launch); the stream carries each burst on its cycle slot
    and zeros between; a ring-like sink gets push()."""
    pls = _tx_payloads(4, seed=9)
    tx = StreamingTransmitter(TC, scale=0.5, cycle_samples=CHUNK, device="cpu")
    before = dict(fused.LAUNCHES)
    out = tx.step(pls)
    assert dict(fused.LAUNCHES) == before
    ref = 0.5 * transmit_planar(TC, torch.from_numpy(pls))[:, 0].numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)

    class Ring:
        pushed = []

        def push(self, planar):
            self.pushed.append(planar)

    ring = Ring()
    it = iter([pls])
    tx.serve(lambda: next(it, None), ring)
    stream_ = np.concatenate(ring.pushed, axis=-1)
    assert stream_.shape == (2, 4 * CHUNK)
    for i in range(4):
        np.testing.assert_array_equal(stream_[:, i * CHUNK : i * CHUNK + TC.frame_len],
                                      out[i])
        assert not stream_[:, i * CHUNK + TC.frame_len : (i + 1) * CHUNK].any()


def test_transmitter_options_and_devices(monkeypatch):
    with pytest.raises(ValueError, match="cannot hold"):
        StreamingTransmitter(TC, cycle_samples=TC.frame_len - 1, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        StreamingTransmitter(TC, cyclic_shift_index=3, device="cpu")
    for name in ("batch_bursts", "scale", "cyclic_shift_index", "sample_rate",
                 "cycle_samples", "timing_advance_secs"):
        assert (getattr(StreamingTransmitter, name)
                == getattr(jax_tx_service.StreamingTransmitter, name)), name
    tx = StreamingTransmitter(TC, device="cpu")
    assert tx.cycle_samples == TC.padded_frame_len and tx.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingTransmitter(TC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        modem_sensitivity(TC, snr_db=(10.0,), bursts_per_point=2)


def test_burst_scheduler_matches_jax():
    sched = timing.BurstScheduler(cycle_interval_secs=2048 / 3.125e6,
                                  timing_advance_secs=1e-4, rx_time_ticks=12345)
    ref = jax_timing.BurstScheduler(cycle_interval_secs=2048 / 3.125e6,
                                    timing_advance_secs=1e-4, rx_time_ticks=12345)
    for now in ((0, 0.0), (0, 0.0), (3, 0.25), (3, 0.2), (7, 0.999999)):
        assert sched.next_tx_time(*now) == ref.next_tx_time(*now)
    assert (sched.rx_gain_windows(3, 0.5, 752, 3.125e6)
            == ref.rx_gain_windows(3, 0.5, 752, 3.125e6))
    for ticks in (0, 1, 999_999_999, 1_000_000_001, 12_345_678_901):
        assert timing.timespec_from_ticks(ticks) == jax_timing.timespec_from_ticks(ticks)
        assert (timing.ticks_from_timespec(*timing.timespec_from_ticks(ticks))
                == jax_timing.ticks_from_timespec(*jax_timing.timespec_from_ticks(ticks)))


def test_coded_link_over_both_services():
    """StreamingTransmitter(cycle_samples=chunk) -> a delayed stream + AWGN
    -> chunk_with_lookahead -> StreamingReceiver(fused, fec="conv").serve:
    chip_smoke.py phase 11's services link at 8 bursts."""
    n = 8
    cap = burst_capacity_bytes(TC, 2, "conv")
    payload = bytes(np.random.default_rng(6).integers(0, 256, n * cap, dtype=np.uint8))
    syms, nb = payload_to_symbols(TC, payload, fec="conv")
    planar = np.stack([syms.real, syms.imag], axis=1).astype(np.float32)
    tx = StreamingTransmitter(TC, cycle_samples=CHUNK, device="cpu")
    parts = []
    it = iter([planar[:5], planar[5:]])
    tx.serve(lambda: next(it, None), lambda out: parts.append(out["samples"]))
    rng = np.random.default_rng(7)
    delay = int(rng.integers(0, CHUNK - TC.frame_len))
    sig = np.concatenate(parts, axis=-1)
    sig = np.pad(sig, ((0, 0), (delay, CHUNK - delay)))
    power = float(np.mean(np.sum(parts[0][:, : TC.frame_len] ** 2, axis=0)))
    sig = sig + np.sqrt(power * 10 ** (-1.0) / 2) * rng.standard_normal(sig.shape)
    chunks = stream.chunk_with_lookahead(torch.from_numpy(sig.astype(np.float32)),
                                         CHUNK, HALO).transpose(0, 1).contiguous().numpy()
    assert chunks.shape == (nb + 1, 2, CHUNK + HALO)
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=4, engine="fused",
                                   fec="conv", device="cpu")
    outs = []
    src = iter([(chunks[:4], 0), (chunks[4:], 4 * CHUNK)])
    rx.serve(lambda: next(src, None), outs.append)
    found = np.concatenate([o["found"] for o in outs])
    bits = np.concatenate([o["bits"] for o in outs])
    starts = np.concatenate([o["start_abs"] for o in outs])
    assert found.tolist() == [True] * nb + [False]
    lag = starts[:nb] - (delay + CHUNK * np.arange(nb))  # the same detection lag
    assert np.all(lag == lag[0]) and 0 <= lag[0] <= TC.cp_len
    assert _payloads(bits[:nb], cap) == payload
