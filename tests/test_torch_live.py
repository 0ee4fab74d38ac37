"""The live-ring modem on the port, on the CPU, against the JAX package's:
StreamingTransmitter -> native StreamBuffer -> StreamingReceiver, and the
same over a real socket (UdpSink -> UdpIngest), with 8 bursts as
tests/test_transmit_service.py:65-146 runs them. Found slots and starts
equal to the JAX chain's on the same payloads; payloads within 1e-4 (the
receiver tolerance of tests/test_torch_fused.py); every hard decision right.
Every UDP test binds a free port (tests/udp_loopback.py).
"""
import time

import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu import native as jnative
from gfdm_tpu.runtime.service import StreamingReceiver as JaxReceiver
from gfdm_tpu.runtime.transmit_service import StreamingTransmitter as JaxTransmitter
from gfdm_tpu.runtime.transmit_service import UdpSink as JaxUdpSink
from gfdm_tpu_torch import GfdmConfig, native
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.runtime.service import StreamingReceiver
from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter, UdpSink
from udp_loopback import udp_ingest

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
N_BURSTS, CHUNK = 8, 2048
HALO = TC.frame_len + TC.cp_len
DATA_ATOL = 1e-4


def _collect(outs):
    return {k: np.concatenate([o[k] for o in outs]) for k in ("found", "start_abs", "data")}


def _check_chain(got, payloads, cycle):
    """All bursts found on the cycle grid, every hard decision right."""
    f = got["found"]
    assert f.sum() == N_BURSTS
    order = np.argsort(got["start_abs"][f])
    np.testing.assert_array_equal(got["start_abs"][f][order],
                                  np.arange(N_BURSTS) * cycle + TC.cp_len)
    np.testing.assert_array_equal(np.sign(got["data"][f][order]), np.sign(payloads))


def _same_as_jax(got, ref):
    np.testing.assert_array_equal(got["found"], ref["found"])
    np.testing.assert_array_equal(got["start_abs"], ref["start_abs"])
    f = ref["found"]
    np.testing.assert_allclose(got["data"][f], ref["data"][f], atol=DATA_ATOL)


def _ring_loopback(pkg, payloads, **rx_kw):
    ring_mod, Tx, Rx, cfg = pkg
    ring = ring_mod.StreamBuffer(capacity=32 * CHUNK, chunk_len=CHUNK, halo=HALO)
    tx = Tx(cfg, batch_bursts=4, **({"device": "cpu"} if Tx is StreamingTransmitter else {}))
    assert tx.cycle_samples == CHUNK  # canonical padding == chunk grid
    batches = iter([payloads[:4], payloads[4:]])
    tx.serve(lambda: next(batches, None), ring)
    ring.push(np.zeros((2, HALO), np.float32))  # flush the tail chunk
    rx = Rx(cfg, chunk_len=CHUNK, batch_chunks=4, **rx_kw)
    outs = []
    stats = rx.serve(ring, outs.append)
    assert stats.dropped_ring == 0
    return _collect(outs), tx.cycle_samples


PORT = (native, StreamingTransmitter, StreamingReceiver, TC)
JAX = (jnative, JaxTransmitter, JaxReceiver, JC)


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_ring_loopback_matches_jax(engine):
    payloads = planar_payload(TC, N_BURSTS, seed=7)
    ref, _ = _ring_loopback(JAX, payloads)
    got, cycle = _ring_loopback(PORT, payloads, engine=engine, device="cpu")
    _check_chain(got, payloads, cycle)
    _same_as_jax(got, ref)


def _udp_loopback(pkg, sink_cls, payloads, **rx_kw):
    ring_mod, Tx, Rx, cfg = pkg
    ring = ring_mod.StreamBuffer(capacity=32 * CHUNK, chunk_len=CHUNK, halo=HALO)
    ing = udp_ingest(ring_mod, ring)
    tx = Tx(cfg, batch_bursts=4, scale=0.5,
            **({"device": "cpu"} if Tx is StreamingTransmitter else {}))
    sink = sink_cls(ing.port)
    batches = iter([payloads[:4], payloads[4:]])
    tx.serve(lambda: next(batches, None), sink)
    sink.push(np.zeros((2, HALO), np.float32))  # flush the tail chunk
    sink.close()  # end-of-stream datagram
    deadline = time.monotonic() + 10.0
    while ing.running and time.monotonic() < deadline:
        time.sleep(0.005)
    saw_end = not ing.running
    ing.stop()  # ends the thread if the end-of-stream datagram was lost
    assert ing.finish() == tx.stats.samples + HALO == sink.samples_sent
    # 4,096-sample datagrams: two batches of 8,192 samples, then the halo
    assert sink.datagrams_sent == 2 * 2 + 1 and saw_end
    rx = Rx(cfg, chunk_len=CHUNK, batch_chunks=4, **rx_kw)
    outs = []
    rx.serve(ring, outs.append)
    return _collect(outs), tx.cycle_samples


def test_udp_loopback_matches_jax():
    payloads = planar_payload(TC, N_BURSTS, seed=29)
    ref, _ = _udp_loopback(JAX, JaxUdpSink, payloads)
    got, cycle = _udp_loopback(PORT, UdpSink, payloads, engine="fused", device="cpu")
    _check_chain(got, payloads, cycle)
    _same_as_jax(got, ref)


def test_udp_sink_datagrams_gain_and_close():
    """Datagrams of at most samples_per_datagram samples, scaled by gain;
    close() sends one zero-length datagram and is idempotent."""
    import socket

    rx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx_sock.bind(("127.0.0.1", 0))
    rx_sock.settimeout(5.0)
    try:
        sink = UdpSink(rx_sock.getsockname()[1], samples_per_datagram=100, gain=0.5)
        x = (np.random.default_rng(3).standard_normal((2, 250)) * 0.3).astype(np.float32)
        sink.push(x)
        assert sink.datagrams_sent == 3 and sink.samples_sent == 250
        sizes, payload = [], b""
        for _ in range(3):
            d = rx_sock.recv(65536)
            sizes.append(len(d))
            payload += d
        assert sizes == [400, 400, 200]  # 4 bytes a sample
        np.testing.assert_array_equal(np.frombuffer(payload, np.int16),
                                      native.planar_to_sc16(x * np.float32(0.5)))
        sink.close()
        assert rx_sock.recv(65536) == b""
        sink.close()  # no second end-of-stream datagram, no error
        with pytest.raises(RuntimeError, match="closed"):
            sink.push(x)
        sink2 = UdpSink(rx_sock.getsockname()[1])
        sink2.close(end_of_stream=False)
        rx_sock.settimeout(0.2)
        with pytest.raises(socket.timeout):
            rx_sock.recv(65536)
    finally:
        rx_sock.close()
