"""The port's native host runtime (gfdm_tpu_torch.native over its copy of
native/gfdm_host.cpp, and gfdm_tpu_torch.utils.converter) against the JAX
package's: a counterpart of each test of tests/test_native.py, the same
pushes into both packages' rings, the converters bit for bit, and the build
that raises instead of falling back to NumPy.

Every UDP test binds a free port (tests/udp_loopback.py).
"""
import filecmp
import os
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gfdm_tpu import native as jnative
from gfdm_tpu.utils import converter as jconverter
from gfdm_tpu_torch import native
from gfdm_tpu_torch.utils import converter
from udp_loopback import udp_ingest

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ---------------------------------------------------------------------------
# the source, the build, the converters
# ---------------------------------------------------------------------------
def test_host_source_is_the_jax_packages():
    assert filecmp.cmp(ROOT / "gfdm_tpu_torch/csrc/gfdm_host.cpp",
                       ROOT / "native/gfdm_host.cpp", shallow=False)
    assert native.SOURCE == ROOT / "gfdm_tpu_torch/csrc/gfdm_host.cpp"


def test_build_goes_under_the_build_dir():
    from gfdm_tpu_torch.kernels.cuda_lib import build_dir

    assert native.available()
    path = native._build()
    assert path.parent == build_dir() and path.name.startswith("libgfdm_host_")
    assert native._build() == path  # cached by the source's hash


def test_failed_build_raises_with_the_log(tmp_path):
    with pytest.raises(RuntimeError, match="cannot read .*missing.cpp"):
        native._build(source=tmp_path / "missing.cpp", out_dir=tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="error") as err:
        native._build(source=bad, out_dir=tmp_path)
    assert "bad.cpp" in str(err.value)
    with pytest.raises(RuntimeError, match="cannot run"):
        native._build(cxx=str(tmp_path / "no-such-g++"), out_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_no_numpy_fallback_when_the_build_fails(monkeypatch):
    """With the library unbuildable every entry raises; nothing converts in
    NumPy or returns False."""
    def broken(*args, **kw):
        raise RuntimeError("native host library: g++ failed")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build", broken)
    raw = np.zeros(8, np.int16)
    for call in (native.available, lambda: native.sc16_to_planar(raw),
                 lambda: native.planar_to_sc16(np.zeros((2, 4), np.float32)),
                 lambda: native.StreamBuffer(1024, 256, 0)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()


def _sc16_to_planar_ref(raw, scale=native.SC16_SCALE):
    """The native rule: int16 -> float32, times the float32 reciprocal."""
    f = np.asarray(raw, np.int16).reshape(-1, 2).astype(np.float32)
    k = np.float32(1.0) / np.float32(scale)
    return np.stack([f[:, 0] * k, f[:, 1] * k])


def _planar_to_sc16_ref(planar, scale=native.SC16_SCALE):
    """The JAX wrapper's NumPy form (gfdm_tpu/native/__init__.py:143-147)."""
    planar = np.asarray(planar, np.float32)
    out = np.empty(2 * planar.shape[-1], np.int16)
    out[0::2] = np.clip(np.round(planar[0] * scale), -32768, 32767)
    out[1::2] = np.clip(np.round(planar[1] * scale), -32768, 32767)
    return out


def test_converters_bit_equal():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 1003)) * 0.4).astype(np.float32)
    x[0, :4] = [1.5, -1.5, 0.5 / 32767, 1.5 / 32767]  # saturation and ties
    raw = native.planar_to_sc16(x)
    np.testing.assert_array_equal(raw, jnative.planar_to_sc16(x))
    np.testing.assert_array_equal(raw, _planar_to_sc16_ref(x))
    for scale in (native.SC16_SCALE, 8191.0):
        back = native.sc16_to_planar(raw, scale)
        np.testing.assert_array_equal(back, jnative.sc16_to_planar(raw, scale))
        np.testing.assert_array_equal(back, _sc16_to_planar_ref(raw, scale))
        # the JAX wrapper's NumPy form divides: within one ulp of the product
        div = raw.astype(np.float32).reshape(-1, 2).T / scale
        np.testing.assert_array_max_ulp(back, div.astype(np.float32), maxulp=1)
    c = x[0] + 1j * x[1]
    np.testing.assert_array_equal(converter.cf64_to_sc16(c), jconverter.cf64_to_sc16(c))
    np.testing.assert_array_equal(converter.sc16_to_cf64(raw), jconverter.sc16_to_cf64(raw))
    assert converter.SC16_SCALE == jconverter.SC16_SCALE == native.SC16_SCALE


def test_sc16_planar_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 500)) * 0.2).astype(np.float32)
    raw = native.planar_to_sc16(x)
    assert raw.dtype == np.int16 and raw.size == 1000
    np.testing.assert_allclose(native.sc16_to_planar(raw), x, atol=1e-4)
    c = converter.sc16_to_cf64(raw)
    np.testing.assert_allclose(c.real, x[0], atol=1e-4)
    np.testing.assert_allclose(c.imag, x[1], atol=1e-4)


def test_bits_qpsk_roundtrip():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (333, 2)).astype(np.uint8)
    sym = native.bits_to_qpsk_planar(bits)
    np.testing.assert_array_equal(sym, jnative.bits_to_qpsk_planar(bits))
    a = np.float32(1.0 / np.sqrt(2.0))
    np.testing.assert_array_equal(sym, np.where(bits.T > 0, -a, a))
    np.testing.assert_array_equal(native.qpsk_planar_to_bits(sym), bits)
    np.testing.assert_array_equal(jnative.qpsk_planar_to_bits(sym), bits)


# ---------------------------------------------------------------------------
# the ring, the bank
# ---------------------------------------------------------------------------
def test_stream_buffer_framing():
    chunk, halo = 64, 16
    sb = native.StreamBuffer(capacity=1024, chunk_len=chunk, halo=halo)
    total = 300
    sig = np.stack([np.arange(total, dtype=np.float32), -np.arange(total, dtype=np.float32)])
    sb.push(sig[:, :100])
    sb.push(sig[:, 100:])
    assert sb.available_chunks == 4  # floor((300 - halo) / chunk)
    chunks, base = sb.pull(10)
    assert base == 0 and chunks.shape == (4, 2, chunk + halo)
    for c in range(4):
        np.testing.assert_array_equal(chunks[c, 0], np.arange(c * chunk, c * chunk + chunk + halo))
        np.testing.assert_array_equal(chunks[c, 1], -np.arange(c * chunk, c * chunk + chunk + halo))
    assert sb.available_chunks == 0


def test_stream_buffer_overflow_drops_oldest():
    chunk, halo = 32, 8
    sb = native.StreamBuffer(capacity=128, chunk_len=chunk, halo=halo)
    sig = np.stack([np.arange(400, dtype=np.float32)] * 2)
    assert sb.dropped == 0
    dropped = sb.push(sig)
    assert dropped > 0 and sb.dropped == dropped
    chunks, base = sb.pull(100)
    assert chunks.shape[0] >= 1
    first = chunks[0, 0, 0]
    np.testing.assert_array_equal(chunks[0, 0], np.arange(first, first + chunk + halo))
    assert base == int(first)


@pytest.mark.parametrize("pieces", [(300,), (100, 257, 411, 1500), (5000,)])
def test_pushes_pull_as_the_jax_packages_ring(pieces):
    """The same pushes (planar and sc16, past the capacity) into both
    packages' rings: equal pulls, bases and drop counts."""
    rng = np.random.default_rng(len(pieces))
    rings = [m.StreamBuffer(capacity=2048, chunk_len=256, halo=96) for m in (native, jnative)]
    for i, n in enumerate(pieces):
        x = rng.standard_normal((2, n)).astype(np.float32)
        raw = rng.integers(-30000, 30000, 2 * n, dtype=np.int16)
        for r in rings:
            r.push_sc16(raw) if i % 2 else r.push(x)
        assert rings[0].dropped == rings[1].dropped
        assert rings[0].available_chunks == rings[1].available_chunks
        (a, ba), (b, bb) = rings[0].pull(3), rings[1].pull(3)
        assert ba == bb
        np.testing.assert_array_equal(a, b)


def test_stream_buffer_feeds_receiver():
    """Native framing -> the port's planar receiver (CPU) finds the burst."""
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.ops import planar as pl
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.ops import tx

    cfg = GfdmConfig()
    chunk_len, halo = 2048, cfg.frame_len + cfg.cp_len
    rng = np.random.default_rng(3)
    data = ((rng.integers(0, 2, cfg.n_data_symbols) * 2 - 1)
            + 1j * (rng.integers(0, 2, cfg.n_data_symbols) * 2 - 1)) / np.sqrt(2.0)
    burst = tx.transmit(cfg, data[None], device="cpu")[0, 0].numpy()
    stream = np.zeros(3 * chunk_len, dtype=np.complex64)
    stream[500 : 500 + cfg.frame_len] = burst
    sb = native.StreamBuffer(capacity=8 * chunk_len, chunk_len=chunk_len, halo=halo)
    sb.push(pl.to_planar(stream))
    chunks, base = sb.pull(8)
    assert chunks.shape[0] == 2 and base == 0
    c = torch.from_numpy(chunks)
    det = pp.detect_bursts_planar(cfg, c)
    assert int(det["start"][0]) == 500 + cfg.cp_len
    out = pp.receive_bursts_planar(cfg, pp.extract_bursts_planar(cfg, c, det), ic_iterations=2)
    d_hat = pl.from_planar(out["data"].numpy())[0]
    np.testing.assert_array_equal(np.sign(d_hat.real), np.sign(data.real))
    np.testing.assert_array_equal(np.sign(d_hat.imag), np.sign(data.imag))


def test_stream_push_sc16_fused():
    rng = np.random.default_rng(7)
    raw = rng.integers(-20000, 20000, 4096, dtype=np.int16)
    sb1 = native.StreamBuffer(capacity=8192, chunk_len=512, halo=128)
    sb1.push_sc16(raw)
    sb2 = native.StreamBuffer(capacity=8192, chunk_len=512, halo=128)
    sb2.push(native.sc16_to_planar(raw))
    (c1, b1), (c2, b2) = sb1.pull(8), sb2.pull(8)
    assert b1 == b2
    np.testing.assert_array_equal(c1, c2)


def test_stream_bank_aligned_multichannel():
    n_ch, chunk, halo = 2, 256, 64
    banks = [m.StreamBank(n_ch, capacity=4096, chunk_len=chunk, halo=halo)
             for m in (native, jnative)]
    rng = np.random.default_rng(8)
    sig = [rng.standard_normal((2, 1024)).astype(np.float32) for _ in range(n_ch)]
    for bank in banks:  # channel 1 pushes in two unequal pieces
        bank.push(0, sig[0])
        bank.push(1, sig[1][:, :300])
        bank.push(1, sig[1][:, 300:])
        assert bank.available_chunks == (1024 - halo) // chunk
    (out, base), (jout, jbase) = banks[0].pull(8), banks[1].pull(8)
    assert base == jbase == 0 and out.shape == ((1024 - halo) // chunk, n_ch, 2, chunk + halo)
    np.testing.assert_array_equal(out, jout)
    for c in range(n_ch):
        for k in range(out.shape[0]):
            np.testing.assert_array_equal(out[k, c], sig[c][:, k * chunk : k * chunk + chunk + halo])
    with pytest.raises(ValueError, match="channel 2"):
        banks[0].push(2, sig[0])


# ---------------------------------------------------------------------------
# the ingest threads
# ---------------------------------------------------------------------------
def test_file_ingest_background_thread(tmp_path):
    rng = np.random.default_rng(9)
    raw = rng.integers(-10000, 10000, 2 * 4096, dtype=np.int16)
    path = tmp_path / "capture.sc16"
    raw.tofile(path)
    sb = native.StreamBuffer(capacity=16384, chunk_len=1024, halo=256)
    ing = native.FileIngest(str(path), sb, block_samples=512)
    assert _wait(lambda: not ing.running)
    assert ing.poll() == 4096 and ing.finish() == 4096 and ing.finish() == 0
    chunks, base = sb.pull(8)
    assert base == 0 and chunks.shape[0] == 3
    np.testing.assert_array_equal(chunks[0], native.sc16_to_planar(raw)[:, : 1024 + 256])


def test_stream_buffer_concurrent_producer_consumer(tmp_path):
    """SPSC ring under real threading: the native ingest thread pushes while
    the consumer pulls; every chunk comes out once, in order, intact."""
    chunk, halo = 512, 128
    n_total = 64 * chunk
    ramp = (np.arange(n_total) % 8191).astype(np.float32)
    planar = np.stack([ramp, -ramp])
    path = tmp_path / "ramp.sc16"
    native.planar_to_sc16(planar / 8191.0, scale=8191.0).tofile(path)
    sb = native.StreamBuffer(capacity=n_total + 2 * chunk, chunk_len=chunk, halo=halo)
    ing = native.FileIngest(str(path), sb, scale=8191.0, block_samples=chunk // 2)
    got = []
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        chunks, base = sb.pull(4)
        if chunks.shape[0]:
            got.append((base, chunks))
        elif not ing.running:
            if sb.available_chunks == 0:
                break
        else:
            time.sleep(0.0005)
    assert ing.finish() == n_total
    seen = 0
    for base, chunks in got:
        assert base == seen * chunk
        for c in chunks:
            ref = planar[:, seen * chunk : seen * chunk + chunk + halo]
            np.testing.assert_allclose(c[:, : ref.shape[-1]], ref / 8191.0, atol=2e-4)
            seen += 1
    assert seen == 64 - 1  # the last chunk's halo completes only at EOF padding


def test_udp_ingest_background_thread():
    rng = np.random.default_rng(11)
    raw = rng.integers(-10000, 10000, 2 * 4096, dtype=np.int16)
    sb = native.StreamBuffer(capacity=16384, chunk_len=1024, halo=256)
    ing = udp_ingest(native, sb)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.sendto(b"\x01\x02", ("127.0.0.1", ing.port))  # a probe: pushed nowhere
        for i in range(8):  # 8 datagrams of 512 samples, then end of stream
            sock.sendto(raw[i * 1024 : (i + 1) * 1024].tobytes(), ("127.0.0.1", ing.port))
            assert _wait(lambda i=i: sb.available_chunks >= ((i + 1) * 512 - 256) // 1024)
        sock.sendto(b"", ("127.0.0.1", ing.port))
        assert _wait(lambda: not ing.running)
    assert ing.finish() == 4096
    chunks, base = sb.pull(8)
    assert base == 0 and chunks.shape[0] == 3
    np.testing.assert_array_equal(chunks[0], native.sc16_to_planar(raw)[:, : 1024 + 256])


def test_udp_ingest_stop_request_and_busy_port():
    sb = native.StreamBuffer(capacity=4096, chunk_len=512, halo=0)
    ing = udp_ingest(native, sb)
    assert ing.running and ing.poll() == -1
    with pytest.raises(OSError, match=f"udp:{ing.port}"):
        native.UdpIngest(ing.port, sb)  # no SO_REUSEADDR: a busy port fails
    ing.stop()
    assert _wait(lambda: not ing.running, timeout=5.0)
    assert ing.finish() == 0


def test_concurrent_first_builds(tmp_path, monkeypatch):
    """Builders racing on one directory (tier-1's workers): each writes a
    temporary name and renames it, so all return the same complete file."""
    monkeypatch.setenv("GFDM_TPU_TORCH_BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def build():
        try:
            paths.append(native._build())
        except RuntimeError as exc:  # pragma: no cover - reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and os.path.getsize(paths[0]) > 0
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
