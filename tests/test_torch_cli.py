"""The port's CLI modem (gfdm_tpu_torch/cli.py, python -m gfdm_tpu_torch)
against the JAX package's gfdm_tpu.cli, on the CPU (``--device cpu``).

Captures interchange: a cf32 or sc16 file written by either package's
``tx`` decodes byte for byte in the other's ``rx``, uncoded and with
``--fec conv``, at qpsk / qam16 / qam64. ``tx_file`` is within 2e-5 of
JAX's (the Tx limit of tests/test_pallas.py). ``simulate`` draws its noise
from a CPU torch.Generator (not JAX's key), so its statistics are held,
not its draws: every burst clean at 20 dB, the estimate tracking the
nominal SNR dB for dB, the coded link at 4 dB above the CRC share the
JAX package's sensitivity test holds (0.9), the uncoded one below half.
Then the reference's CLI tests (tests/test_cli.py) on the port.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu import cli as jcli
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch import cli
from gfdm_tpu_torch.cli import (
    burst_capacity_bytes,
    main,
    payload_to_symbols,
    rx_file,
    simulate,
    symbols_to_payloads,
    tx_file,
)
from gfdm_tpu_torch.utils.framing import payload_capacity_bytes
from udp_loopback import free_udp_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def cfg():
    return GfdmConfig()


def _payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _main(argv):
    return main(["--device", "cpu"] + argv)


def test_info_json_equals_jax(capsys):
    for argv in (["info"], ["info", "-K", "32", "-M", "5", "--active-subcarriers", "24",
                            "--cp-len", "8", "--constellation", "qam64"]):
        assert jcli.main(argv) == 0
        want = json.loads(capsys.readouterr().out)
        assert main(argv) == 0  # info touches no device
        assert json.loads(capsys.readouterr().out) == want
    proc = subprocess.run([sys.executable, "-m", "gfdm_tpu_torch", "info"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["block_len"] == 576


@pytest.mark.parametrize("constellation,fec", [("qpsk", "none"), ("qam16", "conv")])
def test_tx_file_matches_jax(cfg, constellation, fec):
    payload = _payload(1, 300)
    got = tx_file(cfg, payload, scale=0.5, constellation=constellation, fec=fec, **CPU)
    want = jcli.tx_file(JaxConfig(), payload, scale=0.5, constellation=constellation, fec=fec)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("constellation,fec", [
    ("qpsk", "none"), ("qam16", "none"), ("qam64", "none"), ("qpsk", "conv"), ("qam16", "conv"),
])
def test_captures_interchange_with_jax(cfg, tmp_path, constellation, fec):
    """A capture written by either package's tx decodes byte-equal in the
    other's rx, in cf32 and sc16."""
    order = {"qpsk": 2, "qam16": 4, "qam64": 6}[constellation]
    payload = _payload(7, 2 * burst_capacity_bytes(cfg, order, fec) - 3)
    pin = tmp_path / "p.bin"
    pin.write_bytes(payload)
    flags = ["--constellation", constellation, "--fec", fec]
    mains = {"jax": jcli.main, "port": _main}
    for fmt in ("cf32", "sc16"):
        for writer, reader in (("jax", "port"), ("port", "jax")):
            iq = tmp_path / f"{writer}.{fmt}"
            out = tmp_path / f"{writer}_{reader}.{fmt}.bin"
            assert mains[writer](["tx", "--infile", str(pin), "--outfile", str(iq),
                                  "--iq-format", fmt] + flags) == 0
            assert mains[reader](["rx", "--infile", str(iq), "--outfile", str(out),
                                  "--iq-format", fmt] + flags) == 0, (writer, reader, fmt)
            assert out.read_bytes()[: len(payload)] == payload, (writer, reader, fmt)


def test_payload_symbol_roundtrip(cfg):
    cap = payload_capacity_bytes(cfg.n_data_symbols)
    payload = _payload(7, 3 * cap)
    syms, n = payload_to_symbols(cfg, payload)
    assert n == 3 and syms.shape == (3, cfg.n_data_symbols)
    np.testing.assert_allclose(np.abs(syms), 1.0, atol=1e-6)
    decoded = symbols_to_payloads(cfg, syms)
    assert all(ok for ok, _ in decoded)
    assert b"".join(p for _, p in decoded) == payload


def test_file_roundtrip_clean(cfg):
    cap = payload_capacity_bytes(cfg.n_data_symbols)
    payload = _payload(3, 2 * cap + 11)
    stream = tx_file(cfg, payload, **CPU)
    assert stream.size % cfg.padded_frame_len == 0
    got, stats = rx_file(cfg, stream, **CPU)
    assert stats["crc_ok"] == stats["bursts"] == 3
    assert got[: len(payload)] == payload


def test_truncated_and_clipping_captures(cfg, tmp_path, capsys):
    """Truncated sc16 files parse; tail drop and clipping are reported, as
    the JAX package reports them."""
    payload = _payload(9, payload_capacity_bytes(cfg.n_data_symbols))
    stream = tx_file(cfg, payload, **CPU)

    raw = (np.repeat(stream, 2).real * 1000).astype(np.int16)[:-1]
    p = tmp_path / "trunc.sc16"
    raw.tofile(p)
    got = cli._read_iq(str(p), "sc16")
    assert got.size == raw.size // 2
    np.testing.assert_array_equal(got, jcli._read_iq(str(p), "sc16"))

    tail = np.concatenate([stream, stream[:17]])
    _, stats = rx_file(cfg, tail, **CPU)
    err = capsys.readouterr().err
    _, jstats = jcli.rx_file(JaxConfig(), tail)
    assert stats["discarded_samples"] == jstats["discarded_samples"] == 17
    assert "warning: discarding 17 trailing samples" in err
    assert err == capsys.readouterr().err
    assert {k: stats[k] for k in ("bursts", "crc_ok", "bytes")} == {
        k: jstats[k] for k in ("bursts", "crc_ok", "bytes")}

    for name, scale in (("clip", 40.0), ("ok", 1.0)):
        cli._write_iq(str(tmp_path / f"{name}.sc16"), stream * scale, "sc16")
        port_err = capsys.readouterr().err
        jcli._write_iq(str(tmp_path / f"j{name}.sc16"), stream * scale, "sc16")
        assert port_err == capsys.readouterr().err
        assert ("sc16 clipping" in port_err) == (scale > 1)
        assert (tmp_path / f"{name}.sc16").read_bytes() == (
            tmp_path / f"j{name}.sc16").read_bytes()
    with pytest.raises(ValueError, match="stream too short"):
        rx_file(cfg, stream[:100], **CPU)


def test_qam16_roundtrip_and_capacity(cfg):
    cap16 = payload_capacity_bytes(cfg.n_data_symbols, 4)
    assert cap16 == 2 * payload_capacity_bytes(cfg.n_data_symbols, 2) + 4
    payload = _payload(11, 2 * cap16 - 5)
    syms, n = payload_to_symbols(cfg, payload, constellation="qam16")
    assert n == 2 and all(ok for ok, _ in symbols_to_payloads(cfg, syms, "qam16"))
    stream = tx_file(cfg, payload, constellation="qam16", **CPU)
    assert stream.size == 2 * cfg.padded_frame_len
    got, stats = rx_file(cfg, stream, constellation="qam16", **CPU)
    assert stats["crc_ok"] == stats["bursts"] == 2
    assert got[: len(payload)] == payload
    sim = simulate(cfg, n_bursts=4, snr_db=25.0, ic_iterations=2, seed=2,
                   constellation="qam16", **CPU)
    assert sim["crc_ok"] == 4 and sim["payload_intact"]


def test_qam64_roundtrip_and_capacity(cfg):
    cap64 = payload_capacity_bytes(cfg.n_data_symbols, 6)
    assert cap64 > 3 * payload_capacity_bytes(cfg.n_data_symbols, 2)
    assert cli.default_ic_iterations("qam64") == 4 == 2 * cli.default_ic_iterations("qam16")
    payload = _payload(12, 2 * cap64 - 7)
    stream = tx_file(cfg, payload, constellation="qam64", **CPU)
    assert stream.size == 2 * cfg.padded_frame_len
    got, stats = rx_file(cfg, stream, constellation="qam64", **CPU)
    assert stats["crc_ok"] == stats["bursts"] == 2
    assert got[: len(payload)] == payload
    # at the default 4 IC passes: at 2, a third of the qam64 bursts stay
    # unconverged at 40 dB in both packages (32 bursts, seed 2: 21 clean in
    # the JAX package, 22 here), so tests/test_cli.py's 4 of 4 at IC 2 is a
    # draw, not the link's behaviour
    sim = simulate(cfg, n_bursts=4, snr_db=40.0, seed=2, constellation="qam64", **CPU)
    assert sim["crc_ok"] == 4 and sim["payload_intact"]


def test_cli_qam16_flag(cfg, tmp_path, capsys):
    cap16 = payload_capacity_bytes(cfg.n_data_symbols, 4)
    payload = np.arange(cap16, dtype=np.uint8).tobytes()
    pin, iq, out = tmp_path / "p.bin", tmp_path / "iq.cf32", tmp_path / "out.bin"
    pin.write_bytes(payload)
    assert _main(["tx", "--constellation", "qam16", "--infile", str(pin),
                  "--outfile", str(iq)]) == 0
    assert _main(["rx", "--constellation", "qam16", "--infile", str(iq),
                  "--outfile", str(out)]) == 0
    assert out.read_bytes() == payload
    capsys.readouterr()
    assert main(["info", "--constellation", "qam16"]) == 0
    assert json.loads(capsys.readouterr().out)["payload_bytes_per_burst"] == cap16


def test_simulate_awgn_tracks_the_snr(cfg):
    stats = simulate(cfg, n_bursts=4, snr_db=20.0, ic_iterations=2, seed=1, **CPU)
    assert stats["crc_ok"] == stats["bursts"] == 4
    assert stats["payload_intact"] and stats["residual_bit_errors"] == 0
    lo = simulate(cfg, n_bursts=4, snr_db=12.0, ic_iterations=2, seed=1, **CPU)
    assert abs((stats["snr_db_est"] - lo["snr_db_est"]) - 8.0) <= 1.0
    again = simulate(cfg, n_bursts=4, snr_db=12.0, ic_iterations=2, seed=1, **CPU)
    assert again == lo
    assert set(stats) == set(jcli.simulate(JaxConfig(), n_bursts=1, snr_db=20.0))


def test_fec_coding_gain_in_simulate(cfg):
    """At 4 dB through the multipath channel the coded modem recovers at
    least 0.9 of the bursts, the uncoded one less than half."""
    n = 48
    coded = simulate(cfg, n_bursts=n, snr_db=4.0, fec="conv", seed=3, **CPU)
    uncoded = simulate(cfg, n_bursts=n, snr_db=4.0, seed=3, **CPU)
    assert coded["crc_ok"] >= 0.9 * n and coded["residual_bit_errors"] == 0
    assert uncoded["crc_ok"] < n / 2


def test_fec_payload_roundtrip_and_capacity(cfg):
    cap = burst_capacity_bytes(cfg, 2, "conv")
    cap_un = burst_capacity_bytes(cfg, 2, "none")
    assert 0 < cap < cap_un and cap >= cap_un // 2 - 8
    payload = _payload(17, 2 * cap)
    syms, n = payload_to_symbols(cfg, payload, fec="conv")
    assert n == 2
    decoded = symbols_to_payloads(cfg, syms, fec="conv", **CPU)
    assert all(ok for ok, _ in decoded)
    assert b"".join(p for _, p in decoded) == payload


def test_cli_fec_file_roundtrip(cfg, tmp_path):
    payload = _payload(23, 900)
    pin, iq, pout = tmp_path / "p.bin", tmp_path / "x.cf32", tmp_path / "out.bin"
    pin.write_bytes(payload)
    assert _main(["tx", "--infile", str(pin), "--outfile", str(iq), "--fec", "conv"]) == 0
    assert _main(["rx", "--infile", str(iq), "--outfile", str(pout), "--fec", "conv"]) == 0
    assert pout.read_bytes()[: len(payload)] == payload


def test_fec_with_dense_constellations(cfg):
    q16 = simulate(cfg, n_bursts=4, snr_db=12.0, fec="conv", constellation="qam16", seed=2,
                   **CPU)
    assert q16["crc_ok"] == 4 and q16["payload_intact"]
    q64 = simulate(cfg, n_bursts=4, snr_db=18.0, fec="conv", constellation="qam64", seed=2,
                   **CPU)
    assert q64["crc_ok"] == 4 and q64["payload_intact"]


def test_rx_exit_codes(cfg, tmp_path, capsys):
    """rx exits 1 when a burst fails its CRC, 2 without a source."""
    payload = _payload(5, payload_capacity_bytes(cfg.n_data_symbols))
    stream = tx_file(cfg, payload, **CPU).reshape(1, -1).copy()
    start = cfg.pre_padding_len + cfg.preamble_len + cfg.cp_len
    stream[0, start : start + 200] *= -1  # corrupt the payload section
    iq, out = tmp_path / "bad.cf32", tmp_path / "out.bin"
    cli._write_iq(str(iq), stream.reshape(-1), "cf32")
    assert _main(["rx", "--infile", str(iq), "--outfile", str(out)]) == 1
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1])["crc_ok"] == 0
    assert _main(["rx", "--outfile", str(out)]) == 2


def test_main_without_a_card_exits_naming_device_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["simulate", "--bursts", "1"],
                 ["rx", "--infile", str(tmp_path / "x"), "--outfile", str(tmp_path / "y")]):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code != 0
        assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(GfdmConfig(), n_bursts=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tx_file(GfdmConfig(), b"abc")
    assert main(["info"]) == 0  # info needs no card


def _send_when_bound(port, raw, errors, spd=512):
    """Send ``raw`` sc16 to udp:``port`` once a receiver is bound (a
    connected UDP socket sees ECONNREFUSED while nothing listens; 2-byte
    probes are below one sample and dropped), then the empty datagram."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.connect(("127.0.0.1", port))
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                for _ in range(3):
                    s.send(b"\x00\x00")
                    time.sleep(0.05)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    errors.append("receiver never bound the UDP port within 30 s")
                    return
                time.sleep(0.05)
        for i in range(0, raw.size, 2 * spd):
            s.send(raw[i : i + 2 * spd].tobytes())
            time.sleep(0.001)
        s.send(b"")
    except OSError as exc:
        errors.append(f"sender thread died: {exc!r}")
    finally:
        s.close()


def test_rx_udp_live_capture(cfg, tmp_path):
    """rx --udp-port: the sender streams the tx capture as sc16 datagrams
    (longer than the ring, which is pulled while the capture runs); rx
    recovers the payload."""
    from gfdm_tpu_torch.utils.converter import cf64_to_sc16

    payload = _payload(21, 2 * payload_capacity_bytes(cfg.n_data_symbols))
    stream = tx_file(cfg, payload, **CPU)
    raw = cf64_to_sc16(stream.astype(np.complex128))
    errors = []
    port = free_udp_port()
    t = threading.Thread(target=_send_when_bound, args=(port, raw, errors))
    t.start()
    out = tmp_path / "udp_out.bin"
    rc = _main(["rx", "--udp-port", str(port), "--udp-timeout", "15", "--outfile", str(out)])
    t.join()
    assert not errors, errors
    assert rc == 0
    assert out.read_bytes() == payload

    # rx_udp alone, with a ring smaller than the stream
    port = free_udp_port()
    t = threading.Thread(target=_send_when_bound, args=(port, raw, errors))
    t.start()
    got = cli.rx_udp(port, timeout_s=15, max_samples=8192)
    t.join()
    assert not errors, errors
    np.testing.assert_allclose(got, stream, rtol=0, atol=2.0 / cli.SC16_SCALE)
