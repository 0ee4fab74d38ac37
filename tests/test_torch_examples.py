"""The port's examples (gfdm_tpu_torch/examples) at a few bursts on the CPU:
each main runs through and prints what its JAX counterpart prints."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfdm_tpu_torch.examples import ber_sweep, coded_link, loopback_simulation
from gfdm_tpu_torch.examples import ota_style_link, parse_device, spectrum_study
from gfdm_tpu_torch.examples import cdd_two_antenna, coded_service, full_duplex_udp
from gfdm_tpu_torch.examples import large_k_link, multichip_sharding, stream_receiver
from gfdm_tpu_torch.examples import streaming_service

torch.set_num_threads(1)

CPU = {"device": "cpu"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loopback_simulation(capsys):
    res = loopback_simulation.main(batch=4, **CPU)
    assert res["ber"] == 0.0 and res["evm"] < 0.15
    np.testing.assert_array_equal(res["start"], res["expected_start"])
    np.testing.assert_allclose(res["cfo"], 0.03, atol=0.01)
    assert "BER=0.00000" in capsys.readouterr().out


def test_ota_style_link(capsys):
    res = ota_style_link.main(n_bursts=3, **CPU)
    assert res["crc_verified"] == 3 and len(res["stamps"]) == 3
    assert "CRC-verified bursts: 3/3 at 18 dB SNR" in capsys.readouterr().out


def test_ber_sweep_and_multipath_comparison(capsys):
    res = ber_sweep.main(bursts_per_point=2, **CPU)
    assert list(res) == ["qpsk", "qam16", "qam64"]
    for name, snrs, _ in ber_sweep.SWEEPS:
        np.testing.assert_array_equal(res[name]["snr_db"], snrs)
        assert res[name]["ber"][0] > res[name]["ber"][-1]
    res = ber_sweep.multipath_comparison(bursts_per_point=2, **CPU)
    assert sorted(res) == ["mmse", "mmse_cnr", "zf"]
    out = capsys.readouterr().out
    assert "--- qam64 (ic=4) ---" in out and "multipath (8-tap Rayleigh, qam16)" in out


def test_coded_link(capsys):
    res = coded_link.main(bursts=2, multipath_bursts=2, **CPU)
    np.testing.assert_array_equal(res["awgn"]["ebn0_db"], coded_link.EBN0_DB)
    assert sorted(res["multipath"]) == list(coded_link.MULTIPATH_EBN0_DB)
    assert "coded vs uncoded at equal Eb/N0" in capsys.readouterr().out


def test_spectrum_study(capsys, tmp_path):
    pytest.importorskip("matplotlib")
    png = tmp_path / "spectrum.png"
    res = spectrum_study.main(n_bursts=4, png=str(png), **CPU)
    oob = {k: v["oob_attenuation_db"] for k, v in res.items()}
    assert oob["gfdm_frame"] > oob["gfdm_core"] > oob["ofdm"]
    assert png.stat().st_size > 0
    assert "wrote" in capsys.readouterr().out


def test_example_command_line(monkeypatch):
    assert parse_device("x", ["--device", "cpu"]) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        parse_device("x", [])
    assert exc.value.code == 2
    proc = subprocess.run([sys.executable, "-m", "gfdm_tpu_torch.examples.ota_style_link",
                           "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "CRC-verified bursts: 8/8" in proc.stdout


def _free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cdd_two_antenna(capsys):
    res = cdd_two_antenna.main(**CPU)
    assert res["symbols"] == 8 * 468
    assert res["symbol_errors"] <= cdd_two_antenna.SYMBOL_ERROR_FLOOR * res["symbols"]
    assert res["evm"] < 0.1 and res["snr_est_db"] > 28.0
    out = capsys.readouterr().out
    assert "combined 2-antenna link @ 28 dB" in out and "OK: effective CDD channel" in out


def test_coded_service(capsys):
    res = coded_service.main(n_bursts=3, **CPU)
    assert res == {"found": 3, "crc_clean": 3, "bursts": 3, "intact": True}
    out = capsys.readouterr().out
    assert "CRC-clean: 3/3 at 10 dB SNR" in out and "payload intact: True" in out


def test_full_duplex_udp(capsys):
    res = full_duplex_udp.main(n_bursts=4, port=_free_udp_port(), **CPU)
    assert res["found"] == 4 and res["evm"] == 0.0
    assert res["ingested"] == res["sent"] + 768  # the halo flush
    assert "rx: 4/4 bursts recovered" in capsys.readouterr().out


def test_large_k_link(capsys):
    res = large_k_link.main(batch=2, **CPU)
    assert res["evm"] < 1e-5 and res["symbol_error_share"] == 0.0
    assert "K=256 M=9 frame_len=3008" in capsys.readouterr().out


def test_stream_receiver(capsys):
    res = stream_receiver.main(n_bursts=4, **CPU)
    assert res["pulled"] == 3 and res["found"] == 3 and res["base"] == 0
    assert res["evm"] < 1e-5
    np.testing.assert_array_equal(res["start"], [200 + 37 * i + 16 for i in range(3)])
    assert "bursts found: 3/3 pulled chunks" in capsys.readouterr().out


def test_streaming_service(capsys):
    res = streaming_service.main(n_chunks=8, n_bursts=3, **CPU)
    assert res["dp"] == 1 and res["found"] == 3 and res["symbol_errors"] == 0
    assert res["starts"] == res["expected_starts"]
    out = capsys.readouterr().out
    assert "mesh: dp=1 devices, chunk=2048, halo=768" in out
    assert "symbol errors across 3 bursts: 0" in out
    assert "host ms a batch: " in out and "stage" in out
    assert {"gfdm.service.stage", "gfdm.service.step", "gfdm.service.fetch.wait",
            "gfdm.service.fetch.copy", "gfdm.service.sink"} <= set(res["host_s"])


def test_multichip_sharding(capsys):
    res = multichip_sharding.main(**CPU)
    assert (res["dp"], res["sp"], res["sp_serve_found"]) == (4, 2, 4)
    assert np.isfinite(res["evm"]) and res["evm"] < 0.05
    assert "dryrun_multichip: mesh dp=4 sp=2, batch=8" in capsys.readouterr().out
