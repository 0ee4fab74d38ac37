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
