"""The port's evaluation harnesses (gfdm_tpu_torch/eval: ber, coded,
snr_study, spectrum, plotting) against the JAX package's on the same
inputs, on the CPU.

The BER and coded links take the unit taps and noise as tensors: the tests
draw them from the jax.random keys the JAX composite splits inside, so both
packages see the same channel. Limits: bit-error counts within max(2, 1e-4
x bits) a point (float32 sums in another order can flip a decision within
~1e-5 of a level boundary), EVM and the mean SNR estimate within 1e-4
relative, decoded bits differing in at most 1e-3 of the bursts; the SNR
study (NumPy noise in both) within 5e-3 dB; the spectrum measures (float64
in both) within 1e-9 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.eval import ber as jber
from gfdm_tpu.eval import coded as jcoded
from gfdm_tpu.eval import snr_study as jsnr
from gfdm_tpu.eval import spectrum as jspec
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.eval import ber, coded, snr_study, spectrum

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
B = 24


def _draws(key, shapes):
    """The unit normal draws jax.random makes from the keys the JAX
    composites split off ``key`` (channel key, then noise key)."""
    _, k_ch, k_n = jax.random.split(key, 3)
    return [torch.from_numpy(np.asarray(jax.random.normal(k, s), np.float32))
            for k, s in zip((k_ch, k_n), shapes)]


def _count_limit(n_bits: int) -> float:
    return max(2.0, 1e-4 * n_bits)


@pytest.mark.parametrize("constellation,channel,snr_db,ic,equalizer,cfo", [
    ("qpsk", "awgn", 6.0, 2, "zf", 0.0),
    ("qpsk", "awgn", 9.0, 2, "zf", 0.02),
    ("qam16", "multipath", 15.0, 2, "mmse_cnr", 0.0),
    ("qam16", "multipath", 12.0, 2, "mmse", 0.0),
    ("qam64", "awgn", 24.0, 4, "zf", 0.0),
])
def test_ber_point_matches_jax_on_the_same_noise(constellation, channel, snr_db, ic,
                                                 equalizer, cfo):
    order = {"qpsk": 2, "qam16": 4, "qam64": 6}[constellation]
    bits = np.random.default_rng(1).integers(0, 2, (B, JC.n_data_symbols, order))
    key = jax.random.PRNGKey(5)
    jfn = jber._sweep_fn(JC, ic, constellation, equalizer, channel, 8, cfo)
    j_err, j_evm, j_snr = (float(v) for v in jfn(key, jnp.float32(snr_db), jnp.asarray(bits)))
    taps, noise = _draws(key, [(B, 2, 8), (B, 2, JC.frame_len)])
    tfn = ber._sweep_fn(TC, ic, constellation, equalizer, channel, 8, cfo)
    t_err, t_evm, t_snr = (float(v) for v in tfn(snr_db, bits, noise, taps))
    assert j_err > 0  # a point with errors to count
    assert abs(t_err - j_err) <= _count_limit(bits.size), (t_err, j_err)
    assert abs(t_evm / j_evm - 1) < 1e-4
    assert abs(t_snr / j_snr - 1) < 1e-4


def test_channel_helpers_match_jax():
    rng = np.random.default_rng(3)
    bursts = rng.standard_normal((4, 2, JC.frame_len)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jber._apply_multipath(key, jnp.asarray(bursts), 6, decay=0.5))
    unit = torch.from_numpy(np.asarray(jax.random.normal(key, (4, 2, 6)), np.float32))
    got = ber._apply_multipath(unit, torch.from_numpy(bursts), 6, decay=0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want = np.asarray(jber._apply_cfo(JC, jnp.asarray(bursts), 0.07))
    got = ber._apply_cfo(TC, torch.from_numpy(bursts), 0.07)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bits = rng.integers(0, 2, (3, 10, 2))
    pl = ber.qpsk_bits_to_planar(bits)
    np.testing.assert_array_equal(pl, jber.qpsk_bits_to_planar(bits))
    np.testing.assert_array_equal(ber.planar_to_bits(pl, device="cpu").numpy(),
                                  np.asarray(jber.planar_to_bits(pl)))
    with pytest.raises(ValueError, match="unit draws"):
        ber._apply_multipath(unit[:, :, :3], torch.from_numpy(bursts), 6)


def test_ber_sweep_api_on_cpu():
    res = ber.ber_sweep(TC, [0.0, 12.0], bursts_per_point=8, seed=2, device="cpu")
    assert set(res) == {"snr_db", "ber", "evm", "snr_est_db"}
    assert res["ber"].shape == (2,) and res["ber"][0] > res["ber"][1]
    again = ber.ber_sweep(TC, [0.0, 12.0], bursts_per_point=8, seed=2, device="cpu")
    np.testing.assert_array_equal(res["ber"], again["ber"])
    with pytest.raises(ValueError, match="channel model"):
        ber.ber_sweep(TC, [0.0], channel="rician", device="cpu")


@pytest.mark.parametrize("channel,equalizer,ebn0", [
    ("awgn", "zf", 2.0),
    ("multipath", "mmse_cnr", 6.0),
])
def test_coded_point_matches_jax_on_the_same_noise(channel, equalizer, ebn0):
    n = 16
    jfn, n_info, perm = jcoded._coded_fn(JC, 2, equalizer, channel, 8)
    _, tfn, t_info, t_perm = coded._coded_fn(TC, 2, equalizer, channel, 8)
    assert n_info == t_info
    np.testing.assert_array_equal(perm, t_perm)
    bits = np.random.default_rng(4).integers(0, 2, (n, n_info)).astype(np.uint8)
    cb = jcoded.conv_encode(bits)[..., perm]
    key = jax.random.PRNGKey(21)
    want = np.asarray(jfn(key, jnp.float32(ebn0), jnp.asarray(cb)))
    taps, noise = _draws(key, [(n, 2, 8), (n, 2, JC.frame_len)])
    got = tfn(ebn0, cb, noise, taps).numpy()
    assert np.mean(want != bits) > 0  # a point with errors to correct
    rows = np.count_nonzero(np.any(got != want, axis=-1))
    assert rows <= 1e-3 * n, rows


def test_coded_vs_uncoded_api_on_cpu():
    res = coded.coded_vs_uncoded(TC, [3.0], bursts=8, seed=1, device="cpu")
    assert set(res) == {"ebn0_db", "coded_ber", "uncoded_ber"}
    assert res["coded_ber"][0] <= res["uncoded_ber"][0]
    assert coded.coded_ber_point(TC, 3.0, bursts=8, seed=1, device="cpu") == res["coded_ber"][0]


@pytest.mark.parametrize("in_band", [True, False])
def test_snr_estimator_study_matches_jax(in_band):
    snrs = [0.0, 10.0, 20.0]
    want = jsnr.snr_estimator_study(JC, snrs, trials=64, seed=3, in_band=in_band)
    got = snr_study.snr_estimator_study(TC, snrs, trials=64, seed=3, in_band=in_band,
                                        device="cpu")
    np.testing.assert_array_equal(got["snr_db"], want["snr_db"])
    np.testing.assert_allclose(got["est_mean_db"], want["est_mean_db"], rtol=0, atol=5e-3)
    np.testing.assert_allclose(got["est_std_db"], want["est_std_db"], rtol=0, atol=5e-3)


def _tone_and_noise():
    rng = np.random.default_rng(0)
    n = 8192
    tone = np.exp(2j * np.pi * 0.1875 * np.arange(n)) + 0.01 * rng.standard_normal(n)
    return tone, rng.standard_normal(5000)  # complex and real, ragged length


@pytest.mark.parametrize("nfft,hop", [(1024, None), (256, 100)])
def test_welch_psd_and_oob_match_jax(nfft, hop):
    for x in _tone_and_noise():
        f, p = spectrum.welch_psd(x, nfft=nfft, hop=hop, device="cpu")
        jf, jp = jspec.welch_psd(x, nfft=nfft, hop=hop)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_allclose(p, jp, rtol=1e-9, atol=0)
        got = spectrum.oob_attenuation(x, 0.2, nfft=nfft, device="cpu")
        assert abs(got / jspec.oob_attenuation(x, 0.2, nfft=nfft) - 1) < 1e-9


def test_papr_and_ccdf_match_jax():
    rng = np.random.default_rng(5)
    b = rng.standard_normal((40, 300)) + 1j * rng.standard_normal((40, 300))
    np.testing.assert_allclose(spectrum.papr(b, device="cpu"), jspec.papr(b), rtol=1e-9)
    for th in (None, [1.0, 5.0, 7.5]):
        t, c = spectrum.papr_ccdf(b, thresholds_db=th, device="cpu")
        jt, jc_ = jspec.papr_ccdf(b, thresholds_db=th)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(c, jc_)


def test_spectrum_study_matches_jax():
    got = spectrum.spectrum_study(TC, n_bursts=8, device="cpu")
    want = jspec.spectrum_study(JC, n_bursts=8)
    np.testing.assert_array_equal(spectrum._payload_grids(TC, 3, 7),
                                  jspec._payload_grids(JC, 3, 7))
    for name in ("gfdm_frame", "gfdm_core", "ofdm"):
        for key in ("oob_attenuation_db", "papr_median_db"):
            assert abs(got[name][key] / want[name][key] - 1) < 1e-9, (name, key)
        np.testing.assert_array_equal(got[name]["papr_ccdf"], want[name]["papr_ccdf"])
        np.testing.assert_array_equal(got[name]["papr_thresholds_db"],
                                      want[name]["papr_thresholds_db"])
    oob = {k: v["oob_attenuation_db"] for k, v in got.items()}
    assert oob["gfdm_frame"] > oob["gfdm_core"] > oob["ofdm"]


def test_plotting_returns_its_axes():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gfdm_tpu_torch.eval import plotting

    fig, axes = plt.subplots(1, 3)
    try:
        sym = torch.from_numpy(np.exp(2j * np.pi * np.arange(16) / 16))
        assert plotting.plot_constellation(sym, ref_points=sym[:4], ax=axes[0]) is axes[0]
        res = {"snr_db": np.array([0.0, 3.0]), "ber": np.array([1e-1, 0.0])}
        assert plotting.plot_ber_curve(res, ax=axes[1]) is axes[1]
        assert plotting.plot_spectrum(np.ones(2048, np.complex64), ax=axes[2],
                                      fft_len=256) is axes[2]
    finally:
        plt.close(fig)
