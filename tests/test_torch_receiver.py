"""The port's runtime chain on complex tensors (runtime/transmitter.py,
runtime/receiver.py, runtime/stream.receive_long_stream, runtime/channel.py)
against the JAX package's on the same seeded inputs, complex64 on both
sides, on the CPU.

Tolerances (absolute): the Tx within 2e-5 and the receiver's symbols within
5e-4, the JAX package's Pallas-vs-XLA limits (tests/test_pallas.py);
channel ops 1e-5 (float32 products and sums of a few terms, phases up to
~20 rad rounded in float32); metrics relative 1e-3. Detection starts and
found masks are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import rx as jrx
from gfdm_tpu.ops import tx as jtx
from gfdm_tpu.runtime import channel as jchan
from gfdm_tpu.runtime import receiver as jreceiver
from gfdm_tpu.runtime import stream as jstream
from gfdm_tpu.runtime import transmitter as jtransmitter
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.ops import rx
from gfdm_tpu_torch.runtime import channel, receiver, stream, transmitter

torch.set_num_threads(1)

TOL_TX, TOL_RX, TOL_CH = 2e-5, 5e-4, 1e-5
JC, TC = JaxConfig(), GfdmConfig()
TAPS = np.array([1.0, 0.25 + 0.15j, -0.1j])  # gfdm_tpu/cli.py:434's simulate taps


def _qpsk(rng, *shape):
    return (((rng.integers(0, 2, shape) * 2 - 1) + 1j * (rng.integers(0, 2, shape) * 2 - 1))
            / np.sqrt(2.0)).astype(np.complex64)


def _noise(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _jax_unit_noise(key, shape):
    """The unit complex noise jax.random draws inside awgn / place_in_stream."""
    kr, ki = jax.random.split(key)
    return np.asarray(jax.random.normal(kr, shape)) + 1j * np.asarray(jax.random.normal(ki, shape))


def test_transmit_and_shape_bursts_match_jax():
    cfg_s = GfdmConfig(cyclic_shifts=(0, 4))
    jcfg_s = JaxConfig(cyclic_shifts=(0, 4))
    data = _qpsk(np.random.default_rng(0), 4, TC.n_data_symbols)
    for jc, tc in ((JC, TC), (jcfg_s, cfg_s)):
        b = transmitter.transmit_bursts(tc, data, device="cpu")
        _close(b, jtransmitter.transmit_bursts(jc, data), TOL_TX)
        for kw in ({}, {"scale": 0.5 - 0.25j}, {"pre": 3, "post": 7, "scale": 2.0}):
            _close(transmitter.shape_bursts(tc, b, **kw),
                   jtransmitter.shape_bursts(jc, b.numpy(), **kw), TOL_TX)
    assert transmitter.shape_bursts(TC, b).shape[-1] == TC.padded_frame_len


def _link_stream(rng, n, snr_scale=0.02):
    """n one-burst chunks: Tx -> shape -> multipath -> noise (complex64)."""
    data = _qpsk(rng, n, TC.n_data_symbols)
    b = transmitter.transmit_bursts(TC, data, device="cpu")[:, 0]
    s = channel.multipath(transmitter.shape_bursts(TC, b), TAPS)
    return (s.numpy() + _noise(rng, *s.shape, scale=snr_scale)).astype(np.complex64), data


@pytest.mark.parametrize("equalize", [True, False])
def test_receive_bursts_matches_jax(equalize):
    rng = np.random.default_rng(1)
    s, _ = _link_stream(rng, 4)
    bursts = s[:, TC.pre_padding_len : TC.pre_padding_len + TC.frame_len]
    pts = rx.constellation_points("qam16") if not equalize else rx.qpsk_constellation
    got = receiver.receive_bursts(TC, _t(bursts), equalize=equalize, constellation=pts)
    want = jreceiver.receive_bursts(JC, bursts, equalize=equalize, constellation=pts)
    for key in ("data", "symbols", "channel"):
        _close(got[key], want[key], TOL_RX)
    np.testing.assert_allclose(got["snr_lin"].numpy(), np.asarray(want["snr_lin"]), rtol=1e-3)
    np.testing.assert_allclose(got["cnrs"].numpy(), np.asarray(want["cnrs"]), rtol=1e-3,
                               atol=1e-3)


def test_receive_stream_matches_jax():
    rng = np.random.default_rng(2)
    s, _ = _link_stream(rng, 6)
    got = receiver.receive_stream(TC, s, device="cpu")
    want = jreceiver.receive_stream(JC, s)
    np.testing.assert_array_equal(got["detection"]["start"].numpy(),
                                  np.asarray(want["detection"]["start"]))
    _close(got["data"], want["data"], TOL_RX)
    np.testing.assert_allclose(got["snr_lin"].numpy(), np.asarray(want["snr_lin"]), rtol=1e-3)
    for key in ("cfo", "scale", "ac_peak", "noise_floor"):
        np.testing.assert_allclose(got["detection"][key].numpy(),
                                   np.asarray(want["detection"][key]), rtol=1e-3, atol=3e-5)


def _recording(rng, offsets, n_samples):
    data = _qpsk(rng, len(offsets), TC.n_data_symbols)
    b = np.asarray(jtx.transmit(JC, data))[:, 0]
    rec = _noise(rng, n_samples, scale=0.005)
    for burst, off in zip(b, offsets):
        rec[off : off + TC.frame_len] += burst
    return rec, data


@pytest.mark.parametrize("k", [1, 2])
def test_receive_long_stream_matches_jax(k):
    rng = np.random.default_rng(3 + k)
    # chunks 0, 2 (straddling into 3) and 4 as tests/test_stream_eval.py:37;
    # with k = 2 a second burst in chunk 0
    offsets = [100, 3 * 2048 - 300, 4 * 2048 + 777]
    if k == 2:
        offsets.insert(1, 100 + TC.frame_len + 32)
    rec, data = _recording(rng, offsets, 6 * 2048)
    got = stream.receive_long_stream(TC, _t(rec), max_bursts_per_chunk=k)
    want = jstream.receive_long_stream(JC, rec, max_bursts_per_chunk=k)
    found = got["found"].numpy()
    np.testing.assert_array_equal(found, np.asarray(want["found"]))
    assert found.sum() == len(offsets)
    np.testing.assert_array_equal(got["detection"]["start"].numpy(),
                                  np.asarray(want["detection"]["start"]))
    _close(got["data"].numpy()[found], np.asarray(want["data"])[found], TOL_RX)
    np.testing.assert_allclose(got["snr_lin"].numpy()[found],
                               np.asarray(want["snr_lin"])[found], rtol=1e-3)


def test_channel_ops_match_jax():
    rng = np.random.default_rng(5)
    sig = _noise(rng, 3, 500)
    _close(channel.multipath(_t(sig), TAPS), jchan.multipath(jnp.asarray(sig), TAPS), TOL_CH)
    for cfo in (0.0, 0.2, -0.37):
        _close(channel.apply_cfo(_t(sig), cfo, 64), jchan.apply_cfo(jnp.asarray(sig), cfo, 64),
               TOL_CH)
    key = jax.random.PRNGKey(7)
    bursts = _noise(rng, 2, 300)
    for floor in (0.0, 0.1):
        want = jchan.place_in_stream(key, jnp.asarray(bursts), 1024, 123, noise_floor=floor)
        unit = _t(_jax_unit_noise(key, (2, 1024)))
        _close(channel.place_in_stream(unit, _t(bursts), 1024, 123, noise_floor=floor), want,
               TOL_CH)


def test_awgn_matches_jax_given_its_noise():
    rng = np.random.default_rng(6)
    sig = _noise(rng, 4, 2048)
    key = jax.random.PRNGKey(3)
    unit = _t(_jax_unit_noise(key, sig.shape))
    for snr_db, measure in ((15.0, None), (3.0, sig[:, :100])):
        want = jchan.awgn(key, jnp.asarray(sig), snr_db,
                          None if measure is None else jnp.asarray(measure))
        got = channel.awgn(unit, _t(sig), snr_db, None if measure is None else _t(measure))
        assert got.dtype == torch.complex64
        _close(got, want, TOL_CH)
    with pytest.raises(ValueError, match="complex tensor of shape"):
        channel.awgn(unit[:, :10], _t(sig), 10.0)


def test_awgn_snr_from_a_generator():
    """Drawn from a torch.Generator: the SNR within 0.2 dB, reproducible."""
    sig = _t(_noise(np.random.default_rng(8), 8, 4096))
    out = [channel.awgn(torch.Generator().manual_seed(11), sig, 12.0) for _ in range(2)]
    assert torch.equal(out[0], out[1])
    snr = 10 * np.log10(float((sig.abs() ** 2).mean()) / float(((out[0] - sig).abs() ** 2).mean()))
    assert abs(snr - 12.0) < 0.2
    stream_ = channel.place_in_stream(torch.Generator().manual_seed(1), sig[:, :100], 512, 10,
                                      noise_floor=0.1)
    assert stream_.shape == (8, 512)
