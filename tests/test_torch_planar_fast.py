"""The port's factorized 'fast' planar path against the JAX package's (CPU).

Every function of gfdm_tpu_torch.ops.planar_fast against its counterpart in
gfdm_tpu.ops.planar_fast on the same numpy-seeded float32 inputs, with the
constants each package builds for itself; then the method="fast" Tx,
receiver and link of the planar pipelines. Tolerances: the planar tests'
(tests/test_torch_planar.py), scaled to each stage's output magnitude.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import planar_fast as jax_pf
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.ops import planar_fast as pf
from gfdm_tpu_torch.ops import planar_pipeline as pp

torch.set_num_threads(1)

B = 4
CONFIGS = {
    "k64": {},
    "k64_dc": {"dc_free": False},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
    # subcarrier-major resource map (the other branch of _tx_fast_fn's loop)
    "k32m5_sc": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
                 "cp_len": 8, "cs_len": 4, "per_timeslot": False},
}
TOL = {"data": 1e-4, "symbols": 5e-4, "channel": 2e-4}
RTOL = {"snr_lin": 1e-3, "cnrs": 1e-2}


def _pair(name):
    kw = CONFIGS[name]
    return JaxConfig(**kw), GfdmConfig(**kw)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _consts(jc, tc):
    jax_c = {**jax_pf._fft_consts(jc, "float32"), **jax_pf._est_consts(jc, "float32")}
    return jax_c, pf.fast_consts(tc, "float32", "cpu")


def _close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fast_constants_bit_equal(name):
    jc, tc = _pair(name)
    for fn in ("_fft_consts", "_est_consts"):
        ours, theirs = getattr(pf, fn)(tc, "float32"), getattr(jax_pf, fn)(jc, "float32")
        assert set(ours) == set(theirs), fn
        for key, a in ours.items():
            assert a.dtype == theirs[key].dtype, (fn, key)
            np.testing.assert_array_equal(a, theirs[key], err_msg=f"{fn}.{key}")
    t = pf.fast_consts(tc, "float32", "cpu")
    assert t["idxA"].dtype == torch.int32 and t["tw"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fft_stages_match_jax(name):
    """fast_fft_n, fast_ifft_n, _fold_rx, _scatter_tx, modulate_core_fast."""
    jc, tc = _pair(name)
    jax_c, ours = _consts(jc, tc)
    K, M, n = tc.subcarriers, tc.timeslots, tc.block_len
    x = _rand((B, 2, n), 1)
    X = np.asarray(jax_pf.fast_fft_n(jc, jnp.asarray(x), jax_c))
    spec = np.fft.fft(x[:, 0].astype(np.float64) + 1j * x[:, 1])
    np.testing.assert_allclose(X, np.stack([spec.real, spec.imag], axis=1), atol=1e-3)
    _close(pf.fast_fft_n(tc, torch.from_numpy(x), ours), X, 1e-4)
    _close(pf.fast_ifft_n(tc, torch.from_numpy(x), ours),
           jax_pf.fast_ifft_n(jc, jnp.asarray(x), jax_c), 1e-6)
    _close(pf._fold_rx(tc, torch.from_numpy(x), ours),
           jax_pf._fold_rx(jc, jnp.asarray(x), jax_c), 1e-5)
    w = _rand((B, K, 2, M), 2)
    _close(pf._scatter_tx(tc, torch.from_numpy(w), ours),
           jax_pf._scatter_tx(jc, jnp.asarray(w), jax_c), 1e-5)
    _close(pf.modulate_core_fast(tc, torch.from_numpy(x), ours),
           jax_pf.modulate_core_fast(jc, jnp.asarray(x), jax_c), 1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("equalize", [True, False])
def test_demod_fast_matches_jax(name, equalize):
    jc, tc = _pair(name)
    jax_c, ours = _consts(jc, tc)
    n = tc.block_len
    x = _rand((B, 2, n), 3)
    h = _rand((B, 2, n), 4) + np.float32(2.0)  # keeps |h| away from 0
    ref = jax_pf.demod_fast(jc, jnp.asarray(x), jnp.asarray(h), jax_c, equalize=equalize)
    got = pf.demod_fast(tc, torch.from_numpy(x), torch.from_numpy(h), ours,
                        equalize=equalize)
    assert got.shape == (B, tc.subcarriers, 2, tc.timeslots)
    _close(got, ref, 1e-5 if equalize else 1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_estimator_and_snr_power_match_jax(name):
    """On a received preamble (a transmitted burst plus noise) the
    factorized estimate also matches the dense E_W estimate."""
    jc, tc = _pair(name)
    jax_c, ours = _consts(jc, tc)
    K = tc.subcarriers
    data = planar_payload(tc, B, 5)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))[:, 0]
    pre = (bursts[..., tc.cp_len : tc.cp_len + 2 * K] + 0.01 * _rand((B, 2, 2 * K), 6))
    pre = np.ascontiguousarray(pre, dtype=np.float32)
    chan_ref = jax_pf.estimate_channel_fast(jc, jnp.asarray(pre), jax_c)
    chan = pf.estimate_channel_fast(tc, torch.from_numpy(pre), ours)
    assert chan.shape == (B, 2, tc.block_len)
    _close(chan, chan_ref, 1e-5)
    dense = pp._device_mats(tc, "float32", "cpu")["E_W"]
    flat = torch.from_numpy(pre).reshape(B, 4 * K)
    _close(chan, (flat @ dense).reshape(B, 2, -1).numpy(), 1e-5)
    p_ref = np.asarray(jax_pf.snr_power_fast(jc, jnp.asarray(pre), jax_c))
    p = pf.snr_power_fast(tc, torch.from_numpy(pre), ours)
    np.testing.assert_allclose(p.numpy(), p_ref, rtol=1e-4, atol=1e-4 * p_ref.max())


@pytest.mark.parametrize("name", ["k64", "k32m5", "k32m5_sc"])
@pytest.mark.parametrize("shifts", [(0,), (0, 4)])
def test_transmit_planar_fast_matches_xla(name, shifts):
    kw = {**CONFIGS[name], "cyclic_shifts": shifts}
    jc, tc = JaxConfig(**kw), GfdmConfig(**kw)
    data = planar_payload(tc, B, 7)
    ref = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data), method="fast"))
    got = pp.transmit_planar(tc, torch.from_numpy(data), method="fast").numpy()
    assert got.shape == ref.shape == (B, len(shifts), 2, tc.frame_len)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    dense = pp.transmit_planar(tc, torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("equalizer", ["zf", "mmse", "mmse_cnr"])
def test_receive_bursts_planar_fast_matches_xla(name, equalizer):
    jc, tc = _pair(name)
    data = planar_payload(tc, B, 8)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data), method="fast"))[:, 0]
    bursts = (bursts + 0.01 * _rand(bursts.shape, 9)).astype(np.float32)
    ref = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), method="fast",
                                       equalizer=equalizer)
    got = pp.receive_bursts_planar(tc, torch.from_numpy(bursts), method="fast",
                                   equalizer=equalizer)
    for key, tol in TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=tol,
                                   err_msg=key)
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize("ic_iterations", [0, 2])
def test_link_step_planar_fast_matches_xla(ic_iterations):
    jc, tc = _pair("k64")
    data = planar_payload(tc, B, 10)
    d_ref, _s, evm_ref = jax_pp.link_step_planar(jc, jnp.asarray(data),
                                                 ic_iterations=ic_iterations, method="fast")
    d_got, snr, evm_got = pp.link_step_planar(tc, torch.from_numpy(data),
                                              ic_iterations=ic_iterations, method="fast")
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4
    assert snr.shape == (B,)
    # the fast and the dense link agree on the clean loopback
    assert abs(float(evm_got) - float(pp.link_step_planar(
        tc, torch.from_numpy(data), ic_iterations=ic_iterations)[2])) < 1e-4


def test_fast_method_loads_no_dense_operator():
    """prepare(method="fast") builds only the small set: the XLA path's
    method='fast' mats plus the Tx map index, no O(N^2) matrix."""
    _jc, tc = _pair("k64")
    pp.prepare(tc, "float32", "cpu", method="fast")
    mats = pp._device_mats(tc, "float32", "cpu", "fast")
    assert not {"E_W", "F_W", "Bfd_W", "TF_W", "F2_W"} & set(mats)
    n = tc.block_len
    assert all(t.numel() < n * n for t in mats.values())
    with pytest.raises(ValueError, match="method"):
        pp.prepare(tc, "float32", "cpu", method="fft")
