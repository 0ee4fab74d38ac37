"""The port's planar torch-op link against the JAX package's XLA path (CPU).

Same numpy-seeded float32 inputs through gfdm_tpu.ops.planar_pipeline and
gfdm_tpu_torch.ops.planar_pipeline; tolerances follow tests/test_pallas.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu.ops.rx import constellation_points
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.ops import planar_pipeline as pp
from gfdm_tpu_torch.ops.planar import pdiv

torch.set_num_threads(1)

B = 8
TOL = {"data": 1e-4, "symbols": 5e-4, "channel": 2e-4}
RTOL = {"snr_lin": 1e-3, "cnrs": 1e-2}


def _payload(cfg, seed):
    return planar_payload(cfg, B, seed)


def _noisy_bursts(jc, seed, sigma=0.01):
    data = _payload(jc, seed)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))[:, 0]
    rng = np.random.default_rng(seed + 1)
    return (bursts + sigma * rng.standard_normal(bursts.shape)).astype(np.float32)


def _assert_receiver_close(got, ref):
    for key, tol in TOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=tol,
                                   err_msg=key)
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize("shifts", [(0,), (0, 4)])
def test_transmit_planar_matches_xla(shifts):
    jc, tc = JaxConfig(cyclic_shifts=shifts), GfdmConfig(cyclic_shifts=shifts)
    data = _payload(jc, seed=1)
    ref = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))
    got = pp.transmit_planar(tc, torch.from_numpy(data)).numpy()
    assert got.shape == ref.shape == (B, len(shifts), 2, tc.frame_len)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("kwargs", [
    {},
    {"ic_iterations": 0},
    {"equalizer": "mmse"},
    {"equalizer": "mmse_cnr"},
    {"phase_compensation": True},
    {"equalize": False, "ic_iterations": 1},
], ids=["zf", "no_ic", "mmse", "mmse_cnr", "phase_comp", "unequalized"])
def test_receive_bursts_planar_matches_xla(kwargs):
    jc, tc = JaxConfig(), GfdmConfig()
    bursts = _noisy_bursts(jc, seed=10)
    ref = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), **kwargs)
    got = pp.receive_bursts_planar(tc, torch.from_numpy(bursts), **kwargs)
    _assert_receiver_close(got, ref)


def test_receive_bursts_planar_generic_constellation_matches_xla():
    """Nearest-point decisions over a 16-point constellation (non-QPSK path)."""
    jc, tc = JaxConfig(), GfdmConfig()
    bursts = _noisy_bursts(jc, seed=20)
    points = constellation_points("qam16")
    ref = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), constellation=points)
    got = pp.receive_bursts_planar(tc, torch.from_numpy(bursts), constellation=points)
    _assert_receiver_close(got, ref)


def test_receive_bursts_planar_shifted_burst_matches_xla():
    jc, tc = JaxConfig(cyclic_shifts=(0, 4)), GfdmConfig(cyclic_shifts=(0, 4))
    data = _payload(jc, seed=30)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))[:, 1]
    rng = np.random.default_rng(31)  # noise keeps snr_lin finite and comparable
    bursts = (bursts + 0.01 * rng.standard_normal(bursts.shape)).astype(np.float32)
    ref = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts))
    got = pp.receive_bursts_planar(tc, torch.from_numpy(bursts))
    _assert_receiver_close(got, ref)


@pytest.mark.parametrize("ic_iterations", [0, 2])
def test_link_step_planar_matches_xla(ic_iterations):
    jc, tc = JaxConfig(), GfdmConfig()
    data = _payload(jc, seed=40)
    d_ref, snr_ref, evm_ref = jax_pp.link_step_planar(jc, jnp.asarray(data),
                                                      ic_iterations=ic_iterations)
    d_got, snr_got, evm_got = pp.link_step_planar(tc, torch.from_numpy(data),
                                                  ic_iterations=ic_iterations)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4
    assert d_got.shape == (B, 2, tc.n_data_symbols) and snr_got.shape == (B,)


def test_transmit_planar_rejects_wrong_payload_length():
    cfg = GfdmConfig()
    with pytest.raises(ValueError, match="timeslots\\*active_subcarriers"):
        pp.transmit_planar(cfg, torch.zeros(2, 2, cfg.n_data_symbols + 1))


def test_pdiv_has_no_clamp_unless_asked():
    """The XLA-twin divide has no floor; the fused kernels clamp at 1e-30."""
    a = torch.ones(1, 2, 3)
    b = torch.zeros(1, 2, 3)
    assert torch.isnan(pdiv(a, b)).all()
    assert torch.isfinite(pdiv(a, b, eps=1e-30)).all()
