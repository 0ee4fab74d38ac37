"""The port's fused kernels against the JAX package's Pallas kernels.

On the CPU the wrappers run the kernels' plain torch versions; the Pallas
kernels run in interpret mode as tests/test_pallas.py runs them (block=4,
B=8), on the same numpy-seeded float32 inputs. tests/test_torch_gpu.py holds
the CUDA kernels against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused

torch.set_num_threads(1)

B = 8


def _payload(cfg, seed, batch=B):
    return planar_payload(cfg, batch, seed)


def _noisy_bursts(jc, seed, sigma=0.05):
    data = _payload(jc, seed)
    bursts = np.asarray(jax_fused.tx_frame_fused(jc, jnp.asarray(data), block=4))
    rng = np.random.default_rng(seed + 1)
    return (bursts + sigma * rng.standard_normal(bursts.shape)).astype(np.float32)


@pytest.mark.parametrize("shift_index", [0, 1])
def test_tx_frame_fused_matches_pallas(shift_index):
    jc, tc = JaxConfig(cyclic_shifts=(0, 4)), GfdmConfig(cyclic_shifts=(0, 4))
    data = _payload(jc, seed=1)
    ref = np.asarray(jax_fused.tx_frame_fused(jc, jnp.asarray(data), block=4,
                                              shift_index=shift_index))
    got = fused.tx_frame_fused(tc, torch.from_numpy(data), shift_index=shift_index)
    assert got.shape == (B, 2, tc.frame_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_receiver_fused_matches_pallas(ic_mode):
    jc, tc = JaxConfig(), GfdmConfig()
    bursts = _noisy_bursts(jc, seed=10)
    chan_r, sym_r, met_r = jax_fused.rx_receiver_fused(
        jc, jnp.asarray(bursts), ic_iterations=2, block=4, ic_mode=ic_mode)
    chan, sym, met = fused.rx_receiver_fused(tc, torch.from_numpy(bursts),
                                             ic_iterations=2, ic_mode=ic_mode)
    n_cnr, met_w = fused._met_layout(tc)
    assert met.shape == (B, met_w)
    np.testing.assert_allclose(chan.numpy(), np.asarray(chan_r), atol=2e-4)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=5e-4)
    met_r = np.asarray(met_r)
    np.testing.assert_allclose(met[:, 0].numpy(), met_r[:, 0], rtol=1e-3)
    np.testing.assert_allclose(met[:, 1 : 1 + n_cnr].numpy(), met_r[:, 1 : 1 + n_cnr],
                               rtol=1e-2)
    assert not met[:, 1 + n_cnr :].any()


def test_receive_bursts_fused_matches_pallas_composite():
    jc, tc = JaxConfig(), GfdmConfig()
    bursts = _noisy_bursts(jc, seed=20, sigma=0.01)
    ref = jax_fused.receive_bursts_fused(jc, jnp.asarray(bursts), ic_iterations=2,
                                         block=4)
    got = fused.receive_bursts_fused(tc, torch.from_numpy(bursts), ic_iterations=2)
    for key in ("data", "symbols", "channel"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["snr_lin"].numpy(), np.asarray(ref["snr_lin"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["cnrs"].numpy(), np.asarray(ref["cnrs"]), rtol=1e-2)


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_single_fused_matches_pallas(ic_mode):
    jc, tc = JaxConfig(), GfdmConfig()
    data = _payload(jc, seed=30)
    d_ref, _snr_ref, evm_ref = jax_fused.link_single_fused(
        jc, jnp.asarray(data), ic_iterations=2, block=4, ic_mode=ic_mode)
    d_got, snr_got, evm_got = fused.link_single_fused(
        tc, torch.from_numpy(data), ic_iterations=2, ic_mode=ic_mode)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4
    assert snr_got.shape == (B,)


def test_link_step_fused_matches_pallas():
    jc, tc = JaxConfig(), GfdmConfig()
    data = _payload(jc, seed=40)
    d_ref, _s, evm_ref = jax_fused.link_step_fused(jc, jnp.asarray(data),
                                                   ic_iterations=2, tx_block=4,
                                                   rx_block=4)
    d_got, _s, evm_got = fused.link_step_fused(tc, torch.from_numpy(data))
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4


def test_fused_cross_config_matches_pallas():
    """K=32, M=5, cp 8, cs 4: the plain versions generalize like the kernels."""
    kw = dict(subcarriers=32, active_subcarriers=24, timeslots=5, cp_len=8, cs_len=4)
    jc, tc = JaxConfig(**kw), GfdmConfig(**kw)
    data = _payload(jc, seed=45)
    ref_tx = np.asarray(jax_fused.tx_frame_fused(jc, jnp.asarray(data), block=4))
    got_tx = fused.tx_frame_fused(tc, torch.from_numpy(data))
    np.testing.assert_allclose(got_tx.numpy(), ref_tx, atol=3e-5)
    rng = np.random.default_rng(46)
    bursts = (ref_tx + 0.01 * rng.standard_normal(ref_tx.shape)).astype(np.float32)
    _c, sym_r, _m = jax_fused.rx_receiver_fused(jc, jnp.asarray(bursts), block=4)
    _c, sym, _m = fused.rx_receiver_fused(tc, torch.from_numpy(bursts))
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=5e-4)
    d_ref, _s, evm_ref = jax_fused.link_single_fused(jc, jnp.asarray(data), block=4,
                                                     ic_mode="matmul")
    d_got, _s, evm_got = fused.link_single_fused(tc, torch.from_numpy(data),
                                                 ic_mode="matmul")
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4


def test_plain_versions_take_any_batch_and_launch_nothing():
    """Unlike the Pallas wrappers the port takes a ragged batch; on the CPU
    no kernel launches."""
    cfg = GfdmConfig()
    before = dict(fused.LAUNCHES)
    data = torch.from_numpy(_payload(cfg, seed=50, batch=5))
    d_hat, _snr, evm = fused.link_single_fused(cfg, data, ic_mode="matmul")
    d_split, _snr, evm_split = fused.link_step_fused(cfg, data)
    assert d_hat.shape == d_split.shape == (5, 2, cfg.n_data_symbols)
    assert 0.0 < float(evm) < 0.025 and 0.0 < float(evm_split) < 0.025
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("kwargs", [
    {"equalizer": "mmse"},
    {"constellation": "qam16"},
    {"phase_compensation": True},
])
def test_unported_receiver_options_raise(kwargs):
    """The receiver options once refused here are ported
    (tests/test_torch_options.py holds them against the Pallas kernel):
    each runs, and an unknown value of the same option raises ValueError,
    as the JAX wrappers refuse it."""
    cfg = GfdmConfig()
    bursts = torch.from_numpy(_noisy_bursts(JaxConfig(), seed=60))
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, **kwargs)
    assert sym.shape == (B, 2, cfg.block_len) and bool(torch.isfinite(sym).all())
    (name, value), = kwargs.items()
    if isinstance(value, str):
        with pytest.raises(ValueError, match=name):
            fused.rx_receiver_fused(cfg, bursts, **{name: value + "x"})


def test_wrappers_validate_inputs():
    cfg = GfdmConfig()
    good = torch.zeros(2, 2, cfg.n_data_symbols)
    with pytest.raises(TypeError, match="float32"):
        fused.tx_frame_fused(cfg, good.double())
    with pytest.raises(ValueError, match="shape"):
        fused.link_single_fused(cfg, good[:, :, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        fused.link_single_fused(cfg, torch.zeros(2, cfg.n_data_symbols, 2).transpose(1, 2))
    with pytest.raises(ValueError, match="ic_mode"):
        fused.link_single_fused(cfg, good, ic_mode="fft")
