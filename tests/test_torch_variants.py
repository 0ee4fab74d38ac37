"""The superseded receivers of the port against the JAX package's Pallas kernels.

rx_core_fused, rx_ic_fused, rx_full_fused and rx_receiver_hybrid are
compile-time variants of one CUDA receiver template; on the CPU their
wrappers run the plain versions. The Pallas kernels run in interpret mode
(block=4, B=8) on the same numpy-seeded float32 inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused

torch.set_num_threads(1)

B = 8
CONFIGS = {
    "canonical": {},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
}
AMPS = {"qpsk": 2.0**-0.5, "scaled": 0.6}


def _pair(name):
    return JaxConfig(**CONFIGS[name]), GfdmConfig(**CONFIGS[name])


def _bursts(jc, seed=100):
    """test_pallas.py's input: noisy transmitted bursts (sigma 0.01)."""
    data = planar_payload(jc, B, seed)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data))[:, 0])
    noise = np.random.default_rng(seed + 4).standard_normal(bursts.shape)
    return (bursts + 0.01 * noise).astype(np.float32)


def _frames_and_channel(jc, bursts):
    """The payload blocks and the JAX package's channel estimate of them."""
    fs, n = jc.preamble_len + jc.cp_len, jc.block_len
    frames = np.ascontiguousarray(bursts[..., fs : fs + n])
    chan = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), ic_iterations=0)["channel"]
    return frames, np.ascontiguousarray(np.asarray(chan, dtype=np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_core_fused_matches_pallas(name):
    jc, tc = _pair(name)
    frames, chan = _frames_and_channel(jc, _bursts(jc))
    ref = np.asarray(jax_fused.rx_core_fused(jc, jnp.asarray(frames), jnp.asarray(chan),
                                             block=4))
    got = fused.rx_core_fused(tc, _t(frames), _t(chan))
    assert got.shape == (B, 2, tc.block_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


@pytest.mark.parametrize("amp", sorted(AMPS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_ic_fused_matches_pallas(name, amp):
    jc, tc = _pair(name)
    frames, chan = _frames_and_channel(jc, _bursts(jc))
    ref = np.asarray(jax_fused.rx_ic_fused(jc, jnp.asarray(frames), jnp.asarray(chan),
                                           ic_iterations=2, block=4, qpsk_amp=AMPS[amp]))
    got = fused.rx_ic_fused(tc, _t(frames), _t(chan), ic_iterations=2, qpsk_amp=AMPS[amp])
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)


@pytest.mark.parametrize("amp", sorted(AMPS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_full_fused_matches_pallas(name, amp):
    jc, tc = _pair(name)
    bursts = _bursts(jc)
    ref = np.asarray(jax_fused.rx_full_fused(jc, jnp.asarray(bursts), ic_iterations=2,
                                             block=4, qpsk_amp=AMPS[amp]))
    got = fused.rx_full_fused(tc, _t(bursts), ic_iterations=2, qpsk_amp=AMPS[amp])
    assert got.shape == (B, 2, tc.block_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)


@pytest.mark.parametrize("amp", sorted(AMPS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_receiver_hybrid_matches_pallas(name, amp):
    """tests/test_pallas.py:153-172's limits: channel 1e-5, symbols 1e-4."""
    jc, tc = _pair(name)
    bursts = _bursts(jc)
    chan_r, sym_r = jax_fused.rx_receiver_hybrid(jc, jnp.asarray(bursts), ic_iterations=2,
                                                 block=4, qpsk_amp=AMPS[amp])
    chan, sym = fused.rx_receiver_hybrid(tc, _t(bursts), ic_iterations=2,
                                         qpsk_amp=AMPS[amp])
    np.testing.assert_allclose(chan.numpy(), np.asarray(chan_r), atol=1e-5)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=1e-4)


def test_variants_agree_with_the_dense_receiver():
    """With the channel the dense receiver estimated, rx_ic equals its
    symbols at ZF / QPSK / conv IC; rx_full and the hybrid estimate it
    themselves and land within the receiver tolerance of it."""
    tc = GfdmConfig()
    bursts = _t(_bursts(JaxConfig(), seed=7))
    chan, sym, _met = fused.rx_receiver_fused(tc, bursts)
    fs, n = tc.preamble_len + tc.cp_len, tc.block_len
    frames = bursts[..., fs : fs + n].contiguous()
    torch.testing.assert_close(fused.rx_ic_fused(tc, frames, chan), sym, atol=1e-5, rtol=0)
    torch.testing.assert_close(fused.rx_full_fused(tc, bursts), sym, atol=1e-5, rtol=0)
    chan_h, sym_h = fused.rx_receiver_hybrid(tc, bursts)
    torch.testing.assert_close(chan_h, chan, atol=0, rtol=0)
    torch.testing.assert_close(sym_h, sym, atol=1e-4, rtol=0)


def test_variant_wrappers_validate_and_launch_nothing_on_cpu():
    tc = GfdmConfig()
    frames = torch.zeros(3, 2, tc.block_len)
    before = dict(fused.LAUNCHES)
    assert fused.rx_core_fused(tc, frames, torch.ones(3, 2, tc.block_len)).shape == (3, 2, 576)
    assert fused.LAUNCHES == before
    with pytest.raises(ValueError, match="shape"):
        fused.rx_core_fused(tc, frames, torch.ones(3, 2, tc.block_len - 1))
    with pytest.raises(ValueError, match="batch"):
        fused.rx_ic_fused(tc, frames, torch.ones(2, 2, tc.block_len))
    with pytest.raises(ValueError, match="shape"):
        fused.rx_full_fused(tc, frames)
