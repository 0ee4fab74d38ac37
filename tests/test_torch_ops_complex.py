"""The port's complex-dtype ops (ops/_validate, planar helpers, ops/tx,
ops/estimation, ops/rx, ops/sync's detectors, ops/burst) against the JAX
package's on the same seeded inputs, complex64 on both sides.

Tolerances (absolute, on outputs of magnitude ~1): float32 sums of up to N =
576 products in another order, so the transmitter's outputs within 2e-5 and
the receiver's (after the ZF divide and the IC loop) within 5e-4: the JAX
package's own Pallas-vs-XLA limits for bursts and symbols
(tests/test_pallas.py). Detection starts are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import _validate as jval
from gfdm_tpu.ops import burst as jburst
from gfdm_tpu.ops import estimation as jest
from gfdm_tpu.ops import planar as jpl
from gfdm_tpu.ops import rx as jrx
from gfdm_tpu.ops import sync as jsync
from gfdm_tpu.ops import tx as jtx
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.ops import _validate, burst, estimation, operators, planar, rx, sync, tx

torch.set_num_threads(1)

TOL_TX = 2e-5
TOL_RX = 5e-4
# tests/test_ops_parity.py:23-24 and :150
CONFIGS = {
    "canonical": {},
    "shifts04": {"cyclic_shifts": (0, 4)},
    "alpha05_k64": {"filteralpha": 0.5, "active_subcarriers": 64, "dc_free": False},
}
BATCH = 3


def _cfgs(name):
    kw = CONFIGS[name]
    return JaxConfig(**kw), GfdmConfig(**kw)


def _cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2.0)).astype(np.complex64)


def _qpsk(rng, *shape):
    return (((rng.integers(0, 2, shape) * 2 - 1) + 1j * (rng.integers(0, 2, shape) * 2 - 1))
            / np.sqrt(2.0)).astype(np.complex64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# ops/_validate.py, planar helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 5), (5,), (2, 3, 4)])
def test_validate_messages_match(shape):
    x = np.zeros(shape, np.float32)
    for fn in ("check_last_dim", "check_planar"):
        with pytest.raises(ValueError) as want:
            getattr(jval, fn)(jnp.asarray(x), 7, "op", "n")
        with pytest.raises(ValueError) as got:
            getattr(_validate, fn)(_t(x), 7, "op", "n")
        assert str(got.value) == str(want.value)
    _validate.check_planar(_t(np.zeros((4, 2, 7), np.float32)), 7, "op", "n")


def test_planar_helpers():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 2, 11)).astype(np.float32)
    ph = rng.standard_normal((3, 11)).astype(np.float32)
    s = rng.standard_normal((3, 11)).astype(np.float32)
    ja = jnp.asarray(a)
    for name in ("re", "im", "pangle"):
        _close(getattr(planar, name)(_t(a)), getattr(jpl, name)(ja), 1e-6)
    _close(planar.pexp_i(_t(ph)), jpl.pexp_i(jnp.asarray(ph)), 1e-6)
    _close(planar.pscale_real(_t(a), _t(s)), jpl.pscale_real(ja, jnp.asarray(s)), 1e-6)
    _close(planar.pscale_real(_t(a), 0.5), jpl.pscale_real(ja, 0.5), 0)


# ---------------------------------------------------------------------------
# ops/tx.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tx_ops_match_jax(name):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(2)
    data = _qpsk(rng, BATCH, tc.n_data_symbols)
    grid = _qpsk(rng, BATCH, tc.block_len)
    _close(tx.modulate(tc, _t(grid)), jtx.modulate(jc, grid), TOL_TX)
    _close(tx.map_resources(tc, _t(data)), jtx.map_resources(jc, data), 0)
    core = tx.transmit_core(tc, _t(data))
    _close(core, jtx.transmit_core(jc, data), TOL_TX)
    for shift in tc.cyclic_shifts:
        _close(tx.add_cyclic_prefix(tc, core, shift),
               jtx.add_cyclic_prefix(jc, core.numpy(), shift), 1e-6)
    got = tx.transmit(tc, data, device="cpu")
    assert got.dtype == torch.complex64
    _close(got, jtx.transmit(jc, data), TOL_TX)
    assert tx.demap_indices is operators.demap_indices
    np.testing.assert_array_equal(tx.demap_indices(tc), jtx.demap_indices(jc))
    with pytest.raises(ValueError, match="timeslots\\*active_subcarriers"):
        tx.transmit(tc, _t(data[:, :-1]))


# ---------------------------------------------------------------------------
# ops/estimation.py
# ---------------------------------------------------------------------------
def _received_preambles(tc, rng):
    """Preambles through a 3-tap channel plus noise (a non-trivial estimate)."""
    pre = np.asarray(tc.core_preamble, np.complex128)
    h = np.array([1.0, 0.3 - 0.2j, 0.1j])
    rx_pre = np.stack([np.convolve(pre, h)[: pre.size] for _ in range(BATCH)])
    return (rx_pre + 0.05 * _cplx(rng, BATCH, pre.size)).astype(np.complex64)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_estimation_matches_jax(name):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(3)
    rx_pre = _received_preambles(tc, rng)
    H = estimation.estimate_frame(tc, _t(rx_pre))
    jH = np.asarray(jest.estimate_frame(jc, rx_pre))
    _close(H, jH, TOL_TX)
    _close(estimation.prepare_for_zf(H), jest.prepare_for_zf(H.numpy()), 1e-4)
    snr, cnrs = estimation.estimate_snr(tc, _t(rx_pre))
    jsnr, jcnrs = (np.asarray(v) for v in jest.estimate_snr(jc, rx_pre))
    np.testing.assert_allclose(snr.numpy(), jsnr, rtol=1e-4)
    np.testing.assert_allclose(cnrs.numpy(), jcnrs, rtol=1e-3, atol=1e-4)
    for kw in ({"snr_lin": jsnr}, {"cnrs": jcnrs}, {"snr_lin": 3.0}):
        _close(estimation.mmse_channel(tc, H, **kw), jest.mmse_channel(jc, H.numpy(), **kw),
               1e-4)
    with pytest.raises(ValueError, match="snr_lin or cnrs"):
        estimation.mmse_channel(tc, H)


# ---------------------------------------------------------------------------
# ops/rx.py
# ---------------------------------------------------------------------------
def _frames_and_channel(tc, rng, noise=0.05):
    """Tx cores through a per-bin channel near 1, plus noise: (frames, H)."""
    data = _qpsk(rng, BATCH, tc.n_data_symbols)
    core = tx.transmit_core(tc, _t(data)).numpy()
    H = (1.0 + 0.2 * _cplx(rng, BATCH, tc.block_len)).astype(np.complex64)
    frames = np.fft.ifft(np.fft.fft(core, axis=-1) * H, axis=-1)
    frames = (frames + noise * _cplx(rng, BATCH, tc.block_len)).astype(np.complex64)
    return frames, H, data


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rx_step_ops_match_jax(name):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(4)
    frames, H, _ = _frames_and_channel(tc, rng)
    framed = _cplx(rng, BATCH, tc.window_len)
    _close(rx.remove_cyclic_prefix(tc, _t(framed)), jrx.remove_cyclic_prefix(jc, framed), 0)
    _close(rx.demodulate(tc, _t(frames)), jrx.demodulate(jc, frames), TOL_TX)
    _close(rx.demodulate_equalized(tc, _t(frames), _t(H)),
           jrx.demodulate_equalized(jc, frames, H), TOL_RX)
    for ch in (None, H):
        S = rx.fd_filter_downsample(tc, _t(frames), None if ch is None else _t(ch))
        _close(S, jrx.fd_filter_downsample(jc, frames, ch), TOL_RX)
    _close(rx.subcarriers_to_time(tc, S), jrx.subcarriers_to_time(jc, S.numpy()), TOL_TX)
    det = _qpsk(rng, BATCH, tc.block_len)
    _close(rx.cancel_interference(tc, _t(det), S),
           jrx.cancel_interference(jc, det, S.numpy()), TOL_TX)
    sym = _cplx(rng, BATCH, tc.block_len)
    _close(rx.demap_resources(tc, _t(sym)), jrx.demap_resources(jc, sym), 0)


IC_CASES = [(it, phase, const) for it in (0, 1, 2) for phase in (False, True)
            for const in ("qpsk", "qam16")]


@pytest.mark.parametrize("it,phase,const", IC_CASES)
def test_ic_receiver_matches_jax(it, phase, const):
    jc, tc = _cfgs("canonical")
    rng = np.random.default_rng(5 + it)
    frames, H, _ = _frames_and_channel(tc, rng)
    frames = (frames * np.exp(0.1j)).astype(np.complex64)  # a common phase offset
    pts = rx.constellation_points(const)
    np.testing.assert_array_equal(pts, jrx.constellation_points(const))
    got = rx.ic_receiver(tc, _t(frames), _t(H), ic_iterations=it, constellation=pts,
                         phase_compensation=phase)
    want = jrx.ic_receiver(jc, frames, H, ic_iterations=it, constellation=pts,
                           phase_compensation=phase)
    _close(got, want, TOL_RX)


@pytest.mark.parametrize("name", ["shifts04", "alpha05_k64"])
def test_ic_receiver_matches_jax_other_configs(name):
    jc, tc = _cfgs(name)
    frames, H, _ = _frames_and_channel(tc, np.random.default_rng(6))
    _close(rx.ic_receiver(tc, _t(frames), _t(H), phase_compensation=True),
           jrx.ic_receiver(jc, frames, H, phase_compensation=True), TOL_RX)
    _close(rx.ic_receiver(tc, _t(frames), None, ic_iterations=1),
           jrx.ic_receiver(jc, frames, None, ic_iterations=1), TOL_RX)


def test_argmin_takes_the_first_of_tied_distances():
    """All-zero frames put every estimate equidistant from the QPSK points:
    both packages decide points[0] (the first minimum) on active subcarriers."""
    jc, tc = _cfgs("canonical")
    frames = np.zeros((2, tc.block_len), np.complex64)
    got = rx.ic_receiver(tc, _t(frames), ic_iterations=1)
    want = np.asarray(jrx.ic_receiver(jc, frames, ic_iterations=1))
    _close(got, want, 1e-6)
    hard = rx._decide(torch.zeros(1, tc.block_len, dtype=torch.complex64),
                      torch.from_numpy(rx.qpsk_constellation.astype(np.complex64)),
                      torch.from_numpy(np.isin(np.arange(tc.subcarriers), tc.subcarrier_map)),
                      tc.subcarriers, tc.timeslots)
    on = hard[0, tc.subcarrier_map]
    assert torch.all(on == torch.tensor(rx.qpsk_constellation[0], dtype=torch.complex64))


# ---------------------------------------------------------------------------
# ops/sync.py detectors, ops/burst.py
# ---------------------------------------------------------------------------
def _burst_chunks(tc, rng, offsets, T):
    """(len(offsets), T) chunks with one Tx burst each at its offset, a CFO
    of 0.05 subcarriers and AWGN."""
    data = _qpsk(rng, len(offsets), tc.n_data_symbols)
    b = tx.transmit(tc, _t(data))[:, 0].numpy()
    out = 0.05 * _cplx(rng, len(offsets), T)
    n = np.arange(tc.frame_len)
    for i, off in enumerate(offsets):
        out[i, off : off + tc.frame_len] += b[i] * np.exp(2j * np.pi * 0.05 * n / tc.subcarriers)
    return out.astype(np.complex64)


@pytest.mark.parametrize("name", ["canonical", "alpha05_k64"])
def test_detect_and_extract_match_jax(name):
    jc, tc = _cfgs(name)
    rng = np.random.default_rng(7)
    T = 2048 + tc.frame_len + tc.cp_len
    s = _burst_chunks(tc, rng, [100, 700, 1500, 2040], T)
    for limit in (None, 2048):
        got = sync.detect_bursts(tc, _t(s), search_limit=limit)
        want = {k: np.asarray(v) for k, v in jsync.detect_bursts(jc, s, search_limit=limit).items()}
        np.testing.assert_array_equal(got["start"].numpy(), want["start"])
        for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor", "ac_metric"):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-3, atol=3e-5,
                                       err_msg=key)
    for cfo in (True, False):
        _close(burst.extract_bursts(tc, _t(s), got, correct_cfo=cfo),
               jburst.extract_bursts(jc, s, want, correct_cfo=cfo), 1e-4)
    _close(burst.extract_bursts(tc, _t(s), got, burst_len=300, backoff=2100),
           jburst.extract_bursts(jc, s, want, burst_len=300, backoff=2100), 1e-4)
    _close(burst.remove_prefix(_t(s), 10, 100), jburst.remove_prefix(s, 10, 100), 0)


def test_detect_topk_matches_jax():
    jc, tc = _cfgs("canonical")
    rng = np.random.default_rng(8)
    T = 2048 + tc.frame_len + tc.cp_len
    s = _burst_chunks(tc, rng, [100, 900, 1700], T)
    s[0, 1000 : 1000 + tc.frame_len] += _burst_chunks(tc, rng, [0], tc.frame_len)[0]
    got = sync.detect_bursts_topk(tc, _t(s), max_bursts=3, search_limit=2048)
    want = {k: np.asarray(v)
            for k, v in jsync.detect_bursts_topk(jc, s, max_bursts=3, search_limit=2048).items()}
    np.testing.assert_array_equal(got["start"].numpy(), want["start"])
    for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-3, atol=3e-5,
                                   err_msg=key)


def test_argmax_takes_the_first_of_tied_values():
    """An all-zero chunk gates every position to 0: both detectors pick
    position 0, and top-k's later slots do too."""
    jc, tc = _cfgs("canonical")
    s = np.zeros((2, 2048), np.complex64)
    got = sync.detect_bursts(tc, _t(s))
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(jsync.detect_bursts(jc, s)["start"]))
    assert not got["start"].any()
    k = sync.detect_bursts_topk(tc, _t(s), max_bursts=2)
    np.testing.assert_array_equal(
        k["start"].numpy(), np.asarray(jsync.detect_bursts_topk(jc, s, max_bursts=2)["start"]))
