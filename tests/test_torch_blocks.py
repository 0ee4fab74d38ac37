"""The port's GNU-Radio-style block facade (gfdm_tpu_torch/blocks.py) against
the JAX package's blocks on the same inputs, complex64 on the CPU.

Limits (tests/test_torch_receiver.py's): Tx-side blocks within 2e-5, the
receive-side blocks within 5e-4, SNR estimates within 1e-3 relative;
index-only blocks (prefix removal, demapper, the preamble source) equal.
Then the reference's block tests (tests/test_blocks.py) on the port.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu import blocks as jblocks
from gfdm_tpu_torch import GfdmConfig, blocks
from gfdm_tpu_torch.ref import utils

torch.set_num_threads(1)

TOL_TX, TOL_RX, SNR_RTOL = 2e-5, 5e-4, 1e-3
JC, TC = JaxConfig(), GfdmConfig()
CPU = {"device": "cpu"}


def _data(batch, seed=0):
    return np.stack(
        [utils.random_qpsk(TC.n_data_symbols, seed=seed + i) for i in range(batch)]
    ).astype(np.complex64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _bursts(n=4, seed=1):
    return np.asarray(jblocks.transmitter_cc(JC)(_data(n, seed)))[:, 0, :].astype(np.complex64)


def _frames(bursts):
    start = JC.preamble_len + JC.cp_len
    return bursts[:, start : start + JC.block_len]


def _stream(bursts, offset=300, rng=None):
    s = np.zeros((bursts.shape[0], 2048), np.complex64)
    s[:, offset : offset + JC.frame_len] = bursts
    if rng is not None:
        s += (0.01 * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
              ).astype(np.complex64)
    return s


def case_transmitter_cc():
    d = _data(4, 1)
    for shifts in ((0,), (0, 4)):
        _close(blocks.transmitter_cc(GfdmConfig(cyclic_shifts=shifts), **CPU)(d),
               jblocks.transmitter_cc(JaxConfig(cyclic_shifts=shifts))(d), TOL_TX)


def case_simple_modulator_cc():
    grid = np.asarray(jblocks.resource_mapper_cc(JC)(_data(3, 2)))
    _close(blocks.simple_modulator_cc(TC, **CPU)(grid), jblocks.simple_modulator_cc(JC)(grid),
           TOL_TX)


def case_simple_receiver_cc():
    frames = _frames(_bursts())
    _close(blocks.simple_receiver_cc(TC, **CPU)(frames), jblocks.simple_receiver_cc(JC)(frames),
           TOL_RX)


def case_advanced_receiver_sb_cc():
    b = _bursts(4, 3)
    rng = np.random.default_rng(4)
    b = b + (0.02 * (rng.standard_normal(b.shape) + 1j * rng.standard_normal(b.shape))
             ).astype(np.complex64)
    chan = np.asarray(jblocks.channel_estimator_cc(JC)(
        b[:, JC.cp_len : JC.cp_len + 2 * JC.subcarriers])[0])
    for ic, phase in ((0, False), (3, False), (2, True)):
        rx = blocks.advanced_receiver_sb_cc(TC, ic_iterations=1, do_phase_compensation=phase,
                                            **CPU)
        rx.set_ic(ic)
        assert rx.get_ic() == ic
        jrx = jblocks.advanced_receiver_sb_cc(JC, ic_iterations=ic,
                                              do_phase_compensation=phase)
        for ch in (None, chan):
            _close(rx(_frames(b), channel=ch), jrx(_frames(b), channel=ch), TOL_RX)


def case_cyclic_prefixer_cc():
    core = np.asarray(jblocks.simple_modulator_cc(JC)(
        np.asarray(jblocks.resource_mapper_cc(JC)(_data(2, 5)))))
    for shift in (0, 3):
        _close(blocks.cyclic_prefixer_cc(TC, cyclic_shift=shift, **CPU)(core),
               jblocks.cyclic_prefixer_cc(JC, cyclic_shift=shift)(core), TOL_TX)


def case_remove_prefix_cc():
    b = _bursts(2)
    for kw in ({}, {"offset": 5, "block_len": 100}):
        np.testing.assert_array_equal(_np(blocks.remove_prefix_cc(TC, **kw, **CPU)(b)),
                                      _np(jblocks.remove_prefix_cc(JC, **kw)(b)))
    with pytest.raises(ValueError, match="remove_prefix"):
        blocks.remove_prefix_cc(TC, offset=b.shape[-1], **CPU)(b)


def case_extract_burst_cc():
    s = _stream(_bursts(3, 9), rng=np.random.default_rng(6))
    ext, jext = blocks.extract_burst_cc(TC, **CPU), jblocks.extract_burst_cc(JC)
    det, jdet = ext.sync(s), jext.sync(s)
    np.testing.assert_array_equal(_np(det["start"]), _np(jdet["start"]))
    np.testing.assert_allclose(_np(det["scale"]), _np(jdet["scale"]), rtol=SNR_RTOL)
    _close(ext(s, det), jext(s, jdet), TOL_RX)
    ext.activate_cfo_compensation(False)
    jext.activate_cfo_compensation(False)
    _close(ext(s, det), jext(s, jdet), TOL_RX)
    kw = {"burst_len": 600, "tag_backoff": 4}
    _close(blocks.extract_burst_cc(TC, **kw, **CPU)(s, det),
           jblocks.extract_burst_cc(JC, **kw)(s, jdet), TOL_RX)
    half = s.shape[-1] // 2
    np.testing.assert_array_equal(_np(ext.sync(s, search_limit=half)["start"]),
                                  _np(jext.sync(s, search_limit=half)["start"]))


def case_channel_estimator_cc():
    pre = _bursts(4, 7)[:, JC.cp_len : JC.cp_len + 2 * JC.subcarriers]
    rng = np.random.default_rng(7)  # a noiseless preamble's SNR is rounding noise
    pre = pre * np.complex64(0.8 - 0.3j) + (0.05 * (rng.standard_normal(pre.shape) + 1j
                                                   * rng.standard_normal(pre.shape))
                                            ).astype(np.complex64)
    est, tags = blocks.channel_estimator_cc(TC, **CPU)(pre)
    jest, jtags = jblocks.channel_estimator_cc(JC)(pre)
    _close(est, jest, TOL_RX)
    np.testing.assert_allclose(_np(tags["snr_lin"]), _np(jtags["snr_lin"]), rtol=SNR_RTOL)
    np.testing.assert_allclose(_np(tags["cnr"]), _np(jtags["cnr"]), rtol=SNR_RTOL)


def case_resource_mapper_cc():
    d = _data(3, 8)
    _close(blocks.resource_mapper_cc(TC, **CPU)(d), jblocks.resource_mapper_cc(JC)(d), TOL_TX)


def case_resource_demapper_cc():
    frames = np.asarray(jblocks.resource_mapper_cc(JC)(_data(3, 8)))
    np.testing.assert_array_equal(_np(blocks.resource_demapper_cc(TC, **CPU)(frames)),
                                  _np(jblocks.resource_demapper_cc(JC)(frames)))


def case_short_burst_shaper():
    b = _bursts(2)
    for kw in ({"scale": 0.5}, {"pre_padding": 3, "post_padding": 9, "scale": 0.25 - 0.5j}):
        _close(blocks.short_burst_shaper(TC, **kw, **CPU)(b),
               jblocks.short_burst_shaper(JC, **kw)(b), TOL_TX)


def case_modulator_cc():
    grid = np.asarray(jblocks.resource_mapper_cc(JC)(_data(2, 11)))
    for fft_len in (None, 2 * TC.block_len):
        _close(blocks.modulator_cc(TC, fft_len=fft_len, **CPU)(grid),
               jblocks.modulator_cc(JC, fft_len=fft_len)(grid), TOL_TX)
    with pytest.raises(ValueError, match="fft_len"):
        blocks.modulator_cc(TC, fft_len=TC.block_len - 1, **CPU)


def case_preamble_generator():
    for args, kw in (((16, 0.35, 32), {}), ((12, 0.2, 32), {"cp_len": 8, "ramp_len": 4}),
                     ((20, 0.5, 64), {"seed": 3})):
        for a, b in zip(blocks.preamble_generator(*args, **kw),
                        jblocks.preamble_generator(*args, **kw)):
            np.testing.assert_array_equal(a, b)


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def test_every_block_has_a_case():
    assert sorted(CASES) == sorted(blocks.__all__) == sorted(jblocks.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    CASES[name]()


def test_blocks_without_a_device_take_the_card(monkeypatch):
    """A block given no device sends a NumPy input to the card: without one
    it raises, naming device='cpu'; a CPU tensor stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _data(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        blocks.transmitter_cc(TC)(d)
    assert blocks.transmitter_cc(TC)(torch.from_numpy(d)).device.type == "cpu"
    assert "M=9, K=64" in repr(blocks.modulator_cc(TC))


def test_block_flowgraph_tx_rx_roundtrip():
    """Compose the hier receiver flowgraph from blocks, like a GRC user."""
    tx = blocks.transmitter_cc(TC, **CPU)
    est = blocks.channel_estimator_cc(TC, **CPU)
    rxb = blocks.advanced_receiver_sb_cc(TC, ic_iterations=3, **CPU)
    demap = blocks.resource_demapper_cc(TC, **CPU)

    data = _data(4, seed=1)
    bursts = tx(data)[:, 0, :]
    rx_pre = bursts[:, TC.cp_len : TC.cp_len + 2 * TC.subcarriers]
    chan, tags = est(rx_pre)
    assert tags["snr_lin"].shape == (4,)
    frames = bursts[:, TC.preamble_len + TC.cp_len :][:, : TC.block_len]
    d_hat = demap(rxb(frames, channel=chan)).numpy()
    assert utils.evm(utils.qpsk_hard_map(d_hat), data) < 1e-5


def test_block_flowgraph_with_sync_matches_jax():
    """The phase-13 flowgraph of chip_smoke.py at a few bursts: mapper ->
    transmitter (via the modulator and prefixer) -> sync + extraction ->
    estimator -> receiver -> demapper, against the JAX blocks."""
    out = {}
    rng = np.random.default_rng(13)
    data = _data(6, seed=4)
    noise = (0.005 * (rng.standard_normal((6, 2048)) + 1j * rng.standard_normal((6, 2048)))
             ).astype(np.complex64)
    for key, mod, cfg, kw in (("port", blocks, TC, CPU), ("jax", jblocks, JC, {})):
        grid = mod.resource_mapper_cc(cfg, **kw)(data)
        assert _np(grid).shape == (6, cfg.block_len)
        b = _np(mod.transmitter_cc(cfg, **kw)(data))[:, 0]
        s = _stream(b) + noise
        ext = mod.extract_burst_cc(cfg, **kw)
        bursts = _np(ext(s, ext.sync(s)))
        chan, tags = mod.channel_estimator_cc(cfg, **kw)(
            bursts[:, cfg.cp_len : cfg.cp_len + 2 * cfg.subcarriers])
        frames = bursts[:, cfg.preamble_len + cfg.cp_len :][:, : cfg.block_len]
        syms = mod.advanced_receiver_sb_cc(cfg, **kw)(frames, channel=_np(chan))
        out[key] = _np(mod.resource_demapper_cc(cfg, **kw)(syms))
    _close(out["port"], out["jax"], TOL_RX)
    assert utils.evm(utils.qpsk_hard_map(out["port"]), data) < 1e-5


def test_block_mod_demod_and_prefix_chain():
    mod = blocks.simple_modulator_cc(TC, **CPU)
    rx = blocks.simple_receiver_cc(TC, **CPU)
    pref = blocks.cyclic_prefixer_cc(TC, **CPU)
    depref = blocks.remove_prefix_cc(TC, **CPU)
    mapper = blocks.resource_mapper_cc(TC, **CPU)

    frames = mod(mapper(_data(2, seed=5)))
    back = depref(pref(frames))
    np.testing.assert_allclose(back.numpy(), frames.numpy(), atol=1e-6)
    assert rx(back).shape == (2, TC.block_len)


def test_block_extract_burst_with_builtin_sync():
    ext = blocks.extract_burst_cc(TC, **CPU)
    bursts = blocks.transmitter_cc(TC, **CPU)(_data(2, seed=9))[:, 0, :].numpy()
    stream = _stream(bursts)
    det = ext.sync(stream)
    out = ext(stream, det).numpy()
    np.testing.assert_allclose(out, bursts * det["scale"].numpy()[:, None], atol=1e-3)


def test_block_shaper_and_legacy_modulator():
    data = _data(1, seed=11)
    bursts = blocks.transmitter_cc(TC, **CPU)(data)[:, 0, :]
    assert blocks.short_burst_shaper(TC, scale=0.5, **CPU)(bursts).shape == (
        1, TC.padded_frame_len)
    grid = blocks.resource_mapper_cc(TC, **CPU)(data)
    out = blocks.modulator_cc(TC, fft_len=2 * TC.block_len, **CPU)(grid)
    assert out.shape == (1, 2 * TC.block_len)


def test_preamble_generator_variable_block():
    full, core = blocks.preamble_generator(16, 0.35, 32)
    assert core.shape == (32,)
    halves = core.reshape(2, -1)
    np.testing.assert_allclose(halves[0], halves[1], atol=1e-12)
    full, core = blocks.preamble_generator(12, 0.2, 32, cp_len=8, ramp_len=4)
    assert full.shape == (8 + 32 + 4,)
    with pytest.raises(ValueError):
        blocks.preamble_generator(40, 0.2, 32)
