"""The port's factored (large-K) kernels' plain versions against the JAX package.

On the CPU the wrappers run the kernels' plain torch versions; the Pallas
kernels run in interpret mode as tests/test_pallas.py runs them, on the same
numpy-seeded float32 inputs, with its limits: bursts atol 2e-5, channel
1e-5, symbols 1e-4. Each stage of the plain versions is also pinned against
a NumPy transcription of the Pallas kernel body (its rolls, masks and
coefficient rows, built from the JAX package's own tables), so a roll sign
or a layout slip shows at the stage where it happens. tests/test_torch_gpu.py
holds the CUDA kernels against these plain versions on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu.ops import planar_fast as jax_pf
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config, planar_payload
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops import planar_fast as pf
from gfdm_tpu_torch.ops.planar import pmatmul

torch.set_num_threads(1)

B = 4
AMP = 2.0**-0.5
CONFIGS = {
    "k64": {},
    "k128": {"subcarriers": 128, "active_subcarriers": 100, "timeslots": 9,
             "cp_len": 32, "cs_len": 16},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
}


def _pair(name):
    kw = CONFIGS[name]
    return JaxConfig(**kw), GfdmConfig(**kw)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _noisy_bursts(jc, seed, batch=B):
    data = planar_payload(jc, batch, seed)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))[:, 0]
    return data, (bursts + 0.01 * _rand(bursts.shape, seed + 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# the Pallas kernel bodies, transcribed to NumPy (float64 on float32 tables)
# ---------------------------------------------------------------------------
def _groll(v, s):
    """groll(v, s)[c] = v[(c - s) mod N] on the last axis."""
    return np.roll(v, s % v.shape[-1], axis=-1)


def _block_rot(v, j, masks, M):
    if j == 0:
        return v
    return np.where(masks[j - 1] > 0, _groll(v, j - M), _groll(v, j))


def _coef_sum(rows_r, rows_i, shifted):
    """sum_j coef_j * shifted(j) for planar (re, im) pairs."""
    sr = si = 0.0
    for j in range(rows_r.shape[0]):
        vr, vi = shifted(j)
        sr = sr + rows_r[j] * vr - rows_i[j] * vi
        si = si + rows_r[j] * vi + rows_i[j] * vr
    return sr, si


def _planar(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _to_natural(S):
    """(B, K, 2, M) per-subcarrier layout -> (B, 2, N)."""
    S = _planar(S)
    return np.moveaxis(S, -2, -3).reshape(S.shape[0], 2, -1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_stages_match_the_pallas_body(name):
    """K-point DFTs + M-stage rolls (mc rows), ZF clamp, L-tap fold (ft rows),
    masked M-IFFT rolls (iv rows), circulant IC (a * c taps)."""
    jc, tc = _pair(name)
    K, M, L, n = tc.subcarriers, tc.timeslots, tc.overlap, tc.block_len
    fc = jax_fused._factored_consts(jc)
    masks = jax_fused._circ_masks(jc)
    k = fused._factored_consts(tc, "cpu")
    frame = _rand((B, 2, n), 11)

    # K-stage on the reordered frame, then the M-stage of coefficient rolls
    xt = frame[..., fc["reorder"]].astype(np.float64)
    Z = np.zeros_like(xt)
    for n1 in range(M):
        row = np.concatenate([xt[:, 0, n1 * K:(n1 + 1) * K], xt[:, 1, n1 * K:(n1 + 1) * K]], 1)
        z = row @ fc["FK_W"]
        Z[:, 0, n1 * K:(n1 + 1) * K], Z[:, 1, n1 * K:(n1 + 1) * K] = z[:, :K], z[:, K:]
    Xr, Xi = _coef_sum(fc["mcr"], fc["mci"],
                       lambda j: (_groll(Z[:, 0], j * K), _groll(Z[:, 1], j * K)))
    X = pf.fast_fft_n(tc, torch.from_numpy(frame), k)
    np.testing.assert_allclose(X[:, 0].numpy(), Xr, atol=1e-4)
    np.testing.assert_allclose(X[:, 1].numpy(), Xi, atol=1e-4)

    # ZF with |C|^2 clamped at 1e-30: a zero channel bin gives 0, not NaN
    chan = np.float32(0.3) * _rand((B, 2, n), 12) + np.float32(1.5)  # |C| >= ~0.5
    chan[0, :, 3] = 0.0
    Cr, Ci = chan[:, 0].astype(np.float64), chan[:, 1].astype(np.float64)
    den = np.maximum(Cr * Cr + Ci * Ci, 1e-30)
    Yr, Yi = (Xr * Cr + Xi * Ci) / den, (Xi * Cr - Xr * Ci) / den
    Y = fused._zf_clamped(X, torch.from_numpy(chan))
    assert float(Y[0, 0, 3]) == 0.0 and float(Y[0, 1, 3]) == 0.0
    np.testing.assert_allclose(Y[:, 0].numpy(), Yr, atol=1e-4)
    np.testing.assert_allclose(Y[:, 1].numpy(), Yi, atol=1e-4)

    # fold: L tap-weighted rolls by -(i - L//2) M
    Sr, Si = _coef_sum(fc["ftr"], fc["fti"],
                       lambda i: (_groll(Yr, -(i - L // 2) * M), _groll(Yi, -(i - L // 2) * M)))
    S = pf._fold_rx(tc, Y, k)
    np.testing.assert_allclose(_to_natural(S), np.stack([Sr, Si], 1), atol=1e-4)

    # per-subcarrier M-IFFT: masked block rotations
    Dr, Di = _coef_sum(fc["ivr"], fc["ivi"], lambda j: (_block_rot(Sr, j, masks, M),
                                                        _block_rot(Si, j, masks, M)))
    d0 = pmatmul(S, k["iFM_W"])
    np.testing.assert_allclose(_to_natural(d0), np.stack([Dr, Di], 1), atol=1e-4)

    # IC: +-1 decisions on active symbols, neighbours k-1 + k+1, taps a * c_j
    d0 = torch.from_numpy(np.stack([Dr, Di], 1).astype(np.float32))
    c_col = jax_pp._interference_matrix(jc)[:, 0]
    act = np.zeros(n)
    for sc in jc.subcarrier_map:
        act[sc * M:(sc + 1) * M] = 1.0
    dr, di = d0[:, 0].numpy().astype(np.float64), d0[:, 1].numpy().astype(np.float64)
    d0r, d0i = dr, di
    for _ in range(2):
        h = [np.where(v >= 0, 1.0, -1.0) * act for v in (dr, di)]
        nb = [_groll(v, M) + _groll(v, -M) for v in h]
        ir, ii = _coef_sum(np.float32(AMP * c_col.real), np.float32(AMP * c_col.imag),
                           lambda j: (_block_rot(nb[0], j, masks, M),
                                      _block_rot(nb[1], j, masks, M)))
        dr, di = d0r - ir, d0i - ii
    got = fused._ic_factored(tc, k, d0, 2)
    np.testing.assert_allclose(got.numpy(), np.stack([dr, di], 1), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tx_stages_match_the_pallas_body(name):
    """Per-SC M-FFT (txa rows), overlap-add by +(i - L//2) M (ftx rows),
    M-stage rolls by j K (mt rows) + K-point IDFTs + un-reorder."""
    jc, tc = _pair(name)
    K, M, L, n = tc.subcarriers, tc.timeslots, tc.overlap, tc.block_len
    tcs = jax_fused._tx_factored_consts(jc)
    masks = jax_fused._circ_masks(jc)
    k = fused._factored_consts(tc, "cpu")
    g = _rand((B, 2, n), 13).astype(np.float64)

    Wr, Wi = _coef_sum(tcs["txar"], tcs["txai"], lambda j: (_block_rot(g[:, 0], j, masks, M),
                                                            _block_rot(g[:, 1], j, masks, M)))
    gk = torch.movedim(torch.from_numpy(g.astype(np.float32)).reshape(B, 2, K, M), -3, -2)
    W = pmatmul(gk, k["FM_W"])  # (B, K, 2, M)
    np.testing.assert_allclose(_to_natural(W), np.stack([Wr, Wi], 1), atol=1e-5)

    Xr, Xi = _coef_sum(tcs["ftxr"], tcs["ftxi"],
                       lambda i: (_groll(Wr, (i - L // 2) * M), _groll(Wi, (i - L // 2) * M)))
    X = pf._scatter_tx(tc, W, k)
    np.testing.assert_allclose(X.numpy(), np.stack([Xr, Xi], 1), atol=1e-5)

    Zr, Zi = _coef_sum(tcs["mtr"], tcs["mti"],
                       lambda j: (_groll(Xr, j * K), _groll(Xi, j * K)))
    xt = np.zeros((B, 2, n))
    for n1 in range(M):
        row = np.concatenate([Zr[:, n1 * K:(n1 + 1) * K], Zi[:, n1 * K:(n1 + 1) * K]], 1)
        y = row @ tcs["iFK_W"]
        xt[:, 0, n1 * K:(n1 + 1) * K], xt[:, 1, n1 * K:(n1 + 1) * K] = y[:, :K], y[:, K:]
    core = xt[..., tcs["unreorder"]]
    np.testing.assert_allclose(pf.fast_ifft_n(tc, X, k).numpy(), core, atol=1e-5)


@pytest.mark.parametrize("name,shift_index", [("k64", 0), ("k64", 1), ("k128", 0),
                                              ("k32m5", 1)])
def test_tx_frame_factored_matches_pallas(name, shift_index):
    kw = {**CONFIGS[name], "cyclic_shifts": (0, 4)}
    jc, tc = JaxConfig(**kw), GfdmConfig(**kw)
    data = planar_payload(tc, B, 20)
    ref = np.asarray(jax_fused.tx_frame_factored(jc, jnp.asarray(data), block=B,
                                                 shift_index=shift_index))
    before = dict(fused.LAUNCHES)
    got = fused.tx_frame_factored(tc, torch.from_numpy(data), shift_index=shift_index)
    assert fused.LAUNCHES == before
    assert got.shape == (B, 2, tc.frame_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


@pytest.mark.parametrize("name", ["k64", "k128"])
@pytest.mark.parametrize("estimator", ["fused", "fast"])
def test_rx_receiver_factored_matches_pallas(name, estimator):
    jc, tc = _pair(name)
    _data, bursts = _noisy_bursts(jc, 30)
    chan_r, sym_r = jax_fused.rx_receiver_factored(jc, jnp.asarray(bursts), ic_iterations=2,
                                                   block=B, estimator=estimator)
    chan, sym = fused.rx_receiver_factored(tc, torch.from_numpy(bursts), ic_iterations=2,
                                           estimator=estimator)
    assert chan.shape == sym.shape == (B, 2, tc.block_len)
    np.testing.assert_allclose(chan.numpy(), np.asarray(chan_r), atol=1e-5)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=1e-4)


@pytest.mark.parametrize("name", ["k64", "k32m5"])
@pytest.mark.parametrize("estimator", ["fused", "fast"])
@pytest.mark.parametrize("amp", [AMP, 0.6])
def test_rx_receiver_factored_qpsk_amp_matches_pallas(name, estimator, amp):
    """qpsk_amp reaches the IC taps of both estimators' receivers, as in the
    JAX package's rx_receiver_factored(qpsk_amp=...)."""
    jc, tc = _pair(name)
    _data, bursts = _noisy_bursts(jc, 31)
    chan_r, sym_r = jax_fused.rx_receiver_factored(jc, jnp.asarray(bursts), block=B,
                                                   qpsk_amp=amp, estimator=estimator)
    chan, sym = fused.rx_receiver_factored(tc, torch.from_numpy(bursts), qpsk_amp=amp,
                                           estimator=estimator)
    np.testing.assert_allclose(chan.numpy(), np.asarray(chan_r), atol=1e-5)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=1e-4)
    if amp != AMP:  # the amplitude moves the symbols
        _c, sym_q = fused.rx_receiver_factored(tc, torch.from_numpy(bursts), estimator=estimator)
        assert float((sym - sym_q).abs().max()) > 1e-3
        np.testing.assert_array_equal(fused._factored_taps(tc, "cpu", amp).numpy(),
                                      fused._ftaps_np(tc, amp))


def test_factored_link_at_k256_gives_the_payload_back():
    """tests/test_pallas.py::test_tx_frame_factored_large_K_link on the port:
    K = 256, B = 2; the bursts match the JAX factored Tx and every hard
    decision after the factored receiver is the payload's."""
    jc = JaxConfig(subcarriers=256, active_subcarriers=200, timeslots=9,
                   cp_len=64, cs_len=32)
    tc = large_k_config(256)
    assert (tc.active_subcarriers, tc.cp_len, tc.cs_len) == (200, 64, 32)
    data = planar_payload(tc, 2, 40)
    ref = np.asarray(jax_fused.tx_frame_factored(jc, jnp.asarray(data), block=2))
    bursts = fused.tx_frame_factored(tc, torch.from_numpy(data))
    np.testing.assert_allclose(bursts.numpy(), ref, atol=2e-5)
    _chan, sym = fused.rx_receiver_factored(tc, bursts, estimator="fast")
    got = sym[..., fused._factored_consts(tc, "cpu")["demap_idx"]]
    assert torch.equal(torch.sign(got), torch.sign(torch.from_numpy(data)))
    d_hat, evm = fused.link_step_factored(tc, torch.from_numpy(data))
    assert torch.equal(d_hat, got) and 0.0 < float(evm) < 0.025


def test_factored_ic_taps_fold_the_amplitude_in_float64():
    """The factored kernels' taps are float32(a * c) with c in float64, as
    the JAX factored kernels fold them; the dense kernels' conv taps round
    c to float32 first. The two differ by at most one float32 ulp."""
    for name in sorted(CONFIGS):
        jc, tc = _pair(name)
        c_col = jax_pp._interference_matrix(jc)[:, 0]
        want = np.stack([np.float32(AMP * c_col.real), np.float32(AMP * c_col.imag)])
        got = fused._factored_np(tc)["ftaps"]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        c32 = np.stack([c_col.real, c_col.imag]).astype(np.float32)
        conv = (c32.astype(np.float64) * AMP).astype(np.float32)  # the dense kernels' conv taps
        np.testing.assert_array_max_ulp(conv, got, maxulp=1)
    np.testing.assert_array_equal(conv, fused._kernel_consts(tc, "cpu")["taps"].numpy())


def test_factored_map_index_matches_the_mapping_matrix():
    from gfdm_tpu.ops import operators as jax_ops

    from gfdm_tpu_torch.ops import planar_pipeline as pp

    for kw in [*CONFIGS.values(), {"per_timeslot": False}]:
        jc, tc = JaxConfig(**kw), GfdmConfig(**kw)
        got = fused._factored_np(tc)["map_idx"]
        want = np.full(jc.block_len, jc.n_data_symbols)
        rows, cols = np.nonzero(jax_ops.mapping_matrix(jc).real)
        want[rows] = cols
        np.testing.assert_array_equal(got, want)
        # the explicit-loop map of method="fast" is the same index set
        np.testing.assert_array_equal(got, pp._tx_map_idx(tc))


def test_zf_clamp_pinned_against_the_unclamped_fast_demod():
    """The factored kernels clamp |C|^2 at 1e-30; planar_fast.demod_fast
    divides unclamped, in both packages: a zero channel gives NaN there."""
    jc, tc = _pair("k64")
    x = _rand((1, 2, tc.block_len), 50)
    h = np.zeros_like(x)
    ref = np.asarray(jax_pf.demod_fast(jc, jnp.asarray(x), jnp.asarray(h),
                                       jax_pf._fft_consts(jc, "float32")))
    got = pf.demod_fast(tc, torch.from_numpy(x), torch.from_numpy(h),
                        pf.fast_consts(tc, "float32", "cpu"))
    assert np.isnan(ref).all() and torch.isnan(got).all()
    X = pf.fast_fft_n(tc, torch.from_numpy(x), pf.fast_consts(tc, "float32", "cpu"))
    assert not fused._zf_clamped(X, torch.from_numpy(h)).any()


def test_factored_plain_versions_take_any_batch_and_validate():
    cfg = GfdmConfig()
    before = dict(fused.LAUNCHES)
    data = torch.from_numpy(planar_payload(cfg, 5, 60))
    d_hat, evm = fused.link_step_factored(cfg, data)
    assert d_hat.shape == (5, 2, cfg.n_data_symbols) and 0.0 < float(evm) < 0.025
    chan, sym = fused.rx_receiver_factored(cfg, fused.tx_frame_factored(cfg, data))
    assert chan.shape == sym.shape == (5, 2, cfg.block_len)
    assert fused.LAUNCHES == before
    with pytest.raises(ValueError, match="estimator"):
        fused.rx_receiver_factored(cfg, torch.zeros(2, 2, cfg.frame_len), estimator="dense")
    with pytest.raises(ValueError, match="shape"):
        fused.tx_frame_factored(cfg, data[..., :-1])
    with pytest.raises(TypeError, match="float32"):
        fused.rx_receiver_factored(cfg, torch.zeros(2, 2, cfg.frame_len, dtype=torch.float64))
