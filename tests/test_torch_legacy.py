"""The port's legacy modulator and validation frames (gfdm_tpu_torch/ref/
legacy.py, ref/validation.py, ops/legacy.py) against the JAX package's.

The golden-model copies give arrays equal to the originals'; the operator
(complex64 on the CPU) is within 2e-5 of the JAX op, the Tx limit of
tests/test_pallas.py. The JAX package's own tests of these modules
(test_legacy_and_timing.py, test_validation_frames.py) run here on the
copies.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import legacy as jlegacy_ops
from gfdm_tpu.ref import legacy as jlegacy
from gfdm_tpu.ref import validation as jvalidation
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.ops import legacy as legacy_ops
from gfdm_tpu_torch.ops import tx as tx_ops
from gfdm_tpu_torch.ref import filters, legacy, mapping, modulation, utils, validation
from gfdm_tpu_torch.ref.channel_estimation import PreambleChannelEstimator
from gfdm_tpu_torch.ref.demodulation import demodulate_block
from gfdm_tpu_torch.ref.synchronization import find_frame_start

torch.set_num_threads(1)

M, K, ACTIVE, CP, CS = 9, 64, 52, 16, 8
SMALL = dict(timeslots=5, subcarriers=8, active_subcarriers=8, dc_free=False, cp_len=4,
             cs_len=2)


@pytest.fixture(scope="module")
def ref_frame():
    return validation.generate_reference_frame(M, K, ACTIVE, CP, CS)


@pytest.mark.parametrize("ftype,alpha,m,k", [("rrc", 0.5, 9, 16), ("rc", 0.2, 5, 8),
                                             ("rrc", 0.2, 9, 64)])
def test_legacy_copy_equals_the_original(ftype, alpha, m, k):
    taps = legacy.sparse_taps_legacy(ftype, alpha, m, k)
    np.testing.assert_array_equal(taps, jlegacy.sparse_taps_legacy(ftype, alpha, m, k))
    grid = utils.random_qpsk(m * k, seed=2).reshape(k, m)
    for fft_len in (m * k, 2 * m * k + 6):
        np.testing.assert_array_equal(
            legacy.modulate_oversampled_block(grid, taps, fft_len),
            jlegacy.modulate_oversampled_block(grid, taps, fft_len))
    with pytest.raises(ValueError, match="fft_len"):
        legacy.modulate_oversampled_block(grid, taps, m * k - 1)


@pytest.mark.parametrize("args", [(M, K, ACTIVE, CP, CS), (5, 32, 24, 8, 4, 0.35, "rc")])
def test_validation_copy_equals_the_original(args):
    got = validation.generate_reference_frame(*args)
    want = jvalidation.generate_reference_frame(*args)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(validation.embed_frame_in_noise(got.frame, 30, 40, seed=5),
                                  jvalidation.embed_frame_in_noise(want.frame, 30, 40, seed=5))


def test_legacy_taps_layout():
    m, k = 9, 16
    taps = legacy.sparse_taps_legacy("rrc", 0.5, m, k)
    assert taps.size == 2 * m
    assert taps[m] == 0  # legacy generator leaves the M-th bin empty
    H = filters.freq_taps(filters.time_taps("rrc", 0.5, m, k))
    np.testing.assert_allclose(taps[:m], H[:m], atol=1e-12)
    np.testing.assert_allclose(taps[m + 1 :], np.conj(H[m - 1 : 0 : -1]), atol=1e-12)


def test_legacy_modulator_is_centered_modern_modulator():
    """At fft_len == N the legacy output equals the modern modulator (with
    the legacy tap layout) shifted by N/2 + (M+1)/2 bins."""
    for m, k in [(9, 16), (5, 8)]:
        n = m * k
        grid = mapping.data_matrix(utils.random_qpsk(n, seed=3), k)
        x_leg = legacy.modulate_oversampled_block(
            grid, legacy.sparse_taps_legacy("rrc", 0.5, m, k), n)
        H = filters.sparse_freq_taps(filters.freq_taps(filters.time_taps("rrc", 0.5, m, k)),
                                     m, 2)
        H[m] = 0.0
        x_mod = modulation.modulate_block(grid, H, 2)
        shift = n // 2 + (m + 1) // 2
        np.testing.assert_allclose(
            x_leg, x_mod * np.exp(2j * np.pi * shift * np.arange(n) / n), atol=1e-9)


def test_legacy_oversampled_occupies_center():
    cfg = GfdmConfig(**SMALL)
    n, fft_len = cfg.block_len, 2 * cfg.block_len
    x = legacy_ops.modulate_oversampled(
        cfg, utils.random_qpsk(n, seed=9), fft_len, device="cpu").numpy()
    assert x.shape == (fft_len,)
    X = np.abs(np.fft.fft(x))
    guard = X[fft_len // 4 : 3 * fft_len // 4].sum()
    assert X.sum() - guard > 10 * guard


@pytest.mark.parametrize("name,cfg_kw", [("small", SMALL), ("canonical", {})])
def test_legacy_op_matches_golden_and_jax(name, cfg_kw):
    cfg, jcfg = GfdmConfig(**cfg_kw), JaxConfig(**cfg_kw)
    n = cfg.block_len
    np.testing.assert_array_equal(legacy_ops.legacy_taps(cfg), jlegacy_ops.legacy_taps(jcfg))
    batch = np.stack([utils.random_qpsk(n, seed=i) for i in range(3)]).astype(np.complex64)
    for fft_len in (n, 1024):
        got = legacy_ops.modulate_oversampled(cfg, batch, fft_len=fft_len, device="cpu")
        assert got.dtype == torch.complex64 and got.shape == (3, fft_len)
        want = np.asarray(jlegacy_ops.modulate_oversampled(jcfg, batch, fft_len=fft_len))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
        taps = legacy_ops.legacy_taps(cfg)
        for b in range(3):
            ref = legacy.modulate_oversampled_block(
                batch[b].reshape(cfg.subcarriers, cfg.timeslots), taps, fft_len)
            np.testing.assert_allclose(got[b].numpy(), ref, atol=2e-5)
    # the default fft_len is the block length
    default = legacy_ops.modulate_oversampled(cfg, torch.from_numpy(batch))
    np.testing.assert_array_equal(
        default.numpy(), legacy_ops.modulate_oversampled(cfg, batch, n, device="cpu").numpy())


def test_legacy_op_refuses_short_fft_and_wrong_width():
    cfg = GfdmConfig(**SMALL)
    x = np.zeros((2, cfg.block_len), np.complex64)
    with pytest.raises(ValueError, match="fft_len must be >="):
        legacy_ops.modulate_oversampled(cfg, x, fft_len=cfg.block_len - 1, device="cpu")
    with pytest.raises(ValueError, match="fft_len"):
        jlegacy_ops.modulate_oversampled(JaxConfig(**SMALL), x, fft_len=cfg.block_len - 1)
    with pytest.raises(ValueError, match="timeslots\\*subcarriers"):
        legacy_ops.modulate_oversampled(cfg, x[:, :-1], device="cpu")


def test_demap_indices_by_name_in_ops_tx():
    from gfdm_tpu.ops import tx as jtx

    for kw in ({}, SMALL):
        np.testing.assert_array_equal(tx_ops.demap_indices(GfdmConfig(**kw)),
                                      jtx.demap_indices(JaxConfig(**kw)))


def test_deterministic(ref_frame):
    again = validation.generate_reference_frame(M, K, ACTIVE, CP, CS)
    np.testing.assert_array_equal(ref_frame.frame, again.frame)
    np.testing.assert_array_equal(ref_frame.data, again.data)


def test_shapes(ref_frame):
    assert ref_frame.x_preamble.size == 2 * K
    assert ref_frame.modulated_payload.size == M * K
    assert ref_frame.frame.size == (2 * K + CP + CS) + (M * K + CP + CS)
    assert ref_frame.data.size == M * ACTIVE


def test_preamble_halves_repeat(ref_frame):
    x = ref_frame.x_preamble
    np.testing.assert_allclose(x[:K], x[K:], atol=1e-12)


def test_payload_demodulates_to_data(ref_frame):
    taps = filters.normalize_taps_energy(filters.frequency_domain_filter("rrc", 0.2, M, K, 2),
                                         M)
    grid = demodulate_block(ref_frame.modulated_payload, taps, 2).reshape(K, M)
    smap = mapping.subcarrier_map(K, ACTIVE, dc_free=True)
    est = mapping.demap_from_resources(grid, M, smap, per_timeslot=True)
    assert np.sum(utils.qpsk_hard_map(est) != utils.qpsk_hard_map(ref_frame.data)) == 0


def test_estimator_identity_channel(ref_frame):
    est = PreambleChannelEstimator(M, K, ACTIVE, True, ref_frame.x_preamble)
    H = est.estimate_frame(ref_frame.x_preamble)
    half = ACTIVE // 2
    active = np.concatenate((H[: M * half], H[-M * half :]))
    np.testing.assert_allclose(active, np.ones_like(active), atol=1e-5)
    assert np.all(np.isfinite(H))


def test_sync_finds_embedded_frame(ref_frame):
    capture = validation.embed_frame_in_noise(ref_frame.frame, 777, 333, seed=7)
    res = find_frame_start(capture, ref_frame.x_preamble, K, CP)
    assert abs(int(res.frame_start) - (777 + CP)) <= 2
