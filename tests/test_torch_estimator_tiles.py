"""The factored receiver's estimator GEMM (csrc/factored.cu rx_estimate_kernel
on csrc/fma_gemm.cuh), its tile schedule replayed in NumPy on the CPU.

H (B, 2N) = A (B, 4K) @ E_W (4K, 2N), row b of A the preamble window
[bursts[b, 0, cp : cp + 2K] | bursts[b, 1, cp : cp + 2K]] read in place.
The replay follows the kernel copy by copy: each of the 128 threads' copies
of a 16-deep k-tile into the A slot (64 bursts x 16) and the W slot (16 x 128
columns), 16 or 4 bytes wide as the launcher chooses from cp_len, frame_len,
K and N, each source address taken from the flat (B, 2, frame_len) bursts or
the flat E_W, zero-filled past B, 2N and 4K; every slot word is written once
(pre-filled with NaN). The tiles' products are summed in float64 and stored
through the threads' 8 x 8 blocks (rows ty + 8 i, columns 4 tx + 64 h + e)
into an output pre-filled with NaN, rows and columns past B and 2N not
stored. The result must equal the float64 product pre2 @ E_W within 1e-9
of its largest value (the sums differ only in order), and the plain version
(``fused._rx_estimate_plain``, float32) within 1e-5 of it. Configs: the
canonical one (16-byte copies, 2N = 1,152 = 9 column tiles), K = 128 (the
estimator's main-path config), K = 96 (2N = 1,728: a half column tile),
K = 64 at M = 5 with cp_len 6 and frame_len 466 (4-byte copies of A) and K =
33 at M = 5 (N = 165 odd: 4-byte copies of E_W and 4-byte stores, a ragged
k-tile at 4K = 132); batches 1, 63, 65 and 130 (ragged row tiles).
"""
import numpy as np
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config
from gfdm_tpu_torch.kernels import fused

torch.set_num_threads(1)

THREADS = 128  # csrc/fma_gemm.cuh fg::THREADS
# fg::BM, fg::BN, fg::BK: bursts, channel columns and k-depth of a CTA (the
# library's gfdm_rx_estimate_tile; tests/test_torch_gpu.py holds them equal)
BM, BN, BK = 64, 128, 16
TY = THREADS // 16
CONFIGS = {
    "canonical": GfdmConfig(),
    "K128": large_k_config(128),
    "K96": GfdmConfig(subcarriers=96, active_subcarriers=72, timeslots=9),
    "K64_M5_unaligned": GfdmConfig(subcarriers=64, active_subcarriers=50, timeslots=5,
                                   cp_len=6, cs_len=3),
    "K33_M5_odd_n": GfdmConfig(subcarriers=33, active_subcarriers=26, timeslots=5, cp_len=7,
                               cs_len=4),
}
# (16-byte copies of A, 16-byte copies of E_W and stores) of each config
LOADS = {"canonical": (True, True), "K128": (True, True), "K96": (True, True),
         "K64_M5_unaligned": (False, True), "K33_M5_odd_n": (False, False)}
BATCHES = (1, 63, 65, 130)


def copy_widths(cfg):
    """(a16, w16) as csrc/factored.cu launch_rx_estimate picks them for
    16-byte aligned tensors."""
    a16 = cfg.cp_len % 4 == 0 and cfg.frame_len % 4 == 0 and cfg.subcarriers % 2 == 0
    return a16, (2 * cfg.block_len) % 4 == 0


def _copies(n_words: int, wide: bool):
    """The copy index c of every copy of a slot of ``n_words`` floats: thread
    tid's i-th copy is c = tid + 128 i, 4 floats wide or 1."""
    per = n_words // (4 if wide else 1) // THREADS
    return (np.arange(THREADS)[None, :] + THREADS * np.arange(per)[:, None]).ravel()


def _fill(slot_len, dst, src, flat, width):
    """A ring slot from its copies: dst slot offsets, src flat offsets (-1:
    zero-fill), ``width`` floats a copy; each word written once."""
    slot = np.full(slot_len, np.nan)
    hits = np.zeros(slot_len, dtype=int)
    for j in range(width):
        hits[dst + j] += 1
        slot[dst + j] = np.where(src >= 0, flat[np.maximum(src, 0) + j], 0.0)
    assert (hits == 1).all()
    if width == 4:  # 16-byte copies: 16-byte aligned source words
        assert (src[src >= 0] % 4 == 0).all()
    return slot


def a_slot(cfg, bursts_flat, rows, m0, k0, a16):
    """The A slot [64][16] of k-tile k0 for the row tile at m0."""
    K2, L, cp = 2 * cfg.subcarriers, cfg.frame_len, cfg.cp_len
    kd = 2 * K2
    c = _copies(BM * BK, a16)
    r, kk = (c >> 2, 4 * (c & 3)) if a16 else (c >> 4, c & 15)
    k = k0 + kk
    ok = (m0 + r < rows) & (k < kd)
    src = (m0 + r) * 2 * L + np.where(k < K2, cp + k, L + cp + (k - K2))
    return _fill(BM * BK, r * BK + kk, np.where(ok, src, -1), bursts_flat,
                 4 if a16 else 1).reshape(BM, BK)


def w_slot(cfg, ew_flat, n0, k0, w16):
    """The W slot [16][128] of k-tile k0 for the column tile at n0."""
    kd, cols = 4 * cfg.subcarriers, 2 * cfg.block_len
    c = _copies(BK * BN, w16)
    r, col = (c >> 5, 4 * (c & 31)) if w16 else (c >> 7, c & 127)
    ok = (k0 + r < kd) & (n0 + col < cols)
    src = (k0 + r) * cols + n0 + col
    return _fill(BK * BN, r * BN + col, np.where(ok, src, -1), ew_flat,
                 4 if w16 else 1).reshape(BK, BN)


def thread_blocks():
    """(tile row, tile column) of acc[i][4 h + e] of every thread: rows
    ty + 8 i, columns 4 tx + 64 h + e."""
    tid, i, h, e = np.meshgrid(np.arange(THREADS), np.arange(8), np.arange(2), np.arange(4),
                               indexing="ij")
    return (tid >> 4) + TY * i, 4 * (tid & 15) + 64 * h + e


def estimate_tiles(cfg, bursts: np.ndarray, e_w: np.ndarray) -> np.ndarray:
    """(B, 2, frame_len) bursts, (4K, 2N) E_W -> (B, 2N) H, tile by tile."""
    rows, kd, cols = bursts.shape[0], 4 * cfg.subcarriers, 2 * cfg.block_len
    a16, w16 = copy_widths(cfg)
    bflat = bursts.astype(np.float64).ravel()
    wflat = e_w.astype(np.float64).ravel()
    tr, tc = thread_blocks()
    out = np.full((rows, cols), np.nan)
    for m0 in range(0, rows, BM):
        for n0 in range(0, cols, BN):
            acc = np.zeros((BM, BN))
            for k0 in range(0, kd, BK):
                acc += a_slot(cfg, bflat, rows, m0, k0, a16) @ w_slot(cfg, wflat, n0, k0, w16)
            keep = (m0 + tr < rows) & (n0 + tc < cols)
            out[m0 + tr[keep], n0 + tc[keep]] = acc[tr[keep], tc[keep]]
    return out


def _bursts(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, 2, cfg.frame_len)).astype(np.float32)


def test_tile_constants_and_thread_blocks():
    assert (BM, BN, BK) == (64, 128, 16) and BM == TY * 8
    tr, tc = thread_blocks()
    assert np.array_equal(np.sort((tr * BN + tc).ravel()), np.arange(BM * BN))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_copy_widths(name):
    assert copy_widths(CONFIGS[name]) == LOADS[name]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tiles_match_the_estimate(name, batch):
    cfg = CONFIGS[name]
    K = cfg.subcarriers
    bursts = _bursts(cfg, batch, 11 + batch)
    e_w = fused._estimator_op(cfg, "cpu").numpy()
    got = estimate_tiles(cfg, bursts, e_w)
    assert not np.isnan(got).any()
    pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(batch, 4 * K)
    ref = pre2.astype(np.float64) @ e_w.astype(np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * scale)
    plain = fused._rx_estimate_plain(cfg, torch.from_numpy(bursts)).reshape(batch, -1)
    np.testing.assert_allclose(plain.numpy(), got, rtol=0, atol=1e-5 * scale)
