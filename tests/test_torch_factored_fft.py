"""The factored kernels' K-point FFT (csrc/factored.cu), replayed on the CPU.

tests/factored_fft_emulation.py replays the kernels' schedule with numpy:
the plan of radices (``emu.fft_plan``), each butterfly's indices in the
padded row layout (``emu.row_stride``, ``emu.pos``), the twiddle index into
the K-entry table (row 1 of the realified K-point operator), the
bit-reversed input and natural-order output, and the Tx's scale (table times K, 1/K once). The replay must match
``np.fft`` within 1e-5 of the largest magnitude, and the plain version's
dense ``FK_W`` / ``iFK_W`` product as well, in both directions and in both
output layouts (the receiver's Z[n1, k2], the Tx's core sample M n2 + n1),
at K = 32 to 1024 and M = 5 and 9; K = 96 takes the direct DFT.
"""
import numpy as np
import pytest

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.ops import planar_fast
import factored_fft_emulation as emu

KS = (32, 64, 128, 256, 512, 1024)
MS = (5, 9)
TOL = 1e-5  # relative to the largest magnitude: float32 sums over log2 K passes


def _cfg(K: int, M: int) -> GfdmConfig:
    return GfdmConfig(subcarriers=K, active_subcarriers=3 * K // 4, timeslots=M,
                      cp_len=K // 4, cs_len=K // 8)


def _ops(K: int):
    """The plain version's (2K, 2K) FK_W and iFK_W (float32 numpy)."""
    c = planar_fast._fft_consts(_cfg(K, 5), "float32")
    return np.asarray(c["FK_W"]), np.asarray(c["iFK_W"])


def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _dense(rows: np.ndarray, w: np.ndarray) -> np.ndarray:
    """rows (M, K) complex times the realified operator, as the plain
    version multiplies: [re | im] @ W in float32."""
    K = rows.shape[1]
    y = np.concatenate([rows.real, rows.imag], axis=1).astype(np.float32) @ w
    return y[:, :K] + 1j * y[:, K:]


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("K", KS + (96, 2048))
def test_plan_and_layout(K):
    """Radices 8 with the odd last pass 2 or 4, product K; no plan (the
    direct DFT) for K = 96. A row's padded elements fit its stride, and the
    first 9 rows start on distinct 8-byte banks of 16."""
    plan = emu.fft_plan(K)
    if K == 96:
        assert plan == ()
    else:
        assert int(np.prod(plan)) == K
        assert all(r == 8 for r in plan[:-1]) and plan[-1] in (2, 4, 8)
    stride = emu.row_stride(K)
    pos = emu.pos(np.arange(K))
    assert (np.diff(pos) > 0).all() and pos[-1] < stride
    assert len({(r * stride) % 16 for r in range(9)}) == 9


@pytest.mark.parametrize("K", KS)
def test_passes_touch_every_element_once(K):
    """Each pass's butterflies read (and write back) every element of every
    row exactly once: the passes run in place with no two threads on one
    word."""
    M = 9
    seen = []
    emu.fft_rows(np.zeros(M * emu.row_stride(K), np.complex64), K, M,
                 np.ones(K, np.complex64), False, passes_seen=seen)
    assert len(seen) == len(emu.fft_plan(K))
    stride = emu.row_stride(K)
    every = (np.arange(M)[:, None] * stride + emu.pos(np.arange(K))).ravel()
    for reads in seen:
        assert np.array_equal(np.sort(reads), np.sort(every))


@pytest.mark.parametrize("K", KS)
def test_twiddle_table(K):
    """Each pass's slice holds W^(j q K / Ls) from row 1 of FK_W; the Tx's,
    from iFK_W times K, is the receiver's conjugate bit for bit."""
    fk, ifk = _ops(K)
    rx = emu.twiddles(emu.table_row(fk))
    tx = emu.twiddles(emu.table_row(ifk), K)
    off, ls = 0, 1
    for r in emu.fft_plan(K):
        s, ls = ls, ls * r
        q, j = np.arange(1, r)[:, None], np.arange(s)[None, :]
        want = np.exp(-2j * np.pi * (j * q) / ls).ravel()
        np.testing.assert_allclose(rx[off : off + (r - 1) * s], want, atol=1e-7)
        off += (r - 1) * s
    assert off == K - 1
    assert np.array_equal(tx[:off], np.conj(rx[:off]))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("K", KS + (96,))
def test_receiver_k_stage_matches_fft_and_dense(K, M):
    """Z[n1, k2] = sum_n2 x[M n2 + n1] W_K^(n2 k2), as stage 3 reads it."""
    x = _signal(M * K, K + M)
    fk, _ = _ops(K)
    got = emu.rx_k_stage(x, K, M, fk)
    rows = x.reshape(K, M).T  # rows[n1, n2] = x[M n2 + n1]
    assert _rel(got, np.fft.fft(rows.astype(np.complex128), axis=1)) <= TOL
    assert _rel(got, _dense(rows, fk)) <= TOL


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("K", KS + (96,))
def test_tx_k_stage_matches_ifft_and_dense(K, M):
    """core[M n2 + n1] = (1/K) sum_k2 z[n1, k2] W_K^(-n2 k2), as the
    framing reads it."""
    z = _signal((M, K), 7 * K + M)
    _, ifk = _ops(K)
    got = emu.tx_k_stage(z, K, M, ifk)
    ref = np.fft.ifft(z.astype(np.complex128), axis=1)  # (M(n1), K(n2))
    assert _rel(got, ref.T.ravel()) <= TOL
    assert _rel(got, _dense(z, ifk).T.ravel()) <= TOL
