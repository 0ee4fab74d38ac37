"""The Viterbi kernel's contract and schedule on the CPU (csrc/viterbi.cu).

The kernel itself runs only on a card (tests/test_torch_gpu.py holds it to
the plain version there). Here: the tables the wrapper hands it against
the torch-op decoder's (coding._radix_tables / _pattern_index /
_trellis), its per-codeword options (initial metrics, traceback from the
argmax) as the windowed and one-step modes build them against the
decoder those modes ran before, the wrapper's refusals, and the kernel's
per-lane schedule replayed in NumPy float32 (prefix and tree pattern sums,
two next states a lane, decision words of 16 / k steps, the traceback
through them) against the plain version, bit for bit.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu_torch import coding
from gfdm_tpu_torch.kernels import viterbi
from dyadic_llrs import dyadic_llrs, noisy_llrs


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_kernel_tables_match_the_radix_tables(k):
    """q_j[j] ^ q_ns[ns] is the pattern index of every (ns, j) transition,
    its bits the negated terms of _radix_tables' signs; pred is the
    predecessor that k single trellis steps reach."""
    tabs = viterbi.kernel_tables(k)
    q = tabs["q_j"][None, :] ^ tabs["q_ns"][:, None]
    np.testing.assert_array_equal(q.reshape(-1), coding._pattern_index(k))
    neg = (q[..., None] >> np.arange(2 * k - 1, -1, -1)) & 1
    np.testing.assert_array_equal(1.0 - 2.0 * neg, coding._radix_tables(k))
    prev = coding._trellis()[0]  # (64, 2): one step back, by the shifted-out bit
    for ns in range(64):
        for j in range(1 << k):
            state = ns
            for i in range(k):  # the oldest shifted-out bit is j's MSB
                state = prev[state, (j >> i) & 1]
            assert tabs["pred"][ns, j] == state


def _old_decode(lp, k, pm0=None, argmax=None):
    """The torch-op composition the modes ran before the kernel: pattern
    sums, ACS, then the traceback from state 0 or the argmax."""
    B, T = lp.shape[:2]
    lt = lp.reshape(B, T // k, 2 * k).transpose(0, 1)
    idx = torch.from_numpy(coding._pattern_index(k))
    pm0 = coding._initial_metrics(B, "cpu") if pm0 is None else pm0
    pm, decs = coding._forward(coding._pattern_sums(lt), idx, k, pm0)
    start = torch.zeros(B, dtype=torch.int64) if argmax is None else torch.where(
        argmax, pm.argmax(dim=-1), 0)
    return coding._traceback(decs, start, k)


def _llrs(kind, n_info, rows, seed):
    if kind == "dyadic":
        return dyadic_llrs(n_info, rows, seed)[0]
    return noisy_llrs(rows, n_info + 6, seed).reshape(rows, -1)


@pytest.mark.parametrize("kind", ["dyadic", "continuous"])
@pytest.mark.parametrize("n_info", [462, 133])
def test_options_reproduce_the_windowed_and_full_modes(n_info, kind):
    """The windowed mode's options (its windows' initial metrics, the
    argmax start where a window ends before T) and the one-step mode's
    defaults give the bits of the decoder the modes ran before."""
    T = n_info + 6
    x = torch.from_numpy(_llrs(kind, n_info, 24, seed=n_info))
    lp = x.reshape(-1, T, 2)
    assert torch.equal(coding.viterbi_decode(x, n_info, "full"),
                       _old_decode(lp, 1)[:, :n_info])
    plan = coding._window_plan(T, coding.WINDOW_BODY, coding.WINDOW_OVERLAP)
    B, W, width = lp.shape[0], plan["W"], plan["span"]
    wl = lp[:, torch.from_numpy(plan["time_idx"])].reshape(B * W, width, 2)
    pm0 = torch.from_numpy(plan["pm0"]).expand(B, W, 64).reshape(B * W, 64)
    argmax = torch.from_numpy(plan["interior"]).expand(B, W).reshape(B * W)
    old = _old_decode(wl, 1, pm0, argmax).view(B, W, width)
    old = old[:, torch.from_numpy(plan["w_of_t"]), torch.from_numpy(plan["pos_of_t"])]
    assert torch.equal(coding.viterbi_decode(x, n_info, "windowed"), old[:, :n_info])
    assert torch.equal(viterbi.decode(wl.contiguous(), 1, pm0.contiguous(), argmax.contiguous()),
                       _old_decode(wl, 1, pm0, argmax))


def test_wrapper_refuses_other_inputs():
    lp = torch.zeros(8, 468, 2)
    for bad, k, kw in ((lp.double(), 4, {}), (lp.transpose(0, 1), 4, {}),
                       (lp[..., :1].contiguous(), 4, {}), (lp.reshape(8, 936), 4, {}),
                       (lp[:, :466].contiguous(), 4, {}), (lp, 5, {}), (lp.numpy(), 4, {}),
                       (lp, 4, {"pm0": torch.zeros(8, 32)}),
                       (lp, 4, {"pm0": torch.zeros(8, 64).t().contiguous().t()}),
                       (lp, 4, {"from_argmax": torch.zeros(8)})):
        with pytest.raises(ValueError):
            viterbi.decode(bad, k, **kw)
    with pytest.raises(ValueError, match="k in 1..4"):
        viterbi.kernel_tables(5)


def _replay(lp: np.ndarray, k: int, pm0=None, argmax=None) -> np.ndarray:
    """csrc/viterbi.cu viterbi_kernel<k> for a batch of warps, in float32:
    lane L's pattern sums (its bits fix the first LB terms' signs, a tree
    the last TB), its next states 2L and 2L + 1, the first maximum or
    first NaN, decision words of PER steps, lane 0's traceback."""
    B, T = lp.shape[:2]
    S, NJ, NQ = T // k, 1 << k, 1 << (2 * k)
    NPL = max(1, NQ // 32)
    LB = 5 if NQ >= 32 else 2 * k
    TB, PER = 2 * k - LB, 16 // k
    tabs = viterbi.kernel_tables(k)
    lane = np.arange(32)
    hi = (2 * lane) >> k
    qs = tabs["q_ns"][2 * lane[:, None] + np.arange(2)[None, :]]  # (32, 2)
    pm = np.full((B, 64), np.float32(-1e30), np.float32)
    pm[:, 0] = 0.0
    if pm0 is not None:
        pm = pm0.astype(np.float32).copy()
    words = np.zeros((B, -(-S // PER), 32), np.uint64)
    act = lane[: NQ // NPL]
    with np.errstate(over="ignore", invalid="ignore"):  # infinite and NaN LLRs
        for s in range(S):
            l = lp[:, s * k : (s + 1) * k].reshape(B, 2 * k)
            bit = lambda i: ((act >> (LB - 1 - i)) & 1).astype(bool)  # noqa: E731
            v = np.where(bit(0), -l[:, :1], l[:, :1])
            for i in range(1, LB):
                li = l[:, i : i + 1]
                v = np.where(bit(i), v - li, v + li)
            v = v[..., None]
            for i in range(TB):
                li = l[:, LB + i, None, None]
                v = np.stack([v + li, v - li], axis=-1).reshape(B, len(act), -1)
            pat = v.reshape(B, NQ)
            a = pm[:, (np.arange(NJ)[None, :] << (6 - k)) | hi[:, None]]  # (B, 32, NJ)
            q = tabs["q_j"][None, None, :] ^ qs[:, :, None]  # (32, 2, NJ)
            cand = a[:, :, None, :] + pat[:, q]  # (B, 32, 2, NJ)
            best, j = cand[..., 0], np.zeros(cand.shape[:-1], np.int64)
            for jj in range(1, NJ):
                c = cand[..., jj]
                upd = ~(c <= best) & ~np.isnan(best)
                best, j = np.where(upd, c, best), np.where(upd, jj, j)
            pm = best.reshape(B, 64).astype(np.float32)
            field = (j[..., 0] | (j[..., 1] << k)).astype(np.uint64)
            words[:, s // PER, :] |= field << np.uint64((s % PER) * 2 * k)
    bits = np.zeros((B, S * k), np.uint8)
    for b in range(B):
        state = 0
        if argmax is not None and argmax[b]:
            f = pm[b]
            nan = np.flatnonzero(np.isnan(f))
            state = int(nan[0]) if nan.size else int(np.argmax(f))
        for s in range(S - 1, -1, -1):
            bits[b, s * k : (s + 1) * k] = (state >> np.arange(k - 1, -1, -1)) & 1
            if s:
                word = int(words[b, s // PER, state >> 1])
                jj = (word >> ((s % PER) * 2 * k + (state & 1) * k)) & (NJ - 1)
                state = (state >> k) | (jj << (6 - k))
    return bits


@pytest.mark.parametrize("kind", ["dyadic", "continuous"])
@pytest.mark.parametrize("T", [468, 471, 470, 139])
def test_kernel_schedule_replay_matches_the_plain_version(T, kind):
    """The kernel's per-lane schedule, replayed, gives the plain version's
    bits (k from T as viterbi_decode picks it), with noiseless, noisy and
    all-zero rows and with NaN, infinite and huge LLRs."""
    k = next((kk for kk in (4, 3, 2) if T % kk == 0), 1)
    x = _llrs(kind, T - 6, 16, seed=T)
    if kind == "continuous":
        rng = np.random.default_rng(T)
        for row, value in zip((3, 5, 7, 9, 11), (np.nan, np.inf, -np.inf, 3e38, -3e38)):
            x[row, rng.choice(2 * T, 4, replace=False)] = value
    lp = torch.from_numpy(x.reshape(-1, T, 2))
    np.testing.assert_array_equal(_replay(lp.numpy(), k), viterbi.decode(lp, k).numpy())


def test_kernel_schedule_replay_matches_with_options():
    """The replay with initial metrics and argmax starts (the windowed
    mode's options, interior windows at uniform metrics) against the plain
    version."""
    lp = torch.from_numpy(noisy_llrs(12, 128, seed=3))
    pm0 = np.zeros((12, 64), np.float32)
    pm0[::2, 1:] = np.float32(-1e30)
    argmax = np.arange(12) % 3 != 0
    want = viterbi.decode(lp, 1, torch.from_numpy(pm0), torch.from_numpy(argmax))
    np.testing.assert_array_equal(_replay(lp.numpy(), 1, pm0, argmax), want.numpy())
