"""The detection kernels' schedule (csrc/detect.cu detect_kernel<LEAN>),
replayed in NumPy float32 on the CPU.

The replay follows the kernel CTA by CTA: each tile of TILE = TP x R
positions of a chunk stages the samples its windows reach, zero outside
[0, T), into a window with one pad word after every R samples (pad words
NaN here, so a read of one poisons the result); thread g reads its R
positions' samples through the kernel's own pointer steps: the
cross-correlation as the register-sliding FIR (2R samples in registers, a
tap at a time, each position's sum over the taps in order, taps zero past
2K), the sums of p's and e's terms over each block of R window entries,
p and e of the R windows as the terms common to all R (mostly those block
sums) plus each window's head and tail, |ac| into a NaN-filled buffer with the H halo
groups before the tile, the CP integration the same way from that buffer,
then every trace staged by thread and stored by the kernel's coalesced
mapping into outputs pre-filled with NaN, each position counted so that it
is written exactly once. The traces must agree with the plain versions
(``detect._detect_front_plain`` / ``_detect_lean_plain``) within the
limits tests/test_torch_gpu.py holds the kernels to (atol 3e-5, rtol 3e-3), with
the detected starts equal. Inputs: 37 friendly chunks of
``entry.service_stream`` at trims 0 and 5 and ``entry._dynamic_range_chunks``
(power steps of 60 dB, an all-zero chunk, a burst after silence), at the
canonical config and k32m5; and configs small enough (K < R - 1, cp + 1 <
R - 1, and both at R - 1) to take the kernel's direct-sum branches.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import _dynamic_range_chunks, service_stream
from gfdm_tpu_torch.kernels import detect

torch.set_num_threads(1)

# csrc/detect.cu DETECT_TP, DETECT_R (the library's gfdm_detect_tile;
# tests/test_torch_gpu.py holds them equal)
TP, R = 256, 8
TILE = TP * R
F32 = np.float32
TRACE_TOL = dict(atol=3e-5, rtol=3e-3)
CONFIGS = {
    "canonical": GfdmConfig(),
    "k32m5": GfdmConfig(subcarriers=32, active_subcarriers=24, timeslots=5, cp_len=8,
                        cs_len=4),
    # K < R - 1 and cp + 1 < R - 1: every window summed directly
    "k4_direct": GfdmConfig(subcarriers=4, active_subcarriers=2, timeslots=5, cp_len=2,
                            cs_len=1),
    # K = R - 1 and cp + 1 = R - 1: no common term, heads and tails only
    "k7_edges": GfdmConfig(subcarriers=7, active_subcarriers=4, timeslots=5, cp_len=6,
                           cs_len=2),
}
N_CHUNKS = 37
CHUNK = 2048


def pad(i):
    """Shared-memory word of window entry i (csrc/detect.cu detect_pad)."""
    return i + i // R


class Window:
    """A tile's staged samples: float2 words at pad(i), NaN pad words."""

    def __init__(self, chunks, q0: int, span: int):
        B, _, T = chunks.shape
        self.re = np.full((B, pad(span)), np.nan, F32)
        self.im = np.full((B, pad(span)), np.nan, F32)
        i = np.arange(span)
        q = q0 + i
        inside = (q >= 0) & (q < T)
        qc = np.clip(q, 0, T - 1)
        self.re[:, pad(i)] = np.where(inside, chunks[:, 0, qc], F32(0))
        self.im[:, pad(i)] = np.where(inside, chunks[:, 1, qc], F32(0))

    def at(self, words):
        """(B, G) samples at absolute window words (G,)."""
        return self.re[:, words], self.im[:, words]


def _cmac(acc, s, x):
    """acc += s x as the kernel's four FMAs (separately rounded here)."""
    (ar, ai), (sr, si), (xr, xi) = acc, s, x
    ar = ar + sr * xr
    ar = ar + (-si) * xi
    ai = ai + sr * xi
    ai = ai + si * xr
    return ar, ai


def _cconj_mac(acc, a, b):
    """acc += conj(a) b."""
    (pr, pi), (ar, ai), (br, bi) = acc, a, b
    pr = pr + ar * br
    pr = pr + ai * bi
    pi = pi + ar * bi
    pi = pi + (-ai) * br
    return pr, pi


def _norm_mac(a, acc):
    return (acc + a[0] * a[0]) + a[1] * a[1]


def _xcorr(win, o, taps, n_taps, inv_w2):
    """detect_xcorr at window words o (G,): (B, G, R) |cc| / 2K."""
    zero = np.zeros(win.re.shape[:1] + o.shape, F32)
    acc = [(zero, zero) for _ in range(R)]
    lo = [win.at(o + r) for r in range(R)]

    def block(acc, lo, hi, j):
        for u in range(R):
            x = (taps[j + u, 0], taps[j + u, 1])
            acc = [_cmac(acc[r], lo[r + u] if r + u < R else hi[r + u - R], x)
                   for r in range(R)]
        return acc

    for j in range(0, n_taps, 2 * R):
        o = o + R + 1
        hi = [win.at(o + u) for u in range(R)]
        acc = block(acc, lo, hi, j)
        o = o + R + 1
        lo = [win.at(o + u) for u in range(R)]
        acc = block(acc, hi, lo, j + R)
    return np.stack([np.sqrt((ar * ar + ai * ai) * inv_w2) for ar, ai in acc], axis=-1)


def _block_sums(win, K, n_energy, n_products):
    """detect_block_sums: (be (B, n_energy), bp re and im (B, n_products)),
    block k's R terms summed in order, entries kR .. kR + R - 1."""
    zero = np.zeros(win.re.shape[:1], F32)
    be = np.stack([_norm_mac_chain([win.at(k * (R + 1) + i) for i in range(R)], zero)
                   for k in range(n_energy)], axis=1)
    bp = []
    for k in range(n_products):
        acc = (zero, zero)
        for i in range(R):
            acc = _cconj_mac(acc, win.at(k * (R + 1) + i), win.at(k * (R + 1) + pad(i + K)))
        bp.append(acc)
    return be, np.stack([v[0] for v in bp], axis=1), np.stack([v[1] for v in bp], axis=1)


def _norm_mac_chain(terms, acc):
    for a in terms:
        acc = _norm_mac(a, acc)
    return acc


def _pe(win, sums, o, blk, K):
    """detect_pe at window words o (G,), block sums from blocks blk (G,):
    p (re, im) and e, each (B, G, R)."""
    def s(n):
        return win.at(o + pad(n))

    zero = np.zeros(win.re.shape[:1] + o.shape, F32)
    p, e = [None] * R, [None] * R
    if K >= R - 1:
        be, bpr, bpi = sums
        pc = (zero, zero)
        if K >= R:
            pc = _cconj_mac(pc, s(R - 1), s(R - 1 + K))
            for k in range(1, K // R):
                pc = (pc[0] + bpr[:, blk + k], pc[1] + bpi[:, blk + k])
            for n in range(K // R * R, K):
                pc = _cconj_mac(pc, s(n), s(n + K))
        ec = _norm_mac(s(R - 1), zero)
        for k in range(1, 2 * K // R):
            ec = ec + be[:, blk + k]
        for n in range(2 * K // R * R, 2 * K):
            ec = _norm_mac(s(n), ec)
        hp, he = (zero, zero), zero
        p[R - 1], e[R - 1] = pc, ec
        for r in range(R - 2, -1, -1):
            a = s(r)
            hp = _cconj_mac(hp, a, s(K + r))
            he = _norm_mac(a, he)
            p[r] = (pc[0] + hp[0], pc[1] + hp[1])
            e[r] = ec + he
        tp, te = (zero, zero), zero
        for r in range(1, R):
            b = s(2 * K + r - 1)
            tp = _cconj_mac(tp, s(K + r - 1), b)
            te = _norm_mac(b, te)
            p[r] = (p[r][0] + tp[0], p[r][1] + tp[1])
            e[r] = e[r] + te
    else:
        for r in range(R):
            pr, er = (zero, zero), zero
            for j in range(K):
                a, b = s(r + j), s(r + j + K)
                pr = _cconj_mac(pr, a, b)
                er = _norm_mac(b, _norm_mac(a, er))
            p[r], e[r] = pr, er
    stack = lambda v: np.stack(v, axis=-1)  # noqa: E731
    return stack([v[0] for v in p]), stack([v[1] for v in p]), stack(e)


def _mag(win, sums, mag, hits, L, q, n_ac, K, lean):
    """detect_mag for groups at window entries L (G,), positions q (G,):
    writes |ac| into mag; returns (acr, aci, e) of the front kernel."""
    pr, pi, e = _pe(win, sums, pad(L), L // R, K)
    ev = np.maximum(e, F32(1e-30))
    g = F32(2) / ev
    acr, aci = pr * g, pi * g
    m = np.sqrt(pr * pr + pi * pi) * g if lean else np.sqrt(acr * acr + aci * aci)
    t = q[:, None] + np.arange(R)
    m = np.where((t >= 0) & (t < n_ac), m, F32(0))
    words = pad(L[:, None] + np.arange(R))
    mag[:, words] = m
    np.add.at(hits, words, 1)
    return acr, aci, ev


def _ic(mag, L, cp):
    """detect_ic for groups at window entries L (G,): (B, G, R)."""
    def m(n):
        return mag[:, pad(n)]

    u0, W = L - cp, cp + 1
    ic = [None] * R
    if W >= R - 1:
        c = np.zeros(mag.shape[:1] + L.shape, F32)
        for n in range(R - 1, W):
            c = c + m(u0 + n)
        h = np.zeros_like(c)
        ic[R - 1] = c
        for r in range(R - 2, -1, -1):
            h = h + m(u0 + r)
            ic[r] = c + h
        t = np.zeros_like(c)
        for r in range(1, R):
            t = t + m(u0 + W + r - 1)
            ic[r] = ic[r] + t
    else:
        for r in range(R):
            acc = np.zeros(mag.shape[:1] + L.shape, F32)
            for j in range(cp + 1):
                acc = acc + m(L + r - j)
            ic[r] = acc
    return np.stack(ic, axis=-1) / F32(cp + 1)


def replay(cfg: GfdmConfig, chunks: np.ndarray, n_valid: int, lean: bool) -> dict:
    """The kernel's outputs for (B, 2, T) float32 chunks: gated, ic and
    (front) ac, energy, each position written exactly once."""
    B, _, T = chunks.shape
    K, cp = cfg.subcarriers, cfg.cp_len
    n_ac = T - 2 * K
    n_out = n_valid if lean else n_ac
    H = -(-cp // R)
    n_taps = -(-2 * K // (2 * R)) * (2 * R)
    span = (TP + H) * R + n_taps
    taps = detect._kernel_taps_np(cfg)
    assert taps.shape[0] >= n_taps and not taps[2 * K :].any()
    inv_w2 = F32(1) / (F32(2 * K) * F32(2 * K))
    outs = {"gated": np.full((B, n_valid), np.nan, F32), "ic": np.full((B, n_out), np.nan, F32)}
    if not lean:
        outs["ac"] = np.full((B, 2, n_ac), np.nan, F32)
        outs["energy"] = np.full((B, n_ac), np.nan, F32)
    writes = {key: np.zeros(v.shape[-1] * (2 if key == "ac" else 1), int)
              for key, v in outs.items()}
    S = TP * (R + 1)
    tid = np.arange(TP)
    for t0 in range(0, n_out, TILE):
        q0 = t0 - H * R
        idle = TP - min(TP, -(-(n_out - t0) // R))  # groups with no position to write
        win = Window(chunks, q0, span - idle * R)
        sums = None
        if K >= R - 1:
            sums = _block_sums(win, K, TP + H + 2 * K // R - 1 - idle,
                               TP + H + K // R - 1 - idle)
        mag = np.full((B, (TP + H) * (R + 1)), np.nan, F32)
        hits = np.zeros(mag.shape[1], int)
        L, base = (H + tid) * R, t0 + tid * R
        # 1. |cc| / 2K where gated is written, then |ac|; the halo's |ac|
        ccm = np.zeros((B, TP, R), F32)
        xc = base < n_valid
        ccm[:, xc] = _xcorr(win, pad(L[xc]), taps, n_taps, inv_w2)
        mg = base < n_out
        acr, aci, en = (np.zeros((B, TP, R), F32) for _ in range(3))
        acr[:, mg], aci[:, mg], en[:, mg] = _mag(win, sums, mag, hits, L[mg], base[mg], n_ac,
                                                 K, lean)
        if H:
            _mag(win, sums, mag, hits, np.arange(H) * R, q0 + np.arange(H) * R, n_ac, K, lean)
        assert hits.max() <= 1
        # 2. the CP integration; every trace staged by thread
        stage = np.full((B, 5, S), np.nan, F32)
        icv = _ic(mag, L[mg], cp)
        words = pad(L[mg][:, None] - H * R + np.arange(R))  # g (R + 1) + r
        for k, v in enumerate((ccm[:, mg] * icv, icv, acr[:, mg], aci[:, mg], en[:, mg])):
            if k < 2 or not lean:
                stage[:, k, words] = v
        # 3. the coalesced stores: position t0 + i from stage entry pad(i)
        for k in range(R):
            i = tid + k * TP
            t = t0 + i
            sel = t < n_out
            t, si = t[sel], pad(i[sel])
            v = t < n_valid
            outs["gated"][:, t[v]] = stage[:, 0, si[v]]
            np.add.at(writes["gated"], t[v], 1)
            outs["ic"][:, t] = stage[:, 1, si]
            np.add.at(writes["ic"], t, 1)
            if not lean:
                outs["ac"][:, 0, t] = stage[:, 2, si]
                outs["ac"][:, 1, t] = stage[:, 3, si]
                np.add.at(writes["ac"], np.concatenate([t, n_ac + t]), 1)
                outs["energy"][:, t] = stage[:, 4, si]
                np.add.at(writes["energy"], t, 1)
    for key, w in writes.items():
        assert (w == 1).all(), f"{key}: positions written {np.unique(w)} times"
        assert np.isfinite(outs[key]).all(), key
    return outs


def _inputs(cfg, kind):
    if kind == "dynamic":
        return _dynamic_range_chunks(cfg, CHUNK, np.random.default_rng(11))
    trim = int(kind.removeprefix("trim"))
    stream, _counts, _payload = service_stream(cfg, N_CHUNKS, CHUNK, 20.0, False,
                                               np.random.default_rng(7))
    return np.ascontiguousarray(stream[..., : stream.shape[-1] - trim])


def _assert_close(name, got, ref):
    excess = np.abs(got - ref) - TRACE_TOL["rtol"] * np.abs(ref)
    assert excess.max() <= TRACE_TOL["atol"], (name, float(excess.max()))


@pytest.mark.parametrize("lean", [False, True], ids=["front", "lean"])
@pytest.mark.parametrize("kind", ["trim0", "trim5", "dynamic"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replayed_schedule_matches_plain(name, kind, lean):
    cfg = CONFIGS[name]
    chunks = _inputs(cfg, kind)
    n_valid = min(chunks.shape[-1] - 2 * cfg.subcarriers, CHUNK)
    got = replay(cfg, chunks, n_valid, lean)
    flat = torch.from_numpy(chunks)
    if lean:
        ref = dict(zip(("gated", "ic"), detect._detect_lean_plain(cfg, flat, n_valid)))
    else:
        ref = dict(zip(("gated", "ac", "energy", "ic"),
                       detect._detect_front_plain(cfg, flat, n_valid)))
    assert set(got) == set(ref)
    for key, r in ref.items():
        assert got[key].shape == tuple(r.shape), key
        _assert_close(key, got[key], r.numpy())
    starts = np.argmax(got["gated"], axis=-1)
    np.testing.assert_array_equal(starts, torch.argmax(ref["gated"], dim=-1).numpy())
    if lean:
        det = detect._lean_epilogue(cfg, flat, torch.from_numpy(got["gated"]),
                                    torch.from_numpy(got["ic"]))
        det_ref = detect._lean_epilogue(cfg, flat, ref["gated"], ref["ic"])
        assert torch.equal(det["start"], det_ref["start"])


@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_tile_covers_the_service_shapes(name):
    """A chunk of the service's 2,048 owned samples is one lean tile, and
    the front kernel's n_ac positions two; the staged window spans the
    tile, its halo groups and the FIR's last block."""
    cfg = CONFIGS[name]
    K, cp = cfg.subcarriers, cfg.cp_len
    T = CHUNK + cfg.frame_len + cfg.cp_len
    assert -(-CHUNK // TILE) == 1 and -(-(T - 2 * K) // TILE) == 2
    H, n_taps = -(-cp // R), -(-2 * K // (2 * R)) * (2 * R)
    # the last thread's last FIR load and its last tail sample lie in the window
    L_last = (TP + H - 1) * R
    assert L_last + n_taps + R - 1 < (TP + H) * R + n_taps
    assert L_last + 2 * K + R - 2 < (TP + H) * R + n_taps

