"""Plain emulation of the superseded receivers' stages (csrc/rx.cu), for
tests/test_torch_rx_variant_tiles.py. Imports torch only.

Each launch of a receiver's plan (``fused._variant_plan``) is replayed with
the kernels' index arithmetic and rounding, at float32:

- ``load_window``: the A operand read in place from the flat input rows at
  ``offset + r ld + q im + k`` (the kernel's ``Win``), zero-filled past the
  batch to the 64-burst tile and past the width to the 16-deep k-tile, as
  the copies' src-size fills them;
- ``load_stack``: the Gauss stack's three planes, zero-filled past the
  depth and past N to the 64-column tile;
- ``gauss_tiles``: p1 = xr Wr, p2 = xi Wi, p3 = (xr + xi)(Wr + Wi), each sum
  one FMA chain over k in order from zero (``fma``), combined as (p1 - p2,
  (p3 - p1) - p2);
- ``zf``: the DFT stage's epilogue, one float32 operation at a time;
- ``cancel_pass``: the IC pass of one burst a CTA, its neighbours at k - 1
  and k + 1 with the wrap written out, the circulant's timeslot (m - j) mod
  M likewise;
- ``hybrid_pass``: the fold, the M-point IDFTs as one FMA chain over the
  realified operator's 2M rows, then ``cancel_pass``.
"""
import torch

from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops import planar_fast

BM, BN, BK = 64, 64, 16  # csrc/rx.cu's tile: bursts, output columns, k-depth


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def windows(cfg, key: str) -> dict:
    """gfdm_rx_variant's A windows (offset, ld, im, width) in floats: "p"
    the preamble and "f" the payload of each burst row, or the frames
    (B, 2N) for rx_core / rx_ic; "y" the DFT stage's output."""
    n, L = cfg.block_len, cfg.frame_len
    out = {"y": (0, 2 * n, n, n)}
    if key in ("rx_core", "rx_ic"):
        out["f"] = (0, 2 * n, n, n)
    else:
        out["p"] = (cfg.cp_len, 2 * L, L, 2 * cfg.subcarriers)
        out["f"] = (cfg.preamble_len + cfg.cp_len, 2 * L, L, n)
    return out


def load_window(flat: torch.Tensor, batch: int, offset: int, ld: int, im: int,
                width: int) -> torch.Tensor:
    """(rows, 2, depth) A operand of ``batch`` rows read from the flat
    storage ``flat``; rows and depth padded to the tile with zeros."""
    a = torch.zeros(_up(batch, BM), 2, _up(width, BK), dtype=torch.float32)
    r = torch.arange(batch)[:, None, None]
    q = torch.arange(2)[None, :, None]
    k = torch.arange(width)[None, None, :]
    a[:batch, :, :width] = flat[offset + r * ld + q * im + k]
    return a


def load_stack(g: torch.Tensor, n_in: int, n_out: int) -> torch.Tensor:
    """(3, depth, cols) planes of the Gauss stack (3 n_in, n_out), zero past
    n_in and n_out to the tile."""
    w = torch.zeros(3, _up(n_in, BK), _up(n_out, BN), dtype=torch.float32)
    w[:, :n_in, :n_out] = g.reshape(3, n_in, n_out)
    return w


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c as an FMA: the float64 product of two float32 values is
    exact; its sum, rounded to float64 and then to float32, is the FMA's
    one rounding but for rare double-rounding ties."""
    return (a.double() * b.double() + c.double()).float()


def gauss_tiles(a: torch.Tensor, w: torch.Tensor):
    """The tiles' three products over k in order, combined: (yr, yi), both
    (rows, cols) including the padding."""
    rows, cols = a.shape[0], w.shape[2]
    p1, p2, p3 = (torch.zeros(rows, cols) for _ in range(3))
    for k in range(a.shape[2]):
        xr, xi = a[:, 0, k : k + 1], a[:, 1, k : k + 1]
        s = xr + xi
        p1 = fma(xr, w[0, k], p1)
        p2 = fma(xi, w[1, k], p2)
        p3 = fma(s, w[2, k], p3)
    return p1 - p2, (p3 - p1) - p2


def zf(xr, xi, hr, hi):
    """The DFT stage's epilogue: x / h with |h|^2 clamped at 1e-30."""
    den = torch.clamp(hr * hr + hi * hi, min=1e-30)
    return (xr * hr + xi * hi) / den, (xi * hr - xr * hi) / den


def gemm_stage(flat, batch: int, win: tuple, g, n_in: int, n: int, chan=None):
    """One Gauss GEMM launch: (batch, 2N) rows; the epilogue keeps rows < B
    and columns < N and, given ``chan`` (batch, 2N), divides by it."""
    yr, yi = gauss_tiles(load_window(flat, batch, *win), load_stack(g, n_in, n))
    yr, yi = yr[:batch, :n], yi[:batch, :n]
    if chan is not None:
        yr, yi = zf(yr, yi, chan[:, :n], chan[:, n:])
    return torch.cat([yr, yi], dim=1)


def _decide(u, act):
    return torch.where(u >= 0, 1.0, -1.0) * act


def neighbours(K: int, M: int):
    """(lo, hi): the row offsets of subcarriers k - 1 and k + 1 (mod K) of
    each column k M + m, as the IC pass computes them."""
    k = torch.arange(K * M) // M
    lo = torch.where(k == 0, K - 1, k - 1) * M
    hi = torch.where(k == K - 1, 0, k + 1) * M
    return lo, hi


def cancel_pass(cfg, d0: torch.Tensor, taps: torch.Tensor, act: torch.Tensor,
                iterations: int) -> torch.Tensor:
    """The IC pass on D0 rows (B, 2N): QPSK decisions on the active symbols,
    the interference of the k +- 1 neighbours through the M taps, D = D0 -
    interference; the first iteration decides on D0."""
    n, M, K = cfg.block_len, cfg.timeslots, cfg.subcarriers
    if iterations == 0:
        return d0
    lo, hi = neighbours(K, M)
    m = torch.arange(n) % M
    act2 = torch.cat([act, act])
    q = _decide(d0, act2)
    for it in range(iterations):
        ir = torch.zeros(d0.shape[0], n)
        ii = torch.zeros(d0.shape[0], n)
        for j in range(M):
            mm = torch.where(m - j < 0, m - j + M, m - j)
            sr = q[:, lo + mm] + q[:, hi + mm]
            si = q[:, n + lo + mm] + q[:, n + hi + mm]
            tr, ti = taps[0, j], taps[1, j]
            ir = (ir + tr * sr) - ti * si
            ii = (ii + tr * si) + ti * sr
        d = torch.cat([d0[:, :n] - ir, d0[:, n:] - ii], dim=1)
        if it + 1 < iterations:
            q = _decide(d, act2)
    return d


def hybrid_pass(cfg, y: torch.Tensor, amp: float, iterations: int) -> torch.Tensor:
    """The hybrid's per-burst pass on Y rows (B, 2N): the L-tap fold, the
    per-subcarrier M-point IDFTs, then cancel_pass."""
    n, M, K, L = cfg.block_len, cfg.timeslots, cfg.subcarriers, cfg.overlap
    fc = planar_fast.fast_consts(cfg, "float32", y.device)
    parts, ifm = fc["rx_parts"], fc["iFM_W"]
    col = torch.arange(n)
    k, m = col // M, col % M
    sr = torch.zeros(y.shape[0], n)
    si = torch.zeros(y.shape[0], n)
    for l in range(L):
        kk = k + l - L // 2
        kk = torch.where(kk < 0, kk + K, torch.where(kk >= K, kk - K, kk))
        xr, xi = y[:, kk * M + m], y[:, n + kk * M + m]
        pr, pi = parts[(l + L // 2) % L, 0, m], parts[(l + L // 2) % L, 1, m]
        sr = sr + (xr * pr - xi * pi)
        si = si + (xr * pi + xi * pr)
    s = torch.cat([sr, si], dim=1)
    dr = torch.zeros(y.shape[0], n)
    di = torch.zeros(y.shape[0], n)
    for t in range(2 * M):
        v = s[:, k * M + t] if t < M else s[:, n + k * M + t - M]
        dr = fma(v, ifm[t, m], dr)
        di = fma(v, ifm[t, M + m], di)
    d0 = torch.cat([dr, di], dim=1)
    k_consts = fused._kernel_consts(cfg, y.device)
    return cancel_pass(cfg, d0, fused._ic_operand(cfg, "conv", y.device, amp),
                       k_consts["act"], iterations)


def replay(key: str, cfg, x: torch.Tensor, chan, iterations: int, amp: float,
           stages: dict | None = None):
    """The receiver ``key`` launch by launch on (B, 2 .) rows ``x`` (frames
    with ``chan`` for rx_core / rx_ic, else bursts): (chan, symbols), both
    (B, 2N). ``stages``: a dict that takes each launch's output by stage
    name."""
    k = fused._kernel_consts(cfg, x.device)
    n, half, batch = cfg.block_len, 2 * cfg.subcarriers, x.shape[0]
    flat = x.reshape(-1)
    win = windows(cfg, key)
    out = {} if stages is None else stages
    for name, _stage, _it in fused._variant_plan(key, iterations):
        if name == "estimate":
            chan = out[name] = gemm_stage(flat, batch, win["p"], k["E_G"], half, n)
        elif name == "dft_zf":
            out[name] = gemm_stage(flat, batch, win["f"], k["F_G"], n, n, chan)
        elif name == "demod":
            out[name] = gemm_stage(out["dft_zf"].reshape(-1), batch, win["y"], k["Bfd_G"], n, n)
        elif name == "cancel":
            out[name] = cancel_pass(cfg, out["demod"],
                                    fused._ic_operand(cfg, "conv", x.device, amp), k["act"],
                                    iterations)
        else:
            out[name] = hybrid_pass(cfg, out["dft_zf"], amp, iterations)
    return chan, out[name]
