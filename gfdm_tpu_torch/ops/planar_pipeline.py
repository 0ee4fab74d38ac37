"""Complex-free (planar) GFDM link as plain torch ops.

The twin of ``gfdm_tpu.ops.planar_pipeline`` (the JAX package's XLA path):
the same math on real float32 tensors in the planar layout of
:mod:`gfdm_tpu_torch.ops.planar`. Every complex matmul is one real matmul
against a realified operator; divides, decisions and angles are explicit
real arithmetic. The hand-written CUDA kernels (:mod:`gfdm_tpu_torch.kernels`)
are held against this module's results in the tests.

Operators are built once per (config, dtype) in NumPy float64 from the
golden model and uploaded once per device (:func:`prepare`). The kernels'
Gauss stacks (:func:`_np_gauss_stacks`) are built here too but uploaded
only by the kernels' own cache. ``method="fast"`` runs the factorized
stages of :mod:`.planar_fast` and loads only the small-operator set
(:func:`_np_mats_fast`): no O(N^2) matrix, so K >= 1024 configs stay
practical.

The sync section is the service's detection and extraction: the dense,
two-stage and top-k detectors over halo-extended chunks, barrel
extraction and the two-stage CFO correction. ``DETECT_IMPL`` picks the
detection front end; "pallas" and "pallas2" reach the CUDA detection
kernels of :mod:`gfdm_tpu_torch.kernels.detect`.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import resolve_device
from ..ref.demodulation import ic_filter_taps as _ic_taps_ref
from . import operators
from .planar import (
    bf16_operator, gauss_stack, host_dtype, pabs2, pconj, pdiv, pmatmul, pmul,
    real_operator, to_planar,
)

__all__ = [
    "prepare",
    "transmit_planar",
    "receive_bursts_planar",
    "link_step_planar",
    "qpsk_constellation",
    "DETECT_IMPL",
    "detect_bursts_planar",
    "detect_bursts_topk_planar",
    "extract_bursts_planar",
    "refine_cfo_planar",
]

qpsk_constellation = np.array([1 + 1j, 1 - 1j, -1 + 1j, -1 - 1j]) / np.sqrt(2.0)


# ---------------------------------------------------------------------------
# operator matrices: NumPy once per config, tensors once per device
# ---------------------------------------------------------------------------
def _operator_tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """An operator of ``dtype_name`` as a tensor on ``device``."""
    if dtype_name == "bfloat16":
        return bf16_operator(a).to(device)
    return _to_tensor(a, device)


@lru_cache(maxsize=16)
def _np_mats_fast(cfg: GfdmConfig, dtype_name: str):
    """Small-operator set for method='fast': no O(N^2) matrices anywhere
    (the factorized stages carry only K- and M-point matrices,
    :mod:`.planar_fast`)."""
    dt = host_dtype(dtype_name)
    return {
        "C_W": real_operator(operators._interference_matrix(cfg).T, dt),
        "CNRI_T": np.ascontiguousarray(
            operators.cnr_interpolation_operator(cfg).T.astype(dt)
        ),
    }


@lru_cache(maxsize=16)
def _tx_map_idx(cfg: GfdmConfig) -> np.ndarray:
    """(N,) direct index form of the resource-mapper scatter for
    method='fast': frame position -> payload index, n_data (a zero
    sentinel) off the mapped positions."""
    n_data = cfg.n_data_symbols
    map_idx = np.full(cfg.block_len, n_data, dtype=np.int32)
    smap = cfg.subcarrier_map
    M = cfg.timeslots
    for j in range(n_data):
        if cfg.per_timeslot:
            tidx, aidx = divmod(j, smap.size)
        else:
            aidx, tidx = divmod(j, M)
        map_idx[M * smap[aidx] + tidx] = j
    return map_idx


@lru_cache(maxsize=16)
def _np_mats(cfg: GfdmConfig, dtype_name: str):
    dt = host_dtype(dtype_name)
    K = cfg.subcarriers
    return {
        # full per-shift Tx operators with CP gather + window folded in:
        # one matmul emits the windowed framed burst directly
        "TF_W": np.stack(
            [
                real_operator(operators.tx_frame_operator(cfg, s).T, dt)
                for s in cfg.cyclic_shifts
            ]
        ),
        "E_W": real_operator(operators.channel_estimation_operator(cfg).T, dt),
        # real (n_active, N) CNR->per-bin interpolation for per-bin MMSE
        "CNRI_T": np.ascontiguousarray(
            operators.cnr_interpolation_operator(cfg).T.astype(dt)
        ),
        "F_W": real_operator(operators.dft_matrix(cfg.block_len).T, dt),
        "Bfd_W": real_operator(operators.demodulation_fd_operator(cfg).T, dt),
        "F2_W": real_operator(operators.dft_matrix(2 * K).T, dt),
        # interference operator: time-domain form of fft -> x ic_taps -> ifft
        "C_W": real_operator(operators._interference_matrix(cfg).T, dt),
    }


def _gauss_operators(cfg: GfdmConfig) -> dict:
    """The complex (n_in, n_out) operators of the fused kernels' Gauss
    stacks, row convention y = x @ W, in float64."""
    return {
        "T_G": operators.tx_core_operator(cfg).T,
        "E_G": operators.channel_estimation_operator(cfg).T,
        "F_G": operators.dft_matrix(cfg.block_len).T,
        "Bfd_G": operators.demodulation_fd_operator(cfg).T,
        "F2_G": operators.dft_matrix(2 * cfg.subcarriers).T,
    }


@lru_cache(maxsize=16)
def _np_gauss_stacks(cfg: GfdmConfig, dtype_name: str):
    """Gauss 3-matmul stacks for the fused kernels (kernels/fused.py)."""
    dt = np.dtype(dtype_name)
    return {name: gauss_stack(W, dt) for name, W in _gauss_operators(cfg).items()}


@lru_cache(maxsize=16)
def _small_consts(cfg: GfdmConfig, dtype_name: str):
    # windows, preambles and taps stay float32 in the bfloat16 mode: only
    # the big operators are rounded
    dt = np.float32 if dtype_name == "bfloat16" else np.dtype(dtype_name)
    K = cfg.subcarriers
    c = {
        "cp_idx": np.stack([operators.cp_indices(cfg, s) for s in cfg.cyclic_shifts]),
        "win": operators.cp_window(cfg).astype(dt),
        "preambles": to_planar(cfg.full_preambles, dtype=dt),
        "ic_taps": to_planar(_ic_taps_ref(cfg.rx_filter_taps, cfg.timeslots, cfg.overlap), dt),
        "demap_idx": operators.demap_indices(cfg),
    }
    active = np.zeros(K, dtype=bool)
    active[cfg.subcarrier_map] = True
    c["active"] = active
    half = cfg.active_subcarriers // 2
    offset = 1 if cfg.dc_free else 0
    hi = 2 * (np.arange(half) + offset)
    unused_half = (K - cfg.active_subcarriers) // 2
    lo = 2 * (np.arange(half) + unused_half + K // 2)
    c["sig_idx"] = np.concatenate((hi, lo))
    c["noise_idx"] = np.concatenate((hi + 1, lo + 1))
    return c


_DEVICE_MATS_CACHE: dict = {}


def _device_mats(cfg: GfdmConfig, dtype_name: str = "float32", device="cpu",
                 method: str = "dense"):
    """The planar path's operators and small constants as tensors on
    ``device``, built once per (config, dtype, device, method). Index arrays
    become int32 tensors; with ``dtype_name="bfloat16"`` the operators are
    bf16 and the small constants float32. method="fast" loads the
    small-operator set (:func:`_np_mats_fast`, plus the Tx map index
    ``map_idx``) and the factorized stages' constants
    (:func:`.planar_fast.fast_consts`)."""
    if method not in ("dense", "fast"):
        raise ValueError(f"unknown method {method!r}")
    device = torch.device(device)
    key = (cfg, dtype_name, str(device), method)
    hit = _DEVICE_MATS_CACHE.get(key)
    if hit is not None:
        return hit
    if method == "fast":
        from . import planar_fast

        planar_fast.fast_consts(cfg, dtype_name, device)
        ops, arrays = _np_mats_fast(cfg, dtype_name), {"map_idx": _tx_map_idx(cfg)}
    else:
        ops, arrays = _np_mats(cfg, dtype_name), {}
    arrays = {**arrays, **_small_consts(cfg, dtype_name)}
    mats = {name: _operator_tensor(a, dtype_name, device) for name, a in ops.items()}
    mats.update({name: _to_tensor(a, device) for name, a in arrays.items()})
    _DEVICE_MATS_CACHE[key] = mats
    return mats


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """NumPy constant -> tensor on ``device``; integer arrays become int32."""
    a = np.ascontiguousarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


def prepare(cfg: GfdmConfig, dtype_name: str = "float32", device=None, *,
            method: str = "dense") -> None:
    """Eagerly build and upload all operators of ``method`` for ``device``
    (the card unless ``device="cpu"``)."""
    _device_mats(cfg, dtype_name, resolve_device(device, "prepare"), method)


def _dtype_name(x: torch.Tensor) -> str:
    return str(x.dtype).removeprefix("torch.")


def _ops_dtype(x: torch.Tensor, dtype_name: str | None) -> str:
    """The operators' dtype: ``dtype_name``, or by default that of ``x``."""
    return _dtype_name(x) if dtype_name is None else dtype_name


def _mats_for(cfg: GfdmConfig, x: torch.Tensor, method: str = "dense",
              dtype_name: str | None = None) -> dict:
    """The operator cache of ``method`` on the device of ``x``, in
    ``dtype_name`` (default: the dtype of ``x``)."""
    return _device_mats(cfg, _ops_dtype(x, dtype_name), x.device, method)


def _check_planar(x: torch.Tensor, n: int, fn: str, what: str) -> None:
    if x.ndim < 2 or x.shape[-2] != 2 or x.shape[-1] != n:
        raise ValueError(
            f"{fn}: expected a planar (..., 2, {n}) tensor ({what}), "
            f"got shape {tuple(x.shape)}"
        )


# ---------------------------------------------------------------------------
# Tx
# ---------------------------------------------------------------------------
def transmit_planar(cfg: GfdmConfig, data: torch.Tensor,
                    method: str = "dense", dtype_name: str | None = None) -> torch.Tensor:
    """(..., 2, n_data) planar payload -> (..., n_shifts, 2, frame_len).

    Computes in the payload's dtype on the payload's device. method="fast"
    modulates via the factorized per-subcarrier FFT pipeline.
    dtype_name="bfloat16" takes bf16 operators: each product rounds its
    activation to bf16 and sums in float32 (the JAX package's bf16 mode).
    """
    _check_planar(data, cfg.n_data_symbols, "transmit_planar",
                  "timeslots*active_subcarriers")
    if method == "fast":
        return _transmit_fast(cfg, data, dtype_name)
    mats = _mats_for(cfg, data, dtype_name=dtype_name)
    TF_W = mats["TF_W"]  # (n_shifts, 2*n_data, 2*window_len)
    flat = data.reshape(data.shape[:-2] + (2 * data.shape[-1],))
    if TF_W.dtype == torch.bfloat16:
        framed = torch.einsum("...i,sij->...sj", flat.to(torch.bfloat16).float(),
                              TF_W.float()).to(data.dtype)
    else:
        framed = torch.einsum("...i,sij->...sj", flat, TF_W)
    framed = framed.reshape(framed.shape[:-1] + (2, cfg.window_len))
    pre = mats["preambles"].expand(framed.shape[:-2] + mats["preambles"].shape[-2:])
    return torch.cat([pre, framed], dim=-1)


def _transmit_fast(cfg: GfdmConfig, data: torch.Tensor,
                   dtype_name: str | None = None) -> torch.Tensor:
    """method="fast" Tx: index-form resource map, factorized modulator,
    CP gather and window for every shift, preambles prepended."""
    from . import planar_fast

    mats = _mats_for(cfg, data, "fast", dtype_name)
    fc = planar_fast.fast_consts(cfg, _ops_dtype(data, dtype_name), data.device)
    zero = torch.zeros(data.shape[:-1] + (1,), dtype=data.dtype, device=data.device)
    grid = torch.cat([data, zero], dim=-1)[..., mats["map_idx"]]
    core = planar_fast.modulate_core_fast(cfg, grid, fc)
    framed = core[..., mats["cp_idx"]] * mats["win"]  # (..., 2, n_shifts, W)
    framed = torch.movedim(framed, -2, -3)  # (..., n_shifts, 2, W)
    pre = mats["preambles"].expand(framed.shape[:-2] + mats["preambles"].shape[-2:])
    return torch.cat([pre, framed], dim=-1)


# ---------------------------------------------------------------------------
# Rx (channel estimation + SNR + equalizer + IC + demap)
# ---------------------------------------------------------------------------
def _is_qpsk(points: np.ndarray) -> bool:
    if points.size != 4:
        return False
    a = np.abs(points[0].real)
    return bool(
        np.allclose(np.abs(points.real), a) and np.allclose(np.abs(points.imag), a)
        and len({(np.sign(p.real), np.sign(p.imag)) for p in points}) == 4
    )


def _decide_kc(d, points_pl, active_mask, qpsk_amp=None):
    """Nearest-point decision in (..., K, 2, M) layout, zero off active SCs.

    When ``qpsk_amp`` is set (QPSK-shaped constellation) the decision is two
    sign selects instead of a distance tensor over all points.
    """
    r, i = d[..., 0, :], d[..., 1, :]
    if qpsk_amp is not None:
        a = float(qpsk_amp)
        hr = torch.where(r >= 0, a, -a).to(d.dtype)
        hi_ = torch.where(i >= 0, a, -a).to(d.dtype)
    else:
        pr = points_pl[:, 0].reshape((-1,) + (1,) * r.ndim)
        pi = points_pl[:, 1].reshape((-1,) + (1,) * r.ndim)
        dist = (r[None] - pr) ** 2 + (i[None] - pi) ** 2
        idx = torch.argmin(dist, dim=0)
        hr = points_pl[:, 0][idx]
        hi_ = points_pl[:, 1][idx]
    m = active_mask[..., 0, :]
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    return torch.stack([torch.where(m, hr, zero), torch.where(m, hi_, zero)], dim=-2)


_POINTS_CACHE: dict = {}


def _points_tensor(points: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constellation points as a (P, 2) tensor on the device and in the dtype
    of ``like``, uploaded once (a per-step upload would wait for the card)."""
    key = (points.tobytes(), str(like.device), like.dtype)
    hit = _POINTS_CACHE.get(key)
    if hit is None:
        pl = np.ascontiguousarray(to_planar(points).T)
        hit = _POINTS_CACHE[key] = torch.from_numpy(pl).to(like.device, like.dtype)
    return hit


def receive_bursts_planar(
    cfg: GfdmConfig,
    bursts: torch.Tensor,
    ic_iterations: int = 2,
    equalize: bool = True,
    constellation=qpsk_constellation,
    phase_compensation: bool = False,
    equalizer: str = "zf",
    method: str = "dense",
    dtype_name: str | None = None,
):
    """Planar receiver chain: (..., 2, >=frame_len) -> dict of planar outputs.

    bursts are aligned at the full-preamble start; the chain computes in
    their dtype on their device. method="fast" uses the factorized channel
    estimate, SNR power and Cooley-Tukey demodulation of
    :mod:`.planar_fast` instead of the dense operators. equalizer="mmse"
    regularizes the per-bin inversion with the estimated SNR;
    equalizer="mmse_cnr" uses the per-subcarrier CNR vector interpolated to
    every FD bin. dtype_name="bfloat16" takes bf16 operators (as
    :func:`transmit_planar`); the IC decisions then meet the bf16 ``C_W``
    rounded to bf16. Returns data, symbols, channel, snr_lin and cnrs.
    """
    if equalizer not in ("zf", "mmse", "mmse_cnr"):
        raise ValueError(f"unknown equalizer {equalizer!r}")
    mats = _mats_for(cfg, bursts, method, dtype_name)
    K, M = cfg.subcarriers, cfg.timeslots
    points = np.asarray(constellation)
    points_pl = _points_tensor(points, bursts)  # (P, 2)
    qpsk_amp = float(np.abs(points[0].real)) if _is_qpsk(points) else None
    n_active = cfg.subcarrier_map.size

    rx_pre = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K]
    if method == "fast":
        from . import planar_fast

        fc = planar_fast.fast_consts(cfg, _ops_dtype(bursts, dtype_name), bursts.device)
        channel = planar_fast.estimate_channel_fast(cfg, rx_pre, fc)
        p = planar_fast.snr_power_fast(cfg, rx_pre, fc)
    else:
        channel = pmatmul(rx_pre, mats["E_W"])  # (..., 2, N)
        # SNR from the 2K preamble FFT
        p = pabs2(pmatmul(rx_pre, mats["F2_W"]))
    cnrs = p[..., mats["sig_idx"]]
    sym = torch.sum(cnrs, dim=-1)
    noise = torch.sum(p[..., mats["noise_idx"]], dim=-1)
    snr_lin = (sym - noise) / noise
    cnrs = cnrs * (snr_lin / (sym / cnrs.shape[-1]))[..., None]

    start = cfg.preamble_len + cfg.cp_len
    frame = bursts[..., start : start + cfg.block_len]
    if equalize and equalizer == "mmse":
        # divide by H then shrink by |H|^2/(|H|^2+1/snr)
        h2 = pabs2(channel)
        w = h2 / (h2 + (1.0 / torch.clamp(snr_lin, min=1e-6))[..., None])
        channel_eff = channel / w[..., None, :]
    elif equalize and equalizer == "mmse_cnr":
        # a bf16 operator is upcast, the CNRs not rounded (jnp promotes)
        cnr_bins = torch.clamp(cnrs, min=0.0) @ mats["CNRI_T"].to(cnrs.dtype)
        cnr_bins = torch.clamp(cnr_bins, min=1e-6)
        w = cnr_bins / (cnr_bins + 1.0)
        channel_eff = channel / w[..., None, :]
    else:
        channel_eff = channel

    if method == "fast":
        # (..., K, 2, M) directly in IC layout
        d0 = planar_fast.demod_fast(cfg, frame, channel_eff, fc, equalize=equalize)
    else:
        X = pmatmul(frame, mats["F_W"])
        if equalize:
            X = pdiv(X, channel_eff)
        S = pmatmul(X, mats["Bfd_W"])  # (..., 2, N) symbol estimates
        d0 = S.reshape(S.shape[:-1] + (K, M)).movedim(-3, -2)
    # IC in (..., K, 2, M) layout: d_{k+1} = d0 - neighbors_k @ C with
    # C = idft_M . diag(ic_taps) . dft_M, one small planar matmul
    active_mask = mats["active"][:, None, None]  # over K

    def cancel(d0_ref, hard):
        neighbors = torch.roll(hard, 1, dims=-3) + torch.roll(hard, -1, dims=-3)
        return d0_ref - pmatmul(neighbors, mats["C_W"])

    remaining = ic_iterations
    if phase_compensation and ic_iterations > 0:
        # iteration-0 decisions come from the UNROTATED estimates; the phase
        # fix applies to the receiver state before the first cancellation
        hard0 = _decide_kc(d0, points_pl, active_mask, qpsk_amp)
        nz = (hard0[..., 0, :] ** 2 + hard0[..., 1, :] ** 2) > 0
        ang_h = torch.atan2(hard0[..., 1, :], hard0[..., 0, :])
        ang_d = torch.atan2(d0[..., 1, :], d0[..., 0, :])
        diff = torch.where(active_mask[..., 0, :] & nz, ang_h - ang_d,
                           torch.zeros((), dtype=d0.dtype, device=d0.device))
        phase = torch.sum(diff, dim=(-2, -1)) / (n_active * M)
        cr = torch.cos(phase)[..., None, None]
        ci = torch.sin(phase)[..., None, None]
        r0, i0 = d0[..., 0, :], d0[..., 1, :]
        d0 = torch.stack([r0 * cr - i0 * ci, r0 * ci + i0 * cr], dim=-2)
        d = cancel(d0, hard0)
        remaining = ic_iterations - 1
    else:
        d = d0
    for _ in range(remaining):
        d = cancel(d0, _decide_kc(d, points_pl, active_mask, qpsk_amp))

    symbols = d.movedim(-2, -3).reshape(bursts.shape[:-2] + (2, cfg.block_len))
    data = symbols[..., mats["demap_idx"]]
    return {
        "data": data,
        "symbols": symbols,
        "channel": channel,
        "snr_lin": snr_lin,
        "cnrs": cnrs,
    }


# ---------------------------------------------------------------------------
# Sync + extraction
# ---------------------------------------------------------------------------
def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis with ``jnp.median``'s semantics: the mean
    of the two middle values for an even count (``torch.median`` returns
    the lower one), computed as (lo + hi) * 0.5 like JAX's midpoint rule."""
    v = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] per leading row: take_along_axis with a trailing index."""
    return torch.gather(x, -1, idx)


@lru_cache(maxsize=16)
def _detect_consts(cfg: GfdmConfig, dtype_name: str) -> torch.Tensor:
    """(2 out, 2 in, 2K) conv weights of the preamble cross-correlation.

    conv1d computes cross-correlation (no kernel flip), so the kernel is
    conj(x_pre) directly; the channels realize the complex product. A CPU
    tensor in ``dtype_name``, rounded from float64 like the JAX package's.
    """
    x_pre = cfg.core_preamble
    x_pre = x_pre / np.sqrt(np.mean(np.abs(x_pre) ** 2))
    p = np.conjugate(x_pre)
    pr, pi = p.real, p.imag
    w = np.stack([np.stack([pr, -pi]), np.stack([pi, pr])])
    return torch.from_numpy(w).to(getattr(torch, dtype_name))


_DETECT_CACHE: dict = {}


def _detect_kernel(cfg: GfdmConfig, dtype_name: str, device) -> torch.Tensor:
    """_detect_consts on ``device``, uploaded once per (config, dtype, device)."""
    key = (cfg, dtype_name, str(device))
    hit = _DETECT_CACHE.get(key)
    if hit is None:
        hit = _DETECT_CACHE[key] = _detect_consts(cfg, dtype_name).to(device)
    return hit


# default front-end implementation, as in the JAX package: "twostage" for
# 128-aligned chunks (falls back to "matmul"), or "matmul" | "conv" |
# "pallas" (kernels/detect.detect_front_fused) | "pallas2"
# (kernels/detect.detect_bursts_fused, the one-burst detector only)
DETECT_IMPL = "twostage"
_FLOOR_STRIDE = 8  # noise-floor median subsample (same estimator, 1/8 sort)


@lru_cache(maxsize=16)
def _poly_consts(cfg: GfdmConfig, dtype_name: str):
    """Banded 0/1 window operators and the xcorr operator of the polyphase
    front end, as CPU tensors in ``dtype_name`` (rounded from float64 like
    the JAX package's): bands[w] (2b, b) sums a trailing w-window of a block
    pair; xcorr (4b, 2b) is the realified banded preamble correlation."""
    dt = getattr(torch, dtype_name)
    p = np.conjugate(cfg.core_preamble)
    p = p / np.sqrt(np.mean(np.abs(p) ** 2))
    b = p.size  # block size = xcorr kernel length = 2K
    Kc = np.zeros((2 * b, b), dtype=np.complex128)
    for v in range(b):
        Kc[v : v + b, v] = p
    bands = {}
    for w in (cfg.subcarriers, 2 * cfg.subcarriers, cfg.cp_len + 1):
        Bm = np.zeros((2 * b, b))
        for v in range(b):
            Bm[v : v + w, v] = 1.0
        bands[w] = torch.from_numpy(Bm).to(dt)
    xcorr = torch.from_numpy(real_operator(Kc, np.float64)).to(dt)
    return {"xcorr": xcorr, "bands": bands, "b": b}


_POLY_CACHE: dict = {}


def _poly_tensors(cfg: GfdmConfig, dtype_name: str, device) -> dict:
    """_poly_consts upcast to float32 on ``device`` (exact for bf16 values):
    the band and xcorr matmuls run in float32 on the rounded operands."""
    key = (cfg, dtype_name, str(device))
    hit = _POLY_CACHE.get(key)
    if hit is None:
        pc = _poly_consts(cfg, dtype_name)
        hit = {
            "xcorr": pc["xcorr"].to(device, torch.float32),
            "bands": {w: m.to(device, torch.float32) for w, m in pc["bands"].items()},
            "b": pc["b"],
        }
        _POLY_CACHE[key] = hit
    return hit


def _poly_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """(..., T) -> (..., nb, 2b) overlapping block pairs (zero-padded)."""
    T = x.shape[-1]
    nb = -(-T // b)
    pad = (nb + 1) * b - T
    xp = torch.nn.functional.pad(x, (0, pad))
    xb = xp.reshape(x.shape[:-1] + (nb + 1, b))
    return torch.cat([xb[..., :-1, :], xb[..., 1:, :]], dim=-1)


def _poly_window_sum(x: torch.Tensor, Bm: torch.Tensor, b: int, n_out: int):
    """Trailing-window sliding sum via one banded block matmul, in float32
    on upcast operands, rounded back to the dtype of ``x`` (where JAX's
    ``preferred_element_type=float32`` result is cast back)."""
    pairs = _poly_blocks(x, b).to(torch.float32)
    y = torch.matmul(pairs, Bm)
    return y.reshape(x.shape[:-1] + (-1,))[..., :n_out].to(x.dtype)


def _poly_xcorr(sw: torch.Tensor, xcorr: torch.Tensor, b: int, lead, n_pos: int):
    """Preamble cross-correlation of (..., 2, L) samples as one polyphase
    complex block matmul: -> (..., 2, n_pos) float32, not yet / 2K."""
    pairs = _poly_blocks(sw, b)  # (..., 2, nb, 2b)
    rows = torch.cat([pairs[..., 0, :, :], pairs[..., 1, :, :]], dim=-1)
    y = torch.matmul(rows.to(torch.float32), xcorr)  # (..., nb, 2b)
    cc = torch.stack([y[..., :b], y[..., b:]], dim=-3)  # (..., 2, nb, b)
    return cc.reshape(tuple(lead) + (2, -1))[..., :n_pos]


def _conv_xcorr(s: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """(B, 2, T) float32 (x) (2, 2, k) -> (B, 2, T - k + 1) 'valid'
    cross-correlation; on a card cuDNN runs it in float32, not TF32."""
    if s.dtype != kernel.dtype:
        # the JAX package's lax.conv_general_dilated refuses mixed dtypes
        raise TypeError(
            "the conv front end requires arguments to have the same dtypes, "
            f"got {str(s.dtype).removeprefix('torch.')}, "
            f"{str(kernel.dtype).removeprefix('torch.')}"
        )
    if s.device.type != "cuda":
        return torch.nn.functional.conv1d(s, kernel)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.functional.conv1d(s, kernel)
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _detect_front_planar(cfg: GfdmConfig, kernel, s, search_limit: int,
                         impl: str | None = None, dtype_name: str = "float32"):
    """Shared planar sync front end: (gated metric, ac, energy, ic trace).

    impl="matmul": every sliding window - the 2K-tap preamble
    cross-correlation, the K-wide autocorrelation sum, the 2K energy window
    and the CP-integration - is a polyphase banded block matmul.
    impl="pallas" runs the whole chain in the CUDA front-end kernel
    (kernels/detect.detect_front_fused). impl="conv" (and, as in the JAX
    package, any other value such as "pallas2") keeps the cumsum + conv
    forms. "twostage" has no full-trace form; its dense equivalent is
    "matmul".

    dtype_name="bfloat16" (matmul only) carries the trace intermediates and
    matmul operands in bf16, rounded where the JAX package rounds; outputs
    and all peak decisions stay float32.
    """
    from .sync import moving_sum

    if impl is None:
        impl = DETECT_IMPL
    if impl == "twostage":
        impl = "matmul"
    if impl == "pallas":
        from ..kernels.detect import detect_front_fused

        return detect_front_fused(cfg, s, search_limit)
    K = cfg.subcarriers
    cp_len = cfg.cp_len
    p_len = 2 * K
    T = s.shape[-1]
    lead = s.shape[:-2]
    n_ac = T - 2 * K
    bf16 = impl == "matmul" and dtype_name == "bfloat16"
    sw = s.to(torch.bfloat16) if bf16 else s
    # --- coarse autocorrelation ---
    c_prod = pmul(pconj(sw[..., : T - K]), sw[..., K:])
    if impl == "matmul":
        pc = _poly_tensors(cfg, "bfloat16" if bf16 else "float32", s.device)
        bb = pc["b"]
        p_ms = _poly_window_sum(c_prod, pc["bands"][K], bb, n_ac).to(torch.float32)
        energy = _poly_window_sum(pabs2(sw), pc["bands"][2 * K], bb, n_ac)
        energy = energy.to(torch.float32)
    else:
        p_ms = moving_sum(c_prod, K)[..., :n_ac]
        energy = moving_sum(pabs2(s), 2 * K)[..., :n_ac]
    energy = torch.clamp(energy, min=1e-30)
    ac = p_ms * (2.0 / energy)[..., None, :]
    ac_mag = torch.sqrt(pabs2(ac))
    pad = torch.zeros(ac_mag.shape[:-1] + (cp_len,), dtype=sw.dtype, device=s.device)
    if impl == "matmul":
        padded_mag = torch.cat([pad, ac_mag.to(sw.dtype)], dim=-1)
        ic = _poly_window_sum(padded_mag, pc["bands"][cp_len + 1], bb, n_ac)
        ic = ic.to(torch.float32) / (cp_len + 1)
        # --- fine: xcorr as one polyphase complex block matmul ---
        cc = _poly_xcorr(sw, pc["xcorr"], bb, lead, T - p_len + 1) / p_len
    else:
        ic = moving_sum(torch.cat([pad, ac_mag], dim=-1), cp_len + 1) / (cp_len + 1)
        # --- fine: cross-correlation as a 2-channel real conv ---
        cc = _conv_xcorr(s.reshape((-1, 2, T)), kernel)
        cc = cc.reshape(tuple(lead) + (2, T - p_len + 1)) / p_len
    n_valid = min(n_ac, search_limit)
    gated = torch.sqrt(pabs2(cc))[..., :n_valid] * ic[..., :n_valid]
    return gated, ac, energy, ic


def _peak_fields(cfg: GfdmConfig, nc, ac, energy):
    """CFO and scale at the detected positions ``nc`` (trailing index)."""
    ac_r = _take(ac[..., 0, :], nc)
    ac_i = _take(ac[..., 1, :], nc)
    cfo = torch.atan2(ac_i, ac_r) / (2.0 * np.pi)
    scale = torch.sqrt(2 * cfg.subcarriers / _take(energy, nc))
    return cfo, scale


def _detect_fn_planar(cfg: GfdmConfig, search_limit: int, dtype_name: str, s):
    """Dense one-burst detection: full traces, argmax of the gated metric."""
    kernel = _detect_kernel(cfg, dtype_name, s.device)
    gated, ac, energy, ic = _detect_front_planar(
        cfg, kernel, s, search_limit, dtype_name=dtype_name
    )
    nc = torch.argmax(gated, dim=-1, keepdim=True)
    cfo, scale = _peak_fields(cfg, nc, ac, energy)
    ic_v = ic[..., : gated.shape[-1]]
    return {"start": nc[..., 0], "cfo": cfo[..., 0], "scale": scale[..., 0],
            "strength": _take(gated, nc)[..., 0],
            "ac_peak": _take(ic_v, nc)[..., 0],
            "noise_floor": _median(ic_v[..., ::_FLOOR_STRIDE]),
            "ac_metric": ic}


_TWOSTAGE_BLOCK = 128  # window block granularity of the two-stage detector
_TWOSTAGE_HALF = 128  # candidate positions on either side of the coarse peak


def _twostage_blocks(cfg: GfdmConfig) -> int:
    """NB: 128-blocks gathered for the xcorr window (+-128 candidates, the
    2K taps and block-alignment slack)."""
    return (2 * _TWOSTAGE_HALF + 2 * cfg.subcarriers) // _TWOSTAGE_BLOCK + 2


def _detect_fn_twostage(cfg: GfdmConfig, search_limit: int, dtype_name: str, s):
    """Two-stage detection (DETECT_IMPL="twostage", the default).

    Stage 1 localizes the burst with the cheap traces alone (argmax of the
    CP-integrated autocorrelation), stage 2 runs the 2K-tap preamble xcorr
    only in NB = (2*128 + 2K)//128 + 2 gathered 128-sample blocks around
    it. Positions of the window at or past n_valid gate to -1.0. Full
    traces are still produced for cfo/scale/floor, so the output contract
    is the dense detector's. Chunk lengths must be 128-aligned and hold the
    NB blocks (the dispatcher falls back to the dense form otherwise).
    """
    K = cfg.subcarriers
    cp_len = cfg.cp_len
    p_len = 2 * K
    b, W_HALF = _TWOSTAGE_BLOCK, _TWOSTAGE_HALF
    NB = _twostage_blocks(cfg)
    T = s.shape[-1]
    lead = tuple(s.shape[:-2])
    n_ac = T - 2 * K
    dev = s.device
    bf16 = dtype_name == "bfloat16"
    sw = s.to(torch.bfloat16) if bf16 else s
    pc = _poly_tensors(cfg, "bfloat16" if bf16 else "float32", dev)
    bb = pc["b"]
    c_prod = pmul(pconj(sw[..., : T - K]), sw[..., K:])
    p_ms = _poly_window_sum(c_prod, pc["bands"][K], bb, n_ac).to(torch.float32)
    energy = _poly_window_sum(pabs2(sw), pc["bands"][2 * K], bb, n_ac)
    energy = torch.clamp(energy.to(torch.float32), min=1e-30)
    ac = p_ms * (2.0 / energy)[..., None, :]
    ac_mag = torch.sqrt(pabs2(ac))
    pad = torch.zeros(ac_mag.shape[:-1] + (cp_len,), dtype=sw.dtype, device=dev)
    padded_mag = torch.cat([pad, ac_mag.to(sw.dtype)], dim=-1)
    ic = _poly_window_sum(padded_mag, pc["bands"][cp_len + 1], bb, n_ac)
    ic = ic.to(torch.float32) / (cp_len + 1)
    n_valid = min(n_ac, search_limit)

    # stage 1: coarse position from the integrated autocorrelation
    nc0 = torch.argmax(ic[..., :n_valid], dim=-1)

    # stage 2: xcorr only in NB gathered blocks around the coarse peak
    nbT = T // b
    b0 = torch.clamp(torch.div(nc0 - W_HALF, b, rounding_mode="floor"),
                     min=0, max=nbT - NB)
    sblk = sw[..., : nbT * b].reshape(s.shape[:-1] + (nbT, b))  # (..., 2, nbT, b)
    blocks = torch.arange(NB, device=dev)
    idx = (b0[..., None] + blocks)[..., None, :, None]
    win = torch.gather(sblk, -2, idx.expand(lead + (2, NB, b)))
    win = win.reshape(lead + (2, NB * b))
    n_pos = NB * b - p_len + 1
    cc = _poly_xcorr(win, pc["xcorr"], bb, lead, n_pos) / p_len
    # gate with the ic values at the same absolute positions
    nbI = n_ac // b
    icblk = ic[..., : nbI * b].reshape(lead + (nbI, b))
    idx_ic = torch.clamp(b0[..., None] + blocks, min=0, max=nbI - 1)
    ic_w = torch.gather(icblk, -2, idx_ic[..., None].expand(lead + (NB, b)))
    ic_w = ic_w.reshape(lead + (NB * b,))[..., :n_pos]
    pos = b0[..., None] * b + torch.arange(n_pos, device=dev)
    gated_w = torch.where(pos < n_valid, torch.sqrt(pabs2(cc)) * ic_w, -1.0)
    j = torch.argmax(gated_w, dim=-1, keepdim=True)
    nc = b0[..., None] * b + j
    cfo, scale = _peak_fields(cfg, nc, ac, energy)
    ic_v = ic[..., :n_valid]
    return {"start": nc[..., 0], "cfo": cfo[..., 0], "scale": scale[..., 0],
            "strength": _take(gated_w, j)[..., 0],
            "ac_peak": _take(ic_v, nc)[..., 0],
            "noise_floor": _median(ic_v[..., ::_FLOOR_STRIDE]),
            "ac_metric": ic}


def detect_bursts_planar(cfg: GfdmConfig, stream: torch.Tensor,
                         search_limit: int | None = None,
                         dtype_name: str = "float32"):
    """Planar burst detection: (..., 2, T) -> metadata dict (real tensors).

    ``search_limit`` restricts the detection argmax to owned positions when
    the chunk carries a lookahead halo. With DETECT_IMPL == "pallas2" the
    front end runs in the CUDA trace-lean kernel
    (kernels/detect.detect_bursts_fused; no ac_metric trace in the dict).
    """
    T = int(stream.shape[-1])
    limit = T if search_limit is None else int(search_limit)
    if DETECT_IMPL == "pallas2":
        from ..kernels.detect import detect_bursts_fused

        return detect_bursts_fused(cfg, stream, limit)
    # twostage needs 128-aligned chunks of at least NB blocks; the JAX
    # package also routes shorter aligned chunks there, where its clamped
    # window index goes negative (negative starts), and the port takes the
    # dense form instead
    if (DETECT_IMPL == "twostage" and T % _TWOSTAGE_BLOCK == 0
            and T >= _twostage_blocks(cfg) * _TWOSTAGE_BLOCK):
        return _detect_fn_twostage(cfg, limit, dtype_name, stream)
    return _detect_fn_planar(cfg, limit, dtype_name, stream)


def detect_bursts_topk_planar(cfg: GfdmConfig, stream: torch.Tensor,
                              max_bursts: int, search_limit: int | None = None,
                              min_distance: int | None = None,
                              dtype_name: str = "float32"):
    """Planar top-k burst detection: up to ``max_bursts`` per chunk.

    Iterative peak picking with +-min_distance suppression (defaults to one
    frame length), strongest first; entries beyond the real burst count have
    near-zero ``strength``. The full-trace front end follows DETECT_IMPL as
    in the JAX package: "pallas" runs the CUDA front-end kernel, and
    "pallas2" (neither "matmul" nor "pallas") runs the conv form.
    """
    T = int(stream.shape[-1])
    limit = T if search_limit is None else int(search_limit)
    if min_distance is None:
        min_distance = cfg.frame_len
    kernel = _detect_kernel(cfg, dtype_name, stream.device)
    gated, ac, energy, ic = _detect_front_planar(
        cfg, kernel, stream, limit, dtype_name=dtype_name
    )
    pos = torch.arange(gated.shape[-1], device=gated.device)
    g = gated
    ncs, peaks = [], []
    for _ in range(int(max_bursts)):
        nc = torch.argmax(g, dim=-1, keepdim=True)
        peaks.append(_take(g, nc))
        ncs.append(nc)
        g = torch.where(torch.abs(pos - nc) < min_distance, 0.0, g)
    ncs = torch.cat(ncs, dim=-1)  # (..., max_bursts)
    cfo, scale = _peak_fields(cfg, ncs, ac, energy)
    ic_v = ic[..., : gated.shape[-1]]
    return {
        "start": ncs, "cfo": cfo, "scale": scale,
        "strength": torch.cat(peaks, dim=-1),
        "ac_peak": _take(ic_v, ncs),
        "noise_floor": _median(ic_v[..., ::_FLOOR_STRIDE]),
    }


def _extract_fn_planar(cfg: GfdmConfig, burst_len: int, backoff: int,
                       correct_cfo: bool, impl: str = "barrel",
                       dtype_name: str = "float32"):
    """Burst extraction (stream, start, scale, cfo) -> (..., 2, burst_len).

    Positions outside the chunk read zeros: a ``backoff`` pre-roll and
    starts clipped to [0, T] (the reference's tag_backoff pre-roll,
    extract_burst_cc_impl.cc:184-191). impl="barrel" decomposes the
    per-chunk shift into a whole-128-block gather and two one-hot select
    stages (16 then 8 static slices); impl="slice" takes one slice per
    chunk. ``dtype_name="bfloat16"`` (barrel) rounds the samples to bf16
    once; the selects are exact. Scale and CFO derotation run in float32.
    """
    K = cfg.subcarriers
    b = 128
    f1, f2 = 16, b // 16  # shift = 8*r1 + r2
    bf16 = impl == "barrel" and dtype_name == "bfloat16"

    def fn(stream, start, scale, cfo):
        T = stream.shape[-1]
        lead = tuple(stream.shape[:-2])
        dev = stream.device
        if bf16:
            stream = stream.to(torch.bfloat16)
        st = torch.clamp(start.reshape(-1), 0, T)
        flat = stream.reshape((-1, 2, T))
        Bf = flat.shape[0]
        if impl == "slice":
            padded = torch.nn.functional.pad(flat, (backoff, burst_len))
            idx = st[:, None] + torch.arange(burst_len, device=dev)
            burst = torch.gather(padded, -1, idx[:, None, :].expand(Bf, 2, burst_len))
        else:
            nbl = -(-(b - 1 + burst_len) // b)  # coarse blocks per burst
            P = backoff + T + burst_len
            pad_tail = (-P) % b + b  # align + one spare zero block
            padded = torch.nn.functional.pad(flat, (backoff, burst_len + pad_tail))
            nb = padded.shape[-1] // b
            xb = padded.reshape(Bf, 2, nb, b)
            q = torch.div(st, b, rounding_mode="floor")
            r = st - q * b
            idx = torch.clamp(q[:, None] + torch.arange(nbl, device=dev), 0, nb - 1)
            coarse = torch.gather(xb, 2, idx[:, None, :, None].expand(Bf, 2, nbl, b))
            coarse = coarse.reshape(Bf, 2, nbl * b)
            r1 = torch.div(r, f2, rounding_mode="floor")
            r2 = r - r1 * f2
            L1 = nbl * b - (f1 - 1) * f2
            y1 = torch.zeros((Bf, 2, L1), dtype=stream.dtype, device=dev)
            for a in range(f1):
                y1 = y1 + torch.where((r1 == a)[:, None, None],
                                      coarse[..., a * f2 : a * f2 + L1], 0.0)
            burst = torch.zeros((Bf, 2, burst_len), dtype=stream.dtype, device=dev)
            for c in range(f2):
                burst = burst + torch.where((r2 == c)[:, None, None],
                                            y1[..., c : c + burst_len], 0.0)
        burst = burst.reshape(lead + (2, burst_len))
        burst = burst.to(torch.float32) * scale[..., None, None]
        if correct_cfo:
            offs = torch.arange(burst_len, device=dev, dtype=torch.float32)
            phase = -2.0 * np.pi * cfo[..., None] * offs / K
            rot = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2)
            burst = pmul(burst, rot)
        return burst

    return fn


def extract_bursts_planar(cfg: GfdmConfig, stream: torch.Tensor, detection: dict,
                          burst_len: int | None = None, backoff: int | None = None,
                          correct_cfo: bool = True, dtype_name: str = "float32"):
    """Planar burst extraction: (..., 2, T) + detection -> (..., 2, burst_len).

    ``dtype_name="bfloat16"`` runs the barrel gather/select stages on bf16
    samples (output back in float32 before the scale/CFO epilogue) - the
    service threads its detection dtype here.
    """
    if burst_len is None:
        burst_len = cfg.frame_len
    if backoff is None:
        backoff = cfg.cp_len
    fn = _extract_fn_planar(cfg, int(burst_len), int(backoff), bool(correct_cfo),
                            dtype_name=str(dtype_name))
    return fn(stream, detection["start"], detection["scale"], detection["cfo"])


def refine_cfo_planar(cfg: GfdmConfig, bursts: torch.Tensor, skip: int | None = None):
    """Fine CFO correction of coarse-corrected extracted bursts.

    (..., 2, frame_len) planar -> (corrected bursts, fine residual in
    subcarrier fractions). The payload block's cyclic prefix gives an N-lag
    observable (CP sample i equals block-end sample i rotated by
    2*pi*cfo*N/K), an N/K times longer phase lever than the preamble's K
    lag; the residual after the coarse correction is far inside the
    +-K/(2N) ambiguity. ``skip`` (default cp_len/2) drops the first CP
    samples, ISI-polluted by the preceding preamble tail under multipath.
    """
    if skip is None:
        skip = cfg.cp_len // 2
    K = cfg.subcarriers
    N = cfg.block_len
    cp0 = cfg.preamble_len + int(skip)  # block-CP window [cp0, cp1)
    cp1 = cfg.preamble_len + cfg.cp_len
    a = bursts[..., cp0:cp1]
    b = bursts[..., cp0 + N : cp1 + N]
    z = torch.sum(pmul(pconj(a), b), dim=-1)  # (..., 2)
    fine = torch.atan2(z[..., 1], z[..., 0]) * (K / (2.0 * np.pi * N))
    offs = torch.arange(bursts.shape[-1], device=bursts.device, dtype=torch.float32)
    phase = -2.0 * np.pi * fine[..., None] * offs / K
    rot = torch.stack([torch.cos(phase), torch.sin(phase)], dim=-2)
    return pmul(bursts, rot), fine


# ---------------------------------------------------------------------------
# Full link step
# ---------------------------------------------------------------------------
def evm(data_hat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Error-vector magnitude of the whole batch (scalar tensor)."""
    err = torch.sum((data_hat - data) ** 2)
    ref = torch.clamp(torch.sum(data**2), min=1e-30)
    return torch.sqrt(err / ref)


def link_step_planar(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int = 2,
                     method: str = "dense", dtype_name: str | None = None):
    """Planar end-to-end: payload -> Tx -> Rx -> (data_hat, snr, evm).

    dtype_name="bfloat16" runs every operator product with bf16 operators
    and bf16-rounded activations, summed in float32.
    """
    bursts = transmit_planar(cfg, data, method=method, dtype_name=dtype_name)[..., 0, :, :]
    out = receive_bursts_planar(cfg, bursts, ic_iterations=ic_iterations,
                                method=method, dtype_name=dtype_name)
    return out["data"], out["snr_lin"], evm(out["data"], data)
