"""Fused GFDM kernels: transmitters, receivers and the one-kernel link.

The port of ``gfdm_tpu.kernels.fused``. Each Pallas kernel is CUDA C++ for
Hopper in ``gfdm_tpu_torch/csrc`` (built by :mod:`.cuda_lib`) and has a
plain torch version here that computes the same thing the same way:

- ``_tx_kernel`` and ``_tx_cdd_kernel`` -> ``tx_kernel`` (csrc/tx.cu): one
  core product with T_G over (bursts x core columns) tiles (``TX_TILE``),
  each tile's core samples written to their framed positions in every
  requested cyclic-delay port;
- ``_rx_ic_circ_kernel`` -> the staged receiver (csrc/link.cu on the
  tensor-core engine of csrc/link_gemm.cuh) with every option: equalizer
  zf / mmse / mmse_cnr, QPSK / qam16 / qam64 IC decisions (the amplitude
  folded into the conv taps or the bf16 IC operator), both IC modes and the
  one-shot phase compensation: one launch a stage, ``RX_STAGES``, the phase
  stage where it applies, then one an IC iteration (``rx_launches``); its
  stages read the caller's bursts in place and sum the float32-stack
  products in float64 (FP64 tensor cores), so it matches the plain version
  summed in float64 (``gdot=_gdot64``) decision for decision;
- ``_link_kernel`` -> the staged link on the same stages: one launch a
  stage, ``LINK_STAGES`` then one an IC iteration; float32 stacks as 3xTF32
  products, the IC operator and bfloat16 stacks as bf16 products;
- the superseded receivers ``_rx_core_kernel``, ``_rx_ic_kernel``,
  ``_rx_full_kernel`` and ``_rx_hybrid_kernel`` -> a plan of launches each
  (``variant_launches``) of csrc/rx.cu's stages: register-blocked Gauss
  GEMMs over (bursts x columns) tiles (estimate, DFT + ZF, demod) and one
  per-burst pass (the IC; for the hybrid the fold, IDFTs and IC).

What every plain version pins: the Gauss 3-product stacks, the ZF
denominator clamped at 1e-30, decisions ``>= 0 -> +1`` (QPSK) or the odd
level ``clip(2 round((u s - 1) / 2) + 1)`` with round half to even (QAM),
zeroed off the active subcarriers, the metrics row ``[snr_lin | cnrs |
0-pad]``, bf16 operators upcast to float32 with the activations rounded to
bf16 before each product.

The large-K factored pair (``_tx_factored_kernel``, ``_rx_factored_kernel``,
``_rx_factored_chan_kernel``; ``csrc/factored.cu``) carries no dense
operator on the demodulation path: the N-point (I)DFT is K-point DFTs plus a
twiddled M-point stage, the filter fold / overlap-add are L taps, the
per-subcarrier M-point transforms are M-point products. Their plain
versions are the stages of :mod:`..ops.planar_fast` with the kernels' ZF
clamp and circulant IC. ``_rx_factored_kernel`` (``estimator="fused"``) is
two launches: the dense estimate ``pre2 @ E_W`` as a register-blocked GEMM
over (bursts x channel columns) tiles, then the receiver of
``_rx_factored_chan_kernel`` on the channel it wrote.

Dispatch: a wrapper runs the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts the
kernel launches of each wrapper. The two link steps (``link_single_fused``,
``link_step_factored``) are each a ``gfdm.link.step`` span
(``utils.profiling.span``): the host's time to enqueue a step, a range on
the card's timeline under ``torch.profiler``.

Layouts match the JAX package: payload (B, 2, n_data), bursts
(B, 2, frame_len), kernel rows planar-flat ``[re | im]``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..ops import operators, planar_fast
from ..ops.planar import bf16_operator, pabs2, pconj, pmatmul, pmul, real_operator
from ..ops.planar_pipeline import (
    _gauss_operators, _np_gauss_stacks, _small_consts, _to_tensor, evm,
)
from ..utils.profiling import span

__all__ = [
    "LAUNCHES",
    "TX_TILE",
    "tx_frame_fused",
    "tx_cdd_fused",
    "rx_receiver_fused",
    "receive_bursts_fused",
    "link_step_fused",
    "link_single_fused",
    "link_launches",
    "LINK_STAGES",
    "rx_launches",
    "RX_STAGES",
    "variant_launches",
    "rx_core_fused",
    "rx_ic_fused",
    "rx_full_fused",
    "rx_receiver_hybrid",
    "tx_frame_factored",
    "rx_receiver_factored",
    "link_step_factored",
]

# kernel launches per wrapper since the last reset (plain runs do not count)
LAUNCHES = {"tx": 0, "tx_cdd": 0, "rx": 0, "link": 0,
            "rx_core": 0, "rx_ic": 0, "rx_full": 0, "rx_hybrid": 0,
            "tx_factored": 0, "rx_factored": 0, "rx_factored_chan": 0}

# csrc/tx.cu's tile: bursts, core columns and k-depth of a CTA (the library's
# gfdm_tx_tile reports the same on first launch)
TX_TILE = (64, 64, 16)

# IC symbol amplitude of each constellation; the IC decisions are integer
# levels and the amplitude is folded into the interference taps / operator
_IC_AMPS = {"qpsk": 2.0**-0.5, "qam16": 10.0**-0.5, "qam64": 42.0**-0.5}
_QPSK_AMP = _IC_AMPS["qpsk"]
# the odd-level quantizer of qam16 / qam64: (scale, limit)
_QAM_LEVELS = {"qam16": (10.0**0.5, 3.0), "qam64": (42.0**0.5, 7.0)}
# option -> the integer the kernels read (gfdm::Dims)
_IC_MODES = {"conv": 0, "matmul": 1}
_DEC_KINDS = {"qpsk": 0, "qam16": 1, "qam64": 2}
_EQUALIZERS = {"zf": 0, "mmse": 1, "mmse_cnr": 2}
_DTYPES = ("float32", "bfloat16")
# csrc/rx.cu gfdm::rxv::Variant of each superseded receiver, and the
# number of each of its stages (gfdm::rxv::Stage)
_VARIANTS = {"rx_core": 0, "rx_ic": 0, "rx_full": 1, "rx_hybrid": 2}
_VARIANT_STAGES = {"estimate": 0, "dft_zf": 1, "demod": 2, "cancel": 3, "hybrid": 4}
# csrc/link.cu gfdm::lg::Stage: the number of each staged launch
_STAGE = {"tx": 0, "est_zf": 1, "pre_dft": 2, "metrics": 3, "demod": 4, "ic": 5, "phase": 6}
# the link's launches, in order: these five once a call, then one an IC
# iteration in either IC mode
LINK_STAGES = ("tx", "est_zf", "pre_dft", "metrics", "demod")
# the dense receiver's: these four once a call (the metrics before the
# estimate, whose mmse / mmse_cnr weight reads them), the phase stage with
# phase compensation and IC, then one an IC iteration
RX_STAGES = ("pre_dft", "metrics", "est_zf", "demod")
# the dense operators: the largest float32 stack, F_G (3N, N), may take
# 256 MiB (N = 4608, K = 512 at M = 9); beyond, the factored kernels
_DENSE_MAX_STACK_BYTES = 1 << 28


def link_launches(ic_mode: str, ic_iterations: int) -> int:
    """Kernel launches of one link_single_fused call on a CUDA tensor: one a
    stage, then one an IC iteration (the matmul IC's product and the conv
    IC's stencil alike)."""
    _choice("ic_mode", ic_mode, _IC_MODES)
    return len(_link_plan(ic_iterations))


def _link_plan(ic_iterations: int):
    """(stage name, csrc/link.cu stage number, IC iteration) of each launch."""
    plan = [(name, _STAGE[name], 0) for name in LINK_STAGES]
    return plan + [("ic", _STAGE["ic"], it) for it in range(int(ic_iterations))]


def rx_launches(ic_iterations: int, phase_compensation: bool = False) -> int:
    """Kernel launches of one rx_receiver_fused call on a CUDA tensor:
    4 + (1 with phase compensation and IC) + ic_iterations."""
    return len(_rx_plan(ic_iterations, phase_compensation))


def _rx_plan(ic_iterations: int, phase_compensation: bool = False):
    """(stage name, csrc/link.cu stage number, IC iteration) of each launch
    of the dense receiver: the phase stage only where an IC iteration
    follows (the correction uses the first decisions)."""
    plan = [(name, _STAGE[name], 0) for name in RX_STAGES]
    if phase_compensation and ic_iterations > 0:
        plan.append(("phase", _STAGE["phase"], 0))
    return plan + [("ic", _STAGE["ic"], it) for it in range(int(ic_iterations))]


def variant_launches(key: str, ic_iterations: int = 0) -> int:
    """Kernel launches of one call of the superseded receiver ``key`` on a
    CUDA tensor at ``ic_iterations`` (rx_core runs none): rx_core 2, rx_ic 2
    + (1 with IC), rx_full 3 + (1 with IC), rx_hybrid 3."""
    return len(_variant_plan(key, ic_iterations))


def _variant_plan(key: str, ic_iterations: int):
    """(stage name, csrc/rx.cu stage number, 0) of each launch of the
    superseded receiver ``key``: the estimate where the channel is not
    given, DFT + ZF, then the demodulator and, with IC, one launch of all
    its iterations; or the hybrid's fold / IDFT / IC pass."""
    _choice("key", key, _VARIANTS)
    if key == "rx_core" and ic_iterations:
        raise ValueError(f"rx_core runs no IC, got ic_iterations={ic_iterations}")
    names = [] if key in ("rx_core", "rx_ic") else ["estimate"]
    names.append("dft_zf")
    if key == "rx_hybrid":
        names.append("hybrid")
    else:
        names += ["demod"] + (["cancel"] if ic_iterations > 0 else [])
    return [(name, _VARIANT_STAGES[name], 0) for name in names]


def _check_dense_size(cfg: GfdmConfig, fn: str, factored: str) -> None:
    """Refuse a config whose dense operator stacks are too large to build,
    naming ``factored``, the wrapper that takes it."""
    n = cfg.block_len
    nbytes = 3 * n * n * 4
    if nbytes > _DENSE_MAX_STACK_BYTES:
        raise ValueError(
            f"{fn}: N = {n} needs dense (3N, N) float32 operator stacks of "
            f"{nbytes / 2**20:.0f} MiB each (limit {_DENSE_MAX_STACK_BYTES / 2**20:.0f} MiB); "
            f"at large K use {factored}")


def _choice(name: str, value, options) -> None:
    if value not in options:
        raise ValueError(f"unknown {name} {value!r} (use one of {', '.join(map(repr, options))})")


@dataclass(frozen=True)
class _RxOptions:
    """The receiver options of one call, validated."""

    ic_iterations: int = 2
    ic_mode: str = "conv"
    constellation: str = "qpsk"
    equalizer: str = "zf"
    phase_compensation: bool = False
    amp: float = _QPSK_AMP  # IC amplitude folded into taps / operator


def _rx_options(ic_iterations=2, ic_mode="conv", constellation="qpsk", equalizer="zf",
                phase_compensation=False, qpsk_amp=None) -> _RxOptions:
    _choice("ic_mode", ic_mode, _IC_MODES)
    _choice("constellation", constellation, _DEC_KINDS)
    _choice("equalizer", equalizer, _EQUALIZERS)
    amp = _IC_AMPS[constellation] if qpsk_amp is None else float(qpsk_amp)
    return _RxOptions(int(ic_iterations), ic_mode, constellation, equalizer,
                      bool(phase_compensation), amp)


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------
@lru_cache(maxsize=16)
def _met_layout(cfg: GfdmConfig):
    """(n_cnr, met_w): CNR count and padded metrics-row width."""
    n_cnr = 2 * (cfg.active_subcarriers // 2)
    met_w = ((2 + n_cnr + 127) // 128) * 128
    return n_cnr, met_w


def _bf16_stack(W: np.ndarray) -> torch.Tensor:
    """bf16 Gauss stack [Wr; Wi; Wr + Wi] (3 n_in, n_out) of the complex W:
    each part rounded once from float64 by torch (ml_dtypes' rounding,
    pinned in tests/test_torch_constants.py), the sum plane taken in bf16."""
    Wr, Wi = bf16_operator(W.real), bf16_operator(W.imag)
    return torch.cat([Wr, Wi, Wr + Wi], dim=0)


@lru_cache(maxsize=16)
def _ic_matmul_stack(cfg: GfdmConfig, amp: float) -> torch.Tensor:
    """bf16 Gauss stack (3N, N) of the interference operator amp*(P+M + P-M)@BD.

    Row convention: interference_row = decisions_row @ A. Built in float64
    like the JAX package's stack.
    """
    n, M, K = cfg.block_len, cfg.timeslots, cfg.subcarriers
    C = operators._interference_matrix(cfg).T
    BD = np.zeros((n, n), dtype=np.complex128)
    for k in range(K):
        BD[k * M : (k + 1) * M, k * M : (k + 1) * M] = C
    P = np.roll(np.eye(n), M, axis=1) + np.roll(np.eye(n), -M, axis=1)
    return _bf16_stack(amp * (P @ BD))


def _ic_taps_np(cfg: GfdmConfig, amp: float) -> np.ndarray:
    """(2, M) conv-IC taps: column 0 of the circulant C rounded to float32,
    times ``amp`` in float64, rounded once more (tap j multiplies timeslot
    (m - j) mod M)."""
    c_col = operators._interference_matrix(cfg)[:, 0]
    c_f32 = np.stack([c_col.real, c_col.imag]).astype(np.float32)
    return (c_f32.astype(np.float64) * amp).astype(np.float32)


_KERNEL_CONSTS: dict = {}


def _kernel_consts(cfg: GfdmConfig, device) -> dict:
    """Constants of the dense kernels on ``device``, built once per
    (config, device): the float32 Gauss stacks and small constants only,
    none of the planar path's operators. Index forms replace the Pallas
    kernels' 0/1 selection matrices and roll masks; ``CNRI_T`` (n_cnr, N)
    is the mmse_cnr interpolation operator (the Pallas kernel's zero-padded
    ``_cnri_pad`` rows dropped)."""
    device = torch.device(device)
    key = (cfg, str(device))
    hit = _KERNEL_CONSTS.get(key)
    if hit is not None:
        return hit
    small = _small_consts(cfg, "float32")
    arrays = {**_np_gauss_stacks(cfg, "float32"), **{name: small[name] for name in (
        "win", "preambles", "sig_idx", "noise_idx", "demap_idx",
    )}}
    arrays["act"] = np.repeat(small["active"].astype(np.float32), cfg.timeslots)
    arrays["taps"] = _ic_taps_np(cfg, _QPSK_AMP)
    arrays["CNRI_T"] = operators.cnr_interpolation_operator(cfg).T.astype(np.float32)
    k = {name: _to_tensor(a, device) for name, a in arrays.items()}
    _KERNEL_CONSTS[key] = k
    return k


_EXTRA_CONSTS: dict = {}


def _extra(cfg: GfdmConfig, device, name, build):
    """A constant built on first use and cached per (config, device, name)."""
    key = (cfg, str(torch.device(device)), name)
    hit = _EXTRA_CONSTS.get(key)
    if hit is None:
        hit = _EXTRA_CONSTS[key] = build()
    return hit


def _stacks(cfg: GfdmConfig, device, dtype_name: str = "float32") -> dict:
    """The five Gauss stacks in float32 or (the link's dtype "bfloat16") bf16."""
    if dtype_name == "float32":
        return _kernel_consts(cfg, device)
    return _extra(cfg, device, "bf16_stacks", lambda: {
        name: _bf16_stack(W).to(device) for name, W in _gauss_operators(cfg).items()
    })


def _shifts(cfg: GfdmConfig, device) -> torch.Tensor:
    """(n_shifts,) int32 cyclic shift of each Tx port."""
    return _extra(cfg, device, "shifts", lambda: _to_tensor(
        np.asarray(cfg.cyclic_shifts, dtype=np.int32), device))


def _ic_operand(cfg: GfdmConfig, ic_mode: str, device, amp: float = _QPSK_AMP):
    """IC constant with the amplitude ``amp`` folded in: the bf16 (3N, N)
    operator (built on first use) or the float32 (2, M) circulant taps."""
    if ic_mode == "matmul":
        return _extra(cfg, device, ("icop", float(amp)),
                      lambda: _ic_matmul_stack(cfg, float(amp)).to(device))
    if float(amp) == _QPSK_AMP:
        return _kernel_consts(cfg, device)["taps"]
    return _extra(cfg, device, ("taps", float(amp)),
                  lambda: _to_tensor(_ic_taps_np(cfg, float(amp)), device))


# ---------------------------------------------------------------------------
# plain torch versions (what the kernels compute)
# ---------------------------------------------------------------------------
def _gdot(xr, xi, g, n_in):
    """Complex product with a Gauss stack [Wr; Wi; Wr+Wi]. A bf16 stack is
    upcast and the activations are rounded to bf16 first, their sum plane
    taken in bf16, as the JAX package's _gdot casts them to the stack's type
    (float32 accumulation either way)."""
    if g.dtype == torch.bfloat16:
        xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
        s = (xr + xi).float()
        xr, xi = xr.float(), xi.float()
    else:
        s = xr + xi
    g = g.to(torch.float32)
    p1 = xr @ g[:n_in]
    p2 = xi @ g[n_in : 2 * n_in]
    p3 = s @ g[2 * n_in :]
    return p1 - p2, p3 - p1 - p2


def _gdot64(xr, xi, g, n_in):
    """_gdot summed in float64 and rounded once to float32. With a bf16
    stack every product is exact, so this is each output's float32 value as
    near as float64 sums give it, whatever the order of the sums."""
    if g.dtype == torch.bfloat16:
        xr, xi = xr.to(torch.bfloat16), xi.to(torch.bfloat16)
    s = (xr + xi).double()
    xr, xi, g = xr.double(), xi.double(), g.double()
    p1 = xr @ g[:n_in]
    p2 = xi @ g[n_in : 2 * n_in]
    return (p1 - p2).float(), (s @ g[2 * n_in :] - p1 - p2).float()


def _conv_ic(qr, qi, taps, K, M):
    """Interference as neighbour-subcarrier sums and an M-tap circulant."""
    B = qr.shape[0]

    def neighbours(q):
        q3 = q.reshape(B, K, M)
        return torch.roll(q3, 1, dims=1) + torch.roll(q3, -1, dims=1)

    nr, ni = neighbours(qr), neighbours(qi)
    ir = torch.zeros_like(nr)
    ii = torch.zeros_like(ni)
    for j in range(M):
        sr = torch.roll(nr, j, dims=2)
        si = torch.roll(ni, j, dims=2)
        tr, ti = taps[0, j], taps[1, j]
        ir = ir + tr * sr - ti * si
        ii = ii + tr * si + ti * sr
    return ir.reshape(B, K * M), ii.reshape(B, K * M)


def _ic_level(u: torch.Tensor, constellation: str) -> torch.Tensor:
    """IC decision levels: QPSK signs (>= 0 -> +1), or the odd level nearest
    to u * scale for qam16 / qam64; torch.round rounds half to even like
    jnp.round (and the kernels' rintf)."""
    if constellation == "qpsk":
        return torch.where(u >= 0, 1.0, -1.0)
    scale, lim = _QAM_LEVELS[constellation]
    return torch.clamp(2.0 * torch.round((u * scale - 1.0) / 2.0) + 1.0, -lim, lim)


def _phase_rotate(cfg: GfdmConfig, d0r, d0i, qr, qi, act):
    """One-shot common-phase correction of d0 from the decisions q (zero off
    the active symbols): the mean over the active symbols of the A&S 4.4.49
    arctan of clip(Im / max(Re, 1e-20), -1, 1) of q conj(d0), then d0
    rotated with Taylor cos / sin (the JAX kernel's polynomials)."""
    re = qr * d0r + qi * d0i
    im = qi * d0r - qr * d0i
    u = torch.clamp(im / torch.clamp(re, min=1e-20), -1.0, 1.0)
    u2 = u * u
    delta = u * (0.9998660 + u2 * (-0.3302995 + u2 * (0.1801410
                 + u2 * (-0.0851330 + 0.0208351 * u2))))
    n_act = float(cfg.subcarrier_map.size * cfg.timeslots)
    phi = torch.sum(delta * act, dim=-1, keepdim=True) / n_act
    p2 = phi * phi
    cph = 1.0 - p2 * (0.5 - p2 * (1.0 / 24.0 - p2 / 720.0))
    sph = phi * (1.0 - p2 * (1.0 / 6.0 - p2 * (1.0 / 120.0 - p2 / 5040.0)))
    return cph * d0r - sph * d0i, sph * d0r + cph * d0i


def _cancel_plain(cfg: GfdmConfig, act, d0r, d0i, opts: _RxOptions, ic_op, gdot=None):
    """Decision-directed IC: ic_iterations of d = d0 - interference(levels
    of d on the active symbols); the first iteration decides on d0 and, with
    phase compensation, rotates d0 before it subtracts."""
    dr, di = d0r, d0i
    for it in range(opts.ic_iterations):
        qr = _ic_level(dr, opts.constellation) * act
        qi = _ic_level(di, opts.constellation) * act
        if it == 0 and opts.phase_compensation:
            d0r, d0i = _phase_rotate(cfg, d0r, d0i, qr, qi, act)
        if opts.ic_mode == "matmul":
            ir, ii = (gdot or _gdot)(qr, qi, ic_op, cfg.block_len)
        else:
            ir, ii = _conv_ic(qr, qi, ic_op, cfg.subcarriers, cfg.timeslots)
        dr = d0r - ir
        di = d0i - ii
    return dr, di


def _zf(xr, xi, chr_, chi):
    """ZF divide by the channel, |C|^2 clamped at 1e-30; returns y and den."""
    den = torch.clamp(chr_ * chr_ + chi * chi, min=1e-30)
    return (xr * chr_ + xi * chi) / den, (xi * chr_ - xr * chi) / den, den


def _eq_weight(equalizer: str, den, snr, cnr, cnri_t):
    """The equalizer's per-bin weight after ZF (den = |C|^2 clamped), None
    for zf: mmse den / (den + 1 / max(snr, 1e-6)); mmse_cnr cb / (cb + 1),
    cb = max(max(cnr, 0) @ cnri_t, 1e-6). snr (B, 1), cnr (B, n_cnr)."""
    if equalizer == "mmse":
        return den / (den + 1.0 / torch.clamp(snr, min=1e-6))
    if equalizer == "mmse_cnr":
        cb = torch.clamp(torch.clamp(cnr, min=0.0) @ cnri_t, min=1e-6)
        return cb / (cb + 1.0)
    return None


def _rx_core_plain(cfg, k, stacks, pre_r, pre_i, fr_r, fr_i, opts: _RxOptions, ic_op,
                   gdot=None):
    gdot = gdot or _gdot
    n, half = cfg.block_len, 2 * cfg.subcarriers
    n_cnr, met_w = _met_layout(cfg)
    chr_, chi = gdot(pre_r, pre_i, stacks["E_G"], half)
    fr, fi = gdot(pre_r, pre_i, stacks["F2_G"], half)
    p = fr * fr + fi * fi
    sig = p[:, k["sig_idx"]].sum(dim=1, keepdim=True)
    noise = p[:, k["noise_idx"]].sum(dim=1, keepdim=True)
    snr = (sig - noise) / noise
    cnr = p[:, k["sig_idx"]] * (snr / (sig / n_cnr))
    met = torch.zeros(p.shape[0], met_w, dtype=p.dtype, device=p.device)
    met[:, :1] = snr
    met[:, 1 : 1 + n_cnr] = cnr

    xr, xi = gdot(fr_r, fr_i, stacks["F_G"], n)
    yr, yi, den = _zf(xr, xi, chr_, chi)
    w = _eq_weight(opts.equalizer, den, snr, cnr, k["CNRI_T"])
    if w is not None:
        yr, yi = yr * w, yi * w
    d0r, d0i = gdot(yr, yi, stacks["Bfd_G"], n)
    dr, di = _cancel_plain(cfg, k["act"], d0r, d0i, opts, ic_op, gdot)
    return chr_, chi, met, dr, di


def _tx_frame_plain(cfg: GfdmConfig, data: torch.Tensor, shift_index: int = 0,
                    dtype_name: str = "float32", gdot=None):
    """(B, 2 n_data) payload rows -> (B, 2 frame_len) burst rows."""
    k = _kernel_consts(cfg, data.device)
    n, n_d = cfg.block_len, cfg.n_data_symbols
    cp, cs = cfg.cp_len, cfg.cs_len
    shift = int(cfg.cyclic_shifts[shift_index])
    pre = k["preambles"][shift_index]
    core = (gdot or _gdot)(data[:, :n_d], data[:, n_d:],
                           _stacks(cfg, data.device, dtype_name)["T_G"], n_d)
    planes = []
    for p, c in enumerate(core):
        framed = torch.cat([c[:, n - cp - shift :], c, c[:, : cs - shift]], dim=1)
        planes += [pre[p].expand(c.shape[0], -1), framed * k["win"]]
    return torch.cat(planes, dim=1)


def _tx_cdd_plain(cfg: GfdmConfig, data: torch.Tensor):
    """(B, 2 n_data) payload rows -> (B, n_shifts, 2 frame_len): the
    one-port transmitter at every cyclic shift."""
    return torch.stack([_tx_frame_plain(cfg, data, si)
                        for si in range(len(cfg.cyclic_shifts))], dim=1)


def _rx_receiver_plain(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int,
                       ic_mode: str, dtype_name: str = "float32", gdot=None, **options):
    """(B, 2 frame_len) burst rows -> chan (B, 2N), symbols (B, 2N), met.
    ``options``: constellation, equalizer, phase_compensation, qpsk_amp;
    ``gdot``: the Gauss product (default _gdot)."""
    opts = _rx_options(ic_iterations, ic_mode, **options)
    k = _kernel_consts(cfg, bursts.device)
    n, half, L = cfg.block_len, 2 * cfg.subcarriers, cfg.frame_len
    cp, fs = cfg.cp_len, cfg.preamble_len + cfg.cp_len
    chr_, chi, met, dr, di = _rx_core_plain(
        cfg, k, _stacks(cfg, bursts.device, dtype_name),
        bursts[:, cp : cp + half], bursts[:, L + cp : L + cp + half],
        bursts[:, fs : fs + n], bursts[:, L + fs : L + fs + n],
        opts, _ic_operand(cfg, ic_mode, bursts.device, opts.amp), gdot,
    )
    return torch.cat([chr_, chi], dim=1), torch.cat([dr, di], dim=1), met


def _link_single_plain(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int,
                       ic_mode: str, constellation: str = "qpsk", qpsk_amp=None,
                       dtype_name: str = "float32", sum64: bool = False):
    """(B, 2 n_data) payload rows -> data estimate (B, 2 n_data), met.
    ``sum64``: every Gauss product summed in float64 and rounded once
    (_gdot64). With bf16 stacks the next product rounds its activations to
    bf16, and float32 sums in two orders leave a few of them on either side
    of a rounding boundary; the link kernels sum the products whose outputs
    are rounded so (Tx, estimate) in float64, and are held to this."""
    k = _kernel_consts(cfg, data.device)
    gdot = _gdot64 if sum64 else None
    bursts = _tx_frame_plain(cfg, data, 0, dtype_name, gdot)
    _chan, sym, met = _rx_receiver_plain(cfg, bursts, ic_iterations, ic_mode, dtype_name,
                                         gdot, constellation=constellation,
                                         qpsk_amp=qpsk_amp)
    n, idx = cfg.block_len, k["demap_idx"]
    return torch.cat([sym[:, :n][:, idx], sym[:, n:][:, idx]], dim=1), met


def _rx_variant_plain(key: str, cfg: GfdmConfig, x: torch.Tensor, chan, ic_iterations: int,
                      amp: float):
    """The superseded receivers on (B, 2 .) rows: ``x`` is frames (B, 2N)
    with ``chan`` (B, 2N) for rx_core / rx_ic, else bursts (B, 2 frame_len)
    whose channel is estimated. Returns chan (B, 2N), symbols (B, 2N)."""
    k = _kernel_consts(cfg, x.device)
    n, half, L = cfg.block_len, 2 * cfg.subcarriers, cfg.frame_len
    if chan is None:
        cp, fs = cfg.cp_len, cfg.preamble_len + cfg.cp_len
        chr_, chi = _gdot(x[:, cp : cp + half], x[:, L + cp : L + cp + half], k["E_G"], half)
        fr_r, fr_i = x[:, fs : fs + n], x[:, L + fs : L + fs + n]
    else:
        chr_, chi = chan[:, :n], chan[:, n:]
        fr_r, fr_i = x[:, :n], x[:, n:]
    xr, xi = _gdot(fr_r, fr_i, k["F_G"], n)
    yr, yi, _den = _zf(xr, xi, chr_, chi)
    if key == "rx_hybrid":
        fc = planar_fast.fast_consts(cfg, "float32", x.device)
        S = planar_fast._fold_rx(cfg, torch.stack([yr, yi], dim=1), fc)  # (B, K, 2, M)
        d0 = torch.movedim(pmatmul(S, fc["iFM_W"]), -2, -3).reshape(x.shape[0], 2, n)
        d0r, d0i = d0[:, 0], d0[:, 1]
    else:
        d0r, d0i = _gdot(yr, yi, k["Bfd_G"], n)
    opts = _rx_options(ic_iterations, qpsk_amp=amp)
    dr, di = _cancel_plain(cfg, k["act"], d0r, d0i, opts,
                           _ic_operand(cfg, "conv", x.device, amp))
    return torch.cat([chr_, chi], dim=1), torch.cat([dr, di], dim=1)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def _dims(cfg: GfdmConfig, batch: int, opts: _RxOptions | None = None, n_ports: int = 1,
          bf16: bool = False, sum64: bool = False):
    from .cuda_lib import Dims

    opts = opts or _RxOptions(ic_iterations=0)
    n_cnr, met_w = _met_layout(cfg)
    return Dims(
        batch=batch, n=cfg.block_len, n_data=cfg.n_data_symbols,
        timeslots=cfg.timeslots, subcarriers=cfg.subcarriers,
        half=2 * cfg.subcarriers, frame_len=cfg.frame_len,
        preamble_len=cfg.preamble_len, cp_len=cfg.cp_len, cs_len=cfg.cs_len,
        n_ports=n_ports, n_cnr=n_cnr, met_w=met_w,
        ic_iterations=opts.ic_iterations, ic_mode=_IC_MODES[opts.ic_mode],
        dec_kind=_DEC_KINDS[opts.constellation], equalizer=_EQUALIZERS[opts.equalizer],
        phase_comp=int(opts.phase_compensation),
        n_act=cfg.subcarrier_map.size * cfg.timeslots, overlap=cfg.overlap, bf16=int(bf16),
        sum64=int(sum64),
    )


def _consts(**tensors):
    """gfdm::Consts from the named tensors; the fields not given are null."""
    from .cuda_lib import Consts

    return Consts(**{name: t.data_ptr() for name, t in tensors.items()})


def _rx_consts(cfg: GfdmConfig, device, opts: _RxOptions, dtype_name: str = "float32"):
    """The receiver stages' constants (csrc/link.cu)."""
    k, s = _kernel_consts(cfg, device), _stacks(cfg, device, dtype_name)
    ic = "icop" if opts.ic_mode == "matmul" else "taps"
    return dict(e_g=s["E_G"], f_g=s["F_G"], bfd_g=s["Bfd_G"], f2_g=s["F2_G"],
                act=k["act"], sig_idx=k["sig_idx"], noise_idx=k["noise_idx"],
                cnri=k["CNRI_T"], **{ic: _ic_operand(cfg, opts.ic_mode, device, opts.amp)})


def _run(name: str, key: str, dims, consts, *args, device) -> None:
    """Launch ``gfdm_<name>`` on the current stream of ``device`` and count
    it under ``key``; raise if the launch is refused."""
    from .cuda_lib import launch

    def tx_tile(lib):
        return (f"; the Tx tile {TX_TILE} keeps {_tx_tile(lib)[3]} B in shared memory a "
                "CTA")

    launch(f"gfdm_{name}", (ctypes.byref(dims), ctypes.byref(consts), *args),
           device, hint=tx_tile if name == "tx" else None)
    LAUNCHES[key] += 1


def _tx_tile(lib) -> tuple:
    """(bursts, core columns, k-depth, shared bytes) of the library's Tx tile."""
    out = (ctypes.c_int * 4)()
    lib.gfdm_tx_tile(out)
    return tuple(out)


@lru_cache(maxsize=None)
def _check_tx_tile() -> None:
    """Raise unless the built library's Tx tile is ``TX_TILE``."""
    from .cuda_lib import library

    built = _tx_tile(library())[:3]
    if built != TX_TILE:
        raise RuntimeError(f"csrc/tx.cu's tile {built} is not fused.TX_TILE {TX_TILE}")


def _tx_cuda(cfg, data, shift_index=None):
    """One port (``shift_index``) or every port (None) from one Tx launch."""
    _check_tx_tile()
    k = _kernel_consts(cfg, data.device)
    shifts, pre = _shifts(cfg, data.device), k["preambles"]
    if shift_index is not None:
        shifts, pre = shifts[shift_index : shift_index + 1], pre[shift_index]
    ports = shifts.shape[0]
    out = torch.empty(data.shape[0], ports, 2 * cfg.frame_len, dtype=torch.float32,
                      device=data.device)
    consts = _consts(t_g=k["T_G"], win=k["win"], pre=pre, shifts=shifts)
    _run("tx", "tx" if shift_index is not None else "tx_cdd",
         _dims(cfg, data.shape[0], n_ports=ports), consts,
         data.data_ptr(), out.data_ptr(), device=data.device)
    return out


def _run_stages(key: str, plan, dims, consts, io, device, events=None) -> None:
    """Launch each (stage name, stage number, IC iteration) of ``plan`` in
    order on the current stream (csrc/link.cu gfdm_link_stage), counting
    each under ``key``; a refused launch raises, naming the stage and the
    iteration. ``events``: a list that takes a recorded CUDA event before
    each launch and after the last (chip_smoke.py's per-stage times)."""
    from .cuda_lib import launch

    for name, stage, it in plan:
        _record(events)
        launch("gfdm_link_stage",
               (ctypes.byref(dims), ctypes.byref(consts), ctypes.byref(io), stage, it), device,
               hint=lambda lib, name=name, it=it: f" ({key} stage {name}, iteration {it})")
        LAUNCHES[key] += 1
    _record(events)


def _record(events) -> None:
    """Append a CUDA event recorded on the current stream to ``events``
    (a list, or None for no event)."""
    if events is not None:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()


def _burst_windows(cfg: GfdmConfig) -> dict:
    """The two windows the receiver's stages read in each burst row
    (B, 2 frame_len), as (offset, ld, im, width) in floats: row b, plane q,
    column k at ``offset + b ld + q im + k``. "p": the preamble window
    (columns cp .. cp + 2K of each plane), "f": the payload block (columns
    preamble_len + cp .. + N)."""
    L = cfg.frame_len
    return {"p": (cfg.cp_len, 2 * L, L, 2 * cfg.subcarriers),
            "f": (cfg.preamble_len + cfg.cp_len, 2 * L, L, cfg.block_len)}


def _act(t: torch.Tensor, offset: int, ld: int, im: int, width: int):
    """gfdm::lg::Act of a window of the float32 rows of ``t``."""
    from .cuda_lib import Act

    return Act(t.data_ptr() + 4 * offset, ld, im, width)


def _rx_receiver_cuda(cfg, bursts, opts: _RxOptions, events=None, buffers=None):
    """The dense receiver's stages (``_rx_plan``) on the current stream: the
    bursts (B, 2 frame_len) are read in place and never written.
    ``events``: as _run_stages; ``buffers``: a dict that takes the
    intermediates Y, D0, Q and pw (after IC, Q and Y hold decisions)."""
    from .cuda_lib import LinkIO

    dev = bursts.device
    B, n = bursts.shape[0], cfg.block_len
    kw = dict(dtype=torch.float32, device=dev)
    chan, sym = torch.empty(B, 2 * n, **kw), torch.empty(B, 2 * n, **kw)
    met = torch.empty(B, _met_layout(cfg)[1], **kw)
    if B == 0:
        return chan, sym, met
    y, d0, q = (torch.empty(B, 2 * n, **kw) for _ in range(3))
    pw = torch.empty(B, 2 * cfg.subcarriers, **kw)
    consts = _consts(**_rx_consts(cfg, dev, opts))
    win = _burst_windows(cfg)
    io = LinkIO(met=met.data_ptr(), y=y.data_ptr(), d0=d0.data_ptr(), pw=pw.data_ptr(),
                p_in=_act(bursts, *win["p"]), f_in=_act(bursts, *win["f"]),
                chan=chan.data_ptr(), sym=sym.data_ptr(), q=q.data_ptr())
    _run_stages("rx", _rx_plan(opts.ic_iterations, opts.phase_compensation),
                _dims(cfg, B, opts, sum64=True), consts, io, dev, events)
    if buffers is not None:
        buffers.update(y=y, d0=d0, q=q, pw=pw)
    return chan, sym, met


def _inv_demap(cfg: GfdmConfig, device) -> torch.Tensor:
    """(N,) int32: the payload index of each frame position, -1 elsewhere
    (the link's last stage scatters through it in place of the gather)."""
    def build():
        idx = _small_consts(cfg, "float32")["demap_idx"]
        inv = np.full(cfg.block_len, -1, dtype=np.int32)
        inv[idx] = np.arange(idx.size, dtype=np.int32)
        return _to_tensor(inv, device)

    return _extra(cfg, device, "inv_demap", build)


def _link_operands(cfg: GfdmConfig, device, opts: _RxOptions, dtype_name: str) -> dict:
    """The link stages' constants (gfdm::Consts fields): the host's Gauss
    stacks as built, unpadded (the kernels zero-fill ragged slabs), the
    window, the shift-0 preamble and the receiver's small constants."""
    k = _kernel_consts(cfg, device)
    return dict(t_g=_stacks(cfg, device, dtype_name)["T_G"], win=k["win"],
                pre=k["preambles"][0], **_rx_consts(cfg, device, opts, dtype_name))


def _link_single_cuda(cfg, data, opts: _RxOptions, dtype_name: str, events=None,
                      buffers=None):
    """The link's stages on the current stream (csrc/link.cu). ``events``: a
    list that takes a recorded CUDA event before each launch and after the
    last (chip_smoke.py's per-stage times); ``buffers``: a dict that takes
    the intermediates F, Y, D0 and each burst's preamble window P (with IC,
    F and Y end holding decisions)."""
    from .cuda_lib import Act, LinkIO

    dev = data.device
    B, n = data.shape[0], cfg.block_len
    kw = dict(dtype=torch.float32, device=dev)
    out = torch.empty(B, 2 * cfg.n_data_symbols, **kw)
    met = torch.empty(B, _met_layout(cfg)[1], **kw)
    if B == 0:
        return out, met
    f, y, d0 = (torch.empty(B, 2 * n, **kw) for _ in range(3))
    pw = torch.empty(B, 2 * cfg.subcarriers, **kw)
    pre = torch.empty(B, 4 * cfg.subcarriers, **kw)
    consts = _consts(**_link_operands(cfg, dev, opts, dtype_name))
    half = 2 * cfg.subcarriers
    io = LinkIO(data=data.data_ptr(), out=out.data_ptr(), met=met.data_ptr(),
                f=f.data_ptr(), y=y.data_ptr(), d0=d0.data_ptr(), pw=pw.data_ptr(),
                pre=pre.data_ptr(), inv_demap=_inv_demap(cfg, dev).data_ptr(),
                p_in=Act(pre.data_ptr(), 2 * half, half, half),
                f_in=Act(f.data_ptr(), 2 * n, n, n))
    _run_stages("link", _link_plan(opts.ic_iterations),
                _dims(cfg, B, opts, bf16=dtype_name == "bfloat16"), consts, io, dev, events)
    if buffers is not None:
        buffers.update(f=f, y=y, d0=d0, pre=pre)
    return out, met


def _link_stages(cfg: GfdmConfig, data: torch.Tensor, dtype_name: str = "float32") -> dict:
    """The link kernels' product stages on the card beside the plain
    version's same stages on the kernel's own inputs: {stage: (kernel
    output, reference)} for "tx" (the payload block F), "est_zf" (the
    equalized spectrum Y, from each burst's preamble window P) and "demod"
    (D0). data: (B, 2 n_data) rows on the card."""
    bufs = {}
    _link_single_cuda(cfg, data, _rx_options(0, "matmul"), dtype_name, buffers=bufs)
    n, nd, half, cp = cfg.block_len, cfg.n_data_symbols, 2 * cfg.subcarriers, cfg.cp_len
    k, st = _kernel_consts(cfg, data.device), _stacks(cfg, data.device, dtype_name)
    f, y = bufs["f"], bufs["y"]
    win = k["win"][cp : cp + n].repeat(2)

    def prod(x, g, n_in):
        return torch.cat(_gdot(x[:, :n_in], x[:, n_in:], g, n_in), 1)

    chan = prod(bufs["pre"], st["E_G"], half)
    x = prod(f, st["F_G"], n)
    yr, yi, _den = _zf(x[:, :n], x[:, n:], chan[:, :n], chan[:, n:])
    return {"tx": (f, prod(data, st["T_G"], nd) * win),
            "est_zf": (y, torch.cat([yr, yi], 1)),
            "demod": (bufs["d0"], prod(y, st["Bfd_G"], n))}


def _stage_errors(stages: dict) -> dict:
    """{stage: (kernel output, reference)} -> each stage's error per burst,
    relative to the reference's largest magnitude."""
    return {name: (got - ref).abs().amax(dim=1) / ref.abs().max()
            for name, (got, ref) in stages.items()}


def _link_stage_errors(cfg: GfdmConfig, data: torch.Tensor, dtype_name: str = "float32"):
    """Each product stage of the link kernels against the plain stage on
    the kernel's own inputs, per burst, relative to the stage's largest
    magnitude: on identical inputs no activation can round to bf16 on
    another side, so this holds each stage's arithmetic apart from the
    rest of the chain, whatever the stacks' type."""
    return _stage_errors(_link_stages(cfg, data, dtype_name))


def _rx_stages(cfg: GfdmConfig, bursts: torch.Tensor, equalizer: str = "zf") -> dict:
    """The dense receiver's product stages on the card beside the plain
    version's same stages (summed in float64, as the kernels sum them) on the
    kernel's own inputs: {stage: (kernel output, reference)} for "pre_dft"
    (the preamble power pw), "chan", "est_zf" (Y, the equalizer's weight from
    the kernel's own metrics) and "demod" (D0, from the kernel's Y). bursts:
    (B, 2 frame_len) rows on the card."""
    bufs = {}
    chan, _sym, met = _rx_receiver_cuda(cfg, bursts, _rx_options(0, equalizer=equalizer),
                                        buffers=bufs)
    k, st = _kernel_consts(cfg, bursts.device), _stacks(cfg, bursts.device)
    n, half, n_cnr = cfg.block_len, 2 * cfg.subcarriers, _met_layout(cfg)[0]

    def window(name):
        off, _ld, im, width = _burst_windows(cfg)[name]
        return bursts[:, off : off + width], bursts[:, im + off : im + off + width]

    def prod(x, g, n_in):
        return torch.cat(_gdot64(*x, g, n_in), 1)

    pre, frame = window("p"), window("f")
    p = prod(pre, st["F2_G"], half)
    rchan = prod(pre, st["E_G"], half)
    x = prod(frame, st["F_G"], n)
    yr, yi, den = _zf(x[:, :n], x[:, n:], rchan[:, :n], rchan[:, n:])
    w = _eq_weight(equalizer, den, met[:, :1], met[:, 1 : 1 + n_cnr], k["CNRI_T"])
    y = torch.cat([yr, yi], 1) if w is None else torch.cat([yr * w, yi * w], 1)
    return {"pre_dft": (bufs["pw"], p[:, :half] ** 2 + p[:, half:] ** 2),
            "chan": (chan, rchan), "est_zf": (bufs["y"], y),
            "demod": (bufs["d0"], prod((bufs["y"][:, :n], bufs["y"][:, n:]), st["Bfd_G"], n))}


def _rx_stage_errors(cfg: GfdmConfig, bursts: torch.Tensor, equalizer: str = "zf") -> dict:
    """Each product stage of the dense receiver against the plain stage on
    the kernel's own inputs (_rx_stages), per burst, relative to the
    stage's largest magnitude."""
    return _stage_errors(_rx_stages(cfg, bursts, equalizer))


def _tf32_split_cuda(x: torch.Tensor):
    """The kernels' device split (csrc/link.cu tf32_split) of a float32
    CUDA tensor: (hi, lo)."""
    from .cuda_lib import launch

    x = x.contiguous()
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    launch("gfdm_tf32_split", (x.numel(), x.data_ptr(), hi.data_ptr(), lo.data_ptr()),
           x.device)
    return hi, lo


def _rx_variant_cuda(key: str, cfg, x, chan, ic_iterations: int, amp: float, events=None):
    """As _rx_variant_plain; the channel is None for rx_full, which writes
    only the symbols. One launch a stage of ``_variant_plan`` on the current
    stream, each counted under ``key``; the estimate writes the channel
    (rx_hybrid's output), DFT + ZF the equalized spectrum Y, the
    demodulator D0 (the symbols where no IC follows), all (B, 2N).
    ``events``: as _run_stages."""
    from .cuda_lib import launch

    dev = x.device
    B, n = x.shape[0], cfg.block_len
    kw = dict(dtype=torch.float32, device=dev)
    sym = torch.empty(B, 2 * n, **kw)
    plan = _variant_plan(key, ic_iterations)
    chan_buf = chan if chan is not None else torch.empty(B, 2 * n, **kw)
    out_chan = chan_buf if key == "rx_hybrid" else chan
    if B == 0:
        return out_chan, sym
    y = torch.empty(B, 2 * n, **kw)
    d0 = torch.empty(B, 2 * n, **kw) if plan[-1][0] == "cancel" else sym
    k = _kernel_consts(cfg, dev)
    tabs = {}
    if key == "rx_hybrid":
        fc = planar_fast.fast_consts(cfg, "float32", dev)
        tabs = dict(parts=fc["rx_parts"], ifm=fc["iFM_W"])
    consts = _consts(e_g=k["E_G"], f_g=k["F_G"], bfd_g=k["Bfd_G"], act=k["act"],
                     taps=_ic_operand(cfg, "conv", dev, amp), **tabs)
    dims = _dims(cfg, B, _rx_options(ic_iterations, qpsk_amp=amp))

    def hint(lib):
        return (f"; a superseded receiver takes a config whose one-burst state, "
                f"{lib.gfdm_rx_smem_bytes(ctypes.byref(dims))} B, fits a CTA's shared "
                "memory, so a larger N = M*K takes rx_receiver_factored")

    for _name, stage, _it in plan:
        _record(events)
        launch("gfdm_rx_variant",
               (ctypes.byref(dims), ctypes.byref(consts), x.data_ptr(), chan_buf.data_ptr(),
                y.data_ptr(), d0.data_ptr(), sym.data_ptr(), _VARIANTS[key], stage), dev,
               hint=hint)
        LAUNCHES[key] += 1
    _record(events)
    return out_chan, sym


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def _on_cuda(x: torch.Tensor, cols: int, fn: str) -> bool:
    """Validate a (B, 2, cols) float32 contiguous input; True on CUDA."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{fn}: expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim != 3 or tuple(x.shape[1:]) != (2, cols):
        raise ValueError(f"{fn}: expected shape (B, 2, {cols}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{fn}: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: expected a contiguous tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device.type == "cuda"


def tx_frame_fused(cfg: GfdmConfig, data: torch.Tensor, shift_index: int = 0):
    """Fused Tx chain for one cyclic shift.

    data: (B, 2, n_data) planar payload -> (B, 2, frame_len) planar burst.
    Equivalent to transmit_planar(cfg, data)[:, shift_index].
    """
    cuda = _on_cuda(data, cfg.n_data_symbols, "tx_frame_fused")
    flat = data.reshape(data.shape[0], -1)
    if cuda:
        out = _tx_cuda(cfg, flat, shift_index)
    else:
        out = _tx_frame_plain(cfg, flat, shift_index)
    return out.reshape(data.shape[0], 2, cfg.frame_len)


def tx_cdd_fused(cfg: GfdmConfig, data: torch.Tensor):
    """Fused multi-port Tx: every cyclic-delay-diversity shift in one kernel.

    data: (B, 2, n_data) planar payload -> (B, n_shifts, 2, frame_len).
    Equivalent to transmit_planar(cfg, data); the core frame is modulated
    once and cut into every port's CP/CS, window and preamble.
    """
    cuda = _on_cuda(data, cfg.n_data_symbols, "tx_cdd_fused")
    flat = data.reshape(data.shape[0], -1)
    out = _tx_cuda(cfg, flat) if cuda else _tx_cdd_plain(cfg, flat)
    return out.reshape(data.shape[0], len(cfg.cyclic_shifts), 2, cfg.frame_len)


def rx_receiver_fused(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int = 2,
                      qpsk_amp: float | None = None, constellation: str = "qpsk",
                      phase_compensation: bool = False, equalizer: str = "zf",
                      ic_mode: str = "conv"):
    """Whole receiver core (channel est + SNR/CNR + equalizer + demod + IC).

    bursts: (B, 2, frame_len) planar -> (channel (B, 2, N), symbols
    (B, 2, N), metrics (B, met_w) = [snr_lin | scaled cnrs | 0-pad]).
    equalizer "zf", "mmse" (per-bin shrinkage by the estimated SNR) or
    "mmse_cnr" (by the per-bin interpolated CNR); IC decisions of
    ``constellation`` ("qpsk", "qam16", "qam64") at amplitude ``qpsk_amp``
    (default: the constellation's); ``phase_compensation`` corrects a common
    phase offset once, before the first cancellation (ic_iterations > 0).
    On a CUDA tensor it runs the staged tensor-core stages of csrc/link.cu
    (``rx_launches(ic_iterations, phase_compensation)`` launches, any batch
    in 128-burst tiles; float32-stack products summed in float64), reading
    the bursts in place; a config whose dense
    operators exceed 256 MiB a stack (K = 1024 at M = 9) raises ValueError:
    it takes rx_receiver_factored.
    """
    opts = _rx_options(ic_iterations, ic_mode, constellation, equalizer,
                       phase_compensation, qpsk_amp)
    cuda = _on_cuda(bursts, cfg.frame_len, "rx_receiver_fused")
    flat = bursts.reshape(bursts.shape[0], -1)
    if cuda:
        _check_dense_size(cfg, "rx_receiver_fused", "rx_receiver_factored")
        chan, sym, met = _rx_receiver_cuda(cfg, flat, opts)
    else:
        chan, sym, met = _rx_receiver_plain(
            cfg, flat, opts.ic_iterations, opts.ic_mode, constellation=constellation,
            equalizer=equalizer, phase_compensation=opts.phase_compensation,
            qpsk_amp=opts.amp)
    B, n = bursts.shape[0], cfg.block_len
    return chan.reshape(B, 2, n), sym.reshape(B, 2, n), met


def receive_bursts_fused(cfg: GfdmConfig, bursts: torch.Tensor,
                         ic_iterations: int = 2, constellation: str = "qpsk",
                         equalizer: str = "zf"):
    """Production receive path: the receiver kernel + a torch demap gather.

    bursts: (B, 2, frame_len) planar, aligned at the full-preamble start.
    Returns the dict of planar_pipeline.receive_bursts_planar.
    """
    chan, symbols, met = rx_receiver_fused(
        cfg, bursts, ic_iterations=ic_iterations, constellation=constellation,
        equalizer=equalizer,
    )
    n_cnr, _ = _met_layout(cfg)
    idx = _kernel_consts(cfg, bursts.device)["demap_idx"]
    return {
        "data": symbols[..., idx],
        "symbols": symbols,
        "channel": chan,
        "snr_lin": met[:, 0],
        "cnrs": met[:, 1 : 1 + n_cnr],
    }


def link_step_fused(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int = 2):
    """Fused end-to-end link: payload -> Tx kernel -> receiver kernel.

    Same contract as planar_pipeline.link_step_planar (shift 0, ZF, QPSK).
    """
    bursts = tx_frame_fused(cfg, data)
    out = receive_bursts_fused(cfg, bursts, ic_iterations=ic_iterations)
    return out["data"], out["snr_lin"], evm(out["data"], data)


def link_single_fused(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int = 2,
                      qpsk_amp: float | None = None, dtype_name: str = "float32",
                      constellation: str = "qpsk", ic_mode: str = "conv"):
    """End-to-end loopback link: payload -> Tx -> burst -> Rx -> data.

    data: (B, 2, n_data) planar payload. Returns (data_hat (B, 2, n_data),
    snr_lin (B,), evm scalar) - the link_step_fused contract. On a CUDA
    tensor it runs the staged tensor-core kernels of csrc/link.cu
    (``link_launches(ic_mode, ic_iterations)`` launches); the framed burst
    never leaves the device, its payload block goes straight to the
    receiver. ``dtype_name="bfloat16"`` runs the five Gauss products with
    bf16 stacks and bf16-rounded activations (float32 accumulation);
    ``constellation`` sets the IC decisions and amplitude. A config whose
    dense operators exceed 256 MiB a stack (K = 1024 at M = 9) raises
    ValueError: it takes link_step_factored.
    """
    with span("gfdm.link.step"):
        opts = _rx_options(ic_iterations, ic_mode, constellation, qpsk_amp=qpsk_amp)
        _choice("dtype_name", dtype_name, _DTYPES)
        _check_dense_size(cfg, "link_single_fused", "link_step_factored")
        cuda = _on_cuda(data, cfg.n_data_symbols, "link_single_fused")
        flat = data.reshape(data.shape[0], -1)
        if cuda:
            out, met = _link_single_cuda(cfg, flat, opts, dtype_name)
        else:
            out, met = _link_single_plain(cfg, flat, opts.ic_iterations, ic_mode,
                                          constellation, opts.amp, dtype_name)
        d_hat = out.reshape(data.shape)
        return d_hat, met[:, 0], evm(d_hat, data)


def _rx_variant(key: str, cfg: GfdmConfig, x: torch.Tensor, chan, ic_iterations: int,
                qpsk_amp: float):
    """Validate and run one superseded receiver; returns chan, symbols as
    (B, 2, N)."""
    cols = cfg.block_len if chan is not None else cfg.frame_len
    cuda = _on_cuda(x, cols, key)
    if chan is not None and (_on_cuda(chan, cfg.block_len, key) != cuda
                             or chan.shape[0] != x.shape[0]):
        raise ValueError(f"{key}: frames and channel must share batch and device")
    B = x.shape[0]
    flat = x.reshape(B, -1)
    cflat = None if chan is None else chan.reshape(B, -1)
    run = _rx_variant_cuda if cuda else _rx_variant_plain
    c, s = run(key, cfg, flat, cflat, int(ic_iterations), float(qpsk_amp))
    n = cfg.block_len
    return None if c is None else c.reshape(B, 2, n), s.reshape(B, 2, n)


def rx_core_fused(cfg: GfdmConfig, frames: torch.Tensor, channel: torch.Tensor):
    """Fused ZF receiver core.

    frames, channel: (B, 2, N) planar -> (B, 2, N) planar symbol estimates:
    block DFT, ZF divide (|C|^2 clamped at 1e-30), FD demodulation.
    """
    return _rx_variant("rx_core", cfg, frames, channel, 0, _QPSK_AMP)[1]


def rx_ic_fused(cfg: GfdmConfig, frames: torch.Tensor, channel: torch.Tensor,
                ic_iterations: int = 2, qpsk_amp: float = _QPSK_AMP):
    """Fused ZF + IC receiver core: rx_core_fused, then ``ic_iterations``
    QPSK-decision interference-cancellation passes at ``qpsk_amp``.

    frames, channel: (B, 2, N) planar -> (B, 2, N) planar symbols.
    """
    return _rx_variant("rx_ic", cfg, frames, channel, ic_iterations, qpsk_amp)[1]


def rx_full_fused(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int = 2,
                  qpsk_amp: float = _QPSK_AMP):
    """Whole ZF + QPSK-IC receiver core from bursts (the channel estimated
    inside): (B, 2, frame_len) planar -> (B, 2, N) planar symbols. No SNR
    metrics."""
    return _rx_variant("rx_full", cfg, bursts, None, ic_iterations, qpsk_amp)[1]


def rx_receiver_hybrid(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int = 2,
                       qpsk_amp: float = _QPSK_AMP):
    """One-kernel receiver with the dense block DFT and, in place of the
    dense FD demodulator, the L-tap filter fold and per-subcarrier M-point
    IDFTs: (B, 2, frame_len) planar -> (channel (B, 2, N), symbols
    (B, 2, N)), QPSK IC at ``qpsk_amp``."""
    return _rx_variant("rx_hybrid", cfg, bursts, None, ic_iterations, qpsk_amp)


# ---------------------------------------------------------------------------
# factored kernels (large K): host constants
# ---------------------------------------------------------------------------
@lru_cache(maxsize=32)
def _ftaps_np(cfg: GfdmConfig, amp: float) -> np.ndarray:
    """(2, M) IC taps of the factored receivers: column 0 of the circulant
    C times the amplitude ``amp``, folded in float64 and rounded once, as the
    JAX package folds its factored kernels' taps (the dense kernels' conv
    ``taps`` round c to float32 first)."""
    c_col = operators._interference_matrix(cfg)[:, 0]
    return np.stack([c_col.real * amp, c_col.imag * amp]).astype(np.float32)


@lru_cache(maxsize=16)
def _factored_np(cfg: GfdmConfig) -> dict:
    """Host constants of the factored kernels beyond planar_fast's tables.

    ``ftaps`` (2, M): :func:`_ftaps_np` at the QPSK amplitude.
    ``map_idx`` (N,): frame position -> payload index from the nonzeros of
    the mapping matrix (n_data, a zero sentinel, elsewhere), as the JAX
    ``tx_frame_factored`` builds its gather.
    """
    ftaps = _ftaps_np(cfg, _QPSK_AMP)
    map_idx = np.full(cfg.block_len, cfg.n_data_symbols, dtype=np.int32)
    rows, cols = np.nonzero(operators.mapping_matrix(cfg).real)
    map_idx[rows] = cols
    return {"ftaps": ftaps, "map_idx": map_idx}


_FACTORED_CONSTS: dict = {}


def _factored_consts(cfg: GfdmConfig, device) -> dict:
    """Constants of the factored kernels and their plain versions on
    ``device``, built once per (config, device): planar_fast's K- and
    M-point tables, twiddles and filter parts, the IC taps, the Tx map,
    window and preambles. No O(N^2) operator; the dense estimator ``E_W``
    of ``estimator="fused"`` is added on first use (:func:`_estimator_op`)."""
    device = torch.device(device)
    key = (cfg, str(device))
    hit = _FACTORED_CONSTS.get(key)
    if hit is not None:
        return hit
    small = _small_consts(cfg, "float32")
    arrays = {**_factored_np(cfg), **{name: small[name] for name in (
        "win", "preambles", "cp_idx", "demap_idx",
    )}}
    arrays["act"] = np.repeat(small["active"].astype(np.float32), cfg.timeslots)
    k = {name: _to_tensor(a, device) for name, a in arrays.items()}
    k.update(planar_fast.fast_consts(cfg, "float32", device))
    _FACTORED_CONSTS[key] = k
    return k


def _factored_taps(cfg: GfdmConfig, device, amp: float = _QPSK_AMP) -> torch.Tensor:
    """The factored receivers' IC taps at ``amp`` on ``device``: the cached
    QPSK ones, or built on first use and cached per amplitude."""
    if float(amp) == _QPSK_AMP:
        return _factored_consts(cfg, device)["ftaps"]
    return _extra(cfg, device, ("ftaps", float(amp)),
                  lambda: _to_tensor(_ftaps_np(cfg, float(amp)), device))


def _estimator_op(cfg: GfdmConfig, device) -> torch.Tensor:
    """The dense (4K, 2N) realified channel estimator of estimator="fused"
    (4.7 MB at K = 128, 302 MB at K = 1024), built on first use."""
    k = _factored_consts(cfg, device)
    if "E_W" not in k:
        E = real_operator(operators.channel_estimation_operator(cfg).T, np.float32)
        k["E_W"] = _to_tensor(E, device)
    return k["E_W"]


# ---------------------------------------------------------------------------
# factored kernels: plain torch versions, stage by stage
# ---------------------------------------------------------------------------
def _zf_clamped(X: torch.Tensor, chan: torch.Tensor) -> torch.Tensor:
    """ZF divide X / chan with |chan|^2 clamped at 1e-30 (planar (..., 2, N));
    ``planar_fast.demod_fast`` divides unclamped."""
    den = torch.clamp(pabs2(chan), min=1e-30)[..., None, :]
    return pmul(X, pconj(chan)) / den


def _ic_factored(cfg: GfdmConfig, k: dict, d0: torch.Tensor, ic_iterations: int,
                 taps: torch.Tensor | None = None):
    """Circulant QPSK IC on (B, 2, N) symbols: ``ic_iterations`` of
    d = d0 - interference(+-1 decisions on active symbols), the amplitude
    folded into ``taps`` (default: the QPSK ones, ``k["ftaps"]``)."""
    B, n = d0.shape[0], cfg.block_len
    taps = k["ftaps"] if taps is None else taps
    d0r, d0i = d0[:, 0], d0[:, 1]
    dr, di = d0r, d0i
    for _ in range(ic_iterations):
        qr = torch.where(dr >= 0, 1.0, -1.0) * k["act"]
        qi = torch.where(di >= 0, 1.0, -1.0) * k["act"]
        ir, ii = _conv_ic(qr, qi, taps, cfg.subcarriers, cfg.timeslots)
        dr, di = d0r - ir, d0i - ii
    return torch.stack([dr.reshape(B, n), di.reshape(B, n)], dim=1)


def _rx_estimate_plain(cfg: GfdmConfig, bursts: torch.Tensor) -> torch.Tensor:
    """The dense channel estimate (B, 2, N) = pre2 @ E_W, pre2 the (B, 4K)
    preamble window [re | im] of each burst."""
    B, K = bursts.shape[0], cfg.subcarriers
    pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(B, 4 * K)
    return (pre2 @ _estimator_op(cfg, bursts.device)).reshape(B, 2, cfg.block_len)


def _rx_factored_plain(cfg: GfdmConfig, bursts: torch.Tensor, chan, ic_iterations: int,
                       amp: float = _QPSK_AMP):
    """(B, 2, frame_len) bursts [+ (B, 2, N) channel] -> chan, symbols (B, 2, N).

    chan=None estimates it with the dense E_W (:func:`_rx_estimate_plain`);
    the IC decisions have the amplitude ``amp``."""
    k = _factored_consts(cfg, bursts.device)
    B, n = bursts.shape[0], cfg.block_len
    if chan is None:
        chan = _rx_estimate_plain(cfg, bursts)
    fs = cfg.preamble_len + cfg.cp_len
    X = planar_fast.fast_fft_n(cfg, bursts[..., fs : fs + n], k)  # natural order
    S = planar_fast._fold_rx(cfg, _zf_clamped(X, chan), k)  # (B, K, 2, M)
    d0 = pmatmul(S, k["iFM_W"])  # per-subcarrier M-point IFFT
    d0 = torch.movedim(d0, -2, -3).reshape(B, 2, n)
    return chan, _ic_factored(cfg, k, d0, ic_iterations,
                              _factored_taps(cfg, bursts.device, amp))


def _tx_factored_plain(cfg: GfdmConfig, data: torch.Tensor, shift_index: int):
    """(B, 2, n_data) payload -> (B, 2, frame_len) bursts."""
    k = _factored_consts(cfg, data.device)
    zero = torch.zeros(data.shape[:-1] + (1,), dtype=data.dtype, device=data.device)
    grid = torch.cat([data, zero], dim=-1)[..., k["map_idx"]]
    core = planar_fast.modulate_core_fast(cfg, grid, k)
    framed = core[..., k["cp_idx"][shift_index]] * k["win"]
    pre = k["preambles"][shift_index].expand(data.shape[0], 2, cfg.preamble_len)
    return torch.cat([pre, framed], dim=-1)


# ---------------------------------------------------------------------------
# factored kernels: CUDA launches
# ---------------------------------------------------------------------------
def _factored_dims(cfg: GfdmConfig, batch: int, shift: int = 0, ic_iterations: int = 0):
    from .cuda_lib import FactoredDims

    return FactoredDims(
        batch=batch, n=cfg.block_len, timeslots=cfg.timeslots,
        subcarriers=cfg.subcarriers, overlap=cfg.overlap,
        n_data=cfg.n_data_symbols, frame_len=cfg.frame_len,
        preamble_len=cfg.preamble_len, cp_len=cfg.cp_len, shift=shift,
        ic_iterations=ic_iterations,
    )


def _factored_ptrs(k: dict, tx: bool, shift_index: int = 0, taps=None):
    from .cuda_lib import FactoredConsts

    taps = k["ftaps"] if taps is None else taps
    return FactoredConsts(
        fk=k["iFK_W" if tx else "FK_W"].data_ptr(),
        tw=k["itw" if tx else "tw"].data_ptr(),
        fm=k["FM_W"].data_ptr(), ifm=k["iFM_W"].data_ptr(),
        parts=k["tx_parts" if tx else "rx_parts"].data_ptr(),
        taps=taps.data_ptr(), act=k["act"].data_ptr(),
        map_idx=k["map_idx"].data_ptr(), win=k["win"].data_ptr(),
        pre=k["preambles"][shift_index].data_ptr(),
    )


def _run_factored(name: str, dims, args: tuple, device, counts=None) -> None:
    """Launch ``gfdm_<name>`` (``args`` after the dims) and count it under
    each key of ``counts`` (default: ``name``) unless the batch is empty (the
    library launches nothing then); a refused launch raises, naming the
    kernel and the shared memory its one-burst CTA needs."""
    from .cuda_lib import launch

    def tile(lib):
        if name == "rx_estimate":
            return f"; the estimator GEMM, B={dims.batch}, 2N={2 * dims.n}"
        nbytes = lib.gfdm_factored_smem_bytes(ctypes.byref(dims))
        return (f"; the {name} kernel keeps {nbytes} B in shared memory a CTA "
                f"(one burst, K={dims.subcarriers}, M={dims.timeslots})")

    launch(f"gfdm_{name}", (ctypes.byref(dims), *args), device, hint=tile)
    if dims.batch > 0:
        for key in counts or (name,):
            LAUNCHES[key] += 1


def _tx_factored_cuda(cfg: GfdmConfig, data: torch.Tensor, shift_index: int):
    k = _factored_consts(cfg, data.device)
    out = torch.empty(data.shape[0], 2, cfg.frame_len, dtype=torch.float32,
                      device=data.device)
    dims = _factored_dims(cfg, data.shape[0], shift=int(cfg.cyclic_shifts[shift_index]))
    _run_factored("tx_factored", dims,
                  (ctypes.byref(_factored_ptrs(k, True, shift_index)), data.data_ptr(),
                   out.data_ptr()), data.device)
    return out


def _rx_estimate_cuda(cfg: GfdmConfig, bursts: torch.Tensor) -> torch.Tensor:
    """The estimator GEMM alone (one launch, counted under "rx_factored"):
    chan (B, 2, N) = pre2 @ E_W from the bursts' preamble windows."""
    chan = torch.empty(bursts.shape[0], 2, cfg.block_len, dtype=torch.float32,
                       device=bursts.device)
    _run_factored("rx_estimate", _factored_dims(cfg, bursts.shape[0]),
                  (bursts.data_ptr(), _estimator_op(cfg, bursts.device).data_ptr(),
                   chan.data_ptr()), bursts.device, counts=("rx_factored",))
    return chan


def _rx_factored_cuda(cfg: GfdmConfig, bursts: torch.Tensor, chan, ic_iterations: int,
                      amp: float = _QPSK_AMP):
    """chan=None: the estimator GEMM, then the receiver on the channel it
    wrote (two launches of one library call, counted under "rx_factored" and
    "rx_factored_chan"); else the receiver on ``chan``."""
    k = _factored_consts(cfg, bursts.device)
    B, n = bursts.shape[0], cfg.block_len
    opts = dict(dtype=torch.float32, device=bursts.device)
    sym = torch.empty(B, 2, n, **opts)
    dims = _factored_dims(cfg, B, ic_iterations=ic_iterations)
    consts = ctypes.byref(_factored_ptrs(k, False, taps=_factored_taps(cfg, bursts.device, amp)))
    if chan is None:
        chan = torch.empty(B, 2, n, **opts)
        _run_factored("rx_factored", dims,
                      (consts, bursts.data_ptr(), _estimator_op(cfg, bursts.device).data_ptr(),
                       chan.data_ptr(), sym.data_ptr()), bursts.device,
                      counts=("rx_factored", "rx_factored_chan"))
    else:
        _run_factored("rx_factored_chan", dims,
                      (consts, bursts.data_ptr(), chan.data_ptr(), sym.data_ptr()),
                      bursts.device)
    return chan, sym


# ---------------------------------------------------------------------------
# factored kernels: public wrappers
# ---------------------------------------------------------------------------
def tx_frame_factored(cfg: GfdmConfig, data: torch.Tensor, shift_index: int = 0):
    """Factorized one-kernel Tx for large K.

    data: (B, 2, n_data) planar payload -> (B, 2, frame_len) planar burst,
    the contract of tx_frame_fused, but no dense Tx operator exists at any
    K: the map, the modulator (per-subcarrier M-FFT, L-tap overlap-add,
    Cooley-Tukey N-IFFT), the output reorder, CP/CS, window and preamble
    all run in the kernel.
    """
    cuda = _on_cuda(data, cfg.n_data_symbols, "tx_frame_factored")
    run = _tx_factored_cuda if cuda else _tx_factored_plain
    return run(cfg, data, shift_index)


def rx_receiver_factored(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int = 2,
                         qpsk_amp: float = _QPSK_AMP, estimator: str = "fused"):
    """Factorized one-kernel receiver (channel est + ZF + demod + QPSK IC).

    bursts: (B, 2, frame_len) planar -> (channel (B, 2, N), symbols
    (B, 2, N)). The block DFT runs as K-point DFTs plus a twiddled M-point
    stage, the FD demod as an L-tap fold plus per-subcarrier M-point IFFTs.
    The IC decisions are +-``qpsk_amp`` (folded into the IC taps).

    estimator:
      "fused" - channel estimated by the dense (4K, 2N) operator E_W in a
                GEMM launch of its own, then read by the receiver kernel
                (K <= ~128: E_W takes 302 MB at K = 1024);
      "fast"  - channel estimated outside by the O(K^2) factorized torch-op
                estimator (ops.planar_fast.estimate_channel_fast) and read
                by the kernel; no dense operator of any kind.
    """
    if estimator not in ("fused", "fast"):
        raise ValueError(f"estimator must be 'fused' or 'fast', got {estimator!r}")
    cuda = _on_cuda(bursts, cfg.frame_len, "rx_receiver_factored")
    chan = _fast_channel(cfg, bursts) if estimator == "fast" else None
    run = _rx_factored_cuda if cuda else _rx_factored_plain
    return run(cfg, bursts, chan, int(ic_iterations), float(qpsk_amp))


def _fast_channel(cfg: GfdmConfig, bursts: torch.Tensor) -> torch.Tensor:
    """The channel estimator="fast" hands the receiver kernel: the
    factorized torch-op estimate from the bursts' preamble, (B, 2, N)."""
    pre = bursts[..., cfg.cp_len : cfg.cp_len + 2 * cfg.subcarriers]
    fc = planar_fast.fast_consts(cfg, "float32", bursts.device)
    return planar_fast.estimate_channel_fast(cfg, pre, fc).contiguous()


def link_step_factored(cfg: GfdmConfig, data: torch.Tensor, ic_iterations: int = 2,
                       estimator: str = "fast"):
    """Large-K link: payload -> factored Tx kernel -> factored receiver ->
    demap. Returns (data_hat (B, 2, n_data), evm); with estimator="fast" the
    link of ``benchmarks/largek_crossover.py``'s link mode."""
    with span("gfdm.link.step"):
        bursts = tx_frame_factored(cfg, data)
        _chan, sym = rx_receiver_factored(cfg, bursts, ic_iterations=ic_iterations,
                                          estimator=estimator)
        d_hat = sym[..., _factored_consts(cfg, data.device)["demap_idx"]]
        return d_hat, evm(d_hat, data)
