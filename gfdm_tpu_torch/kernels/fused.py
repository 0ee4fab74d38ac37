"""Fused GFDM kernels: transmitter, receiver and one-kernel link.

The port of ``gfdm_tpu.kernels.fused`` (the Pallas kernels ``_tx_kernel``,
``_rx_ic_circ_kernel`` and ``_link_kernel``). Each kernel is CUDA C++ for
Hopper in ``gfdm_tpu_torch/csrc`` (built by :mod:`.cuda_lib`) and has a plain
torch version here that computes the same thing the same way: the Gauss
3-product stacks, the ZF denominator clamped at 1e-30, QPSK decisions
``>= 0 -> +1`` zeroed off the active subcarriers, the metrics row
``[snr_lin | cnrs | 0-pad]`` and, in ``ic_mode="matmul"``, the bf16
interference operator upcast to float32.

The large-K factored pair (``_tx_factored_kernel``, ``_rx_factored_kernel``,
``_rx_factored_chan_kernel``; ``csrc/factored.cu``) carries no dense
operator: the N-point (I)DFT is K-point DFTs plus a twiddled M-point stage,
the filter fold / overlap-add are L taps, the per-subcarrier M-point
transforms are M-point products. Their plain versions are the stages of
:mod:`..ops.planar_fast` with the kernels' ZF clamp and circulant IC.

Dispatch: a wrapper runs the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises. ``LAUNCHES`` counts the
kernel launches of each wrapper.

Layouts match the JAX package: payload (B, 2, n_data), bursts
(B, 2, frame_len), kernel rows planar-flat ``[re | im]``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..ops import operators, planar_fast
from ..ops.planar import pabs2, pconj, pmatmul, pmul, real_operator
from ..ops.planar_pipeline import _np_gauss_stacks, _small_consts, _to_tensor, evm

__all__ = [
    "LAUNCHES",
    "tx_frame_fused",
    "rx_receiver_fused",
    "receive_bursts_fused",
    "link_step_fused",
    "link_single_fused",
    "tx_frame_factored",
    "rx_receiver_factored",
    "link_step_factored",
]

# kernel launches per wrapper since the last reset (plain runs do not count)
LAUNCHES = {"tx": 0, "rx": 0, "link": 0,
            "tx_factored": 0, "rx_factored": 0, "rx_factored_chan": 0}

# QPSK symbol amplitude; the IC decisions are +-1 levels and the amplitude
# is folded into the interference taps / operator
_QPSK_AMP = 2.0**-0.5
_IC_MODES = {"conv": 0, "matmul": 1}


# ---------------------------------------------------------------------------
# host constants
# ---------------------------------------------------------------------------
@lru_cache(maxsize=16)
def _met_layout(cfg: GfdmConfig):
    """(n_cnr, met_w): CNR count and padded metrics-row width."""
    n_cnr = 2 * (cfg.active_subcarriers // 2)
    met_w = ((2 + n_cnr + 127) // 128) * 128
    return n_cnr, met_w


@lru_cache(maxsize=16)
def _ic_matmul_stack(cfg: GfdmConfig, amp: float) -> torch.Tensor:
    """bf16 Gauss stack (3N, N) of the interference operator amp*(P+M + P-M)@BD.

    Row convention: interference_row = decisions_row @ A. Built in float64
    like the JAX package's stack and rounded to bf16 by torch; the sum plane
    Wr + Wi is taken in bf16.
    """
    n, M, K = cfg.block_len, cfg.timeslots, cfg.subcarriers
    C = operators._interference_matrix(cfg).T
    BD = np.zeros((n, n), dtype=np.complex128)
    for k in range(K):
        BD[k * M : (k + 1) * M, k * M : (k + 1) * M] = C
    P = np.roll(np.eye(n), M, axis=1) + np.roll(np.eye(n), -M, axis=1)
    A = amp * (P @ BD)
    Wr = torch.from_numpy(np.ascontiguousarray(A.real)).to(torch.bfloat16)
    Wi = torch.from_numpy(np.ascontiguousarray(A.imag)).to(torch.bfloat16)
    return torch.cat([Wr, Wi, Wr + Wi], dim=0)


_KERNEL_CONSTS: dict = {}


def _kernel_consts(cfg: GfdmConfig, device) -> dict:
    """Constants of the three kernels on ``device``, built once per
    (config, device): the Gauss stacks and small constants only, none of
    the planar path's operators. Index forms replace the Pallas kernels'
    0/1 selection matrices and roll masks."""
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
    # column 0 of the circulant C times the QPSK amplitude: tap j multiplies
    # timeslot (m - j) mod M
    c_col = operators._interference_matrix(cfg)[:, 0]
    c_f32 = np.stack([c_col.real, c_col.imag]).astype(np.float32)
    arrays["taps"] = (c_f32.astype(np.float64) * _QPSK_AMP).astype(np.float32)
    k = {name: _to_tensor(a, device) for name, a in arrays.items()}
    _KERNEL_CONSTS[key] = k
    return k


def _ic_operand(cfg: GfdmConfig, ic_mode: str, device) -> torch.Tensor:
    """IC constant with the QPSK amplitude folded in: the bf16 (3N, N)
    operator (built on first use) or the float32 (2, M) circulant taps."""
    k = _kernel_consts(cfg, device)
    if ic_mode == "matmul":
        if "icop" not in k:
            k["icop"] = _ic_matmul_stack(cfg, _QPSK_AMP).to(device)
        return k["icop"]
    return k["taps"]


# ---------------------------------------------------------------------------
# plain torch versions (what the kernels compute)
# ---------------------------------------------------------------------------
def _gdot(xr, xi, g, n_in):
    """Complex product with a Gauss stack [Wr; Wi; Wr+Wi] (bf16 upcast)."""
    g = g.to(torch.float32)
    p1 = xr @ g[:n_in]
    p2 = xi @ g[n_in : 2 * n_in]
    p3 = (xr + xi) @ g[2 * n_in :]
    return p1 - p2, p3 - p1 - p2


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


def _rx_core_plain(cfg, k, pre_r, pre_i, fr_r, fr_i, ic_iterations, ic_mode,
                   ic_op):
    n, half = cfg.block_len, 2 * cfg.subcarriers
    n_cnr, met_w = _met_layout(cfg)
    chr_, chi = _gdot(pre_r, pre_i, k["E_G"], half)
    fr, fi = _gdot(pre_r, pre_i, k["F2_G"], half)
    p = fr * fr + fi * fi
    sig = p[:, k["sig_idx"]].sum(dim=1, keepdim=True)
    noise = p[:, k["noise_idx"]].sum(dim=1, keepdim=True)
    snr = (sig - noise) / noise
    met = torch.zeros(p.shape[0], met_w, dtype=p.dtype, device=p.device)
    met[:, :1] = snr
    met[:, 1 : 1 + n_cnr] = p[:, k["sig_idx"]] * (snr / (sig / n_cnr))

    xr, xi = _gdot(fr_r, fr_i, k["F_G"], n)
    den = torch.clamp(chr_ * chr_ + chi * chi, min=1e-30)
    yr = (xr * chr_ + xi * chi) / den
    yi = (xi * chr_ - xr * chi) / den
    d0r, d0i = _gdot(yr, yi, k["Bfd_G"], n)
    dr, di = d0r, d0i
    act = k["act"]
    for _ in range(ic_iterations):
        qr = torch.where(dr >= 0, 1.0, -1.0) * act
        qi = torch.where(di >= 0, 1.0, -1.0) * act
        if ic_mode == "matmul":
            ir, ii = _gdot(qr, qi, ic_op, n)
        else:
            ir, ii = _conv_ic(qr, qi, ic_op, cfg.subcarriers, cfg.timeslots)
        dr = d0r - ir
        di = d0i - ii
    return chr_, chi, met, dr, di


def _tx_frame_plain(cfg: GfdmConfig, data: torch.Tensor, shift_index: int = 0):
    """(B, 2 n_data) payload rows -> (B, 2 frame_len) burst rows."""
    k = _kernel_consts(cfg, data.device)
    n, n_d = cfg.block_len, cfg.n_data_symbols
    cp, cs = cfg.cp_len, cfg.cs_len
    shift = int(cfg.cyclic_shifts[shift_index])
    pre = k["preambles"][shift_index]
    core = _gdot(data[:, :n_d], data[:, n_d:], k["T_G"], n_d)
    planes = []
    for p, c in enumerate(core):
        framed = torch.cat([c[:, n - cp - shift :], c, c[:, : cs - shift]], dim=1)
        planes += [pre[p].expand(c.shape[0], -1), framed * k["win"]]
    return torch.cat(planes, dim=1)


def _rx_receiver_plain(cfg: GfdmConfig, bursts: torch.Tensor,
                       ic_iterations: int, ic_mode: str):
    """(B, 2 frame_len) burst rows -> chan (B, 2N), symbols (B, 2N), met."""
    k = _kernel_consts(cfg, bursts.device)
    n, half, L = cfg.block_len, 2 * cfg.subcarriers, cfg.frame_len
    cp, fs = cfg.cp_len, cfg.preamble_len + cfg.cp_len
    chr_, chi, met, dr, di = _rx_core_plain(
        cfg, k, bursts[:, cp : cp + half], bursts[:, L + cp : L + cp + half],
        bursts[:, fs : fs + n], bursts[:, L + fs : L + fs + n],
        ic_iterations, ic_mode, _ic_operand(cfg, ic_mode, bursts.device),
    )
    return torch.cat([chr_, chi], dim=1), torch.cat([dr, di], dim=1), met


def _link_single_plain(cfg: GfdmConfig, data: torch.Tensor,
                       ic_iterations: int, ic_mode: str):
    """(B, 2 n_data) payload rows -> data estimate (B, 2 n_data), met."""
    k = _kernel_consts(cfg, data.device)
    bursts = _tx_frame_plain(cfg, data, 0)
    _chan, sym, met = _rx_receiver_plain(cfg, bursts, ic_iterations, ic_mode)
    n, idx = cfg.block_len, k["demap_idx"]
    return torch.cat([sym[:, :n][:, idx], sym[:, n:][:, idx]], dim=1), met


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def _dims(cfg: GfdmConfig, batch: int, shift: int = 0, ic_iterations: int = 0,
          ic_mode: str = "conv"):
    from .cuda_lib import Dims

    n_cnr, met_w = _met_layout(cfg)
    return Dims(
        batch=batch, n=cfg.block_len, n_data=cfg.n_data_symbols,
        timeslots=cfg.timeslots, subcarriers=cfg.subcarriers,
        half=2 * cfg.subcarriers, frame_len=cfg.frame_len,
        preamble_len=cfg.preamble_len, cp_len=cfg.cp_len, cs_len=cfg.cs_len, shift=shift, n_cnr=n_cnr,
        met_w=met_w, ic_iterations=ic_iterations, ic_mode=_IC_MODES[ic_mode],
    )


def _consts(k: dict, pre: torch.Tensor, ic_op: torch.Tensor | None = None,
            ic_mode: str = "conv"):
    from .cuda_lib import Consts

    ic = {"taps": None, "icop": None}
    if ic_op is not None:
        ic["icop" if ic_mode == "matmul" else "taps"] = ic_op.data_ptr()
    return Consts(
        t_g=k["T_G"].data_ptr(), win=k["win"].data_ptr(), pre=pre.data_ptr(),
        e_g=k["E_G"].data_ptr(), f_g=k["F_G"].data_ptr(),
        bfd_g=k["Bfd_G"].data_ptr(), f2_g=k["F2_G"].data_ptr(),
        act=k["act"].data_ptr(), sig_idx=k["sig_idx"].data_ptr(),
        noise_idx=k["noise_idx"].data_ptr(),
        demap_idx=k["demap_idx"].data_ptr(), **ic,
    )


def _run(name: str, dims, consts, *ptrs, device) -> None:
    """Launch ``gfdm_<name>`` on the current stream of ``device``; raise if
    the launch is refused (e.g. a config whose tile exceeds shared memory)."""
    from .cuda_lib import launch

    def rx_tile(lib):
        return (f"; the receiver tile keeps {lib.gfdm_rx_smem_bytes(ctypes.byref(dims))}"
                " B in shared memory a CTA even at one burst, so a larger "
                "N = M*K takes rx_receiver_factored")

    launch(f"gfdm_{name}", (ctypes.byref(dims), ctypes.byref(consts), *ptrs),
           device, hint=None if name == "tx" else rx_tile)
    LAUNCHES[name] += 1


def _tx_frame_cuda(cfg, data, shift_index):
    k = _kernel_consts(cfg, data.device)
    out = torch.empty(data.shape[0], 2 * cfg.frame_len, dtype=torch.float32,
                      device=data.device)
    dims = _dims(cfg, data.shape[0], shift=int(cfg.cyclic_shifts[shift_index]))
    consts = _consts(k, k["preambles"][shift_index])
    _run("tx", dims, consts, data.data_ptr(), out.data_ptr(), device=data.device)
    return out


def _rx_receiver_cuda(cfg, bursts, ic_iterations, ic_mode):
    k = _kernel_consts(cfg, bursts.device)
    B, w = bursts.shape[0], 2 * cfg.block_len
    opts = dict(dtype=torch.float32, device=bursts.device)
    chan, sym = torch.empty(B, w, **opts), torch.empty(B, w, **opts)
    met = torch.empty(B, _met_layout(cfg)[1], **opts)
    ic_op = _ic_operand(cfg, ic_mode, bursts.device)
    dims = _dims(cfg, B, ic_iterations=ic_iterations, ic_mode=ic_mode)
    consts = _consts(k, k["preambles"][0], ic_op, ic_mode)
    _run("rx", dims, consts, bursts.data_ptr(),
         chan.data_ptr(), sym.data_ptr(), met.data_ptr(), device=bursts.device)
    return chan, sym, met


def _link_single_cuda(cfg, data, ic_iterations, ic_mode):
    k = _kernel_consts(cfg, data.device)
    B = data.shape[0]
    opts = dict(dtype=torch.float32, device=data.device)
    out = torch.empty(B, 2 * cfg.n_data_symbols, **opts)
    met = torch.empty(B, _met_layout(cfg)[1], **opts)
    ic_op = _ic_operand(cfg, ic_mode, data.device)
    dims = _dims(cfg, B, ic_iterations=ic_iterations, ic_mode=ic_mode)
    consts = _consts(k, k["preambles"][0], ic_op, ic_mode)
    _run("link", dims, consts, data.data_ptr(),
         out.data_ptr(), met.data_ptr(), device=data.device)
    return out, met


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


def _check_options(constellation: str, equalizer: str, phase_compensation: bool,
                   ic_mode: str) -> None:
    if ic_mode not in _IC_MODES:
        raise ValueError(f"unknown ic_mode {ic_mode!r}")
    missing = []
    if constellation != "qpsk":
        missing.append(f"constellation={constellation!r}")
    if equalizer != "zf":
        missing.append(f"equalizer={equalizer!r}")
    if phase_compensation:
        missing.append("phase_compensation=True")
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: the fused kernels take ZF, QPSK and no phase "
            "compensation; the other receiver options are ROADMAP.md Queue 2 "
            "item 14 (use ops.planar_pipeline.receive_bursts_planar meanwhile)"
        )


def tx_frame_fused(cfg: GfdmConfig, data: torch.Tensor, shift_index: int = 0):
    """Fused Tx chain for one cyclic shift.

    data: (B, 2, n_data) planar payload -> (B, 2, frame_len) planar burst.
    Equivalent to transmit_planar(cfg, data)[:, shift_index].
    """
    cuda = _on_cuda(data, cfg.n_data_symbols, "tx_frame_fused")
    flat = data.reshape(data.shape[0], -1)
    if cuda:
        out = _tx_frame_cuda(cfg, flat, shift_index)
    else:
        out = _tx_frame_plain(cfg, flat, shift_index)
    return out.reshape(data.shape[0], 2, cfg.frame_len)


def rx_receiver_fused(cfg: GfdmConfig, bursts: torch.Tensor, ic_iterations: int = 2,
                      constellation: str = "qpsk", phase_compensation: bool = False,
                      equalizer: str = "zf", ic_mode: str = "conv"):
    """Whole receiver core (channel est + SNR/CNR + ZF + demod + IC).

    bursts: (B, 2, frame_len) planar -> (channel (B, 2, N), symbols
    (B, 2, N), metrics (B, met_w) = [snr_lin | scaled cnrs | 0-pad]).
    """
    _check_options(constellation, equalizer, phase_compensation, ic_mode)
    cuda = _on_cuda(bursts, cfg.frame_len, "rx_receiver_fused")
    flat = bursts.reshape(bursts.shape[0], -1)
    run = _rx_receiver_cuda if cuda else _rx_receiver_plain
    chan, sym, met = run(cfg, flat, int(ic_iterations), ic_mode)
    B, n = bursts.shape[0], cfg.block_len
    return chan.reshape(B, 2, n), sym.reshape(B, 2, n), met


def receive_bursts_fused(cfg: GfdmConfig, bursts: torch.Tensor,
                         ic_iterations: int = 2, constellation: str = "qpsk",
                         equalizer: str = "zf"):
    """Production receive path: the receiver kernel + a torch demap gather.

    bursts: (B, 2, frame_len) planar, aligned at the full-preamble start.
    Returns the dict of planar_pipeline.receive_bursts_planar (ZF, QPSK).
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
                      constellation: str = "qpsk", ic_mode: str = "conv"):
    """One-kernel end-to-end link: payload -> Tx -> on-chip burst -> Rx -> data.

    data: (B, 2, n_data) planar payload. Returns (data_hat (B, 2, n_data),
    snr_lin (B,), evm scalar) - the link_step_fused contract, with the burst
    never leaving the chip.
    """
    _check_options(constellation, "zf", False, ic_mode)
    cuda = _on_cuda(data, cfg.n_data_symbols, "link_single_fused")
    flat = data.reshape(data.shape[0], -1)
    run = _link_single_cuda if cuda else _link_single_plain
    out, met = run(cfg, flat, int(ic_iterations), ic_mode)
    d_hat = out.reshape(data.shape)
    return d_hat, met[:, 0], evm(d_hat, data)


# ---------------------------------------------------------------------------
# factored kernels (large K): host constants
# ---------------------------------------------------------------------------
@lru_cache(maxsize=16)
def _factored_np(cfg: GfdmConfig) -> dict:
    """Host constants of the factored kernels beyond planar_fast's tables.

    ``ftaps`` (2, M): column 0 of the circulant C times the QPSK amplitude,
    folded in float64 and rounded once, as the JAX package folds its
    factored kernels' taps (the dense kernels' conv ``taps`` round c to
    float32 first).
    ``map_idx`` (N,): frame position -> payload index from the nonzeros of
    the mapping matrix (n_data, a zero sentinel, elsewhere), as the JAX
    ``tx_frame_factored`` builds its gather.
    """
    c_col = operators._interference_matrix(cfg)[:, 0]
    ftaps = np.stack([c_col.real * _QPSK_AMP, c_col.imag * _QPSK_AMP]).astype(np.float32)
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


def _ic_factored(cfg: GfdmConfig, k: dict, d0: torch.Tensor, ic_iterations: int):
    """Circulant QPSK IC on (B, 2, N) symbols: ``ic_iterations`` of
    d = d0 - interference(+-1 decisions on active symbols)."""
    B, n = d0.shape[0], cfg.block_len
    d0r, d0i = d0[:, 0], d0[:, 1]
    dr, di = d0r, d0i
    for _ in range(ic_iterations):
        qr = torch.where(dr >= 0, 1.0, -1.0) * k["act"]
        qi = torch.where(di >= 0, 1.0, -1.0) * k["act"]
        ir, ii = _conv_ic(qr, qi, k["ftaps"], cfg.subcarriers, cfg.timeslots)
        dr, di = d0r - ir, d0i - ii
    return torch.stack([dr.reshape(B, n), di.reshape(B, n)], dim=1)


def _rx_factored_plain(cfg: GfdmConfig, bursts: torch.Tensor, chan, ic_iterations: int):
    """(B, 2, frame_len) bursts [+ (B, 2, N) channel] -> chan, symbols (B, 2, N).

    chan=None estimates it with the dense E_W (the in-kernel estimator)."""
    k = _factored_consts(cfg, bursts.device)
    B, n, K = bursts.shape[0], cfg.block_len, cfg.subcarriers
    if chan is None:
        pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(B, 4 * K)
        chan = (pre2 @ _estimator_op(cfg, bursts.device)).reshape(B, 2, n)
    fs = cfg.preamble_len + cfg.cp_len
    X = planar_fast.fast_fft_n(cfg, bursts[..., fs : fs + n], k)  # natural order
    S = planar_fast._fold_rx(cfg, _zf_clamped(X, chan), k)  # (B, K, 2, M)
    d0 = pmatmul(S, k["iFM_W"])  # per-subcarrier M-point IFFT
    d0 = torch.movedim(d0, -2, -3).reshape(B, 2, n)
    return chan, _ic_factored(cfg, k, d0, ic_iterations)


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


def _factored_ptrs(k: dict, tx: bool, shift_index: int = 0, e_w=None):
    from .cuda_lib import FactoredConsts

    return FactoredConsts(
        fk=k["iFK_W" if tx else "FK_W"].data_ptr(),
        tw=k["itw" if tx else "tw"].data_ptr(),
        fm=k["FM_W"].data_ptr(), ifm=k["iFM_W"].data_ptr(),
        parts=k["tx_parts" if tx else "rx_parts"].data_ptr(),
        taps=k["ftaps"].data_ptr(), act=k["act"].data_ptr(),
        map_idx=k["map_idx"].data_ptr(), win=k["win"].data_ptr(),
        pre=k["preambles"][shift_index].data_ptr(),
        e_w=None if e_w is None else e_w.data_ptr(),
    )


def _run_factored(name: str, dims, consts, *ptrs, device) -> None:
    """Launch ``gfdm_<name>``; a refused launch raises, naming the kernel and
    the shared memory its one-burst CTA needs."""
    from .cuda_lib import FACTORED_KINDS, launch

    def tile(lib):
        nbytes = lib.gfdm_factored_smem_bytes(ctypes.byref(dims), FACTORED_KINDS[name])
        return (f"; the {name} kernel keeps {nbytes} B in shared memory a CTA "
                f"(one burst, K={dims.subcarriers}, M={dims.timeslots})")

    launch(f"gfdm_{name}", (ctypes.byref(dims), ctypes.byref(consts), *ptrs),
           device, hint=tile)
    LAUNCHES[name] += 1


def _tx_factored_cuda(cfg: GfdmConfig, data: torch.Tensor, shift_index: int):
    k = _factored_consts(cfg, data.device)
    out = torch.empty(data.shape[0], 2, cfg.frame_len, dtype=torch.float32,
                      device=data.device)
    dims = _factored_dims(cfg, data.shape[0], shift=int(cfg.cyclic_shifts[shift_index]))
    _run_factored("tx_factored", dims, _factored_ptrs(k, True, shift_index),
                  data.data_ptr(), out.data_ptr(), device=data.device)
    return out


def _rx_factored_cuda(cfg: GfdmConfig, bursts: torch.Tensor, chan, ic_iterations: int):
    k = _factored_consts(cfg, bursts.device)
    B, n = bursts.shape[0], cfg.block_len
    opts = dict(dtype=torch.float32, device=bursts.device)
    sym = torch.empty(B, 2, n, **opts)
    dims = _factored_dims(cfg, B, ic_iterations=ic_iterations)
    if chan is None:
        chan = torch.empty(B, 2, n, **opts)
        consts = _factored_ptrs(k, False, e_w=_estimator_op(cfg, bursts.device))
        _run_factored("rx_factored", dims, consts, bursts.data_ptr(), None,
                      chan.data_ptr(), sym.data_ptr(), device=bursts.device)
    else:
        _run_factored("rx_factored_chan", dims, _factored_ptrs(k, False),
                      bursts.data_ptr(), chan.data_ptr(), None, sym.data_ptr(),
                      device=bursts.device)
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
                         estimator: str = "fused"):
    """Factorized one-kernel receiver (channel est + ZF + demod + QPSK IC).

    bursts: (B, 2, frame_len) planar -> (channel (B, 2, N), symbols
    (B, 2, N)). The block DFT runs as K-point DFTs plus a twiddled M-point
    stage, the FD demod as an L-tap fold plus per-subcarrier M-point IFFTs.

    estimator:
      "fused" - channel estimated inside the kernel via the dense (4K, 2N)
                operator (K <= ~128: 302 MB at K = 1024);
      "fast"  - channel estimated outside by the O(K^2) factorized torch-op
                estimator (ops.planar_fast.estimate_channel_fast) and read
                by the kernel; no dense operator of any kind.
    """
    if estimator not in ("fused", "fast"):
        raise ValueError(f"estimator must be 'fused' or 'fast', got {estimator!r}")
    cuda = _on_cuda(bursts, cfg.frame_len, "rx_receiver_factored")
    chan = _fast_channel(cfg, bursts) if estimator == "fast" else None
    run = _rx_factored_cuda if cuda else _rx_factored_plain
    return run(cfg, bursts, chan, int(ic_iterations))


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
    bursts = tx_frame_factored(cfg, data)
    _chan, sym = rx_receiver_factored(cfg, bursts, ic_iterations, estimator=estimator)
    d_hat = sym[..., _factored_consts(cfg, data.device)["demap_idx"]]
    return d_hat, evm(d_hat, data)
