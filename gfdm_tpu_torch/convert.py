"""Constants carried across from the JAX package.

``operators_from_numpy`` turns the JAX package's host constants - its
operator matrices, small constants, selection matrices and bf16 IC stack,
as NumPy arrays - into the port's constant cache: the names, dtypes and
index forms that ``ops.planar_pipeline._device_mats`` and
``kernels.fused._kernel_consts`` build. ``detect_consts_from_numpy`` does
the same for the detection kernels, whose banded operators reduce to the
preamble taps the CUDA kernel reads, and ``factored_consts_from_numpy`` for
the factored kernels, whose coefficient rows and reorder gathers the CUDA
kernels compute by index. ``chain_weights_from_numpy`` (from
``kernels.chain``) takes the weights of ``benchmarks/int8_gauss.py``'s
chain, as the script makes them, to the port's f32, bf16 or int8 form. The
tests use them to show that the packages compute with the same constants,
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.chain import chain_weights_from_numpy
from .kernels.fused import _QPSK_AMP
from .ops.planar_pipeline import _to_tensor

__all__ = ["operators_from_numpy", "detect_consts_from_numpy", "factored_consts_from_numpy",
           "chain_weights_from_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        a = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return _to_tensor(a, device)


def _columns_of(sel: np.ndarray) -> np.ndarray:
    """Row index of the single 1 in each column of a 0/1 selection matrix."""
    if not (np.isin(sel, (0, 1)).all() and (sel.sum(axis=0) == 1).all()):
        raise ValueError("expected exactly one 1 in every column")
    return np.argmax(sel, axis=0).astype(np.int32)


def _put(out: dict, name: str, t: torch.Tensor) -> None:
    hit = out.get(name)
    if hit is not None and not (hit.dtype == t.dtype and torch.equal(hit, t)):
        raise ValueError(f"{name}: inputs disagree")
    out[name] = t


def _circulant_blocks(c: np.ndarray, K: int) -> np.ndarray:
    """(N, N) block diagonal of K circulant (M, M) blocks in row convention:
    entry (k M + m', k M + m) = c[(m - m') mod M]."""
    M = c.size
    j = (np.arange(M)[None, :] - np.arange(M)[:, None]) % M
    return np.kron(np.eye(K), c[j])


def operators_from_numpy(np_consts: dict, device="cpu",
                         amp: float = _QPSK_AMP) -> dict[str, torch.Tensor]:
    """JAX-package constants (NumPy) -> the port's constant cache on ``device``.

    Arrays pass through under their names (integers as int32, ml_dtypes
    bf16 as torch.bfloat16: the bf16 Gauss stacks of the link's
    ``dtype_name="bfloat16"`` come across bit for bit). These names are
    translated, ``amp`` being the IC amplitude folded into the IC constants
    (the QPSK one by default; ``_IC_AMPS`` of qam16 / qam64 or a
    ``qpsk_amp`` override):

    - ``met_selection`` (2K, met_w) -> ``sig_idx`` and ``noise_idx``;
    - ``demap_selection`` (N, n_data) -> ``demap_idx``;
    - ``ic_matmul_stack`` (3N, N) bf16, built at ``amp`` -> ``icop``;
    - ``C_W`` -> also ``taps`` (2, M), column 0 of the circulant times
      ``amp`` (the conv-mode IC taps, what the superseded receivers' IC
      reads in place of the realified C_W product);
    - ``block_diag_C`` (BDr, BDi), the (N, N) block-diagonal circulant of
      ``_rx_ic_kernel``, is checked against the circulant of ``C_W``'s row
      0 to 1e-6 (needs ``C_W`` beside it) and dropped: the kernels read the
      taps;
    - ``cnri_pad`` (pad_n, N), the mmse_cnr operator with zero rows padded
      to a sublane multiple -> ``CNRI_T`` (n_cnr, N), the zero rows checked
      and dropped (n_cnr from ``met_selection`` or ``CNRI_T`` beside it);
    - ``active`` (K,) -> also ``act`` (N,), the per-symbol mask (needs
      ``ic_taps`` beside it, as ``_small_consts`` gives both);
    - ``circ_masks`` (M-1, N) is checked against ``(col % M) < j`` and
      dropped: the port's kernels compute that rotation by index.
    """
    out: dict[str, torch.Tensor] = {}
    for name, a in np_consts.items():
        if name == "block_diag_C":
            bd = np.asarray(a[0], dtype=np.float64) + 1j * np.asarray(a[1], dtype=np.float64)
            cw = np.asarray(np_consts["C_W"])
            M = cw.shape[0] // 2
            c = cw[0, :M].astype(np.float64) + 1j * cw[0, M:].astype(np.float64)
            # the float64 product idft diag dft is circulant only to rounding:
            # its float32 entries along one diagonal may differ by an ulp
            if np.abs(bd - _circulant_blocks(c, bd.shape[0] // M)).max() > 1e-6:
                raise ValueError("block_diag_C is not the block circulant of C_W's row 0")
            continue
        a = np.asarray(a)
        if name == "cnri_pad":
            n_cnr = (int(np.asarray(np_consts["met_selection"])[:, 0].sum())
                     if "met_selection" in np_consts else np.asarray(np_consts["CNRI_T"]).shape[0])
            if np.any(a[n_cnr:]):
                raise ValueError("cnri_pad: the rows past n_cnr are not zero padding")
            _put(out, "CNRI_T", _tensor(np.ascontiguousarray(a[:n_cnr]), device))
        elif name == "met_selection":
            n_cnr = int(a[:, 0].sum())
            _put(out, "sig_idx", _tensor(_columns_of(a[:, 2 : 2 + n_cnr]), device))
            _put(out, "noise_idx", _tensor(np.nonzero(a[:, 1])[0], device))
        elif name == "demap_selection":
            _put(out, "demap_idx", _tensor(_columns_of(a), device))
        elif name == "ic_matmul_stack":
            _put(out, "icop", _tensor(a, device))
        elif name == "circ_masks":
            M = a.shape[0] + 1
            cols = np.arange(a.shape[1]) % M
            want = np.stack([(cols < j) for j in range(1, M)]).astype(a.dtype)
            if not np.array_equal(a, want):
                raise ValueError("circ_masks is not the (col % M) < j pattern")
        else:
            _put(out, name, _tensor(a, device))
            if name == "C_W":  # realified (2M, 2M): row 0 is [c.real | c.imag]
                M = a.shape[0] // 2
                c = np.stack([a[0, :M], a[0, M:]]).astype(np.float32)
                taps = (c.astype(np.float64) * amp).astype(np.float32)
                _put(out, "taps", _tensor(taps, device))
            elif name == "active":  # with its _small_consts sibling ic_taps (2, M)
                M = np.asarray(np_consts["ic_taps"]).shape[-1]
                _put(out, "act", _tensor(np.repeat(a.astype(np.float32), M), device))
    return out


def _band(b: int, w: int, backward: bool = False) -> np.ndarray:
    """The JAX detection kernels' (2b, b) 0/1 sliding-window operator."""
    Bm = np.zeros((2 * b, b), dtype=np.float32)
    for v in range(b):
        if backward:
            Bm[b + v - w + 1 : b + v + 1, v] = 1.0
        else:
            Bm[v : v + w, v] = 1.0
    return Bm


def detect_consts_from_numpy(c: dict, device="cpu") -> dict:
    """The JAX detection kernels' constants -> the CUDA detection kernels'.

    ``c`` is ``gfdm_tpu.kernels.detect._consts(cfg)`` (or ``_consts2``,
    which adds the row-permuted ``xcorr2``). The banded realified xcorr
    operator (4b, 2b), b = 2K, must hold one preamble column shifted down
    by one row per output; its column gives ``taps`` (2, 2K) float32, what
    ``kernels.detect._consts`` uploads. The K, 2K and backward (cp+1)/(cp+1)
    window operators are checked against their patterns and dropped: the
    CUDA kernel sums those windows by index. Returns ``taps``, ``K`` and
    ``cp_len``.
    """
    b = int(c["b"])
    x = np.asarray(c["xcorr"])
    if x.shape != (4 * b, 2 * b):
        raise ValueError(f"xcorr: unexpected shape {x.shape}")
    Kr, Ki = x[: 2 * b, :b], x[: 2 * b, b:]
    taps = np.stack([Kr[:b, 0], Ki[:b, 0]]).astype(np.float32)
    want = np.zeros((2, 2 * b, b), dtype=np.float32)
    for v in range(b):
        want[:, v : v + b, v] = taps
    if not (np.array_equal(np.stack([Kr, Ki]), want)
            and np.array_equal(x[2 * b :, :b], -Ki) and np.array_equal(x[2 * b :, b:], Kr)):
        raise ValueError("xcorr is not the banded preamble correlation operator")
    if "xcorr2" in c:
        perm = np.concatenate([np.arange(0, b), np.arange(2 * b, 3 * b),
                               np.arange(b, 2 * b), np.arange(3 * b, 4 * b)])
        if not np.array_equal(np.asarray(c["xcorr2"]), x[perm]):
            raise ValueError("xcorr2 is not xcorr with its rows in pair order")
    K = b // 2
    bcp = np.asarray(c["bandCP"])
    cp1 = int(np.count_nonzero(bcp[:, 0]))
    for name, want_band in (("bandK", _band(b, K)), ("band2K", _band(b, 2 * K)),
                            ("bandCP", _band(b, cp1, backward=True) / cp1)):
        if not np.array_equal(np.asarray(c[name]), want_band):
            raise ValueError(f"{name} is not the expected window operator")
    return {"taps": _tensor(taps, device), "K": K, "cp_len": cp1 - 1}


def _complex_op(w2: np.ndarray) -> np.ndarray:
    """Realified (2n, 2n) operator -> the complex (n, n) map it holds."""
    n = w2.shape[0] // 2
    return w2[:n, :n].astype(np.float64) + 1j * w2[:n, n:].astype(np.float64)


def _planar(t: np.ndarray) -> np.ndarray:
    """(..., 2, n) planar table -> complex (..., n)."""
    return t[..., 0, :].astype(np.float64) + 1j * t[..., 1, :].astype(np.float64)


# the factored kernels' coefficient tables: name -> (sources, exact)
_FACTORED_PATTERNS = {
    "mc": (("FM_W", "tw"), False),
    "ft": (("rx_parts",), True),
    "iv": (("iFM_W",), True),
    "reorder": (("tw",), True),
    "txa": (("FM_W",), True),
    "ftx": (("tx_parts",), True),
    "mt": (("iFM_W", "itw"), False),
    "unreorder": (("tw",), True),
}


def _factored_pattern(name: str, src: dict) -> np.ndarray:
    """What the JAX factored kernels' table ``name`` holds, by index from
    the tables the port keeps (the CUDA kernels' index arithmetic)."""
    M, _, K = src["tw"].shape if "tw" in src else src["itw"].shape
    N = K * M
    if name in ("reorder", "unreorder"):
        t = np.arange(N)
        if name == "unreorder":  # core sample t = M n2 + n1 <- xt[n1 K + n2]
            return ((t % M) * K + t // M).astype(np.int32)
        return (M * (t % K) + t // K).astype(np.int32)  # xt[n1 K + n2] <- M n2 + n1
    if name in ("ft", "ftx"):
        parts = src["rx_parts" if name == "ft" else "tx_parts"]
        L = parts.shape[0]
        return np.stack([np.tile(_planar(parts[(i + L // 2) % L]), K) for i in range(L)])
    j = np.arange(M)[:, None]
    if name in ("iv", "txa"):  # row j at k M + m: the M-point map's entry (m, (m - j) % M)
        m = np.arange(N)[None, :] % M
        W = _complex_op(src["iFM_W" if name == "iv" else "FM_W"])  # W[r, c] = F[c, r]
        return W[(m - j) % M, m]
    k1 = np.arange(N)[None, :] // K  # row j at k1 K + k2
    k2 = np.arange(N)[None, :] % K
    if name == "mc":  # dft_M[k1, n1] tw[n1, k2], n1 = (k1 - j) % M
        n1 = (k1 - j) % M
        return _complex_op(src["FM_W"])[n1, k1] * _planar(src["tw"])[n1, k2]
    # "mt": idft_M[(n1 - j) % M, n1] itw[n1, k2] with n1 the row block index
    n1 = k1
    return _complex_op(src["iFM_W"])[n1, (n1 - j) % M] * _planar(src["itw"])[n1, k2]


def factored_consts_from_numpy(np_consts: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The JAX factored kernels' and planar_fast's constants -> the port's.

    ``np_consts`` holds any of ``gfdm_tpu.kernels.fused._factored_consts(cfg)``,
    ``_tx_factored_consts(cfg)``, ``planar_fast._fft_consts(cfg, "float32")``
    and ``_est_consts(cfg, "float32")`` (NumPy). Names the port keeps pass
    through under their names (``FK_W``, ``iFK_W``, ``FM_W``, ``iFM_W``,
    ``tw``, ``itw``, ``tx_parts``, ``rx_parts`` and the estimator's tables;
    integers as int32); where two inputs share a name they must agree. The
    coefficient tables the CUDA kernels compute by index are checked against
    that index pattern of the kept tables and dropped: the M-stage rows
    ``mcr``/``mci`` and ``mtr``/``mti`` (a product of two float32 tables,
    so within 1e-6 of the table rounded once from float64), and exactly the
    filter rows ``ftr``/``fti``/``ftxr``/``ftxi``, the M-point rows
    ``ivr``/``ivi``/``txar``/``txai`` and the gathers ``reorder`` and
    ``unreorder``.
    """
    out: dict[str, torch.Tensor] = {}
    kept, tables = {}, {}
    for name, a in np_consts.items():
        a = np.asarray(a)
        base = name[:-1] if name[:-1] in _FACTORED_PATTERNS and name[-1] in "ri" else name
        if base in _FACTORED_PATTERNS:
            tables.setdefault(base, {})[name] = a
        else:
            kept[name] = a
            _put(out, name, _tensor(a, device))
    for base, parts in tables.items():
        sources, exact = _FACTORED_PATTERNS[base]
        missing = [s for s in sources if s not in kept]
        if missing:
            raise ValueError(f"{base}: checking it needs {', '.join(missing)} beside it")
        want = _factored_pattern(base, kept)
        if base in ("reorder", "unreorder"):
            ok = np.array_equal(parts[base], want)
        else:
            got = parts.get(base + "r"), parts.get(base + "i")
            if got[0] is None or got[1] is None:
                raise ValueError(f"{base}: needs both {base}r and {base}i")
            if exact:
                ok = (np.array_equal(got[0], want.real.astype(np.float32))
                      and np.array_equal(got[1], want.imag.astype(np.float32)))
            else:
                ok = (np.abs(got[0] - want.real).max() <= 1e-6
                      and np.abs(got[1] - want.imag).max() <= 1e-6)
        if not ok:
            raise ValueError(f"{base} is not the pattern the factored kernels compute by index")
    return out
