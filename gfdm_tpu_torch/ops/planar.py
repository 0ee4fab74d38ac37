"""Planar complex arithmetic: complex tensors as stacked real planes.

The port keeps the JAX package's layout (``gfdm_tpu.ops.planar``): a complex
tensor of shape (..., n) is a real tensor of shape (..., 2, n) - plane 0 the
real part, plane 1 the imaginary part - so flattening the last two axes gives
the row [re | im] and a complex matmul y = x @ W is one real matmul against
the realified operator [[Wr, Wi], [-Wi, Wr]].

The host-side builders (``to_planar``, ``from_planar``, ``real_operator``,
``gauss_stack``) stay NumPy (a bf16 operator is built in float64 and rounded
once by :func:`bf16_operator`); the primitives on tensors are torch.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "to_planar",
    "from_planar",
    "real_operator",
    "gauss_stack",
    "host_dtype",
    "bf16_operator",
    "pmatmul",
    "pmul",
    "pconj",
    "pdiv",
    "pabs2",
    "re",
    "im",
    "pangle",
    "pexp_i",
    "pscale_real",
]


# ---------------------------------------------------------------------------
# conversions (host side, numpy in / numpy out)
# ---------------------------------------------------------------------------
def to_planar(x, dtype=np.float32) -> np.ndarray:
    """complex (..., n) -> real (..., 2, n)."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-2).astype(dtype)


def from_planar(x) -> np.ndarray:
    """real (..., 2, n) -> complex (..., n)."""
    x = np.asarray(x)
    return x[..., 0, :] + 1j * x[..., 1, :]


def real_operator(W, dtype=np.float32) -> np.ndarray:
    """Realify a complex operator for right-multiplication.

    For y = x @ W (x a row of length n_in, W (n_in, n_out) complex), the
    planar form is  y2 = x2 @ real_operator(W)  with x2 = [x_re | x_im]:

        [[ Wr,  Wi],
         [-Wi,  Wr]]    of shape (2*n_in, 2*n_out).
    """
    W = np.asarray(W)
    Wr, Wi = W.real.astype(dtype), W.imag.astype(dtype)
    top = np.concatenate([Wr, Wi], axis=1)
    bot = np.concatenate([-Wi, Wr], axis=1)
    return np.concatenate([top, bot], axis=0)


def gauss_stack(W, dtype=np.float32) -> np.ndarray:
    """Complex operator as the 3-real-matmul (Gauss/Karatsuba) stack.

    For y = x @ W with W (n_in, n_out) complex:

        P1 = x_re @ Wr;  P2 = x_im @ Wi;  P3 = (x_re + x_im) @ (Wr + Wi)
        y_re = P1 - P2;  y_im = P3 - P1 - P2

    Returns the (3*n_in, n_out) stack [Wr; Wi; Wr+Wi] (the sum is taken in
    ``dtype``, as in the JAX package).
    """
    W = np.asarray(W)
    Wr, Wi = W.real.astype(dtype), W.imag.astype(dtype)
    return np.concatenate([Wr, Wi, Wr + Wi], axis=0)


def host_dtype(dtype_name: str):
    """NumPy dtype the host builds an operator of ``dtype_name`` in: NumPy
    has no bf16, so a bf16 operator stays float64 until
    :func:`bf16_operator` rounds it once on upload."""
    return np.float64 if dtype_name == "bfloat16" else np.dtype(dtype_name)


def bf16_operator(a: np.ndarray) -> torch.Tensor:
    """A float64 host constant rounded once to bf16 by torch (ml_dtypes'
    round-to-nearest-even, pinned in tests/test_torch_constants.py), as the
    JAX package's ``astype(bfloat16)`` on float64 rounds it."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# tensor primitives (operate on tensors shaped (..., 2, n))
# ---------------------------------------------------------------------------
def re(x):
    return x[..., 0, :]


def im(x):
    return x[..., 1, :]


def _pack(r, i):
    return torch.stack([r, i], dim=-2)


def pmatmul(x: torch.Tensor, W_real: torch.Tensor) -> torch.Tensor:
    """Planar complex matmul: (..., 2, n) @ realified (2n, 2m) -> (..., 2, m).

    With a bfloat16 operator the activation is rounded to bf16 and the
    products are summed in float32, returned in the activation's dtype (the
    JAX package's bf16 mode). The product of two bf16 values is exact in
    float32, so the float32 matmul of the upcast operands is that function
    up to the order of the sums; torch's own bf16 matmul would round its
    output to bf16."""
    flat = x.reshape(x.shape[:-2] + (2 * x.shape[-1],))
    if W_real.dtype == torch.bfloat16:
        y = torch.matmul(flat.to(torch.bfloat16).float(), W_real.float()).to(x.dtype)
    else:
        y = torch.matmul(flat, W_real)
    return y.reshape(x.shape[:-2] + (2, W_real.shape[-1] // 2))


def pmul(a, b):
    """Elementwise complex multiply."""
    ar, ai = a[..., 0, :], a[..., 1, :]
    br, bi = b[..., 0, :], b[..., 1, :]
    return _pack(ar * br - ai * bi, ar * bi + ai * br)


def pconj(a):
    return _pack(a[..., 0, :], -a[..., 1, :])


def pabs2(a):
    """|a|^2 (real tensor, no plane axis)."""
    return a[..., 0, :] ** 2 + a[..., 1, :] ** 2


def pdiv(a, b, eps: float = 0.0):
    """Elementwise complex divide a/b (no clamp unless ``eps`` is set)."""
    d = pabs2(b)
    if eps:
        d = torch.clamp(d, min=eps)
    num = pmul(a, pconj(b))
    return _pack(num[..., 0, :] / d, num[..., 1, :] / d)


def pangle(a):
    return torch.atan2(im(a), re(a))


def pexp_i(phase):
    """e^{j phase} as a planar tensor (phase real, shape (..., n))."""
    return _pack(torch.cos(phase), torch.sin(phase))


def pscale_real(a, s):
    """Multiply by a real scalar/array broadcast over both planes."""
    return a * s[..., None, :] if hasattr(s, "ndim") and s.ndim == a.ndim - 1 else a * s
