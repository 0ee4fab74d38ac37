"""Plain replay of the factored kernels' K-point stage (csrc/factored.cu),
for tests/test_torch_factored_fft.py. Imports numpy and the port only.

The M rows of one burst share one shared-memory array: row r starts at
r * ``row_stride(K)`` and holds its element i at ``pos(i)``. For K a power of
two the rows are transformed in place by a decimation-in-time FFT
(``fft_plan(K)``; ``fft_plan``, ``row_stride`` and ``pos`` mirror the
kernels' fac_radix, fac_stride and fac_pos, and a card test holds the first
two against the library's ``gfdm_factored_plan``): the
producer writes element t of a row at the bit reversal of t, and each pass of
radix R runs one butterfly a thread, each reading R points at stride s (the
sub-transforms' length), in the radix's bit-reversed order, twiddling them
from the pass's slice of the table, and writing the R outputs back in
natural order, so the consumer reads element k at ``pos(k)``. The
twiddle table holds, pass after pass, W^(j q K / Ls) for q = 1..R-1 (rows)
and j < s (columns), read from row 1 of the realified K-point operator: the
Tx's carries the 1/K of the inverse DFT, so it is taken times K (exact for K
a power of two) and the core is scaled by 1/K once. Any other K takes the
direct DFT over the natural-order rows.
"""
import numpy as np

def fft_plan(K: int) -> tuple:
    """Radices of the kernels' in-place K-point FFT, first pass first: radix
    8, the odd last pass radix 2 or 4, for K a power of two; () for any other
    K, whose K-point stage is the direct DFT."""
    if K < 2 or K & (K - 1):
        return ()
    bits = K.bit_length() - 1
    return (8,) * (bits // 3) + ((1 << bits % 3,) if bits % 3 else ())


def row_stride(K: int) -> int:
    """Elements between two rows in shared memory: a row of K holds element
    i at ``pos(i)``, then one more gap, so that the M rows start on
    different banks."""
    return K + K // 16 + 1


def pos(i):
    """Shared-memory offset of element i of a row: a gap after every 16, so
    a radix-8 butterfly's 8 neighbours and 16 threads' rows differ in bank."""
    return i + (i >> 4)


# bit reversal inside one radix-R butterfly
BREV = {2: (0, 1), 4: (0, 2, 1, 3), 8: (0, 4, 2, 6, 1, 5, 3, 7)}
_C = np.float32(np.sqrt(0.5))


def bitrev(i, K: int):
    """Bit reversal of i over log2 K bits."""
    bits = K.bit_length() - 1
    i = np.asarray(i)
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def table_row(fk_w: np.ndarray) -> np.ndarray:
    """Row 1 of a realified (2K, 2K) K-point operator as complex64: the
    K-entry table W^t the kernels read."""
    K = fk_w.shape[0] // 2
    return (fk_w[1, :K] + 1j * fk_w[1, K:]).astype(np.complex64)


def twiddles(row1: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """The kernel's twiddle table for the FFT plan at K = len(row1), each
    pass's slice laid out [q - 1][j] so that neighbouring threads (j) read
    neighbouring words."""
    K = row1.shape[0]
    table = np.zeros(K, dtype=np.complex64)
    off, ls = 0, 1
    for r in fft_plan(K):
        s, ls = ls, ls * r
        q, j = np.arange(1, r)[:, None], np.arange(s)[None, :]
        table[off : off + (r - 1) * s] = (row1[(j * q * (K // ls)).ravel()]
                                          * np.float32(scale))
        off += (r - 1) * s
    return table


def _mul_i(a, inverse: bool):
    """a times -i (forward) or +i (inverse)."""
    return a * np.complex64(1j if inverse else -1j)


def _dft(v: list, inverse: bool) -> list:
    """The kernel's R-point DFT in registers (R = 2, 4, 8), natural order."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], _mul_i(v[1] - v[3], inverse)
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    e, o = _dft(v[0::2], inverse), _dft(v[1::2], inverse)
    w1 = np.complex64(_C + (1j if inverse else -1j) * _C)
    w3 = np.complex64(-_C + (1j if inverse else -1j) * _C)
    o = [o[0], o[1] * w1, _mul_i(o[2], inverse), o[3] * w3]
    return [e[p] + o[p] for p in range(4)] + [e[p] - o[p] for p in range(4)]


def butterflies(K: int, M: int, r: int, ls: int):
    """(row, first element, j) of every butterfly of the pass of radix r
    whose transforms have length ls, in thread order."""
    s, per_row = ls // r, K // r
    u = np.arange(M * per_row)
    row, w = u // per_row, u % per_row
    blk, j = w // s, w % s
    return row, blk * ls + j, j


def fft_rows(smem: np.ndarray, K: int, M: int, table: np.ndarray, inverse: bool,
             passes_seen: list | None = None) -> None:
    """The kernel's passes over the M rows held in ``smem``, in place.
    ``passes_seen`` collects each pass's read offsets (for the tests)."""
    stride = row_stride(K)
    off, ls = 0, 1
    for r in fft_plan(K):
        s, ls = ls, ls * r
        row, e0, j = butterflies(K, M, r, ls)
        base = row * stride
        reads = [base + pos(e0 + BREV[r][q] * s) for q in range(r)]
        v = [smem[a] for a in reads]
        if s > 1:
            v = [v[0]] + [v[q] * table[off + (q - 1) * s + j] for q in range(1, r)]
        y = _dft(v, inverse)
        for p in range(r):
            smem[base + pos(e0 + p * s)] = y[p]
        if passes_seen is not None:
            passes_seen.append(np.concatenate(reads))
        off += (r - 1) * s


def direct_rows(smem: np.ndarray, K: int, M: int, row1: np.ndarray) -> np.ndarray:
    """The direct path: out(r, k) = sum_j in[r, j] W^((j k) mod K) over the
    natural-order rows; returns (M, K)."""
    stride = row_stride(K)
    idx = np.arange(M)[:, None] * stride + pos(np.arange(K))[None, :]
    jk = np.outer(np.arange(K), np.arange(K)) % K
    return smem[idx] @ row1[jk]


def _smem(K: int, M: int) -> np.ndarray:
    # unwritten words are NaN: a read the layout misses shows in the result
    return np.full(M * row_stride(K), np.nan, dtype=np.complex64)


def rx_k_stage(x: np.ndarray, K: int, M: int, fk_w: np.ndarray) -> np.ndarray:
    """The receiver's K-point stage on one burst's payload x (N,) complex:
    sample t = M n2 + n1 loaded into row n1 at element n2 (bit-reversed for
    the FFT); returns Z (M, K) as the next stage reads it, Z[n1, k2] at
    element k2 of row n1 (``Bs[n1 K + k2]``)."""
    stride, row1 = row_stride(K), table_row(fk_w)
    fft = bool(fft_plan(K))
    smem = _smem(K, M)
    t = np.arange(M * K)
    n2, n1 = t // M, t % M
    smem[n1 * stride + pos(bitrev(n2, K) if fft else n2)] = x
    if not fft:
        return direct_rows(smem, K, M, row1)
    fft_rows(smem, K, M, twiddles(row1), inverse=False)
    k2 = np.arange(K)
    return smem[np.arange(M)[:, None] * stride + pos(k2)[None, :]]


def tx_k_stage(z: np.ndarray, K: int, M: int, ifk_w: np.ndarray) -> np.ndarray:
    """The Tx's K-point stage on one burst's twiddled rows z (M, K): element
    k2 of row n1 written at the bit reversal of k2 (FFT), the inverse FFT
    with the table times K, and the core read as the framing reads it,
    sample M n2 + n1 (``A[M k + r]``) from element n2 of row n1, times 1/K;
    returns the core (N,)."""
    stride, row1 = row_stride(K), table_row(ifk_w)
    fft = bool(fft_plan(K))
    smem = _smem(K, M)
    rows, k2 = np.arange(M)[:, None], np.arange(K)[None, :]
    smem[rows * stride + pos(bitrev(k2, K) if fft else k2)] = z
    col = np.arange(M * K)
    n2, n1 = col // M, col % M
    if not fft:
        return direct_rows(smem, K, M, row1)[n1, n2]
    fft_rows(smem, K, M, twiddles(row1, K), inverse=True)
    return smem[n1 * stride + pos(n2)] * np.float32(1.0 / K)
