"""Plain emulation of the Tx kernel's tiles (csrc/tx.cu), for
tests/test_torch_tx_tiles.py. Imports torch only.

The core is computed tile by tile with the kernel's constants
(``fused.TX_TILE``: bursts, core columns, k-depth), k zero-padded to the
k-tile, and each tile's core samples are scattered to their framed
positions by the kernel's body / CP / CS rule, into an output pre-filled
with NaN: a position the rule misses stays NaN."""
import torch
import torch.nn.functional as F

from gfdm_tpu_torch.kernels import fused


def tx_tiles(cfg, data: torch.Tensor, shift_indices) -> torch.Tensor:
    """(B, 2 n_data) payload rows -> (B, len(shift_indices), 2 frame_len)."""
    bm, bn, bk = fused.TX_TILE
    k = fused._kernel_consts(cfg, data.device)
    n, nd = cfg.block_len, cfg.n_data_symbols
    L, p_len, cp, cs = cfg.frame_len, cfg.preamble_len, cfg.cp_len, cfg.cs_len
    pad = -(-nd // bk) * bk - nd
    w1, w2, w3 = (F.pad(k["T_G"][q * nd : (q + 1) * nd], (0, 0, 0, pad)) for q in range(3))
    xr, xi = F.pad(data[:, :nd], (0, pad)), F.pad(data[:, nd:], (0, pad))
    batch, ports = data.shape[0], len(shift_indices)
    out = torch.full((batch, ports, 2, L), float("nan"), dtype=data.dtype)
    win = k["win"]
    for r0 in range(0, batch, bm):
        rows = slice(r0, min(r0 + bm, batch))
        a, c = xr[rows], xi[rows]
        s = a + c
        for c0 in range(0, n, bn):
            cols = torch.arange(c0, min(c0 + bn, n))
            p1, p2, p3 = a @ w1[:, cols], c @ w2[:, cols], s @ w3[:, cols]
            core = (p1 - p2, (p3 - p1) - p2)
            for port, si in enumerate(shift_indices):
                shift = int(cfg.cyclic_shifts[si])
                lead = cp + shift  # framed position of core sample 0
                body = cols + lead
                in_cp = cols >= n - lead
                in_cs = cols < cs - shift
                for q, v in enumerate(core):
                    framed = out[rows, port, q, p_len:]
                    framed[:, body] = v * win[body]
                    i = cols[in_cp] - (n - lead)
                    framed[:, i] = v[:, in_cp] * win[i]
                    i = cols[in_cs] + lead + n
                    framed[:, i] = v[:, in_cs] * win[i]
                if c0 == 0:  # the column-0 tiles write the preambles
                    out[rows, port, :, :p_len] = k["preambles"][si]
    return out.reshape(batch, ports, 2 * L)
