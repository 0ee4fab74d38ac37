"""The Tx kernel's tiling and framing rule (csrc/tx.cu), emulated on the CPU.

tests/tx_tile_emulation.py computes the core tile by tile with the
kernel's constants (fused.TX_TILE), k zero-padded to the k-tile, and
scatters each tile's core samples to their framed positions in every port
by the kernel's body / CP / CS rule, into an output pre-filled with NaN.
No position may stay NaN, and the result must equal the plain versions
(_tx_frame_plain, _tx_cdd_plain) within 1e-6: the tiles' products sum k in
another order than one product over the whole batch. The configs: the
canonical one (n_data = 468, N = 576 = 9 tiles) and K = 32 with 26 active
at M = 5 (n_data = 130: a ragged last k-tile and an xi plane 520 bytes into
a row; N = 160: a ragged last column tile); the batches are ragged.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused
from tx_tile_emulation import tx_tiles

torch.set_num_threads(1)

CONFIGS = {
    "canonical": {},
    "n130": dict(subcarriers=32, active_subcarriers=26, timeslots=5, cp_len=8, cs_len=8),
}
SHIFTS = [(0,), (0, 4), (0, 3, 7)]


def _payload(cfg, batch, seed):
    return torch.from_numpy(planar_payload(cfg, batch, seed)).reshape(batch, -1)


def test_tile_constants():
    bm, bn, bk = fused.TX_TILE
    assert bm > 0 and bn % 4 == 0 and bk % 4 == 0  # 16-byte rows of the slabs
    assert GfdmConfig(**CONFIGS["n130"]).n_data_symbols == 130


@pytest.mark.parametrize("batch", [1, 65, 130])
@pytest.mark.parametrize("shifts", SHIFTS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tiles_match_cdd_plain(name, shifts, batch):
    cfg = GfdmConfig(cyclic_shifts=shifts, **CONFIGS[name])
    data = _payload(cfg, batch, 7)
    got = tx_tiles(cfg, data, range(len(shifts)))
    assert not bool(torch.isnan(got).any())
    ref = fused._tx_cdd_plain(cfg, data)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shift_index", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tiles_match_one_port_plain(name, shift_index):
    cfg = GfdmConfig(cyclic_shifts=(0, 3, 7), **CONFIGS[name])
    data = _payload(cfg, 70, 8)
    got = tx_tiles(cfg, data, [shift_index])[:, 0]
    assert not bool(torch.isnan(got).any())
    ref = fused._tx_frame_plain(cfg, data, shift_index)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
