"""Each CUDA kernel of gfdm_tpu_torch against its plain torch version, on the card.

Imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py tests/test_torch_entry.py

Without a CUDA device every test skips. chip_smoke.py runs the same
comparisons at the main path's full batch.
"""
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused

pytestmark = pytest.mark.gpu

B = 1027  # not a multiple of the 8-burst tile: the last tile is masked
CONFIGS = {
    "canonical": GfdmConfig(),
    "k32m5": GfdmConfig(subcarriers=32, active_subcarriers=24, timeslots=5,
                        cp_len=8, cs_len=4),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _payload(cfg, seed, dev):
    return torch.from_numpy(planar_payload(cfg, B, seed)).to(dev)


def _max_err(a, b):
    return float((a.reshape(b.shape) - b).abs().max())


@pytest.mark.parametrize("shift_index", [0, 1])
def test_tx_kernel_matches_plain(shift_index):
    dev = _cuda()
    cfg = GfdmConfig(cyclic_shifts=(0, 4))
    data = _payload(cfg, 60, dev)
    before = fused.LAUNCHES["tx"]
    got = fused.tx_frame_fused(cfg, data, shift_index=shift_index)
    assert fused.LAUNCHES["tx"] == before + 1
    ref = fused._tx_frame_plain(cfg, data.reshape(B, -1), shift_index)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 70, dev))
    gen = torch.Generator(dev).manual_seed(0)
    bursts = bursts + 0.05 * torch.randn(bursts.shape, device=dev, generator=gen)
    before = fused.LAUNCHES["rx"]
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, ic_mode=ic_mode)
    assert fused.LAUNCHES["rx"] == before + 1
    rchan, rsym, rmet = fused._rx_receiver_plain(cfg, bursts.reshape(B, -1), 2, ic_mode)
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4
    rel = ((met[:, 0] - rmet[:, 0]).abs() / rmet[:, 0].abs()).max()
    assert float(rel) < 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    data = _payload(cfg, 80, dev)
    before = fused.LAUNCHES["link"]
    d_hat, _snr, evm = fused.link_single_fused(cfg, data, ic_mode=ic_mode)
    assert fused.LAUNCHES["link"] == before + 1
    ref, _met = fused._link_single_plain(cfg, data.reshape(B, -1), 2, ic_mode)
    assert _max_err(d_hat, ref) < 1e-4
    assert 0.0 < float(evm) < 0.025


def test_receiver_tile_too_large_for_shared_memory_raises():
    """N = 1152 (K=128) needs ~310 KB of shared memory for an 8-burst tile:
    the launch is refused and the wrapper raises; the Tx kernel still runs."""
    dev = _cuda()
    cfg = GfdmConfig(subcarriers=128, active_subcarriers=100, timeslots=9,
                     cp_len=32, cs_len=16)
    data = _payload(cfg, 90, dev)
    bursts = fused.tx_frame_fused(cfg, data)
    assert _max_err(bursts, fused._tx_frame_plain(cfg, data.reshape(B, -1), 0)) < 3e-5
    before = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="gfdm_rx kernel failed to launch"):
        fused.rx_receiver_fused(cfg, bursts)
    with pytest.raises(RuntimeError, match="gfdm_link kernel failed to launch"):
        fused.link_single_fused(cfg, data)
    assert fused.LAUNCHES["rx"] == before["rx"]
    assert fused.LAUNCHES["link"] == before["link"]
