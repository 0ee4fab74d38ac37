"""The port's cyclic-delay-diversity transmitter against the JAX package's.

tx_cdd_fused modulates the core frame once and cuts every port's CP/CS,
window and preamble from it (one CUDA Tx launch); on the CPU its wrapper
runs the plain version, the one-port transmitter at every shift. The Pallas
kernel runs in interpret mode (block=4). Then the two-antenna link of
examples/cdd_two_antenna.py through the port: each port through its own
multipath, summed, received by the dense receiver.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import cdd_link, planar_payload
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops.planar_pipeline import transmit_planar

torch.set_num_threads(1)


@pytest.mark.parametrize("shifts,batch", [((0, 2), 8), ((0, 3, 7), 8), ((0, 4), 5)])
def test_tx_cdd_fused_matches_pallas(shifts, batch):
    """tests/test_pallas.py:175-185's limit, 2e-5; a ragged batch (5) runs
    on the port (the Pallas wrapper needs a multiple of its block)."""
    jc, tc = JaxConfig(cyclic_shifts=shifts), GfdmConfig(cyclic_shifts=shifts)
    data = planar_payload(tc, batch, seed=110)
    got = fused.tx_cdd_fused(tc, torch.from_numpy(data))
    assert got.shape == (batch, len(shifts), 2, tc.frame_len)
    block = 4 if batch % 4 == 0 else batch
    ref = np.asarray(jax_fused.tx_cdd_fused(jc, jnp.asarray(data), block=block))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    # every port equals the one-port transmitter at its shift
    for si in range(len(shifts)):
        one = fused.tx_frame_fused(tc, torch.from_numpy(data), shift_index=si)
        torch.testing.assert_close(got[:, si], one, atol=0, rtol=0)
    planar = transmit_planar(tc, torch.from_numpy(data))
    torch.testing.assert_close(got, planar, atol=2e-5, rtol=0)


def test_cdd_two_antenna_combining():
    """tests/test_link.py:132 on the port: the summed ports act as a
    multipath channel the preamble estimator absorbs (BER proxy < 0.05 at
    shifts (0, 4) on the clean sum), and the example's link (its taps,
    shifts (0, 2)) makes no symbol error at 34 dB. At the example's 28 dB
    both packages sit on an error floor: 22 symbol errors in 512 bursts for
    the JAX package's receive_bursts, 20 for the port."""
    cfg = GfdmConfig(cyclic_shifts=(0, 4))
    data = torch.from_numpy(planar_payload(cfg, 2, seed=50))
    ports = fused.tx_cdd_fused(cfg, data)
    out = fused.receive_bursts_fused(cfg, (ports[:, 0] + ports[:, 1]).contiguous(),
                                     ic_iterations=4)
    ber_proxy = float((torch.sign(out["data"]) != torch.sign(data)).float().mean())
    assert ber_proxy < 0.05

    cfg = GfdmConfig(cyclic_shifts=(0, 2))
    data = torch.from_numpy(planar_payload(cfg, 8, seed=100))
    d_hat = cdd_link(cfg, data, 34.0, seed=3)
    assert int((torch.sign(d_hat) != torch.sign(data)).sum()) == 0
