"""The receiver and link options of the port's dense kernels against JAX's.

On the CPU the wrappers run the kernels' plain versions; the Pallas kernels
run in interpret mode as tests/test_pallas.py runs them (block=4, B=8), on
the same numpy-seeded float32 inputs. Covers every option the CUDA receiver
and link kernels take: equalizer mmse / mmse_cnr, qam16 / qam64 IC
decisions and amplitudes, the qpsk_amp override and the one-shot phase
compensation (both IC modes), the link's qam decisions and bf16 stacks, and
the fused-engine streaming service across its option matrix.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu.ops import planar as jax_planar
from gfdm_tpu.ops import tx as jax_tx
from gfdm_tpu.ref import symbolmapping
from gfdm_tpu.runtime import service as jax_service
from gfdm_tpu.runtime.stream import chunk_with_lookahead
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops.rx import constellation_points
from gfdm_tpu_torch.runtime import service

torch.set_num_threads(1)

B = 8
JC, TC = JaxConfig(), GfdmConfig()
SYM_ATOL = 2e-3  # tests/test_pallas.py:328-414, the fused receiver's options
CHAN_ATOL = 2e-4
DATA_ATOL = 2e-3


def _qam_payload(order: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pts = symbolmapping.constellation(order)
    d = np.stack([symbolmapping.bits_to_symbols(rng.integers(0, 2, order * JC.n_data_symbols),
                                                pts) for _ in range(B)])
    return np.asarray(jax_planar.to_planar(d.astype(np.complex64)))


def _bursts(data: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    bursts = np.asarray(jax_fused.tx_frame_fused(JC, jnp.asarray(data), block=4))
    noise = np.random.default_rng(seed).standard_normal(bursts.shape)
    return (bursts + sigma * noise).astype(np.float32)


def _rotated(bursts: np.ndarray, phi: float = 0.1) -> np.ndarray:
    """The data section rotated by a common phase (the residual-CPO case of
    tests/test_pallas.py: the preamble estimate absorbs a whole-burst one)."""
    c, s = np.cos(phi), np.sin(phi)
    p = JC.preamble_len
    rot = bursts.copy()
    rot[:, 0, p:] = c * bursts[:, 0, p:] - s * bursts[:, 1, p:]
    rot[:, 1, p:] = s * bursts[:, 0, p:] + c * bursts[:, 1, p:]
    return rot.astype(np.float32)


CASES = {
    "mmse-qpsk": (dict(equalizer="mmse"), "qpsk", 0.05),
    "mmse_cnr-qpsk": (dict(equalizer="mmse_cnr"), "qpsk", 0.05),
    "mmse_cnr-qam16": (dict(equalizer="mmse_cnr", constellation="qam16"), "qam16", 0.01),
    "mmse-qam64": (dict(equalizer="mmse", constellation="qam64"), "qam64", 0.005),
    "zf-qam16": (dict(constellation="qam16"), "qam16", 0.01),
    "phase": (dict(phase_compensation=True), "rotated", 0.0),
    "qpsk_amp": (dict(qpsk_amp=0.6), "qpsk", 0.02),
}


def _case_bursts(kind: str, sigma: float) -> np.ndarray:
    if kind in ("qam16", "qam64"):
        return _bursts(_qam_payload({"qam16": 4, "qam64": 6}[kind], 17), sigma, 18)
    bursts = _bursts(planar_payload(JC, B, 130), sigma, 5)
    return _rotated(bursts) if kind == "rotated" else bursts


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rx_receiver_fused_option_matches_pallas(case, ic_mode):
    options, kind, sigma = CASES[case]
    bursts = _case_bursts(kind, sigma)
    chan_r, sym_r, met_r = jax_fused.rx_receiver_fused(
        JC, jnp.asarray(bursts), ic_iterations=2, block=4, ic_mode=ic_mode, **options)
    chan, sym, met = fused.rx_receiver_fused(TC, torch.from_numpy(bursts), ic_iterations=2,
                                             ic_mode=ic_mode, **options)
    np.testing.assert_allclose(chan.numpy(), np.asarray(chan_r), atol=CHAN_ATOL)
    np.testing.assert_allclose(sym.numpy(), np.asarray(sym_r), atol=SYM_ATOL)
    np.testing.assert_allclose(met[:, 0].numpy(), np.asarray(met_r)[:, 0], rtol=1e-3)


def test_phase_compensation_corrects_the_rotation():
    """tests/test_pallas.py's check on the port: without the correction the
    symbols stay rotated by ~phi."""
    data = planar_payload(JC, B, 110)
    rot = torch.from_numpy(_rotated(_bursts(data, 0.0, 0)))
    idx = fused._kernel_consts(TC, "cpu")["demap_idx"]
    err = {}
    for on in (True, False):
        _c, sym, _m = fused.rx_receiver_fused(TC, rot, phase_compensation=on)
        err[on] = float((sym[..., idx] - torch.from_numpy(data)).abs().max())
    assert err[False] > 2 * err[True]


@pytest.mark.parametrize("name", ["qam16", "qam64"])
def test_qam_decisions_round_half_to_even(name):
    """Decision inputs whose (u scale - 1) / 2 is exactly k + 1/2 in float32:
    the level is 2 round(.) + 1 with round half to even (jnp.round's rule,
    the kernels' rintf), never half away from zero (roundf)."""
    scale, lim = fused._QAM_LEVELS[name]
    s32 = np.float32(scale)
    ties, want = [], []
    for k in range(-4, 4):
        target = np.float32(2 * k + 2)  # u s = 2k + 2 -> (u s - 1) / 2 = k + 1/2
        u = np.float32(target / s32)
        for _ in range(64):  # walk to a u whose float32 product is exact
            prod = np.float32(u * s32)
            if prod == target:
                break
            u = np.nextafter(u, np.float32(np.inf if prod < target else -np.inf))
        if np.float32(u * s32) == target:
            ties.append(u)
            even = k if k % 2 == 0 else k + 1
            want.append(float(np.clip(2 * even + 1, -lim, lim)))
    assert len(ties) >= 4
    u = np.asarray(ties, dtype=np.float32)
    ours = fused._ic_level(torch.from_numpy(u), name).numpy()
    theirs = np.asarray(jax_fused._ic_decide(jnp.asarray(u), jnp.asarray(u), name)[0])
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(theirs, want)


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("name", ["qam16", "qam64"])
def test_link_single_fused_qam_matches_pallas(name, ic_mode):
    data = _qam_payload({"qam16": 4, "qam64": 6}[name], 31)
    d_ref, _s, evm_ref = jax_fused.link_single_fused(JC, jnp.asarray(data), block=4,
                                                     constellation=name, ic_mode=ic_mode)
    d_got, _s, evm_got = fused.link_single_fused(TC, torch.from_numpy(data),
                                                 constellation=name, ic_mode=ic_mode)
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=DATA_ATOL)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_single_fused_bf16_matches_pallas(ic_mode):
    """bf16 Gauss stacks, activations rounded to bf16 before each product.
    Float32 sums taken in another order can leave an activation on the other
    side of a bf16 rounding boundary; one such activation moves every output
    of its burst by up to 2^-8 of its share (this seed: one burst by ~4e-3).
    So every burst but one holds DATA_ATOL, that one 1e-2, and the EVM
    agrees to 1e-4."""
    data = planar_payload(JC, B, 302)
    d_ref, _s, evm_ref = jax_fused.link_single_fused(
        JC, jnp.asarray(data), block=4, dtype_name="bfloat16", ic_mode=ic_mode)
    d_got, _s, evm_got = fused.link_single_fused(
        TC, torch.from_numpy(data), dtype_name="bfloat16", ic_mode=ic_mode)
    per_burst = np.abs(d_got.numpy() - np.asarray(d_ref)).reshape(B, -1).max(axis=1)
    assert (per_burst > DATA_ATOL).sum() <= 1 and per_burst.max() < 1e-2
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4
    f32 = float(fused.link_single_fused(TC, torch.from_numpy(data), ic_mode=ic_mode)[2])
    assert f32 < float(evm_got) < 0.025  # bf16 operator noise on the MF/IC floor


def test_options_validate():
    bursts = torch.zeros(2, 2, TC.frame_len)
    data = torch.zeros(2, 2, TC.n_data_symbols)
    for kw in ({"equalizer": "lmmse"}, {"constellation": "qam256"}, {"ic_mode": "fft"}):
        with pytest.raises(ValueError, match=next(iter(kw))):
            fused.rx_receiver_fused(TC, bursts, **kw)
    with pytest.raises(ValueError, match="dtype_name"):
        fused.link_single_fused(TC, data, dtype_name="float16")
    with pytest.raises(ValueError, match="constellation"):
        fused.link_single_fused(TC, data, constellation="8psk")


# ---------------------------------------------------------------------------
# the fused-engine service across its option matrix
# ---------------------------------------------------------------------------
CHUNK = 2048


def _option_stream(constellation: str) -> tuple[np.ndarray, np.ndarray]:
    """tests/test_stream_eval.py:636's stream: two bursts of the
    constellation's points in 8 chunks of AWGN."""
    points = constellation_points(constellation)
    rng = np.random.default_rng(220)
    data = points[rng.integers(0, points.size, (2, JC.n_data_symbols))].astype(np.complex64)
    bursts = np.asarray(jax_tx.transmit(JC, data))[:, 0, :]
    stream = np.zeros(8 * CHUNK, dtype=np.complex64)
    rng = np.random.default_rng(13)
    noise_amp = 0.002 if constellation == "qam64" else 0.005
    stream += noise_amp * (rng.standard_normal(stream.size)
                           + 1j * rng.standard_normal(stream.size)).astype(np.complex64)
    for b, off in zip(bursts, [400, 5 * CHUNK + 90]):
        stream[off : off + JC.frame_len] += b
    halo = JC.frame_len + JC.cp_len
    chunks = np.asarray(chunk_with_lookahead(jnp.asarray(jax_planar.to_planar(stream)),
                                             CHUNK, halo))
    return np.ascontiguousarray(np.moveaxis(chunks, -2, -3)), data


@pytest.mark.parametrize("equalizer,constellation", [
    ("zf", "qpsk"), ("mmse", "qam16"), ("mmse_cnr", "qpsk"), ("mmse_cnr", "qam16"),
    ("mmse", "qam64"),
])
def test_service_fused_engine_option_matrix_matches_jax(equalizer, constellation):
    chunks, data = _option_stream(constellation)
    kw = dict(chunk_len=CHUNK, engine="fused", equalizer=equalizer,
              constellation=constellation, dtype_name="float32")
    ref = jax_service.StreamingReceiver(JC, **kw).step(chunks)
    before = dict(fused.LAUNCHES)
    got = service.StreamingReceiver(TC, device="cpu", **kw).step(chunks)
    assert fused.LAUNCHES == before
    np.testing.assert_array_equal(got["found"], ref["found"])
    assert got["found"].sum() == 2
    f = ref["found"]  # the other slots hold noise picks, amplified by the ZF
    np.testing.assert_allclose(got["data"][f], ref["data"][f], atol=DATA_ATOL)
    np.testing.assert_allclose(got["snr_lin"][f], ref["snr_lin"][f], rtol=1e-3)
    d_hat = got["data"][f]
    points = constellation_points(constellation)

    def nearest(x):
        return np.argmin(np.abs(x[..., None] - points), axis=-1)

    np.testing.assert_array_equal(nearest(d_hat[:, 0] + 1j * d_hat[:, 1]), nearest(data))
