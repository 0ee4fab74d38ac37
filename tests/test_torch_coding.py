"""The port's coding, soft bits and framing against the JAX package, on the CPU.

The same numpy-seeded inputs go through ``gfdm_tpu`` and ``gfdm_tpu_torch``:
encoder, interleaver, trellis tables, block sizes and framing bit for bit;
the Viterbi decoder bit for bit in every mode on LLRs of a dyadic grid
(multiples of 1/8 in [-16, 16], where every sum is exact whatever its
order), ties and all-zero rows included, and on continuous LLRs at a small
batch; the soft bits within rtol 1e-5 and atol 1e-5 * max|ref|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu import cli as jax_cli
from gfdm_tpu import coding as jax_coding
from gfdm_tpu.ops import softbits as jax_softbits
from gfdm_tpu.ops.rx import constellation_points as jax_points
from gfdm_tpu.utils import framing as jax_framing
from gfdm_tpu_torch import GfdmConfig, cli, coding
from gfdm_tpu_torch.ops import softbits
from gfdm_tpu_torch.ops.rx import constellation_points
from gfdm_tpu_torch.utils import framing
from dyadic_llrs import dyadic_llrs

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
SOFT_RTOL = 1e-5  # softbits: rtol, and atol as a share of max |ref|
MODES = ("auto", "radix", "full", "sm", "windowed")
# n_info whose trellis length T = n_info + 6 is divisible by 4 (the
# canonical QPSK block, 462 -> T = 468, 117 radix-16 steps), by 3 only, by
# 2 only, and by none of them (auto -> full, radix raises; T < 128 also
# makes windowed raise)
N_INFO = (462, 117, 124, 121, 133)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_conv_encode_matches_jax(lead):
    bits = np.random.default_rng(len(lead)).integers(0, 2, lead + (57,)).astype(np.uint8)
    got = coding.conv_encode(bits)
    np.testing.assert_array_equal(got, jax_coding.conv_encode(bits))
    assert got.shape == lead + (coding.coded_bits_per_block(57),)
    assert not coding.conv_encode(np.zeros(9, np.uint8)).any()


@pytest.mark.parametrize("n", [936, 1872, 2808])
def test_interleaver_matches_jax_at_block_sizes(n):
    perm = coding.interleaver(n)
    np.testing.assert_array_equal(perm, jax_coding.interleaver(n))
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))
    np.testing.assert_array_equal(coding.interleaver(n, seed=7),
                                  jax_coding.interleaver(n, seed=7))


def test_interleaver_matches_jax_for_short_lengths():
    for n in range(0, 65):
        got = coding.interleaver(n)
        np.testing.assert_array_equal(got, jax_coding.interleaver(n))
        assert got.dtype == jax_coding.interleaver(n).dtype, n


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_trellis_and_radix_tables_match_jax(k):
    for got, ref in zip(coding._trellis(), jax_coding._trellis()):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    got = coding._radix_tables(k)
    np.testing.assert_array_equal(got, jax_coding._radix_tables(k))
    if k == 1:  # the one-step decoder runs the radix code at k = 1
        np.testing.assert_array_equal(got, 1.0 - 2.0 * jax_coding._trellis()[1])
    # each (ns, j) transition's pattern column carries its signs
    idx = coding._pattern_index(k).reshape(64, 1 << k)
    bit = (idx[..., None] >> np.arange(2 * k - 1, -1, -1)) & 1
    np.testing.assert_array_equal(1.0 - 2.0 * bit, got)


def test_block_sizes_constants_and_framing_match_jax():
    for name in ("CONV_RATE", "CONV_TAIL_BITS", "WINDOW_BODY", "WINDOW_OVERLAP"):
        assert getattr(coding, name) == getattr(jax_coding, name), name
    for n in (0, 1, 50, 462, 930, 1398):
        assert coding.coded_bits_per_block(n) == jax_coding.coded_bits_per_block(n)
    for n in (12, 13, 936, 1872, 2808):
        assert coding.info_bits_for_block(n) == jax_coding.info_bits_for_block(n)
    payload = bytes(np.random.default_rng(3).integers(0, 256, 37, dtype=np.uint8))
    frame = framing.attach_crc32(payload)
    assert frame == jax_framing.attach_crc32(payload)
    assert framing.check_crc32(frame) == jax_framing.check_crc32(frame) == (True, payload)
    bad = frame[:-1] + bytes([frame[-1] ^ 1])
    assert framing.check_crc32(bad) == jax_framing.check_crc32(bad)
    assert framing.check_crc32(b"abc") == (False, b"")
    bits = framing.unpack_bits(frame)
    np.testing.assert_array_equal(bits, jax_framing.unpack_bits(frame))
    np.testing.assert_array_equal(framing.unpack_bits(frame, 13),
                                  jax_framing.unpack_bits(frame, 13))
    assert framing.pack_bits(bits) == jax_framing.pack_bits(bits) == frame
    with pytest.raises(ValueError, match="multiple of 8"):
        framing.pack_bits(bits[:-1])
    for order in (2, 4, 6):
        assert (framing.payload_capacity_bytes(468, order)
                == jax_framing.payload_capacity_bytes(468, order))
        for fec in ("none", "conv"):
            assert (cli.burst_capacity_bytes(TC, order, fec)
                    == jax_cli.burst_capacity_bytes(JC, order, fec))
    odd = GfdmConfig(subcarriers=32, active_subcarriers=25, timeslots=5, cp_len=8,
                     cs_len=4)
    with pytest.raises(ValueError, match="even bits-per-burst"):
        cli.burst_capacity_bytes(odd, 1, "conv")


@pytest.mark.parametrize("fec", ["none", "conv"])
@pytest.mark.parametrize("name", ["qpsk", "qam16", "qam64"])
def test_payload_to_symbols_matches_jax(name, fec):
    order = int(np.log2(constellation_points(name).size))
    cap = cli.burst_capacity_bytes(TC, order, fec)
    payload = bytes(np.random.default_rng(order).integers(0, 256, 2 * cap + 5,
                                                          dtype=np.uint8))
    got, n = cli.payload_to_symbols(TC, payload, name, fec=fec)
    ref, n_ref = jax_cli.payload_to_symbols(JC, payload, name, fec=fec)
    assert n == n_ref == 3 and got.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(constellation_points(name), jax_points(name))
    # noiseless symbols decode to CRC-clean payloads in both packages
    snr = np.full(n, 100.0, np.float32)
    back = cli.symbols_to_payloads(TC, got, name, fec=fec, snr_lin=snr, device="cpu")
    assert back == jax_cli.symbols_to_payloads(JC, ref, name, fec=fec, snr_lin=snr)
    assert all(ok for ok, _ in back)
    assert b"".join(p for _, p in back)[: len(payload)] == payload
    with pytest.raises(ValueError, match="unknown fec"):
        cli.payload_to_symbols(TC, payload, name, fec="ldpc")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_info", N_INFO)
def test_viterbi_matches_jax_on_dyadic_llrs(n_info, mode):
    llrs, bits = dyadic_llrs(n_info, 12, seed=n_info)
    T = n_info + coding.CONV_TAIL_BITS
    try:
        ref = np.asarray(jax_coding.viterbi_decode(llrs, n_info, mode))
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            coding.viterbi_decode(llrs, n_info, mode, device="cpu")
        assert str(got.value) == str(exc)
        assert (mode == "radix" and all(T % k for k in (4, 3, 2))) or (
            mode == "windowed" and T < coding.WINDOW_BODY + 2 * coding.WINDOW_OVERLAP)
        return
    got = coding.viterbi_decode(llrs, n_info, mode, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[0], bits[0])  # the noiseless row
    # the same decode on a leading shape and from float64 LLRs
    lead = coding.viterbi_decode(torch.from_numpy(llrs.astype(np.float64)).view(3, 4, -1),
                                 n_info, mode)
    np.testing.assert_array_equal(lead.reshape(12, n_info).numpy(), ref)


@pytest.mark.parametrize("mode", MODES)
def test_viterbi_matches_jax_on_continuous_llrs(mode):
    """Continuous LLRs (0 dB Es/N0) at a small batch: the branch sums'
    order is explicit (coding._pattern_sums), so no near-tie flips a
    survivor."""
    n_info = 200
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (6, n_info)).astype(np.uint8)
    sym = 1.0 - 2.0 * coding.conv_encode(bits).astype(np.float32)
    noisy = sym + 0.5**0.5 * rng.standard_normal(sym.shape)
    llrs = (4.0 * noisy).astype(np.float32)
    got = coding.viterbi_decode(llrs, n_info, mode, device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_coding.viterbi_decode(llrs, n_info,
                                                                            mode)))
    assert (got != bits).mean() < 0.05


def test_viterbi_errors_and_devices(monkeypatch):
    llrs = np.zeros((2, 2 * 468), np.float32)
    with pytest.raises(ValueError, match="unknown viterbi mode"):
        coding.viterbi_decode(llrs, 462, "bcjr", device="cpu")
    with pytest.raises(ValueError, match="936"):
        coding.viterbi_decode(llrs[:, :-2], 462, device="cpu")
    # a tensor stays on its own device; a NumPy array needs the card or device="cpu"
    assert coding.viterbi_decode(torch.from_numpy(llrs), 462).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coding.viterbi_decode(llrs, 462)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        softbits.maxlog_llrs_planar(np.zeros((1, 2, 4), np.float32),
                                    constellation_points("qpsk"), 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.symbols_to_payloads(TC, np.zeros((1, 468), np.complex64), fec="conv")


def _assert_soft(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=SOFT_RTOL,
                               atol=SOFT_RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", ["qpsk", "qam16", "qam64"])
def test_softbits_match_jax(name):
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((5, 64)) + 1j * rng.standard_normal((5, 64))).astype(
        np.complex64)
    nv = rng.uniform(0.05, 0.5, (5, 1)).astype(np.float32)
    pl = np.stack([s.real, s.imag], axis=1)  # (5, 2, 64)
    pts = constellation_points(name)
    ref = jax_softbits.maxlog_llrs(s, pts, nv)
    _assert_soft(softbits.maxlog_llrs(torch.from_numpy(s), pts, torch.from_numpy(nv)), ref)
    ref_pl = jax_softbits.maxlog_llrs_planar(pl, pts, nv)
    _assert_soft(softbits.maxlog_llrs_planar(pl, pts, nv, device="cpu"), ref_pl)
    if name == "qpsk":
        nv1 = nv[:, 0]
        _assert_soft(softbits.qpsk_llrs(s, nv1, device="cpu"),
                     jax_softbits.qpsk_llrs(jnp.asarray(s), jnp.asarray(nv1)))
        _assert_soft(softbits.qpsk_llrs_planar(torch.from_numpy(pl), torch.from_numpy(nv1)),
                     jax_softbits.qpsk_llrs_planar(jnp.asarray(pl), jnp.asarray(nv1)))
        # Gray QPSK: the max-log LLRs reduce to the scaled components
        np.testing.assert_allclose(
            softbits.maxlog_llrs_planar(pl, pts, nv, device="cpu").numpy(),
            softbits.qpsk_llrs_planar(pl, nv1, device="cpu").numpy(), rtol=1e-4,
            atol=1e-4)
