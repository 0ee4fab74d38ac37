"""The port's detection and extraction against the JAX package's, on the CPU.

Same numpy-seeded float32 chunks into both packages. The JAX Pallas
detection kernels run in interpret mode, as tests/test_detection.py runs
them; the port's wrappers run their kernels' plain torch versions on CPU
tensors (tests/test_torch_gpu.py holds the CUDA kernels against those on the
card). ``DETECT_IMPL`` is switched with monkeypatch in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import detect as jax_detect
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu.ops import sync as jax_sync
from gfdm_tpu.ops import tx as jax_tx
from gfdm_tpu.ref import utils
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.kernels import detect
from gfdm_tpu_torch.ops import planar_pipeline as pp
from gfdm_tpu_torch.ops import sync

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
CHUNK = 2048
HALO = TC.frame_len + TC.cp_len
PEAK_TOL = dict(rtol=1e-4, atol=1e-6)
KEYS = ("cfo", "scale", "strength", "ac_peak", "noise_floor")


def _burst_chunks(n, snr_db, seed, trim=0, off=300):
    """One burst per chunk at ``off``, AWGN at ``snr_db`` over the burst."""
    data = np.stack([utils.random_qpsk(JC.n_data_symbols, seed=seed + i)
                     for i in range(n)]).astype(np.complex64)
    bursts = np.asarray(jax_tx.transmit(JC, data))[:, 0, :]
    sigma = np.sqrt(np.mean(np.abs(bursts) ** 2) / 10 ** (snr_db / 10.0))
    rng = np.random.default_rng(seed + 7777)
    chunks = sigma / np.sqrt(2.0) * rng.standard_normal((n, 2, CHUNK + HALO))
    chunks[:, 0, off : off + JC.frame_len] += bursts.real
    chunks[:, 1, off : off + JC.frame_len] += bursts.imag
    return chunks[..., : CHUNK + HALO - trim].astype(np.float32)


def _both(chunks):
    return jnp.asarray(chunks), torch.from_numpy(chunks)


def _assert_dict(got, ref, keys=KEYS, start="equal"):
    if start == "equal":
        np.testing.assert_array_equal(got["start"].numpy(), np.asarray(ref["start"]))
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   err_msg=key, **PEAK_TOL)


@pytest.mark.parametrize("impl,dtype_name,tol", [
    ("matmul", "float32", dict(rtol=1e-4, atol=1e-6)),
    ("matmul", "bfloat16", dict(rtol=1e-4, atol=1e-6)),
    # the cumsum sliding sums carry ~1e-5 absolute error in either package
    # (the JAX package's own conv-vs-matmul limit, test_detection.py)
    ("conv", "float32", dict(rtol=2e-4, atol=2e-5)),
])
@pytest.mark.parametrize("trim", [0, 5])
def test_front_end_matches_jax(impl, dtype_name, tol, trim):
    s_j, s_t = _both(_burst_chunks(3, 12.0, seed=900, trim=trim))
    ref = jax_pp._detect_front_planar(JC, jax_pp._detect_consts(JC, dtype_name), s_j,
                                      CHUNK, impl=impl, dtype_name=dtype_name)
    got = pp._detect_front_planar(TC, pp._detect_kernel(TC, dtype_name, "cpu"), s_t,
                                  CHUNK, impl=impl, dtype_name=dtype_name)
    for name, r, g in zip(("gated", "ac", "energy", "ic"), ref, got):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **tol)


def test_bf16_front_end_rounds_where_jax_rounds():
    """Samples, products, window sums and |ac| are rounded to bf16 (RNE) at
    the JAX package's points and the band sums run in float32 on the
    rounded operands: the autocorrelation, energy and ic traces come out
    bit-identical."""
    s_j, s_t = _both(_burst_chunks(3, 8.0, seed=904))
    ref = jax_pp._detect_front_planar(JC, None, s_j, CHUNK, impl="matmul",
                                      dtype_name="bfloat16")
    got = pp._detect_front_planar(TC, None, s_t, CHUNK, impl="matmul",
                                  dtype_name="bfloat16")
    for name, r, g in zip(("gated", "ac", "energy", "ic"), ref, got):
        if name != "gated":  # gated: float32 xcorr sums in another order
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("trim", [0, 5])
def test_front_kernel_plain_matches_pallas(trim):
    s_j, s_t = _both(_burst_chunks(3, 12.0, seed=901, trim=trim))
    ref = jax_detect.detect_front_pallas(JC, s_j, CHUNK)
    before = dict(detect.LAUNCHES)
    got = detect.detect_front_fused(TC, s_t, CHUNK)
    assert detect.LAUNCHES == before  # CPU tensors: the plain version
    for name, r, g in zip(("gated", "ac", "energy", "ic"), ref, got):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name, **PEAK_TOL)


@pytest.mark.parametrize("trim", [0, 5])
def test_lean_kernel_plain_matches_pallas(trim):
    s_j, s_t = _both(_burst_chunks(6, 12.0, seed=902, trim=trim))
    ref = jax_detect.detect_bursts_pallas(JC, s_j, CHUNK, c_chunks=3)
    got = detect.detect_bursts_fused(TC, s_t, CHUNK)
    _assert_dict(got, ref)
    assert set(got) == set(ref)


@pytest.mark.parametrize("impl", ["pallas", "pallas2", "matmul", "conv"])
def test_dispatch_by_detect_impl_matches_jax(impl, monkeypatch):
    """detect_bursts_planar under each DETECT_IMPL against the JAX package
    under the same setting (pallas: front kernel + dense epilogue; pallas2:
    the trace-lean kernel's dict)."""
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", impl)
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    s_j, s_t = _both(_burst_chunks(4, 10.0, seed=905))
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK)
    got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK)
    assert set(got) == set(ref)
    _assert_dict(got, ref)


def test_twostage_float32_matches_jax():
    s_j, s_t = _both(_burst_chunks(8, 15.0, seed=907))
    assert pp.DETECT_IMPL == jax_pp.DETECT_IMPL == "twostage"
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK)
    got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK)
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(ref["start"]))
    np.testing.assert_allclose(got["cfo"].numpy(), np.asarray(ref["cfo"]), atol=1e-6)
    _assert_dict(got, ref)
    np.testing.assert_allclose(got["ac_metric"].numpy(), np.asarray(ref["ac_metric"]),
                               **PEAK_TOL)


def test_twostage_bfloat16_matches_jax():
    """The bf16 budget of test_detection.py::test_bfloat16_detection_quality."""
    s_j, s_t = _both(_burst_chunks(16, 10.0, seed=903))
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK, dtype_name="bfloat16")
    got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK, dtype_name="bfloat16")
    assert np.all(np.abs(got["start"].numpy() - np.asarray(ref["start"])) <= 1)
    np.testing.assert_allclose(got["cfo"].numpy(), np.asarray(ref["cfo"]), atol=2e-3)
    np.testing.assert_array_equal(sync.detection_valid(got, 1e-4).numpy(),
                                  np.asarray(jax_sync.detection_valid(ref, 1e-4)))


def test_twostage_falls_back_on_unaligned_chunks():
    """T % 128 != 0: the dense front, as in the JAX package."""
    s_j, s_t = _both(_burst_chunks(4, 15.0, seed=906, trim=1))
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK)
    got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK)
    _assert_dict(got, ref)
    assert np.all(np.abs(got["start"].numpy() - (300 + TC.cp_len)) <= 2)


def test_twostage_short_aligned_chunks_take_the_dense_form(monkeypatch):
    """A recorded divergence: for 128-aligned chunks shorter than the NB
    gathered blocks (T < 640 at K = 64) the JAX package's twostage clamps
    its window start below 0 and reports negative starts; the port's
    dispatcher takes the dense front there, as it does for unaligned T."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 2, 512)).astype(np.float32)
    s_j, s_t = _both(x)
    assert pp._twostage_blocks(TC) * 128 == 640
    got = pp.detect_bursts_planar(TC, s_t, search_limit=300)
    assert (got["start"] >= 0).all()
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", "matmul")
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=300)
    _assert_dict(got, ref)
    monkeypatch.setattr(pp, "DETECT_IMPL", "matmul")
    dense = pp.detect_bursts_planar(TC, s_t, search_limit=300)
    for key in dense:
        assert torch.equal(dense[key], got[key]), key


@pytest.mark.parametrize("impl", ["twostage", "pallas"])
def test_topk_matches_jax(impl, monkeypatch):
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", impl)
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    chunks = _burst_chunks(4, 15.0, seed=700)
    # a second burst in two of the chunks, one frame and more away
    chunks[:2, :, 1300:] += chunks[:2, :, 300 : 300 + chunks.shape[-1] - 1300]
    s_j, s_t = _both(chunks)
    ref = jax_pp.detect_bursts_topk_planar(JC, s_j, max_bursts=3, search_limit=CHUNK)
    got = pp.detect_bursts_topk_planar(TC, s_t, max_bursts=3, search_limit=CHUNK)
    assert got["start"].shape == (4, 3) and got["noise_floor"].shape == (4,)
    _assert_dict(got, ref)
    jax_ref_valid = np.asarray(jax_sync.detection_valid(ref, 1e-4))
    np.testing.assert_array_equal(sync.detection_valid(got, 1e-4).numpy(), jax_ref_valid)
    assert jax_ref_valid[:, 0].all() and jax_ref_valid[:2, 1].all()


def test_pallas2_topk_runs_the_conv_form_like_jax(monkeypatch):
    """A mirrored quirk: under "pallas2" the full-trace front end is neither
    "matmul" nor "pallas", so top-k runs the conv form - in float32 equal
    to the JAX package's, and with bf16 both packages refuse the mixed
    dtypes with a TypeError."""
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", "pallas2")
    monkeypatch.setattr(pp, "DETECT_IMPL", "pallas2")
    s_j, s_t = _both(_burst_chunks(3, 15.0, seed=701))
    ref = jax_pp.detect_bursts_topk_planar(JC, s_j, max_bursts=2, search_limit=CHUNK)
    got = pp.detect_bursts_topk_planar(TC, s_t, max_bursts=2, search_limit=CHUNK)
    monkeypatch.setattr(pp, "DETECT_IMPL", "conv")
    conv = pp.detect_bursts_topk_planar(TC, s_t, max_bursts=2, search_limit=CHUNK)
    _assert_dict(got, ref)
    for key in conv:
        assert torch.equal(conv[key], got[key]), key
    with pytest.raises(TypeError, match="same dtypes"):
        jax_pp.detect_bursts_topk_planar(JC, s_j, 2, search_limit=CHUNK,
                                         dtype_name="bfloat16")
    monkeypatch.setattr(pp, "DETECT_IMPL", "pallas2")
    with pytest.raises(TypeError, match="same dtypes"):
        pp.detect_bursts_topk_planar(TC, s_t, 2, search_limit=CHUNK,
                                     dtype_name="bfloat16")


def test_noise_floor_median_has_jax_semantics():
    """jnp.median averages the two middle values of an even-length input;
    torch.median returns the lower one. The floor is the median of
    ic[:n_valid:8], 256 entries at chunk_len 2048 - an even count."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (5, 256)).astype(np.float32)
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=-1))
    got = pp._median(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(torch.median(torch.from_numpy(x), dim=-1).values.numpy(), ref)
    odd = x[:, :255]
    np.testing.assert_array_equal(pp._median(torch.from_numpy(odd)).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(odd), axis=-1)))
    assert float(pp._median(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.5


@pytest.mark.parametrize("impl", ["twostage", "matmul", "conv", "pallas", "pallas2"])
def test_argmax_takes_the_first_of_tied_maxima(impl, monkeypatch):
    """All-zero chunks tie every position: each detector (and twostage's
    -1.0-filled window, whose valid positions all gate to 0) picks position
    0, the first maximum, as the JAX package does."""
    monkeypatch.setattr(jax_pp, "DETECT_IMPL", impl)
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    s_j, s_t = _both(np.zeros((2, 2, CHUNK + HALO), np.float32))
    ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK)
    got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK)
    np.testing.assert_array_equal(got["start"].numpy(), np.asarray(ref["start"]))
    assert not got["start"].any()
    if impl != "pallas2":
        topk = pp.detect_bursts_topk_planar(TC, s_t, max_bursts=2, search_limit=CHUNK)
        ref_k = jax_pp.detect_bursts_topk_planar(JC, s_j, max_bursts=2, search_limit=CHUNK)
        np.testing.assert_array_equal(topk["start"].numpy(), np.asarray(ref_k["start"]))
    tied = torch.tensor([[0.5, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    np.testing.assert_array_equal(torch.argmax(tied, dim=-1).numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(tied.numpy()), axis=-1)))


def test_detection_threshold_and_valid_match_jax():
    for pfa in (1e-2, 1e-4, 1e-6):
        assert sync.detection_threshold(pfa, 0.1) == jax_sync.detection_threshold(pfa, 0.1)
    assert sync.RAYLEIGH_MEDIAN_TO_MEAN == jax_sync.RAYLEIGH_MEDIAN_TO_MEAN
    rng = np.random.default_rng(5)
    det = {"ac_peak": rng.uniform(0, 1, (6, 3)).astype(np.float32),
           "noise_floor": rng.uniform(0, 0.3, 6).astype(np.float32)}
    ref = np.asarray(jax_sync.detection_valid(
        {k: jnp.asarray(v) for k, v in det.items()}, 1e-4))
    got = sync.detection_valid({k: torch.from_numpy(v) for k, v in det.items()}, 1e-4)
    np.testing.assert_array_equal(got.numpy(), ref)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    np.testing.assert_allclose(sync.moving_sum(torch.from_numpy(x), 7).numpy(),
                               np.asarray(jax_sync.moving_sum(jnp.asarray(x), 7)),
                               atol=1e-5)


def _extract_args(B=16, T=CHUNK + HALO, seed=41):
    rng = np.random.default_rng(seed)
    stream = rng.standard_normal((B, 2, T)).astype(np.float32)
    start = np.concatenate([[0, 1, T - 1, T, T + 900], rng.integers(0, CHUNK, B - 5)])
    scale = rng.uniform(0.5, 2.0, B).astype(np.float32)
    cfo = rng.uniform(-0.05, 0.05, B).astype(np.float32)
    return stream, start, scale, cfo


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("correct_cfo", [True, False])
def test_extraction_matches_jax(dtype_name, correct_cfo):
    """Barrel and slice forms, starts at 0, 1, T-1, T and past T (zero-fill
    pre-roll, clipped starts). Barrel equals slice bit for bit; without the
    CFO derotation (cos/sin differ by an ulp between the libraries) the
    port equals the JAX package bit for bit, bf16 rounding included."""
    args = _extract_args()
    jargs = tuple(jnp.asarray(a) for a in args)
    targs = tuple(torch.from_numpy(np.asarray(a)) for a in args)
    L, bo = TC.frame_len, TC.cp_len
    ref = np.asarray(jax_pp._extract_fn_planar(JC, L, bo, correct_cfo, "barrel",
                                               dtype_name)(*jargs))
    barrel = pp._extract_fn_planar(TC, L, bo, correct_cfo, "barrel", dtype_name)(*targs)
    if dtype_name == "float32":
        sl = pp._extract_fn_planar(TC, L, bo, correct_cfo, "slice", dtype_name)(*targs)
        assert torch.equal(barrel, sl)
    if correct_cfo:
        np.testing.assert_allclose(barrel.numpy(), ref, atol=2e-6)
    else:
        np.testing.assert_array_equal(barrel.numpy(), ref)
    # starts at T and past T read the last cp_len samples (the pre-roll),
    # then zeros
    assert not barrel[3:5, :, TC.cp_len :].any() and barrel[3:5].any()


def test_extract_bursts_planar_public_api():
    args = _extract_args(B=6, seed=42)
    det_t = {"start": torch.from_numpy(args[1][:6]), "scale": torch.from_numpy(args[2]),
             "cfo": torch.from_numpy(args[3])}
    det_j = {k: jnp.asarray(v.numpy()) for k, v in det_t.items()}
    for dt in ("float32", "bfloat16"):
        got = pp.extract_bursts_planar(TC, torch.from_numpy(args[0]), det_t, dtype_name=dt)
        ref = jax_pp.extract_bursts_planar(JC, jnp.asarray(args[0]), det_j, dtype_name=dt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_refine_cfo_matches_jax():
    chunks = _burst_chunks(4, 12.0, seed=910)
    rng = np.random.default_rng(11)
    res = rng.uniform(-0.02, 0.02, 4)
    n = np.arange(TC.frame_len)
    bursts = chunks[:, :, 300 : 300 + TC.frame_len].astype(np.float64)
    rot = np.exp(2j * np.pi * res[:, None] * n / TC.subcarriers)
    cplx = (bursts[:, 0] + 1j * bursts[:, 1]) * rot
    bursts = np.stack([cplx.real, cplx.imag], axis=1).astype(np.float32)
    ref, fine_ref = jax_pp.refine_cfo_planar(JC, jnp.asarray(bursts))
    got, fine = pp.refine_cfo_planar(TC, torch.from_numpy(bursts))
    np.testing.assert_allclose(fine.numpy(), np.asarray(fine_ref), atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)
    np.testing.assert_allclose(fine.numpy(), res, atol=3e-3)
    for skip in (0, 4):
        _, f_ref = jax_pp.refine_cfo_planar(JC, jnp.asarray(bursts), skip=skip)
        _, f = pp.refine_cfo_planar(TC, torch.from_numpy(bursts), skip=skip)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-7)


def test_detection_wrappers_validate_inputs():
    s = torch.zeros(2, 2, CHUNK + HALO)
    with pytest.raises(TypeError, match="float32"):
        detect.detect_bursts_fused(TC, s.double(), CHUNK)
    with pytest.raises(ValueError, match="planar"):
        detect.detect_front_fused(TC, torch.zeros(2, 3, 500), CHUNK)
    with pytest.raises(ValueError, match="2K"):
        detect.detect_front_fused(TC, torch.zeros(2, 2, 2 * TC.subcarriers), CHUNK)
    # leading axes pass through, as in the JAX wrappers
    out = detect.detect_bursts_fused(TC, torch.zeros(3, 2, 2, 1000), 500)
    assert out["start"].shape == (3, 2)


@pytest.mark.parametrize("snr_db", [0.0, 2.0, 4.0])
def test_low_snr_starts_match_jax_and_twostage_parity(snr_db, monkeypatch):
    """Low-SNR detection parity (ROADMAP Queue 3: twostage against the dense
    front was pinned only at 15 dB). 32 friendly service chunks at 0, 2 and
    4 dB into both packages: the port's "twostage" and "pallas2" starts
    equal the JAX package's (its Pallas kernel in interpret mode), and the
    chunks where twostage's start differs from the dense front's ("matmul")
    are the same chunks in both packages."""
    from gfdm_tpu_torch.entry import service_stream

    chunks, _counts, _payload = service_stream(TC, 32, CHUNK, snr_db, False,
                                               np.random.default_rng(40 + int(snr_db)))
    s_j, s_t = _both(chunks)
    starts = {}
    for impl in ("twostage", "pallas2", "matmul"):
        monkeypatch.setattr(jax_pp, "DETECT_IMPL", impl)
        monkeypatch.setattr(pp, "DETECT_IMPL", impl)
        ref = jax_pp.detect_bursts_planar(JC, s_j, search_limit=CHUNK)
        got = pp.detect_bursts_planar(TC, s_t, search_limit=CHUNK)
        starts[impl] = (np.asarray(ref["start"]), got["start"].numpy())
    for impl in ("twostage", "pallas2"):
        np.testing.assert_array_equal(starts[impl][1], starts[impl][0], err_msg=impl)
    jax_off, port_off = (starts["twostage"][i] != starts["matmul"][i] for i in (0, 1))
    np.testing.assert_array_equal(port_off, jax_off)
