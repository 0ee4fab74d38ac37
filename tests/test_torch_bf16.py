"""The planar torch-op link's bfloat16 mode against the JAX package's (CPU).

``dtype_name="bfloat16"`` of transmit_planar / receive_bursts_planar /
link_step_planar: every big operator is bf16 (rounded once from float64),
small constants stay float32, and each operator product rounds its
activation to bf16 and sums in float32. The same numpy-seeded payload goes
through gfdm_tpu.ops.planar_pipeline and the port at dtype_name="bfloat16",
dense and fast, at the canonical config and at k32m5 (the factored tests'
narrow config), B = 8, seed 0. Limits: data within 1e-2 a burst (the bf16
link limit of PERF.md section 2: float32 sums in another order can leave an
activation on the other side of a bf16 rounding boundary) and the EVM
within 1e-4 of JAX's. The operators are held bit for bit; the chunk
receiver (runtime.stream) takes the mode too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.ops import planar_fast as jax_pf
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu.ops.rx import constellation_points
from gfdm_tpu.runtime import stream as jax_stream
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.convert import operators_from_numpy
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.ops import planar_fast as pf
from gfdm_tpu_torch.ops import planar_pipeline as pp
from gfdm_tpu_torch.runtime import stream

torch.set_num_threads(1)

B = 8
DATA_TOL, EVM_TOL = 1e-2, 1e-4
CONFIGS = {
    "canonical": {},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
}
CASES = [(name, method) for name in sorted(CONFIGS) for method in ("dense", "fast")]


def _pair(name):
    kw = CONFIGS[name]
    return JaxConfig(**kw), GfdmConfig(**kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("name,method", CASES)
def test_link_step_bf16_matches_jax(name, method):
    jc, tc = _pair(name)
    data = planar_payload(tc, B, 0)
    d_ref, _snr, evm_ref = jax_pp.link_step_planar(jc, jnp.asarray(data),
                                                   dtype_name="bfloat16", method=method)
    d_got, _snr, evm_got = pp.link_step_planar(tc, torch.from_numpy(data),
                                               dtype_name="bfloat16", method=method)
    assert d_got.dtype == torch.float32 and d_got.shape == data.shape
    per_burst = np.abs(d_got.numpy() - np.asarray(d_ref)).reshape(B, -1).max(axis=1)
    assert per_burst.max() <= DATA_TOL, per_burst
    assert abs(float(evm_got) - float(evm_ref)) <= EVM_TOL
    # the bf16 operators move the link off its float32 result
    evm_f32 = float(pp.link_step_planar(tc, torch.from_numpy(data), method=method)[2])
    assert float(evm_got) != evm_f32


@pytest.mark.parametrize("name,method", CASES)
def test_transmit_and_receive_bf16_match_jax(name, method):
    jc, tc = _pair(name)
    data = planar_payload(tc, B, 0)
    ref = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data), dtype_name="bfloat16",
                                            method=method))
    got = pp.transmit_planar(tc, torch.from_numpy(data), dtype_name="bfloat16", method=method)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    rng = np.random.default_rng(1)
    bursts = (ref[:, 0] + 0.01 * rng.standard_normal(ref[:, 0].shape)).astype(np.float32)
    r = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), dtype_name="bfloat16",
                                     method=method)
    g = pp.receive_bursts_planar(tc, torch.from_numpy(bursts), dtype_name="bfloat16",
                                 method=method)
    np.testing.assert_allclose(g["channel"].numpy(), np.asarray(r["channel"]), atol=2e-4)
    np.testing.assert_allclose(g["snr_lin"].numpy(), np.asarray(r["snr_lin"]), rtol=1e-3)
    per_burst = np.abs(g["symbols"].numpy() - np.asarray(r["symbols"])).reshape(B, -1).max(1)
    assert per_burst.max() <= DATA_TOL, per_burst


@pytest.mark.parametrize("equalizer,constellation", [("mmse_cnr", "qpsk"), ("mmse", "qam16")])
def test_receive_bf16_options_match_jax(equalizer, constellation):
    """mmse_cnr's CNRs meet the bf16 CNRI_T upcast (jnp promotes), qam16's
    decisions the bf16 C_W."""
    jc, tc = _pair("canonical")
    pts = constellation_points(constellation)
    idx = np.random.default_rng(2).integers(0, pts.size, (B, tc.n_data_symbols))
    data = np.stack([pts[idx].real, pts[idx].imag], axis=1).astype(np.float32)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data)))[:, 0]
    bursts = (bursts + 0.003 * np.random.default_rng(3).standard_normal(bursts.shape))
    bursts = bursts.astype(np.float32)
    kw = dict(dtype_name="bfloat16", equalizer=equalizer, constellation=pts)
    r = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), **kw)
    g = pp.receive_bursts_planar(tc, torch.from_numpy(bursts), **kw)
    per_burst = np.abs(g["data"].numpy() - np.asarray(r["data"])).reshape(B, -1).max(1)
    assert per_burst.max() <= DATA_TOL, per_burst
    np.testing.assert_allclose(g["cnrs"].numpy(), np.asarray(r["cnrs"]), rtol=1e-2)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bf16_operators_bit_equal_to_jax(name):
    """Each operator rounded once from float64 to bf16 (not through float32),
    the small constants float32, both sets of planar_fast tables as JAX's."""
    jc, tc = _pair(name)
    for method, np_mats in (("dense", jax_pp._np_mats), ("fast", jax_pp._np_mats_fast)):
        ours = pp._device_mats(tc, "bfloat16", "cpu", method)
        theirs = operators_from_numpy(np_mats(jc, "bfloat16"))
        for key in ("C_W", "CNRI_T") + (("TF_W", "E_W", "F_W", "Bfd_W", "F2_W")
                                         if method == "dense" else ()):
            assert ours[key].dtype == theirs[key].dtype == torch.bfloat16, key
            np.testing.assert_array_equal(_bits(ours[key]), _bits(theirs[key]), err_msg=key)
        for key in ("win", "preambles", "ic_taps"):
            assert ours[key].dtype == torch.float32, key
    fc = pf.fast_consts(tc, "bfloat16", "cpu")
    for jax_tables in (jax_pf._fft_consts(jc, "bfloat16"), jax_pf._est_consts(jc, "bfloat16")):
        theirs = operators_from_numpy(jax_tables)
        for key, t in theirs.items():
            assert fc[key].dtype == t.dtype, key
            if t.dtype == torch.bfloat16:
                np.testing.assert_array_equal(_bits(fc[key]), _bits(t), err_msg=key)
            else:
                assert torch.equal(fc[key], t), key


@pytest.mark.parametrize("method", ["dense", "fast"])
def test_float32_default_is_unchanged(method):
    """No dtype_name, dtype_name="float32" and the JAX package's float32
    path: the first two bit for bit, the third within test_torch_planar.py's
    limit."""
    jc, tc = _pair("canonical")
    data = planar_payload(tc, B, 0)
    x = torch.from_numpy(data)
    d0, s0, e0 = pp.link_step_planar(tc, x, method=method)
    d1, s1, e1 = pp.link_step_planar(tc, x, method=method, dtype_name="float32")
    assert torch.equal(d0, d1) and torch.equal(s0, s1) and torch.equal(e0, e1)
    assert pp._device_mats(tc, "float32", "cpu", method)["C_W"].dtype == torch.float32
    d_ref, _s, e_ref = jax_pp.link_step_planar(jc, jnp.asarray(data), method=method)
    np.testing.assert_allclose(d0.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(e0) - float(e_ref)) <= 1e-6


def test_receive_chunks_bf16_receiver_matches_jax():
    """receive_chunks_planar(dtype_name="bfloat16") takes the bf16 receiver
    (and, by default, the bf16 detection front end), as the JAX package's
    does: found slots and starts equal, data within the bf16 limit."""
    jc, tc = _pair("canonical")
    chunk = 2048
    chunks, counts = bench._service_stream(jc, 8, chunk, 20.0, False,
                                           np.random.default_rng(5))
    ref = jax_stream.receive_chunks_planar(jc, jnp.asarray(chunks), chunk,
                                           dtype_name="bfloat16")
    got = stream.receive_chunks_planar(tc, torch.from_numpy(chunks), chunk,
                                       dtype_name="bfloat16")
    f = np.asarray(ref["found"])
    np.testing.assert_array_equal(got["found"].numpy(), f)
    assert f.sum() == counts.sum()
    np.testing.assert_array_equal(got["detection"]["start"].numpy(),
                                  np.asarray(ref["detection"]["start"]))
    per_slot = np.abs(got["data"].numpy()[f] - np.asarray(ref["data"])[f]).reshape(
        int(f.sum()), -1).max(axis=1)
    assert per_slot.max() <= DATA_TOL, per_slot
