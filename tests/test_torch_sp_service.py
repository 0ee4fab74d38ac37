"""The port's sample-axis-sharded service (StreamingReceiver(sp_shards > 1))
against the JAX package's, on the CPU.

The JAX service runs over 4 of the conftest's 8 CPU devices (dp = 2, sp =
2; its Pallas receiver in interpret mode, as tests/test_graft_entry.py runs
it), the port's over a virtual mesh of the CPU (its receiver kernel's plain
version). A burst whose preamble peak sits within a few samples of a
sub-chunk boundary is found by both shards in both packages: the left
shard's search limit takes the peak's shoulder, the right shard sees the
core preamble without its cyclic prefix. Those slots match in found and
start; their payloads (a misaligned window) are compared nowhere.
"""
import jax
import numpy as np
import pytest
import torch

import bench
from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.runtime import service as jax_service
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.kernels import detect, fused
from gfdm_tpu_torch.parallel import make_mesh
from gfdm_tpu_torch.runtime import service

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
CHUNK, SP = 2048, 2
N = 8
DATA_ATOL = 1e-5


def _jax_mesh(dp, sp):
    return jax.sharding.Mesh(np.asarray(jax.devices()[: dp * sp]).reshape(dp, sp),
                             ("dp", "sp"))


def _stream(seed=0):
    return bench._service_stream(JC, N, CHUNK, 20.0, False, np.random.default_rng(seed))


def _boundary_chunks(found, counts):
    """Chunks in which the sp service found more bursts than were sent."""
    return found.reshape(-1, SP).sum(axis=1) > counts


@pytest.fixture(scope="module")
def jax_run():
    chunks, counts = _stream()
    rx = jax_service.StreamingReceiver(JC, chunk_len=CHUNK, batch_chunks=N, engine="fused",
                                       sp_shards=SP, mesh=_jax_mesh(2, SP))
    return chunks, counts, rx.step(chunks), rx


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"] * 2],
                         ids=["one_device", "two_devices"])
def test_sp_step_matches_jax(jax_run, devices):
    chunks, counts, ref, _ = jax_run
    mesh = make_mesh(devices, dp=2, sp=SP)
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=N, engine="fused",
                                   sp_shards=SP, mesh=mesh)
    before = (dict(fused.LAUNCHES), dict(detect.LAUNCHES))
    got = rx.step(chunks)
    assert (dict(fused.LAUNCHES), dict(detect.LAUNCHES)) == before  # CPU: plain versions
    assert got["data"].shape == ref["data"].shape == (N * SP, 2, TC.n_data_symbols)
    np.testing.assert_array_equal(got["found"], ref["found"])
    np.testing.assert_array_equal(got["start"], ref["start"])
    np.testing.assert_array_equal(rx._slot_offsets(N) + got["start"],
                                  jax_run[3]._slot_offsets(N) + ref["start"])
    np.testing.assert_allclose(got["cfo"], ref["cfo"], atol=1e-6)
    # every sent burst found, once, except at a sub-chunk boundary (twice)
    per_chunk = got["found"].reshape(N, SP).sum(axis=1)
    boundary = _boundary_chunks(got["found"], counts)
    np.testing.assert_array_equal(per_chunk[~boundary], counts[~boundary])
    assert boundary.sum() <= 1
    sub = CHUNK // SP
    starts = got["start"].reshape(N, SP) + np.arange(SP) * sub
    assert (np.abs(starts[boundary] - sub) <= TC.subcarriers).all()
    keep = got["found"] & ~np.repeat(boundary, SP)
    np.testing.assert_allclose(got["data"][keep], ref["data"][keep], atol=DATA_ATOL)
    np.testing.assert_allclose(got["snr_lin"][keep], ref["snr_lin"][keep], rtol=1e-3)
    assert rx.stats.chunks == N and rx.stats.bursts_found == int(got["found"].sum())


def test_sp_serve_start_abs_matches_jax(jax_run):
    """serve(): absolute starts (chunk base + shard * sub + start) and the
    found slots equal the JAX service's, over two dispatches."""
    chunks, _counts, _ref, _ = jax_run

    def source(batch):
        it = iter(range(0, N, batch))
        return lambda: None if (i := next(it, None)) is None else (chunks[i : i + batch],
                                                                   i * CHUNK)

    jrx = jax_service.StreamingReceiver(JC, chunk_len=CHUNK, batch_chunks=4, engine="fused",
                                        sp_shards=SP, mesh=_jax_mesh(2, SP))
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=4, engine="fused",
                                   sp_shards=SP, mesh=make_mesh(["cpu"] * 4, dp=2, sp=SP))
    outs = {}
    for name, r in (("jax", jrx), ("port", rx)):
        got = []
        r.serve(source(4), got.append)
        outs[name] = {key: np.concatenate([g[key] for g in got])
                      for key in ("found", "start_abs")}
    np.testing.assert_array_equal(outs["port"]["found"], outs["jax"]["found"])
    np.testing.assert_array_equal(outs["port"]["start_abs"], outs["jax"]["start_abs"])
    assert rx.stats.batches == 2 and rx.stats.chunks == N


def test_sp_windows_are_one_step_on_one_device(jax_run):
    """On a virtual mesh every shard of every row runs as one step: one call
    of the receiver over the n * sp windows (chunks.unfold)."""
    chunks = jax_run[0]
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=N, engine="fused",
                                   sp_shards=SP, mesh=make_mesh(["cpu"] * 8, dp=4, sp=SP))
    assert rx._plan(N) == [(0, N, [(torch.device("cpu"), 0, SP)])]
    calls = []
    step = rx._chunk_step
    rx._chunk_step = lambda w, owned=None: (calls.append((tuple(w.shape), owned)),
                                            step(w, owned))[1]
    rx.step(chunks)
    assert calls == [((N * SP, 2, CHUNK // SP + rx.halo), CHUNK // SP)]
    two = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=N, engine="fused",
                                    sp_shards=SP,
                                    mesh=make_mesh(["cpu", "cpu:0"] * 2, dp=2, sp=SP))
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    assert two._plan(N) == [(0, N, [(cpu, 0, 1), (cpu0, 1, 2)])]


def _sp_error(jkw, tkw):
    with pytest.raises(ValueError) as ref:
        jax_service.StreamingReceiver(JC, **jkw)
    with pytest.raises(ValueError) as got:
        service.StreamingReceiver(TC, **tkw)
    return str(got.value), str(ref.value)


@pytest.mark.parametrize("case", ["engine", "k", "mesh_sp", "divide", "halo"])
def test_sp_checks_raise_jax_errors(case):
    kw = {"engine": "fused", "sp_shards": SP}
    kw.update({"engine": dict(engine="xla"), "k": dict(max_bursts_per_chunk=2),
               "mesh_sp": dict(sp_shards=4), "divide": dict(chunk_len=2049),
               "halo": dict(chunk_len=1024)}[case])
    got, ref = _sp_error({**kw, "mesh": _jax_mesh(2, SP)},
                         {**kw, "mesh": make_mesh(["cpu"] * 4, dp=2, sp=SP)})
    assert got == ref


def test_mesh_not_divisible_by_sp_raises():
    """Without a mesh the service takes its device (or every card): one
    device does not divide into sp_shards = 2, as in the JAX package."""
    got, ref = _sp_error({"engine": "fused", "sp_shards": 3},
                         {"engine": "fused", "sp_shards": 2, "device": "cpu"})
    assert got == "1 devices not divisible by sp_shards=2"
    assert ref == "8 devices not divisible by sp_shards=3"


def test_slot_offsets_and_batch_ladder_match_jax():
    jrx = jax_service.StreamingReceiver(JC, chunk_len=CHUNK, batch_chunks=3,
                                        max_batch_chunks=12, engine="fused", sp_shards=SP,
                                        mesh=_jax_mesh(2, SP))
    rx = service.StreamingReceiver(TC, chunk_len=CHUNK, batch_chunks=3, max_batch_chunks=12,
                                   engine="fused", sp_shards=SP,
                                   mesh=make_mesh(["cpu"] * 4, dp=2, sp=SP))
    np.testing.assert_array_equal(rx._slot_offsets(5), jrx._slot_offsets(5))
    for n in range(1, 13):
        assert rx._padded_batch(n) == jrx._padded_batch(n)
    assert rx.mesh.shape == dict(jrx.mesh.shape)
