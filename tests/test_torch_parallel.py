"""The port's mesh layer (gfdm_tpu_torch.parallel) against gfdm_tpu.parallel,
on the CPU.

The JAX side runs on the conftest's 8-device CPU mesh; the port's on a
virtual mesh of the CPU repeated. A mesh alternating torch.device("cpu")
and torch.device("cpu", 0) counts as two devices to the port's grouping,
so it runs the cross-device path (one call a shard, heads copied between
runs) with the data on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu import parallel as jpar
from gfdm_tpu.ops.planar_pipeline import receive_bursts_planar as jax_receive
from gfdm_tpu.ref import utils
from gfdm_tpu.runtime.transmitter import transmit_bursts
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch import parallel as tpar
from gfdm_tpu_torch.ops.planar_pipeline import receive_bursts_planar

torch.set_num_threads(1)

JC, TC = JaxConfig(), GfdmConfig()
HALO = TC.frame_len + 64
MESHES = {
    "one_device": ["cpu"] * 8,
    "two_devices": ["cpu", "cpu:0"] * 4,  # every shard its own run
}


def _payloads(batch, seed):
    return np.stack([utils.random_qpsk(TC.n_data_symbols, seed=seed + i)
                     for i in range(batch)]).astype(np.complex64)


def _bursts(data):
    return np.asarray(transmit_bursts(JC, data))[:, 0, :]


def _noise(shape, seeds):
    return 0.01 * (np.random.default_rng(seeds[0]).standard_normal(shape)
                   + 1j * np.random.default_rng(seeds[1]).standard_normal(shape))


def _straddle():
    """test_parallel.py: a burst across the chunk 1 / chunk 2 boundary."""
    stream = np.zeros((2, 4 * 2048), np.complex64)
    off = 2 * 2048 - TC.frame_len // 2
    stream[:, off : off + TC.frame_len] = _bursts(_payloads(2, 7))
    return stream


def _owner():
    """test_parallel.py: a burst well inside chunk 0, silence elsewhere."""
    stream = np.zeros((2, 4 * 2048), np.complex64)
    stream[:, 100 : 100 + TC.frame_len] = _bursts(_payloads(2, 11))
    return stream


def _dual():
    """test_parallel.py: a burst near chunk 2's start, in chunk 1's halo too."""
    stream = _noise((2, 4 * 2048), (3, 4)).astype(np.complex64)
    off = 2 * 2048 + 150
    stream[:, off : off + TC.frame_len] += _bursts(_payloads(2, 31))
    return stream


def _dense():
    """test_parallel.py: two bursts in chunk 1 of 4,096 samples, noise."""
    cl = 4096
    stream = _noise((2, 4 * cl), (5, 6)).astype(np.complex64)
    for off, seed in ((cl + 100, 41), (cl + 100 + TC.frame_len + 400, 43)):
        stream[:, off : off + TC.frame_len] += _bursts(_payloads(2, seed))
    return stream


SCENARIOS = {"straddle": _straddle, "owner": _owner, "dual": _dual, "dense": _dense}


def _jax_sharded(stream, planar, k):
    mesh = jpar.make_mesh(dp=2, sp=4)
    spec = P("dp", None, "sp") if planar else P("dp", "sp")
    x = jax.device_put(jnp.asarray(stream), NamedSharding(mesh, spec))
    det, bursts = jpar.detect_bursts_sharded(JC, mesh, x, halo=HALO, planar=planar,
                                             max_bursts_per_chunk=k)
    return {key: np.asarray(v) for key, v in det.items()}, np.asarray(bursts)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("planar", [False, True], ids=["complex", "planar"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_detect_bursts_sharded_matches_jax(scenario, planar, k):
    stream = SCENARIOS[scenario]()
    if planar:
        stream = np.stack([stream.real, stream.imag], axis=1).astype(np.float32)
    ref_det, ref_bursts = _jax_sharded(stream, planar, k)
    mesh = tpar.make_mesh(MESHES["one_device"], dp=2, sp=4)
    det, bursts = tpar.detect_bursts_sharded(TC, mesh, torch.from_numpy(stream), halo=HALO,
                                             planar=planar, max_bursts_per_chunk=k)
    assert sorted(det) == sorted(ref_det)
    for key in ("start", "owned", "found"):
        np.testing.assert_array_equal(det[key].numpy(), ref_det[key], err_msg=key)
    f = ref_det["found"]
    np.testing.assert_allclose(det["cfo"].numpy()[f], ref_det["cfo"][f], atol=1e-6)
    # a pick on noise: the angle of a noise autocorrelation, where the two
    # packages' complex64 FFTs differ by up to ~7e-6 (dual, complex, k = 2)
    np.testing.assert_allclose(det["cfo"].numpy(), ref_det["cfo"], atol=1e-5)
    assert tuple(bursts.shape) == ref_bursts.shape
    # extraction derotates by the slot's CFO: bursts within 1e-5 of their
    # peak wherever the CFOs agree within 1e-6 (every found slot)
    same = np.abs(det["cfo"].numpy() - ref_det["cfo"]) <= 1e-6
    assert same[f].all()
    peak = np.abs(ref_bursts).max()
    assert np.abs(bursts.numpy()[same] - ref_bursts[same]).max() <= 1e-5 * peak
    if scenario == "dense" and k == 2:  # shard 1 keeps both bursts, nothing else fires
        found = det["found"].numpy()
        assert (found[:, 1].sum(-1) == 2).all() and found[:, [0, 2, 3]].sum() == 0


@pytest.mark.parametrize("planar", [False, True], ids=["complex", "planar"])
def test_detect_bursts_sharded_across_devices_equals_one_device(planar):
    """The cross-device path (a batched call a run, heads copied between
    runs) gives what the one-device path gives, bit for bit."""
    stream = _dual()
    if planar:
        stream = np.stack([stream.real, stream.imag], axis=1).astype(np.float32)
    runs = {}
    for name, devices in MESHES.items():
        mesh = tpar.make_mesh(devices, dp=2, sp=4)
        runs[name] = tpar.detect_bursts_sharded(TC, mesh, torch.from_numpy(stream),
                                                halo=HALO, planar=planar)
    (det_a, b_a), (det_b, b_b) = runs.values()
    for key in det_a:
        assert torch.equal(det_a[key], det_b[key]), key
    assert torch.equal(b_a, b_b)


@pytest.mark.parametrize("halo", [1, 40, 64])
@pytest.mark.parametrize("planar", [False, True], ids=["complex", "planar"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_halo_exchange_right_matches_jax(mesh_name, planar, halo):
    """The ring of test_parallel.py's halo exchange inside jax.shard_map:
    shard i gets shard (i + 1) mod 4's head, the last shard the first's."""
    T = 64
    rng = np.random.default_rng(halo)
    shape = (2, 2, 4 * T) if planar else (2, 4 * T)
    x = rng.standard_normal(shape).astype(np.float32)
    jmesh = jpar.make_mesh(dp=2, sp=4)
    spec = P("dp", None, "sp") if planar else P("dp", "sp")
    fn = jax.jit(jax.shard_map(lambda c: jpar.halo_exchange_right(c, halo, "sp"),
                               mesh=jmesh, in_specs=spec, out_specs=spec))
    ref = np.asarray(fn(jax.device_put(jnp.asarray(x), NamedSharding(jmesh, spec))))
    mesh = tpar.make_mesh(MESHES[mesh_name], dp=2, sp=4)
    xt = torch.from_numpy(x)
    for r in range(2):
        shards = [xt[r : r + 1, ..., j * T : (j + 1) * T].to(mesh.devices[r, j])
                  for j in range(4)]
        got = tpar.halo_exchange_right(shards, halo)
        for j, g in enumerate(got):
            w = T + halo
            np.testing.assert_array_equal(g.numpy(), ref[r : r + 1, ..., j * w : (j + 1) * w])


def test_halo_longer_than_a_shard_raises():
    shards = [torch.zeros(1, 8) for _ in range(4)]
    with pytest.raises(ValueError, match="shard width"):
        tpar.halo_exchange_right(shards, 9)
    mesh = tpar.make_mesh(MESHES["one_device"], dp=2, sp=4)
    with pytest.raises(ValueError, match="shard width"):
        tpar.detect_bursts_sharded(TC, mesh, torch.zeros(2, 4 * 512, dtype=torch.complex64))


@pytest.mark.parametrize("sp", [2, 4])
def test_unfold_is_the_halo_exchange_with_the_lookahead_tail(sp):
    """The sp service's windows: sub-chunk j extended by sub-chunk j + 1's
    head, the last by the chunk's lookahead tail. On one device that is
    chunks.unfold(-1, sub + halo, sub) over the halo-extended chunk; the
    general form is the ring exchange with the last shard's halo taken from
    the tail instead of the wrap."""
    sub, halo, n = 96, 40, 5
    chunks = torch.from_numpy(np.random.default_rng(sp).standard_normal(
        (n, 2, sp * sub + halo)).astype(np.float32))
    windows = chunks.unfold(-1, sub + halo, sub)  # (n, 2, sp, sub + halo)
    shards = [chunks[..., j * sub : (j + 1) * sub] for j in range(sp)]
    ring = tpar.halo_exchange_right(shards, halo)
    general = ring[:-1] + [torch.cat([shards[-1], chunks[..., sp * sub :]], dim=-1)]
    assert windows.shape[2] == sp
    for j in range(sp):
        assert torch.equal(windows[:, :, j], general[j])
    # and the ring's own last window wraps to the first shard's head
    assert torch.equal(ring[-1][..., sub:], shards[0][..., :halo])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dp_sharded_receive_equals_unsharded(mesh_name):
    """test_parallel.py's dp case: 16 bursts over dp = 8 rows; rows that
    share a device run as one call."""
    data = _payloads(16, 0)
    bursts = _bursts(data)
    planar = torch.from_numpy(np.stack([bursts.real, bursts.imag], 1).astype(np.float32))
    mesh = tpar.make_mesh(MESHES[mesh_name], dp=8, sp=1)
    calls = []

    def rx(b):
        calls.append(b.shape[0])
        return receive_bursts_planar(TC, b, ic_iterations=2)

    got = tpar.dp_map(mesh, rx, planar)
    assert calls == ([16] if mesh_name == "one_device" else [2] * 8)
    whole = receive_bursts_planar(TC, planar, ic_iterations=2)
    assert sorted(got) == sorted(whole)
    for key in whole:
        np.testing.assert_allclose(got[key].numpy(), whole[key].numpy(), atol=1e-5, rtol=1e-5)
    ref = jax_receive(JC, jnp.asarray(planar.numpy()), ic_iterations=2)
    np.testing.assert_allclose(got["data"].numpy(), np.asarray(ref["data"]), atol=1e-4)
    pieces = tpar.shard_bursts(mesh, planar)
    assert len(pieces) == 8 and all(p.shape[0] == 2 for p in pieces)
    assert torch.equal(torch.cat(pieces), planar)


def test_make_mesh_errors_and_shape(monkeypatch):
    with pytest.raises(ValueError) as ref:
        jpar.make_mesh(jax.devices(), dp=3, sp=2)
    with pytest.raises(ValueError) as got:
        tpar.make_mesh(["cpu"] * 8, dp=3, sp=2)
    assert str(got.value) == str(ref.value) == "dp*sp = 3*2 != 8 devices"
    mesh = tpar.make_mesh(["cpu"] * 8, sp=4)
    assert mesh.shape == dict(jpar.make_mesh(sp=4).shape) == {"dp": 2, "sp": 4}
    assert mesh.devices.shape == (2, 4) and mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="does not split into dp=2"):
        tpar.shard_bursts(mesh, torch.zeros(3, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.make_mesh()


def test_psum_metrics_over_shards_and_a_group(monkeypatch):
    """The list form sums per-shard dicts; with a group the sum is then
    all-reduced (a one-process gloo group joined by init_distributed from
    torch's standard environment)."""
    import socket

    import torch.distributed as dist

    from gfdm_tpu_torch.runtime.service import init_distributed

    shards = [{"bursts": torch.tensor(i), "evm": torch.tensor([0.5 * i, 1.0])}
              for i in range(4)]
    total = tpar.psum_metrics(shards)
    assert int(total["bursts"]) == 6
    np.testing.assert_allclose(total["evm"].numpy(), [3.0, 4.0])
    assert int(shards[0]["bursts"]) == 0  # the inputs are left alone
    assert init_distributed() is False and not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                       ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(key, value)
    try:
        assert init_distributed() is False  # one process: no group of several
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert init_distributed() is False  # an initialized group is left alone
        summed = tpar.psum_metrics(total, group=dist.group.WORLD)
        assert int(summed["bursts"]) == 6
    finally:
        dist.destroy_process_group()
