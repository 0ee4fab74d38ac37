"""The port's multi-process serve (gfdm_tpu_torch.parallel.multihost) on the
CPU: two OS processes in one gloo group, against a one-process run, and its
stream against the JAX package's."""
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.parallel import multihost as jax_multihost
from gfdm_tpu.runtime.service import host_chunk_range as jax_host_chunk_range
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.parallel import multihost
from gfdm_tpu_torch.runtime.service import host_chunk_range

torch.set_num_threads(1)


def test_build_stream_chunks_matches_jax():
    got = multihost.build_stream_chunks(GfdmConfig(), 12, device="cpu")
    ref = jax_multihost.build_stream_chunks(JaxConfig(), 12)
    assert got[0].dtype == np.float32 and got[0].shape == ref[0].shape
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    again = multihost.build_stream_chunks(GfdmConfig(), 12, device="cpu")
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("total,hosts", [(16, 2), (24, 3), (7, 2), (5, 8), (4096, 2)])
def test_host_chunk_range_contiguous_cover(total, hosts):
    ranges = [host_chunk_range(total, hosts, h) for h in range(hosts)]
    assert [i for r in ranges for i in r] == list(range(total))
    assert ranges == [jax_host_chunk_range(total, hosts, h) for h in range(hosts)]


def test_launch_two_processes_parity_and_psum(tmp_path):
    """Two processes join a gloo group, each serves its contiguous chunk
    range; the union of their payloads equals the one-process run and the
    metrics' all-reduce agrees in each."""
    try:
        r = multihost.launch(num_processes=2, n_chunks=16, out_dir=str(tmp_path),
                             timeout=240, device="cpu")
    except TimeoutError as e:  # pragma: no cover - constrained machines
        pytest.skip(f"multi-process run timed out on this machine: {e}")
    assert r["parity"], "multi-process payloads diverged from the one-process run"
    assert r["psum_ok"], "the cross-process metrics' sum disagreed"
    _, _, expect_found = multihost.build_stream_chunks(GfdmConfig(), 16, device="cpu")
    assert r["bursts_found"] == int(expect_found.sum())
    assert r["serve_seconds_multi_max"] > 0 and r["efficiency"] > 0
    for i in range(2):
        got = np.load(tmp_path / "n2" / f"proc{i}.npz")
        assert int(got["process_count"]) == 2 and int(got["global_chunks"]) == 16
        assert int(got["global_samples"]) == 16 * 2048
        assert (int(got["chunk_lo"]), int(got["chunk_hi"])) == (8 * i, 8 * i + 8)


def test_launch_raises_on_a_failed_worker(tmp_path):
    """A worker that fails (no chunks to build a stream from) raises with
    its error output, and no worker is left running."""
    with pytest.raises(RuntimeError, match="worker 0 failed"):
        multihost.launch(num_processes=2, n_chunks=0, out_dir=str(tmp_path), timeout=240,
                         device="cpu")


def test_launch_on_a_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.launch(num_processes=2, n_chunks=4, device="cuda")
