"""The port's entry step against the JAX entry, and the port's import boundary."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import entry, planar_payload
from gfdm_tpu_torch.kernels import fused

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_reproduces_jax_evm_on_cpu():
    """The clean-loopback EVM floor (0.018) of the JAX entry, within 1e-4."""
    jax_fn, (jax_data,) = __graft_entry__.entry()
    evm_jax = float(np.asarray(jax_fn(jax_data)[2]))
    step, (data,) = entry("cpu")
    np.testing.assert_array_equal(data.numpy(), jax_data)
    d_hat, snr, evm = step(data)
    assert abs(float(evm) - evm_jax) < 1e-4
    assert 0.017 < float(evm) < 0.019
    assert d_hat.shape == (64, 2, GfdmConfig().n_data_symbols) and snr.shape == (64,)


def test_entry_example_args():
    step, (data,) = entry(torch.device("cpu"))
    assert callable(step)
    assert data.dtype == torch.float32 and data.device.type == "cpu"
    assert data.shape == (64, 2, GfdmConfig().n_data_symbols)
    np.testing.assert_array_equal(data.numpy(), planar_payload(GfdmConfig(), 64, 0))


def test_port_imports_neither_jax_nor_the_reference_package():
    """Every module of the package (walked, so a new one cannot slip past),
    the CLI's info command, chip_smoke.py and the kernels' timer import
    neither JAX nor gfdm_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gfdm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gfdm_tpu_torch.__path__, "
        "'gfdm_tpu_torch.') if m.name.rsplit('.', 1)[-1] != '__main__']\n"
        "for name in names:\n    importlib.import_module(name)\n"
        "for name in ('gfdm_tpu_torch.parallel.mesh', 'gfdm_tpu_torch.parallel.multihost', "
        "'gfdm_tpu_torch.utils.profiling', 'gfdm_tpu_torch.examples.multichip_sharding', "
        "'gfdm_tpu_torch.kernels.fused', 'gfdm_tpu_torch.runtime.service'):\n"
        "    assert name in names, name\n"
        "import chip_smoke\n"
        "import gfdm_tpu_torch.benchmarks.kernels\n"
        "gfdm_tpu_torch.native.available()\n"
        "sys.argv = ['gfdm_tpu_torch', 'info']\n"
        "try:\n    import gfdm_tpu_torch.__main__\n"
        "except SystemExit as exc:\n    assert exc.code == 0, exc.code\n"
        "assert 'jax' not in sys.modules and 'gfdm_tpu' not in sys.modules, "
        "sorted(m for m in sys.modules if m.startswith(('jax', 'gfdm_tpu.')))\n"
        "print(len(names))"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 82  # every module of the package


def test_dryrun_multichip_matches_jax_on_cpu(capsys):
    """The eight-device dry run on a virtual CPU mesh: the JAX dry run's
    EVM and shard ownership."""
    from gfdm_tpu_torch.entry import dryrun_multichip

    __graft_entry__.dryrun_multichip(8)
    ref = capsys.readouterr().out.strip().splitlines()[-1]
    res = dryrun_multichip(8, device="cpu")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == ref
    assert (res["dp"], res["sp"], res["sp_serve_found"]) == (4, 2, 4)
    assert 0.017 < res["evm"] < 0.019


def test_prepare_and_dry_runs_without_a_card_raise(monkeypatch):
    """Entry points that once defaulted to the CPU (prepare, fast_consts)
    and the dry runs take the card by default: without one they raise,
    naming device='cpu'."""
    from gfdm_tpu_torch.entry import dryrun_multichip, dryrun_multihost
    from gfdm_tpu_torch.ops.planar_fast import fast_consts
    from gfdm_tpu_torch.ops.planar_pipeline import prepare

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GfdmConfig()
    for call in (lambda: prepare(cfg), lambda: prepare(cfg, "float32", method="fast"),
                 lambda: fast_consts(cfg), lambda: dryrun_multichip(8),
                 lambda: dryrun_multihost(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_live_chain_without_a_device_never_falls_back_to_the_cpu(monkeypatch):
    """Given no device and no card, the transmit and receive services and
    the complex chain's entry points raise, naming device='cpu'."""
    from gfdm_tpu_torch.runtime import receiver, stream, transmitter
    from gfdm_tpu_torch.runtime.service import StreamingReceiver
    from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GfdmConfig()
    chunks = np.zeros((2, 2048), np.complex64)
    for call in (lambda: StreamingTransmitter(cfg), lambda: StreamingReceiver(cfg),
                 lambda: receiver.receive_stream(cfg, chunks),
                 lambda: receiver.receive_bursts(cfg, chunks[:, : cfg.frame_len]),
                 lambda: transmitter.transmit_bursts(cfg, chunks[:, : cfg.n_data_symbols]),
                 lambda: stream.receive_long_stream(cfg, chunks.reshape(-1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("K", [256, 512, 1024])
def test_large_k_config_is_the_crossover_benchmarks(K):
    """benchmarks/largek_crossover.py:49-55 builds this config."""
    from gfdm_tpu import GfdmConfig as JaxConfig

    from gfdm_tpu_torch.entry import large_k_config

    jc = JaxConfig(subcarriers=K, active_subcarriers=int(K * 0.78125), timeslots=9,
                   cp_len=K // 4, cs_len=K // 8)
    tc = large_k_config(K)
    for attr in ("subcarriers", "active_subcarriers", "timeslots", "cp_len", "cs_len",
                 "block_len", "frame_len", "n_data_symbols"):
        assert getattr(tc, attr) == getattr(jc, attr), attr
    np.testing.assert_array_equal(tc.subcarrier_map, jc.subcarrier_map)
    assert tc.block_len == 9 * K


def test_build_dir_checkout_override_and_installed(monkeypatch, tmp_path):
    from gfdm_tpu_torch.kernels import cuda_lib

    monkeypatch.delenv("GFDM_TPU_TORCH_BUILD_DIR", raising=False)
    assert cuda_lib.build_dir() == Path(ROOT) / "build" / "gfdm_tpu_torch"
    monkeypatch.setenv("GFDM_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    assert cuda_lib.build_dir() == tmp_path / "b"
    # an installed package: no pyproject.toml two levels above kernels/
    monkeypatch.delenv("GFDM_TPU_TORCH_BUILD_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    site = tmp_path / "site-packages" / "gfdm_tpu_torch" / "kernels"
    monkeypatch.setattr(cuda_lib, "__file__", str(site / "cuda_lib.py"))
    assert cuda_lib.build_dir() == tmp_path / "cache" / "gfdm_tpu_torch"


@pytest.mark.gpu
def test_cuda_tensor_with_unported_option_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100: python3 chip_smoke.py)")
    """On a CUDA tensor an option value the kernel does not take raises
    before any launch (there is no plain fallback); the receiver options
    once refused here (mmse) launch the kernel."""
    cfg = GfdmConfig()
    bursts = torch.zeros(4, 2, cfg.frame_len, device="cuda")
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="equalizer"):
        fused.rx_receiver_fused(cfg, bursts, equalizer="lmmse")
    assert fused.LAUNCHES == before
    fused.rx_receiver_fused(cfg, bursts, equalizer="mmse")
    assert fused.LAUNCHES["rx"] == before["rx"] + fused.rx_launches(2)
