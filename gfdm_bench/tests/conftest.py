"""Shared set-up of the benchmark's own tests: the repository root on the
import path, torch's threads shared between test workers, and ``dry_run``,
one cell run on the CPU at a small size."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _share_the_cores() -> None:
    """Parallel test workers split the cores: torch's threads on every core
    in every worker slow a dry run's steps past its window."""
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


_share_the_cores()

SMALL = {
    "service.default.impaired": {"batch_chunks": 32},
    "service.default.coded": {"batch_chunks": 32},
    "link.default.b65536": {"batch": 64, "check_rows": 32},
    "link.largek512.b4096": {"batch": 4, "check_rows": 4},
}


def dry_run(name: str, seed: int = 2**31 + 5, control: bool = False, seconds: float = 2.0,
            patch=None, look=None, **over) -> dict:
    """Set up, measure, check (and with ``control`` the control's
    readings, with ``look`` its numbers) one cell on the CPU with SMALL's
    sizes; ``patch(driver module)`` may break the timed path first. Returns execute()'s dict plus
    ``correct``."""
    import torch

    from gfdm_bench import run as bench

    wl = bench.load_json("workloads", name)
    cfg = bench.load_json("configs", wl["config"])
    wl["params"].update(SMALL[name], **over)
    run = bench.Run(wl, cfg, seed, seconds, False, torch.device("cpu"))
    mod = bench.load_module("drivers", wl["driver"])
    if patch is not None:
        patch(mod)
    got = bench.execute(run, mod, control=control, look=look)
    got["correct"] = all(c["value"] <= c["limit"] for c in got["checks"].values())
    got["run"] = run
    return got


@pytest.fixture
def dry():
    return dry_run
