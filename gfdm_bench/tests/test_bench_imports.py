"""The import boundary: nothing the benchmark runs imports JAX, jaxlib,
flax or the JAX package ``gfdm_tpu`` (whole top-level names: the port's
``gfdm_tpu_torch`` begins with ``gfdm_tpu``), and the reference and the
counts import nothing of the program under test."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "gfdm_tpu"}


def _sources(sub=""):
    base = os.path.join(BENCH, sub)
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_top_level_names_are_compared_whole():
    assert "gfdm_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "gfdm_tpu.ops".split(".", 1)[0] in FORBIDDEN


def test_no_file_the_benchmark_runs_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _sources() for m in _top_level_imports(p) if m in FORBIDDEN]
    assert not bad, bad


def test_reference_and_counts_import_nothing_of_the_program():
    for sub in ("reference", "counts"):
        bad = [(p, m) for p in _sources(sub) for m in _top_level_imports(p)
               if m in FORBIDDEN | {"gfdm_tpu_torch"}]
        assert not bad, bad


def test_a_dry_run_loads_no_jax():
    """A CPU dry run of one cell in a fresh process, then sys.modules by
    whole top-level names."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from gfdm_bench import run as bench\n"
        "wl = bench.load_json('workloads', 'link.default.b65536')\n"
        "wl['params'].update(batch=16, check_rows=16)\n"
        "cfg = bench.load_json('configs', wl['config'])\n"
        "r = bench.Run(wl, cfg, 5, 0.2, False, torch.device('cpu'))\n"
        "bench.execute(r, bench.load_module('drivers', wl['driver']))\n"
        "print('LOADED', sorted({m.split('.', 1)[0] for m in sys.modules} & %r))\n"
    ) % (ROOT, FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]
