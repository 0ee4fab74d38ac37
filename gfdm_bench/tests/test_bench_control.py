"""The comparison that decides ``correct``, at a size a test run holds.

For every cell on the CPU: the program's readings lie within the cell's
limits and the control's (the reference in the control precisions in the
program's place) fail at least one; and with the timed path broken
underneath, each fault the cell can have (a step that returns its state
unchanged, half the batch left out, one answer altered where it is made,
and in the links the batch's EVM altered) turns ``correct`` false. The
same readings on the card, at the cells' own sizes, are what the limits
were set from (PERF.md)."""
from __future__ import annotations

import pytest
import torch

CELLS = ("link.default.b65536", "link.largek512.b4096", "service.default.impaired",
         "service.default.coded")


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(dry, name):
    got = dry(name, control=True)
    assert got["correct"], got["checks"]
    limits = {k: c["limit"] for k, c in got["checks"].items()}
    failed = [k for k, lim in limits.items() if got["control"].get(k, 0.0) > lim]
    assert failed, (got["control"], limits)


def _link_fault(kind):
    def patch(mod):
        step = mod.Driver.step

        def broken(self, data):
            d_hat, snr, evm = step(self, data)
            if kind == "unchanged":
                return data, snr, evm
            d_hat = d_hat.clone()
            if kind == "half":
                d_hat[d_hat.shape[0] // 2 :] = 0.0
            elif kind == "altered":
                d_hat[0, 0, 0] += 0.05
            else:  # the batch's EVM altered where it is made
                evm = evm * 1.01
            return d_hat, snr, evm

        mod.Driver.step = broken

    return patch


def _service_fault(kind, monkeypatch):
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    fetch = StreamingReceiver._fetch

    def patch(mod):
        if kind == "half":
            def setup(self, _orig=mod.Driver.setup):
                _orig(self)
                inner = self.rx._step

                def halved(chunks):
                    chunks = chunks.clone()
                    chunks[chunks.shape[0] // 2 :] = 0.0
                    return inner(chunks)

                self.rx._step = halved

            monkeypatch.setattr(mod.Driver, "setup", setup)
            return
        first = {}

        def broken(self, outs, n, keys=()):
            got = fetch(self, outs, n, keys)
            if kind == "unchanged":
                return first.setdefault("out", got)
            i = int(got["found"].nonzero()[0][0])
            got["data"][i, 0, 0] += 0.5
            return got

        monkeypatch.setattr(StreamingReceiver, "_fetch", broken)

    return patch


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(dry, monkeypatch, name, kind):
    if name.startswith("link."):
        patch = _link_fault(kind)
    else:
        patch = _service_fault(kind, monkeypatch)
    got = dry(name, patch=patch)
    assert not got["correct"], got["checks"]


@pytest.mark.parametrize("name", CELLS[:2])
def test_an_altered_link_evm_is_not_correct(dry, name):
    got = dry(name, patch=_link_fault("evm"))
    assert not got["correct"], got["checks"]
    assert got["checks"]["evm_gap"]["value"] > got["checks"]["evm_gap"]["limit"]


@pytest.mark.gpu
def test_a_cell_runs_on_the_card():
    """One short run of the flagship cell through the command line."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", "gfdm_bench", "--workload",
                          "link.default.b65536", "--seed", str(2**31 + 17), "--seconds", "2",
                          "--trace", "1"], capture_output=True, text=True, cwd=root,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["busy_s"] > 0
    assert set(line["metrics"]) == {"device_idle_share.link", "link_step_roofline"}


def test_a_near_tie_decision_decided_the_other_way_is_allowed(dry):
    """The program's answer at the clearest found burst replaced by the
    reference's with one IC decision flipped: correct where that decision
    lies within the cell's ``tie_margin`` of its boundary, and a wrong
    answer where it does not."""
    drv = dry("service.default.impaired", look=lambda d: d)["look"]
    wf, det, front = drv.reference()
    i, out = drv.kept.items[0]
    f = drv.follow(i, out, det, wf, front)
    dr = f["r"]["data"].to(torch.complex128)
    hard = torch.complex(torch.where(dr.real >= 0, 1.0, -1.0),
                         torch.where(dr.imag >= 0, 1.0, -1.0)) * 2**-0.5
    j = int((dr - hard).abs().pow(2).mean(-1).argmin())
    margins = f["r"]["margins"][:, j : j + 1]
    near = torch.sort(margins.reshape(margins.shape[0], -1), dim=-1).values[:, :8]
    _which, passes, variants = wf.tie_variants(f["bursts"][j : j + 1], margins, float("inf"))
    # the last pass's flips stand; a first-pass flip in a clear burst heals
    v = next(v for v in range(len(variants)) if (variants[v] - dr[j]).abs().max() > 1e-3)
    margin = float(near[passes[v], v - 8 * int(passes[v])])
    flipped = dict(out, data=out["data"].copy())
    slot = int(f["idx"][j])
    flipped["data"][slot] = torch.stack([variants[v].real, variants[v].imag]).numpy()
    limit = drv.run.workload["limits"]["payload_gap"]
    drv.p["tie_margin"] = margin * 1.01
    assert drv._compare(i, flipped, det, wf, front)["payload_gap"] <= limit
    drv.p["tie_margin"] = margin * 0.99
    assert drv._compare(i, flipped, det, wf, front)["payload_gap"] > limit
