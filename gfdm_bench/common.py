"""What the drivers share: the program's configuration from a cell's
configuration file, the checks' format, and the loopback link driver that
``link_entry`` and ``link_factored`` specialize."""
from __future__ import annotations

import random
import time
from collections import deque

import torch

from .reference import traffic
from .reference.waveform import SHAPE_KEYS, Waveform

# configuration-file keys -> the program's GfdmConfig fields
_PROGRAM_KEYS = {k: k for k in SHAPE_KEYS} | {"preamble_seed": "seed"}


def shape(config: dict) -> dict:
    """The waveform keys of a configuration file."""
    return {k: config[k] for k in SHAPE_KEYS}


def program_config(config: dict):
    """The program's GfdmConfig for a configuration file."""
    from gfdm_tpu_torch.config import GfdmConfig

    return GfdmConfig(**{_PROGRAM_KEYS[k]: config[k] for k in SHAPE_KEYS})


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _HostEvent:
    """A stand-in for a CUDA event on the CPU (the tests' dry runs)."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def event(device, timing: bool = False):
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=timing)
    return _HostEvent()


def checks(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number the cell's file gives a
    limit; a limit with no number is a fault of the driver."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise RuntimeError(f"no reading for the limits {missing}")
    return {k: {"value": float(values[k]), "limit": float(lim)} for k, lim in limits.items()}


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = int(k), 0, []
        self.rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


class LinkDriver:
    """A batched loopback link, steps dispatched back to back.

    Set-up makes ``pool`` distinct batches of ``batch`` QPSK payloads on the
    device from the seed and runs one step on each. The window runs steps
    on the batches in turn, at most ``depth`` steps ahead of the device (a
    CUDA event a step), until ``seconds`` have passed, then synchronizes:
    ``link_samples_per_s`` is bursts x frame_len of every step over the
    window's seconds. One step's outputs, drawn from the seed, are kept and
    compared with the reference over every burst: the data estimates and
    the batch's EVM. Subclasses give ``program_setup`` and ``step(data) ->
    (data estimate, snr_lin or None, evm)``.
    """

    depth = 2

    def __init__(self, run):
        self.run = run
        self.p = run.workload["params"]
        self.shape = shape(run.config)
        self.device = run.device
        self.frame_len = int(run.config["frame_len"])

    # -- program ----------------------------------------------------------
    def program_setup(self) -> None:
        raise NotImplementedError

    def step(self, data: torch.Tensor) -> tuple:
        raise NotImplementedError

    # -- harness ----------------------------------------------------------
    def setup(self) -> None:
        self.cfg = program_config(self.run.config)
        gen = traffic.generator(self.run.seed, self.device)
        B, n_data = int(self.p["batch"]), int(self.run.config["n_data_symbols"])
        self.batches = [traffic.qpsk_payload(B, n_data, gen) for _ in range(int(self.p["pool"]))]
        self.program_setup()
        from .run import mark

        mark("program")
        for data in self.batches:
            self.step(data)
        synchronize(self.device)

    def _loop(self, until, keep=None, mark=None) -> tuple[int, float]:
        """Steps until ``until(steps, elapsed)``; (steps, device seconds)."""
        cuda = self.device.type == "cuda"
        stream = torch.cuda.current_stream(self.device) if cuda else None
        ev0, ev1 = event(self.device, True), event(self.device, True)
        inflight: deque = deque()
        steps, t0 = 0, time.perf_counter()
        ev0.record(stream)
        while not until(steps, time.perf_counter() - t0):
            i = steps % len(self.batches)
            if mark is None:
                out = self.step(self.batches[i])
            else:
                with mark("step"):
                    out = self.step(self.batches[i])
            ev = event(self.device)
            ev.record(stream)
            inflight.append(ev)
            steps += 1
            if keep is not None:
                keep.offer((i, out))
            if len(inflight) > self.depth:
                if mark is None:
                    inflight.popleft().synchronize()
                else:
                    with mark("wait"):
                        inflight.popleft().synchronize()
        ev1.record(stream)
        ev1.synchronize()
        return steps, ev0.elapsed_time(ev1) * 1e-3

    def window(self, seconds: float) -> dict:
        self.kept = Reservoir(1, self.run.seed)
        synchronize(self.device)
        t0 = time.perf_counter()
        steps, dev_s = self._loop(lambda n, t: t >= seconds, keep=self.kept)
        elapsed = time.perf_counter() - t0
        B = int(self.p["batch"])
        return {
            "metrics": {"link_samples_per_s": steps * B * self.frame_len / elapsed},
            "attempted": steps * B, "failed": 0, "steps": steps, "elapsed_s": elapsed,
            "device_s_per_step": dev_s / steps,
            "info": {"window": {"steps": steps, "elapsed_s": elapsed,
                                "device_ms_per_step": dev_s / steps * 1e3}},
        }

    def trace_window(self, mark) -> dict:
        n = int(self.p["trace_steps"])
        steps, dev_s = self._loop(lambda k, t: k >= n, mark=mark)
        return {"steps": steps, "event_ms_per_step": dev_s / steps * 1e3}

    def release(self) -> None:
        """Free all but the kept step's payload and outputs."""
        (i, out), = self.kept.items
        self.kept_payload, self.kept_out = self.batches[i], out
        self.batches = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------
    def _compare(self, wf: Waveform, estimate: torch.Tensor) -> tuple[float, float]:
        """(widest |estimate - reference| over every payload symbol of the
        kept step, the reference's EVM over the step), the reference run in
        blocks of rows."""
        rows = int(self.p.get("check_rows", 4096))
        gap, err, power = 0.0, 0.0, 0.0
        for r0 in range(0, self.kept_payload.shape[0], rows):
            sent = self.kept_payload[r0 : r0 + rows]
            ref = wf.link(sent)["data"].to(torch.complex128)
            est = wf.complex_payload(estimate[r0 : r0 + rows]).to(ref.device)
            gap = max(gap, float((est - ref).abs().max()))
            sent = wf.complex_payload(sent).to(ref.device)
            err += float((ref - sent).abs().pow(2).sum())
            power += float(sent.abs().pow(2).sum())
        return gap, (err / power) ** 0.5

    def _numbers(self, wf: Waveform, estimate: torch.Tensor, evm: float) -> dict:
        """``data_gap``; ``evm_gap``, |EVM - the reference's| over the
        reference's."""
        gap, evm_ref = self._compare(wf, estimate)
        return {"data_gap": gap, "evm_gap": abs(evm - evm_ref) / evm_ref}

    def _decision_failures(self) -> int:
        """Bursts of the kept step with any QPSK decision unlike the sent
        symbol."""
        d_hat = self.kept_out[0]
        wrong = (torch.sign(d_hat) != torch.sign(self.kept_payload)).flatten(1)
        return int(wrong.any(dim=1).sum())

    def readings(self) -> dict:
        prec = self.run.workload["precision"]
        wf = Waveform(self.shape, self.device, prec["linear_reference"], prec.get("ic_operand"))
        self.run.window["failed"] = self._decision_failures()
        d_hat, _snr, evm = self.kept_out
        return self._numbers(wf, d_hat, float(evm))

    def control(self) -> dict:
        """The same comparison with the reference, computed in the cell's
        control precisions, in the program's place (its EVM from its own
        estimates, as the program's is)."""
        prec = self.run.workload["precision"]
        ref = Waveform(self.shape, self.device, prec["linear_reference"], prec.get("ic_operand"))
        ctl = Waveform(self.shape, self.device, prec["linear_control"],
                       prec.get("ic_operand_control"))
        rows = int(self.p.get("check_rows", 4096))
        outs = []
        for r0 in range(0, self.kept_payload.shape[0], rows):
            d = ctl.link(self.kept_payload[r0 : r0 + rows])["data"]
            outs.append(torch.stack([d.real, d.imag], dim=1).to(torch.float32))
        d_hat = torch.cat(outs)
        sent = self.kept_payload.to(torch.float64)
        evm = float(((d_hat.double() - sent).pow(2).sum() / sent.pow(2).sum()).sqrt())
        return self._numbers(ref, d_hat, evm)
