"""The coded 64-QAM receive service: ``service.Driver`` with the receiver
built for the configuration's constellation and the cell's IC passes, and
the traffic, the reference and the plain decoder at 6 coded bits a symbol.

Set-up builds ``StreamingReceiver(..., fec="conv", constellation=<the
configuration's>, ic_iterations=<the cell's>)`` and draws each pool batch
from ``reference.qam.coded_qam_chunks``; the window, the deliveries and
``miss_share`` are the service driver's. The comparison follows the
program's start at every found slot with ``reference.qam.QamWaveform``
(64-QAM decisions in the cancellation, the cell's IC passes):
``payload_gap`` is, a slot, rms(data - reference) over rms(reference - its
own 64-QAM decisions), near ties allowed through ``tie_margin`` as in the
QPSK cells, up to four a burst (``_with_ties``); ``crc_fail_share`` checks
the decoded CRC-32 frames. The
control decodes the control's own 64-point max-log LLRs
(``reference.qam.maxlog_llrs``) with the plain Viterbi.

The traced window also returns ``coded_bits``, the coded bits the program
counted as soft-decoded over the window (``ServiceStats.coded_bits``); a
program without that counter gives no such key.
"""
from __future__ import annotations

import numpy as np
import torch

from gfdm_bench.common import program_config, synchronize
from gfdm_bench.drivers import service
from gfdm_bench.reference import coding, qam, traffic
from gfdm_bench.reference.precision import rounder
from gfdm_bench.reference.sync import Detector


class Driver(service.Driver):
    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from gfdm_tpu_torch.runtime.service import StreamingReceiver

        p = self.p
        self.cfg = program_config(self.run.config)
        self.rx = StreamingReceiver(
            self.cfg, chunk_len=self.chunk_len, batch_chunks=int(p["batch_chunks"]),
            max_bursts_per_chunk=int(p["max_bursts_per_chunk"]), engine=p["engine"],
            pipeline_depth=int(p["pipeline_depth"]), fec=p["fec"],
            constellation=self.run.config["constellation"],
            ic_iterations=int(p["ic_iterations"]), device=self.device)
        from gfdm_bench.run import mark

        mark("program")
        wf = qam.QamWaveform(self.shape, self.device)
        gen = traffic.generator(self.run.seed, self.device)
        self.pool, self.truth, self.info = [], [], []
        for _ in range(int(p["pool"])):
            b = qam.coded_qam_chunks(wf, int(p["batch_chunks"]), self.chunk_len, gen,
                                     snr_db=float(p["snr_db"]), cfo_max=float(p["cfo_max"]),
                                     payload_bytes=int(p["payload_bytes"]))
            self.info.append(b["info"])
            self.pool.append(np.ascontiguousarray(b["chunks"].cpu().numpy()))
            self.truth.append(self._truth(b))
        del b, wf
        mark("traffic")
        self._empty_cache()
        self._serve(lambda i: None, batches=int(p["pool"]) + 2)
        synchronize(self.device)

    def trace_window(self, mark) -> dict:
        before = getattr(self.rx.stats, "coded_bits", None)
        got = super().trace_window(mark)
        if before is not None:
            got["coded_bits"] = self.rx.stats.coded_bits - before
        return got

    # -- the comparison ---------------------------------------------------
    @property
    def n_coded(self) -> int:
        return qam.BITS * int(self.run.config["n_data_symbols"])

    @property
    def n_info(self) -> int:
        return coding.info_bits(self.n_coded)

    @property
    def inv_perm(self) -> torch.Tensor:
        return torch.as_tensor(np.argsort(coding.interleaver(self.n_coded)),
                               device=self.device)

    def _waveform(self, linear: str, ic_operand) -> qam.QamWaveform:
        return qam.QamWaveform(self.shape, self.device, linear, ic_operand,
                               ic_iterations=int(self.p["ic_iterations"]))

    def reference(self):
        prec = self.run.workload["precision"]
        wf = self._waveform(prec["linear_reference"], prec.get("ic_operand"))
        det = Detector(wf, self.chunk_len, trace_precision=prec["front_reference"])
        return wf, det, prec["front_reference"]

    def _compare(self, i: int, out: dict, det: Detector, wf, front: str) -> dict:
        """``service.Driver._compare`` with ``payload_gap``'s denominator
        the reference's distance to its own 64-QAM decisions."""
        f = self.follow(i, out, det, wf, front)
        idx, r = f["idx"], f["r"]
        n_bursts = int((self.truth[i] != service._NONE).sum())
        got = {"miss_share": 1.0 - self._delivered(i, out) / max(n_bursts, 1),
               "cfo_gap": 0.0, "snr_gap_db": 0.0, "payload_gap": 0.0,
               "crc_fail_share": self._crc_fail_share(i, out)}
        if not idx.numel():
            return got
        cfo_p = torch.as_tensor(out["cfo"], device=self.device).reshape(-1)[idx].double()
        dr = r["data"].to(torch.complex128)
        dp = torch.as_tensor(out["data"], device=self.device)[idx].double()
        dp = torch.complex(dp[:, 0], dp[:, 1])
        num = (dp - dr).abs().pow(2).mean(-1).sqrt()
        den = (dr - qam.decide(dr)).abs().pow(2).mean(-1).sqrt().clamp_min(1e-12)
        ratio = self._with_ties(wf, f, dp, den, num / den)
        snr_p = torch.as_tensor(out["snr_lin"], device=self.device)[idx].double()
        snr_r = r["snr_lin"].to(torch.float64)
        snr_gap = (10 * torch.log10(snr_p.clamp_min(1e-30) / snr_r.clamp_min(1e-30))).abs()
        return got | {"cfo_gap": float((cfo_p - f["at"]["cfo"]).abs().max()),
                      "snr_gap_db": float(snr_gap.max()),
                      "payload_gap": float(ratio.max())}

    def control_outputs(self) -> list:
        """``service.Driver.control_outputs`` at 64-QAM: the control's
        receiver decides on the 64-QAM grid, and its bits are the plain
        Viterbi's on its own 64-point max-log LLRs."""
        prec = self.run.workload["precision"]
        ctl = self._waveform(prec["linear_control"], prec.get("ic_operand_control"))
        cdet = Detector(ctl, self.chunk_len, trace_precision=prec["front_control"])
        outs = []
        for i, _out in self.kept.items:
            chunks = torch.from_numpy(self.pool[i]).to(self.device)
            s = rounder(prec["front_control"])(chunks).to(torch.float64)
            s = torch.complex(s[:, 0], s[:, 1])
            d = cdet.detect(s, self.k)
            idx = torch.nonzero(d["found"])[:, 0]
            bursts = cdet.extract(s, idx // self.k, d["start"][idx], d["scale"][idx],
                                  d["cfo"][idx])
            r = ctl.receive(bursts)
            slots = d["found"].numel()
            data = torch.zeros((slots, 2, ctl.n_data), dtype=torch.float32, device=self.device)
            data[idx] = torch.stack([r["data"].real, r["data"].imag], 1).to(torch.float32)
            snr = torch.ones(slots, dtype=torch.float64, device=self.device)
            snr[idx] = r["snr_lin"].to(torch.float64)
            bits = torch.zeros((slots, self.n_info), dtype=torch.uint8, device=self.device)
            llrs = qam.maxlog_llrs(r["data"], r["snr_lin"])
            bits[idx] = coding.viterbi(llrs[:, self.inv_perm], self.n_info)
            fields = [("found", d["found"]), ("start", d["start"]), ("cfo", d["cfo"]),
                      ("snr_lin", snr), ("data", data), ("bits", bits)]
            outs.append((i, {k: v.cpu().numpy() for k, v in fields}))
        return outs

    def _with_ties(self, wf, f: dict, dp, den, ratio):
        """Each found slot's ``payload_gap`` against the nearest answer the
        reference allows: its own, or its own with up to four decisions that
        lie within the cell's ``tie_margin`` of their boundary flipped
        (``QamWaveform.nearest_answer``). At 64-QAM a burst holds 936
        decisions a pass over four passes, so two near ties that a float32
        receiver decides otherwise meet in one burst now and then, and a
        flipped near tie recurs in a later pass where the cancellation
        repeats its estimate, the next pass once it has converged or two
        passes on while the neighbours' decisions alternate. Only slots
        over ``service._TIE_FROM`` are looked at."""
        tie = float(self.p.get("tie_margin", 0.0))
        hi = torch.nonzero(ratio > service._TIE_FROM)[:, 0]
        if tie <= 0 or not hi.numel():
            return ratio
        alt = wf.nearest_answer(f["bursts"][hi], f["r"]["data"][hi], f["r"]["margins"][:, hi],
                                dp[hi], tie)
        gap = (dp[hi] - alt).abs().pow(2).mean(-1).sqrt() / den[hi]
        return ratio.clone().scatter_reduce_(0, hi, gap, reduce="amin")
