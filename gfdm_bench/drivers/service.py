"""The receive service: ``StreamingReceiver(...).serve(source, sink)`` in a
closed loop over a pool of chunk batches.

Set-up builds the receiver with the cell's settings (every other setting
the program's default), makes ``pool`` batches of ``batch_chunks``
impaired chunks on the device from the seed (``reference.traffic``, each
burst from the reference modulator), copies them to host memory and warms
the loop up on them. In the window the source hands ``serve()`` the pool's
batches in turn as NumPy arrays, always ready, until ``seconds`` have
passed; the program stages each into its own pinned buffer, so that copy is
host work in the window. ``rx_samples_per_s`` is the owned samples
(chunks x chunk_len) of the batches whose outputs reached the sink before
the source ran dry, over the window's seconds.

Every delivered batch is checked against its truth: a burst is delivered
when a found slot of its chunk starts within ``start_tolerance`` samples of
its core preamble (its first sample plus cp_len); ``attempted`` counts the
placed bursts, ``failed`` those not delivered. ``samples`` delivered
batches, drawn from the seed, are kept whole for the comparison with the
reference (``readings``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gfdm_bench.common import Reservoir, program_config, shape, synchronize
from gfdm_bench.reference import coding, traffic
from gfdm_bench.reference.precision import rounder
from gfdm_bench.reference.sync import Detector
from gfdm_bench.reference.waveform import Waveform

_NONE = -(1 << 40)
_TIE_FROM = 1e-4  # payload_gap below which near-tie answers are not looked for


class Driver:
    def __init__(self, run):
        self.run = run
        self.p = run.workload["params"]
        self.shape = shape(run.config)
        self.device = run.device
        self.k = max(1, int(self.p["max_bursts_per_chunk"]))
        self.chunk_len = int(self.p["chunk_len"])

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from gfdm_tpu_torch.runtime.service import StreamingReceiver

        p = self.p
        self.cfg = program_config(self.run.config)
        self.rx = StreamingReceiver(
            self.cfg, chunk_len=self.chunk_len, batch_chunks=int(p["batch_chunks"]),
            max_bursts_per_chunk=int(p["max_bursts_per_chunk"]), engine=p["engine"],
            pipeline_depth=int(p["pipeline_depth"]), fec=p.get("fec", "none"),
            device=self.device)
        from gfdm_bench.run import mark

        mark("program")
        wf = Waveform(self.shape, self.device)
        gen = traffic.generator(self.run.seed, self.device)
        self.pool, self.truth = [], []
        self.info = []
        for _ in range(int(p["pool"])):
            if p["traffic"] == "coded":
                b = traffic.coded_chunks(wf, int(p["batch_chunks"]), self.chunk_len, gen,
                                         snr_db=float(p["snr_db"]),
                                         payload_bytes=int(p["payload_bytes"]))
                self.info.append(b["info"])
            else:
                b = traffic.impaired_chunks(
                    wf, int(p["batch_chunks"]), self.chunk_len, gen, snr_db=float(p["snr_db"]),
                    cfo_max=float(p["cfo_max"]), taps=int(p["taps"]),
                    tap_decay=float(p["tap_decay"]), density=tuple(p["density"]))
            self.pool.append(np.ascontiguousarray(b["chunks"].cpu().numpy()))
            self.truth.append(self._truth(b))
        del b, wf
        mark("traffic")
        self._empty_cache()
        self._serve(lambda i: None, batches=int(p["pool"]) + 2)
        synchronize(self.device)

    def _empty_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _truth(self, b: dict) -> np.ndarray:
        """(n_chunks, k) expected core-preamble starts, _NONE where empty."""
        n = int(self.p["batch_chunks"])
        starts = np.full((n, self.k), _NONE, dtype=np.int64)
        chunk = b["chunk"].cpu().numpy()
        pos = b["pos"].cpu().numpy() + int(self.run.config["cp_len"])
        rank = np.arange(chunk.size) - np.searchsorted(chunk, chunk)
        starts[chunk, rank] = pos
        return starts

    def _serve(self, on_batch, batches: int | None = None, seconds: float | None = None,
               mark=None):
        """One serve() call over the pool in turn; ``on_batch(out)`` is the
        sink. Returns (batches pulled, seconds until the source ran dry)."""
        state = {"pulled": 0, "t_end": None}
        t0 = time.perf_counter()

        def source():
            now = time.perf_counter()
            if ((batches is not None and state["pulled"] >= batches)
                    or (seconds is not None and now - t0 >= seconds)):
                if state["t_end"] is None:
                    state["t_end"] = now
                return None
            chunks = self.pool[state["pulled"] % len(self.pool)]
            state["pulled"] += 1
            return chunks[:]

        src, sink = source, on_batch
        if mark is not None:
            def src():
                with mark("source"):
                    return source()

            def sink(out):
                with mark("sink"):
                    on_batch(out)
        self.rx.serve(src, sink)
        return state["pulled"], state["t_end"] - t0, t0

    # -- the window -------------------------------------------------------
    def _delivered(self, i: int, out: dict) -> int:
        """Bursts of pool batch ``i`` that ``out`` delivered."""
        truth = self.truth[i]
        start = out["start"].reshape(-1, self.k).astype(np.int64)
        found = out["found"].reshape(-1, self.k)
        tol = int(self.p["start_tolerance"])
        near = np.abs(start[:, None, :] - truth[:, :, None]) <= tol  # (n, truth, slot)
        return int((near & found[:, None, :]).any(axis=2).sum())

    def window(self, seconds: float) -> dict:
        n_pool = len(self.pool)
        self.kept = Reservoir(int(self.p["samples"]), self.run.seed)
        deliveries = []  # (time, bursts placed, bursts delivered)

        def sink(out):
            i = len(deliveries) % n_pool
            deliveries.append((time.perf_counter(), int((self.truth[i] != _NONE).sum()),
                               self._delivered(i, out)))
            self.kept.offer((i, out))

        pulled, elapsed, t0 = self._serve(sink, seconds=seconds)
        done = [d for d in deliveries if d[0] <= t0 + elapsed]
        gaps = np.diff([t0] + [d[0] for d in done]) * 1e3
        samples = len(done) * int(self.p["batch_chunks"]) * self.chunk_len
        attempted = sum(d[1] for d in done)
        return {
            "metrics": {"rx_samples_per_s": samples / elapsed},
            "attempted": attempted,
            "failed": attempted - sum(d[2] for d in done),
            "batches": len(done), "elapsed_s": elapsed,
            "info": {"window": {"batches_in_window": len(done), "batches": len(deliveries),
                                "elapsed_s": elapsed, "pulled": pulled,
                                "batch_ms_quartiles": np.percentile(gaps, [25, 50, 75]).tolist()
                                if gaps.size else None,
                                "batch_ms_first_last_half": [
                                    float(np.median(gaps[: gaps.size // 2])),
                                    float(np.median(gaps[gaps.size // 2 :]))]
                                if gaps.size > 3 else None}},
        }

    def trace_window(self, mark) -> dict:
        n = int(self.p["trace_batches"])
        got = []
        self._serve(lambda out: got.append(1), batches=n, mark=mark)
        return {"batches": len(got)}

    def release(self) -> None:
        del self.rx
        self._empty_cache()

    # -- the comparison ---------------------------------------------------
    def follow(self, i: int, out: dict, det: Detector, wf: Waveform, front: str) -> dict:
        """The reference on pool batch ``i``'s samples rounded as ``front``
        states: its own detection (``ref``), and at every slot that ``out``
        found (``idx``) its traces read at ``out``'s start (``at``) and the
        burst extracted there and received from the chunk (``r``)."""
        chunks = torch.from_numpy(self.pool[i]).to(self.device)
        s = rounder(front)(chunks).to(torch.float64)
        s = torch.complex(s[:, 0], s[:, 1])
        del chunks
        ref = det.detect(s, self.k)
        found = torch.as_tensor(out["found"], device=self.device).reshape(-1)
        start = torch.as_tensor(out["start"], device=self.device).reshape(-1).long()
        idx = torch.nonzero(found)[:, 0]
        at = det.at(ref["traces"], idx // self.k, start[idx])
        bursts = det.extract(s, idx // self.k, start[idx], at["scale"], at["cfo"])
        r = wf.receive(bursts, margins=True)
        return {"ref": ref, "found": found, "start": start, "idx": idx, "at": at,
                "bursts": bursts, "r": r}

    def _compare(self, i: int, out: dict, det: Detector, wf: Waveform, front: str) -> dict:
        """The numbers compared for one delivered batch ``out`` of pool batch
        ``i``, against the reference (``det``, ``wf``) on samples rounded as
        ``front`` states:

        - ``miss_share``: the batch's placed bursts ``out`` did not deliver;
        - at every slot ``out`` found, the reference follows ``out``'s start
          (``follow``): ``cfo_gap`` the widest |CFO - reference|;
          ``snr_gap_db`` the widest |SNR - reference| in dB; ``payload_gap``
          the widest ratio, a burst, of rms(data - reference) to
          rms(reference - its own QPSK decisions), the reference's answer
          the nearest of its own and those with one near-tie IC decision
          flipped (``_with_ties``);
        - with ``fec``, ``crc_fail_share``.
        """
        f = self.follow(i, out, det, wf, front)
        idx, r = f["idx"], f["r"]
        n_bursts = int((self.truth[i] != _NONE).sum())
        got = {"miss_share": 1.0 - self._delivered(i, out) / max(n_bursts, 1),
               "cfo_gap": 0.0, "snr_gap_db": 0.0, "payload_gap": 0.0}
        if "bits" in out:
            got["crc_fail_share"] = self._crc_fail_share(i, out)
        if not idx.numel():
            return got
        cfo_p = torch.as_tensor(out["cfo"], device=self.device).reshape(-1)[idx].double()
        dr = r["data"].to(torch.complex128)
        dp = torch.as_tensor(out["data"], device=self.device)[idx].double()
        dp = torch.complex(dp[:, 0], dp[:, 1])
        hard = torch.complex(torch.where(dr.real >= 0, 1.0, -1.0),
                             torch.where(dr.imag >= 0, 1.0, -1.0)).to(torch.complex128) * 2**-0.5
        num = (dp - dr).abs().pow(2).mean(-1).sqrt()
        den = (dr - hard).abs().pow(2).mean(-1).sqrt().clamp_min(1e-12)
        ratio = self._with_ties(wf, f, dp, den, num / den)
        snr_p = torch.as_tensor(out["snr_lin"], device=self.device)[idx].double()
        snr_r = r["snr_lin"].to(torch.float64)
        snr_gap = (10 * torch.log10(snr_p.clamp_min(1e-30) / snr_r.clamp_min(1e-30))).abs()
        return got | {"cfo_gap": float((cfo_p - f["at"]["cfo"]).abs().max()),
                      "snr_gap_db": float(snr_gap.max()),
                      "payload_gap": float(ratio.max())}

    def _with_ties(self, wf: Waveform, f: dict, dp, den, ratio):
        """Each found slot's ``payload_gap`` against the nearest answer the
        reference allows: its own, or its own with one IC decision that lies
        within the cell's ``tie_margin`` of its boundary flipped
        (``Waveform.tie_variants``). A receiver that rounds otherwise may
        decide such a symbol the other way, and the cancellation then moves
        its neighbours by a fixed pattern. Only slots over _TIE_FROM are
        looked at: a reading below it is far under every cell's limit, and
        another answer could only lower it."""
        tie = float(self.p.get("tie_margin", 0.0))
        hi = torch.nonzero(ratio > _TIE_FROM)[:, 0]
        if tie <= 0 or not hi.numel():
            return ratio
        which, _passes, data = wf.tie_variants(f["bursts"][hi], f["r"]["margins"][:, hi], tie)
        if not which.numel():
            return ratio
        slot = hi[which]
        alt = (dp[slot] - data.to(torch.complex128)).abs().pow(2).mean(-1).sqrt() / den[slot]
        return ratio.clone().scatter_reduce_(0, slot, alt, reduce="amin")

    def _crc_fail_share(self, i: int, out: dict) -> float:
        """The share of pool batch ``i``'s bursts that no found slot
        delivered (start within tolerance) with its CRC-32 whole."""
        truth = self.truth[i]
        n_bursts = int((truth != _NONE).sum())
        start = out["start"].reshape(-1, self.k).astype(np.int64)
        found = out["found"].reshape(-1, self.k)
        near = (np.abs(start[:, None, :] - truth[:, :, None]) <= int(self.p["start_tolerance"]))
        ok = coding.crc_ok(out["bits"].reshape(found.size, -1),
                           int(self.p["payload_bytes"])).reshape(found.shape)
        clean = int((near & (found & ok)[:, None, :]).any(axis=2).sum())
        return 1.0 - clean / max(n_bursts, 1)

    @property
    def n_info(self) -> int:
        return coding.info_bits(2 * int(self.run.config["n_data_symbols"]))

    @property
    def inv_perm(self) -> torch.Tensor:
        n = 2 * int(self.run.config["n_data_symbols"])
        return torch.as_tensor(np.argsort(coding.interleaver(n)), device=self.device)

    def _readings(self, outs, det, wf, front) -> dict:
        worst: dict = {}
        for i, out in outs:
            for key, v in self._compare(i, out, det, wf, front).items():
                worst[key] = max(worst.get(key, 0.0), v)
        return worst

    def reference(self):
        prec = self.run.workload["precision"]
        wf = Waveform(self.shape, self.device, prec["linear_reference"], prec.get("ic_operand"))
        det = Detector(wf, self.chunk_len, trace_precision=prec["front_reference"])
        return wf, det, prec["front_reference"]

    def readings(self) -> dict:
        """The comparison of the kept batches with the reference, and
        ``miss_share``: the placed bursts that the window's batches did not
        deliver, over all placed (every answer due in the window); a window
        that delivered no batch missed everything."""
        wf, det, front = self.reference()
        got = self._readings(self.kept.items, det, wf, front)
        w = self.run.window
        got["miss_share"] = w["failed"] / w["attempted"] if w["attempted"] else 1.0
        return got

    def control_outputs(self) -> list:
        """The reference in the control precisions in the program's place,
        on the kept batches: its own detection on the samples rounded as
        ``front_control`` states, extraction at its own starts and its
        receiver computed in ``linear_control`` (and with ``fec`` the plain
        Viterbi), in the program's output layout; [(pool batch, outputs)]."""
        prec = self.run.workload["precision"]
        ctl = Waveform(self.shape, self.device, prec["linear_control"],
                       prec.get("ic_operand_control"))
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
            fields = [("found", d["found"]), ("start", d["start"]), ("cfo", d["cfo"]),
                      ("snr_lin", snr), ("data", data)]
            if self.p.get("fec", "none") == "conv":
                bits = torch.zeros((slots, self.n_info), dtype=torch.uint8, device=self.device)
                llrs = coding.qpsk_llrs(r["data"].to(torch.complex128), r["snr_lin"].double())
                bits[idx] = coding.viterbi(llrs[:, self.inv_perm], self.n_info)
                fields.append(("bits", bits))
            outs.append((i, {k: v.cpu().numpy() for k, v in fields}))
        return outs

    def control(self) -> dict:
        """The same comparison as ``readings`` with the control's outputs
        (``control_outputs``) in the program's place."""
        wf, det, front = self.reference()
        return self._readings(self.control_outputs(), det, wf, front)
