"""The readings a cell's limits are set from, in one process.

    python3 -m gfdm_bench.tools.readings --workload link.default.b65536 \\
        --seeds 11,12,13 --seconds 2 [--control] [--look] [--worst]

For each seed: the cell's set-up, a measured window of ``--seconds`` at the
cell's own load, the comparison of what the window delivered with the
reference (the program's readings) and, with ``--control``, the same
comparison with the reference computed in the cell's control precisions in
the program's place (the control's readings). ``--look`` adds numbers that
no limit compares, read for PERF.md's account of why not (``look``);
``--worst`` the service's slot with the widest ``payload_gap`` and what
tells its cause (``worst_slot``). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from gfdm_bench import run as bench
from gfdm_bench.reference import coding
from gfdm_bench.reference.waveform import Waveform

_FAR = 1 << 40


def _starts(driver, f: dict) -> dict:
    """How the program's picks (``f`` from the service driver's ``follow``)
    differ from the reference's own: ``detect_mismatch``, per chunk the
    found starts of one side the other lacks, over the reference's found
    slots; ``found_flips``, the difference of the found counts; and, in
    chunks whose counts agree, ``pick_loss_max`` / ``_mean``, 1 - the
    reference's gated metric at the program's pick over at its own."""
    k, ref = driver.k, f["ref"]

    def keyed(found, start):
        far = torch.full_like(start, _FAR)
        return torch.sort(torch.where(found, start, far).reshape(-1, k), dim=1).values

    kp, kr = keyed(f["found"], f["start"]), keyed(ref["found"], ref["start"])
    n_ref = max(int(ref["found"].sum()), 1)
    np_c, nr_c = f["found"].reshape(-1, k).sum(1), ref["found"].reshape(-1, k).sum(1)
    both = (kp < _FAR) & (kr < _FAR) & (np_c == nr_c)[:, None]
    g = ref["traces"]["gated"]
    rows = torch.arange(g.shape[0], device=g.device)[:, None].expand_as(kp)
    gp = g[rows[both], kp[both].clamp(max=g.shape[1] - 1)]
    gr = g[rows[both], kr[both].clamp(max=g.shape[1] - 1)]
    loss = (1.0 - gp / gr.clamp_min(1e-300)).clamp_min(0.0)
    return {"detect_mismatch": float((kp != kr).sum()) / n_ref,
            "found_flips": float((np_c - nr_c).abs().sum()) / n_ref,
            "pick_loss_max": float(loss.max()) if loss.numel() else 0.0,
            "pick_loss_mean": float(loss.mean()) if loss.numel() else 0.0}


def _decode_mismatch(driver, f: dict, out: dict) -> float:
    """The share of decoded bits unlike the plain Viterbi's on the
    reference's own LLRs at the same slots."""
    idx, r = f["idx"], f["r"]
    if not idx.numel():
        return 0.0
    llrs = coding.qpsk_llrs(r["data"].to(torch.complex128), r["snr_lin"].double())
    bits_r = coding.viterbi(llrs[:, driver.inv_perm], driver.n_info)
    bits_p = torch.as_tensor(out["bits"], device=driver.device)[idx]
    return float((bits_p != bits_r).float().mean())


def _service_look(driver) -> dict:
    wf, det, front = driver.reference()

    def worst(outs):
        got: dict = {}
        for i, out in outs:
            f = driver.follow(i, out, det, wf, front)
            one = _starts(driver, f)
            if "bits" in out:
                one["decode_mismatch"] = _decode_mismatch(driver, f, out)
            for key, v in one.items():
                got[key] = max(got.get(key, 0.0), v)
        return got

    return {"program": worst(driver.kept.items), "control": worst(driver.control_outputs())}


def _link_look(driver) -> dict:
    """The program's SNR in dB over the kept step and the reference's on
    its first rows: a clean loopback's SNR reads only rounding."""
    _d_hat, snr, _evm = driver.kept_out
    if snr is None:
        return {}
    prec = driver.run.workload["precision"]
    wf = Waveform(driver.shape, driver.device, prec["linear_reference"], prec.get("ic_operand"))
    rows = int(driver.p.get("check_rows", 4096))
    ref = wf.link(driver.kept_payload[:rows])["snr_lin"].double()
    db = 10 * torch.log10(snr.double())
    return {"snr_db_min": float(db.min()), "snr_db_max": float(db.max()),
            "reference_snr_db_min": float((10 * torch.log10(ref)).min())}


def worst_slot(driver) -> dict:
    """The service's slot with the widest ``payload_gap`` over the kept
    batches, with what tells its cause: the program's and the reference's
    start, CFO and SNR there, the chunk's truth, the error a timeslot, and
    the channel estimate's weakest bin against its median."""
    wf, det, front = driver.reference()
    k, worst = driver.k, {"payload_gap": -1.0}
    for i, out in driver.kept.items:
        f = driver.follow(i, out, det, wf, front)
        idx, r = f["idx"], f["r"]
        if not idx.numel():
            continue
        dr = r["data"].to(torch.complex128)
        dp = torch.as_tensor(out["data"], device=driver.device)[idx].double()
        dp = torch.complex(dp[:, 0], dp[:, 1])
        hard = torch.complex(torch.where(dr.real >= 0, 1.0, -1.0),
                             torch.where(dr.imag >= 0, 1.0, -1.0)).to(torch.complex128) * 2**-0.5
        num = (dp - dr).abs().pow(2).mean(-1).sqrt()
        den = (dr - hard).abs().pow(2).mean(-1).sqrt().clamp_min(1e-12)
        j = int((num / den).argmax())
        if float(num[j] / den[j]) <= worst["payload_gap"]:
            continue
        slot, chunk = int(idx[j]), int(idx[j]) // k
        ref = f["ref"]
        err = (dp[j] - dr[j]).abs().pow(2).reshape(wf.M, -1).mean(-1).sqrt()
        h = r["channel"][j].abs()
        worst = {
            "payload_gap": float(num[j] / den[j]), "num": float(num[j]), "den": float(den[j]),
            "batch": i, "slot": slot, "chunk": chunk,
            "truth": [int(t) for t in driver.truth[i][chunk]],
            "program": {"found": out["found"].reshape(-1, k)[chunk].tolist(),
                        "start": out["start"].reshape(-1, k)[chunk].tolist(),
                        "cfo": out["cfo"].reshape(-1)[slot].item(),
                        "snr_db": float(10 * np.log10(out["snr_lin"][slot]))},
            "reference": {"found": ref["found"].reshape(-1, k)[chunk].tolist(),
                          "start": ref["start"].reshape(-1, k)[chunk].tolist(),
                          "cfo": ref["cfo"].reshape(-1, k)[chunk].tolist(),
                          "cfo_at_program_start": float(f["at"]["cfo"][j]),
                          "snr_db": float(10 * torch.log10(r["snr_lin"][j]))},
            "err_per_timeslot": [round(float(e), 5) for e in err],
            "channel_min_over_median": float(h.min() / h.median()),
        }
    return worst


def look(driver) -> dict:
    """Numbers that no limit of the cell compares."""
    return _service_look(driver) if hasattr(driver, "follow") else _link_look(driver)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--worst", action="store_true", help="the service's worst slot")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = bench.load_json("workloads", args.workload)
    cfg = bench.load_json("configs", wl["config"])
    mod = bench.load_module("drivers", wl["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = bench.Run(wl, cfg, seed, args.seconds, False, device)
        extra = [fn for on, fn in ((args.look, look), (args.worst, worst_slot)) if on]
        got = bench.execute(run, mod, control=args.control,
                            look=(lambda d: {fn.__name__: fn(d) for fn in extra})
                            if extra else None)
        row = {"workload": args.workload, "seed": seed,
               "program": got["readings"],
               "control": got.get("control"), "look": got.get("look"),
               "attempted": run.window["attempted"],
               "failed": run.window["failed"], "wall_s": time.time() - t0}
        print(json.dumps(row), flush=True)
        del got, run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
