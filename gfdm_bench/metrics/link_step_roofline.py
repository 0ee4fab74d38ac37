"""The whole link step's share of its roofline: the step's least time
(counts.gfdm.link_work over counts.peaks, the larger of its flop and byte
bounds) over the device seconds a step, from CUDA events around the
measured window's steps (steps dispatched back to back)."""
from gfdm_bench.common import shape
from gfdm_bench.counts.gfdm import link_work
from gfdm_bench.counts.peaks import least_seconds


def read(run):
    w = run.window
    if not w.get("steps") or not w.get("device_s_per_step"):
        return None
    p = run.workload["params"]
    work = link_work(shape(run.config), int(p["batch"]), int(p.get("ic_iterations", 2)),
                     outputs=tuple(p["outputs"]))
    least, _bound = least_seconds(work)
    return 100.0 * least / w["device_s_per_step"]
