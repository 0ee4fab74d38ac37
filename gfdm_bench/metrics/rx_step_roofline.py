"""The whole service step's share of its roofline: a batch's least time
(counts.gfdm.rx_step_work on its chunks and placed bursts, with the
decoder where the cell decodes, over
counts.peaks) over the device kernel seconds a batch in the traced window
(the union of kernel intervals in the profiler timeline over the batches)."""
from gfdm_bench.common import shape
from gfdm_bench.counts.gfdm import rx_step_work
from gfdm_bench.counts.peaks import least_seconds


def read(run):
    t = run.trace
    if not t or not t.get("batches") or t.get("kernel_busy_s", 0) <= 0:
        return None
    p, cfg = run.workload["params"], run.config
    n = int(p["batch_chunks"])
    length = int(p["chunk_len"]) + int(cfg["frame_len"]) + int(cfg["cp_len"])
    if p["traffic"] == "coded":  # one burst a chunk
        bursts = n
    else:
        bursts = round(n * sum(c * f for c, f in enumerate(p["density"])))
    fec = (2 * int(cfg["n_data_symbols"])) // 2 - 6 if p.get("fec") == "conv" else None
    work = rx_step_work(shape(cfg), n, length, bursts, int(p.get("ic_iterations", 2)), fec)
    least, _bound = least_seconds(work)
    return 100.0 * least / (t["kernel_busy_s"] / t["batches"])
