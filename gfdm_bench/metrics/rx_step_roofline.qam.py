"""The coded 64-QAM service step's share of its roofline: a batch's least
time (counts.qam.qam_step_work: the receive step of counts.gfdm at the
cell's IC passes, with the decoder's soft bits demapped over the
configuration's constellation, over counts.peaks) over the device kernel
seconds a batch in the traced window (the union of kernel intervals in the
profiler timeline over the batches).

The codewords a batch are the program's own count: the traced window's
``coded_bits`` (``ServiceStats.coded_bits``, every slot the decoder ran
on) over its batches and the coded bits a codeword. A program without
that counter reads None."""
import math

from gfdm_bench.common import shape
from gfdm_bench.counts.qam import qam_step_work
from gfdm_bench.counts.peaks import least_seconds
from gfdm_bench.reference import coding

POINTS = {"qpsk": 4, "qam16": 16, "qam64": 64}


def read(run):
    t = run.trace
    if (not t or not t.get("batches") or t.get("kernel_busy_s", 0) <= 0
            or not t.get("coded_bits")):
        return None
    p, cfg = run.workload["params"], run.config
    points = POINTS[cfg["constellation"]]
    bits = int(math.log2(points))
    n_coded = bits * int(cfg["n_data_symbols"])
    codewords = t["coded_bits"] / (n_coded * t["batches"])
    length = int(p["chunk_len"]) + int(cfg["frame_len"]) + int(cfg["cp_len"])
    work = qam_step_work(shape(cfg), int(p["batch_chunks"]), length, codewords,
                         int(p["ic_iterations"]), coding.info_bits(n_coded), points, bits)
    least, _bound = least_seconds(work)
    return 100.0 * least / (t["kernel_busy_s"] / t["batches"])
