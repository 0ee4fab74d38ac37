"""Device kernels a served batch: the kernels in the traced window's
profiler timeline over the batches it delivered."""


def read(run):
    t = run.trace
    if not t or not t.get("batches"):
        return None
    return t["kernels"] / t["batches"]
