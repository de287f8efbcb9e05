"""detect_batch's time a job: CUDA events around the call (its kernels,
element-wise ops and launches), summed over the traced jobs."""


def read(run):
    c = run.counters
    return c["detect_ms"] / c["jobs"] if c.get("jobs") else None
