"""The host-to-card copies a job: the profiler's HtoD memcpy time over
the traced jobs."""


def read(run):
    s = run.trace.op_seconds("Memcpy HtoD")
    return 1e3 * s / run.steps if s > 0 and run.steps else None
