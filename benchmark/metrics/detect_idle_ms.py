"""The card's idle time a job inside detect_batch: the time of the
harness's ``detect`` spans that no device operation covers (the
complement of ``Trace.busy()`` there), over the traced jobs. In this
cell a ``detect`` span holds exactly the one ``detect_batch`` call of a
job (benchmark/runners/qrs_jobs.py). None where the trace holds no
device operation or no ``detect`` span."""

from bisect import bisect_right


def read(run):
    tr = run.trace
    spans = [(a, b) for name, a, b in tr.spans if name == "detect"]
    if not tr.ops or not spans or not run.steps:
        return None
    busy = tr.busy()
    starts = [a for a, _ in busy]
    idle = 0.0
    for a, b in spans:
        idle += b - a
        # busy intervals are disjoint and in order: from the last that
        # starts at or before a, through those that start before b
        i = max(0, bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            idle -= max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return 1e3 * idle / run.steps
