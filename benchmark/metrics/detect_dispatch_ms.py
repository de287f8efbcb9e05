"""The host's own time a job inside detect_batch, launching and in
Python: the host time of the ``detect_batch`` span less that of the
``sync.*`` spans (in this cell every one lies inside it), a call
(benchmark/port_counts.py)."""

from benchmark.port_counts import per_call, waits_ns


def read(run):
    return per_call(lambda c: (c["ns.detect_batch"] - waits_ns(c)) / 1e6)
