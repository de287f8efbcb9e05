"""The host's time a job blocked on the card inside the port: the host
time of the port's ``sync.*`` spans a detect_batch call
(benchmark/port_counts.py)."""

from benchmark.port_counts import per_call, waits_ns


def read(run):
    return per_call(lambda c: waits_ns(c) / 1e6)
