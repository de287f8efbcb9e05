"""Points a job where the host blocked on the card inside the port: the
port's count ``host_syncs`` (one a ``tracing.sync`` site reached) a
detect_batch call (benchmark/port_counts.py)."""

from benchmark.port_counts import per_call


def read(run):
    return per_call(lambda c: c.get("host_syncs", 0))
