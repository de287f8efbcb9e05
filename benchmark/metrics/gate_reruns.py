"""S4 peak_gate's chunks re-run a job by its repair walk: the port's
count ``gate_reruns`` (``peak_gate.last_reruns``' chunk column, summed on
the card) a detect_batch call (benchmark/port_counts.py)."""

from benchmark.port_counts import per_call


def read(run):
    return per_call(lambda c: c.get("gate_reruns"))
