"""S4 peak_gate's share of its roofline in detect_batch: its bytes a job
(benchmark/rooflines/signal.py) at the HBM peak, over the profiler's
time of its two kernels (speculate, repair)."""

from benchmark.rooflines import share_pct, signal

KERNELS = ("gate_speculate", "gate_repair")


def read(run):
    c, steps = run.counters, run.steps
    s = run.trace.op_seconds(*KERNELS)
    if not steps or s <= 0:
        return None
    return share_pct(signal.peak_gate_bytes(c["rows"], c["T"]), s / steps)
