"""S2 iir_assoc's share of its roofline in detect_batch: the bytes of its
three calls a job (benchmark/rooflines/signal.py) at the HBM peak, over
the profiler's time of its three kernels (ends, carry, final)."""

from benchmark.rooflines import share_pct, signal

KERNELS = ("iir_ends_kernel", "iir_carry_kernel", "iir_final_kernel")


def read(run):
    c, steps = run.counters, run.steps
    s = run.trace.op_seconds(*KERNELS)
    if not steps or s <= 0:
        return None
    return share_pct(signal.iir_assoc_bytes(c["rows"], c["T"]), s / steps)
