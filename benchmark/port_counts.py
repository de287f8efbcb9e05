"""The port's own counts of a traced run (rspt_tpu_torch/utils/tracing.py):
what its spans and counters recorded while the profiler ran, over every
traced window of the run (the counts are the port's, and no window
resets them), per call of ``detect_batch`` (one a job).

Every reader of these returns None where the port has no tracing module,
as before it had one, or where it counted no ``detect_batch`` call."""

from __future__ import annotations

from typing import Callable, Dict, Optional

CALLS = "calls.detect_batch"


def snapshot() -> Optional[Dict[str, int]]:
    """The port's counts, or None without its tracing module."""
    try:
        from rspt_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def waits_ns(counts: Dict[str, int]) -> int:
    """Host nanoseconds inside the port's ``sync.*`` spans."""
    return sum(v for k, v in counts.items() if k.startswith("ns.sync."))


def per_call(value: Callable[[Dict[str, int]], Optional[float]]
             ) -> Optional[float]:
    """``value(counts)`` over the detect_batch calls counted, or None."""
    counts = snapshot()
    if not counts or not counts.get(CALLS):
        return None
    v = value(counts)
    return None if v is None else v / counts[CALLS]
