"""The traced window: torch.profiler over the cell's own steps, and its
reduction to device operations, busy time, idle gaps and the harness's
host spans.

The harness marks the calls into each layer with ``span(name)``
(``record_function`` ranges named ``bench.<name>``); the profiler puts
them on the same clock as the device operations. The profiler loses a
trace's events now and then, all or a few, and never adds one, so a
traced window is repeated up to ATTEMPTS times and the fullest, by device
operations a step, is kept.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "bench."
ATTEMPTS = 3


def span(name: str):
    """A host span around a call into a layer; free when not profiling."""
    return torch.profiler.record_function(PREFIX + name)


@dataclass
class Trace:
    """One traced window, times in seconds from the profiler's start."""
    ops: List[Tuple[str, float, float]]       # device operations
    spans: List[Tuple[str, float, float]]     # the harness's host spans
    start: float
    end: float
    steps: int
    counters: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_pct(self) -> Optional[float]:
        if not self.ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def op_seconds(self, *names: str) -> float:
        """Seconds of the device operations whose name holds any of
        ``names``."""
        return sum(b - a for n, a, b in self.ops
                   if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for n, a, b in self.ops:
            tot[n] = tot.get(n, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda i: -i[1])[:k]]

    def span_at(self, t: float) -> str:
        """The innermost harness span the host was inside at t."""
        best = None
        for n, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (n, a, b)
        return "host_inside_" + best[0] if best else "host_outside_spans"

    def idle_gaps(self, k: int = 10) -> List[List]:
        edges = [self.start]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.end)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.span_at((a + b) / 2), b - a] for a, b in gaps[:k]]


def _capture(step: Callable[[], None], seconds: float,
             reset: Callable[[], None], counters: Callable[[], dict]
             ) -> Trace:
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    steps = 0
    reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                step()
                steps += 1
            torch.cuda.synchronize()
    ops, spans, window = [], [], None
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(PREFIX):
            if e.device_type != cuda:
                if e.name == PREFIX + "window":
                    window = (a, b)
                else:
                    spans.append((e.name[len(PREFIX):], a, b))
        elif e.device_type == cuda:
            ops.append((e.name, a, b))
    if window is None:
        window = (min([o[1] for o in ops], default=0.0),
                  max([o[2] for o in ops], default=0.0))
    return Trace(ops, spans, window[0], window[1], steps, counters())


def traced(step: Callable[[], None], seconds: float,
           reset: Callable[[], None], counters: Callable[[], dict]
           ) -> Trace:
    """Trace ``seconds`` of steps up to ATTEMPTS times, the runner's
    counters reset before each and read after it; stop once two traces
    in a row hold as many device operations a step (within 1%), and keep
    the fullest."""
    best, last = None, None
    for _ in range(ATTEMPTS):
        tr = _capture(step, seconds, reset, counters)
        rate = len(tr.ops) / max(1, tr.steps)
        if best is None or rate > len(best.ops) / max(1, best.steps):
            best = tr
        if last is not None and rate > 0 and abs(rate - last) <= 0.01 * rate:
            break
        last = rate
    return best
