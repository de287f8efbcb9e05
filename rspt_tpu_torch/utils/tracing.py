"""Spans and counters of the port's hot paths, on the profiler's clock.

``span(name)`` is a profiler range named ``rspt.<name>`` while a torch
profiler records, and a shared no-op context otherwise: the profiler's
own check decides, so an untraced call pays that check and nothing more
(no environment variable, flag or argument turns tracing on). The
profiler nests the ranges, so a span's parent is the span that caused
it. A range is of function scope (the profiler's ``cpu_op``), not a
``record_function`` user annotation: the profiler puts no device-side
copy of it among the card's operations, where a reader of the trace
would count it as the card's work.

While a profiler records, each span also counts its calls under
``calls.<name>`` and its host time under ``ns.<name>``, so the counts
alone give a stage's time a call.

``count(name, n)`` adds to a process-wide count, under the same rule:
nothing is counted while no profiler records. ``n`` is a number, or a
tensor whose sum is added on its device into one accumulator a name,
with no host read; ``snapshot()`` reads those once. ``reset()`` clears
every count.

``sync(site, device)`` marks a point where the host blocks on the card:
the span ``sync.<site>`` and one count of ``host_syncs``; nothing on the
CPU, where no call waits for a card.

The counts take no lock: count from the one thread that runs the path.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Union

import torch

PREFIX = "rspt."

enabled = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_device: Dict[str, torch.Tensor] = {}


class _Span:
    """A profiler range that counts its calls and host nanoseconds."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = _Range(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        _add("calls." + self.name, 1)
        _add("ns." + self.name, dt)
        return False


def _add(name: str, n: int) -> None:
    _counts[name] = _counts.get(name, 0) + n


def span(name: str):
    """A profiler range ``rspt.<name>`` while one records, else a no-op."""
    if enabled():
        return _Span(name)
    return _OFF


def sync(site: str, device: torch.device):
    """The span ``sync.<site>`` and one ``host_syncs`` count around a
    point where the host waits for ``device``; a no-op off the card."""
    if device.type != "cuda" or not enabled():
        return _OFF
    _add("host_syncs", 1)
    return _Span("sync." + site)


def count(name: str, n: Union[int, torch.Tensor] = 1) -> None:
    """Add ``n`` to the count ``name`` while a profiler records; a
    tensor's sum is added on its device."""
    if not enabled():
        return
    if not isinstance(n, torch.Tensor):
        _add(name, int(n))
        return
    n = n.sum(dtype=torch.int64)
    acc = _device.get(name)
    _device[name] = n if acc is None else acc.add_(n)


def reset() -> None:
    """Clear every count."""
    _counts.clear()
    _device.clear()


def snapshot() -> Dict[str, int]:
    """Every count by name, the device ones read once each."""
    out = dict(_counts)
    for name, acc in _device.items():
        out[name] = out.get(name, 0) + int(acc)
    return out
