"""The readers of the port's own spans and counters
(benchmark/port_counts.py, rspt_tpu_torch/utils/tracing.py): on counts
made by hand; with the port's tracing module hidden, as in a port that
has none; the traced window's reduction with the port's ranges among the
profiler's events; through a whole traced run on the CPU."""

import argparse
import sys
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, manifest, port_counts, trace
from rspt_tpu_torch.utils import tracing

NEW = ("host_syncs.qrs", "host_wait_ms.qrs", "detect_dispatch_ms.qrs",
       "gate_reruns.qrs")
OLD = ("detect_ms.qrs", "upload_ms.qrs", "iir_assoc_roofline",
       "peak_gate_roofline", "device_idle_pct.qrs")


@pytest.fixture(autouse=True)
def clean_counts():
    tracing.reset()
    yield
    tracing.reset()


def read(name, run=None):
    return manifest.reader(name).read(run)


def hide_tracing(monkeypatch):
    """Imports of the port's tracing module fail, as in a port without it."""
    import rspt_tpu_torch.utils
    monkeypatch.setitem(sys.modules, "rspt_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(rspt_tpu_torch.utils, "tracing")


def count_four_jobs():
    """Four jobs' counts, as the port makes them under a profiler: one
    companion copy each (2 ms) and one table miss (1 ms); detect_batch
    6.5 ms each; 130 chunks re-run in all, on two rows."""
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("calls.detect_batch", 4)
        tracing.count("ns.detect_batch", 26_000_000)
        tracing.count("calls.sync.companion_copy", 4)
        tracing.count("ns.sync.companion_copy", 8_000_000)
        tracing.count("ns.sync.iir_tables", 1_000_000)
        tracing.count("host_syncs", 5)
        tracing.count("gate_reruns", torch.tensor([100, 0]))
        tracing.count("gate_reruns", torch.tensor([0, 30]))


def test_new_readers_on_counts_made_by_hand():
    count_four_jobs()
    want = {"host_syncs.qrs": 1.25, "host_wait_ms.qrs": 2.25,
            "detect_dispatch_ms.qrs": 4.25, "gate_reruns.qrs": 32.5}
    for name, value in want.items():
        assert read(name) == pytest.approx(value, rel=1e-12), name


def test_counts_read_zero_when_the_port_waited_for_nothing():
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("calls.detect_batch", 2)
        tracing.count("ns.detect_batch", 3_000_000)
        tracing.count("gate_reruns", 0)
    assert read("host_syncs.qrs") == 0
    assert read("host_wait_ms.qrs") == 0
    assert read("gate_reruns.qrs") == 0
    assert read("detect_dispatch_ms.qrs") == pytest.approx(1.5)


def test_new_readers_none_without_a_counted_call(monkeypatch):
    for name in NEW:
        assert read(name) is None, name
    count_four_jobs()
    hide_tracing(monkeypatch)
    assert port_counts.snapshot() is None
    for name in NEW:
        assert read(name) is None, name


def event(name, a_us, b_us, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=a_us, end=b_us))


HARNESS_EVENTS = [event("bench.window", 0, 1000, False),
                  event("bench.upload", 20, 100, False),
                  event("bench.detect", 100, 900, False),
                  event("bench.detect", 150, 950, True),
                  event("Memcpy HtoD (Pinned -> Device)", 40, 450, True),
                  event("iir_ends_kernel", 500, 600, True),
                  event("gate_speculate", 700, 950, True)]
# the port's ranges as the profiler gives them on the card: host events
# only (function scope, no device-side copy)
PORT_EVENTS = [event("rspt.detect_batch", 120, 880, False),
               event("rspt.iir_warmup_state", 130, 480, False),
               event("rspt.sync.companion_copy", 140, 460, False),
               event("rspt.iir_apply", 480, 650, False),
               event("rspt.peak_gate", 660, 870, False)]


def fake_capture(monkeypatch, events):
    class FakeProfile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    return trace._capture(lambda: time.sleep(0.002), 0.001, lambda: None,
                          lambda: {"jobs": 1, "rows": 96, "T": 650000,
                                   "detect_ms": 8.0})


def test_port_ranges_leave_the_harness_trace_as_it_was(root, monkeypatch):
    """The port's host ranges are no device operations and no harness
    spans: the old readers, the breakdown and the busy time read as
    without them."""
    old = fake_capture(monkeypatch, HARNESS_EVENTS)
    new = fake_capture(monkeypatch, HARNESS_EVENTS + PORT_EVENTS)
    assert (new.ops, new.spans) == (old.ops, old.spans)
    assert new.busy() == old.busy() and new.top_ops() == old.top_ops()
    assert new.idle_gaps() == old.idle_gaps()
    cell = manifest.resolve(root, "mitdb.qrs")
    for name in OLD:
        a = read(name, harness.RunView(cell, old))
        assert a is not None and read(name, harness.RunView(cell, new)) == a


def test_detect_idle_ms_on_a_trace_made_by_hand(root, monkeypatch):
    """The card's idle time inside the harness's detect spans, a job: two
    jobs, idle 3 + 4 ms inside them, and idle time outside them left out;
    on the captured trace, the same with the port's ranges or without."""
    tr = trace.Trace(
        ops=[("Memcpy HtoD", 0.000, 0.004), ("iir_ends_kernel", 0.006, 0.009),
             ("gate_speculate", 0.009, 0.010),
             ("Memcpy HtoD", 0.012, 0.016), ("iir_ends_kernel", 0.019, 0.020)],
        spans=[("upload", 0.000, 0.001), ("detect", 0.001, 0.011),
               ("markers", 0.011, 0.0115),
               ("upload", 0.0115, 0.012), ("detect", 0.012, 0.021)],
        start=0.0, end=0.025, steps=2)
    cell = manifest.resolve(root, "mitdb.qrs")
    run = harness.RunView(cell, tr)
    assert read("detect_idle_ms.qrs", run) == pytest.approx(3.5, rel=1e-9)
    # busy 0.040-0.450 ms, 0.5-0.6, 0.7-0.95; detect 0.1-0.9 ms, one job
    for events in (HARNESS_EVENTS, HARNESS_EVENTS + PORT_EVENTS):
        run = harness.RunView(cell, fake_capture(monkeypatch, events))
        assert run.steps == 1
        assert read("detect_idle_ms.qrs", run) == pytest.approx(0.15)
    empty = trace.Trace([], tr.spans, 0.0, 0.025, 2)
    assert read("detect_idle_ms.qrs", harness.RunView(cell, empty)) is None


def small(root):
    c = manifest.resolve(root, "mitdb.qrs")
    c.config = dict(c.config, records=1, samples=1000)
    c.mix = dict(c.mix, warm_jobs=1, trace_seconds=0.05)
    return c


def traced_run(root, monkeypatch):
    """A traced run at a small size on the CPU: one window, the card's
    synchronise a no-op (the CPU's profiler records no device operation,
    so every attempt would be made)."""
    monkeypatch.setattr(trace, "ATTEMPTS", 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    args = argparse.Namespace(seed=2 ** 31 + 5, seconds=0.5, trace=1)
    return harness.measure(small(root), args, torch.device("cpu"),
                           {"platform": "cpu"})


def test_traced_cpu_run_reports_every_new_metric(root, monkeypatch):
    r = traced_run(root, monkeypatch)
    assert r["correct"] is True
    for name in NEW:
        assert name in r["metrics"], name
    m = r["metrics"]
    assert m["host_syncs.qrs"]["value"] == 0       # the CPU waits for no card
    assert m["host_wait_ms.qrs"]["value"] == 0
    assert m["gate_reruns.qrs"]["value"] == 0      # the serial plain gate
    assert m["detect_dispatch_ms.qrs"]["value"] > 0
    # the CPU's profiler records no device operation: no device metric
    assert "detect_idle_ms.qrs" not in m and "device_idle_pct.qrs" not in m
    assert all(n in r["breakdown"] for n in ("device_ops", "idle_gaps"))


def test_traced_run_without_the_ports_tracing(root, monkeypatch):
    """As on a port with no tracing module: every new reader None, the
    run complete."""
    hide_tracing(monkeypatch)
    r = traced_run(root, monkeypatch)
    assert r["correct"] is True
    assert not set(NEW) & set(r["metrics"])
