"""The port's spans and counters (rspt_tpu_torch/utils/tracing.py) on the
QRS path: what a profiler sees of detect_batch, that nothing is recorded
while no profiler runs, and that tracing leaves the outputs as they are.
The card's own points (the companion copy, S4's re-run chunks) are
checked by the test marked ``cuda``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rspt_tpu_torch.analysis.torch_peaks import detect_batch  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.utils import tracing  # noqa: E402

STAGES = ["detect_batch", "iir_warmup_state", "iir_apply", "iir_apply",
          "iir_apply", "peak_gate"]


@pytest.fixture(autouse=True)
def clean_counts():
    tracing.reset()
    yield
    tracing.reset()


def records(rows=3, T=600, seed=5):
    """ADC-scale rows with sharp beats, as detect_batch's callers pass."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    beats = sum(np.exp(-0.5 * ((t - p) / 4.0) ** 2)
                for p in range(200, T, 290))
    x = 1024 + 200 * beats + 3 * rng.standard_normal((rows, T))
    return torch.tensor(x, dtype=torch.float32)


def port_events(prof):
    """The profiler's host events of the port's ranges, by start."""
    return sorted((e for e in prof.events()
                   if e.name.startswith(tracing.PREFIX)),
                  key=lambda e: e.time_range.start)


def traced(fn):
    """fn() under a CPU profiler: (its result, the rspt.* ranges as (name,
    start, end) in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name[len(tracing.PREFIX):], e.time_range.start,
              e.time_range.end) for e in port_events(prof)]
    return out, spans


@pytest.fixture(scope="module")
def job():
    """One detect_batch on the CPU untraced, then one traced: the input,
    both outputs, the profiler's events and the counts of the traced
    call."""
    x = records()
    plain = detect_batch(x, 360.0, device="cpu")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = detect_batch(x, 360.0, device="cpu")
    counts = tracing.snapshot()
    tracing.reset()
    return dict(x=x, plain=plain, out=out, events=port_events(prof),
                counts=counts)


def test_detect_batch_spans_nest_under_it(job):
    events = job["events"]
    assert [e.name for e in events] == [tracing.PREFIX + n for n in STAGES]
    top = events[0]
    # the profiler's own nesting: every stage a child of detect_batch
    assert {c.name for c in top.cpu_children if c.name.startswith(
        tracing.PREFIX)} == {tracing.PREFIX + n for n in STAGES[1:]}
    for e in events[1:]:
        assert e.cpu_parent is top, e.name
    # the stages follow one another: none inside another
    for a, b in zip(events[1:], events[2:]):
        assert a.time_range.end <= b.time_range.start


def test_spans_are_no_user_annotations(job):
    """Function-scope ranges: the profiler copies no device-side range of
    them among a card's operations."""
    assert not [e.name for e in job["events"] if e.is_user_annotation]


def test_spans_count_their_calls_and_host_time(job):
    counts = job["counts"]
    want = {"detect_batch": 1, "iir_warmup_state": 1, "iir_apply": 3,
            "peak_gate": 1}
    assert {k[len("calls."):]: v for k, v in counts.items()
            if k.startswith("calls.")} == want
    ns = {k[len("ns."):]: v for k, v in counts.items() if k.startswith("ns.")}
    assert set(ns) == set(want) and all(v > 0 for v in ns.values())
    # the stages' host time lies inside detect_batch's
    assert sum(v for k, v in ns.items() if k != "detect_batch") \
        <= ns["detect_batch"]


def test_cpu_has_no_sync_points(job):
    """The CPU waits for no card: no sync span, no host_syncs; the plain
    gate re-runs nothing."""
    assert not [e.name for e in job["events"]
                if e.name.startswith(tracing.PREFIX + "sync.")]
    assert "host_syncs" not in job["counts"]
    assert job["counts"]["gate_reruns"] == 0


def test_nothing_recorded_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(tracing, "_Range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.enabled()
    assert tracing.span("detect_batch") is tracing.span("peak_gate")
    with tracing.span("detect_batch"):
        pass
    with tracing.sync("site", torch.device("cuda")):
        pass
    detect_batch(records(), 360.0, device="cpu")
    tracing.count("host_syncs")
    tracing.count("gate_reruns", torch.ones(4, dtype=torch.int64))
    assert tracing.snapshot() == {}


def test_reset_and_snapshot_round_trip():
    def work():
        tracing.count("a")
        tracing.count("a", 4)
        tracing.count("t", torch.tensor([1, 2, 3]))  # summed
        tracing.count("t", torch.tensor([10, 0, 0]))
        tracing.count("t", torch.tensor([100, 0]))
        tracing.count("t", 1000)                     # a host number beside
        return tracing.snapshot()

    inside, _ = traced(work)
    assert inside == {"a": 5, "t": 1116}
    assert tracing.snapshot() == inside
    tracing.reset()
    assert tracing.snapshot() == {}


def test_outputs_bit_identical_traced_or_not(job):
    for a, b in zip(job["plain"], job["out"]):
        assert torch.equal(a, b)


def test_host_input_bit_identical_traced_or_not(job):
    """A numpy input takes detect_batch's copy from host memory."""
    arg = job["x"].numpy()
    out, spans = traced(lambda: detect_batch(arg, 360.0, device="cpu"))
    assert [n for n, _, _ in spans] == STAGES
    for a, b in zip(job["plain"], out):
        assert torch.equal(a, b)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_sync_point_and_gate_reruns(dev):
    """On the card: the companion copy is the one point a job where the
    host waits (the tables cached by a first call); no range of the port
    is among the device's events; gate_reruns is the chunk column of
    peak_gate.last_reruns summed on the card; the outputs equal an
    untraced call's."""
    x = records(rows=8, T=20000, seed=3).to(dev)
    plain = detect_batch(x, 360.0, device=dev)          # fills the caches
    want = ck.peak_gate.last_reruns[:, 0].sum().item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = detect_batch(x, 360.0, device=dev)
        torch.cuda.synchronize(dev)
    cuda = torch.autograd.DeviceType.CUDA
    ours = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert not [e.name for e in ours if e.device_type == cuda]
    names = [e.name for e in ours]
    assert names.count("rspt.sync.companion_copy") == 1
    assert [n for n in names if n.startswith("rspt.sync.")] == \
        ["rspt.sync.companion_copy"]
    counts = tracing.snapshot()
    assert counts["host_syncs"] == 1 and counts["gate_reruns"] == want
    assert counts["calls.sync.companion_copy"] == 1
    assert 0 < counts["ns.sync.companion_copy"] < counts["ns.detect_batch"]
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    # forced re-runs are counted on the card as the kernel reports them
    tracing.reset()
    sig, thr = out[1].contiguous(), out[2].contiguous()
    with profile(activities=[ProfilerActivity.CPU]):
        ck.peak_gate(sig, thr, 36, 0.93, 1.0, chunk=64, warmup=0)
        tracing.count("gate_reruns", ck.peak_gate.last_reruns[:, 0])
    forced = ck.peak_gate.last_reruns[:, 0].sum().item()
    assert forced > 0 and tracing.snapshot() == {"gate_reruns": forced}
