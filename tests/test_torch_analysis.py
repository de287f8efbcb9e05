"""The port's analysis (rspt_tpu_torch.analysis: the host peak detectors
and rolling median, the batch detectors on S1, S2 and S4's plain
versions, the rolling medians in torch ops) against rspt_tpu's, on the
CPU. The same numpy inputs go through both packages; the criteria are
tests/test_jax_analysis.py's and tests/test_analysis.py's own (peak
counts equal and positions within ±3 samples of the float64 host
detector; offline indexes equal; medians equal as float32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from rspt_tpu.analysis import jax_peaks  # noqa: E402
from rspt_tpu.analysis import peaks as ref_peaks  # noqa: E402
from rspt_tpu.analysis.rolling_median import (  # noqa: E402
    jax_rolling_median, jax_rolling_median_large)
from rspt_tpu.analysis.rolling_median import \
    rolling_median as ref_rolling_median  # noqa: E402
from rspt_tpu_torch.analysis import peaks, torch_peaks  # noqa: E402
from rspt_tpu_torch.analysis.rolling_median import (  # noqa: E402
    rolling_median, torch_rolling_median, torch_rolling_median_large)
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import (GATE_EDGE_CASES, check_gate_case,  # noqa: E402
                             check_gate_expectations)

CPU = "cpu"


def make_ecg(sr=360, seconds=20, channels=3):
    """tests/test_jax_analysis.py's signal: ~66 beats a minute."""
    t = np.arange(sr * seconds) / sr
    rng = np.random.RandomState(3)
    beats = np.sin(2 * np.pi * 1.1 * t[None, :]
                   + 0.3 * np.arange(channels)[:, None]) ** 63 * 900
    return beats + 15 * rng.normal(size=(channels, t.size)) + 50


def offline_ecg(rng, n=6000, sr=1000.0):
    """tests/test_jax_analysis.py's offline signal (one row)."""
    t = np.arange(n) / sr
    return (1200.0 * np.exp(-((t % 0.8) - 0.35) ** 2 / 0.0002)
            + 150 * np.sin(2 * np.pi * 0.4 * t) + rng.normal(0, 12.0, n))


@pytest.mark.parametrize("cls", ["PeakDetector", "PeakDetector1stOrder"])
def test_host_detectors_equal_rspt_tpu(cls):
    """The streaming host detectors' (marker, sig, threshold) equal
    rspt_tpu's bit for bit, with marker −1 (the signal value)."""
    sig = make_ecg(sr=500, seconds=4, channels=1)[0]
    ours = getattr(peaks, cls)(500.0, marker_val=-1.0)
    theirs = getattr(ref_peaks, cls)(500.0, marker_val=-1.0)
    for v in sig:
        assert ours.detect(float(v)) == theirs.detect(float(v))


def test_offline_host_detector_equals_rspt_tpu(rng):
    """PeakDetectorOffline.detect_fw and detect(return_indexes=True) equal
    rspt_tpu's bit for bit."""
    ecg = offline_ecg(rng, 4000)
    for fn in ("detect_fw", "detect"):
        got = getattr(peaks.PeakDetectorOffline(1000.0), fn)(ecg)
        want = getattr(ref_peaks.PeakDetectorOffline(1000.0), fn)(ecg)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    got = peaks.PeakDetectorOffline(1000.0).detect(ecg, return_indexes=True)
    want = ref_peaks.PeakDetectorOffline(1000.0).detect(ecg,
                                                        return_indexes=True)
    assert got[3].dtype == np.uint32 and np.array_equal(got[3], want[3])


@pytest.mark.parametrize("order2", [True, False])
def test_detect_batch_matches_host_and_jax(order2):
    """Batched detect_batch: per channel the host detector's peak count,
    positions within ±3 samples; sig and threshold within 1% of the
    float64 host chain's largest value (the float32 tiles drift up to
    0.7% of it on the 0.15 Hz threshold: measured on this signal). JAX's
    float32 associative scan drifts farther from the host (up to 6% of sig
    and 48% of the threshold, measured likewise): the port's lies within
    JAX's own distance from the host, plus 1%, of JAX's."""
    sig = make_ecg()
    pk, s, th = torch_peaks.detect_batch(sig, 360.0, order2=order2,
                                         device=CPU)
    assert pk.shape == s.shape == th.shape == sig.shape
    pj, sj, tj = jax_peaks.detect_batch(sig, 360.0, order2=order2)
    cls = peaks.PeakDetector if order2 else peaks.PeakDetector1stOrder
    for ch in range(sig.shape[0]):
        pd = cls(360.0)
        host = np.array([pd.detect(float(v)) for v in sig[ch]])
        got = np.flatnonzero(pk[ch].numpy())
        want = np.flatnonzero(host[:, 0])
        assert len(got) == len(want) > 10
        assert np.all(np.abs(got - want) <= 3)
        assert len(np.flatnonzero(np.asarray(pj)[ch])) == len(got)
        for port, jx, h in ((s, sj, host[:, 1]), (th, tj, host[:, 2])):
            scale = np.abs(h).max()
            jx = np.asarray(jx)[ch]
            assert np.abs(port[ch].numpy() - h).max() <= 1e-2 * scale
            assert np.abs(port[ch].numpy() - jx).max() <= \
                np.abs(jx - h).max() + 1e-2 * scale


def test_detect_offline_batch_matches_jax_and_host(rng):
    """detect_offline_batch's indexes equal JAX's and the host
    PeakDetectorOffline's (test_jax_analysis.py's signal and batch)."""
    ecg = offline_ecg(rng)
    batch = np.stack([ecg, ecg * 1.3])
    pk, filt, thr, idxs = torch_peaks.detect_offline_batch(
        batch, 1000.0, return_indexes=True, device=CPU)
    _, fj, tj, jidx = jax_peaks.detect_offline_batch(batch, 1000.0,
                                                     return_indexes=True)
    assert pk.shape == batch.shape and filt.shape == thr.shape == pk.shape
    for row, got, gj in zip(batch, idxs, jidx):
        want = peaks.PeakDetectorOffline(1000.0).detect(
            row, return_indexes=True)[3]
        assert got.dtype == np.uint32 and len(got) > 5
        assert np.array_equal(got, want) and np.array_equal(got, gj)


def test_relocation_revisits_a_marker_moved_forward():
    """A marker moved to a later index inside the range is visited again
    there, as the full loop over every index does: the port's relocation
    over marker positions equals that loop."""
    radius, T = 10, 120
    ecg = np.zeros(T)
    ecg[46] = 5.0        # the extremum seen from 40: 40 -> 46
    ecg[55] = 9.0        # from 46 the window reaches 55: 46 -> 55
    ecg[20] = -3.0       # a marker at 25 moves back to 20
    base = np.zeros(T)
    pk = np.zeros(T, np.float32)
    pk[[25, 40]] = 1.0

    def full_loop(p):
        for i in range(radius, T - radius):
            if p[i]:
                seg = ecg[i - radius:i + radius] - base[i - radius:i + radius]
                mx, mn = int(np.argmax(seg)), int(np.argmin(seg))
                val = p[i]
                p[i] = 0
                p[i - radius + (mx if seg[mx] > -seg[mn] else mn)] = val

    want = pk.copy()
    full_loop(want)
    torch_peaks.relocate(pk, ecg, base, radius)
    assert np.array_equal(pk, want)
    assert list(np.flatnonzero(want)) == [20, 55]


def _gate_loop(sig, thr, nr_slope, atten, marker):
    """_PeakStateMachine.step's logic in float32, a sample at a time."""
    f = np.float32
    out = np.zeros(sig.shape, f)
    for r in range(sig.shape[0]):
        amp, prev, searching, count = f(0), f(0), False, 0
        for t in range(sig.shape[1]):
            s = f(sig[r, t])
            if searching and s > f(thr[r, t]) * f(1.5) and prev > s:
                if amp == 0 or prev > amp * f(0.5):
                    amp, count, searching = prev, 1, False
                else:
                    amp = amp * f(atten)
            elif prev < s:
                searching, count = True, 0
            prev = s
            if count:
                count += 1
            if count == nr_slope:
                count = 0
                out[r, t] = s if f(marker) == -1 else f(marker)
    return out


@pytest.mark.parametrize("marker", [1.0, -1.0])
def test_peak_gate_plain_equals_state_machine_loop(rng, marker):
    """S4's plain version against a float32 loop of the state machine,
    with a NaN and an all-zero row."""
    t = np.arange(3000)
    sig = np.stack([np.sin(t / 37.0) ** 8 * 900,
                    np.sin(t / 23.0 + 1.0) ** 8 * (300 + t / 10.0),
                    np.zeros(3000)]).astype(np.float32)
    sig[:2] += rng.normal(0, 0.01, (2, 3000)).astype(np.float32)
    sig[1, 1500] = np.nan
    thr = np.full_like(sig, 40.0)
    got = ck.peak_gate(torch.from_numpy(sig), torch.from_numpy(thr), 36,
                       1.0 / (1.0 + 70.0 / 360.0), marker)
    want = _gate_loop(sig, thr, 36, np.float32(1.0 / (1.0 + 70.0 / 360.0)),
                      marker)
    assert np.array_equal(got.numpy(), want, equal_nan=True)
    assert (want[:2] != 0).sum() > 20


@pytest.mark.parametrize("case", GATE_EDGE_CASES)
def test_peak_gate_edge_cases_on_cpu(case):
    """tests/test_torch_cuda.py's GATE_EDGE_CASES on the CPU: the wrapper
    (its plain version here) against the plain version, and the model of
    peaks.cu's chunk-parallel schedule (speculation from guessed states,
    the repair walk; gate_schedule_model) against it bit for bit at each
    case's (chunk, warmup), forced re-runs and never-merging rows
    included."""
    check_gate_expectations(case, *check_gate_case(torch.device(CPU),
                                                   *case))


def test_peak_gate_schedule_arguments_checked():
    """peak_gate's schedule: chunk >= 1 and warmup >= 0, else ValueError
    on every device; valid ones leave the plain result unchanged here."""
    sig = torch.zeros((2, 50))
    thr = torch.ones((2, 50))
    for kw in ({"chunk": 0}, {"warmup": -1}):
        with pytest.raises(ValueError, match="chunk"):
            ck.peak_gate(sig, thr, 36, 0.8, 1.0, **kw)
    assert torch.equal(ck.peak_gate(sig, thr, 36, 0.8, 1.0, chunk=7,
                                    warmup=0), torch.zeros((2, 50)))


def _median_inputs(rng):
    fixed = np.array([9, 1, 8, 2, 7, 3, 6, 4, 5, 5, 4, 6, 3, 7, 2, 8, 1, 9,
                      0, 10], np.float64)
    return {"normal": np.concatenate([fixed, rng.normal(0, 100, 2000)]),
            "ties": rng.integers(0, 6, 1500).astype(np.float64)}


@pytest.mark.parametrize("w", [1, 2, 5, 6, 7, 40])
def test_rolling_median_equals_host_and_jax(rng, w):
    """torch_rolling_median equals RollingWindowMedian as float32 and
    jax_rolling_median, odd and even windows, warm-up and heavy ties; the
    host copies equal rspt_tpu's."""
    for name, vals in _median_inputs(rng).items():
        v32 = vals.astype(np.float32).astype(np.float64)
        host = rolling_median(v32, w)
        assert np.array_equal(host, ref_rolling_median(v32, w))
        got = torch_rolling_median(vals, w, device=CPU)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), host.astype(np.float32)), name
        assert np.array_equal(
            got.numpy(), np.asarray(jax_rolling_median(vals, w)))


@pytest.mark.parametrize("w", [41, 100, 101])
def test_rolling_median_large_equals_host_and_jax(rng, w):
    """torch_rolling_median_large (stride 16: the anchor path) equals
    RollingWindowMedian as float32 on normal values and on heavy ties, and
    jax_rolling_median_large on both at once (at the even and odd window;
    each JAX call compiles for ~9 s)."""
    inputs = _median_inputs(rng)
    for name, vals in inputs.items():
        v32 = vals.astype(np.float32).astype(np.float64)
        want = rolling_median(v32, w).astype(np.float32)
        got = torch_rolling_median_large(vals, w, stride=16, device=CPU)
        assert np.array_equal(got.numpy(), want), name
    if w != 41:
        vals = np.concatenate([inputs["ties"], inputs["normal"]])
        got = torch_rolling_median_large(vals, w, stride=16, device=CPU)
        assert np.array_equal(got.numpy(), np.asarray(
            jax_rolling_median_large(vals, w, stride=16)))
