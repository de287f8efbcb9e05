"""The frozen QRS reference against hand-made cases and its own serial
definition."""

import numpy as np
import pytest
import torch

from benchmark.reference import qrs


def test_designs_against_closed_forms():
    # 2nd-order low-pass: b = K^2 [1, 2, 1] / a0, a = [1, 2(K^2-1), 1-sqrt2 K+K^2] / a0
    K = np.tan(np.pi * 3.0 / 360.0)
    a0 = 1 + np.sqrt(2) * K + K * K
    b, a = qrs.lowpass2(360.0, 3.0)
    np.testing.assert_allclose(b, np.array([1, 2, 1]) * K * K / a0, rtol=1e-12)
    np.testing.assert_allclose(
        a, [1, 2 * (K * K - 1) / a0, (1 - np.sqrt(2) * K + K * K) / a0],
        rtol=1e-12)
    b, a = qrs.bandpass2(360.0, 10.0, 20.0)
    assert len(a) == 5 and a[0] == 1.0
    np.testing.assert_allclose(b[[1, 3]], 0, atol=1e-15)
    np.testing.assert_allclose(b[2], -2 * b[0], rtol=1e-12)
    # unity gain at the geometric centre, none at DC and Nyquist
    w = 2 * np.pi * np.sqrt(10.0 * 20.0) / 360.0
    z = np.exp(1j * w)
    h = np.polyval(b, z) / np.polyval(a, z)
    assert abs(abs(h) - 1) < 0.05
    assert abs(np.polyval(b, 1.0)) < 1e-12 and abs(np.polyval(b, -1.0)) < 1e-12


@pytest.mark.parametrize("T", [1, 255, 256, 700])
def test_block_recurrence_is_the_serial_one(T):
    g = torch.Generator().manual_seed(T)
    x = torch.randn(3, T, generator=g, dtype=torch.float64)
    b, a = qrs.bandpass2(360.0, 10.0, 20.0)
    xh = torch.randn(3, 4, generator=g, dtype=torch.float64)
    yh = torch.randn(3, 4, generator=g, dtype=torch.float64)
    want = qrs.serial(torch.cat([xh, x], 1), yh, b, a)
    # the block map sums in another order: float64 rounding, relative to
    # the output's scale
    err = (qrs.iir(x, b, a, xh, yh) - want).abs().max()
    assert err <= 1e-10 * want.abs().max()


def test_warmup_is_a_constant_input():
    b, a = qrs.lowpass2(360.0, 3.0)
    x0 = torch.tensor([5.0, -2.0], dtype=torch.float64)
    xh, yh = qrs.warmup(x0, b, a, 4 * 360)
    # unity DC gain: after 4 s the low-pass sits on its input
    torch.testing.assert_close(yh, x0[:, None].expand(2, 2), rtol=1e-9,
                               atol=0)
    torch.testing.assert_close(xh, x0[:, None].expand(2, 2))


def beats(T, at, sr=360.0):
    """A train of sharp positive pulses (12 ms Gaussians) at ``at``."""
    t = np.arange(T)[None, :]
    x = sum(np.exp(-0.5 * ((t - p) / (0.012 * sr)) ** 2) for p in at)
    return torch.tensor(1024 + 200 * x, dtype=torch.float32)


def test_detector_marks_each_beat_once():
    at = [900 + 300 * k for k in range(8)]
    marks = qrs.detect(beats(4000, at), 360.0)[0]
    # before the first beat the integrator and threshold filters settle
    # from zero (markers on the start-up wiggles); after it, one marker a
    # beat: the gate fires nr_slope - 2 = 34 samples after the integrated
    # peak, which trails the pulse by the filters' delay
    marks = marks[marks >= at[0]]
    assert marks.size == len(at)
    lag = marks - np.asarray(at)
    assert np.all((lag > 34) & (lag < 34 + 60)) and np.ptp(lag) <= 2


@pytest.mark.parametrize("seed", range(6))
def test_event_gate_is_the_serial_gate(seed):
    rng = np.random.default_rng(seed)
    T = 5000
    sig = np.abs(np.convolve(rng.standard_normal(T), np.ones(9), "same"))
    if seed % 2:
        sig = np.round(sig, 1)          # plateaus: neither rising nor falling
    thr = np.convolve(sig, np.ones(200) / 300, "same")
    for nr_slope in (1, 2, 3, 36):
        np.testing.assert_array_equal(
            qrs.gate(sig, thr, nr_slope, 0.93),
            qrs.gate_serial(sig, thr, nr_slope, 0.93))


def test_unmatched_counts():
    w = [np.array([10, 50, 90])]
    assert qrs.unmatched([np.array([10, 50, 90])], w, 0) == (0, 3)
    assert qrs.unmatched([np.array([11, 50, 90])], w, 0) == (2, 3)
    assert qrs.unmatched([np.array([12, 50, 90])], w, 2) == (0, 3)
    assert qrs.unmatched([np.array([13, 50])], w, 2) == (3, 3)
    assert qrs.unmatched([np.array([], np.int64)], w, 2) == (3, 3)


def test_inexact_counts():
    w = [np.array([10, 50, 90])]
    assert qrs.inexact([np.array([10, 50, 90])], w, 1) == (0, 3)
    assert qrs.inexact([np.array([11, 50, 89])], w, 1) == (2, 3)
    assert qrs.inexact([np.array([12, 50, 90])], w, 1) == (0, 2)
    assert qrs.inexact([np.array([9, 10, 50, 91])], w, 1) == (1, 3)
    assert qrs.inexact([np.array([], np.int64)], w, 1) == (0, 0)
