"""Adaptive peak detection, host reference semantics — the port's copy of
rspt_tpu/analysis/peaks.py:29-197, built on the port's IirFilter.

Pan-Tompkins-style chain of lib_rspt/peak_detector.h: band-pass →
square → low-pass integrator → low-pass adaptive threshold → amplitude-
gated state machine that emits a marker nr_slope_samples (100 ms) after
the peak maximum.

* PeakDetector          — 4th-order 10–20 Hz band-pass (peak_detector.h:33-124)
* PeakDetector1stOrder  — 1st-order filters (:126-217)
* PeakDetectorOffline   — forward(+backward) zero-phase filtering,
  baseline removal and peak relocation to the signal extremum within
  ±10 ms (:219-405)

The filter structs the reference embeds (iir_filter_opt.h) accumulate in
the filter_opt order, so these use IirFilter.filter_opt; ``process``
runs the port's host runtime. These are the oracles of the batch
detectors in analysis/torch_peaks.py.
"""

from __future__ import annotations

import numpy as np

from ..filters.design import FilterKind, FilterType, create_filter_iir
from ..filters.streaming import IirFilter


def _make_filter(ftype, order, sr, lo, hi=0.0) -> IirFilter:
    b, a = create_filter_iir(FilterKind.BUTTERWORTH, ftype, order, sr, lo, hi)
    return IirFilter(n=a, d=b)


class _PeakStateMachine:
    """The shared gating logic (peak_detector.h:95-122)."""

    def __init__(self, sampling_rate: float, marker_val: float,
                 attenuation: float):
        self.previous_peak_amplitude = 0.0
        self.previous_sig_val = 0.0
        self.searching_for_peaks = False
        self.samples_after_peak_count = 0
        self.marker_val = float(marker_val)
        self.previous_peak_reference_ratio = 0.5
        self.peak_attenuation = 1.0 / (1.0 + attenuation / sampling_rate)
        self.threshold_ratio = 1.5
        self.nr_slope_samples = int((100.0 * sampling_rate) / 1000.0)

    def step(self, sig_val: float, threshold: float) -> float:
        if self.searching_for_peaks \
                and sig_val > threshold * self.threshold_ratio \
                and self.previous_sig_val > sig_val:
            if (self.previous_peak_amplitude == 0) or (
                    self.previous_sig_val > self.previous_peak_amplitude
                    * self.previous_peak_reference_ratio):
                self.previous_peak_amplitude = self.previous_sig_val
                self.samples_after_peak_count = 1
                self.searching_for_peaks = False
            else:
                self.previous_peak_amplitude *= self.peak_attenuation
        elif self.previous_sig_val < sig_val:
            self.searching_for_peaks = True
            self.samples_after_peak_count = 0

        self.previous_sig_val = sig_val

        if self.samples_after_peak_count:
            self.samples_after_peak_count += 1
        if self.samples_after_peak_count == self.nr_slope_samples:
            self.samples_after_peak_count = 0
            return sig_val if self.marker_val == -1.0 else self.marker_val
        return 0.0


class PeakDetector:
    """Streaming detector, 2nd-order-prototype filters
    (peak_detector.h:33-124): bandpass 10–20 Hz (4th-order digital),
    integrator LP 3 Hz, threshold LP 0.15 Hz."""

    BANDPASS_ORDER = 2
    INTEGRATOR_ORDER = 2
    BAND = (10.0, 20.0)
    ATTENUATION = 25.0

    def __init__(self, sampling_rate: float, marker_val: float = 1.0):
        sr = float(sampling_rate)
        self.sampling_rate = sr
        self.bandpass = _make_filter(FilterType.BAND_PASS,
                                     self.BANDPASS_ORDER, sr, *self.BAND)
        self.integrator = _make_filter(FilterType.LOW_PASS,
                                       self.INTEGRATOR_ORDER, sr, 3.0)
        self.threshold = _make_filter(FilterType.LOW_PASS, 2, sr, 0.15)
        self.sm = _PeakStateMachine(sr, marker_val, self.ATTENUATION)
        self.sample_indx = 0

    def detect(self, new_sample: float):
        """Returns (marker, sig_val, threshold) — the reference's out
        params exposed as a tuple (peak_detector.h:84-93)."""
        if self.sample_indx == 0:
            self.bandpass.init_history_values(
                new_sample, int(self.sampling_rate), opt=True)
        self.sample_indx += 1
        v = self.bandpass.filter_opt(float(new_sample))
        sig_val = self.integrator.filter_opt(v * v)
        threshold = self.threshold.filter_opt(sig_val)
        return self.sm.step(sig_val, threshold), sig_val, threshold


class PeakDetector1stOrder(PeakDetector):
    """1st-order variant (peak_detector.h:126-217): 2nd-order digital
    bandpass, 1st-order integrator; same thresholds."""
    BANDPASS_ORDER = 1
    INTEGRATOR_ORDER = 1


class PeakDetectorOffline:
    """Offline detector (peak_detector.h:219-405): zero-phase
    forward+backward filtering, 0.5 Hz baseline estimate, marker moved
    back nr_slope_samples−1 then relocated to the dominant signal
    extremum (vs baseline) within ±10 ms."""

    def __init__(self, sampling_rate: float, marker_val: float = 1.0):
        sr = float(sampling_rate)
        self.sr = sr
        self.marker_val = float(marker_val)
        self.bandpass = _make_filter(FilterType.BAND_PASS, 1, sr, 15.0, 25.0)
        self.integrator = _make_filter(FilterType.LOW_PASS, 1, sr, 3.0)
        self.baseline = _make_filter(FilterType.LOW_PASS, 1, sr, 0.5)
        self.threshold = _make_filter(FilterType.LOW_PASS, 2, sr, 0.15)
        self.sm = _PeakStateMachine(sr, marker_val, 70.0)

    def detect_fw(self, ecg: np.ndarray):
        """Forward-only pass (peak_detector.h:267-305).
        Returns (peak_signal, filt_signal, threshold_signal)."""
        ecg = np.asarray(ecg, np.float64)
        self.bandpass.init_history_values(ecg[0], int(self.sr), opt=True)
        filt = self.bandpass.process(ecg, opt=True)
        filt = self.integrator.process(filt * filt, opt=True)
        thr = self.threshold.process(filt, opt=True)
        peaks = np.zeros_like(ecg)
        for i in range(ecg.size):
            peaks[i] = self.sm.step(filt[i], thr[i])
        return peaks, filt, thr

    def detect(self, ecg: np.ndarray, return_indexes: bool = False):
        """Zero-phase pass (peak_detector.h:307-403). Returns
        (peak_signal, filt_signal, threshold_signal[, peak_indexes]).

        Quirks replicated: the backward bandpass pass re-filters the
        *original* signal (not the forward result — :319-320), and the
        state machine runs with the same shared instance semantics.
        """
        ecg = np.asarray(ecg, np.float64)
        n = ecg.size
        self.bandpass.init_history_values(ecg[0], int(self.sr), opt=True)
        self.baseline.init_history_values(ecg[0], int(self.sr), opt=True)

        baseline = self.baseline.process(ecg, opt=True)
        baseline = self.baseline.process(baseline[::-1], opt=True)[::-1]
        filt = self.bandpass.process(ecg, opt=True)
        # reference :319-320 filters ecg again (not filt) backwards —
        # preserving the quirk for parity
        filt = self.bandpass.process(ecg[::-1], opt=True)[::-1]
        filt = self.integrator.process(filt * filt, opt=True)
        filt = self.integrator.process(filt[::-1], opt=True)[::-1]
        thr = self.threshold.process(filt, opt=True)
        thr = self.threshold.process(filt[::-1], opt=True)[::-1]

        peaks = np.zeros(n)
        for i in range(n):
            peaks[i] = self.sm.step(filt[i], thr[i])

        # move markers back to the peak position (:396-403 relocation 1)
        nss = self.sm.nr_slope_samples
        nr_peaks = 0
        for i in range(nss, n):
            if peaks[i]:
                peaks[i - nss + 1] = peaks[i]
                peaks[i] = 0
                nr_peaks += 1
        # relocate to dominant extremum vs baseline within ±10 ms (:370-395)
        radius = int((10.0 * self.sr) / 1000.0)
        for i in range(radius, n - radius):
            if peaks[i]:
                seg = ecg[i - radius:i + radius] - baseline[i - radius:i + radius]
                maxj = int(np.argmax(seg))
                minj = int(np.argmin(seg))
                val = peaks[i]
                peaks[i] = 0
                if seg[maxj] > -seg[minj]:
                    peaks[i - radius + maxj] = val
                else:
                    peaks[i - radius + minj] = val
        if return_indexes:
            idx = np.flatnonzero(peaks).astype(np.uint32)
            return peaks, filt, thr, idx
        return peaks, filt, thr
