"""Batched peak detection on the card — the port's counterpart of
rspt_tpu/analysis/jax_peaks.py.

The host detectors (analysis/peaks.py) are the bit-exact reference
copies; this module is the throughput path over many channels at once:
the filters as batched IIRs (filters/torch_filters.py: S2 ``iir_assoc``,
S1 ``iir_scan`` for the offline threshold), the amplitude-gated state
machine in S4 ``peak_gate`` (ops/cuda_kernels.py), serial in T and
parallel over the rows. float32 arithmetic: peak positions match the host
detector's on real-scale signals, values differ in low-order bits.

Chain (peak_detector.h:89-93): band-pass → square → low-pass integrator
→ low-pass threshold → gate (:95-122).

Entry points take ``device=None`` (the card, or they raise without one;
``device="cpu"`` runs the kernels' plain versions).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from ..device import resolve_device
from ..filters.design import FilterKind, FilterType, create_filter_iir
from ..filters.torch_filters import iir_apply, iir_warmup_state
from ..ops import cuda_kernels as ck
from ..utils import tracing


def _coeffs(sr: float, order2: bool = True):
    """The (b, a) of the band-pass, integrator and threshold filters
    (jax_peaks.py:24-31)."""
    bp = create_filter_iir(FilterKind.BUTTERWORTH, FilterType.BAND_PASS,
                           2 if order2 else 1, sr, 10.0, 20.0)
    integ = create_filter_iir(FilterKind.BUTTERWORTH, FilterType.LOW_PASS,
                              2 if order2 else 1, sr, 3.0)
    thr = create_filter_iir(FilterKind.BUTTERWORTH, FilterType.LOW_PASS,
                            2, sr, 0.15)
    return bp, integ, thr


def _signal(x, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    if x.device.type != "cpu":
        return x.to(dev, torch.float32)
    # a copy from host memory: the host waits for the stream
    with tracing.sync("input_copy", dev):
        return x.to(dev, torch.float32)


def _gate_scan(sig, thr, sampling_rate, marker_val, attenuation):
    """The amplitude-gated state machine (peak_detector.h:95-122) along
    the last axis, batched over the leading ones, in S4 (jax_peaks.py:
    88-126). Returns (peaks, nr_slope)."""
    sr = float(sampling_rate)
    nr_slope = int((100.0 * sr) / 1000.0)
    atten = np.float32(1.0 / (1.0 + attenuation / sr))
    T = sig.shape[-1]
    with tracing.span("peak_gate"):
        peaks = ck.peak_gate(sig.reshape(-1, T).contiguous(),
                             thr.reshape(-1, T).contiguous(), nr_slope,
                             float(atten), float(np.float32(marker_val)))
        if tracing.enabled():
            # the chunks S4 re-ran a row, summed on the card (the plain
            # version's serial walk re-runs none)
            reruns = ck.peak_gate.last_reruns
            tracing.count("gate_reruns",
                          0 if reruns is None else reruns[:, 0])
    return peaks.reshape(sig.shape), nr_slope


def detect_batch(x, sampling_rate: float, marker_val: float = 1.0,
                 order2: bool = True, device=None):
    """x: (..., T) → (peaks, sig, threshold), each (..., T) float32 on the
    device (jax_peaks.detect_batch, :34-85). The band-pass stage starts
    from the reference's first-sample warm-up (peak_detector.h:86-88), in
    closed form (iir_warmup_state)."""
    with tracing.span("detect_batch"):
        (bp_b, bp_a), (in_b, in_a), (th_b, th_a) = _coeffs(sampling_rate,
                                                            order2)
        sr = float(sampling_rate)
        dev = resolve_device(device)
        x = _signal(x, dev)
        zi = iir_warmup_state(x[..., 0], bp_a, bp_b, 4 * int(sr), device=dev)
        v, _ = iir_apply(x, bp_a, bp_b, zi=zi, mode="assoc", device=dev)
        sig, _ = iir_apply(v * v, in_a, in_b, mode="assoc", device=dev)
        thr, _ = iir_apply(sig, th_a, th_b, mode="assoc", device=dev)
        peaks, _ = _gate_scan(sig, thr, sr, marker_val, 25.0)
        return peaks, sig, thr


def _move_back(peaks: torch.Tensor, nr_slope: int) -> torch.Tensor:
    """Markers at i >= nr_slope move to i − nr_slope + 1, earlier ones stay
    (peak_detector.h:396-403), as jax_peaks.py:187-195 computes it."""
    T = peaks.shape[-1]
    tix = torch.arange(T, device=peaks.device)
    shifted = torch.cat([peaks[..., nr_slope - 1:],
                         peaks.new_zeros(peaks.shape[:-1] + (nr_slope - 1,))],
                        -1)
    shifted = torch.where(tix >= 1, shifted, 0.0)
    kept = torch.where(tix < nr_slope, peaks, 0.0)
    return torch.where(shifted > 0, shifted, kept)


def relocate(pk: np.ndarray, ecg: np.ndarray, base: np.ndarray,
             radius: int) -> None:
    """The ±radius extremum relocation of one row, in place
    (peak_detector.h:370-395; jax_peaks.py:197-209 visits every i in
    [radius, T − radius) in order). Only marker positions are visited: a
    marker moved to a later position inside that range is visited again
    there, as the full loop would."""
    T = pk.size
    todo = [int(i) for i in np.flatnonzero(pk[radius:T - radius]) + radius]
    heapq.heapify(todo)
    last = -1
    while todo:
        i = heapq.heappop(todo)
        if i == last or not pk[i]:
            continue
        last = i
        seg = ecg[i - radius:i + radius] - base[i - radius:i + radius]
        mx, mn = int(np.argmax(seg)), int(np.argmin(seg))
        val = pk[i]
        pk[i] = 0
        q = i - radius + (mx if seg[mx] > -seg[mn] else mn)
        pk[q] = val
        if i < q < T - radius:
            heapq.heappush(todo, q)


def offline_filters(x: torch.Tensor, sampling_rate: float,
                    marker_val: float = 1.0):
    """detect_offline_batch's device part on x ((..., T) float32 on the
    device): the forward and backward filter chains with the reference's
    quirks (the backward band-pass pass filters the ORIGINAL signal; every
    filter's state carries from its forward pass into its backward one;
    the threshold stage in mode="scan"), the gate and the marker
    move-back. Returns (moved peaks, filt, thr, baseline) on the device."""
    sr = float(sampling_rate)
    dev = x.device
    bp_b, bp_a = create_filter_iir(FilterKind.BUTTERWORTH,
                                   FilterType.BAND_PASS, 1, sr, 15.0, 25.0)
    in_b, in_a = create_filter_iir(FilterKind.BUTTERWORTH,
                                   FilterType.LOW_PASS, 1, sr, 3.0)
    bl_b, bl_a = create_filter_iir(FilterKind.BUTTERWORTH,
                                   FilterType.LOW_PASS, 1, sr, 0.5)
    th_b, th_a = create_filter_iir(FilterKind.BUTTERWORTH,
                                   FilterType.LOW_PASS, 2, sr, 0.15)

    def run(sig, b, a, zi, mode="assoc"):
        return iir_apply(sig, a, b, zi=zi, mode=mode, device=dev)

    def fwd_bwd(sig, b, a, zi, mode="assoc"):
        fwd, zf = run(sig, b, a, zi, mode)
        return run(fwd.flip(-1), b, a, zf, mode)[0].flip(-1)

    x0 = x[..., 0]
    zi_bp = iir_warmup_state(x0, bp_a, bp_b, 4 * int(sr), device=dev)
    zi_bl = iir_warmup_state(x0, bl_a, bl_b, 4 * int(sr), device=dev)
    baseline = fwd_bwd(x, bl_b, bl_a, zi_bl)
    # quirk (:319-320): the backward band-pass pass filters the ORIGINAL
    # signal; the forward pass only contributes its state
    _, zf_bp = run(x, bp_b, bp_a, zi_bp)
    filt = run(x.flip(-1), bp_b, bp_a, zf_bp)[0].flip(-1)
    filt = fwd_bwd(filt * filt, in_b, in_a, None)
    # threshold: the forward pass contributes state only, the backward
    # result (of filt reversed) is used; its poles sit ~1e-3 from the unit
    # circle, so it runs the serial recurrence (S1), as JAX's does
    _, zf_th = run(filt, th_b, th_a, None, "scan")
    thr = run(filt.flip(-1), th_b, th_a, zf_th, "scan")[0].flip(-1)
    peaks, nr_slope = _gate_scan(filt, thr, sr, marker_val, 70.0)
    return _move_back(peaks, nr_slope), filt, thr, baseline


def detect_offline_batch(x, sampling_rate: float, marker_val: float = 1.0,
                         return_indexes: bool = False, device=None):
    """Batched zero-phase offline detector (peak_detector.h:307-403;
    jax_peaks.detect_offline_batch, :129-217): offline_filters on the
    device, then the ±10 ms extremum relocation on the host (relocate).

    x: (..., T) → (peaks, filt, thr[, indexes per row]): peaks a float32
    numpy array (relocated on the host), filt and thr float32 tensors on
    the device, indexes uint32 numpy arrays."""
    sr = float(sampling_rate)
    x = _signal(x, resolve_device(device))
    lead, T = x.shape[:-1], x.shape[-1]
    moved, filt, thr, baseline = offline_filters(x, sr, marker_val)
    peaks_np = moved.cpu().numpy().reshape(-1, T)
    ecg_np = x.cpu().numpy().astype(np.float64).reshape(-1, T)
    base_np = baseline.cpu().numpy().astype(np.float64).reshape(-1, T)
    radius = int((10.0 * sr) / 1000.0)
    for b in range(peaks_np.shape[0]):
        relocate(peaks_np[b], ecg_np[b], base_np[b], radius)
    out_peaks = peaks_np.reshape(lead + (T,))
    if return_indexes:
        idx = [np.flatnonzero(row).astype(np.uint32) for row in peaks_np]
        return out_peaks, filt, thr, idx
    return out_peaks, filt, thr
