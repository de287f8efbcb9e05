"""Plain reference of the batch QRS detector (the chain of lib_rspt's
peak_detector.h:33-124: band-pass 10-20 Hz, square, 3 Hz integrator,
0.15 Hz threshold low-pass, amplitude-gated state machine).

It imports nothing of the program and takes nothing it made: the
Butterworth coefficients come from their analog prototypes through the
bilinear transform with prewarping (iir_filter_design.cpp's designs),
the recurrence is the direct form I, the band-pass starts from the
reference's warm-up (4 * sr steps of the first sample from a zero state,
iir_filter.cpp:109-113), and the gate is the state machine of
peak_detector.h:95-122. The truth is computed in float64; ``dtype``
computes the same chain in a lower precision (the control).

The recurrence runs in blocks of ``BLOCK`` samples: each block's outputs
are a linear map of its inputs, the last m inputs and the last m outputs
before it, and the two matrices of that map are the serial recurrence
run on unit vectors (``serial``). That is the recurrence, unrolled, so
the whole detector runs on a card in a few seconds.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

BLOCK = 256


def _bilinear(num: Sequence[float], den: Sequence[float], k: float):
    """Analog (num, den), highest power of s first, to digital (b, a)
    by s = k (z - 1) / (z + 1), normalised to a[0] = 1."""
    n = len(den) - 1
    num = [0.0] * (n + 1 - len(num)) + list(num)

    def sub(coeffs):
        out = np.zeros(n + 1)
        for i, c in enumerate(coeffs):
            p = n - i
            term = np.array([1.0])
            for _ in range(p):
                term = np.polymul(term, [1.0, -1.0])
            for _ in range(n - p):
                term = np.polymul(term, [1.0, 1.0])
            out += c * k ** p * term
        return out

    b, a = sub(num), sub(den)
    return b / a[0], a / a[0]


def lowpass2(sr: float, fc: float):
    """2nd-order Butterworth low-pass: W^2 / (s^2 + sqrt2 W s + W^2)."""
    k = 2.0 * sr
    w = k * math.tan(math.pi * fc / sr)
    return _bilinear([w * w], [1.0, math.sqrt(2.0) * w, w * w], k)


def bandpass2(sr: float, lo: float, hi: float):
    """The 2nd-order prototype band-pass, a 4th-order digital filter:
    Bw^2 s^2 over s^4 + sqrt2 Bw s^3 + (2 W0^2 + Bw^2) s^2
    + sqrt2 Bw W0^2 s + W0^4, with prewarped edges."""
    k = 2.0 * sr
    o1 = k * math.tan(math.pi * lo / sr)
    o2 = k * math.tan(math.pi * hi / sr)
    bw, w0s = o2 - o1, o1 * o2
    r2 = math.sqrt(2.0)
    return _bilinear([bw * bw, 0.0, 0.0],
                     [1.0, r2 * bw, 2.0 * w0s + bw * bw, r2 * bw * w0s,
                      w0s * w0s], k)


def serial(x_ext: torch.Tensor, y_hist: torch.Tensor, b, a) -> torch.Tensor:
    """The direct form I recurrence, one step a sample, batched over
    rows: x_ext (rows, m + n) holds m inputs of history (oldest first)
    then n new ones, y_hist (rows, m) the m outputs before them (oldest
    first). Returns the n outputs, in x_ext's type."""
    m = len(a) - 1
    n = x_ext.shape[1] - m
    ys = list(y_hist.unbind(1))
    for t in range(n):
        acc = x_ext[:, m + t] * float(b[0])
        for i in range(1, m + 1):
            acc = acc + x_ext[:, m + t - i] * float(b[i]) \
                - ys[-i] * float(a[i])
        ys.append(acc)
    return torch.stack(ys[m:], 1) if n else x_ext[:, :0]


def _maps(b, a, dtype, device):
    """The block map: y = x_ext @ hx + y_hist @ hy, from the serial
    recurrence on unit vectors in float64, then in ``dtype``."""
    m = len(a) - 1
    f64 = dict(dtype=torch.float64, device="cpu")
    hx = serial(torch.eye(BLOCK + m, **f64),
                torch.zeros(BLOCK + m, m, **f64), b, a)
    hy = serial(torch.zeros(m, BLOCK + m, **f64), torch.eye(m, **f64), b, a)
    return hx.to(device, dtype), hy.to(device, dtype)


def iir(x: torch.Tensor, b, a, x_hist=None, y_hist=None) -> torch.Tensor:
    """Filter x (rows, T) from the given history (oldest first; zeros
    when None), in x's type and on its device."""
    m = len(a) - 1
    rows, T = x.shape
    hx, hy = _maps(b, a, x.dtype, x.device)
    xh = x.new_zeros(rows, m) if x_hist is None else x_hist.to(x.dtype)
    yh = x.new_zeros(rows, m) if y_hist is None else y_hist.to(x.dtype)
    out = torch.empty_like(x)
    for t0 in range(0, T, BLOCK):
        n = min(BLOCK, T - t0)
        xe = torch.cat([xh, x[:, t0:t0 + n]], 1)
        y = xe @ hx[:m + n, :n] + yh @ hy[:, :n]
        out[:, t0:t0 + n] = y
        xh = xe[:, -m:]
        yh = torch.cat([yh, y], 1)[:, -m:]
    return out


def warmup(x0: torch.Tensor, b, a, steps: int):
    """The history after ``steps`` constant inputs x0 (rows,) from a zero
    state, one step a sample: (x_hist, y_hist), oldest first."""
    m = len(a) - 1
    rows = x0.shape[0]
    x_ext = x0[:, None].expand(rows, m + steps).clone()
    x_ext[:, :m] = 0
    y = serial(x_ext, x0.new_zeros(rows, m), b, a)
    return x0[:, None].expand(rows, m).clone(), y[:, -m:]


def gate_serial(sig: np.ndarray, thr: np.ndarray, nr_slope: int,
                atten: float) -> np.ndarray:
    """peak_detector.h:95-122 as written, one step a sample over one
    row: the marker positions. The definition ``gate`` is held to."""
    amp = prev = 0.0
    searching, count, out = False, 0, []
    for t in range(sig.size):
        s = float(sig[t])
        if searching and s > float(thr[t]) * 1.5 and prev > s:
            if amp == 0 or prev > amp * 0.5:
                amp, count, searching = prev, 1, False
            else:
                amp *= atten
        elif prev < s:
            searching, count = True, 0
        prev = s
        if count:
            count += 1
        if count == nr_slope:
            count = 0
            out.append(t)
    return np.asarray(out, np.int64)


def _next_true(mask: np.ndarray) -> np.ndarray:
    """next[t] = the first i >= t with mask[i], or mask.size."""
    T = mask.size
    idx = np.where(mask, np.arange(T), T)
    return np.append(np.minimum.accumulate(idx[::-1])[::-1], T)


def gate(sig: np.ndarray, thr: np.ndarray, nr_slope: int,
         atten: float) -> np.ndarray:
    """The same state machine, stepping only where it can change: while
    searching, only at a falling sample above 1.5 x the threshold (a
    confirm); after an accepted peak, only at the next rising sample,
    which re-arms the search and cancels a marker not yet due. The
    marker of a peak accepted at c falls at c + nr_slope - 2."""
    T = sig.size
    sig = np.asarray(sig, np.float64)
    prev = np.concatenate([[0.0], sig[:-1]])
    next_r = _next_true(prev < sig)
    next_c = _next_true((sig > np.asarray(thr, np.float64) * 1.5)
                        & (prev > sig))
    amp, searching, t, pending, out = 0.0, False, 0, -1, []
    while t < T:
        if not searching:
            r = int(next_r[t])
            if pending >= 0 and nr_slope >= 2:
                f = pending + nr_slope - 2
                if f < r and f < T:
                    out.append(f)
            pending = -1
            searching, t = True, r + 1
        else:
            c = int(next_c[t])
            if c >= T:
                break
            p = float(prev[c])
            if amp == 0 or p > amp * 0.5:
                amp, pending, searching = p, c, False
            else:
                amp *= atten
            t = c + 1
    if pending >= 0 and nr_slope >= 2:
        f = pending + nr_slope - 2
        if f < T and f < int(next_r[min(pending + 1, T)]):
            out.append(f)
    return np.asarray(out, np.int64)


def detect(x: torch.Tensor, sr: float, dtype=torch.float64,
           attenuation: float = 25.0) -> List[np.ndarray]:
    """The marker positions of each row of x (rows, T), the chain run in
    ``dtype`` on x's device: one int64 array a row."""
    (bp_b, bp_a), (in_b, in_a), (th_b, th_a) = (
        bandpass2(sr, 10.0, 20.0), lowpass2(sr, 3.0), lowpass2(sr, 0.15))
    x = x.to(dtype)
    xh, yh = warmup(x[:, 0], bp_b, bp_a, 4 * int(sr))
    v = iir(x, bp_b, bp_a, xh, yh)
    sig = iir(v * v, in_b, in_a)
    del v
    thr = iir(sig, th_b, th_a)
    nr_slope = int((100.0 * sr) / 1000.0)
    atten = 1.0 / (1.0 + attenuation / sr)
    sig = sig.double().cpu().numpy()
    thr = thr.double().cpu().numpy()
    return [gate(sig[r], thr[r], nr_slope, atten) for r in range(len(sig))]


def unmatched(got: Sequence[np.ndarray], want: Sequence[np.ndarray],
              tol: int = 0) -> Tuple[int, int]:
    """(markers with no marker of the other side within +-tol samples,
    summed over both sides; the reference's markers), row by row. With
    tol 0 the first is the size of the symmetric difference."""
    miss = ref = 0
    for g, w in zip(got, want):
        miss += _lonely(g, w, tol) + _lonely(w, g, tol)
        ref += w.size
    return miss, ref


def inexact(got: Sequence[np.ndarray], want: Sequence[np.ndarray],
            tol: int) -> Tuple[int, int]:
    """(the reference's markers that have a marker of the program within
    +-tol samples but none at their own sample; those that have one
    within +-tol), summed over the rows."""
    off = matched = 0
    for g, w in zip(got, want):
        if g.size == 0 or w.size == 0:
            continue
        exact = g[np.minimum(np.searchsorted(g, w), g.size - 1)] == w
        i = np.searchsorted(g, w - tol, "left")
        near = (i < g.size) & (g[np.minimum(i, g.size - 1)] <= w + tol)
        off += int(np.count_nonzero(near & ~exact))
        matched += int(np.count_nonzero(near))
    return off, matched


def _lonely(a: np.ndarray, b: np.ndarray, tol: int) -> int:
    """Markers of sorted a with no marker of sorted b within +-tol."""
    if b.size == 0:
        return int(a.size)
    i = np.searchsorted(b, a - tol, "left")
    near = b[np.minimum(i, b.size - 1)]
    return int(np.count_nonzero((i >= b.size) | (near > a + tol)))
