"""Butterworth IIR coefficient design, host f64 math: the port's copy of
rspt_tpu/filters/design.py (which replicates
lib_rspt/lib_filter/iir_filter_design.cpp). The coefficients are the
streaming path's weights and equal the reference's bit for bit.

* 2nd-order low/high-pass via bilinear transform with prewarp
  (iir_filter_design.cpp:26-61)
* 1st-order low/high-pass (:63-93)
* 2nd-order band-pass → 4th-order digital filter via polynomial algebra
  in z (:242-307, helpers :165-234)
* 1st-order band-pass as LP·HP cascade (:309-356)
* dispatcher create_filter_iir (:358-375)

Naming convention: this module returns scipy-style ``(b, a)`` — b the
feedforward (numerator) and a the feedback (denominator, a[0] == 1).
The reference's filter objects take ``n`` = feedback = our ``a`` and
``d`` = feedforward = our ``b`` (iir_filter.cpp:75-78).
"""

from __future__ import annotations

import enum
import math
from typing import List, Tuple


class FilterType(enum.IntEnum):
    """filter.h:94-100."""
    INVALID = -1
    HIGH_PASS = 0
    LOW_PASS = 1
    BAND_PASS = 2
    BAND_STOP = 3  # not supported (parity with reference)


class FilterKind(enum.IntEnum):
    """filter.h:102-106."""
    INVALID = -1
    BESSEL = 0
    BUTTERWORTH = 1
    CHEBYSHEV = 2


def butterworth_2nd(ftype: FilterType, sampling_rate: float,
                    cutoff: float) -> Tuple[List[float], List[float]]:
    """2nd-order LP/HP (iir_filter_design.cpp:26-61). Returns (b, a)."""
    if ftype not in (FilterType.LOW_PASS, FilterType.HIGH_PASS) \
            or sampling_rate <= 0 or cutoff <= 0:
        raise ValueError("unsupported 2nd-order design")
    K = math.tan(math.pi * cutoff / sampling_rate)
    K2 = K * K
    sqrt2 = math.sqrt(2.0)
    a0 = 1.0 + sqrt2 * K + K2
    a1 = 2.0 * (K2 - 1.0)
    a2 = 1.0 - sqrt2 * K + K2
    if ftype == FilterType.LOW_PASS:
        b = [K2 / a0, 2.0 * K2 / a0, K2 / a0]
    else:
        b = [1.0 / a0, -2.0 / a0, 1.0 / a0]
    a = [1.0, a1 / a0, a2 / a0]
    return b, a


def butterworth_1st(ftype: FilterType, sampling_rate: float,
                    cutoff: float) -> Tuple[List[float], List[float]]:
    """1st-order LP/HP (iir_filter_design.cpp:63-93)."""
    if ftype not in (FilterType.LOW_PASS, FilterType.HIGH_PASS) \
            or sampling_rate <= 0 or cutoff <= 0:
        raise ValueError("unsupported 1st-order design")
    K = math.tan(math.pi * cutoff / sampling_rate)
    a0 = 1.0 + K
    a1 = 1.0 - K
    if ftype == FilterType.LOW_PASS:
        b = [K / a0, K / a0]
    else:
        b = [1.0 / a0, -1.0 / a0]
    a = [1.0, -a1 / a0]
    return b, a


# --- polynomial helpers (iir_filter_design.cpp:165-234) ---------------------

def _poly_multiply(p, q):
    r = [0.0] * (len(p) + len(q) - 1)
    for i, pi in enumerate(p):
        for j, qj in enumerate(q):
            r[i + j] += pi * qj
    return r


def _poly_add(p, q):
    n = max(len(p), len(q))
    po, qo = n - len(p), n - len(q)
    return [(p[i - po] if i >= po else 0.0) + (q[i - qo] if i >= qo else 0.0)
            for i in range(n)]


def _poly_scale(p, s):
    return [c * s for c in p]


def _binomial_poly(n: int, sign: float):
    """(z ± 1)^n coefficients, highest power first, replicating the
    reference's incremental binomial build (:204-234)."""
    poly = []
    for k in range(n + 1):
        coeff = 1.0
        for i in range(1, k + 1):
            coeff *= float(n - i + 1) / i
        poly.append(coeff * (1.0 if (k % 2 == 0 or sign > 0) else -1.0))
    return poly


def butterworth_bandpass_2nd(sampling_rate: float, cutoff_low: float,
                             cutoff_high: float):
    """2nd-order prototype band-pass → 4th-order digital (5 coeffs),
    replicating the polynomial bilinear transform of
    iir_filter_design.cpp:242-307 term by term (output matches scipy,
    as the reference claims at :241)."""
    if sampling_rate <= 0 or cutoff_low <= 0 or cutoff_high <= cutoff_low:
        raise ValueError("unsupported band-pass design")
    T = 1.0 / sampling_rate
    k = 2.0 / T
    Omega1 = k * math.tan(math.pi * cutoff_low / sampling_rate)
    Omega2 = k * math.tan(math.pi * cutoff_high / sampling_rate)
    Bw = Omega2 - Omega1
    W0 = math.sqrt(Omega1 * Omega2)

    a4 = 1.0
    a3 = math.sqrt(2.0) * Bw
    a2 = 2.0 * W0 * W0 + Bw * Bw
    a1 = math.sqrt(2.0) * Bw * W0 * W0
    a0 = W0 ** 4
    b2 = Bw * Bw

    zm1_4 = _binomial_poly(4, -1)
    zp1_4 = _binomial_poly(4, +1)
    zm1_3 = _binomial_poly(3, -1)
    zp1_1 = _binomial_poly(1, +1)
    zm1_2 = _binomial_poly(2, -1)
    zp1_2 = _binomial_poly(2, +1)
    zm1_1 = _binomial_poly(1, -1)
    zp1_3 = _binomial_poly(3, +1)

    d = _poly_scale(zm1_4, a4 * k ** 4)
    d = _poly_add(d, _poly_scale(_poly_multiply(zm1_3, zp1_1), a3 * k ** 3))
    d = _poly_add(d, _poly_scale(_poly_multiply(zm1_2, zp1_2), a2 * k ** 2))
    d = _poly_add(d, _poly_scale(_poly_multiply(zm1_1, zp1_3), a1 * k))
    d = _poly_add(d, _poly_scale(zp1_4, a0))

    n = _poly_scale([1.0, 0.0, -2.0, 0.0, 1.0], b2 * k ** 2)
    norm = d[0]
    a = [c / norm for c in d]
    b = [c / norm for c in n]
    return b, a


def butterworth_bandpass_1st(sampling_rate: float, cutoff_low: float,
                             cutoff_high: float):
    """1st-order band-pass = HP(f_lo) · LP(f_hi) cascade
    (iir_filter_design.cpp:309-356)."""
    if sampling_rate <= 0 or cutoff_low <= 0 or cutoff_high <= cutoff_low:
        raise ValueError("unsupported band-pass design")
    b_hp, a_hp = butterworth_1st(FilterType.HIGH_PASS, sampling_rate,
                                 cutoff_low)
    b_lp, a_lp = butterworth_1st(FilterType.LOW_PASS, sampling_rate,
                                 cutoff_high)
    b = [b_lp[0] * b_hp[0], b_lp[0] * b_hp[1] + b_lp[1] * b_hp[0],
         b_lp[1] * b_hp[1]]
    a = [a_lp[0] * a_hp[0], a_lp[0] * a_hp[1] + a_lp[1] * a_hp[0],
         a_lp[1] * a_hp[1]]
    norm = a[0]
    return [c / norm for c in b], [c / norm for c in a]


def create_filter_iir(kind: FilterKind, ftype: FilterType, order: int,
                      sampling_rate: float, cutoff_low: float,
                      cutoff_high: float = 0.0):
    """Dispatcher mirroring iir_filter_design.cpp:358-375.

    Returns (b, a). Only Butterworth is supported (parity with the
    reference, filter.h:104-105).
    """
    if kind != FilterKind.BUTTERWORTH:
        raise ValueError("only butterworth is supported")
    if order == 2:
        if ftype in (FilterType.LOW_PASS, FilterType.HIGH_PASS):
            return butterworth_2nd(ftype, sampling_rate, cutoff_low)
        return butterworth_bandpass_2nd(sampling_rate, cutoff_low,
                                        cutoff_high)
    if order == 1:
        if ftype in (FilterType.LOW_PASS, FilterType.HIGH_PASS):
            return butterworth_1st(ftype, sampling_rate, cutoff_low)
        return butterworth_bandpass_1st(sampling_rate, cutoff_low,
                                        cutoff_high)
    raise ValueError("only order 1 and 2 designs are supported")
