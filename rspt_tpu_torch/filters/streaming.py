"""Streaming sample-at-a-time filters — the port's copy of
rspt_tpu/filters/streaming.py:30-173.

Bit-exact (f64, identical accumulation order) mirror of ``iir_filter``
(lib_rspt/lib_filter/iir_filter.cpp:46-121): the generic ``filter()``
and the order-unrolled ``filter_opt()`` differ in floating-point
accumulation order, and both orders are kept exactly.

``process`` and ``init_history_values`` run the port's host runtime
(rspt_tpu_torch/native: ``iir_filter_array``), with no fallback: a
failed build raises. The per-sample ``filter`` / ``filter_opt`` loops
are its plain versions, which the tests hold it against.

``FirFilter`` (fir_filter.cpp:26-79: 0 until the kernel window fills)
and ``Delay`` (iir_filter_opt.h:113-130) are host classes in f64, the
oracles of the batched ``filters.torch_filters.fir_apply``.

Parameter naming follows the reference: ``n`` is the FEEDBACK
(denominator) vector with n[0] == 1, ``d`` the FEEDFORWARD (numerator),
swapped relative to scipy's (b, a) (see filters/design.py). The state
(xz, yz) is explicit, so a checkpoint is a copy of it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..native import bindings as native


class IirFilter:
    """Direct-form-I IIR with 2 to 5 coefficients (order <= 4)."""

    def __init__(self, n: Sequence[float], d: Sequence[float]):
        if not 2 <= len(n) <= 5 or len(n) != len(d):
            raise ValueError("2..5 coefficients, equal lengths")
        self.n = [float(v) for v in n]
        self.d = [float(v) for v in d]
        self.p = len(self.n)
        self.xz = [0.0] * self.p
        self.yz = [0.0] * self.p

    def get_state(self):
        return list(self.xz), list(self.yz)

    def set_state(self, state):
        xz, yz = state
        self.xz, self.yz = list(xz), list(yz)

    def filter(self, x: float) -> float:
        """Generic loop (iir_filter.cpp:64-79): y = d0·x0, then
        interleaved += d[i]·x[i]; -= n[i]·y[i] per i."""
        for i in range(self.p - 1, 0, -1):
            self.xz[i] = self.xz[i - 1]
            self.yz[i] = self.yz[i - 1]
        self.xz[0] = float(x)
        y = self.d[0] * self.xz[0]
        for i in range(1, self.p):
            y += self.d[i] * self.xz[i]
            y -= self.n[i] * self.yz[i]
        self.yz[0] = y
        return y

    def filter_opt(self, x: float) -> float:
        """Unrolled MAC (iir_filter.cpp:26-44): all feedforward terms
        left to right, then all feedback subtractions."""
        for i in range(self.p - 1, 0, -1):
            self.xz[i] = self.xz[i - 1]
            self.yz[i] = self.yz[i - 1]
        self.xz[0] = float(x)
        d, n, xz, yz = self.d, self.n, self.xz, self.yz
        y = d[0] * xz[0]
        for i in range(1, self.p):
            y = y + d[i] * xz[i]
        for i in range(1, self.p):
            y = y - n[i] * yz[i]
        self.yz[0] = y
        return y

    def init_history_values(self, x: float, nr_samples: int,
                            opt: bool = False) -> None:
        """4·nr_samples warm-up iterations on constant x, the
        anti-ripple loop of iir_filter.cpp:109-113, through the generic
        order (opt=True: the unrolled one), in the runtime."""
        self.process(np.full(4 * int(nr_samples), float(x)), opt=opt)

    def process(self, xs, opt: bool = True) -> np.ndarray:
        """Filter an array serially (the reference's usage loop,
        rspt_test.cpp:130-132) in the runtime: filter_opt's order, or
        filter's with opt=False. Returns y float64."""
        y, (self.xz, self.yz) = native.iir_filter_array(
            np.asarray(xs, np.float64).reshape(-1), self.n, self.d,
            self.xz, self.yz, 1 if opt else 0)
        return y


def new_iir(n: Sequence[float], d: Sequence[float],
            nr_coefficients: int = None) -> IirFilter:
    """The i_filter factory (filter.h:75-88): an IirFilter of the first
    nr_coefficients of n and d, or all of them."""
    if nr_coefficients is not None:
        n, d = list(n)[:nr_coefficients], list(d)[:nr_coefficients]
    return IirFilter(n, d)


class FirFilter:
    """Kernel dot product over a sliding window (fir_filter.cpp:26-79)."""

    def __init__(self, kernel: Sequence[float]):
        self.kernel = [float(v) for v in kernel]
        self.ksize = len(self.kernel)
        self.window: List[float] = []

    def get_state(self):
        return list(self.window)

    def set_state(self, state):
        self.window = list(state)

    def filter(self, x: float) -> float:
        """0 until the window fills (fir_filter.cpp:41-50)."""
        if len(self.window) == self.ksize:
            return self.filter_opt(x)
        self.window.append(float(x))
        return 0.0

    def filter_opt(self, x: float) -> float:
        """Push, pop, dot (fir_filter.cpp:52-60)."""
        self.window.append(float(x))
        self.window.pop(0)
        y = 0.0
        for i in range(self.ksize):
            y += self.window[i] * self.kernel[i]
        return y

    def init_history_values(self, x: float, nr_samples: int) -> None:
        """kernel_size warm-up calls (fir_filter.cpp:62-66; nr_samples is
        unused there too)."""
        for _ in range(self.ksize):
            self.filter(x)


class Delay:
    """Pure delay line (iir_filter_opt.h:113-130)."""

    def __init__(self, nr_samples: int):
        self.history = [0.0] * int(nr_samples)

    def get_delayed(self, new_sample: float) -> float:
        res = self.history[-1]
        self.history = [float(new_sample)] + self.history[:-1]
        return res


def new_fir(kernel: Sequence[float], kernel_size: int = None) -> FirFilter:
    """The i_filter factory for a FIR (filter.h:75-88): the first
    kernel_size taps of kernel, or all of them."""
    if kernel_size is not None:
        kernel = list(kernel)[:kernel_size]
    return FirFilter(kernel)
