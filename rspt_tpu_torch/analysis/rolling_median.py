"""Rolling-window median — the host reference semantics and two batch
paths on the device: the port's counterpart of
rspt_tpu/analysis/rolling_median.py.

The reference keeps a multiset and a median iterator with O(log w)
updates (lib_rspt/lib_stat/rolling_window_median.h:151-254). What it
returns: after inserting each value, the median of the last ≤ w values,
the middle element for odd counts and ``(lo + hi) / 2.0`` of the two
middle ones for even counts (:247-250); during warm-up the window is the
partial prefix.

* ``RollingWindowMedian`` / ``rolling_median``: host copies (:26-52), a
  sorted list and bisect; the oracles.
* ``torch_rolling_median`` (counterpart of ``jax_rolling_median``
  :153-175): every window at once, a (T, w) gather padded with +inf,
  ``torch.sort``, the middle element or elements.
* ``torch_rolling_median_large`` (counterpart of
  ``jax_rolling_median_large`` :55-150): large windows without the (T, w)
  matrix, by anchor decomposition (see its docstring).

Both device paths return float32 medians on the device (``device=None``:
the card, or they raise without one). The sorts are ``torch.sort``: no
hand-written kernel yet.
"""

from __future__ import annotations

import bisect
from typing import List

import numpy as np
import torch

from ..device import resolve_device

_ANCHOR_CHUNK = 1 << 26     # elements of count_delta's masks at a time


class RollingWindowMedian:
    """Drop-in equivalent of rolling_window_median<T>::insert."""

    def __init__(self, size: int):
        self.size = int(size)
        self._sorted: List[float] = []
        self._ring: List[float] = []

    def insert(self, value):
        v = value
        bisect.insort(self._sorted, v)
        self._ring.append(v)
        if len(self._ring) > self.size:
            old = self._ring.pop(0)
            i = bisect.bisect_left(self._sorted, old)
            self._sorted.pop(i)
        s = self._sorted
        m = len(s)
        if m % 2:
            return s[m // 2]
        return (s[m // 2 - 1] + s[m // 2]) / 2.0


def rolling_median(values, window: int) -> np.ndarray:
    """Host convenience: the median after every insert."""
    rm = RollingWindowMedian(window)
    return np.array([rm.insert(float(v)) for v in np.asarray(values).ravel()])


def _values(values, dev: torch.device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(dev, torch.float32).reshape(-1)
    return torch.from_numpy(
        np.asarray(values, np.float32).reshape(-1).copy()).to(dev)


def torch_rolling_median(values, window: int, device=None) -> torch.Tensor:
    """Every rolling median at once: the (T, w) sliding-window matrix (a
    gather, +inf before the first sample), sorted by rows, the middle
    element(s) of each row's valid count (min(t + 1, w))."""
    dev = resolve_device(device)
    x = _values(values, dev)
    T, w = x.shape[0], int(window)
    t = torch.arange(T, device=dev)
    idx = t[:, None] - torch.arange(w - 1, -1, -1, device=dev)[None, :]
    gathered = torch.where(idx >= 0, x[idx.clamp(0, max(T - 1, 0))],
                           torch.tensor(float("inf"), device=dev))
    srt = torch.sort(gathered, dim=1).values
    cnt = torch.minimum(t + 1, torch.tensor(w, device=dev))
    lo = srt[t, (cnt - 1) // 2]
    hi = srt[t, cnt // 2]
    return torch.where(cnt % 2 == 1, lo, (lo + hi) / 2.0)


def torch_rolling_median_large(values, window: int, stride: int = 512,
                               device=None) -> torch.Tensor:
    """Exact rolling medians for LARGE windows without the (T, w) matrix
    (the reference's test_8 regime: w = 1,500 over 1M samples).

    Anchor decomposition: the windows whose start falls in one
    stride-aligned bucket share an anchor window A = x[α:α+w] (sorted
    once) and differ from it by removing a prefix of R = x[α:α+s] and
    appending a prefix of P = x[α+w:α+w+s]. Each output's rank-k element
    is found by a binary search over the anchor's merged sorted
    candidates M = sort(A ∪ P); the count of window elements ≤ M[j] is
    Q[j] − #R_d≤v + #P_d≤v, with Q the count from A (made value-exact
    under ties: each run of equal values takes its run end's Q, by
    doubling). Float32 medians for t ≥ w − 1; the first w − 1 (partial
    windows) from torch_rolling_median on the first samples."""
    dev = resolve_device(device)
    x = _values(values, dev)
    T, w, s = x.shape[0], int(window), int(stride)
    if T <= w or w <= 2 * s:
        return torch_rolling_median(x, w, device=dev)

    nw = T - (w - 1)                     # full windows
    na = -(-nw // s)                     # anchors
    pad = na * s + w + s                 # room for the pools
    xp = torch.cat([x, torch.full((pad - T,), float("inf"), device=dev)])
    gather = (torch.arange(na, device=dev) * s)[:, None] \
        + torch.arange(w + s, device=dev)[None, :]
    AP = xp[gather]                      # (na, w + s): A then P's pool
    flags = torch.cat([torch.ones(w, dtype=torch.int32, device=dev),
                       torch.zeros(s, dtype=torch.int32, device=dev)])
    order = torch.argsort(AP, dim=1, stable=True)
    M = torch.take_along_dim(AP, order, 1)
    Q = torch.cumsum(flags[order], 1, dtype=torch.int32)
    p = 1
    while p < w + s:
        Mp = torch.cat([M[:, p:], torch.full((na, p), float("inf"),
                                             device=dev)], 1)
        Qp = torch.cat([Q[:, p:], torch.zeros((na, p), dtype=torch.int32,
                                              device=dev)], 1)
        Q = torch.where(M == Mp, torch.maximum(Q, Qp), Q)
        p *= 2

    R = AP[:, :s]                        # removal pool (A's prefix)
    P = AP[:, w:w + s]                   # addition pool
    dd = torch.arange(s, device=dev)
    below = dd[None, :] < dd[:, None]    # [d, e]: e < d
    chunk = max(1, _ANCHOR_CHUNK // (s * s))

    def count_delta(pool, v):
        """#{pool[a, :d] <= v[a, d]} for every (anchor a, d)."""
        out = []
        for a0 in range(0, na, chunk):
            le = (pool[a0:a0 + chunk, None, :] <= v[a0:a0 + chunk, :, None])
            out.append((le & below).sum(2, dtype=torch.int32))
        return torch.cat(out)

    def select(k):
        lo = torch.zeros((na, s), dtype=torch.int64, device=dev)
        hi = torch.full((na, s), w + s, dtype=torch.int64, device=dev)
        for _ in range(int(np.ceil(np.log2(w + s))) + 1):
            mid = (lo + hi) // 2
            v = torch.take_along_dim(M, mid.clamp(max=w + s - 1), 1)
            qa = torch.take_along_dim(Q, mid.clamp(max=w + s - 1), 1)
            ge = qa - count_delta(R, v) + count_delta(P, v) >= k
            lo = torch.where(ge, lo, mid + 1)
            hi = torch.where(ge, mid, hi)
        return torch.take_along_dim(M, hi.clamp(max=w + s - 1), 1)

    if w % 2:
        med = select((w + 1) // 2).reshape(-1)[:nw]
    else:
        med = (select(w // 2).reshape(-1)[:nw]
               + select(w // 2 + 1).reshape(-1)[:nw]) / 2.0
    warm = torch_rolling_median(x[:w - 1], w, device=dev)
    return torch.cat([warm, med])
