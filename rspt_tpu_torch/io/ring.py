"""Host-side ingest staging, ring buffers: the port's copy of
rspt_tpu/io/ring.py:25-156 (lib_rspt/lib_ring_buffer/ring_buffers.h).

* ContinuousRing — a ring guaranteeing *contiguous* readable memory
  (ring_buffers.h:20-148): pops are pointer bumps, pushes compact via
  memmove or grow the allocation. Numpy-backed, so the contiguous view
  goes to the packer with no extra copy.
* IoBuffer — fixed-pool SPSC packet ring with a per-slot state machine
  (0 empty / 1 filling / 2 filled / 3 read; ring_buffers.h:150-201).
  Slot states are plain Python ints guarded by a threading.Condition,
  which also gives an optional blocking hand-off.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class ContinuousRing:
    """Contiguous-readable ring of scalar elements (dtype-typed)."""

    def __init__(self, size: int, dtype=np.float64):
        """Starts with ``size`` zero elements, like the reference ctor
        (ring_buffers.h:30-37; fir_filter passes 0 for an empty ring)."""
        self._real = 2 * int(size) + 1
        self._data = np.zeros(self._real, dtype)
        self._shift = 0
        self._size = int(size)
        self.dtype = np.dtype(dtype)

    def __len__(self):
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    @property
    def data(self) -> np.ndarray:
        """The contiguous readable view (mShiftedData[0:size])."""
        return self._data[self._shift:self._shift + self._size]

    def _make_room(self, n: int):
        if self._shift + self._size + n > self._real:
            if (self._size + n <= self._real
                    and self._shift > self._real // 2
                    and self._real // 2 >= n):
                # compact in place (ring_buffers.h:57-58)
                self._data[:self._size] = self.data
            else:
                self._real *= 2
                if self._real < n + self._size:
                    self._real += n
                nd = np.zeros(self._real, self.dtype)
                nd[:self._size] = self.data
                self._data = nd
            self._shift = 0

    def push_back(self, v):
        self.push_elements_back(np.asarray([v], self.dtype))

    def push_elements_back(self, arr):
        arr = np.asarray(arr, self.dtype).ravel()
        self._make_room(arr.size)
        start = self._shift + self._size
        self._data[start:start + arr.size] = arr
        self._size += arr.size

    def enlarge_back(self, n: int) -> np.ndarray:
        """Reserve n writable elements at the back; returns the view
        (ring_buffers.h:76-97)."""
        self._make_room(n)
        start = self._shift + self._size
        self._size += n
        return self._data[start:start + n]

    def clear(self):
        self._shift = 0
        self._size = 0

    def __getitem__(self, i):
        return self.data[i]

    def front(self):
        return self.data[0]

    def back(self):
        return self.data[self._size - 1]

    def pop_front(self):
        self.pop_elements_front(1)

    def pop_back(self):
        self.pop_elements_back(1)

    def pop_elements_front(self, n: int):
        if self._size >= n:
            self._shift += n
            self._size -= n

    def pop_elements_back(self, n: int):
        if self._size >= n:
            self._size -= n


_EMPTY, _FILLING, _FILLED, _READ = 0, 1, 2, 3


class IoBuffer:
    """Fixed-pool packet ring for producer→consumer hand-off."""

    def __init__(self, packet_size: int, nr_max_packets: int = 100):
        self.packet_bytes = int(packet_size)
        self.n = int(nr_max_packets)
        self._buf = np.zeros((self.n, self.packet_bytes), np.uint8)
        self._states = [_EMPTY] * self.n
        self._it_read = 0
        self._it_write = 0
        self._it_write_last = 0
        self._cond = threading.Condition()

    def get_next_address_to_fill(self) -> Optional[np.ndarray]:
        """Producer: claim the next packet slot; the previously claimed
        slot is published as filled (ring_buffers.h:180-197)."""
        with self._cond:
            w = self._it_write
            if self._states[w] in (_EMPTY, _READ):
                if self._states[self._it_write_last] == _FILLING:
                    self._states[self._it_write_last] = _FILLED
                self._states[w] = _FILLING
                self._it_write_last = w
                self._it_write = (w + 1) % self.n
                self._cond.notify_all()
                return self._buf[w]
            return None

    def get_next_filled_address(self, timeout: Optional[float] = None
                                ) -> Optional[np.ndarray]:
        """Consumer: next filled packet or None
        (ring_buffers.h:167-178). timeout enables blocking waits (an
        extension; pass None for the reference's non-blocking probe)."""
        with self._cond:
            if timeout is not None:
                self._cond.wait_for(
                    lambda: self._states[self._it_read] == _FILLED, timeout)
            r = self._it_read
            if self._states[r] == _FILLED:
                self._states[r] = _READ
                self._it_read = (r + 1) % self.n
                return self._buf[r]
            return None
