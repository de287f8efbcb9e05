"""Streaming real-time path (BASELINE config 5): ring-buffer ingest →
per-channel IIR pre-filter → batched xdelta_hzr frames. The port's
counterpart of rspt_tpu/pipeline.py:32-218.

The reference's usage pattern (lib_rspt_test/rspt_test.cpp:114-137):
convert native → filter each channel sample by sample with
``filter_opt`` → convert back → pack fixed-size blocks:

  StreamingCodec.push(bytes)
      → ContinuousRing staging (io/ring.py) until whole blocks
      → every channel of every complete block in ONE call of the host
        runtime's threaded serial f64 IIR (filters/streaming.py; the
        state (xz, yz) carried across blocks and pushes)
      → f64 → int32 on the host, as the reference's C cast (numpy's
        astype is x86's cvttsd2si: INT32_MIN out of range; a torch
        conversion on the card would saturate)
      → the port's xdelta_hzr packer: compress_many over the span's
        blocks (one K1 and one K2 launch a plane count probed), or
        compress for a single block.

When the packer is the all-host engine's xdelta packer
(packers.native.NativeXdeltaHzrPacker with hzr planes), each push takes
the fused route instead (pipeline.py:150-196 of the reference): the
filter's warm-up on the span's first samples, then the whole span in
ONE runtime call (native.stream_filter_pack: the IIR with the state
(xz, yz) carried in and out, the f64 → int32 conversion, each frame's
xdelta planes with sequential verify-and-grow, every block encoded),
and the packer's plane count taken from the call. Both routes give the
same frames, and a state from either loads into the other.

There is no fallback: a failed runtime build or kernel launch raises.
Every stage's carry state is plain data, so checkpoint/resume is
get_state()/set_state(), in the reference's dict layout: a state that
rspt_tpu.pipeline.StreamingCodec gives loads here and continues with
equal frames.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import packers
from .filters.streaming import IirFilter
from .io.ring import ContinuousRing
from .native import bindings as native
from .packers.native import NativeXdeltaHzrPacker


@dataclass
class StreamConfig:
    bytes_per_sample: int
    nr_channels: int
    nr_samples: int          # samples per compressed block
    sampling_rate: float = 2000.0
    nr_bytes_to_encode: int = 3
    filter_coeffs: Optional[Tuple[List[float], List[float]]] = None
    # (n = feedback, d = feedforward), reference naming; None = no filter


def native_to_i32(buf: np.ndarray, nr_samples: int, nr_channels: int,
                  bytes_per_sample: int) -> np.ndarray:
    """Interleaved native bytes [s0c0][s0c1]... (flat uint8) →
    (channels, samples) int32, sign-extended from bit 8·bps − 1 (the
    port's copy of rspt_tpu/ops/numpy_ops.py:19-42)."""
    bps = bytes_per_sample
    flat = buf[:nr_samples * nr_channels * bps]
    if bps in (1, 2, 4):
        v = flat.view({1: np.int8, 2: "<i2", 4: "<i4"}[bps])
        return np.ascontiguousarray(
            v.reshape(nr_samples, nr_channels).T.astype(np.int32))
    b = flat.reshape(nr_samples, nr_channels, bps)
    v = np.zeros((nr_samples, nr_channels), np.int64)
    for k in range(bps):
        v |= b[..., k].astype(np.int64) << (8 * k)
    half = np.int64(1) << (8 * bps - 1)
    v = np.where(v >= half, v - (np.int64(1) << (8 * bps)), v)
    return np.ascontiguousarray(v.T.astype(np.int32))


def i32_to_native(arr: np.ndarray, bytes_per_sample: int) -> np.ndarray:
    """(channels, samples) int32 → interleaved native low bytes, flat
    uint8 (numpy_ops.py:45-57)."""
    if bytes_per_sample == 4:
        return np.ascontiguousarray(arr.T, "<i4").view(np.uint8).reshape(-1)
    v = np.ascontiguousarray(arr.T).astype(np.uint32)
    b = np.stack([(v >> np.uint32(8 * k)).astype(np.uint8)
                  for k in range(bytes_per_sample)], axis=-1)
    return b.reshape(-1)


def state_from_reference(st) -> dict:
    """A state dict of rspt_tpu.pipeline.StreamingCodec.get_state() in
    this codec's layout (the same keys and values: a copy)."""
    return dict(st, ring=np.asarray(st["ring"], np.uint8).copy())


class StreamingCodec:
    """Push native interleaved bytes in, get compressed frames out. The
    packer runs on ``device`` (default: the card; raises without one;
    "cpu": the kernels' plain versions); a given packer of the all-host
    engine takes the fused route."""

    def __init__(self, cfg: StreamConfig, packer=None, device=None):
        self.cfg = cfg
        if packer is None:
            packer = packers.new_xdelta_hzr(
                cfg.bytes_per_sample, cfg.nr_channels, cfg.nr_samples,
                cfg.nr_bytes_to_encode, device=device)
        self.packer = packer
        self._ring = ContinuousRing(0, np.uint8)
        self._filters = None
        if cfg.filter_coeffs is not None:
            n, d = cfg.filter_coeffs
            self._filters = [IirFilter(n=n, d=d)
                             for _ in range(cfg.nr_channels)]
        self._warmed = False
        self.frames_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        # wall seconds of the last push's stages: filter, pack (the fused
        # route: span)
        self.stage_seconds = {}

    @property
    def block_bytes(self) -> int:
        c = self.cfg
        return c.bytes_per_sample * c.nr_channels * c.nr_samples

    def get_state(self):
        return {
            "ring": self._ring.data.copy(),
            "filters": [f.get_state() for f in self._filters]
            if self._filters else None,
            "warmed": self._warmed,
            "counters": (self.frames_out, self.bytes_in, self.bytes_out),
        }

    def set_state(self, st):
        self._ring.clear()
        self._ring.push_elements_back(st["ring"])
        if self._filters and st["filters"]:
            for f, s in zip(self._filters, st["filters"]):
                f.set_state(s)
        self._warmed = st["warmed"]
        self.frames_out, self.bytes_in, self.bytes_out = st["counters"]

    def _warm_up(self, sig: np.ndarray) -> None:
        """The first time: each filter's warm-up on its channel's first
        sample (sig (channels, >= 1) int32; the generic order,
        4·sampling_rate samples)."""
        if not self._warmed:
            for f, row in zip(self._filters, sig):
                f.init_history_values(float(row[0]),
                                      int(self.cfg.sampling_rate))
            self._warmed = True

    def _filter_state(self):
        """The filters' (xz, yz) as (channels, p) float64 arrays."""
        return (np.array([f.xz for f in self._filters], np.float64),
                np.array([f.yz for f in self._filters], np.float64))

    def _set_filter_state(self, xz: np.ndarray, yz: np.ndarray) -> None:
        for j, f in enumerate(self._filters):
            f.xz, f.yz = xz[j].tolist(), yz[j].tolist()

    def _filter_span(self, span: np.ndarray, nblocks: int) -> np.ndarray:
        """Every channel of the span through its filter_opt recurrence in
        one threaded runtime call, after the warm-up: the reference's
        pre-filter loop (rspt_test.cpp:120-136), bit for bit. Returns the
        filtered native bytes."""
        c = self.cfg
        sig = native_to_i32(span, nblocks * c.nr_samples, c.nr_channels,
                            c.bytes_per_sample)
        self._warm_up(sig)
        f0 = self._filters[0]
        xz, yz = self._filter_state()
        y = native.iir_filter_channels(sig.astype(np.float64), f0.n, f0.d,
                                       xz, yz, 1)
        self._set_filter_state(xz, yz)
        with np.errstate(invalid="ignore"):
            out = y.astype(np.int32)
        return i32_to_native(out, c.bytes_per_sample)

    def _fused(self) -> bool:
        """Whether pushes take the fused route: the packer is the
        all-host engine's xdelta packer with hzr planes."""
        return (isinstance(self.packer, NativeXdeltaHzrPacker)
                and self.packer.plane_backend == "hzr")

    def _push_fused(self, span: np.ndarray, nblocks: int) -> List[bytes]:
        """The span's frames in one runtime call (stream_filter_pack),
        after the warm-up on its first samples; the filters' state and
        the packer's plane count come back from the call."""
        c = self.cfg
        n = d = xz = yz = None
        if self._filters is not None:
            self._warm_up(native_to_i32(span, 1, c.nr_channels,
                                        c.bytes_per_sample))
            n, d = self._filters[0].n, self._filters[0].d
            xz, yz = self._filter_state()
        frames, planes = native.stream_filter_pack(
            span, c.nr_samples, nblocks, c.nr_channels, c.bytes_per_sample,
            n, d, xz, yz, 1, self.packer.nr_planes, self.packer.nthreads)
        self.packer.nr_planes = planes
        if self._filters is not None:
            self._set_filter_state(xz, yz)
        return frames

    def push(self, data) -> List[bytes]:
        """Feed native bytes; returns 0+ compressed frames. Every complete
        block after the push is one span: filtered in one runtime call,
        then compressed in one compress_many call (compress for a single
        block); on the fused route, filtered and compressed in one
        runtime call."""
        buf = (np.frombuffer(memoryview(data).cast("B"), np.uint8)
               if not isinstance(data, np.ndarray) else data.reshape(-1))
        self.bytes_in += buf.size
        self._ring.push_elements_back(buf)
        nblocks = len(self._ring) // self.block_bytes
        self.stage_seconds = {}
        if nblocks == 0:
            return []
        # a view: popping only moves the ring's start, and nothing writes
        # the ring again before this push returns
        span = self._ring.data[:nblocks * self.block_bytes]
        self._ring.pop_elements_front(nblocks * self.block_bytes)
        t0 = time.perf_counter()
        if self._fused():
            frames = self._push_fused(span, nblocks)
            self.stage_seconds = {"span": time.perf_counter() - t0}
            return self._count(frames)
        if self._filters is not None:
            span = self._filter_span(span, nblocks)
        t1 = time.perf_counter()
        blocks = [span[k * self.block_bytes:(k + 1) * self.block_bytes]
                  for k in range(nblocks)]
        if nblocks > 1:
            frames = self.packer.compress_many(blocks)
        else:
            frames = [self.packer.compress(blocks[0])]
        self.stage_seconds = {"filter": t1 - t0,
                              "pack": time.perf_counter() - t1}
        return self._count(frames)

    def _count(self, frames: List[bytes]) -> List[bytes]:
        for comp in frames:
            self.bytes_out += len(comp)
            self.frames_out += 1
        return frames

    def flush_stats(self):
        return {"frames": self.frames_out, "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "cr": self.bytes_in / self.bytes_out
                if self.bytes_out else None}


class StreamingDecoder:
    """Inverse: compressed frames → native byte stream, through the
    port's xdelta_hzr packer on ``device`` (device_decode: the device
    decoder instead of the host runtime)."""

    def __init__(self, cfg: StreamConfig, packer=None, device=None,
                 device_decode: bool = False):
        self.cfg = cfg
        if packer is None:
            packer = packers.new_xdelta_hzr(
                cfg.bytes_per_sample, cfg.nr_channels, cfg.nr_samples,
                cfg.nr_bytes_to_encode, device=device,
                device_decode=device_decode)
        self.packer = packer

    def push(self, frame: bytes) -> bytes:
        out, _ = self.packer.decompress(frame)
        return out
