"""The all-host engine: the four packers with every stage in the port's
C++ host runtime (native/rspt_torch_native.cpp), no card and no torch op
on the path. The port's counterpart of rspt_tpu/packers/native.py
(NativeHzrPacker :63, NativeXdeltaHzrPacker :86, NativeDctPacker :147,
NativeHadamardPacker :201), byte-identical to the card packers
(packers/gpu.py) and to the reference's host packers.

compress: the native samples to int32 (or, for xdelta, straight to its
byte planes in one threaded pass with the growth test), the packer's
transform (the means and the FWHT, or the exact serial-f64 DCT), the
byte planes, then every 64 KiB block of every plane hzr-encoded in
threads — or, with plane_backend 'lz4' / 'lz4hc', each plane as an LZ4
block. decompress: every plane's blocks decoded in threads (LZ4 planes a
plane a thread), whatever backend the packer was built with, then the
inverse transform. ``nthreads`` bounds the threads of each runtime call
(0: one a hardware thread); no thread count changes a byte. The xdelta
packer grows its plane count by the port's rule (ops/cuda_kernels.
_fits_planes), not by the reference native engine's (ROADMAP §3).

The card's options (device, device_decode, encoder=, hints and
compress_with_hints) do not exist here.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..native import bindings as native
from ..ops import torch_ops as tops
from .container import METHOD_MASK, PLANE_BACKENDS, PLANE_LZ4, container
from .gpu import PackerConfig, _means_from_header, _means_header


class _NativeBase:
    """What the native packers share: config, threads, the plane codec
    (hzr or LZ4) and the container. A subclass sets METHOD, nr_planes and
    header_size and writes compress and _postprocess."""

    METHOD = 0

    def __init__(self, bytes_per_sample: int, nr_channels: int,
                 nr_samples: int, nthreads: int = 0,
                 plane_backend: str = "hzr"):
        if plane_backend not in PLANE_BACKENDS:
            raise ValueError(f"unknown plane backend {plane_backend!r}")
        self.cfg = PackerConfig(bytes_per_sample, nr_channels, nr_samples)
        self.nthreads = int(nthreads)
        self.plane_backend = plane_backend
        self._method = self.METHOD | (0 if plane_backend == "hzr"
                                      else PLANE_LZ4)
        self.header_size = 0

    def _container(self, planes: np.ndarray, header: bytes = b"") -> bytes:
        """The container of the (nr_planes, plane_len) byte planes."""
        if self.plane_backend == "hzr":
            streams = native.encode_planes_blocks(planes, self.nthreads)
        else:
            streams = native.lz4_encode_planes(planes,
                                               self.plane_backend == "lz4hc")
        return container(self._method, header, streams)

    def _samples(self, src) -> np.ndarray:
        c = self.cfg
        return native.native_to_i32(src, c.nr_samples, c.nr_channels,
                                    c.bytes_per_sample)

    def _centred(self, src) -> Tuple[np.ndarray, np.ndarray]:
        """The transform packers' start: the (channels, samples) int32
        signal minus the reference's per-channel means (int32 wrap), and
        the means."""
        sig = self._samples(src).astype(np.int64)
        means = tops.average32_host(sig.sum(axis=1), self.cfg.nr_samples)
        return (sig - means[:, None]).astype(np.int32), means

    def _uncentred(self, rec: np.ndarray, header: bytes) -> bytes:
        """rec plus the header's means (int32 wrap), as native bytes."""
        means = _means_from_header(header, self.cfg.nr_channels)
        return native.i32_to_native(
            (rec.astype(np.int64) + means[:, None]).astype(np.int32),
            self.cfg.bytes_per_sample)

    def _decode_planes(self, comp) -> Tuple[bytes, np.ndarray, int]:
        """The container's header, its (nr_planes, plane_len) planes and
        the bytes it spans; hzr or LZ4 planes by the method byte."""
        buf = np.frombuffer(memoryview(comp).cast("B"), np.uint8)
        if buf.size < 1 or buf[0] & METHOD_MASK != self.METHOD:
            raise ValueError("unsupported compression method")
        start = 1 + self.header_size
        if buf[0] & PLANE_LZ4:
            planes, used = native.lz4_decode_planes(
                buf[start:], self.nr_planes, self.cfg.plane_len)
        else:
            planes, used = native.decode_planes_blocks(
                buf[start:], self.nr_planes, self.cfg.plane_len,
                self.nthreads)
        return buf[1:start].tobytes(), planes, start + used

    def _postprocess(self, planes: np.ndarray, header: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, comp) -> Tuple[bytes, int]:
        """Returns (native bytes, bytes of comp consumed)."""
        header, planes, pos = self._decode_planes(comp)
        return self._postprocess(planes, header), pos

    def compress_many(self, srcs) -> List[bytes]:
        """compress of each payload in order: an xdelta payload that grows
        the plane count grows it for every later one
        (rspt_tpu/packers/native.py:122-128)."""
        return [self.compress(s) for s in srcs]

    def decompress_many(self, comps) -> List[bytes]:
        return [self.decompress(cp)[0] for cp in comps]


class NativeHzrPacker(_NativeBase):
    """Lossless 4-plane packer with no preprocessing
    (signal_packer_hzr.cpp:39-65). Method byte 0."""

    METHOD = 0
    NR_PLANES = 4

    def __init__(self, bytes_per_sample, nr_channels, nr_samples, **kw):
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = self.NR_PLANES

    def compress(self, src) -> bytes:
        return self._container(native.plane_split(self._samples(src),
                                                  self.nr_planes))

    def _postprocess(self, planes, header) -> bytes:
        c = self.cfg
        return native.i32_to_native(native.plane_merge(planes).reshape(
            c.nr_channels, c.nr_samples), c.bytes_per_sample)


class NativeXdeltaHzrPacker(_NativeBase):
    """Lossless delta → offset → xor packer with verify-and-grow
    (signal_packer_xdelta_hzr.cpp:34-88). Method byte 0. The plane count
    grows, and stays grown, when its planes would not give back every
    native sample of a payload."""

    METHOD = 0

    def __init__(self, bytes_per_sample: int, nr_channels: int,
                 nr_samples: int, nr_bytes_to_encode: int, **kw):
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = int(nr_bytes_to_encode)

    def compress(self, src) -> bytes:
        c = self.cfg
        while True:
            planes, fits = native.xdelta_preprocess(
                src, c.nr_samples, c.nr_channels, c.bytes_per_sample,
                self.nr_planes, self.nthreads)
            if fits:
                return self._container(planes)
            self.nr_planes += 1

    def _postprocess(self, planes, header) -> bytes:
        c = self.cfg
        return native.xdelta_postprocess(planes, c.nr_samples, c.nr_channels,
                                         c.bytes_per_sample, self.nthreads)


class NativeHadamardPacker(_NativeBase):
    """Lossy Walsh-Hadamard packer (signal_packer_hadamard.cpp:35-107):
    method byte 2, 3 planes, quality 1, a 24-bit per-channel means
    header. nr_samples must be a power of two (1 included)."""

    METHOD = 2
    NR_PLANES = 3
    QUALITY = 1.0

    def __init__(self, bytes_per_sample, nr_channels, nr_samples, **kw):
        if nr_samples < 1 or nr_samples & (nr_samples - 1):
            raise ValueError("Hadamard packer: nr_samples must be 2^k")
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = self.NR_PLANES
        self.header_size = 3 * nr_channels

    def compress(self, src) -> bytes:
        centred, means = self._centred(src)
        had = native.fwht_normalize(native.fwht(centred, self.nthreads),
                                    self.cfg.nr_samples, self.QUALITY)
        return self._container(native.plane_split(had, self.nr_planes),
                               _means_header(means))

    def _postprocess(self, planes, header) -> bytes:
        c = self.cfg
        had = native.plane_merge(planes).reshape(c.nr_channels, c.nr_samples)
        return self._uncentred(native.fwht_normalize2(
            native.fwht(had, self.nthreads), self.QUALITY), header)


class NativeDctPacker(_NativeBase):
    """Lossy DCT packer (signal_packer_dct.cpp:36-156): method byte 1, 2
    planes, quality 128, a 24-bit per-channel means header; any
    nr_samples >= 1. The transform is the reference's exact one (each
    output a serial f64 sum in its order). The packer builds its float32
    cosine table (and its transpose) once, as the card packer does. The
    tail is xdelta's over the flat coefficients, across channel
    borders."""

    METHOD = 1
    NR_PLANES = 2
    QUALITY = 128.0

    def __init__(self, bytes_per_sample, nr_channels, nr_samples, **kw):
        if nr_samples < 1:
            raise ValueError("DCT packer: nr_samples must be >= 1")
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = self.NR_PLANES
        self.header_size = 3 * nr_channels
        self._cos = tops.dct_cos_table(nr_samples)
        self._cos_t = np.ascontiguousarray(self._cos.T)  # COS[i][x] at [x][i]
        self._cs = tops.dct_cs(nr_samples)

    def compress(self, src) -> bytes:
        centred, means = self._centred(src)
        dct = native.dct_forward(centred, self._cos, self._cs, self.QUALITY,
                                 self.nthreads)
        flat = native.xor_encode(native.offset32(
            native.delta_encode(dct.reshape(-1)), -128))
        return self._container(native.plane_split(flat, self.nr_planes),
                               _means_header(means))

    def _postprocess(self, planes, header) -> bytes:
        c = self.cfg
        coef = native.delta_decode(native.offset32(native.xor_decode(
            native.plane_merge(planes)), 128))
        return self._uncentred(native.dct_inverse(
            coef.reshape(c.nr_channels, c.nr_samples), self._cos_t, self._cs,
            self.QUALITY, self.nthreads), header)
