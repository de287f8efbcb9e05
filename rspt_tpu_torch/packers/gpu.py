"""GPU xdelta_hzr packer — the port of rspt_tpu/packers/tpu.py's
TpuXdeltaHzrPacker (:752-782, :887-903), byte-identical containers.

compress, two device passes with host work between them:
  pass 1: xdelta_swizzle (delta → offset −128 → xor and the
      verify-and-grow flag) → tokenize_planes (RLE token words, plane
      bytes, histograms); one device→host copy of the histograms and
      the flag.
  host: per-block Huffman tables and the exact stream layout.
  pass 2: compact_tokens → pack_flat, straight into the final payload
      layout; one device→host copy of the payload words (and of the
      raw plane bytes of COPY blocks).
  host: tree descriptions OR-merged, headers, CRC32C, concatenation.

decompress decodes each plane's hzr stream on the host (the port's
pyref copy) or, with device_decode, all planes' HUFF blocks in one
device decode (hzr/gpu_decoder.py: hzr_decode + place_literals), then
merges planes and undoes xor, offset and delta as torch ops on the
packer's device. decompress_many puts every payload's planes into one
device decode.

The packer's state is its config and the plane count, which grows
(and stays grown) when the xdelta values of a payload do not fit
(signal_packer_xdelta_hzr.cpp:59-71). ``stage_seconds`` holds the wall
time of each stage of the last call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..hzr import gpu_decoder, pyref
from ..hzr import torch_coder as tc
from ..ops import cuda_kernels as ck
from ..ops import torch_ops as tops


@dataclass
class PackerConfig:
    bytes_per_sample: int
    nr_channels: int
    nr_samples: int

    @property
    def native_size(self) -> int:
        return self.bytes_per_sample * self.nr_channels * self.nr_samples

    @property
    def plane_len(self) -> int:
        return self.nr_channels * self.nr_samples


def _container(method: int, header: bytes, streams) -> bytes:
    parts = [bytes([method]), header]
    for stream in streams:
        parts.append(len(stream).to_bytes(4, "little"))
        parts.append(stream)
    return b"".join(parts)


def _as_words(src, bps: int) -> np.ndarray:
    """Writable host copy of the input: '<i4' words when they are the
    samples exactly (bps 4), else the u8 bytes."""
    flat = (np.frombuffer(memoryview(src).cast("B"), np.uint8)
            if not isinstance(src, np.ndarray) else src.reshape(-1))
    if bps == 4 and flat.dtype == np.uint8 and flat.nbytes % 4 == 0:
        flat = flat.view("<i4")
    return np.array(flat, copy=True)


class GpuXdeltaHzrPacker:
    """Lossless delta → offset → xor packer with verify-and-grow
    (signal_packer_xdelta_hzr.cpp:34-88). Method byte 0."""

    METHOD = 0

    def __init__(self, bytes_per_sample: int, nr_channels: int,
                 nr_samples: int, nr_bytes_to_encode: int, device=None,
                 device_decode: bool = False):
        self.cfg = PackerConfig(bytes_per_sample, nr_channels, nr_samples)
        self.nr_planes = int(nr_bytes_to_encode)
        self.device = resolve_device(device)
        # entropy-decode on the device (hzr_decode + place_literals)
        # instead of the host's pyref copy
        self.device_decode = device_decode
        # what the last device decode did (gpu_decoder.decode_device)
        self.decode_info: dict = {}
        self.stage_seconds: Dict[str, float] = {}

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _pass1(self, raw: torch.Tensor):
        c = self.cfg
        if raw.dtype == torch.int32:
            enc, ok = ck.xdelta_swizzle(raw, c.nr_samples, c.nr_channels,
                                        self.nr_planes, swizzle=True)
        else:
            sig = tops.native_to_i32(raw, c.nr_samples, c.nr_channels,
                                     c.bytes_per_sample).reshape(-1)
            enc, ok = ck.xdelta_swizzle(sig, c.nr_samples, c.nr_channels,
                                        self.nr_planes, swizzle=False)
        tokw, bwords, hist = ck.tokenize_planes(enc, self.nr_planes)
        small = torch.cat([hist.reshape(-1), ok]).cpu().numpy()
        return small, tokw, bwords

    def compress(self, src) -> bytes:
        c = self.cfg
        times = self.stage_seconds = {}
        t0 = time.perf_counter()
        raw = self._to_dev(_as_words(src, c.bytes_per_sample))
        while True:
            small, tokw, bwords = self._pass1(raw)
            if small[-1]:
                break
            self.nr_planes += 1
        times["pass1"] = time.perf_counter() - t0
        hist_np = small[:-1].reshape(-1, tc.NUM_SYMBOLS)
        streams = tc.entropy_streams(tokw, bwords, hist_np, c.plane_len,
                                     self.nr_planes, times)
        return _container(self.METHOD, b"", streams)

    def _streams(self, comp) -> Tuple[List[bytes], int]:
        """The container's plane streams and the bytes it spans."""
        src = memoryview(comp).cast("B")
        if src[0] != self.METHOD:
            raise ValueError("unsupported compression method")
        pos = 1
        streams = []
        for _ in range(self.nr_planes):
            clen = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
            streams.append(bytes(src[pos:pos + clen]))
            pos += clen
        return streams, pos

    def _decode_device(self, streams, hints=None, return_hints=False):
        """Every stream's HUFF blocks in one device decode; returns
        (planes (len(streams), plane_len) uint8 on the device, hints)."""
        out, _, h, info = gpu_decoder.decode_device(
            streams, self.device, hints, return_hints)
        n = self.cfg.plane_len
        if out.numel() != len(streams) * n:
            raise ValueError("hzr: decoded size does not match the config")
        self.decode_info = info
        self.stage_seconds.update(info["times"])
        return out.reshape(len(streams), n), h

    def _postprocess(self, planes: torch.Tensor) -> bytes:
        """Plane merge and the xdelta inverse on the device."""
        c = self.cfg
        merged = tops.plane_merge(planes)
        flat = tops.delta_decode(tops.offset32(tops.xor_decode(merged), 128))
        return tops.i32_to_native(flat.reshape(c.nr_channels, c.nr_samples),
                                  c.bytes_per_sample).cpu().numpy().tobytes()

    def decompress(self, comp) -> Tuple[bytes, int]:
        """Returns (native bytes, bytes of comp consumed)."""
        c = self.cfg
        times = self.stage_seconds = {}
        streams, pos = self._streams(comp)
        if self.device_decode:
            planes, _ = self._decode_device(streams)
        else:
            t0 = time.perf_counter()
            planes = self._to_dev(np.stack([
                np.frombuffer(pyref.decode(s, c.plane_len), np.uint8,
                              count=c.plane_len) for s in streams]))
            times["decode"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = self._postprocess(planes)
        times["postprocess"] = time.perf_counter() - t1
        return out, pos

    def decompress_many(self, comps, hints=None, return_hints: bool = False):
        """Decompress several containers (rspt_tpu/packers/tpu.py:905-970).
        With device_decode, every payload's plane streams share one lane
        batch: one hzr_decode and one place_literals launch in all.
        Otherwise the payloads decompress one at a time.

        hints / return_hints (device_decode only): DecodeHints from an
        earlier decode of the same streams skip the alignment fixpoint;
        return_hints=True returns (outs, hints)."""
        if not self.device_decode:
            outs = [self.decompress(cp)[0] for cp in comps]
            return (outs, None) if return_hints else outs
        if not comps:
            return ([], None) if return_hints else []
        self.stage_seconds = {}
        streams = []
        for comp in comps:
            streams += self._streams(comp)[0]
        planes, h = self._decode_device(streams, hints, return_hints)
        planes = planes.reshape(len(comps), self.nr_planes, -1)
        t1 = time.perf_counter()
        outs = [self._postprocess(p) for p in planes]
        self.stage_seconds["postprocess"] = time.perf_counter() - t1
        return (outs, h) if return_hints else outs
