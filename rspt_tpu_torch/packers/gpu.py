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
pyref copy), then merges planes and undoes xor, offset and delta as
torch ops on the packer's device.

The packer's state is its config and the plane count, which grows
(and stays grown) when the xdelta values of a payload do not fit
(signal_packer_xdelta_hzr.cpp:59-71). ``stage_seconds`` holds the wall
time of each stage of the last call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..hzr import pyref
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


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU
    fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rspt_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the kernels' plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def block_layout(plane_len: int, nr_planes: int):
    """(blocks per plane, (nr_planes * nb_per,) block lengths)."""
    nb_per = max(1, -(-plane_len // tc.B))
    lengths = np.full(nr_planes * nb_per, tc.B, np.int32)
    if plane_len % tc.B:
        lengths[nb_per - 1::nb_per] = plane_len % tc.B
    return nb_per, lengths


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
                 nr_samples: int, nr_bytes_to_encode: int, device=None):
        self.cfg = PackerConfig(bytes_per_sample, nr_channels, nr_samples)
        self.nr_planes = int(nr_bytes_to_encode)
        self.device = resolve_device(device)
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
        streams = self._entropy_streams(tokw, bwords, hist_np, times)
        return _container(self.METHOD, b"", streams)

    def _entropy_streams(self, tokw, bwords, hist_np, times):
        nb_per, lengths = block_layout(self.cfg.plane_len, self.nr_planes)
        t0 = time.perf_counter()
        plan = tc.flat_plan(hist_np, lengths)
        t1 = time.perf_counter()
        times["tables"] = t1 - t0

        words = tc.pack_tokens_flat(
            tokw, self._to_dev(plan.bases), plan.T, self._to_dev(plan.ntok),
            self._to_dev(plan.bit0), self._to_dev(plan.lut), plan.nwords)
        copy_rows = np.flatnonzero(plan.is_copy)
        copy_len = np.where(plan.is_copy, lengths, 0).astype(np.int64)
        copy_np = np.zeros(0, np.uint8)
        if copy_rows.size:
            raw = bwords[self._to_dev(copy_rows)].cpu().numpy().view(np.uint8)
            copy_np = np.concatenate([raw[j, :lengths[b]]
                                      for j, b in enumerate(copy_rows)])
        tight = words.cpu().numpy().view(np.uint8)[:plan.total_payload].copy()
        t2 = time.perf_counter()
        times["pack"] = t2 - t1

        hoff, comp_len = plan.hoff, plan.comp_len
        for i in np.flatnonzero(comp_len):
            dlen = min(tc.DESC_STRIDE, int(comp_len[i]))
            tight[hoff[i]:hoff[i] + dlen] |= plan.desc_bytes[i, :dlen]
        fill_byte = tc.fill_bytes_from_hist(hist_np)
        coff = np.cumsum(copy_len) - copy_len
        streams = []
        for k in range(self.nr_planes):
            s = slice(k * nb_per, (k + 1) * nb_per)
            streams.append(tc.assemble_compact(
                lengths[s], tight[hoff[s.start]:], comp_len[s],
                copy_np[coff[s.start]:], copy_len[s], plan.is_fill[s],
                fill_byte[s]))
        times["assemble"] = time.perf_counter() - t2
        return streams

    def decompress(self, comp) -> Tuple[bytes, int]:
        """Returns (native bytes, bytes of comp consumed)."""
        c = self.cfg
        times = self.stage_seconds = {}
        t0 = time.perf_counter()
        src = memoryview(comp).cast("B")
        if src[0] != self.METHOD:
            raise ValueError("unsupported compression method")
        pos = 1
        planes = np.empty((self.nr_planes, c.plane_len), np.uint8)
        for k in range(self.nr_planes):
            clen = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
            planes[k] = np.frombuffer(
                pyref.decode(bytes(src[pos:pos + clen]), c.plane_len),
                np.uint8, count=c.plane_len)
            pos += clen
        t1 = time.perf_counter()
        times["decode"] = t1 - t0
        merged = tops.plane_merge(self._to_dev(planes))
        flat = tops.delta_decode(tops.offset32(tops.xor_decode(merged), 128))
        out = tops.i32_to_native(flat.reshape(c.nr_channels, c.nr_samples),
                                 c.bytes_per_sample).cpu().numpy().tobytes()
        times["postprocess"] = time.perf_counter() - t1
        return out, pos
