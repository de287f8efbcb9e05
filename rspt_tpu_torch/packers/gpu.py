"""GPU packers — the port of rspt_tpu/packers/tpu.py's TpuHzrPacker
(:726-749), TpuXdeltaHzrPacker (:752-903, compress_many :811-885),
TpuDctPacker (:971-1043) and TpuHadamardPacker (:1065-1116);
byte-identical containers.

compress, device passes with host work between them:
  pass 1: the packer's preprocessing on the device (one xdelta_swizzle
      launch on the '<i4' words or the native bytes at any bps, with its
      verify-and-grow flag; native_to_i32 for hzr; means, centring, then
      fwht and the power-of-two quantization for Hadamard, or dct_forward
      and the flat delta/offset/xor for DCT), then tokenize_planes (RLE
      token words, plane bytes, histograms); one device→host copy of the
      histograms (and the flag, or the row sums).
  host: per-block Huffman tables and the exact stream layout.
  pass 2: compact_tokens → pack_flat (pack_flat_lanes with hints),
      straight into the final payload layout; one device→host copy of the
      payload words (and of the raw plane bytes of COPY blocks).
  host: tree descriptions OR-merged, headers, CRC32C, concatenation.

compress_many (the serving path, xdelta_hzr) does the same for a batch
of payloads of one shape: one upload, then for each plane count it
probes one xdelta_swizzle_batch and one tokenize_planes launch over the
whole batch, and the entropy stage in waves of 4 payloads whose host
tables overlap the card's pack of the wave before.

With an ``encoder`` (parallel.mesh.ShardedHzrEncoder), pass 1 runs as
above on the packer's device, then the planes' block bytes go to the
host and the encoder's shards take pass 2 (tpu.py:363-391): its flat
route where it does not decline, else its compact route, then one
assembly a stream; compress_with_hints gives no hints there.

With plane_backend 'lz4' or 'lz4hc' (container.PLANE_LZ4 in the method
byte; packers/host.py:53-72 of the reference), pass 1 runs as above on
the device without tokenize_planes (the xdelta packer: one xdelta_swizzle
a plane count probed), the planes are split on the device (plane_split)
and copied to the host in one copy, and one call of the host runtime
codes them as LZ4 blocks, a plane a thread (greedy, or hash chains with
lazy matching): the reference's bytes.

decompress dispatches on the masked method byte, whatever backend the
packer was built with. It decodes every plane's hzr stream on the host,
all blocks of all planes in one call of the port's host runtime
(rspt_tpu_torch/native), or, with device_decode, all planes' HUFF
blocks in one device decode (hzr/gpu_decoder.py: hzr_decode +
place_literals); an LZ4 container's planes in one runtime call (with
device_decode too). Then it merges planes and undoes the packer's
preprocessing as torch ops (and fwht, or dct_inverse) on the packer's
device. decompress_many puts every hzr payload's planes into one
device decode.

``stage_seconds`` holds the wall time of each stage of the last call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..hzr import gpu_decoder
from ..hzr import torch_coder as tc
from ..native import bindings as native
from ..ops import cuda_kernels as ck
from ..ops import torch_ops as tops
from .container import METHOD_MASK, PLANE_BACKENDS, PLANE_LZ4, container


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


def _as_words(src, bps: int) -> np.ndarray:
    """Writable host copy of the input: '<i4' words when they are the
    samples exactly (bps 4), else the u8 bytes."""
    flat = (np.frombuffer(memoryview(src).cast("B"), np.uint8)
            if not isinstance(src, np.ndarray) else src.reshape(-1))
    if bps == 4 and flat.dtype == np.uint8 and flat.nbytes % 4 == 0:
        flat = flat.view("<i4")
    return np.array(flat, copy=True)


def _means_header(means: np.ndarray) -> bytes:
    """Per-channel 24-bit little-endian means (signal_packer_dct.cpp:120-126;
    the port's copy of packers/host.py:161-168)."""
    m = means.astype(np.uint32)
    out = np.zeros((m.size, 3), dtype=np.uint8)
    out[:, 0] = m & 0xFF
    out[:, 1] = (m >> np.uint32(8)) & 0xFF
    out[:, 2] = (m >> np.uint32(16)) & 0xFF
    return out.tobytes()


def _means_from_header(header: bytes, nr_channels: int) -> np.ndarray:
    """Inverse of _means_header, sign-extended from bit 23
    (packers/host.py:171-175)."""
    b = np.frombuffer(header, np.uint8).reshape(nr_channels, 3).astype(
        np.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    v = np.where(v >= 1 << 23, v - (1 << 24), v)
    return v.astype(np.int32)


def _xdelta_decode(merged: torch.Tensor) -> torch.Tensor:
    """The flat xdelta inverse: xor decode, offset +128, delta decode."""
    return tops.delta_decode(tops.offset32(tops.xor_decode(merged), 128))


class _GpuPackerBase:
    """What the packers share (tpu.py:659-723): config, device, the
    container's streams and header, and the N-plane entropy encode and
    decode on the host or the device, with hzr or LZ4 planes. A subclass
    sets METHOD, nr_planes and header_size and writes compress and
    _postprocess."""

    METHOD = 0

    def __init__(self, bytes_per_sample: int, nr_channels: int,
                 nr_samples: int, device=None, device_decode: bool = False,
                 encoder=None, plane_backend: str = "hzr"):
        if plane_backend not in PLANE_BACKENDS:
            raise ValueError(f"unknown plane backend {plane_backend!r}")
        if encoder is not None and plane_backend != "hzr":
            raise ValueError("encoder= shards the hzr plane codec; "
                             f"plane_backend={plane_backend!r} takes none")
        self.cfg = PackerConfig(bytes_per_sample, nr_channels, nr_samples)
        self.device = resolve_device(device)
        self.plane_backend = plane_backend
        # the method byte of this packer's containers
        self._method = self.METHOD | (0 if plane_backend == "hzr"
                                      else PLANE_LZ4)
        # pass 2 over a mesh's shards (parallel.mesh.ShardedHzrEncoder)
        self._encoder = encoder
        # entropy-decode on the device (hzr_decode + place_literals)
        # instead of the host runtime
        self.device_decode = device_decode
        self.header_size = 0
        # what the last device decode did (gpu_decoder.decode_device)
        self.decode_info: dict = {}
        self.stage_seconds: Dict[str, float] = {}
        # pinned host buffers of the device<->host copies, kept across calls
        self._host = tc.HostStaging()

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _check_method(self, method: int) -> None:
        if method & METHOD_MASK != self.METHOD:
            raise ValueError("unsupported compression method")

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """A uint8 device tensor on the host in one copy (flat; on the
        card into a pinned buffer that the next fetch reuses)."""
        t = t.reshape(-1)
        if self.device.type != "cuda":
            return t.numpy()
        host = self._host.take("lz4", t.numel(), torch.uint8)
        host.copy_(t)
        return host.numpy()

    def _lz4_streams(self, planes: np.ndarray) -> List[bytes]:
        """The LZ4 blocks of the host planes' rows, in one runtime call."""
        t0 = time.perf_counter()
        streams = native.lz4_encode_planes(
            planes.reshape(-1, self.cfg.plane_len),
            self.plane_backend == "lz4hc")
        self.stage_seconds["lz4"] = time.perf_counter() - t0
        return streams

    def _entropy(self, flat: torch.Tensor, t0: float, header: bytes = b"",
                 want_hints: bool = False):
        """(container, hints) of the flat int32 signal's nr_planes planes;
        the stage pass1 ends here (t0 its start). hzr: tokenize_planes,
        then _encode. LZ4: the planes split on the device, one copy to
        the host (stage fetch), one runtime call; no hints."""
        if self.plane_backend == "hzr":
            hist_np, tokw, bwords = self._tokenize(flat.reshape(-1))
            self.stage_seconds["pass1"] = time.perf_counter() - t0
            return self._encode(tokw, bwords, hist_np, header, want_hints)
        planes = tops.plane_split(flat.reshape(-1), self.nr_planes)
        t1 = time.perf_counter()
        self.stage_seconds["pass1"] = t1 - t0
        host = self._fetch(planes)
        self.stage_seconds["fetch"] = time.perf_counter() - t1
        return container(self._method, header,
                         self._lz4_streams(host)), None

    def _tokenize(self, flat: torch.Tensor):
        """tokenize_planes of a flat int32 signal; (hist on the host,
        token words, plane words)."""
        tokw, bwords, hist = ck.tokenize_planes(flat, self.nr_planes)
        return hist.cpu().numpy(), tokw, bwords

    def _sharded_streams(self, bwords, nr_streams: int) -> List[bytes]:
        """nr_streams plane streams of the tokenized planes' blocks
        through the encoder's shards (tpu.py:363-391): the block bytes to
        the host, encode_blocks_flat unless it declines, else
        encode_blocks_compact, then one assembly a stream."""
        t0 = time.perf_counter()
        nb_per, lengths = tc.block_layout(self.cfg.plane_len, nr_streams)
        blocks = bwords.view(torch.uint8).cpu().numpy()
        res = self._encoder.encode_blocks_flat(blocks, lengths)
        if res is None:
            res = self._encoder.encode_blocks_compact(blocks, lengths)
        t1 = time.perf_counter()
        streams = tc.plane_streams(res[0], nb_per, nr_streams, *res[1:])
        self.stage_seconds.update(shards=t1 - t0,
                                  assemble=time.perf_counter() - t1)
        return streams

    def _encode(self, tokw, bwords, hist_np, header: bytes = b"",
                want_hints: bool = False):
        """Container of the tokenized planes: (container, hints; None
        with an encoder)."""
        if self._encoder is not None:
            return container(self.METHOD, header, self._sharded_streams(
                bwords, self.nr_planes)), None
        streams, hints = tc.entropy_streams(
            tokw, bwords, hist_np.reshape(-1, tc.NUM_SYMBOLS),
            self.cfg.plane_len, self.nr_planes, self.stage_seconds,
            want_hints, self._host)
        return container(self.METHOD, header, streams), hints

    def _streams(self, comp, nr_planes: int, header_size: int
                 ) -> Tuple[bytes, List[bytes], int]:
        """The container's header, its plane streams and the bytes it
        spans."""
        src = memoryview(comp).cast("B")
        self._check_method(src[0])
        header = bytes(src[1:1 + header_size])
        pos = 1 + header_size
        streams = []
        for _ in range(nr_planes):
            clen = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
            streams.append(bytes(src[pos:pos + clen]))
            pos += clen
        return header, streams, pos

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

    def _decode_planes(self, comp) -> Tuple[bytes, torch.Tensor, int]:
        """The container's header, its (nr_planes, plane_len) uint8
        planes on the device and the bytes it spans. LZ4 planes: every
        plane in one call of the host runtime (stage lz4), then one
        upload. hzr: decoded on the device (device_decode) or on the
        host, every plane's blocks in one call of the host runtime
        (tpu.py:711-720)."""
        buf = np.frombuffer(memoryview(comp).cast("B"), np.uint8)
        self._check_method(buf[0])
        if self.device_decode and not buf[0] & PLANE_LZ4:
            header, streams, pos = self._streams(comp, self.nr_planes,
                                                 self.header_size)
            return header, self._decode_device(streams)[0], pos
        t0 = time.perf_counter()
        start = 1 + self.header_size
        decode = (native.lz4_decode_planes if buf[0] & PLANE_LZ4
                  else native.decode_planes_blocks)
        planes, used = decode(buf[start:], self.nr_planes,
                              self.cfg.plane_len)
        t1 = time.perf_counter()
        planes = self._to_dev(planes)
        self.stage_seconds.update(
            {"lz4" if buf[0] & PLANE_LZ4 else "decode": t1 - t0,
             "upload": time.perf_counter() - t1})
        return buf[1:start].tobytes(), planes, start + used

    def _postprocess(self, planes: torch.Tensor, header: bytes) -> bytes:
        raise NotImplementedError

    def _centred(self, src) -> Tuple[torch.Tensor, np.ndarray]:
        """The transform packers' start: the (channels, samples) int32
        signal minus the reference's per-channel means (int32 wrap), and
        the means. The mean: an int64 row sum on the device, its unsigned
        64-bit division on the host."""
        c = self.cfg
        raw = self._to_dev(_as_words(src, c.bytes_per_sample))
        sig = tops.native_to_i32(raw, c.nr_samples, c.nr_channels,
                                 c.bytes_per_sample).contiguous()
        means = tops.average32_host(tops.row_sums64(sig).cpu().numpy(),
                                    c.nr_samples)
        return tops._wrap32(sig.to(torch.int64) - self._to_dev(
            means.astype(np.int64))[:, None]), means

    def _uncentred(self, rec: torch.Tensor, header: bytes) -> bytes:
        """rec plus the header's means (int32 wrap), as native bytes."""
        means = _means_from_header(header, self.cfg.nr_channels)
        return self._native(tops._wrap32(rec.to(torch.int64) + self._to_dev(
            means.astype(np.int64))[:, None]))

    def _native(self, sig: torch.Tensor) -> bytes:
        """(channels, samples) int32 → native sample bytes on the host."""
        return tops.i32_to_native(
            sig.reshape(self.cfg.nr_channels, self.cfg.nr_samples),
            self.cfg.bytes_per_sample).cpu().numpy().tobytes()

    def decompress(self, comp) -> Tuple[bytes, int]:
        """Returns (native bytes, bytes of comp consumed)."""
        self.stage_seconds = {}
        header, planes, pos = self._decode_planes(comp)
        t1 = time.perf_counter()
        out = self._postprocess(planes, header)
        self.stage_seconds["postprocess"] = time.perf_counter() - t1
        return out, pos

    def decompress_many(self, comps, hints=None, return_hints: bool = False):
        """Decompress several containers (rspt_tpu/packers/tpu.py:905-970);
        each output is what decompress gives. With device_decode, every
        hzr payload's plane streams share one lane batch: one hzr_decode
        and one place_literals launch in all; an LZ4 payload's planes
        decode in one host runtime call each. Otherwise the payloads
        decompress one at a time.

        hints / return_hints (device_decode only): DecodeHints from an
        earlier decode of the same hzr streams, or from
        compress_with_hints, skip the alignment fixpoint; they cover the
        batch's hzr payloads alone. return_hints=True returns (outs,
        hints; None when no payload is hzr)."""
        if not self.device_decode:
            outs = [self.decompress(cp)[0] for cp in comps]
            return (outs, None) if return_hints else outs
        self.stage_seconds = {}
        planes = [None] * len(comps)
        headers, streams, hzr = [None] * len(comps), [], []
        for i, comp in enumerate(comps):
            if memoryview(comp).cast("B")[0] & PLANE_LZ4:
                headers[i], planes[i], _ = self._decode_planes(comp)
                continue
            headers[i], s, _ = self._streams(comp, self.nr_planes,
                                             self.header_size)
            streams += s
            hzr.append(i)
        h = None
        if hzr:
            dec, h = self._decode_device(streams, hints, return_hints)
            for i, p in zip(hzr, dec.reshape(len(hzr), self.nr_planes, -1)):
                planes[i] = p
        t1 = time.perf_counter()
        outs = [self._postprocess(p, hd) for p, hd in zip(planes, headers)]
        self.stage_seconds["postprocess"] = time.perf_counter() - t1
        return (outs, h) if return_hints else outs


class GpuHzrPacker(_GpuPackerBase):
    """Lossless 4-plane packer with no preprocessing
    (signal_packer_hzr.cpp:39-65). Method byte 0."""

    METHOD = 0
    NR_PLANES = 4

    def __init__(self, bytes_per_sample, nr_channels, nr_samples, **kw):
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = self.NR_PLANES

    def compress(self, src) -> bytes:
        c = self.cfg
        self.stage_seconds = {}
        t0 = time.perf_counter()
        raw = self._to_dev(_as_words(src, c.bytes_per_sample))
        sig = tops.native_to_i32(raw, c.nr_samples, c.nr_channels,
                                 c.bytes_per_sample)
        return self._entropy(sig, t0)[0]

    def _postprocess(self, planes: torch.Tensor, header: bytes) -> bytes:
        return self._native(tops.plane_merge(planes))


class GpuXdeltaHzrPacker(_GpuPackerBase):
    """Lossless delta → offset → xor packer with verify-and-grow
    (signal_packer_xdelta_hzr.cpp:34-88). Method byte 0. The plane count
    grows (and stays grown) when its planes would not give back every
    native sample of a payload (signal_packer_xdelta_hzr.cpp:59-71):
    only the low 8 * bytes_per_sample bits of each value must survive the
    sign-extending plane merge."""

    METHOD = 0

    def __init__(self, bytes_per_sample: int, nr_channels: int,
                 nr_samples: int, nr_bytes_to_encode: int, **kw):
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = int(nr_bytes_to_encode)

    def _pass1(self, raw: torch.Tensor):
        """One xdelta_swizzle launch on the '<i4' words (bps 4) or the
        native bytes (any bps), then the tokenizer."""
        c = self.cfg
        enc, ok = ck.xdelta_swizzle(raw, c.nr_samples, c.nr_channels,
                                    self.nr_planes, c.bytes_per_sample)
        tokw, bwords, hist = ck.tokenize_planes(enc, self.nr_planes)
        small = torch.cat([hist.reshape(-1), ok]).cpu().numpy()
        return small, tokw, bwords

    def _compress(self, src, want_hints: bool):
        c = self.cfg
        self.stage_seconds = {}
        t0 = time.perf_counter()
        raw = self._to_dev(_as_words(src, c.bytes_per_sample))
        if self.plane_backend != "hzr":
            # one xdelta_swizzle a plane count probed, no tokenizer
            while True:
                enc, ok = ck.xdelta_swizzle(raw, c.nr_samples, c.nr_channels,
                                            self.nr_planes,
                                            c.bytes_per_sample)
                if ok.item():
                    return self._entropy(enc, t0)
                self.nr_planes += 1
        while True:
            small, tokw, bwords = self._pass1(raw)
            if small[-1]:
                break
            self.nr_planes += 1
        self.stage_seconds["pass1"] = time.perf_counter() - t0
        return self._encode(tokw, bwords, small[:-1], want_hints=want_hints)

    def compress(self, src) -> bytes:
        return self._compress(src, False)[0]

    def _upload_batch(self, srcs) -> torch.Tensor:
        """The payloads stacked into one (batch, words or bytes) host
        array (pinned on the card) and uploaded in one copy."""
        c = self.cfg
        rows = [_as_words(s, c.bytes_per_sample) for s in srcs]
        need = c.native_size // rows[0].itemsize
        if any(r.size < need for r in rows):
            raise ValueError(f"compress_many: every payload needs "
                             f"{c.native_size} bytes")
        dtype = torch.from_numpy(rows[0][:0]).dtype
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack([r[:need] for r in rows]))
        buf = self._host.take("upload", len(rows) * need, dtype)
        host = buf.numpy().reshape(len(rows), need)
        for h, r in zip(host, rows):
            h[:] = r[:need]
        return buf.reshape(len(rows), need).to(self.device, non_blocking=True)

    def compress_many(self, srcs) -> List[bytes]:
        """Compress a batch of same-shape payloads, the serving path
        (tpu.py:811-885); each container equals what a sequential run of
        compress() on this packer gives, verify-and-grow included: a
        payload that grows the plane count grows it for every later
        payload and never for an earlier one
        (signal_packer_xdelta_hzr.cpp:59-71), by the reference's rule (F1).

        One upload of the stacked payloads; for each plane count probed
        (from nr_planes up, until every payload fits) one
        xdelta_swizzle_batch and one tokenize_planes launch over the
        whole batch. A level that every payload takes goes through the
        pipelined entropy stage when the batch is larger than 4 (waves of
        4), else one entropy_streams call; a level that only some take
        selects their rows on the device first. compress_many([]) is []
        and touches no device. ``stage_seconds``: pass1 (upload and
        probes), then tables, pack, wait and assemble. With an encoder,
        each level's payload x plane streams go through its shards in
        one call (stage_seconds shards and assemble). With LZ4 planes, a
        probe is the xdelta_swizzle_batch alone (the xdelta values do not
        depend on the plane count), then every payload's planes go to
        the host in one copy (stage fetch) and through one runtime call
        (stage lz4)."""
        c = self.cfg
        batch = len(srcs)
        if batch == 0:
            return []
        self.stage_seconds = {}
        t0 = time.perf_counter()
        raw = self._upload_batch(srcs)
        lz4 = self.plane_backend != "hzr"
        levels = {}
        minfit = np.full(batch, -1, np.int64)
        p = self.nr_planes
        while True:
            enc, ok = ck.xdelta_swizzle_batch(raw, c.nr_samples,
                                              c.nr_channels, p,
                                              c.bytes_per_sample)
            if lz4:
                small = ok.cpu().numpy()
            else:
                tokw, bwords, hist = ck.tokenize_planes(enc, p)
                small = torch.cat([hist.reshape(-1), ok]).cpu().numpy()
                levels[p] = (tokw, bwords,
                             small[:-batch].reshape(-1, tc.NUM_SYMBOLS))
            minfit[(minfit < 0) & (small[-batch:] != 0)] = p
            if (minfit >= 0).all() or p >= 4:
                minfit[minfit < 0] = p      # 4 planes always fit
                break
            p += 1
        # sequential-call semantics: the plane count only ever grows
        plane_of = np.maximum.accumulate(minfit)
        self.nr_planes = int(plane_of[-1])
        if lz4:     # every probe gives the same xdelta values
            return self._many_lz4(enc, plane_of, t0)
        self.stage_seconds["pass1"] = time.perf_counter() - t0

        nb_per, _ = tc.block_layout(c.plane_len, 1)
        containers: List[bytes] = [b""] * batch
        for lvl in sorted(set(plane_of.tolist())):
            idx = np.flatnonzero(plane_of == lvl)
            tokw, bwords, hist_np = levels[lvl]
            if idx.size < batch:
                nbp = lvl * nb_per
                rows = (idx[:, None] * nbp + np.arange(nbp)).reshape(-1)
                rows_d = self._to_dev(rows)
                tokw = tokw.index_select(0, rows_d)
                bwords = bwords.index_select(0, rows_d)
                hist_np = hist_np[rows]
            if self._encoder is not None:
                streams = self._sharded_streams(bwords, idx.size * lvl)
            elif idx.size == batch and batch > tc.WAVE:
                streams = tc.entropy_streams_pipelined(
                    tokw, bwords, hist_np, c.plane_len, batch, lvl,
                    self.stage_seconds, self._host)
            else:
                streams, _ = tc.entropy_streams(
                    tokw, bwords, hist_np, c.plane_len, idx.size * lvl,
                    self.stage_seconds, host=self._host)
            for j, b in enumerate(idx):
                containers[b] = container(self.METHOD, b"",
                                          streams[j * lvl:(j + 1) * lvl])
        return containers

    def _many_lz4(self, enc: torch.Tensor, plane_of: np.ndarray,
                  t0: float) -> List[bytes]:
        """compress_many's LZ4 containers: each payload's plane_of planes
        of its xdelta values (enc (batch, plane_len) on the device) split
        on the device, all of them copied to the host in one copy and
        LZ4-coded in one runtime call."""
        planes = torch.cat([tops.plane_split(e, int(lvl)).reshape(-1)
                            for e, lvl in zip(enc, plane_of)])
        t1 = time.perf_counter()
        self.stage_seconds["pass1"] = t1 - t0
        host = self._fetch(planes)
        self.stage_seconds["fetch"] = time.perf_counter() - t1
        streams = self._lz4_streams(host)
        ends = np.cumsum(plane_of)
        return [container(self._method, b"",
                          streams[e - lvl:e])
                for e, lvl in zip(ends.tolist(), plane_of.tolist())]

    def compress_with_hints(self, src):
        """compress() plus the encode-time decode hints (hzr/sidecar.py):
        returns (container, DecodeHints or None). The container equals
        compress()'s. The hints cover decompress_many([container]) on a
        device_decode packer, whose first decode then runs one trusted
        sweep instead of the alignment fixpoint; they are also
        registered with the decoder. Every HUFF block gets hints, COPY
        blocks or not (the JAX packer gives None when a batch has a COPY
        block); None when no block is HUFF, with an encoder
        (tpu.py:345-348), and with LZ4 planes (no HUFF block)."""
        return self._compress(src, True)

    def _postprocess(self, planes: torch.Tensor, header: bytes) -> bytes:
        """Plane merge and the xdelta inverse on the device."""
        return self._native(_xdelta_decode(tops.plane_merge(planes)))


class GpuHadamardPacker(_GpuPackerBase):
    """Lossy Walsh-Hadamard packer (signal_packer_hadamard.cpp:35-107):
    method byte 2, 3 planes, quality 1, a 24-bit per-channel means
    header. nr_samples must be a power of two."""

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
        c = self.cfg
        self.stage_seconds = {}
        t0 = time.perf_counter()
        centred, means = self._centred(src)
        had = tops.fwht_normalize_pow2(ck.fwht(centred), c.nr_samples,
                                       self.QUALITY)
        return self._entropy(had, t0, _means_header(means))[0]

    def _postprocess(self, planes: torch.Tensor, header: bytes) -> bytes:
        c = self.cfg
        had = tops.plane_merge(planes).reshape(c.nr_channels, c.nr_samples)
        return self._uncentred(
            tops.fwht_normalize2_int(ck.fwht(had), self.QUALITY), header)


class GpuDctPacker(_GpuPackerBase):
    """Lossy DCT packer (signal_packer_dct.cpp:36-156): method byte 1, 2
    planes, quality 128, a 24-bit per-channel means header; any
    nr_samples >= 1. The transform is the reference's exact one (each
    output a serial f64 sum in its order): dct_forward and dct_inverse,
    one launch each on the card. The packer builds its cosine tables on
    the host once (float32 from np.cos in f64, as the reference builds
    them; 64 MiB each at 4,096 samples) and uploads them once. The tail
    is xdelta's over the flat (channels * samples) coefficients, across
    channel borders (tpu.py:308-310)."""

    METHOD = 1
    NR_PLANES = 2
    QUALITY = 128.0

    def __init__(self, bytes_per_sample, nr_channels, nr_samples, **kw):
        if nr_samples < 1:
            raise ValueError("DCT packer: nr_samples must be >= 1")
        super().__init__(bytes_per_sample, nr_channels, nr_samples, **kw)
        self.nr_planes = self.NR_PLANES
        self.header_size = 3 * nr_channels
        cos = tops.dct_cos_table(nr_samples)
        cs = tops.dct_cs(nr_samples)
        self._cos = self._to_dev(cos)
        self._cos_t = self._to_dev(cos.T)      # COS[i][x] at [x][i]
        self._cs = self._to_dev(cs)
        self._fwd_scale = self._to_dev(tops.dct_forward_scale(
            cs, self.QUALITY))
        self._inv_scale = tops.dct_inverse_scale(nr_samples, self.QUALITY)

    def compress(self, src) -> bytes:
        self.stage_seconds = {}
        t0 = time.perf_counter()
        centred, means = self._centred(src)
        dct = ck.dct_forward(centred, self._cos, self._fwd_scale)
        flat = tops.xor_encode(tops.offset32(
            tops.delta_encode(dct.reshape(-1)), -128))
        return self._entropy(flat, t0, _means_header(means))[0]

    def _postprocess(self, planes: torch.Tensor, header: bytes) -> bytes:
        c = self.cfg
        coef = _xdelta_decode(tops.plane_merge(planes))
        return self._uncentred(ck.dct_inverse(
            coef.reshape(c.nr_channels, c.nr_samples), self._cos_t,
            self._cs, self._inv_scale), header)
