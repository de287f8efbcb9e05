"""Shards and the sharded hzr block codec (counterpart of
rspt_tpu/parallel/mesh.py).

Data parallelism over hzr's 64 KiB blocks, which code independently
(hzr_encode.c:528-539): a block batch is cut into contiguous runs, one a
shard, and each shard runs the port's kernels on its own device.

JAX runs one controller over every device; the port runs one process
per card or group of shards, as torch does. A ``Mesh`` is this
process's shards (``devices``; a device may repeat, so several shards
can share one card) and a torch.distributed process group (``group``)
whose every rank holds as many shards, or None in one process. Global
shard g = rank * local + i, and blocks go to shards in contiguous runs
in rank order. Only small host data crosses processes, over gloo on CPU
tensors: the block meta and the live payload bytes for assembly, and
one int32 a shard for the scans (scans.py). Within a process, tensors
move with ``.to(device)``.

Encode (``ShardedHzrEncoder``): each shard tokenizes its blocks
(torch_coder.tokenize_blocks), builds their Huffman tables on the host
and packs them, per block (K13a pack_blocks, then compact_payloads) or
flat (K3 compact_tokens, then K4/K5 pack_flat); only each shard's live
payload bytes reach the host, where the tree descriptions are ORed in.
COPY blocks' bytes come from the host's own copy of the input (every
rank holds the whole input, as in the JAX version). Every rank returns
the whole result, whose streams equal torch_coder.encode's.

Decode (``ShardedHzrDecoder``): the host walk and LUTs of
hzr/gpu_decoder.py, the HUFF blocks cut into contiguous runs balanced by
segment count, and each run decoded on its shard (K6 hzr_decode, K7
place_literals, ``gpu_decoder.decode_span``) into a buffer of its
output span; the host copies back each HUFF block's bytes. The decoder
runs over this process's shards.
"""

from __future__ import annotations

import logging
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..hzr import gpu_decoder as gd
from ..hzr import torch_coder as tc

AXIS = "blocks"

log = logging.getLogger("rspt_tpu_torch.parallel")


class Mesh:
    """This process's shards (``devices``, a torch.device each) and the
    process group over which every rank holds as many (``group``, or
    None in one process)."""

    def __init__(self, devices, group=None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1

    @property
    def local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of every process."""
        return self.world * self.local

    def shard_ids(self) -> range:
        """The global numbers of this process's shards."""
        return range(self.rank * self.local, (self.rank + 1) * self.local)


def _gloo(group):
    """group itself when it runs gloo, else a gloo group of its ranks (a
    collective call: every rank of group makes it)."""
    if "gloo" in str(dist.get_backend(group)).lower():
        return group
    return dist.new_group(dist.get_process_group_ranks(group),
                          backend="gloo")


def make_mesh(devices=None, group=None) -> Mesh:
    """A Mesh of ``devices`` (default: every visible card; raises when
    there is none; ``["cpu"] * k`` shards over the kernels' plain
    versions) and ``group`` (default: torch.distributed's default group
    when it is initialized, else one process). A group that does not run
    gloo is joined by a gloo group of its ranks, made here."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError(
                "rspt_tpu_torch: no CUDA device; pass devices=['cpu'] * k "
                "to shard over the kernels' plain PyTorch versions")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in devices}) != 1:
        raise ValueError("make_mesh: the shards' devices must be of one type")
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return Mesh(devices, None if group is None else _gloo(group))


def pad_blocks(nb: int, ndev: int) -> int:
    """Blocks padded so the batch divides the mesh."""
    return -(-nb // ndev) * ndev


def allgather(mesh: Mesh, arr: np.ndarray) -> np.ndarray:
    """arr of every rank, concatenated along axis 0 in rank order (arr
    itself in one process): two all_gathers over mesh.group, the sizes
    and the bytes. The row count may differ across ranks, the dtype and
    the row shape may not."""
    if mesh.group is None:
        return arr
    arr = np.ascontiguousarray(arr)
    flat = arr.reshape(-1).view(np.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.world)]
    dist.all_gather(sizes, torch.tensor([flat.size]), group=mesh.group)
    sizes = [int(s) for s in sizes]
    buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
    buf[:flat.size] = torch.from_numpy(flat)
    outs = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(outs, buf, group=mesh.group)
    whole = np.concatenate([o.numpy()[:k] for o, k in zip(outs, sizes)])
    return whole.view(arr.dtype).reshape(-1, *arr.shape[1:])


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

@dataclass
class _Shard:
    """One shard's blocks, on its device after tokenize_blocks."""
    device: torch.device
    lengths: np.ndarray      # (nb_loc,) int32, 0 for padding blocks
    blocks: torch.Tensor     # (nb_loc, B) uint8
    lengths_dev: torch.Tensor
    toks: tuple              # syms, extras, ebits, tvalid, hist
    hist: np.ndarray = None  # (nb_loc, 261) on the host


# the per-block columns a shard reports: payload bytes (HUFF), raw bytes
# (COPY), description + token bits, FILL flag, FILL byte
_COMP, _COPY, _BITS, _FILL, _BYTE = range(5)


class ShardedHzrEncoder:
    """hzr encode of a block batch cut over a mesh's shards: each shard
    tokenizes its blocks, gets their tables from the host and packs them
    on its device (mesh.py:349-611's contracts). ``stage_seconds``: the
    wall time of each stage of the last call (tokenize, tables, pack,
    fetch, gather)."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.stage_seconds = {}

    def _tokenized(self, blocks_np, lengths_np):
        """The local shards' runs of the batch padded with zero-length
        blocks to a multiple of the global shard count, tokenized (every
        launch first, then the histograms to the host)."""
        t0 = time.perf_counter()
        nb = blocks_np.shape[0]
        loc = pad_blocks(nb, self.mesh.size) // self.mesh.size
        shards = []
        for dev, g in zip(self.mesh.devices, self.mesh.shard_ids()):
            blk = np.zeros((loc, tc.B), np.uint8)
            ln = np.zeros(loc, np.int32)
            lo, hi = min(g * loc, nb), min((g + 1) * loc, nb)
            blk[:hi - lo] = blocks_np[lo:hi]
            ln[:hi - lo] = lengths_np[lo:hi]
            b, lnd = tc._to_device(blk, dev), tc._to_device(ln, dev)
            shards.append(_Shard(dev, ln, b, lnd, tc.tokenize_blocks(b, lnd)))
        for s in shards:
            s.hist = s.toks[4].cpu().numpy()
        self.stage_seconds = dict(tokenize=time.perf_counter() - t0)
        return shards

    def _tables(self, shards):
        """host_tables of every local shard's blocks in one call of the
        host runtime (a call costs ~2 ms beside its blocks' work), split
        a shard."""
        t0 = time.perf_counter()
        tables = tc.host_tables(np.concatenate([s.hist for s in shards]),
                                np.concatenate([s.lengths for s in shards]))
        loc = shards[0].lengths.size
        self._time("tables", t0)
        return [tuple(a[k * loc:(k + 1) * loc] for a in tables)
                for k in range(len(shards))]

    def _time(self, key, t0):
        t1 = time.perf_counter()
        self.stage_seconds[key] = self.stage_seconds.get(key, 0.0) + t1 - t0
        return t1

    def _compact_parts(self, blocks_np, lengths_np):
        """The local shards' tables, then per shard pack_blocks (K13a)
        and compact_payloads, then one copy of its meta and its HUFF
        payloads to the host, descriptions ORed in. Returns the global
        meta (nb, 5) and payload bytes."""
        shards = self._tokenized(blocks_np, lengths_np)
        staged = []
        for s, tables in zip(shards, self._tables(shards)):
            t0 = time.perf_counter()
            codes, cbits, desc_bytes, desc_bits, is_fill = tables
            _, comp_len, _, _ = tc.host_layout(s.hist, s.lengths, cbits,
                                               desc_bits, is_fill)
            packed, total_bits = tc.pack_blocks(*s.toks[:4], codes, cbits,
                                                desc_bits)
            data, meta = tc.compact_payloads(
                packed, s.blocks, total_bits, s.lengths_dev,
                tc._to_device(is_fill, s.device))
            ncomp = int(comp_len.sum())
            staged.append((torch.cat([meta.view(torch.uint8), data[:ncomp]]),
                           comp_len, desc_bytes, is_fill))
            self._time("pack", t0)
        t0 = time.perf_counter()
        metas, tights = [], []
        for s, (dev_bytes, comp_len, desc_bytes, is_fill) in zip(shards,
                                                                  staged):
            host = dev_bytes.cpu().numpy()
            m = host[:12 * comp_len.size].view(np.int32).reshape(3, -1)
            if not np.array_equal(m[0], comp_len):
                raise RuntimeError("sharded encode: the packed payload "
                                   "sizes differ from the tables'")
            tight = host[12 * comp_len.size:].copy()
            tc._or_descriptions(tight, comp_len, desc_bytes)
            metas.append(np.stack([m[0], m[1], m[2], is_fill,
                                   tc.fill_bytes_from_hist(s.hist)], 1))
            tights.append(tight)
        t0 = self._time("fetch", t0)
        return self._gathered(blocks_np.shape[0], metas, tights, t0)

    def _gathered(self, nb, metas, tights, t0):
        meta = allgather(self.mesh, np.concatenate(metas).astype(np.int64))
        tight = allgather(self.mesh, np.concatenate(tights))
        self._time("gather", t0)
        return meta[:nb], tight

    @staticmethod
    def _compact_tuple(blocks_np, lengths_np, meta, tight):
        """assemble_compact's arguments; COPY blocks' bytes from the
        host's blocks."""
        nb = meta.shape[0]
        copy_len = meta[:, _COPY]
        rows = np.flatnonzero(copy_len)
        copy_np = (np.concatenate([blocks_np[i, :copy_len[i]] for i in rows])
                   if rows.size else np.zeros(0, np.uint8))
        return (np.asarray(lengths_np[:nb]), tight, meta[:, _COMP], copy_np,
                copy_len, meta[:, _FILL].astype(bool),
                meta[:, _BYTE].astype(np.uint8))

    def encode_blocks(self, blocks_np: np.ndarray, lengths_np: np.ndarray):
        """assemble()'s inputs for a (nb, B) uint8 block batch: (packed
        (nb, B + 512) uint8, total_bits (nb,) int32, is_fill (nb,) bool)
        on the host, every rank the whole batch's. Each HUFF row holds
        its payload with the description ORed in (only those bytes cross
        to the host; the rest of a row is 0), total_bits is exact for
        every block."""
        meta, tight = self._compact_parts(blocks_np, lengths_np)
        comp_len = meta[:, _COMP]
        hoff = np.cumsum(comp_len) - comp_len
        packed = np.zeros((meta.shape[0], tc.B + 512), np.uint8)
        for i in np.flatnonzero(comp_len):
            packed[i, :comp_len[i]] = tight[hoff[i]:hoff[i] + comp_len[i]]
        return (packed, meta[:, _BITS].astype(np.int32),
                meta[:, _FILL].astype(bool))

    def encode_blocks_compact(self, blocks_np: np.ndarray,
                              lengths_np: np.ndarray):
        """The batch through the per-block pack (K13a) and per-shard
        compaction: assemble_compact()'s arguments (lengths, tight,
        comp_len, copy, copy_len, is_fill, fill_byte)."""
        meta, tight = self._compact_parts(blocks_np, lengths_np)
        return self._compact_tuple(blocks_np, lengths_np, meta, tight)

    def encode_blocks_flat(self, blocks_np: np.ndarray,
                           lengths_np: np.ndarray):
        """The batch through the flat exact-offset pack: each shard's
        torch_coder.flat_plan over its own blocks, compact_tokens (K3)
        and pack_flat (K4/K5) straight into its payload layout (no
        launch on a shard without a HUFF block), one copy of its payload
        bytes to the host. The shards' bytes concatenate in shard order.
        Returns assemble_compact()'s arguments, or None when the batch
        has a COPY block and no HUFF block (nothing to pack: the compact
        route takes it). COPY blocks beside HUFF ones are taken, as the
        port's unsharded flat path takes them; there are no VMEM caps."""
        shards = self._tokenized(blocks_np, lengths_np)
        tables = self._tables(shards)
        t0 = time.perf_counter()
        plans, metas = [], []
        for s, tab in zip(shards, tables):
            p = tc.flat_plan(s.hist, s.lengths, tab)
            plans.append(p)
            metas.append(np.stack([
                p.comp_len, np.where(p.is_copy, s.lengths, 0), p.total_bits,
                p.is_fill, tc.fill_bytes_from_hist(s.hist)], 1))
        nb = blocks_np.shape[0]
        meta = allgather(self.mesh, np.concatenate(metas).astype(np.int64))
        t0 = self._time("tables", t0)
        if meta[:, _COPY].any() and not meta[:, _COMP].any():
            return None
        staged = []
        for s, p in zip(shards, plans):
            if p.total_payload == 0:
                staged.append(None)
                continue

            def d(a, dev=s.device):
                return tc._to_device(a, dev)

            tokw = (s.toks[0] | (s.toks[2] << 9) | (s.toks[1] << 13)
                    | (s.toks[3] << 27))
            words = tc.pack_tokens_flat(tokw, d(p.bases), p.T, d(p.ntok),
                                        d(p.bit0), d(p.lut), p.nwords)
            staged.append(words.view(torch.uint8)[:p.total_payload])
        t0 = self._time("pack", t0)
        tights = []
        for p, words in zip(plans, staged):
            tight = (np.zeros(0, np.uint8) if words is None
                     else words.cpu().numpy().copy())
            tc._or_descriptions(tight, p.comp_len, p.desc_bytes)
            tights.append(tight)
        t0 = self._time("fetch", t0)
        tight = allgather(self.mesh, np.concatenate(tights))
        self._time("gather", t0)
        return self._compact_tuple(blocks_np, lengths_np, meta[:nb], tight)

    def encode(self, data, out_capacity: Optional[int] = None) -> bytes:
        """hzr_encode of a byte string (bytes-like, or an ndarray taken
        as uint8; every rank passes the whole input): the stream equals
        torch_coder.encode(data, out_capacity)'s, the ValueError of a
        stream that does not fit out_capacity included. One process
        without out_capacity: the compact route and assemble_compact;
        else encode_blocks and assemble."""
        if isinstance(data, np.ndarray):
            buf = data.astype(np.uint8, copy=False).reshape(-1)
        else:
            buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
        blocks_np, lengths_np = tc.split_blocks(buf)
        if out_capacity is None and self.mesh.group is None:
            return tc.assemble_compact(
                *self.encode_blocks_compact(blocks_np, lengths_np))
        packed, total_bits, is_fill = self.encode_blocks(blocks_np,
                                                         lengths_np)
        return tc.assemble(blocks_np, lengths_np, packed, total_bits,
                           is_fill, out_capacity)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def shard_cuts(nseg, nshards: int) -> List[int]:
    """Block cuts of contiguous runs, one a shard, balanced by
    cumulative segment count (mesh.py:210-219): shard d takes blocks
    cuts[d]:cuts[d + 1]."""
    csum = np.cumsum(nseg)
    nb = len(nseg)
    cuts = [0]
    for d in range(1, nshards):
        i = int(np.searchsorted(csum, int(csum[-1]) * d / nshards))
        cuts.append(max(cuts[-1], min(i, nb)))
    return cuts + [nb]


class ShardedHzrDecoder:
    """hzr decode with the HUFF blocks cut over this process's shards
    (mesh.py:30-336). ``decode_info`` says what the last decode did."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.decode_info: dict = {}

    def decode_many(self, datas, hints=None, return_hints: bool = False):
        """The decoded bytes of each hzr stream (and DecodeHints or None
        with return_hints). Every HUFF block decodes on a shard: K6 and
        K7 once on each shard that holds a block, into its span.

        hints: DecodeHints of an earlier decode of the same streams by a
        decoder of as many shards (the digest binds the stream content,
        gpu_decoder.LAYOUT_VERSION and the shard cuts: any other hint
        runs the fixpoint), None (consult gpu_decoder's registry) or
        False (never hint). The first hinted decode of a digest is held
        against an unhinted one, as gpu_decoder.decode_device does."""
        if not len(datas):
            return ([], None) if return_hints else []
        t0 = time.perf_counter()
        spans, out, huff = gd._walk_all(datas, light=True)
        dev, digest_parts = gd._device_blocks(huff)
        info = dict(shards=self.mesh.local, device_blocks=len(dev),
                    blocks=[], tiles=[], fp_iters=[], hinted=False)
        self.decode_info = info

        def host_outs():
            return [out[a:a + n].tobytes() for a, n in spans]

        if not dev:
            return (host_outs(), None) if return_hints else host_outs()
        nseg = [b[1] for b in gd.lane_rows([(d[1], d[2]) for d in dev])[1]]
        cuts = shard_cuts(nseg, self.mesh.local)
        parts = [dev[cuts[k]:cuts[k + 1]] for k in range(self.mesh.local)]
        rows = [gd.lane_shape(p)[0] if p else 0 for p in parts]
        digest = zlib.crc32(np.asarray(cuts, np.int64).tobytes(),
                            gd._hints_digest(digest_parts))
        entries = None
        if not gd._hints_disabled:
            shape = (sum(rows), 128)
            entries = gd._match_hints(hints, digest, shape)
            if entries is None and hints is not False:
                entries = gd._registry_hints(digest, shape)
        t1 = time.perf_counter()
        # every shard's launches first, then its span and stats
        row0 = np.cumsum(rows) - rows
        res = [gd.decode_span(p, p[0][3], p[-1][3] + p[-1][4] - p[0][3],
                              d, None if entries is None
                              else entries[r:r + n], sync=False)
               if p else None
               for p, d, r, n in zip(parts, self.mesh.devices, row0, rows)]
        t2 = time.perf_counter()
        for p, r in zip(parts, res):
            if r is None:
                continue
            span = r.out.cpu().numpy()
            stats = r.stats.cpu().numpy()
            base = p[0][3]
            for d in p:
                out[d[3]:d[3] + d[4]] = span[d[3] - base:d[3] - base + d[4]]
            info["tiles"].append(stats.shape[0])
            info["fp_iters"].append(stats[:, 1].tolist())
        outs = host_outs()
        t3 = time.perf_counter()
        info.update(blocks=[len(p) for p in parts], cuts=cuts,
                    hinted=entries is not None,
                    times=dict(walk_luts=t1 - t0, dispatch=t2 - t1,
                               fetch=t3 - t2))
        if entries is not None and digest not in gd._validated_digests:
            # the first hinted decode of a digest is held against the
            # alignment fixpoint's bytes; a mismatch disables hint trust
            ref = self.decode_many(datas, hints=False,
                                   return_hints=return_hints)
            gd._validated(digest)
            if (ref[0] if return_hints else ref) != outs:
                gd._hints_disabled = True
                log.warning("sharded decode: hinted output differs from the "
                            "alignment fixpoint's; hint trust disabled")
                return ref
            self.decode_info = info
            info["times"]["check"] = time.perf_counter() - t3
        h = None
        if return_hints:
            h = gd.DecodeHints(digest, np.concatenate(
                [r.entry_out.cpu().numpy() for r in res if r is not None]))
            gd.register_hints(h)
        return (outs, h) if return_hints else outs
