"""Device hzr decoder of the port (counterpart of
rspt_tpu/hzr/pallas_decoder.py:decode_many, :1180-1506).

The entropy stage of every HUFF+RLE block runs on the card as one
launch of ``hzr_decode`` (K6): each block's payload is cut into
segments of ``segw`` words, one lane per segment, 8 rows x 128 lanes a
tile; every lane decodes its segment speculatively and an in-kernel
alignment fixpoint (entry(s+1) = exit(s)) makes the entries exact. The
lanes' literal emissions (``outc << 9 | byte``) are then written to
their output bytes by one ``place_literals`` launch, which takes the
place of the TPU's K7-K9 placement chain.

Host half (own copies of pallas_decoder.py): the light stream walk
(``walk.walk_stream(..., light=True)``), the 8-bit-root + 4-bit
nibble-level LUTs of every HUFF block recovered from its payload bits in
one call of the host runtime (``native.lut_nib_batch``; ``build_lut_nib``
of a tree from the full walk is the plain version), the lane layout
shared with encode-side hints (``lane_rows``), the kernel's input
arrays (``lane_arrays``) and the decode-hints registry with its
per-digest cross-check. COPY and FILL
blocks resolve on the host; every HUFF block decodes on the device.

Entry points run on the card unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions compute the same bytes.
"""

from __future__ import annotations

import collections
import logging
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..native import bindings as native
from ..ops import cuda_kernels as ck
from ..ops.cuda_kernels import SEG_PER_BLOCK
from .walk import walk_stream

W_SEG = 40             # window words per lane (segw <= 38 + straddle)
NIB_LEVELS = 4         # 4-bit levels past the 8-bit root: 8+4*4 = 24 bits
CHUNK_BUCKETS = (1, 2, 4, 8, 16, 32, 40, 64)  # per-level chunk caps
DEEP_BIT = 1 << 30
# Bound into every hints digest: a change of the lane layout (lane_rows,
# SEG_PER_BLOCK, the window buckets) must bump it, so that hints built
# for the old layout are never trusted.
LAYOUT_VERSION = 1

log = logging.getLogger("rspt_tpu_torch.hzr")


# ---------------------------------------------------------------------------
# Decode hints (pallas_decoder.py:110-219)
# ---------------------------------------------------------------------------

class DecodeHints:
    """Converged fixpoint entries bound to the stream content they came
    from (a digest over the stored per-block CRC32C fields, the block
    geometry and LAYOUT_VERSION). ``decode_many(hints=)`` trusts them
    only when the digest and the entry shape match the streams being
    decoded; otherwise the alignment fixpoint runs."""

    __slots__ = ("digest", "entries")

    def __init__(self, digest: int, entries):
        self.digest = int(digest)
        self.entries = entries


def _hints_digest(parts) -> int:
    arr = np.asarray(parts, np.int64) if parts else np.zeros(1, np.int64)
    return zlib.crc32(arr.tobytes(), LAYOUT_VERSION)


# Ambient registry: hints returned by a decode register by digest, so a
# later decode of the same streams runs the single trusted sweep
# without the caller passing them. Bounded LRU; hints=False opts out.
_hint_registry: "collections.OrderedDict[int, np.ndarray]" = \
    collections.OrderedDict()
_HINT_REG_CAP = 64
# The first hinted decode of each digest is also decoded without hints
# and compared byte for byte (bounded like the registry); a mismatch
# disables hint trust for the process.
_validated_digests: "collections.OrderedDict[int, None]" = \
    collections.OrderedDict()
_hints_disabled = False


def register_hints(hints) -> None:
    """Add DecodeHints to the ambient registry."""
    if not isinstance(hints, DecodeHints):
        return
    _hint_registry[hints.digest] = np.ascontiguousarray(hints.entries,
                                                        np.int32)
    _hint_registry.move_to_end(hints.digest)
    while len(_hint_registry) > _HINT_REG_CAP:
        _hint_registry.popitem(last=False)


def _validated(digest) -> None:
    _validated_digests[digest] = None
    _validated_digests.move_to_end(digest)
    while len(_validated_digests) > _HINT_REG_CAP:
        _validated_digests.popitem(last=False)


def _registry_hints(digest, shape):
    ent = _hint_registry.get(digest)
    if ent is None or ent.shape != shape:
        return None
    _hint_registry.move_to_end(digest)
    return ent


def _match_hints(hints, digest, shape):
    """The entry array to trust, or None (the fixpoint runs). Bare
    arrays carry no digest and are never trusted."""
    if not isinstance(hints, DecodeHints) or hints.digest != digest:
        return None
    if getattr(hints.entries, "shape", None) != shape:
        return None
    return np.ascontiguousarray(hints.entries, np.int32)


# ---------------------------------------------------------------------------
# Host tables and lane layout
# ---------------------------------------------------------------------------

def build_lut_nib(tree):
    """Flatten a pyref tree into an 8-bit root LUT chained into up to
    NIB_LEVELS 4-bit levels (pallas_decoder.py:226-284), or None when a
    code exceeds 24 bits (impossible for legal streams: the Fibonacci
    bound caps hzr codes at 23 bits).

    l1 (256,): leaf -> sym | bits << 16 (bits <= 8), deep -> DEEP_BIT |
    slot. levels[k] (nslots_k * 16,) slot-major: leaf -> sym |
    totalbits << 16, internal at the nibble boundary -> DEEP_BIT | next
    level's slot. chunks[k] = ceil(nslots_k * 16 / 128)."""
    l1 = np.zeros(256, np.int32)
    slots = [[] for _ in range(NIB_LEVELS)]

    def walk_nib(node, lvl):
        if lvl >= NIB_LEVELS:
            return None
        sid = len(slots[lvl])
        arr = np.zeros(16, np.int32)
        slots[lvl].append(arr)

        def w(nd, c, b):
            if not isinstance(nd, tuple):
                arr[c:16:1 << b] = nd | ((8 + 4 * lvl + b) << 16)
                return True
            if b == 4:
                s2 = walk_nib(nd, lvl + 1)
                if s2 is None:
                    return False
                arr[c] = DEEP_BIT | s2
                return True
            return w(nd[0], c, b + 1) and w(nd[1], c | (1 << b), b + 1)

        return sid if w(node, 0, 0) else None

    def walk(node, code, bits):
        if not isinstance(node, tuple):
            # a degenerate single-leaf tree consumes 1 bit
            l1[code:256:1 << bits] = node | (max(bits, 1) << 16)
            return True
        if bits == 8:
            sid = walk_nib(node, 0)
            if sid is None:
                return False
            l1[code] = DEEP_BIT | sid
            return True
        return walk(node[0], code, bits + 1) and \
            walk(node[1], code | (1 << bits), bits + 1)

    if not walk(tree, 0, 0):
        return None
    levels = [np.concatenate(s) if s else np.zeros(0, np.int32)
              for s in slots]
    chunks = [-(-lv.size // 128) if lv.size else 0 for lv in levels]
    return l1, levels, chunks


def lane_rows(geom):
    """Segment-lane layout (pallas_decoder.py:130-161): per block
    ceil(nseg / 128) rows, blocks contiguous, never straddling an 8-row
    tile, so a block's fixpoint stays inside one tile.

    geom: [(pbits, dbits)] per HUFF block, in stream order.
    Returns (rows, blk_rows): rows = [(block_idx, seg_lo)] with (-1, 0)
    padding rows; blk_rows = [(segw, nseg, nrow)] per block."""
    rows = []
    blk_rows = []
    for i, (pbits, dbits) in enumerate(geom):
        body_words = -(-max(pbits - dbits, 1) // 32)
        # short segments for small payloads keep their step counts low
        segw = max(8, -(-body_words // SEG_PER_BLOCK))
        nseg = -(-body_words // segw)
        nrow = -(-nseg // 128)
        blk_rows.append((segw, nseg, nrow))
        if (len(rows) % 8) + nrow > 8:
            while len(rows) % 8:
                rows.append((-1, 0))
        for r in range(nrow):
            rows.append((i, r * 128))
    while len(rows) % 8:
        rows.append((-1, 0))
    return rows, blk_rows


def _chunk_cap(used: int) -> int:
    for c in CHUNK_BUCKETS:
        if used <= c:
            return c
    return used


@dataclass
class LaneArrays:
    """hzr_decode's inputs (all int32, nrows = 8 * tiles) and the lane
    metadata placement needs ((nrows * 128,) each)."""
    ntc: np.ndarray          # (tiles, 5): max level-k chunks, trust flag
    win: np.ndarray          # (wseg, nrows, 128) payload words per lane
    l1lo: np.ndarray         # (nrows, 128) root LUT entries 0..127
    l1hi: np.ndarray         # (nrows, 128) root LUT entries 128..255
    lv: List[np.ndarray]     # 4 x (cap_k, nrows, 128) nibble levels
    entry: np.ndarray        # (nrows, 128) nominal segment start bits
    segend: np.ndarray       # (nrows, 128) segment end bits
    pbits: np.ndarray        # (nrows, 128) payload bits of the block
    first: np.ndarray        # (nrows, 128) 1 = entry pinned
    wbase: np.ndarray        # (nrows, 128) window anchor words
    lane_live: np.ndarray    # bool, real (non-padding) lanes
    block_first: np.ndarray  # lane index of the block's first lane
    out_off: np.ndarray      # the block's output byte offset
    out_limit: np.ndarray    # the block's output end

    def kernel_inputs(self):
        """hzr_decode's argument order."""
        return (self.ntc, self.win, self.l1lo, self.l1hi, *self.lv,
                self.entry, self.segend, self.pbits, self.first, self.wbase)


def lane_arrays(dev) -> LaneArrays:
    """The kernel's inputs for the HUFF blocks
    (pallas_decoder.py:1301-1396).

    dev: [(payload u8, pbits, dbits, out_off, out_len, l1, levels,
    chunks)] in stream order."""
    rows, blk_rows = lane_rows([(d[1], d[2]) for d in dev])
    max_segw = max(8, max(b[0] for b in blk_rows))
    nrows = len(rows)
    nl = nrows * 128
    # window rows needed: a segment's decode spans <= segw + 2 words past
    # its base plus <= 3 words of refill lookahead
    wseg = W_SEG
    for b in (14, 22, W_SEG):
        if max_segw + 6 <= b:
            wseg = b
            break
    win = np.zeros((wseg, nrows, 128), np.int32)
    l1lo = np.zeros((nrows, 128), np.int32)
    l1hi = np.zeros((nrows, 128), np.int32)
    capc = [_chunk_cap(max(d[7][k] for d in dev) or 1)
            for k in range(NIB_LEVELS)]
    lva = [np.zeros((capc[k], nrows, 128), np.int32)
           for k in range(NIB_LEVELS)]
    entry = np.zeros((nrows, 128), np.int32)
    segend = np.zeros((nrows, 128), np.int32)
    pbits_a = np.zeros((nrows, 128), np.int32)
    # every lane pinned by default (padding rows never update); live
    # rows clear their live prefix below
    first = np.ones((nrows, 128), np.int32)
    ntc = np.zeros((nrows // 8, 5), np.int32)
    lane_live = np.zeros(nl, bool)
    block_first = np.zeros(nl, np.int32)
    out_off = np.zeros(nl, np.int32)
    out_limit = np.zeros(nl, np.int32)
    lane_block = np.full(nl, -1, np.int32)
    firsts, frames = {}, {}
    for r, (bi, seg_lo) in enumerate(rows):
        if bi < 0:
            continue
        payload, pbits, dbits, ooff, olen, l1, levels, chunks = dev[bi]
        segw, nseg, _ = blk_rows[bi]
        l1lo[r] = l1[:128]
        l1hi[r] = l1[128:]
        for k in range(NIB_LEVELS):
            if chunks[k]:
                flat = np.zeros(capc[k] * 128, np.int32)
                flat[:levels[k].size] = levels[k]
                lva[k][:, r, :] = flat.reshape(capc[k], 128)
                ntc[r // 8, k] = max(ntc[r // 8, k], chunks[k])
        nj = min(128, nseg - seg_lo)
        s = seg_lo + np.arange(nj)
        e0 = dbits + s * segw * 32
        entry[r, :nj] = e0
        segend[r, :nj] = np.where(s + 1 < nseg,
                                  dbits + (s + 1) * segw * 32, pbits)
        pbits_a[r, :nj] = pbits
        # live lanes but a block's segment 0 take the previous lane's
        # exit; dead tail lanes stay pinned, or neighbour exits would
        # walk down the dead tail one lane per sweep (~128 sweeps)
        first[r, 1 if seg_lo == 0 else 0:nj] = 0
        # per-lane word windows through one strided view of the block
        if bi not in frames:
            need = (dbits // 32) + nseg * segw + wseg + 2
            pw = np.zeros(need * 4, np.uint8)
            pw[:payload.size] = payload
            frames[bi] = np.lib.stride_tricks.sliding_window_view(
                pw.view("<u4").view(np.int32), wseg)
        win[:, r, :nj] = frames[bi][e0 >> 5].T
        li = r * 128
        lane_live[li:li + nj] = True
        lane_block[li:li + nj] = bi
        out_off[li:li + nj] = ooff
        out_limit[li:li + nj] = ooff + olen
        firsts.setdefault(bi, li)
        block_first[li:li + nj] = firsts[bi]
    dead = lane_block < 0
    block_first[dead] = np.flatnonzero(dead)
    return LaneArrays(ntc=ntc, win=win, l1lo=l1lo, l1hi=l1hi, lv=lva,
                      entry=entry, segend=segend, pbits=pbits_a,
                      first=first, wbase=np.right_shift(entry, 5),
                      lane_live=lane_live, block_first=block_first,
                      out_off=out_off, out_limit=out_limit)


def valid_emissions(emis: torch.Tensor, steps: torch.Tensor,
                    literals_only: bool = False) -> torch.Tensor:
    """hzr_decode's emission grid with every step at or past its tile's
    step count zeroed (those rows are scratch), and with literals_only
    also every non-literal step: what placement reads. Kernels whose
    tile step counts differ (the TPU kernel counts in fours) agree on
    this form."""
    s = torch.arange(emis.shape[1], device=emis.device)
    keep = (s[None, :] < steps.reshape(-1, 1))[:, :, None, None]
    if literals_only:
        keep = keep & ((emis & 0x1FF) != 0)
    return torch.where(keep, emis, 0)


def lane_out_base(counts: torch.Tensor, lane_live: torch.Tensor,
                  out_off: torch.Tensor, block_first: torch.Tensor
                  ) -> torch.Tensor:
    """Each lane's first output byte: its block's offset plus the bytes
    the block's earlier lanes decoded (pallas_decoder.py:735-738).
    counts (nrows, 128) int32; the rest (nrows * 128,); int32 out."""
    flat = torch.where(lane_live, counts.reshape(-1).long(), 0)
    excl = torch.cumsum(flat, 0) - flat
    return (out_off.long() + excl - excl[block_first.long()]).to(torch.int32)


def lane_shape(dev):
    """The entry shape (nrows, 128) that lane_arrays gives the device
    blocks ``dev``: what decode hints for them must match."""
    return len(lane_rows([(d[1], d[2]) for d in dev])[0]), 128


@dataclass
class SpanDecode:
    """What decode_span did: the span's bytes and the kernel's lane
    results, on the device."""
    out: torch.Tensor         # (size,) uint8, the span's bytes
    entry_out: torch.Tensor   # (nrows, 128) converged segment entries
    stats: torch.Tensor       # (tiles, 5) hzr_decode's tile stats
    stats_np: Optional[np.ndarray]   # the stats on the host (sync)
    lanes: int
    times: dict               # wall s: lanes, kernel, place


def decode_span(dev, base: int, size: int, device, entries=None, out=None,
                sync: bool = True) -> SpanDecode:
    """Decode the device blocks ``dev`` (_device_blocks' tuples, in
    stream order) whose output lies in bytes [base, base + size) of the
    decoded batch: their lanes (lane_arrays), one hzr_decode (K6), the
    lanes' output bases and one place_literals (K7) into a (size,)
    uint8 buffer on ``device`` that starts as ``out`` (the span's host
    bytes, e.g. the walk's COPY and FILL blocks) or as zeros. entries:
    trusted segment entries of lane_shape(dev), or None (the fixpoint
    runs). sync: fetch the tile stats between the kernels and wait for
    the placement (the stage times then hold the device's); else both
    launches are only queued."""
    t0 = time.perf_counter()
    if base:
        dev = [d[:3] + (d[3] - base,) + d[4:] for d in dev]
    la = lane_arrays(dev)
    if entries is not None:
        la.entry = entries
        la.ntc[:, 4] = 1

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t1 = time.perf_counter()
    emis, counts, entry_out, stats = ck.hzr_decode(
        *[upload(a) for a in la.kernel_inputs()])
    out_t = (torch.zeros(size, dtype=torch.uint8, device=device)
             if out is None else upload(out))
    lane_live = upload(la.lane_live)
    stats_np = stats.cpu().numpy() if sync else None
    t2 = time.perf_counter()
    out_base = lane_out_base(counts, lane_live, upload(la.out_off),
                             upload(la.block_first))
    ck.place_literals(emis, stats[:, 0].contiguous(), out_base,
                      upload(la.out_limit), lane_live, size, out=out_t)
    if sync and out_t.is_cuda:
        torch.cuda.synchronize(out_t.device)
    t3 = time.perf_counter()
    return SpanDecode(out=out_t, entry_out=entry_out, stats=stats,
                      stats_np=stats_np, lanes=lane_live.numel(),
                      times=dict(lanes=t1 - t0, kernel=t2 - t1,
                                 place=t3 - t2))


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

def _walk_all(datas, light: bool = False):
    srcs = [np.frombuffer(memoryview(d).cast("B"), np.uint8)
            if not isinstance(d, np.ndarray) else d.reshape(-1)
            for d in datas]
    spans = []
    total = 0
    for src in srcs:
        if src.size < 4:
            raise ValueError("hzr: input too small")
        sz = int.from_bytes(src[:4].tobytes(), "little")
        spans.append((total, sz))
        total += sz
    out = np.zeros(total, np.uint8)
    huff = []
    for src, (gstart, ssize) in zip(srcs, spans):
        walk_stream(src, ssize, gstart, out, huff, light)
    return spans, out, huff


def _device_blocks(huff):
    """Every HUFF block with its LUTs and description bits from the host
    runtime (one batch call), and the parts of the hints digest. A walk
    that recovered the trees (description bits >= 0) must agree with
    the runtime's bits. The kernel covers every legal block: one
    indexed load per nibble level, whatever a level's chunk count, so
    no block is routed to a host decoder on cost (the JAX decoder
    routes dense trees away because its lookup sweeps 128-entry
    chunks)."""
    luts, nat_dbits = native.lut_nib_batch([h[0] for h in huff])
    dev, digest_parts = [], []
    for (payload, pbits, dbits, ooff, olen, _, crc), lut, nd in zip(
            huff, luts, nat_dbits.tolist()):
        if dbits >= 0 and dbits != nd:
            raise ValueError("hzr: description bits differ from the walk's")
        digest_parts.append((crc, payload.size, nd, ooff, olen))
        dev.append((payload, pbits, nd, ooff, olen) + lut)
    return dev, digest_parts


def decode_device(datas, device=None, hints=None, return_hints=False):
    """Decode hzr streams into one uint8 tensor on ``device``.

    Returns (out (total,) uint8, spans [(offset, size)] per stream,
    DecodeHints or None, info). hints: DecodeHints, None (consult the
    ambient registry) or False (never hint: the plain fixpoint path).
    info says what the decode did: tiles, lanes, per-tile step counts
    and fixpoint sweeps, literals, device blocks, whether hints were
    trusted, and the wall time of its stages (walk_luts, kernel, place,
    and check when a first hinted decode was cross-checked)."""
    global _hints_disabled
    device = resolve_device(device)
    t0 = time.perf_counter()
    spans, out, huff = _walk_all(datas, light=True)
    dev, digest_parts = _device_blocks(huff)
    info = dict(tiles=0, lanes=0, steps=[], fp_iters=[], literals=0,
                device_blocks=len(dev), hinted=False)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if not dev:
        info["times"] = dict(walk_luts=time.perf_counter() - t0, kernel=0.0,
                             place=0.0)
        return upload(out), spans, None, info

    shape = lane_shape(dev)
    digest = _hints_digest(digest_parts)
    h_entries = None
    if not _hints_disabled:
        h_entries = _match_hints(hints, digest, shape)
        if h_entries is None and hints is not False:
            h_entries = _registry_hints(digest, shape)
    t1 = time.perf_counter()
    res = decode_span(dev, 0, out.size, device, h_entries, out)
    out_t, entry_out, stats_np = res.out, res.entry_out, res.stats_np
    info.update(tiles=stats_np.shape[0], lanes=res.lanes,
                steps=stats_np[:, 0].tolist(),
                fp_iters=stats_np[:, 1].tolist(),
                literals=int(stats_np[:, 2].sum()),
                hinted=h_entries is not None,
                times=dict(walk_luts=t1 - t0 + res.times["lanes"],
                           kernel=res.times["kernel"],
                           place=res.times["place"]))
    t3 = time.perf_counter()
    if h_entries is not None and digest not in _validated_digests:
        # the first hinted decode of a digest is held against the
        # alignment fixpoint's bytes on the same device; a mismatch
        # disables hint trust for the process
        ref = decode_device(datas, device, hints=False,
                            return_hints=return_hints)
        _validated(digest)
        if not torch.equal(out_t, ref[0]):
            _hints_disabled = True
            log.warning("gpu decode: hinted output differs from the "
                        "alignment fixpoint's; hint trust disabled")
            return ref
        info["times"]["check"] = time.perf_counter() - t3
    out_hints = None
    if return_hints:
        out_hints = DecodeHints(digest, entry_out.cpu().numpy())
        register_hints(out_hints)
    return out_t, spans, out_hints, info


def decode_many(datas, device=None, hints=None, return_hints: bool = False):
    """Decode several hzr streams with the entropy stage of all their
    HUFF blocks in one kernel launch and one placement launch. Returns
    the decoded bytes per stream (and DecodeHints with return_hints)."""
    if not len(datas):
        return ([], None) if return_hints else []
    out_t, spans, h, _ = decode_device(datas, device, hints, return_hints)
    out = out_t.cpu().numpy()
    outs = [out[a:a + n].tobytes() for a, n in spans]
    return (outs, h) if return_hints else outs
