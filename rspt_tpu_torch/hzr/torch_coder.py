"""hzr two-pass encoder around the CUDA kernels (counterpart of
rspt_tpu/hzr/jax_coder.py).

Host half (own copies of jax_coder.py:541-582, 740-788, 856-936 and
build_block_tables :211-229): block splitting, per-block Huffman tables
from the histograms (the host runtime's table builder, rspt_tpu_torch/
native; ``host_tables_plain`` is the Python oracle), the exact stream
layout those imply, and the final assembly (7-byte block headers, the
runtime's CRC32C, COPY and FILL fallbacks, the reference's
output-capacity rule).

Device half, two pack designs:
- ``pack_tokens_flat``, the flat exact-offset pack
  (jax_coder._pack_tokens_flat2_impl:585-676) the packers use: valid
  tokens of every HUFF block are compacted to a group-aligned flat
  stream (compact_tokens) and each block's bits are placed straight
  into the final payload layout (pack_flat). The JAX version's
  compaction splits and its flat-buffer and token-row caps are TPU VMEM
  limits; the port has none of them, and its flat path covers batches
  with COPY blocks too (their payload is the raw plane bytes the
  tokenizer already wrote). With hints, ``pack_flat_lanes`` also writes
  the device decoder's segment entries (hzr/sidecar.py, the want_hints
  branch of tpu.py:_entropy_streams). Two further routes give the same
  payload words through the TPU's windows form, per 8,192-token group
  (``group_layout``): ``pack_tokens_fused`` through windows_place_flat
  (K15, the fuse_place branch of jax_coder.py:627-636), and
  ``pack_tokens_windows``, group_windows (K14) → ``ck.windows_glue`` →
  place_windows_aligned (X1, tools/exp_place.py). No packer takes them.
- ``pack_blocks`` / ``pack_blocks_tokw``, the per-block positional pack
  (jax_coder.pack_blocks :478-538): every block packs its own row from
  its token slots, no compaction, and every block's bit total comes
  back. It carries the stream encoder ``encode(data, out_capacity)``
  (jax_coder.encode :939-948, through ``tokenize_blocks`` and
  ``encode_blocks_device``) and ``entropy_streams_blocks``, the JAX
  packers' per-block branch (tpu.py:_entropy_streams :476-515, with
  ``compact_payloads``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..formats.crc32c import crc32c
from ..formats.hzr_constants import (
    BLOCK_HEADER_SIZE,
    ENCODING_COPY,
    ENCODING_FILL,
    ENCODING_HUFF_RLE,
    HEADER_SIZE,
    MAX_BLOCK_SIZE,
    NUM_SYMBOLS,
    SYMBOL_SIZE,
)
from ..native import bindings as native
from ..ops import cuda_kernels as ck
from ..ops import torch_ops as tops
from . import pyref, sidecar

B = MAX_BLOCK_SIZE  # 65536
MAX_DESC_BITS = (2 * NUM_SYMBOLS - 1) + SYMBOL_SIZE * NUM_SYMBOLS
DESC_STRIDE = (MAX_DESC_BITS + 7) // 8
GROUP_TOK_FLAT = 8192  # tokens per group; block token bases align to it
WAVE = 4               # payloads a wave of the pipelined entropy stage

_EBITS_VEC = np.zeros(NUM_SYMBOLS, np.int64)
_EBITS_VEC[256:261] = (0, 2, 4, 8, 14)


# ---------------------------------------------------------------------------
# Host — Huffman tables and stream layout
# ---------------------------------------------------------------------------

def build_block_tables(hist: np.ndarray):
    """One block's Huffman tables from its 261-bin histogram:
    (codes u32[261], code_bits i32[261], desc_bytes, desc_bits), or None
    for a single-code-class FILL block (hzr_encode.c:285-305)."""
    if pyref._only_single_code(hist):
        return None
    root, single = pyref.build_tree(hist)
    desc_vals, desc_nbits, codes, code_bits = pyref.serialize_tree(
        root, single)
    desc_bits = int(desc_nbits.sum())
    desc_bytes = np.frombuffer(pyref.pack_bits(desc_vals, desc_nbits),
                               np.uint8)
    return codes, code_bits, desc_bytes, desc_bits


def host_tables(hist_np: np.ndarray, lengths_np: np.ndarray):
    """Per-block code LUTs, packed tree descriptions and FILL flags:
    (codes, cbits, desc_bytes, desc_bits, is_fill), built in the host
    runtime's threads. An empty block is FILL."""
    codes, cbits, desc_bytes, desc_bits, is_fill = native.build_tables(
        hist_np, DESC_STRIDE)
    is_fill |= np.asarray(lengths_np) == 0
    _check_code_bits(cbits)
    return codes, cbits, desc_bytes, desc_bits, is_fill


def _check_code_bits(cbits: np.ndarray) -> None:
    # the combined code | cbits << 24 LUT word needs cbits <= 23 — the
    # Huffman depth over <= 64Ki+261 weights is Fibonacci-bounded there
    if cbits.size and int(cbits.max()) > 23:
        raise ValueError("hzr: pathological code length")


def host_tables_plain(hist_np: np.ndarray, lengths_np: np.ndarray):
    """host_tables one block at a time in Python (pyref's tree)."""
    nb = hist_np.shape[0]
    codes = np.zeros((nb, NUM_SYMBOLS), np.uint32)
    cbits = np.zeros((nb, NUM_SYMBOLS), np.int32)
    desc_bytes = np.zeros((nb, DESC_STRIDE), np.uint8)
    desc_bits = np.zeros(nb, np.int32)
    is_fill = np.zeros(nb, bool)
    for i in range(nb):
        if lengths_np[i] == 0:
            is_fill[i] = True
            continue
        t = build_block_tables(hist_np[i])
        if t is None:
            is_fill[i] = True
            continue
        codes[i], cbits[i], db, desc_bits[i] = t
        desc_bytes[i, :db.size] = db
    _check_code_bits(cbits)
    return codes, cbits, desc_bytes, desc_bits, is_fill


def host_layout(hist_np, lengths_np, cbits, desc_bits, is_fill):
    """Exact per-block stream layout from the histograms alone: token
    bits are sum_s hist[s] * (code_bits[s] + extra_bits[s]). Returns
    (total_bits, comp_len, is_huff, is_copy)."""
    tokbits = (hist_np.astype(np.int64)
               * (cbits.astype(np.int64) + _EBITS_VEC[None, :])).sum(1)
    total_bits = desc_bits.astype(np.int64) + tokbits
    plen = (total_bits + 7) >> 3
    live = np.asarray(lengths_np) > 0
    is_huff = ((~is_fill) & live & (plen <= lengths_np)
               & (plen < MAX_BLOCK_SIZE))
    is_copy = (~is_fill) & live & (~is_huff)
    comp_len = np.where(is_huff, plen, 0).astype(np.int64)
    return total_bits, comp_len, is_huff, is_copy


def flat_compact_layout(hist_np, is_huff):
    """Token layout of the compacted flat stream: per-block token counts
    from the histograms, bases group-aligned. Non-HUFF blocks get base
    T, past the real region, and are not compacted."""
    ntok = hist_np.sum(axis=1).astype(np.int64)
    groups = np.where(is_huff, -(-ntok // GROUP_TOK_FLAT), 0)
    gpref = np.concatenate(([0], np.cumsum(groups)[:-1]))
    T = int(groups.sum()) * GROUP_TOK_FLAT
    bases = np.where(is_huff, gpref * GROUP_TOK_FLAT, T).astype(np.int32)
    ng = int(groups.sum())
    g2b = np.repeat(np.arange(len(groups)), groups)
    gfirst = np.repeat(gpref, groups).astype(np.int32)
    return bases, T, ng, g2b, gfirst


def fill_bytes_from_hist(hist_np: np.ndarray) -> np.ndarray:
    """FILL blocks are single-code-class: all bytes equal one literal or
    all zero — recover block[0] from the histogram
    (hzr_encode.c:341-367 semantics)."""
    lits = hist_np[:, 1:256]
    has_lit = lits.max(axis=1, initial=0) > 0
    return np.where(has_lit, lits.argmax(axis=1) + 1, 0).astype(np.uint8)


def assemble_compact(lengths_np, tight_np, comp_len_np, copy_np,
                     copy_len_np, is_fill, fill_byte, crc_out=None) -> bytes:
    """One hzr stream from the packed payloads: 4-byte size, then per
    block the 7-byte header (size-1, CRC32C, mode) and its payload.
    crc_out, if given, receives each non-empty block's stored CRC32C."""
    nb = lengths_np.shape[0]
    in_size = int(lengths_np.sum())
    parts: List[bytes] = [int(in_size).to_bytes(4, "little")]
    hoff = np.concatenate(([0], np.cumsum(comp_len_np)[:-1]))
    coff = np.concatenate(([0], np.cumsum(copy_len_np)[:-1]))
    for i in range(nb):
        blen = int(lengths_np[i])
        if blen == 0:
            continue
        if is_fill[i]:
            fb = bytes([int(fill_byte[i])])
            crc = crc32c(np.frombuffer(fb, np.uint8))
            enc = ((0).to_bytes(2, "little") + int(crc).to_bytes(4, "little")
                   + bytes([ENCODING_FILL]) + fb)
        elif comp_len_np[i] > 0:
            payload = tight_np[hoff[i]:hoff[i] + comp_len_np[i]]
            crc = crc32c(payload)
            enc = ((int(comp_len_np[i]) - 1).to_bytes(2, "little")
                   + int(crc).to_bytes(4, "little")
                   + bytes([ENCODING_HUFF_RLE]) + payload.tobytes())
        else:  # COPY fallback
            block = copy_np[coff[i]:coff[i] + blen]
            crc = crc32c(block)
            enc = ((blen - 1).to_bytes(2, "little")
                   + int(crc).to_bytes(4, "little")
                   + bytes([ENCODING_COPY]) + block.tobytes())
        if crc_out is not None:
            crc_out[i] = crc
        parts.append(enc)
    return b"".join(parts)


def lut_words(codes: np.ndarray, cbits: np.ndarray) -> np.ndarray:
    """(nb, 261) int32 LUT words code | cbits << 24."""
    return ((codes.astype(np.uint32) & np.uint32(0xFFFFFF))
            | (cbits.astype(np.uint32) << np.uint32(24))).view(np.int32)


@dataclass
class FlatPlan:
    """Everything the host derives from a block batch's histograms: the
    tables, the exact stream layout, and pack_tokens_flat's inputs."""
    desc_bytes: np.ndarray   # (nb, DESC_STRIDE) packed tree descriptions
    desc_bits: np.ndarray    # (nb,) int32 description bits
    is_fill: np.ndarray      # (nb,) FILL blocks (incl. empty)
    is_copy: np.ndarray      # (nb,) COPY-fallback blocks
    comp_len: np.ndarray     # (nb,) HUFF payload bytes, 0 otherwise
    total_bits: np.ndarray   # (nb,) int64 description + token bits
    hoff: np.ndarray         # (nb,) payload offsets in the flat buffer
    bases: np.ndarray        # (nb,) int32 compacted token bases
    T: int                   # compacted tokens (group-aligned)
    ntok: np.ndarray         # (nb,) int32 tokens to pack, 0 if not HUFF
    bit0: np.ndarray         # (nb,) int64 first token bit
    lut: np.ndarray          # (nb, 261) int32 code | cbits << 24
    g2b: np.ndarray          # (ng,) block of each 8,192-token group
    gfirst: np.ndarray       # (ng,) int32 first group of that block

    @property
    def total_payload(self) -> int:
        return int(self.comp_len.sum())

    @property
    def nwords(self) -> int:
        return self.total_payload // 4 + 1


def flat_plan(hist_np: np.ndarray, lengths_np: np.ndarray,
              tables=None) -> FlatPlan:
    """The plan of a block batch; tables: its host_tables, if the caller
    has them already."""
    if tables is None:
        tables = host_tables(hist_np, lengths_np)
    codes, cbits, desc_bytes, desc_bits, is_fill = tables
    total_bits, comp_len, is_huff, is_copy = host_layout(
        hist_np, lengths_np, cbits, desc_bits, is_fill)
    hoff = np.cumsum(comp_len) - comp_len
    bases, T, _, g2b, gfirst = flat_compact_layout(hist_np, is_huff)
    return FlatPlan(
        desc_bytes=desc_bytes, desc_bits=desc_bits, is_fill=is_fill,
        is_copy=is_copy, comp_len=comp_len, total_bits=total_bits,
        hoff=hoff, bases=bases, T=T,
        ntok=np.where(is_huff, hist_np.sum(1), 0).astype(np.int32),
        bit0=(hoff * 8 + desc_bits).astype(np.int64),
        lut=lut_words(codes, cbits), g2b=g2b, gfirst=gfirst)


@dataclass
class GroupLayout:
    """The windows routes' per-group inputs on a device (the lut3,
    dbits_g, woff_g and gfirst of jax_coder._pack_tokens_flat2_impl) and
    their output row counts."""
    lut3: torch.Tensor       # (ng, 3, 128) int32 LUT of the group's block
    dbg: torch.Tensor        # (ng,) int32 its block's description bits
    wog: torch.Tensor        # (ng,) int32 its block's payload byte offset
    gfirst: torch.Tensor     # (ng,) int32 its block's first group
    ng: int
    nrows_fused: int         # rows of windows_place_flat's words
    nrows_windows: int       # rows of place_windows_aligned's words


def group_layout(plan: FlatPlan, device) -> GroupLayout:
    """plan's group layout on ``device``. The fused route's rows are
    jax_coder's (packers/tpu.py:410-411: the payload words, 2 spare and
    ACC_ROWS, rounded up to 8); the windows route adds 8 more
    (tools/exp_place.py:57-58), so that X1's 56-row spans never meet
    the wbase clamp on real input."""
    ng = plan.g2b.size
    lut3 = np.zeros((ng, 3 * 128), np.int32)
    lut3[:, :NUM_SYMBOLS] = plan.lut[plan.g2b]
    rows = -(-(plan.total_payload // 4 + 2) // 128) + ck.ACC_ROWS

    def d(a):
        return _to_device(np.asarray(a, np.int32), device)

    return GroupLayout(
        lut3=d(lut3.reshape(ng, 3, 128)), dbg=d(plan.desc_bits[plan.g2b]),
        wog=d(plan.hoff[plan.g2b]), gfirst=d(plan.gfirst), ng=ng,
        nrows_fused=-(-rows // 8) * 8, nrows_windows=-(-(rows + 8) // 8) * 8)


# ---------------------------------------------------------------------------
# Device — flat exact-offset pack
# ---------------------------------------------------------------------------

def pack_tokens_flat(tokw: torch.Tensor, bases: torch.Tensor, T: int,
                     ntok: torch.Tensor, bit0: torch.Tensor,
                     lut: torch.Tensor, nwords: int, lanes=None):
    """(nb, 65536) token words → (nwords,) int32 flat payload words.

    bases/T: flat_compact_layout; ntok: block token counts (0 for
    non-HUFF blocks); bit0: 8 * payload offset + description bits; lut:
    lut_words. The tree descriptions are not in the output: the host
    ORs them over each payload's first bytes. lanes = (meta, init) of a
    sidecar.HintPlan on the device: returns (words, decode entry lanes)
    through pack_flat_lanes instead."""
    tokc = ck.compact_tokens(tokw, bases, T)
    if lanes is not None:
        return ck.pack_flat_lanes(tokc, bases, ntok, bit0, lut, nwords,
                                  *lanes)
    return ck.pack_flat(tokc, bases, ntok, bit0, lut, nwords)


def pack_tokens_fused(tokw: torch.Tensor, bases: torch.Tensor, T: int,
                      groups: GroupLayout) -> torch.Tensor:
    """pack_tokens_flat's payload through the fused windows pack, the
    fuse_place branch of jax_coder._pack_tokens_flat2_impl (:627-636):
    compact_tokens → windows_place_flat (K15). groups: group_layout(plan).
    Returns (groups.nrows_fused, 128) int32 words."""
    tokc = ck.compact_tokens(tokw, bases, T)
    return ck.windows_place_flat(tokc.reshape(-1, 128), groups.lut3,
                                 groups.dbg, groups.wog, groups.gfirst,
                                 groups.ng, groups.nrows_fused)


def pack_tokens_windows(tokw: torch.Tensor, bases: torch.Tensor, T: int,
                        groups: GroupLayout) -> torch.Tensor:
    """pack_tokens_flat's payload by the tools' two-stage windows pipeline
    (tools/exp_place.py:68-72, 209-212): compact_tokens → group_windows
    (K14) → ck.windows_glue with X1's 56-row accumulator →
    place_windows_aligned (X1). Returns (groups.nrows_windows, 128)
    int32 words."""
    tokc = ck.compact_tokens(tokw, bases, T)
    w = ck.group_windows(tokc.reshape(1, T), groups.lut3)
    return ck.place_windows_aligned(
        *ck.windows_glue(*w, groups.dbg, groups.wog, groups.gfirst,
                         groups.nrows_windows, ck.AR2), groups.nrows_windows)


# ---------------------------------------------------------------------------
# Device — per-block positional pack
# ---------------------------------------------------------------------------

def _to_device(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def tokenize_blocks(blocks: torch.Tensor, lengths: torch.Tensor):
    """jax_coder.tokenize_blocks as torch ops on the blocks' device.

    blocks: (nb, n) uint8 (padding arbitrary); lengths: (nb,) int32.
    Returns syms, extras, ebits, tvalid (nb, n) int32 — a position holds
    at most one token, and tvalid is 1 where it does — and hist (nb,
    261) int32, single zeros counted under symbol 0."""
    syms, extras, ebits, valid, hist = tops.rle_tokenize(
        blocks.to(torch.int32), lengths.to(torch.int32)[:, None])
    return syms, extras, ebits, valid.to(torch.int32), hist


def _device_tables(codes, code_bits, desc_bits, dev):
    return (_to_device(lut_words(codes, code_bits), dev),
            _to_device(np.asarray(desc_bits, np.int32), dev))


def pack_blocks(syms, extras, ebits, tvalid, codes, code_bits, desc_bits):
    """Per-block pack of tokenize_blocks' fields (jax_coder.pack_blocks)
    through the pack_blocks kernel (K13a). codes, code_bits, desc_bits:
    host_tables' arrays.

    Returns (packed (nb, n + 512) uint8, total_bits (nb,) int32) on the
    fields' device: row b holds block b's token bits from bit
    desc_bits[b] (the description's bits are 0: the host ORs it in), and
    total_bits[b] = desc_bits[b] + the block's token bits for every
    block, a payload too long for its row included."""
    n = syms.shape[1]
    words, total = ck.pack_blocks(
        syms, extras, ebits, tvalid,
        *_device_tables(codes, code_bits, desc_bits, syms.device))
    return words.view(torch.uint8)[:, :n + 512], total


def pack_blocks_tokw(tokw, codes, code_bits, desc_bits):
    """pack_blocks over tokenize_planes' token words
    (jax_coder.pack_blocks_tokw), through pack_blocks_tokw (K13b)."""
    n = tokw.shape[1]
    words, total = ck.pack_blocks_tokw(
        tokw, *_device_tables(codes, code_bits, desc_bits, tokw.device))
    return words.view(torch.uint8)[:, :n + 512], total


def compact_payloads(packed: torch.Tensor, blocks: torch.Tensor,
                     total_bits: torch.Tensor, lengths: torch.Tensor,
                     is_fill: torch.Tensor):
    """jax_coder.compact_payloads as torch ops on the device: the bytes
    the host needs, in one buffer.

    packed (nb, max_out) uint8 and total_bits (nb,) from pack_blocks;
    blocks (nb, B) uint8 the raw block bytes; lengths (nb,) int32;
    is_fill (nb,) bool. Returns (data, meta): data (uint8) holds every
    HUFF block's payload packed[b, :comp_len[b]] back to back, then the
    raw bytes of every COPY block (JAX's buffer runs on past them with
    scratch; this one ends there); meta (3 nb,) int32 is [comp_len |
    copy_len | total_bits]."""
    tb = total_bits.to(torch.int64)
    ln = lengths.to(torch.int64)
    plen = (tb + 7) >> 3
    live = ln > 0
    is_huff = ~is_fill & live & (plen <= ln) & (plen < MAX_BLOCK_SIZE)
    comp_len = torch.where(is_huff, plen, 0)
    copy_len = torch.where(~is_fill & live & ~is_huff, ln, 0)

    def head(rows, count):
        col = torch.arange(rows.shape[1], device=rows.device)
        return rows[col[None, :] < count[:, None]]

    data = torch.cat([head(packed, comp_len), head(blocks, copy_len)])
    meta = torch.cat([comp_len, copy_len, tb]).to(torch.int32)
    return data, meta


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------

def block_layout(plane_len: int, nr_planes: int):
    """(blocks per plane, (nr_planes * nb_per,) block lengths)."""
    nb_per = max(1, -(-plane_len // B))
    lengths = np.full(nr_planes * nb_per, B, np.int32)
    if plane_len % B:
        lengths[nb_per - 1::nb_per] = plane_len % B
    return nb_per, lengths


def _add_time(times: dict, key: str, dt: float) -> None:
    times[key] = times.get(key, 0.0) + dt


class HostStaging:
    """Pinned host buffers that the payload words' device→host copies
    land in, kept across calls by their owner (a packer): buffer ``slot``
    grows as a call needs and is reused by the next call or wave that
    takes the same slot, after the earlier one's words were copied out
    of it."""

    def __init__(self):
        self._bufs = {}

    def take(self, slot, n: int, dtype=torch.int32) -> torch.Tensor:
        """A pinned (n,) host tensor of dtype: a view of buffer slot."""
        buf = self._bufs.get((slot, dtype))
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
            self._bufs[(slot, dtype)] = buf
        return buf[:n]


@dataclass
class _Staged:
    """A block batch between the dispatch and the finish of its streams:
    the host plan, and the payload words (then the raw plane words of its
    COPY blocks) on their way to the host. The copy runs on the current
    stream, so the caching allocator's stream order keeps the device
    words valid until it is done."""
    plan: FlatPlan
    hplan: Optional[sidecar.HintPlan]
    lengths: np.ndarray
    nb_per: int
    nr_streams: int
    hist_np: np.ndarray
    copy_rows: np.ndarray
    host: torch.Tensor       # host int32 words, valid after `event`
    event: Optional[torch.cuda.Event]
    entries: Optional[torch.Tensor]


def _dispatch_streams(tokw, bwords, hist_np, lengths, nb_per: int,
                      times: dict, want_hints: bool = False,
                      host: Optional[HostStaging] = None,
                      slot: int = 0) -> _Staged:
    """The first half of entropy_streams: the host tables and layout, the
    uploads, the flat pack on tokw's device, and the device→host copy of
    the payload words (and of COPY blocks' raw plane words) started: on
    the card into host's pinned buffer `slot` (non_blocking) with an
    event recorded after it; on the CPU the words themselves."""
    t0 = time.perf_counter()
    plan = flat_plan(hist_np, lengths)
    hplan = (sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                                plan.comp_len > 0) if want_hints else None)
    t1 = time.perf_counter()
    _add_time(times, "tables", t1 - t0)
    dev = tokw.device

    def d(a):
        return _to_device(a, dev)

    lanes = None if hplan is None else (d(hplan.meta), d(hplan.init))
    res = pack_tokens_flat(tokw, d(plan.bases), plan.T, d(plan.ntok),
                           d(plan.bit0), d(plan.lut), plan.nwords, lanes)
    words, entries = res if lanes is not None else (res, None)
    copy_rows = np.flatnonzero(plan.is_copy)
    if copy_rows.size:
        words = torch.cat([words, bwords[d(copy_rows)].reshape(-1)])
    event = None
    if dev.type == "cuda":
        buf = host.take(slot, words.numel())
        buf.copy_(words, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    else:
        buf = words
    _add_time(times, "pack", time.perf_counter() - t1)
    return _Staged(plan=plan, hplan=hplan, lengths=lengths, nb_per=nb_per,
                   nr_streams=len(lengths) // nb_per, hist_np=hist_np,
                   copy_rows=copy_rows, host=buf, event=event,
                   entries=entries)


def _finish_streams(st: _Staged, times: dict, wait_key: str = "wait"):
    """The second half of entropy_streams: wait for the staged copy, then
    the description OR, the COPY rows, the headers and CRCs of each
    stream, and the hints. Returns (streams, hints or None)."""
    t0 = time.perf_counter()
    if st.event is not None:
        st.event.synchronize()
    host = st.host.numpy()
    entries = None if st.entries is None else st.entries.cpu().numpy()
    t1 = time.perf_counter()
    _add_time(times, wait_key, t1 - t0)
    plan, lengths = st.plan, st.lengths
    nw = plan.nwords
    tight = host[:nw].view(np.uint8)[:plan.total_payload].copy()
    copy_len = np.where(plan.is_copy, lengths, 0).astype(np.int64)
    copy_np = np.zeros(0, np.uint8)
    if st.copy_rows.size:
        raw = host[nw:].view(np.uint8).reshape(st.copy_rows.size, -1)
        copy_np = np.concatenate([raw[j, :lengths[b]]
                                  for j, b in enumerate(st.copy_rows)])
    _or_descriptions(tight, plan.comp_len, plan.desc_bytes)
    crcs = np.zeros(len(lengths), np.int64)
    streams = plane_streams(lengths, st.nb_per, st.nr_streams, tight,
                            plan.comp_len, copy_np, copy_len, plan.is_fill,
                            fill_bytes_from_hist(st.hist_np), crcs)
    hints = None
    if st.hplan is not None:
        hints = sidecar.finish_hints(st.hplan, entries, crcs, plan.comp_len)
    _add_time(times, "assemble", time.perf_counter() - t1)
    return streams, hints


def entropy_streams(tokw, bwords, hist_np, plane_len: int, nr_planes: int,
                    times: dict, want_hints: bool = False,
                    host: Optional[HostStaging] = None):
    """One hzr stream per plane from tokenize_planes' outputs: host
    tables, the flat pack on tokw's device, one device→host copy of the
    payload words and of COPY blocks' raw plane bytes (on the card into
    host's pinned buffers, or new ones), headers. A batch of payloads
    (tokenize_planes' 2-D form) is nr_planes = batch * planes streams.
    Adds the wall time of its stages to ``times`` (tables, pack with the
    wait for the copy, assemble).

    Returns (streams, hints): with want_hints, the pack also writes the
    decoder's segment entries (hzr/sidecar.py) and hints are the
    DecodeHints of a decode of these streams in order (None when no
    block is HUFF); else None."""
    nb_per, lengths = block_layout(plane_len, nr_planes)
    st = _dispatch_streams(tokw, bwords, hist_np, lengths, nb_per, times,
                           want_hints, host or HostStaging())
    return _finish_streams(st, times, wait_key="pack")


def entropy_streams_pipelined(tokw, bwords, hist_np, plane_len: int,
                              batch: int, planes: int, times: dict,
                              host: Optional[HostStaging] = None
                              ) -> List[bytes]:
    """entropy_streams of a batch of payloads in waves of WAVE payloads,
    software-pipelined (packers/tpu.py:_entropy_streams_pipelined
    :518-620): wave i's host tables (the runtime's build_tables, which
    releases the GIL) run while wave i-1's pack and its device→host copy
    run on the card; wave i-1 is finished (its streams assembled) after
    wave i is dispatched. Each wave's streams equal an entropy_streams
    call over its payloads, so the whole equals one call over the batch.
    Unlike JAX's, every wave pipelines: the flat pack takes COPY blocks
    and has no VMEM cap. Rows of tokw, bwords and hist_np are
    payload-major (tokenize_planes' 2-D form). Adds the wall time of its
    stages, summed over the waves, to ``times`` (tables, pack, wait,
    assemble). Returns batch * planes streams, payload-major."""
    nb_per, lengths = block_layout(plane_len, planes)
    nbp = planes * nb_per                       # blocks a payload
    host = host or HostStaging()
    staged, streams = [], []
    for k, p0 in enumerate(range(0, batch, WAVE)):
        p1 = min(p0 + WAVE, batch)
        r = slice(p0 * nbp, p1 * nbp)
        staged.append(_dispatch_streams(
            tokw[r], bwords[r], hist_np[r], np.tile(lengths, p1 - p0),
            nb_per, times, host=host, slot=k % 2))
        if len(staged) > 1:
            streams += _finish_streams(staged.pop(0), times)[0]
    while staged:
        streams += _finish_streams(staged.pop(0), times)[0]
    return streams


def _or_descriptions(tight, comp_len, desc_bytes) -> None:
    """OR each HUFF block's packed tree description over the first bytes
    of its payload in the back-to-back payload bytes `tight` (the token
    bits start at bit desc_bits, so the straddle byte holds disjoint
    bits)."""
    hoff = np.cumsum(comp_len) - comp_len
    for i in np.flatnonzero(comp_len):
        dlen = min(DESC_STRIDE, int(comp_len[i]))
        tight[hoff[i]:hoff[i] + dlen] |= desc_bytes[i, :dlen]


def plane_streams(lengths, nb_per, nr_planes, tight, comp_len, copy_np,
                  copy_len, is_fill, fill_byte, crcs=None) -> List[bytes]:
    """assemble_compact of each plane's nb_per blocks; crcs, if given,
    receives every block's stored CRC32C."""
    hoff = np.cumsum(comp_len) - comp_len
    coff = np.cumsum(copy_len) - copy_len
    streams = []
    for k in range(nr_planes):
        s = slice(k * nb_per, (k + 1) * nb_per)
        streams.append(assemble_compact(
            lengths[s], tight[hoff[s.start]:], comp_len[s],
            copy_np[coff[s.start]:], copy_len[s], is_fill[s], fill_byte[s],
            None if crcs is None else crcs[s]))
    return streams


def entropy_streams_blocks(tokw, bwords, hist_np, plane_len: int,
                           nr_planes: int, times: dict) -> List[bytes]:
    """entropy_streams through the per-block pack, the JAX packers' branch
    for a batch with a COPY block (tpu.py:_entropy_streams :476-515):
    host tables, pack_blocks_tokw (K13b) and compact_payloads on tokw's
    device, one device→host copy of the meta and one of the payload and
    COPY bytes, the description OR, headers. The same streams as
    entropy_streams; adds the wall time of its stages to ``times``.
    Returns the streams, one per plane."""
    nb_per, lengths = block_layout(plane_len, nr_planes)
    t0 = time.perf_counter()
    codes, cbits, desc_bytes, desc_bits, is_fill = host_tables(hist_np,
                                                               lengths)
    t1 = time.perf_counter()
    times["tables"] = t1 - t0
    dev = tokw.device
    packed, total_bits = pack_blocks_tokw(tokw, codes, cbits, desc_bits)
    data, meta = compact_payloads(packed, bwords.view(torch.uint8),
                                  total_bits, _to_device(lengths, dev),
                                  _to_device(is_fill, dev))
    comp_len, copy_len, _ = np.split(meta.cpu().numpy().astype(np.int64), 3)
    data = data.cpu().numpy()
    t2 = time.perf_counter()
    times["pack"] = t2 - t1

    ncomp = int(comp_len.sum())
    tight = data[:ncomp]
    _or_descriptions(tight, comp_len, desc_bytes)
    streams = plane_streams(lengths, nb_per, nr_planes, tight, comp_len,
                            data[ncomp:], copy_len, is_fill,
                            fill_bytes_from_hist(hist_np))
    times["assemble"] = time.perf_counter() - t2
    return streams


# ---------------------------------------------------------------------------
# The stream encoder (jax_coder.py:740-751, 791-811, 899-948)
# ---------------------------------------------------------------------------

def split_blocks(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a byte buffer into (nb, B) blocks + lengths; an empty buffer
    is one block of length 0."""
    in_size = buf.size
    nb = max(1, -(-in_size // B))
    padded = np.zeros(nb * B, dtype=np.uint8)
    padded[:in_size] = buf
    lengths = np.full(nb, B, np.int32)
    if in_size % B:
        lengths[-1] = in_size % B
    if in_size == 0:
        lengths[0] = 0
    return padded.reshape(nb, B), lengths


def encode_blocks_device(blocks_np: np.ndarray, lengths_np: np.ndarray,
                         device, times: Optional[dict] = None):
    """Both passes and the host Huffman step for a block batch on
    ``device``: tokenize_blocks, host_tables, pack_blocks (K13a), one
    device→host copy of the rows and bit totals, then the tree
    descriptions ORed over each row's first bytes. With ``times``, adds
    the wall time of its stages (tokenize, tables, pack).

    Returns (packed (nb, n + 512) uint8, total_bits (nb,) int32,
    is_fill (nb,) bool) on the host, for assemble()."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    syms, extras, ebits, tvalid, hist = tokenize_blocks(
        _to_device(blocks_np, dev),
        _to_device(lengths_np.astype(np.int32), dev))
    hist_np = hist.cpu().numpy()
    t1 = time.perf_counter()
    codes, cbits, desc_bytes, desc_bits, is_fill = host_tables(hist_np,
                                                               lengths_np)
    t2 = time.perf_counter()
    packed, total_bits = pack_blocks(syms, extras, ebits, tvalid, codes,
                                     cbits, desc_bits)
    nb, w = packed.shape
    host = torch.cat([packed.reshape(-1),
                      total_bits.view(torch.uint8)]).cpu().numpy()
    packed_np = host[:nb * w].reshape(nb, w)
    packed_np[:, :DESC_STRIDE] |= desc_bytes
    if times is not None:
        times.update(tokenize=t1 - t0, tables=t2 - t1,
                     pack=time.perf_counter() - t2)
    return packed_np, host[nb * w:].view(np.int32), is_fill


def assemble(blocks_np, lengths_np, packed, total_bits, is_fill,
             out_capacity: Optional[int] = None) -> bytes:
    """Host assembly: headers, CRC32C, FILL and COPY fallbacks, concat
    (hzr_encode.c:369-407, 462-481, 499-544). A block is COPY when its
    payload exceeds its length or the space left (out_capacity - written
    - 7) or reaches 64 KiB; a block whose encoding does not fit the
    space left raises ValueError("hzr: output buffer too small")."""
    in_size = int(lengths_np.sum())
    parts: List[bytes] = [int(in_size).to_bytes(4, "little")]
    written = HEADER_SIZE
    for i in range(blocks_np.shape[0]):
        blen = int(lengths_np[i])
        if blen == 0:
            continue
        block = blocks_np[i, :blen]
        if is_fill[i]:
            crc = crc32c(block[:1])
            enc = ((0).to_bytes(2, "little") + int(crc).to_bytes(4, "little")
                   + bytes([ENCODING_FILL, int(block[0])]))
        else:
            payload_len = (int(total_bits[i]) + 7) // 8
            limit = blen
            if out_capacity is not None:
                limit = min(limit, out_capacity - written - BLOCK_HEADER_SIZE)
            if payload_len > limit or payload_len >= MAX_BLOCK_SIZE:
                crc = crc32c(block)
                enc = ((blen - 1).to_bytes(2, "little")
                       + int(crc).to_bytes(4, "little")
                       + bytes([ENCODING_COPY]) + block.tobytes())
            else:
                payload = packed[i, :payload_len]
                crc = crc32c(payload)
                enc = ((payload_len - 1).to_bytes(2, "little")
                       + int(crc).to_bytes(4, "little")
                       + bytes([ENCODING_HUFF_RLE]) + payload.tobytes())
        if out_capacity is not None and written + len(enc) > out_capacity:
            raise ValueError("hzr: output buffer too small")
        parts.append(enc)
        written += len(enc)
    return b"".join(parts)


def encode(data, out_capacity: Optional[int] = None, device=None) -> bytes:
    """hzr_encode of a byte string (bytes-like, or an ndarray taken as
    uint8) on the card, or on ``device`` ("cpu": the kernels' plain
    versions); raises without a card when no device is named. The
    stream equals rspt_tpu.hzr.pyref.encode's and jax_coder.encode's,
    out_capacity included (see assemble)."""
    dev = resolve_device(device)
    if isinstance(data, np.ndarray):
        buf = data.astype(np.uint8, copy=False).reshape(-1)
    else:
        buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    blocks_np, lengths_np = split_blocks(buf)
    packed, total_bits, is_fill = encode_blocks_device(blocks_np, lengths_np,
                                                       dev)
    return assemble(blocks_np, lengths_np, packed, total_bits, is_fill,
                    out_capacity)
