"""hzr two-pass encoder around the CUDA kernels (counterpart of
rspt_tpu/hzr/jax_coder.py).

Host half (own copies of jax_coder.py:541-582, 754-788, 856-896 and the
fallback build_block_tables :211-229): per-block Huffman tables from the
histograms, the exact stream layout those imply, and the final
assembly (7-byte block headers, CRC32C, concatenation).

Device half: ``pack_tokens_flat``, the flat exact-offset pack
(jax_coder._pack_tokens_flat2_impl:585-676): valid tokens of every HUFF
block are compacted to a group-aligned flat stream (compact_tokens) and
each block's bits are placed straight into the final payload layout
(pack_flat). The JAX version's compaction splits and its flat-buffer
and token-row caps are TPU VMEM limits; the port has none of them, and
its flat path covers batches with COPY blocks too (their payload is
the raw plane bytes the tokenizer already wrote). With hints,
``pack_flat_lanes`` also writes the device decoder's segment entries
(hzr/sidecar.py, the want_hints branch of tpu.py:_entropy_streams).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..formats.crc32c import crc32c
from ..formats.hzr_constants import (
    ENCODING_COPY,
    ENCODING_FILL,
    ENCODING_HUFF_RLE,
    MAX_BLOCK_SIZE,
    NUM_SYMBOLS,
    SYMBOL_SIZE,
)
from ..ops import cuda_kernels as ck
from . import pyref, sidecar

B = MAX_BLOCK_SIZE  # 65536
MAX_DESC_BITS = (2 * NUM_SYMBOLS - 1) + SYMBOL_SIZE * NUM_SYMBOLS
DESC_STRIDE = (MAX_DESC_BITS + 7) // 8
GROUP_TOK_FLAT = 8192  # tokens per group; block token bases align to it

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
    """Per-block code LUTs, packed tree descriptions and FILL flags."""
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
    # the combined code | cbits << 24 LUT word needs cbits <= 23 — the
    # Huffman depth over <= 64Ki+261 weights is Fibonacci-bounded there
    if cbits.size and int(cbits.max()) > 23:
        raise ValueError("hzr: pathological code length")
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
    hoff: np.ndarray         # (nb,) payload offsets in the flat buffer
    bases: np.ndarray        # (nb,) int32 compacted token bases
    T: int                   # compacted tokens (group-aligned)
    ntok: np.ndarray         # (nb,) int32 tokens to pack, 0 if not HUFF
    bit0: np.ndarray         # (nb,) int64 first token bit
    lut: np.ndarray          # (nb, 261) int32 code | cbits << 24

    @property
    def total_payload(self) -> int:
        return int(self.comp_len.sum())

    @property
    def nwords(self) -> int:
        return self.total_payload // 4 + 1


def flat_plan(hist_np: np.ndarray, lengths_np: np.ndarray) -> FlatPlan:
    codes, cbits, desc_bytes, desc_bits, is_fill = host_tables(
        hist_np, lengths_np)
    _, comp_len, is_huff, is_copy = host_layout(
        hist_np, lengths_np, cbits, desc_bits, is_fill)
    hoff = np.cumsum(comp_len) - comp_len
    bases, T, _, _, _ = flat_compact_layout(hist_np, is_huff)
    return FlatPlan(
        desc_bytes=desc_bytes, desc_bits=desc_bits, is_fill=is_fill,
        is_copy=is_copy, comp_len=comp_len, hoff=hoff, bases=bases, T=T,
        ntok=np.where(is_huff, hist_np.sum(1), 0).astype(np.int32),
        bit0=(hoff * 8 + desc_bits).astype(np.int64),
        lut=lut_words(codes, cbits))


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


def entropy_streams(tokw, bwords, hist_np, plane_len: int, nr_planes: int,
                    times: dict, want_hints: bool = False):
    """One hzr stream per plane from tokenize_planes' outputs: host
    tables, the flat pack on tokw's device, one device→host copy of the
    payload words (and of COPY blocks' raw plane bytes), headers. Adds
    the wall time of its stages to ``times``.

    Returns (streams, hints): with want_hints, the pack also writes the
    decoder's segment entries (hzr/sidecar.py) and hints are the
    DecodeHints of a decode of these streams in order (None when no
    block is HUFF); else None."""
    nb_per, lengths = block_layout(plane_len, nr_planes)
    t0 = time.perf_counter()
    plan = flat_plan(hist_np, lengths)
    hplan = (sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                                plan.comp_len > 0) if want_hints else None)
    t1 = time.perf_counter()
    times["tables"] = t1 - t0

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(tokw.device)

    lanes = None if hplan is None else (d(hplan.meta), d(hplan.init))
    res = pack_tokens_flat(tokw, d(plan.bases), plan.T, d(plan.ntok),
                           d(plan.bit0), d(plan.lut), plan.nwords, lanes)
    words, entries = res if lanes is not None else (res, None)
    copy_rows = np.flatnonzero(plan.is_copy)
    copy_len = np.where(plan.is_copy, lengths, 0).astype(np.int64)
    copy_np = np.zeros(0, np.uint8)
    if copy_rows.size:
        raw = bwords[d(copy_rows)].cpu().numpy().view(np.uint8)
        copy_np = np.concatenate([raw[j, :lengths[b]]
                                  for j, b in enumerate(copy_rows)])
    tight = words.cpu().numpy().view(np.uint8)[:plan.total_payload].copy()
    if entries is not None:
        entries = entries.cpu().numpy()
    t2 = time.perf_counter()
    times["pack"] = t2 - t1

    hoff, comp_len = plan.hoff, plan.comp_len
    for i in np.flatnonzero(comp_len):
        dlen = min(DESC_STRIDE, int(comp_len[i]))
        tight[hoff[i]:hoff[i] + dlen] |= plan.desc_bytes[i, :dlen]
    fill_byte = fill_bytes_from_hist(hist_np)
    coff = np.cumsum(copy_len) - copy_len
    crcs = np.zeros(len(lengths), np.int64)
    streams = []
    for k in range(nr_planes):
        s = slice(k * nb_per, (k + 1) * nb_per)
        streams.append(assemble_compact(
            lengths[s], tight[hoff[s.start]:], comp_len[s],
            copy_np[coff[s.start]:], copy_len[s], plan.is_fill[s],
            fill_byte[s], crcs[s]))
    hints = None
    if hplan is not None:
        hints = sidecar.finish_hints(hplan, entries, crcs, comp_len)
    times["assemble"] = time.perf_counter() - t2
    return streams, hints


def encode(data, device) -> bytes:
    """hzr_encode of a byte string on ``device`` (the streams equal
    rspt_tpu.hzr.pyref.encode's): its bytes are tokenized as one plane
    and packed by the flat path."""
    raw = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    if raw.size == 0:
        raise ValueError("hzr: nothing to encode")
    x = torch.from_numpy(raw.astype(np.int32)).to(device)
    tokw, bwords, hist = ck.tokenize_planes(x, 1)
    return entropy_streams(tokw, bwords, hist.cpu().numpy(), raw.size, 1,
                           {})[0][0]
