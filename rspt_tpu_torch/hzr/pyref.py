"""Host half of the hzr codec — the port's own copy of the parts of
rspt_tpu/hzr/pyref.py it needs (the port imports nothing of rspt_tpu).

Kept: the greedy Huffman build with the reference's exact tie-breaking
(hzr_encode.c:222-283), the preorder tree serialization
(hzr_encode.c:177-219), LSB-first bit packing, the FILL-class test
(hzr_encode.c:285-305), the sequential block decoder
(hzr_decode.c:263-674) and hzr_verify (hzr_decode.c:569-624). Pure
Python/numpy: the plain versions that the port's host runtime
(rspt_tpu_torch/native) is held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..formats.crc32c import crc32c_plain
from ..formats.hzr_constants import (
    BLOCK_HEADER_SIZE,
    ENCODING_COPY,
    ENCODING_FILL,
    ENCODING_HUFF_RLE,
    HEADER_SIZE,
    MAX_BLOCK_SIZE,
    MAX_TREE_NODES,
    NUM_SYMBOLS,
    SYMBOL_SIZE,
)

# ---------------------------------------------------------------------------
# Huffman tree — exact replication of the reference's greedy build
# ---------------------------------------------------------------------------

@dataclass
class _Node:
    count: int
    symbol: int  # -1 for branch
    a: Optional["_Node"] = None
    b: Optional["_Node"] = None


def build_tree(hist: np.ndarray):
    """Greedy two-lightest-node Huffman build with the reference's exact
    tie-breaking (hzr_encode.c:222-283).

    The reference scans nodes[0..next_idx) each round; `<=` comparisons
    mean the *latest* scanned node with the minimal count becomes node_1
    and similar for node_2; internal nodes are appended after the leaves
    and participate in later scans.

    Returns (root, single_symbol) where single_symbol indicates the
    degenerate one-leaf tree (stored with bits=1, hzr_encode.c:278-282).
    """
    nodes: List[_Node] = [
        _Node(int(hist[k]), k) for k in range(NUM_SYMBOLS) if hist[k] > 0
    ]
    num_symbols = len(nodes)
    if num_symbols == 0:
        return None, False

    nodes_left = num_symbols
    root = None
    while nodes_left > 1:
        node_1 = None
        node_2 = None
        for nd in nodes:
            if nd.count > 0:
                if node_1 is None or nd.count <= node_1.count:
                    node_2 = node_1
                    node_1 = nd
                elif node_2 is None or nd.count <= node_2.count:
                    node_2 = nd
        root = _Node(node_1.count + node_2.count, -1, node_1, node_2)
        node_1.count = 0
        node_2.count = 0
        nodes.append(root)
        nodes_left -= 1

    if root is not None:
        return root, False
    # Single symbol: no branch; stored as a leaf with bits=1
    return nodes[0], True


def serialize_tree(root: _Node, single_symbol: bool):
    """Preorder tree description bits + per-symbol (code, bits) tables.

    Leaf: bit 1 + 9-bit symbol. Branch: bit 0, then child_a with code
    unchanged, child_b with bit `bits` set (LSB-first code growth)
    (reference: hzr_encode.c:177-219).

    Returns (desc_values, desc_nbits, codes[261], code_bits[261]).
    """
    desc_vals: List[int] = []
    desc_bits: List[int] = []
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint32)
    code_bits = np.zeros(NUM_SYMBOLS, dtype=np.int32)

    def store(node: _Node, code: int, bits: int):
        if node.symbol >= 0:
            desc_vals.append(1)
            desc_bits.append(1)
            desc_vals.append(node.symbol)
            desc_bits.append(SYMBOL_SIZE)
            codes[node.symbol] = code
            code_bits[node.symbol] = bits
            return
        desc_vals.append(0)
        desc_bits.append(1)
        store(node.a, code, bits + 1)
        store(node.b, code + (1 << bits), bits + 1)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * MAX_TREE_NODES))
    try:
        store(root, 0, 1 if single_symbol else 0)
    finally:
        sys.setrecursionlimit(old)
    return (np.asarray(desc_vals, np.uint64), np.asarray(desc_bits, np.int64),
            codes, code_bits)


# ---------------------------------------------------------------------------
# Bit packing (vectorized, LSB-first)
# ---------------------------------------------------------------------------

def pack_bits(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Pack (value, nbits) fields LSB-first into bytes.

    Equivalent to sequential WriteBits + ForceFlushBitCache
    (hzr_encode.c:94-113,77-90). Values must fit in their bit widths
    and each field must be ≤ 57 bits (tree symbols ≤ 9+1, tokens ≤
    code_bits+14 ≤ 37 in valid streams).

    Fields land at disjoint bit positions, so scatter-ADD == scatter-OR.
    """
    values = values.astype(np.uint64, copy=False)
    nbits = nbits.astype(np.int64, copy=False)
    offsets = np.concatenate(([0], np.cumsum(nbits)[:-1]))
    total_bits = int(nbits.sum())
    nbytes = (total_bits + 7) // 8
    out = np.zeros(nbytes + 8, dtype=np.uint8)

    byte_idx = (offsets >> 3).astype(np.int64)
    shift = (offsets & 7).astype(np.uint64)
    shifted = values << shift  # ≤ 57+7 = 64 bits, no overflow for our fields
    for j in range(8):
        contrib = ((shifted >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
        nz = contrib.nonzero()[0]
        if nz.size:
            np.add.at(out, byte_idx[nz] + j, contrib[nz])
    return out[:nbytes].tobytes()


# ---------------------------------------------------------------------------
# FILL-class test
# ---------------------------------------------------------------------------

def _only_single_code(hist: np.ndarray) -> bool:
    """True if all tokens fall in one 'code class' — zeros (symbol 0 or
    RLE symbols) count as a single class (reference: hzr_encode.c:285-305)."""
    has_zeros = hist[0] > 0 or hist[256:].sum() > 0
    num_nonzero_codes = int((hist[1:256] > 0).sum())
    return (num_nonzero_codes + (1 if has_zeros else 0)) == 1


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class _BitReader:
    """LSB-first bit reader (reference: hzr_decode.c:102-186)."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: memoryview, start: int, end: int):
        self.buf = buf
        self.pos = start * 8
        self.end = end * 8

    def read(self, nbits: int) -> int:
        if self.pos + nbits > self.end:
            raise ValueError("hzr: premature end of input")
        out = 0
        got = 0
        pos = self.pos
        while got < nbits:
            byte = self.buf[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, nbits - got)
            out |= ((byte >> (pos & 7)) & ((1 << take) - 1)) << got
            got += take
            pos += take
        self.pos = pos
        return out

    def byte_pos(self) -> int:
        return (self.pos + 7) >> 3


def _recover_tree(br: _BitReader):
    """Rebuild the tree (hzr_decode.c:263-333). Returns nested tuples:
    leaf = symbol int, branch = (a, b)."""
    count = [0]

    def rec(depth: int):
        count[0] += 1
        if count[0] >= MAX_TREE_NODES:
            raise ValueError("hzr: tree too large")
        if br.read(1):
            return br.read(SYMBOL_SIZE)
        if depth >= 300:
            raise ValueError("hzr: tree too deep")
        a = rec(depth + 1)
        b = rec(depth + 1)
        return (a, b)

    return rec(0)


def decode_block(src: memoryview, start: int, src_end: int, out_size: int
                 ) -> Tuple[bytes, int]:
    """Decode one block; returns (decoded bytes, next offset in src)."""
    if start + BLOCK_HEADER_SIZE > src_end:
        raise ValueError("hzr: truncated block header")
    encoded_size = int.from_bytes(src[start:start + 2], "little") + 1
    # CRC (src[start+2:start+6]) is not checked here — hzr_decode skips it
    # (hzr_decode.c:343); use verify() for CRC checking.
    mode = src[start + 6]
    data_start = start + BLOCK_HEADER_SIZE

    if mode == ENCODING_COPY:
        if encoded_size != out_size:
            raise ValueError("hzr: COPY size mismatch")
        if data_start + out_size > src_end:
            raise ValueError("hzr: truncated COPY block")
        return bytes(src[data_start:data_start + out_size]), data_start + out_size

    if mode == ENCODING_FILL:
        if data_start + 1 > src_end:
            raise ValueError("hzr: truncated FILL block")
        return bytes([src[data_start]]) * out_size, data_start + 1

    if mode != ENCODING_HUFF_RLE:
        raise ValueError("hzr: invalid encoding mode")

    block_end = data_start + encoded_size
    if block_end > src_end:
        raise ValueError("hzr: truncated block")
    br = _BitReader(src, data_start, block_end)
    tree = _recover_tree(br)

    out = bytearray()
    single_leaf = not isinstance(tree, tuple)
    while len(out) < out_size:
        if single_leaf:
            br.read(1)
            sym = tree
        else:
            node = tree
            while isinstance(node, tuple):
                node = node[br.read(1)]
            sym = node
        if sym <= 255:
            out.append(sym)
        elif sym == 256:
            out += b"\0\0"
        elif sym == 257:
            out += b"\0" * (br.read(2) + 3)
        elif sym == 258:
            out += b"\0" * (br.read(4) + 7)
        elif sym == 259:
            out += b"\0" * (br.read(8) + 23)
        elif sym == 260:
            out += b"\0" * (br.read(14) + 279)
        else:
            raise ValueError("hzr: invalid symbol")
    if len(out) != out_size:
        raise ValueError("hzr: output overrun")
    return bytes(out), br.byte_pos()


def decode(data, expected_size: Optional[int] = None) -> bytes:
    """hzr_decode equivalent (reference: hzr_decode.c:626-674)."""
    src = memoryview(bytes(data) if isinstance(data, np.ndarray) else data).cast("B")
    if len(src) < HEADER_SIZE:
        raise ValueError("hzr: input too small")
    out_size = int.from_bytes(src[0:4], "little")
    if expected_size is not None and out_size > expected_size:
        raise ValueError("hzr: insufficient output space")
    pos = HEADER_SIZE
    chunks = []
    left = out_size
    while left > 0:
        blk = min(left, MAX_BLOCK_SIZE)
        chunk, pos = decode_block(src, pos, len(src), blk)
        chunks.append(chunk)
        left -= blk
    return b"".join(chunks)


def decoded_size(data) -> int:
    src = memoryview(bytes(data) if isinstance(data, np.ndarray) else data).cast("B")
    return int.from_bytes(src[0:4], "little")


def verify(data) -> int:
    """hzr_verify equivalent: walk blocks and check CRC32C
    (reference: hzr_decode.c:569-624). Returns decoded size; raises on error."""
    src = memoryview(bytes(data) if isinstance(data, np.ndarray) else data).cast("B")
    if len(src) < HEADER_SIZE:
        raise ValueError("hzr: input too small")
    out_size = int.from_bytes(src[0:4], "little")
    pos = HEADER_SIZE
    left = out_size
    while left > 0:
        blk = min(left, MAX_BLOCK_SIZE)
        if pos + BLOCK_HEADER_SIZE > len(src):
            raise ValueError("hzr: truncated block header")
        encoded_size = int.from_bytes(src[pos:pos + 2], "little") + 1
        expected_crc = int.from_bytes(src[pos + 2:pos + 6], "little")
        mode = src[pos + 6]
        if mode > ENCODING_FILL:
            raise ValueError("hzr: unsupported encoding")
        payload = src[pos + BLOCK_HEADER_SIZE:pos + BLOCK_HEADER_SIZE + encoded_size]
        if crc32c_plain(np.frombuffer(payload, np.uint8)) != expected_crc:
            raise ValueError("hzr: CRC32C mismatch")
        if mode == ENCODING_FILL:
            pos += BLOCK_HEADER_SIZE + 1
        else:
            pos += BLOCK_HEADER_SIZE + encoded_size
        left -= blk
    return out_size
