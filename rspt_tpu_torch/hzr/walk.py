"""Host walk of hzr streams for the device decoder (the port's copy of
rspt_tpu/hzr/jax_decoder.py:319-393, ``_walk_stream`` and its light
form ``_walk_stream_light``).

COPY and FILL blocks are resolved straight into the output; every
HUFF+RLE block is queued for the device as (payload, payload bits,
description bits, output offset, output length, tree, stored CRC32C).
The light walk, the decoder's, leaves the tree to the host runtime's
LUT builder (description bits -1, tree None); the full walk recovers
each tree in Python (pyref), the plain version.
"""

from __future__ import annotations

import numpy as np

from ..formats.hzr_constants import (
    BLOCK_HEADER_SIZE,
    ENCODING_COPY,
    ENCODING_FILL,
    ENCODING_HUFF_RLE,
    HEADER_SIZE,
    MAX_BLOCK_SIZE,
)
from . import pyref


def walk_stream(src: np.ndarray, out_size: int, gbase: int, out: np.ndarray,
                huff: list, light: bool = False) -> None:
    """Walk one stream's blocks; its output starts at ``out[gbase]``.

    The stored CRC32C field (hzr_encode.c:474-481) rides along as a
    content digest for binding decode hints. light: recover no tree."""
    pos = HEADER_SIZE
    left = out_size
    out_off = gbase
    while left > 0:
        blen = min(left, MAX_BLOCK_SIZE)
        if pos + BLOCK_HEADER_SIZE > src.size:
            raise ValueError("hzr: truncated block header")
        esz = int.from_bytes(src[pos:pos + 2].tobytes(), "little") + 1
        mode = src[pos + 6]
        dstart = pos + BLOCK_HEADER_SIZE
        if mode == ENCODING_COPY:
            if esz != blen or dstart + blen > src.size:
                raise ValueError("hzr: bad COPY block")
            out[out_off:out_off + blen] = src[dstart:dstart + blen]
            pos = dstart + blen
        elif mode == ENCODING_FILL:
            if dstart + 1 > src.size:
                raise ValueError("hzr: truncated FILL block")
            out[out_off:out_off + blen] = src[dstart]
            pos = dstart + 1
        elif mode == ENCODING_HUFF_RLE:
            if dstart + esz > src.size:
                raise ValueError("hzr: truncated block")
            payload = src[dstart:dstart + esz]
            dbits, tree = -1, None
            if not light:
                br = pyref._BitReader(memoryview(payload.tobytes()), 0,
                                      payload.size)
                tree = pyref._recover_tree(br)
                dbits = br.pos
            crc = int.from_bytes(src[pos + 2:pos + 6].tobytes(), "little")
            huff.append((payload, payload.size * 8, dbits, out_off, blen,
                         tree, crc))
            pos = dstart + esz
        else:
            raise ValueError("hzr: invalid encoding mode")
        out_off += blen
        left -= blen
