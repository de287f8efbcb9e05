"""Encode-time decode hints (the port's counterpart of
rspt_tpu/hzr/sidecar.py, ``plan_hints`` / ``finish_hints``, :63-153).

The device decoder's alignment fixpoint only finds where symbols start:
each segment lane's converged entry is the first symbol start at or
after its nominal boundary ``dbits + s * segw * 32``. The encoder's flat
pack knows every token's bit, so ``pack_flat_lanes`` writes those
entries while it packs; a first decode of the container then runs one
trusted sweep instead of the fixpoint.

The lanes are ``gpu_decoder.lane_rows``'s over every HUFF block in
stream order (the port's decoder routes no block to the host, so there
is no park area), and the digest is the decoder's own
(``_hints_digest`` over the stored CRC32C fields, the block geometry and
``LAYOUT_VERSION``). A stale or mismatched sidecar can only make the
decoder run its fixpoint, never decode wrongly. The streams are
byte-identical with or without hints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gpu_decoder import DecodeHints, _hints_digest, lane_rows, register_hints


@dataclass
class HintPlan:
    """Host half of an encode-time sidecar: the kernel's per-block lane
    meta and init plane, and what ``finish_hints`` needs for the digest."""
    meta: np.ndarray       # (nb, 3) int32: W = segw * 32, lane_base, dbits
    init: np.ndarray       # (nrows * 128,) int32 entries where no store lands
    nrows: int             # lane rows (the decoder's entry shape[0])
    huff: np.ndarray       # (nb,) HUFF blocks, the ones with lanes
    ooff: np.ndarray       # (nb,) each block's output offset
    olen: np.ndarray       # (nb,) each block's output length
    dbits: np.ndarray      # (nb,) description bits


def plan_hints(lengths, comp_len, desc_bits, is_huff) -> "HintPlan | None":
    """The lane layout the decoder will build for one container's
    blocks (plane-major, in stream order), or None when no block is
    HUFF (a decode then has nothing to hint).

    Inactive lanes start at their block's payload end, segment 0 at the
    description's end (it is exact), padding lanes at 0: the decoder's
    converged values where no token start is written."""
    huff = np.flatnonzero(is_huff)
    if huff.size == 0:
        return None
    comp_len = np.asarray(comp_len, np.int64)
    desc_bits = np.asarray(desc_bits, np.int64)
    rows, blk_rows = lane_rows([(int(comp_len[i]) * 8, int(desc_bits[i]))
                                for i in huff])
    row_base = {}
    for r, (k, _) in enumerate(rows):
        if k >= 0:
            row_base.setdefault(k, r)
    nb = len(lengths)
    meta = np.zeros((nb, 3), np.int32)
    meta[:, 0] = 256
    meta[:, 1] = -1
    meta[:, 2] = desc_bits
    init = np.zeros(len(rows) * 128, np.int32)
    for k, i in enumerate(huff):
        segw, nseg, _ = blk_rows[k]
        lo = row_base[k] * 128
        meta[i, 0] = segw * 32
        meta[i, 1] = lo
        init[lo:lo + nseg] = comp_len[i] * 8
        init[lo] = desc_bits[i]
    lengths = np.asarray(lengths, np.int64)
    return HintPlan(meta=meta, init=init, nrows=len(rows),
                    huff=np.asarray(is_huff, bool),
                    ooff=np.cumsum(lengths) - lengths, olen=lengths,
                    dbits=desc_bits)


def finish_hints(plan: HintPlan, entries: np.ndarray, crcs,
                 comp_len) -> DecodeHints:
    """DecodeHints from the kernel's entry lanes and the stored CRC32C
    fields of the HUFF blocks (``crcs[i]`` for block i, the ones the
    assembly wrote: the digest covers the payload after the description
    OR-merge). The hints are also registered with the decoder, so a
    later decode of the same streams runs hinted without being passed
    them."""
    parts = [(int(crcs[i]), int(comp_len[i]), int(plan.dbits[i]),
              int(plan.ooff[i]), int(plan.olen[i]))
             for i in np.flatnonzero(plan.huff)]
    hints = DecodeHints(_hints_digest(parts),
                        np.asarray(entries, np.int32).reshape(plan.nrows,
                                                              128))
    register_hints(hints)
    return hints
