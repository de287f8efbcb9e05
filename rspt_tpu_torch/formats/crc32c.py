"""CRC32C (Castagnoli, polynomial 0x82F63B78, reflected).

Convention: init 0xFFFFFFFF, process reflected, final xor 0xFFFFFFFF —
matching the reference's table fallback (lib_rspt/lib_hzr/hzr_crc32c.c:76-84).

``crc32c`` runs in the port's host runtime (rspt_tpu_torch/native: the
CPU's CRC32C instruction when it has one). ``crc32c_plain`` is the
port's own copy of rspt_tpu/formats/crc32c.py, the slice-by-8 spec in
numpy, kept as the oracle.
"""

from __future__ import annotations

import numpy as np

from ..native import bindings as _native

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        table[i] = crc
    return table


_TABLE = _make_table()

# Slice-by-8 tables: _TABLES[j][b] advances byte b through 8-j more bytes.
_TABLES = np.zeros((8, 256), dtype=np.uint32)
_TABLES[0] = _TABLE
for _j in range(1, 8):
    _TABLES[_j] = _TABLE[_TABLES[_j - 1] & 0xFF] ^ (_TABLES[_j - 1] >> np.uint32(8))


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data`` (bytes-like or uint8 ndarray); ``crc`` is the
    CRC32C of the bytes before it."""
    return _native.crc32c(data, crc)


def crc32c_plain(data, crc: int = 0) -> int:
    """crc32c in numpy, slice-by-8."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False)
    c = np.uint32(~np.uint32(crc) & 0xFFFFFFFF)

    n8 = len(buf) // 8 * 8
    if n8:
        chunks = buf[:n8].reshape(-1, 8).astype(np.uint32)
        t = _TABLES
        for row in chunks:
            x = c ^ (row[0] | (row[1] << np.uint32(8)) |
                     (row[2] << np.uint32(16)) | (row[3] << np.uint32(24)))
            c = (t[7][x & 0xFF] ^ t[6][(x >> np.uint32(8)) & 0xFF] ^
                 t[5][(x >> np.uint32(16)) & 0xFF] ^ t[4][x >> np.uint32(24)] ^
                 t[3][row[4]] ^ t[2][row[5]] ^ t[1][row[6]] ^ t[0][row[7]])
    for b in buf[n8:]:
        c = _TABLE[(c ^ b) & np.uint32(0xFF)] ^ (c >> np.uint32(8))
    return int(~c & np.uint32(0xFFFFFFFF))
