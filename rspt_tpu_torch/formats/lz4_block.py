"""LZ4 block format — executable Python spec (the port's copy of
rspt_tpu/formats/lz4_block.py).

The reference vendors lz4.c/lz4hc.c as a *dormant* alternate plane
backend: the calls sit commented out on the per-plane boundary
(signal_packer_base.cpp:26-28,73-76,107-109 in the reference). This
module is the clean-room spec implementation of the public LZ4 block
format. The packers never call it: their plane codec is the port's host
runtime (native/bindings.py lz4_compress, lz4_compress_hc,
lz4_decompress and the plane batches), whose greedy encoder writes other
(equally valid) bytes than this one's. The tests use it as a second,
independent decoder.

Block format:
    sequence := token (1 byte: high nibble = literal length,
                       low nibble = match length - 4)
                [literal length extension: 255* then a byte < 255]
                literals
                offset (2 bytes little-endian, 1..65535)
                [match length extension: 255* then a byte < 255]
    The final sequence carries literals only. Encoders keep the last
    5 bytes as literals and start no match within the last 12 bytes.
"""

from __future__ import annotations

_MIN_MATCH = 4
_LAST_LITERALS = 5
_MF_LIMIT = 12
_MAX_OFFSET = 65535


def max_compressed_size(n: int) -> int:
    return n + n // 255 + 16


def _emit_len(extra: int, out: bytearray) -> int:
    """Returns the nibble value; appends extension bytes to out."""
    if extra < 15:
        return extra
    rem = extra - 15
    while rem >= 255:
        out.append(255)
        rem -= 255
    out.append(rem)
    return 15


def compress(data: bytes) -> bytes:
    """Greedy single-candidate compressor (hash of 4-byte prefixes).

    Correctness-first spec code: every output stream is a valid LZ4
    block decodable by any conformant decoder (including the
    reference's vendored LZ4_decompress_safe).
    """
    data = bytes(data)
    n = len(data)
    out = bytearray()

    def emit_seq(anchor: int, ip: int, mlen: int, off: int) -> None:
        lit = ip - anchor
        ext = bytearray()
        lnib = _emit_len(lit, ext)
        token_pos = len(out)
        out.append(lnib << 4)
        out.extend(ext)
        out.extend(data[anchor:ip])
        if mlen:
            out.append(off & 0xFF)
            out.append(off >> 8)
            ext2 = bytearray()
            mnib = _emit_len(mlen - _MIN_MATCH, ext2)
            out[token_pos] |= mnib
            out.extend(ext2)

    if n <= _MF_LIMIT:
        emit_seq(0, n, 0, 0)
        return bytes(out)

    table: dict = {}
    mflimit = n - _MF_LIMIT
    matchlimit = n - _LAST_LITERALS
    anchor = 0
    ip = 1
    table[data[0:_MIN_MATCH]] = 0
    while ip <= mflimit:
        key = data[ip:ip + _MIN_MATCH]
        cand = table.get(key, -1)
        table[key] = ip
        if cand < 0 or ip - cand > _MAX_OFFSET:
            ip += 1
            continue
        # extend forwards then backwards
        m = _MIN_MATCH
        while ip + m < matchlimit and data[cand + m] == data[ip + m]:
            m += 1
        while ip > anchor and cand > 0 and data[ip - 1] == data[cand - 1]:
            ip -= 1
            cand -= 1
            m += 1
        emit_seq(anchor, ip, m, ip - cand)
        ip += m
        anchor = ip
        if ip <= mflimit:
            table[data[ip - 2:ip + 2]] = ip - 2
    emit_seq(anchor, n, 0, 0)
    return bytes(out)


def decompress(src: bytes, out_len: int) -> bytes:
    """Bounds-checked block decode; raises ValueError on malformed
    input (LZ4_decompress_safe semantics)."""
    src = bytes(src)
    n = len(src)
    if n == 0:
        raise ValueError("lz4: empty input")
    out = bytearray()
    ip = 0
    while True:
        if ip >= n:
            raise ValueError("lz4: truncated token")
        token = src[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[ip]
                ip += 1
                lit += b
                if b != 255:
                    break
        if ip + lit > n or len(out) + lit > out_len:
            raise ValueError("lz4: literal overflow")
        out.extend(src[ip:ip + lit])
        ip += lit
        if ip == n:
            break  # final, literals-only sequence
        if ip + 2 > n:
            raise ValueError("lz4: truncated offset")
        off = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if off == 0 or off > len(out):
            raise ValueError("lz4: bad offset")
        mlen = (token & 15) + _MIN_MATCH
        if (token & 15) == 15:
            while True:
                if ip >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[ip]
                ip += 1
                mlen += b
                if b != 255:
                    break
        if len(out) + mlen > out_len:
            raise ValueError("lz4: match overflow")
        start = len(out) - off
        for i in range(mlen):  # byte-wise: overlapping matches replicate
            out.append(out[start + i])
    if len(out) != out_len:
        raise ValueError("lz4: size mismatch")
    return bytes(out)
