"""Exact int32 signal ops on torch tensors (counterpart of
rspt_tpu/ops/jax_ops.py:43-230), and the hzr zero-run tokenizer as
torch ops (the body of rspt_tpu/hzr/jax_coder.py:tokenize_blocks).

All arithmetic is int32 two's-complement wraparound, as in the
reference's C loops (utils.cpp:123-236, signal_packer_base.cpp:40-138).
Torch gives no wrap guarantee for signed int32 overflow and its ``>>``
on int32 is arithmetic, so every op that can overflow or needs a
logical shift widens to int64, masks, and wraps back with ``_wrap32``.
The ops run on whatever device their input lies on.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.hzr_constants import MAX_ZERO_RUN, NUM_SYMBOLS

_M32 = 0xFFFFFFFF


def _wrap32(x64: torch.Tensor) -> torch.Tensor:
    """int64 → int32 modulo 2**32 (two's complement)."""
    return (((x64 + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def _sign_extend(v64: torch.Tensor, bits: int) -> torch.Tensor:
    """Non-negative int64 holding ``bits`` bits → its signed value."""
    return v64 - (((v64 >> (bits - 1)) & 1) << bits)


def native_to_i32(native: torch.Tensor, nr_samples: int, nr_channels: int,
                  bytes_per_sample: int) -> torch.Tensor:
    """Interleaved native samples → (channels, samples) int32.

    ``native`` is either the '<i4' word view (bps 4: pure layout) or the
    flat u8 bytes ``[s0c0][s0c1]...`` (any bps), sign-extended from bit
    8*bps-1. The word path returns a transposed view."""
    n = nr_samples * nr_channels
    if native.dtype == torch.int32:
        if bytes_per_sample != 4:
            raise ValueError("int32 word input needs bytes_per_sample=4")
        return native[:n].reshape(nr_samples, nr_channels).T
    bps = bytes_per_sample
    b = native[:n * bps].reshape(nr_samples, nr_channels, bps).to(torch.int64)
    v = torch.zeros((nr_samples, nr_channels), dtype=torch.int64,
                    device=native.device)
    for k in range(bps):
        v |= b[..., k] << (8 * k)
    return _wrap32(_sign_extend(v, 8 * bps)).T


def i32_to_native(arr: torch.Tensor, bytes_per_sample: int) -> torch.Tensor:
    """(channels, samples) int32 → interleaved native low bytes, flat u8."""
    v = arr.T.to(torch.int64) & _M32
    b = torch.stack([(v >> (8 * k)) & 255 for k in range(bytes_per_sample)],
                    dim=-1)
    return b.to(torch.uint8).reshape(-1)


def delta_encode(a: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.int64)
    prev = torch.cat([torch.zeros_like(a[:1]), a[:-1]])
    return _wrap32(a - prev)


def delta_decode(a: torch.Tensor) -> torch.Tensor:
    """Inverse of delta_encode: int32 wraparound prefix sum (torch's
    int32 cumsum returns int64, so the wrap is explicit)."""
    return _wrap32(torch.cumsum(a.reshape(-1).to(torch.int64), 0))


def offset32(a: torch.Tensor, val: int) -> torch.Tensor:
    return _wrap32(a.to(torch.int64) + int(val))


def xor_encode(a: torch.Tensor) -> torch.Tensor:
    a = a.to(torch.int32)
    prev = torch.cat([torch.zeros_like(a[:1]), a[:-1]])
    return a ^ prev


def xor_decode(a: torch.Tensor) -> torch.Tensor:
    """Prefix-xor (inverse of xor_encode) as a log-step doubling scan:
    torch has no prefix-xor."""
    x = a.reshape(-1).to(torch.int32).clone()
    p = 1
    while p < x.numel():
        x[p:] = x[p:] ^ x[:-p]
        p *= 2
    return x


def plane_split(flat_i32: torch.Tensor, nr_planes: int) -> torch.Tensor:
    """(N,) int32 → (nr_planes, N) uint8, plane k = byte k (LSB first).
    The arithmetic shift fills only bits above byte k, which the mask
    drops."""
    v = flat_i32.to(torch.int32)
    return torch.stack([((v >> (8 * k)) & 255).to(torch.uint8)
                        for k in range(nr_planes)])


def plane_merge(planes: torch.Tensor) -> torch.Tensor:
    """(nr_planes, N) uint8 → (N,) int32, sign-extended from the top
    plane (signal_packer_base.cpp:122-138)."""
    p = planes.shape[0]
    v = torch.zeros(planes.shape[1], dtype=torch.int64, device=planes.device)
    for k in range(p):
        v |= planes[k].to(torch.int64) << (8 * k)
    return _wrap32(_sign_extend(v, 8 * p))


def _run_fields(L: torch.Tensor):
    """RLE (sym, extra, ebits) of zero-run chunk lengths L
    (hzr_internal.h:117-121)."""
    w = torch.where
    sym = w(L == 1, 0, w(L == 2, 256, w(L <= 6, 257, w(
        L <= 22, 258, w(L <= 278, 259, 260)))))
    extra = w(L <= 2, 0, w(L <= 6, L - 3, w(L <= 22, L - 7, w(
        L <= 278, L - 23, L - 279))))
    ebits = w(L <= 2, 0, w(L <= 6, 2, w(L <= 22, 4, w(L <= 278, 8, 14))))
    return sym, extra, ebits


def rle_tokenize(byte: torch.Tensor, limit: torch.Tensor):
    """Zero-run tokenization of rows of bytes, a token at the position
    of its first byte (hzr_encode.c:133-173): greedy zero runs capped at
    MAX_ZERO_RUN, never crossing a row's end; single zeros carry sym 0.

    byte: (nb, n) int32 in 0..255; limit: (nb, 1) int32, the row's
    length (positions at or past it hold no token). Returns int32 sym,
    extra, ebits (nb, n), bool valid (nb, n) and int32 hist (nb, 261)."""
    nb, n = byte.shape
    idx = torch.arange(n, dtype=torch.int32, device=byte.device).expand(nb, n)
    inblk = idx < limit
    iszero = (byte == 0) & inblk
    # last non-zero strictly before i, first non-zero at/after i
    lnb = torch.cummax(torch.where(iszero, -1, idx), dim=1).values
    prev = torch.cat([torch.full_like(lnb[:, :1], -1), lnb[:, :-1]], 1)
    run_start = prev + 1
    fna = torch.where(iszero, n, idx).flip(1)
    fna = torch.cummin(fna, dim=1).values.flip(1)
    run_end = torch.minimum(fna, limit) - 1
    is_cs = iszero & ((idx - run_start) % MAX_ZERO_RUN == 0)
    run_sym, run_extra, run_ebits = _run_fields(
        torch.clamp(run_end - idx + 1, max=MAX_ZERO_RUN))
    is_lit = ~iszero & inblk
    valid = is_lit | is_cs
    sym = torch.where(is_lit, byte, torch.where(is_cs, run_sym, 0))
    extra = torch.where(is_cs, run_extra, 0)
    ebits = torch.where(is_cs, run_ebits, 0)
    kw = dict(dtype=torch.int32, device=byte.device)
    hist = torch.zeros((nb, NUM_SYMBOLS + 1), **kw)
    hist.scatter_add_(1, torch.where(valid, sym, NUM_SYMBOLS).to(torch.int64),
                      torch.ones((nb, n), **kw))
    return (sym.to(torch.int32), extra.to(torch.int32),
            ebits.to(torch.int32), valid, hist[:, :NUM_SYMBOLS])


def row_sums64(a: torch.Tensor) -> torch.Tensor:
    """(channels, n) int32 → (channels,) exact int64 row sums (the
    reference's int64 accumulator, utils.cpp:30-40; jax_ops.sum64_parts
    splits it into hi/lo int32 halves only because a TPU has no int64)."""
    return a.to(torch.int64).sum(dim=-1)


def average32_host(sums, n: int) -> np.ndarray:
    """The reference's quirky per-channel mean from exact int64 sums:
    the int64 sum divided by a size_t, an unsigned 64-bit division, then
    truncated to int32 by the return type (utils.cpp:38)."""
    out = []
    for s in np.atleast_1d(np.asarray(sums, np.int64)):
        q = ((int(s) % (1 << 64)) // n) & 0xFFFFFFFF
        out.append(q - (1 << 32) if q >= (1 << 31) else q)
    return np.asarray(out, dtype=np.int32)


def _trunc_div_pow2(a: torch.Tensor, d: int) -> torch.Tensor:
    """int32 a / d truncated toward zero, d = 2^j, computed in int64 so
    that INT32_MIN is exact (the reference's int /= double)."""
    if d <= 0 or d & (d - 1):
        raise ValueError("divisor must be a power of two")
    return torch.div(a.to(torch.int64), d,
                     rounding_mode="trunc").to(torch.int32)


def fwht_normalize_pow2(a: torch.Tensor, n: int,
                        ratio: float = 1.0) -> torch.Tensor:
    """Encode quantization x = trunc(x / (n / ratio)) (fwht.c:30-34) for
    n / ratio a power of two. jax_ops.fwht_normalize_pow2 negates,
    shifts and negates in int32, which gives +2^31 / d for INT32_MIN;
    this follows the reference (and nops.fwht_normalize): -2^31 / d."""
    d = n / ratio
    if int(d) != d:
        raise ValueError("n / ratio must be a power of two")
    return _trunc_div_pow2(a, int(d))


def fwht_normalize2_int(a: torch.Tensor, ratio: float = 1.0) -> torch.Tensor:
    """Decode dequantization x = trunc(x / ratio) (fwht.c:36-40) for a
    power-of-two ratio; the identity at the packer's ratio 1."""
    if ratio == 1.0:
        return a.to(torch.int32)
    if int(ratio) != ratio:
        raise ValueError("ratio must be a power of two")
    return _trunc_div_pow2(a, int(ratio))


def dct_cos_table(n: int) -> np.ndarray:
    """float32 cosine table COS[i][j] = cos(j * (2i + 1) * pi / (2n)),
    from np.cos in f64 on the host as the reference builds it
    (signal_packer_dct.cpp:60-74; the port's copy of
    numpy_ops.dct_cos_table). The forward DCT reads COS[x][i], the
    inverse COS[i][x]: a device cos is not correctly rounded."""
    i = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(((2 * i) * j + j) * (np.pi / (2.0 * n))).astype(np.float32)


def dct_cs(n: int) -> np.ndarray:
    """float32 DCT normalisation: 1/sqrt(2) for the DC term, else 1."""
    cs = np.ones(n, dtype=np.float32)
    cs[0] = np.float32(1.0 / np.sqrt(2.0))
    return cs


def dct_forward_scale(cs: np.ndarray, quality: float) -> np.ndarray:
    """The forward's per-output factor `cs[i] * ratio1 / quality`, f64,
    evaluated left to right as the C expression is (ratio1 =
    sqrt(2.0 / n)); folding ratio1 / quality into one constant would
    round differently."""
    ratio1 = np.sqrt(2.0 / cs.size)
    return (cs.astype(np.float64) * ratio1) / np.float64(quality)


def dct_inverse_scale(n: int, quality: float) -> float:
    """The inverse's factor `ratio1 * quality`, one f64."""
    return float(np.sqrt(2.0 / n) * np.float64(quality))
