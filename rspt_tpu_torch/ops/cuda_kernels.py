"""The port's hand-written CUDA kernels: ctypes wrappers, each beside a
plain PyTorch version of the same function.

A wrapper given CPU tensors computes with the plain version; given CUDA
tensors it launches its kernel (``csrc/*.cu``, built by ``_build`` at
first use) on the current stream, or raises. Nothing falls back from
the kernel to the plain version. Each wrapper counts its kernel
launches in its ``launches`` attribute. The plain versions run on any
device, so a run on the card can hold each kernel against its plain
version on the same inputs.

Each replaces (rspt_tpu/ops/pallas_kernels.py):
  xdelta_swizzle   K1 xdelta_preprocess_pallas, with the native_to_i32
                   transpose and the verify-and-grow flag
  tokenize_planes  K2 tokenize_planes_pallas, with hist_from_tokw
  compact_tokens   K3 compact_tokens_pallas
  pack_flat        K4 token_group_windows_rows_pallas, the cumsum glue
                   and K5 super_place_flat_pallas
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from . import torch_ops as tops

B = 65536             # positions per slab (hzr MAX_BLOCK_SIZE)
MZR = 16662           # MAX_ZERO_RUN
NUM_SYMBOLS = 261
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Binding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "rspt_xdelta_swizzle": [P, P, P, I, I, I, I, I, P],
        "rspt_tokenize_planes": [P, P, P, P, I, I, I, P],
        "rspt_compact_tokens": [P, P, P, I, I, I, I, P],
        "rspt_pack_flat": [P, P, P, P, P, P, I, I, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = I
    return lib


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False if every tensor lies on the CPU, True if every one lies on
    the same CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        names = sorted(map(str, devs))
        raise ValueError(f"tensors on several devices: {names}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


# ---------------------------------------------------------------------------
# Kernel 1 — xdelta_swizzle (K1)
# ---------------------------------------------------------------------------

def _fits_planes(enc: torch.Tensor, nr_planes: int) -> torch.Tensor:
    """(1,) int32: 1 if every value fits nr_planes signed bytes
    (packers/tpu.py:169-174), else 0."""
    if nr_planes >= 4:
        return torch.ones(1, dtype=torch.int32, device=enc.device)
    lim = 1 << (8 * nr_planes - 1)
    ok = ((enc >= -lim) & (enc < lim)).all()
    return ok.to(torch.int32).reshape(1)


def xdelta_swizzle_plain(x: torch.Tensor, nr_samples: int, nr_channels: int,
                         nr_planes: int, swizzle: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = nr_samples * nr_channels
    v = x[:n].reshape(nr_samples, nr_channels).T.reshape(-1) if swizzle \
        else x[:n]
    enc = tops.xor_encode(tops.offset32(tops.delta_encode(v), -128))
    return enc, _fits_planes(enc, nr_planes)


def xdelta_swizzle(x: torch.Tensor, nr_samples: int, nr_channels: int,
                   nr_planes: int, swizzle: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat xdelta (delta → offset −128 → xor, int32 wrap) of the signal,
    channel-major, and the verify-and-grow flag.

    x: int32, the interleaved '<i4' sample words (swizzle=True, bps 4)
    or the channel-major int32 signal (swizzle=False, after the u8
    native_to_i32 path for bps 2/3). Returns (enc (n,) int32,
    ok (1,) int32)."""
    n = nr_samples * nr_channels
    _check(x, "x", torch.int32)
    if x.dim() != 1 or x.numel() < n or n <= 0 or n >= 2**31:
        raise ValueError(f"x: need 1-D with >= {n} > 0 words")
    if not 1 <= nr_planes <= 4:
        raise ValueError("nr_planes must be 1..4")
    if not _on_cuda(x):
        return xdelta_swizzle_plain(x, nr_samples, nr_channels, nr_planes,
                                    swizzle)
    enc = torch.empty(n, dtype=torch.int32, device=x.device)
    ok = torch.ones(1, dtype=torch.int32, device=x.device)
    _launch("xdelta_swizzle", _lib().rspt_xdelta_swizzle, x.data_ptr(),
            enc.data_ptr(), ok.data_ptr(), n, nr_samples, nr_channels,
            int(swizzle), nr_planes, device=x.device)
    xdelta_swizzle.launches += 1
    return enc, ok


xdelta_swizzle.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2 — tokenize_planes (K2 + hist_from_tokw)
# ---------------------------------------------------------------------------

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


def tokenize_planes_plain(enc: torch.Tensor, nr_planes: int):
    plane_len = enc.numel()
    dev = enc.device
    nb_per = max(1, -(-plane_len // B))
    xp = torch.zeros(nb_per * B, dtype=torch.int32, device=dev)
    xp[:plane_len] = enc
    slabs = xp.reshape(nb_per, B)
    idx = torch.arange(B, dtype=torch.int32, device=dev).expand(nb_per, B)
    limit = torch.full((nb_per, 1), B, dtype=torch.int32, device=dev)
    limit[-1] = plane_len - (nb_per - 1) * B
    inblk = idx < limit
    tokws, bws, hists = [], [], []
    for p in range(nr_planes):
        byte = (slabs >> (8 * p)) & 255
        q = byte.reshape(nb_per, B // 4, 4).to(torch.int64)
        bws.append(tops._wrap32(q[..., 0] | (q[..., 1] << 8)
                                | (q[..., 2] << 16) | (q[..., 3] << 24)))
        iszero = (byte == 0) & inblk
        # last non-zero strictly before i, first non-zero at/after i
        lnb = torch.cummax(torch.where(iszero, -1, idx), dim=1).values
        prev = torch.cat([torch.full_like(lnb[:, :1], -1), lnb[:, :-1]], 1)
        run_start = prev + 1
        fna = torch.where(iszero, B, idx).flip(1)
        fna = torch.cummin(fna, dim=1).values.flip(1)
        run_end = torch.minimum(fna, limit) - 1
        is_cs = iszero & ((idx - run_start) % MZR == 0)
        run_sym, run_extra, run_ebits = _run_fields(
            torch.clamp(run_end - idx + 1, max=MZR))
        is_lit = ~iszero & inblk
        valid = is_lit | is_cs
        sym = torch.where(is_lit, byte, torch.where(is_cs, run_sym, 0))
        extra = torch.where(is_cs, run_extra, 0)
        ebits = torch.where(is_cs, run_ebits, 0)
        tokws.append((sym | (ebits << 9) | (extra << 13)
                      | (valid.to(torch.int32) << 27)).to(torch.int32))
        h = torch.zeros((nb_per, NUM_SYMBOLS + 1), dtype=torch.int32,
                        device=dev)
        h.scatter_add_(1, torch.where(valid, sym, NUM_SYMBOLS).to(torch.int64),
                       torch.ones_like(sym, dtype=torch.int32))
        hists.append(h[:, :NUM_SYMBOLS])
    return torch.cat(tokws), torch.cat(bws), torch.cat(hists)


def tokenize_planes(enc: torch.Tensor, nr_planes: int):
    """Plane extract + zero-run tokenize + histograms of a flat int32
    signal, per 64 KiB slab and byte plane (hzr_encode.c:133-173).

    Returns (tokw (nb, 65536), bwords (nb, 16384), hist (nb, 261)), all
    int32, nb = nr_planes * ceil(plane_len / 65536), plane-major rows:
    the token words sym | ebits<<9 | extra<<13 | valid<<27, the plane
    bytes 4 per little-endian word, and each block's 261-bin histogram
    (single zeros count under sym 0)."""
    _check(enc, "enc", torch.int32)
    plane_len = enc.numel()
    if enc.dim() != 1 or plane_len <= 0 or plane_len >= 2**31:
        raise ValueError("enc: need a non-empty 1-D signal")
    if not 1 <= nr_planes <= 4:
        raise ValueError("nr_planes must be 1..4")
    if not _on_cuda(enc):
        return tokenize_planes_plain(enc, nr_planes)
    nb_per = -(-plane_len // B)
    nb = nr_planes * nb_per
    kw = dict(dtype=torch.int32, device=enc.device)
    tokw = torch.empty((nb, B), **kw)
    bwords = torch.empty((nb, B // 4), **kw)
    hist = torch.empty((nb, NUM_SYMBOLS), **kw)
    _launch("tokenize_planes", _lib().rspt_tokenize_planes, enc.data_ptr(),
            tokw.data_ptr(), bwords.data_ptr(), hist.data_ptr(), plane_len,
            nr_planes, nb_per, device=enc.device)
    tokenize_planes.launches += 1
    return tokw, bwords, hist


tokenize_planes.launches = 0


# ---------------------------------------------------------------------------
# Kernel 3 — compact_tokens (K3)
# ---------------------------------------------------------------------------

def compact_tokens_plain(tokw: torch.Tensor, bases: torch.Tensor,
                         t_total: int, nonzero_valid: bool = False):
    valid = tokw != 0 if nonzero_valid else ((tokw >> 27) & 1) != 0
    base = bases.to(torch.int64)[:, None]
    dst = base + torch.cumsum(valid, dim=1) - 1
    keep = valid & (base >= 0) & (base < t_total) & (dst < t_total)
    out = torch.zeros(t_total, dtype=torch.int32, device=tokw.device)
    out[dst[keep]] = tokw[keep]
    return out


def compact_tokens(tokw: torch.Tensor, bases: torch.Tensor, t_total: int,
                   nonzero_valid: bool = False) -> torch.Tensor:
    """Order-preserving compaction: row b's valid words (bit 27, or
    != 0 under nonzero_valid) land in order at bases[b] of a zeroed
    (t_total,) int32 buffer. Rows with bases[b] >= t_total write
    nothing; nothing is written past t_total."""
    _check(tokw, "tokw", torch.int32)
    if tokw.dim() != 2:
        raise ValueError("tokw: need (nb, ntok)")
    nb, ntok = tokw.shape
    _check(bases, "bases", torch.int32, (nb,))
    if not 0 <= t_total < 2**31 or ntok >= 2**31:
        raise ValueError("t_total out of range")
    if not _on_cuda(tokw, bases):
        return compact_tokens_plain(tokw, bases, t_total, nonzero_valid)
    out = torch.zeros(t_total, dtype=torch.int32, device=tokw.device)
    if nb == 0 or t_total == 0:
        return out
    _launch("compact_tokens", _lib().rspt_compact_tokens, tokw.data_ptr(),
            bases.data_ptr(), out.data_ptr(), nb, ntok, t_total,
            int(nonzero_valid), device=tokw.device)
    compact_tokens.launches += 1
    return out


compact_tokens.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4 — pack_flat (K4 + cumsum glue + K5)
# ---------------------------------------------------------------------------

def pack_flat_plain(tokc: torch.Tensor, tok_base: torch.Tensor,
                    ntok: torch.Tensor, bit0: torch.Tensor, lut: torch.Tensor,
                    nwords: int) -> torch.Tensor:
    dev = tokc.device
    n = ntok.to(torch.int64).clamp(min=0)
    blk = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    start = torch.cumsum(n, 0) - n
    local = torch.arange(blk.numel(), device=dev) - start[blk]
    w = tokc[tok_base.to(torch.int64)[blk] + local].to(torch.int64)
    sym = w & 511
    live = (((w >> 27) & 1) != 0) & (sym < NUM_SYMBOLS)
    e = lut[blk, sym.clamp(max=NUM_SYMBOLS - 1)].to(torch.int64) & _M32
    cb = e >> 24
    nbits = torch.where(live, cb + ((w >> 9) & 15), 0)
    excl = torch.cumsum(nbits, 0) - nbits            # global exclusive
    bit = bit0.to(torch.int64)[blk] + excl - excl[start[blk]]
    val = torch.where(live, (e & 0xFFFFFF) | (((w >> 13) & 16383) << cb), 0)
    s = bit & 31
    wi = bit >> 5
    vlo, vhi = val & _M32, val >> 32
    c0 = (vlo << s) & _M32
    c1 = (vlo >> (32 - s)) | ((vhi << s) & _M32)     # s = 0: vlo >> 32 = 0
    c2 = vhi >> (32 - s)
    out = torch.zeros(nwords + 3, dtype=torch.int64, device=dev)
    # the fields' bits are disjoint, so adding the contributions is OR
    for k, c in enumerate((c0, c1, c2)):
        out.index_add_(0, wi + k, c)
    return tops._wrap32(out[:nwords])


def pack_flat(tokc: torch.Tensor, tok_base: torch.Tensor, ntok: torch.Tensor,
              bit0: torch.Tensor, lut: torch.Tensor,
              nwords: int) -> torch.Tensor:
    """Huffman-code block b's tokens tokc[tok_base[b] : +ntok[b]] with
    its LUT lut[b] (code | cbits << 24) and place them LSB-first from
    absolute bit bit0[b] of a zeroed (nwords,) int32 payload buffer
    (ntok[b] = 0 skips a block). The caller sizes nwords to hold every
    block's last bit; the kernel reads no token outside tokc and writes
    no word past nwords."""
    _check(tokc, "tokc", torch.int32)
    nb = ntok.numel()
    _check(tok_base, "tok_base", torch.int32, (nb,))
    _check(ntok, "ntok", torch.int32, (nb,))
    _check(bit0, "bit0", torch.int64, (nb,))
    _check(lut, "lut", torch.int32, (nb, NUM_SYMBOLS))
    if not 0 <= nwords < 2**31 or tokc.numel() >= 2**31:
        raise ValueError("nwords or tokc out of range")
    if not _on_cuda(tokc, tok_base, ntok, bit0, lut):
        return pack_flat_plain(tokc, tok_base, ntok, bit0, lut, nwords)
    out = torch.zeros(nwords, dtype=torch.int32, device=tokc.device)
    if nb == 0 or nwords == 0:
        return out
    _launch("pack_flat", _lib().rspt_pack_flat, tokc.data_ptr(),
            tok_base.data_ptr(), ntok.data_ptr(), bit0.data_ptr(),
            lut.data_ptr(), out.data_ptr(), nb, tokc.numel(), nwords,
            device=tokc.device)
    pack_flat.launches += 1
    return out


pack_flat.launches = 0

KERNELS = (xdelta_swizzle, tokenize_planes, compact_tokens, pack_flat)
