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
                   transpose and byte assembly and the verify-and-grow
                   flag
  xdelta_swizzle_batch
                   K1 over a batch of payloads, the vmap of
                   packers/tpu.py:_pass1_xdelta_batch
  tokenize_planes  K2 tokenize_planes_pallas, with hist_from_tokw; a 2-D
                   (batch, plane_len) input is its batched form
  compact_tokens   K3 compact_tokens_pallas, and X2
                   tools/exp_compact.py:compact_bf, K3 by another route
  pack_flat        K4 token_group_windows_rows_pallas, the cumsum glue
                   and K5 super_place_flat_pallas
  pack_flat_lanes  pack_flat plus the decoder's segment entry lanes: K10
                   token_group_windows_grouped_off_pallas and K11
                   sidecar_entries_pallas
  pack_blocks      K13a token_group_windows_pallas, the group-total scan
                   and K8b super_place_pallas's encode use: the
                   per-block positional pack (jax_coder.pack_blocks)
  pack_blocks_tokw the same over token words: K13b
                   token_group_windows_tokw_pallas
  fwht             K12 fwht_pallas
  group_windows    K14 token_group_windows_grouped_pallas
  place_windows_aligned
                   X1 tools/exp_place.py:place_aligned, K5 with 8-row
                   aligned spans
  windows_place_flat
                   K15 token_windows_place_flat_pallas: K14's windows,
                   the cross-group bit carry and K5's placement
and (rspt_tpu/hzr/pallas_decoder.py):
  hzr_decode       K6 _run_kernel / _decode_kernel, the lockstep decoder
  place_literals   the placement chain of _place_emissions: K7
                   place_compact_pallas, K3 in its nonzero_valid form,
                   K8a chunk_windows2_pallas, K8b super_place_pallas, K9a
                   chunk_windows1_pallas, K9b merge_place_pallas and the
                   scatter ladder
and, with no pallas_call (a TPU has no f64; the JAX package runs them on
the host, rspt_tpu/native/rspt_native.cpp):
  dct_forward      D1 rn_dct_forward (:1274), the exact DCT-II
  dct_inverse      D2 rn_dct_inverse (:1290), its inverse
and, with no pallas_call (the JAX package runs the batch signal ops on XLA
primitives: rspt_tpu/filters/jax_filters.py, rspt_tpu/analysis/
jax_peaks.py):
  iir_scan         S1 _iir_apply mode="scan" (the lax.scan step, :96-108)
                   with _feedforward (:47-65)
  iir_assoc        S2 _iir_apply mode="assoc" (the associative scan of the
                   companion affine maps, :109-126)
  fir_apply        S3 fir_apply (:134-162)
  peak_gate        S4 detect_batch.gate (:58-84) and _gate_scan.gate
                   (:98-126)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from . import torch_ops as tops
from ..utils import tracing

B = 65536             # positions per slab (hzr MAX_BLOCK_SIZE)
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
        "rspt_xdelta_tile": [I, I],
        "rspt_xdelta_band": [],
        "rspt_xdelta_tile_batch": [I, I, I],
        "rspt_xdelta_swizzle": [P] * 4 + [I] * 6 + [P],
        "rspt_xdelta_swizzle_batch": [P] * 4 + [I] * 7 + [P],
        "rspt_tokenize_tiles": [],
        "rspt_tokenize_planes": [P] * 5 + [I] * 3 + [P],
        "rspt_tokenize_planes_batch": [P] * 5 + [I] * 4 + [P],
        "rspt_compact_tiles": [I],
        "rspt_compact_tokens": [P] * 4 + [I] * 4 + [P],
        "rspt_pack_flat_state": [I, I],
        "rspt_pack_flat_tile": [],
        "rspt_pack_flat": [P] * 7 + [I] * 3 + [P],
        "rspt_pack_flat_lanes": [P] * 9 + [I] * 4 + [P],
        "rspt_pack_blocks_state": [I, I],
        "rspt_pack_blocks_tile": [],
        "rspt_pack_blocks": [P] * 9 + [I] * 3 + [P],
        "rspt_pack_blocks_tokw": [P] * 6 + [I] * 3 + [P],
        "rspt_fwht": [P, P, I, I, P],
        "rspt_fwht_launches": [I],
        "rspt_fwht_cluster": [I],
        "rspt_dct_ctas": [I, I],
        "rspt_dct_forward": [P] * 4 + [I] * 2 + [P],
        "rspt_dct_inverse": [P] * 4 + [ctypes.c_double] + [I] * 2 + [P],
        "rspt_hzr_decode_cluster": [],
        "rspt_hzr_decode": [P] * 17 + [I] * 7 + [P],
        "rspt_place_literals": [P] * 6 + [I] * 3 + [P],
        "rspt_group_windows": [P] * 7 + [I] + [P],
        "rspt_place_windows_aligned": [P] * 8 + [I] * 2 + [P],
        "rspt_windows_place_flat_state": [I],
        "rspt_windows_place_flat": [P] * 7 + [I] * 2 + [P],
        "rspt_iir_scan": [P] * 6 + [I, I, ctypes.c_long, I, P],
        "rspt_iir_assoc": [P] * 10 + [I, I, ctypes.c_long, I, I, P],
        "rspt_fir_apply": [P] * 4 + [I, ctypes.c_long, I, I, I, P],
        "rspt_peak_gate_schedule": [P],
        "rspt_peak_gate": [P] * 5 + [I, ctypes.c_long, I, I, I,
                                     ctypes.c_float, ctypes.c_float, P],
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


def _aligned16(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


# ---------------------------------------------------------------------------
# Kernel 1 — xdelta_swizzle (K1)
# ---------------------------------------------------------------------------

def _fits_planes(enc: torch.Tensor, nr_planes: int,
                 bytes_per_sample: int) -> torch.Tensor:
    """(1,) int32: 1 if nr_planes planes keep every sample's native bytes,
    else 0. The reference decompresses and compares the native samples
    (signal_packer_xdelta_hzr.cpp:59-71), and their low 8 * bps bits
    depend only on the low 8 * bps bits of the xdelta values: so the
    planes fit iff sign-extending each value's low 8 * nr_planes bits
    leaves its low 8 * bps bits unchanged (always at nr_planes >= bps)."""
    if nr_planes >= bytes_per_sample:
        return torch.ones(1, dtype=torch.int32, device=enc.device)
    v = enc.to(torch.int64) & _M32
    merged = tops._sign_extend(v & ((1 << 8 * nr_planes) - 1), 8 * nr_planes)
    keep = (1 << 8 * bytes_per_sample) - 1
    ok = (((merged ^ v) & keep) == 0).all()
    return ok.to(torch.int32).reshape(1)


def xdelta_swizzle_plain(x: torch.Tensor, nr_samples: int, nr_channels: int,
                         nr_planes: int, bytes_per_sample: int, swizzle: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = nr_samples * nr_channels
    if x.dtype == torch.uint8:
        v = tops.native_to_i32(x, nr_samples, nr_channels,
                               bytes_per_sample).reshape(-1)
    elif swizzle:
        v = x[:n].reshape(nr_samples, nr_channels).T.reshape(-1)
    else:
        v = x[:n]
    enc = tops.xor_encode(tops.offset32(tops.delta_encode(v), -128))
    return enc, _fits_planes(enc, nr_planes, bytes_per_sample)


# the kernel's ticket counters for each (device, stream), one a payload of
# a batch: zeroed when made, left at 0 by every call (csrc/xdelta.cu); a
# larger batch replaces them with more, made on the same stream
_xdelta_tickets = {}


def _xdelta_ticket(device: torch.device, n: int = 1) -> torch.Tensor:
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    t = _xdelta_tickets.get(key)
    if t is None or t.numel() < n:
        with torch.cuda.device(device):
            t = torch.zeros(max(n, 1), dtype=torch.int64, device=device)
        _xdelta_tickets[key] = t
    return t


def xdelta_swizzle(x: torch.Tensor, nr_samples: int, nr_channels: int,
                   nr_planes: int, bytes_per_sample: int,
                   swizzle: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat xdelta (delta → offset −128 → xor, int32 wrap) of the signal,
    channel-major, and the verify-and-grow flag: 1 if nr_planes byte
    planes keep every bytes_per_sample-byte sample (_fits_planes).

    x: the interleaved native bytes [s0c0][s0c1]... as uint8 at
    bytes_per_sample 1-4 (sign-extended from bit 8·bps − 1, as
    native_to_i32); or int32: the interleaved '<i4' sample words
    (swizzle=True) or the channel-major signal (swizzle=False). On the
    card one kernel and no other device operation. Returns (enc (n,)
    int32, ok (1,) int32)."""
    n = nr_samples * nr_channels
    u8 = x.dtype == torch.uint8
    _check(x, "x", torch.uint8 if u8 else torch.int32)
    if u8 and not swizzle:
        raise ValueError("x: native bytes are interleaved (swizzle)")
    need = n * bytes_per_sample if u8 else n
    if x.dim() != 1 or x.numel() < need or n <= 0 or n >= 2**31:
        raise ValueError(f"x: need 1-D with >= {need} > 0 elements")
    if not 1 <= nr_planes <= 4:
        raise ValueError("nr_planes must be 1..4")
    if not 1 <= bytes_per_sample <= 4:
        raise ValueError("bytes_per_sample must be 1..4")
    if not _on_cuda(x):
        return xdelta_swizzle_plain(x, nr_samples, nr_channels, nr_planes,
                                    bytes_per_sample, swizzle)
    ns, ch = (nr_samples, nr_channels) if swizzle else (n, 1)
    enc = torch.empty(n, dtype=torch.int32, device=x.device)
    ok = torch.empty(1, dtype=torch.int32, device=x.device)
    _launch("xdelta_swizzle", _lib().rspt_xdelta_swizzle, x.data_ptr(),
            enc.data_ptr(), ok.data_ptr(), _xdelta_ticket(x.device).data_ptr(),
            ns, ch, int(u8), int(_aligned16(x)), nr_planes, bytes_per_sample,
            device=x.device)
    xdelta_swizzle.launches += 1
    return enc, ok


xdelta_swizzle.launches = 0


def xdelta_swizzle_batch_plain(x: torch.Tensor, nr_samples: int,
                               nr_channels: int, nr_planes: int,
                               bytes_per_sample: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    outs = [xdelta_swizzle_plain(row, nr_samples, nr_channels, nr_planes,
                                 bytes_per_sample, True) for row in x]
    return (torch.stack([e for e, _ in outs]),
            torch.cat([ok for _, ok in outs]))


def xdelta_swizzle_batch(x: torch.Tensor, nr_samples: int, nr_channels: int,
                         nr_planes: int, bytes_per_sample: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdelta_swizzle of each row of x, a batch of interleaved payloads of
    one shape: (batch, ns * ch) int32 '<i4' words, or (batch, ns * ch *
    bps) uint8 native bytes at bps 1-4. Each payload's chain starts fresh
    at its own first sample and has its own flag. On the card one kernel
    and no other device operation. Returns (enc (batch, ns * ch) int32,
    channel-major a payload, ok (batch,) int32)."""
    n = nr_samples * nr_channels
    u8 = x.dtype == torch.uint8
    _check(x, "x", torch.uint8 if u8 else torch.int32)
    need = n * bytes_per_sample if u8 else n
    if x.dim() != 2 or x.shape[1] != need or n <= 0 or n >= 2**31:
        raise ValueError(f"x: need (batch, {need}) with {need} > 0")
    if not 1 <= nr_planes <= 4:
        raise ValueError("nr_planes must be 1..4")
    if not 1 <= bytes_per_sample <= 4:
        raise ValueError("bytes_per_sample must be 1..4")
    if not u8 and bytes_per_sample != 4:
        raise ValueError("int32 word input needs bytes_per_sample=4")
    batch = x.shape[0]
    if not _on_cuda(x):
        return xdelta_swizzle_batch_plain(x, nr_samples, nr_channels,
                                          nr_planes, bytes_per_sample)
    enc = torch.empty((batch, n), dtype=torch.int32, device=x.device)
    ok = torch.empty(batch, dtype=torch.int32, device=x.device)
    if batch == 0:
        return enc, ok
    _launch("xdelta_swizzle_batch", _lib().rspt_xdelta_swizzle_batch,
            x.data_ptr(), enc.data_ptr(), ok.data_ptr(),
            _xdelta_ticket(x.device, batch).data_ptr(), nr_samples,
            nr_channels, int(u8), int(_aligned16(x)), nr_planes,
            bytes_per_sample, batch, device=x.device)
    xdelta_swizzle_batch.launches += 1
    return enc, ok


xdelta_swizzle_batch.launches = 0


# ---------------------------------------------------------------------------
# Kernel 2 — tokenize_planes (K2 + hist_from_tokw)
# ---------------------------------------------------------------------------

def tokenize_planes_plain(enc: torch.Tensor, nr_planes: int):
    if enc.dim() == 2:
        outs = [tokenize_planes_plain(row, nr_planes) for row in enc]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    plane_len = enc.numel()
    dev = enc.device
    nb_per = max(1, -(-plane_len // B))
    xp = torch.zeros(nb_per * B, dtype=torch.int32, device=dev)
    xp[:plane_len] = enc
    slabs = xp.reshape(nb_per, B)
    limit = torch.full((nb_per, 1), B, dtype=torch.int32, device=dev)
    limit[-1] = plane_len - (nb_per - 1) * B
    tokws, bws, hists = [], [], []
    for p in range(nr_planes):
        byte = (slabs >> (8 * p)) & 255
        q = byte.reshape(nb_per, B // 4, 4).to(torch.int64)
        bws.append(tops._wrap32(q[..., 0] | (q[..., 1] << 8)
                                | (q[..., 2] << 16) | (q[..., 3] << 24)))
        sym, extra, ebits, valid, h = tops.rle_tokenize(byte, limit)
        tokws.append(sym | (ebits << 9) | (extra << 13)
                     | (valid.to(torch.int32) << 27))
        hists.append(h)
    return torch.cat(tokws), torch.cat(bws), torch.cat(hists)


def tokenize_planes(enc: torch.Tensor, nr_planes: int):
    """Plane extract + zero-run tokenize + histograms of a flat int32
    signal, per 64 KiB slab and byte plane (hzr_encode.c:133-173).

    Returns (tokw (nb, 65536), bwords (nb, 16384), hist (nb, 261)), all
    int32, nb = nr_planes * ceil(plane_len / 65536), plane-major rows:
    the token words sym | ebits<<9 | extra<<13 | valid<<27, the plane
    bytes 4 per little-endian word, and each block's 261-bin histogram
    (single zeros count under sym 0).

    enc may be (batch, plane_len), a batch of payloads (the serving
    path): one launch for the whole batch, nb = batch * nr_planes *
    nb_per rows, payload-major then plane-major (row (b * nr_planes + p)
    * nb_per + j, tokenize_planes_pallas's order)."""
    _check(enc, "enc", torch.int32)
    batch = enc.shape[0] if enc.dim() == 2 else 1
    plane_len = enc.shape[-1] if enc.dim() else 0
    if (enc.dim() not in (1, 2) or plane_len <= 0 or plane_len >= 2**31
            or not 1 <= batch < 65536):
        raise ValueError("enc: need a non-empty 1-D signal, or (batch, "
                         "plane_len) with 1 <= batch < 65536")
    if not 1 <= nr_planes <= 4:
        raise ValueError("nr_planes must be 1..4")
    if not _on_cuda(enc):
        return tokenize_planes_plain(enc, nr_planes)
    nb_per = -(-plane_len // B)
    nb = batch * nr_planes * nb_per
    kw = dict(dtype=torch.int32, device=enc.device)
    tokw = torch.empty((nb, B), **kw)
    bwords = torch.empty((nb, B // 4), **kw)
    hist = torch.empty((nb, NUM_SYMBOLS), **kw)    # zeroed by the call
    lib = _lib()
    # the summary pass's first and last non-zero of every tile and plane
    summary = torch.empty(batch * nb_per * lib.rspt_tokenize_tiles() * 8,
                          **kw)
    _launch("tokenize_planes", lib.rspt_tokenize_planes_batch,
            enc.data_ptr(), summary.data_ptr(), tokw.data_ptr(),
            bwords.data_ptr(), hist.data_ptr(), plane_len, nr_planes, nb_per,
            batch, device=enc.device)
    tokenize_planes.launches += 1
    return tokw, bwords, hist


tokenize_planes.launches = 0


# ---------------------------------------------------------------------------
# Kernel 3 — compact_tokens (K3, X2)
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


def _check_compact_args(tokw, bases, t_total):
    _check(tokw, "tokw", torch.int32)
    if tokw.dim() != 2:
        raise ValueError("tokw: need (nb, ntok)")
    nb, ntok = tokw.shape
    _check(bases, "bases", torch.int32, (nb,))
    if not 0 <= t_total < 2**31 or ntok >= 2**31 - 2**16:
        raise ValueError("t_total out of range")
    return nb, ntok


def compact_tokens(tokw: torch.Tensor, bases: torch.Tensor, t_total: int,
                   nonzero_valid: bool = False) -> torch.Tensor:
    """Order-preserving compaction: row b's valid words (bit 27, or
    != 0 under nonzero_valid) land in order at bases[b] of a zeroed
    (t_total,) int32 buffer. Rows with bases[b] >= t_total write
    nothing; nothing is written past t_total."""
    nb, ntok = _check_compact_args(tokw, bases, t_total)
    if not _on_cuda(tokw, bases):
        return compact_tokens_plain(tokw, bases, t_total, nonzero_valid)
    if nb == 0 or ntok == 0 or t_total == 0:
        return torch.zeros(t_total, dtype=torch.int32, device=tokw.device)
    lib = _lib()
    # one zeroed buffer: the output, then the tile ticket and each tile's
    # valid count + 1 once known
    nstate = 1 + nb * lib.rspt_compact_tiles(ntok)
    buf = torch.zeros(t_total + nstate, dtype=torch.int32, device=tokw.device)
    out = buf[:t_total]
    _launch("compact_tokens", lib.rspt_compact_tokens, tokw.data_ptr(),
            bases.data_ptr(), out.data_ptr(), buf[t_total:].data_ptr(), nb,
            ntok, t_total, int(nonzero_valid), device=tokw.device)
    compact_tokens.launches += 1
    return out


compact_tokens.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4 — pack_flat (K4 + cumsum glue + K5)
# ---------------------------------------------------------------------------

def _unpack_tokw(w: torch.Tensor):
    """int64 token words → (sym, extra, ebits, valid)."""
    return w & 511, (w >> 13) & 16383, (w >> 9) & 15, ((w >> 27) & 1) != 0


def _code_tokens(lut, blk, sym, extra, ebits, valid):
    """Each token's value code | extra << cbits and bit count cbits +
    ebits under its block's LUT row lut[blk] (both 0 for an invalid
    token or sym >= 261); int64."""
    live = valid & (sym < NUM_SYMBOLS)
    e = lut[blk, sym.clamp(max=NUM_SYMBOLS - 1)].to(torch.int64) & _M32
    cb = e >> 24
    nbits = torch.where(live, cb + ebits, 0)
    val = torch.where(live, (e & 0xFFFFFF) | (extra << cb), 0)
    return val, nbits


def _token_bits(tokc, tok_base, ntok, lut):
    """Every packed token's block, index in its block, value, bit count
    and block-local exclusive bit offset (the kernel's bit - bit0)."""
    dev = tokc.device
    n = ntok.to(torch.int64).clamp(min=0)
    blk = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    start = torch.cumsum(n, 0) - n
    local = torch.arange(blk.numel(), device=dev) - start[blk]
    w = tokc[tok_base.to(torch.int64)[blk] + local].to(torch.int64)
    val, nbits = _code_tokens(lut, blk, *_unpack_tokw(w))
    excl = torch.cumsum(nbits, 0) - nbits            # global exclusive
    x = excl - excl[start[blk]]
    return blk, local, val, nbits, x


def _place_words(row, bit, val, nrows: int, nwords: int):
    """OR each value LSB-first from bit `bit` of row `row` of a zeroed
    (nrows, nwords) int32 buffer; words at or past nwords are dropped."""
    row, bit, val = row.reshape(-1), bit.reshape(-1), val.reshape(-1)
    s = bit & 31
    wi = bit >> 5
    vlo, vhi = val & _M32, val >> 32
    c0 = (vlo << s) & _M32
    c1 = (vlo >> (32 - s)) | ((vhi << s) & _M32)     # s = 0: vlo >> 32 = 0
    c2 = vhi >> (32 - s)
    out = torch.zeros(nrows * nwords + 1, dtype=torch.int64, device=val.device)
    # the fields' bits are disjoint, so adding the contributions is OR
    for k, c in enumerate((c0, c1, c2)):
        keep = wi + k < nwords
        out.index_add_(0, torch.where(keep, row * nwords + wi + k,
                                      nrows * nwords), torch.where(keep, c, 0))
    return tops._wrap32(out[:-1].reshape(nrows, nwords))


def pack_flat_plain(tokc: torch.Tensor, tok_base: torch.Tensor,
                    ntok: torch.Tensor, bit0: torch.Tensor, lut: torch.Tensor,
                    nwords: int) -> torch.Tensor:
    blk, _, val, _, x = _token_bits(tokc, tok_base, ntok, lut)
    bit = bit0.to(torch.int64)[blk] + x
    return _place_words(torch.zeros_like(blk), bit, val, 1, nwords)[0]


def _check_pack_args(tokc, tok_base, ntok, bit0, lut, nwords):
    _check(tokc, "tokc", torch.int32)
    nb = ntok.numel()
    _check(tok_base, "tok_base", torch.int32, (nb,))
    _check(ntok, "ntok", torch.int32, (nb,))
    _check(bit0, "bit0", torch.int64, (nb,))
    _check(lut, "lut", torch.int32, (nb, NUM_SYMBOLS))
    if not 0 <= nwords < 2**31 or tokc.numel() >= 2**31:
        raise ValueError("nwords or tokc out of range")
    return nb


def _pack_buffers(nwords: int, nb: int, tokc: torch.Tensor, lib=None):
    """One zeroed buffer: the (nwords,) output words, then, at an 8-byte
    offset, the state of lib's (default: the port's) pack_flat kernel
    (its tile ticket and one status word a tile): returns (out, state)."""
    lib = lib or _lib()
    nw = nwords + (nwords & 1)
    buf = torch.zeros(nw + lib.rspt_pack_flat_state(nb, tokc.numel()),
                      dtype=torch.int32, device=tokc.device)
    return buf[:nwords], buf[nw:]


def pack_flat(tokc: torch.Tensor, tok_base: torch.Tensor, ntok: torch.Tensor,
              bit0: torch.Tensor, lut: torch.Tensor,
              nwords: int) -> torch.Tensor:
    """Huffman-code block b's tokens tokc[tok_base[b] : +ntok[b]] with
    its LUT lut[b] (code | cbits << 24) and place them LSB-first from
    absolute bit bit0[b] of a zeroed (nwords,) int32 payload buffer
    (ntok[b] = 0 skips a block). The caller sizes nwords to hold every
    block's last bit, and the blocks' bit ranges do not overlap; the
    kernel reads no token outside tokc (tokens past its end count as
    invalid) and writes no word past nwords. Codes have cbits <= 23 and
    tokens ebits <= 14 (flat_plan's LUTs, rle_tokenize's tokens); on the
    card, input outside that can stop the launch with a device error."""
    nb = _check_pack_args(tokc, tok_base, ntok, bit0, lut, nwords)
    if not _on_cuda(tokc, tok_base, ntok, bit0, lut):
        return pack_flat_plain(tokc, tok_base, ntok, bit0, lut, nwords)
    if nb == 0 or nwords == 0:
        return torch.zeros(nwords, dtype=torch.int32, device=tokc.device)
    out, state = _pack_buffers(nwords, nb, tokc)
    _launch("pack_flat", _lib().rspt_pack_flat, tokc.data_ptr(),
            tok_base.data_ptr(), ntok.data_ptr(), bit0.data_ptr(),
            lut.data_ptr(), out.data_ptr(), state.data_ptr(), nb,
            tokc.numel(), nwords, device=tokc.device)
    pack_flat.launches += 1
    return out


pack_flat.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4b — pack_flat_lanes (pack_flat + K10/K11's decode entry lanes)
# ---------------------------------------------------------------------------

def pack_flat_lanes_plain(tokc, tok_base, ntok, bit0, lut, nwords, meta,
                          init):
    blk, local, val, nbits, x = _token_bits(tokc, tok_base, ntok, lut)
    words = _place_words(torch.zeros_like(blk), bit0.to(torch.int64)[blk] + x,
                         val, 1, nwords)[0]
    m = meta.to(torch.int64)
    W, lane_base, dbits = m[blk, 0], m[blk, 1], m[blk, 2]
    end = x + nbits
    seg = torch.div(end, W, rounding_mode="floor")
    lane = lane_base + seg
    hit = ((lane_base >= 0) & (seg * W > x)
           & (local + 1 < ntok.to(torch.int64)[blk]) & (lane < init.numel()))
    entries = init.clone()
    entries[lane[hit]] = (dbits + end)[hit].to(torch.int32)
    return words, entries


def pack_flat_lanes(tokc: torch.Tensor, tok_base: torch.Tensor,
                    ntok: torch.Tensor, bit0: torch.Tensor, lut: torch.Tensor,
                    nwords: int, meta: torch.Tensor, init: torch.Tensor):
    """pack_flat, and the decoder's segment entry lanes of every block.

    meta (nb, 3) int32: W = segw * 32 (the decoder's segment width in
    bits, >= 64), lane_base (-1: no lanes) and dbits (description bits)
    per block; init (nlanes,) int32 the lanes' values where no store
    lands. A token of block b at body-relative bit x with nbits bits
    whose end crosses a segment boundary, floor(x / W) < s = floor((x +
    nbits) / W), and that is not the block's last token, stores dbits +
    x + nbits (the first token start at or after s * W) at lane
    lane_base + s. Returns (words as pack_flat's, entries (nlanes,))."""
    nb = _check_pack_args(tokc, tok_base, ntok, bit0, lut, nwords)
    _check(meta, "meta", torch.int32, (nb, 3))
    _check(init, "init", torch.int32)
    if init.dim() != 1 or init.numel() >= 2**31:
        raise ValueError("init: need (nlanes,)")
    args = (tokc, tok_base, ntok, bit0, lut, meta, init)
    if not _on_cuda(*args):
        return pack_flat_lanes_plain(tokc, tok_base, ntok, bit0, lut, nwords,
                                     meta, init)
    entries = init.clone()
    if nb == 0 or nwords == 0:
        return (torch.zeros(nwords, dtype=torch.int32, device=tokc.device),
                entries)
    out, state = _pack_buffers(nwords, nb, tokc)
    _launch("pack_flat_lanes", _lib().rspt_pack_flat_lanes, tokc.data_ptr(),
            tok_base.data_ptr(), ntok.data_ptr(), bit0.data_ptr(),
            lut.data_ptr(), out.data_ptr(), meta.data_ptr(),
            entries.data_ptr(), state.data_ptr(), nb, tokc.numel(), nwords,
            entries.numel(), device=tokc.device)
    pack_flat_lanes.launches += 1
    return out, entries


pack_flat_lanes.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4c — pack_blocks, pack_blocks_tokw (K13a, K13b, the group scan
# and K8b's encode use)
# ---------------------------------------------------------------------------

def blocks_nwords(n: int) -> int:
    """Words of a pack_blocks output row for n token slots: the packed
    payload width n + 512 bytes plus a spill word
    (jax_coder.py:284, :399-400)."""
    return (n + 512) // 4 + 1


def _pack_rows(sym, extra, ebits, valid, lut, desc_bits):
    nb, n = sym.shape
    rows = torch.arange(nb, device=sym.device)[:, None]
    val, nbits = _code_tokens(lut, rows, sym, extra, ebits, valid)
    d = desc_bits.to(torch.int64)
    bit = d[:, None] + torch.cumsum(nbits, 1) - nbits
    words = _place_words(rows.expand(nb, n), bit, val, nb, blocks_nwords(n))
    return words, (d + nbits.sum(1)).to(torch.int32)


def pack_blocks_plain(syms, extras, ebits, tvalid, lut, desc_bits):
    f = [a.to(torch.int64) for a in (syms, extras, ebits)]
    return _pack_rows(f[0] & 511, f[1] & 16383, f[2] & 15, tvalid != 0, lut,
                      desc_bits)


def pack_blocks_tokw_plain(tokw, lut, desc_bits):
    return _pack_rows(*_unpack_tokw(tokw.to(torch.int64)), lut, desc_bits)


def _check_blocks_args(tokens, names, lut, desc_bits):
    if tokens[0].dim() != 2:
        raise ValueError(f"{names[0]}: need (nb, n)")
    nb, n = tokens[0].shape
    for t, name in zip(tokens, names):
        _check(t, name, torch.int32, (nb, n))
    if not 8 <= n <= B or n % 8:
        raise ValueError(f"{names[0]}: need n a multiple of 8, 8 <= n <= {B}")
    _check(lut, "lut", torch.int32, (nb, NUM_SYMBOLS))
    _check(desc_bits, "desc_bits", torch.int32, (nb,))


def _blocks_buffers(nb: int, n: int, dev, lib=None):
    """One zeroed buffer: the (nb, blocks_nwords(n)) rows, then, at an
    8-byte offset, the state of lib's (default: the port's) pack_blocks
    kernels (a tile ticket counter a block, a status word a tile):
    returns (rows, state)."""
    lib = lib or _lib()
    nw = nb * blocks_nwords(n)
    nw += nw & 1
    buf = torch.zeros(nw + lib.rspt_pack_blocks_state(nb, n),
                      dtype=torch.int32, device=dev)
    return buf[:nb * blocks_nwords(n)].view(nb, -1), buf[nw:]


def _launch_blocks(name, fn, tokens, lut, desc_bits):
    """Allocate the rows, bit totals and state and launch a CTA a tile."""
    nb, n = tokens[0].shape
    dev = lut.device
    total = torch.empty(nb, dtype=torch.int32, device=dev)
    if not nb:
        return torch.empty((0, blocks_nwords(n)), dtype=torch.int32,
                           device=dev), total
    words, state = _blocks_buffers(nb, n, dev)
    _launch(name, fn, *[t.data_ptr() for t in tokens], lut.data_ptr(),
            desc_bits.data_ptr(), words.data_ptr(), total.data_ptr(),
            state.data_ptr(), nb, n, words.shape[1], device=dev)
    return words, total


def pack_blocks(syms: torch.Tensor, extras: torch.Tensor, ebits: torch.Tensor,
                tvalid: torch.Tensor, lut: torch.Tensor,
                desc_bits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-block positional hzr pack: row b's token slots (syms,
    extras, ebits, tvalid: (nb, n) int32, tokenize_blocks' layout;
    tvalid != 0 marks a token) are Huffman-coded with lut[b] (code |
    cbits << 24) and placed LSB-first, in slot order, from bit
    desc_bits[b] of row b. Fields are read at the token word's widths
    (sym 9, ebits 4, extra 14 bits).

    Returns (words (nb, blocks_nwords(n)) int32: bits at or past the row
    end are dropped; total_bits (nb,) int32 = desc_bits + the tokens'
    bits, exact for every row). n is a multiple of 8 up to 65,536. Codes
    have cbits <= 23 (host_tables' limit); on the card, a LUT outside
    that can stop the launch with a device error."""
    fields = (syms, extras, ebits, tvalid)
    _check_blocks_args(fields, ("syms", "extras", "ebits", "tvalid"), lut,
                       desc_bits)
    if not _on_cuda(*fields, lut, desc_bits):
        return pack_blocks_plain(*fields, lut, desc_bits)
    out = _launch_blocks("pack_blocks", _lib().rspt_pack_blocks, fields, lut,
                         desc_bits)
    if syms.shape[0]:
        pack_blocks.launches += 1
    return out


pack_blocks.launches = 0


def pack_blocks_tokw(tokw: torch.Tensor, lut: torch.Tensor,
                     desc_bits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pack_blocks over packed token words (nb, n) int32, sym | ebits<<9
    | extra<<13 | valid<<27 (tokenize_planes' tokw)."""
    _check_blocks_args((tokw,), ("tokw",), lut, desc_bits)
    if not _on_cuda(tokw, lut, desc_bits):
        return pack_blocks_tokw_plain(tokw, lut, desc_bits)
    out = _launch_blocks("pack_blocks_tokw", _lib().rspt_pack_blocks_tokw,
                         (tokw,), lut, desc_bits)
    if tokw.shape[0]:
        pack_blocks_tokw.launches += 1
    return out


pack_blocks_tokw.launches = 0


# ---------------------------------------------------------------------------
# Kernel 4d — fwht (K12)
# ---------------------------------------------------------------------------

def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """fwht on the host's torch ops; n = 1 is the identity (a copy)."""
    rows, n = x.shape
    v = x.to(torch.int64) & _M32
    h = n >> 1
    while h > 0:
        g = v.reshape(rows, -1, 2, h)
        u, w = g[:, :, 0], g[:, :, 1]
        v = torch.stack(((u + w) & _M32, (u - w) & _M32), 2).reshape(rows, n)
        h >>= 1
    return tops._wrap32(v)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform along the rows of x ((rows, n) int32,
    n = 2^k, 1 <= n <= 2^30), int32 wraparound butterflies
    (fwht.c:4-28); a new tensor, x unchanged. At n = 1 the transform is
    the identity: a copy, on the card with no launch. On the card a row of
    n > 2,048 words is a cluster of n / 2,048 CTAs (up to 16); rows
    longer than 2^15 add one global pass per 5 index bits above that: 2
    launches up to n = 2^20."""
    _check(x, "x", torch.int32)
    if x.dim() != 2:
        raise ValueError("x: need (rows, n)")
    rows, n = x.shape
    if n < 1 or n & (n - 1) or n > 2**30 or rows >= 2**31:
        raise ValueError("x: need rows < 2^31 of 2^k words, 1 <= n <= 2^30")
    if not _on_cuda(x):
        return fwht_plain(x)
    if n == 1:
        return x.clone()
    out = torch.empty_like(x)
    if rows == 0:
        return out
    log_n = n.bit_length() - 1
    lib = _lib()
    _launch("fwht", lib.rspt_fwht, x.data_ptr(), out.data_ptr(), rows, log_n,
            device=x.device)
    fwht.launches += lib.rspt_fwht_launches(log_n)
    return out


fwht.launches = 0


# ---------------------------------------------------------------------------
# Kernels D1, D2 — dct_forward, dct_inverse
# ---------------------------------------------------------------------------

def _x86_i32(s: torch.Tensor) -> torch.Tensor:
    """x86's (int32_t) of f64 values (cvttsd2si), as the reference's C++
    converts: trunc inside the int32 range, INT32_MIN outside it, for
    positive overflow and NaN too (CUDA's conversion, and torch's on the
    card, saturate instead)."""
    ok = (s > -2147483649.0) & (s < 2147483648.0)
    return torch.where(ok, s, -2147483648.0).trunc().to(torch.int32)


def _dct_sums_plain(v: torch.Tensor, tab: torch.Tensor,
                    block: int = 64) -> torch.Tensor:
    """(rows, n) f64: for each row and i, the sum over x in order of
    (double)(v[row, x] * tab[x, i]), the products in float32 (a block of
    x at a time) and every partial sum rounded to f64."""
    acc = torch.zeros(v.shape, dtype=torch.float64, device=v.device)
    for x0 in range(0, v.shape[1], block):
        terms = (v[:, x0:x0 + block, None] * tab[x0:x0 + block]).double()
        for j in range(terms.shape[1]):
            acc += terms[:, j]
    return acc


def dct_forward_plain(sig: torch.Tensor, cos: torch.Tensor,
                      fwd_scale: torch.Tensor) -> torch.Tensor:
    return _x86_i32(_dct_sums_plain(sig.float(), cos) * fwd_scale)


def dct_inverse_plain(coef: torch.Tensor, cos_t: torch.Tensor,
                      cs: torch.Tensor, inv_scale: float) -> torch.Tensor:
    return _x86_i32(_dct_sums_plain(cs * coef.float(), cos_t) * inv_scale)


def _check_dct_args(a, name, tab, tab_name, vec, vec_name, vec_dtype):
    _check(a, name, torch.int32)
    if a.dim() != 2:
        raise ValueError(f"{name}: need (channels, n)")
    ch, n = a.shape
    if ch > 4 * 65535:
        raise ValueError(f"{name}: at most {4 * 65535} channels")
    _check(tab, tab_name, torch.float32, (n, n))
    _check(vec, vec_name, vec_dtype, (n,))
    return _on_cuda(a, tab, vec)


def dct_forward(sig: torch.Tensor, cos: torch.Tensor,
                fwd_scale: torch.Tensor) -> torch.Tensor:
    """The exact DCT-II with folded quantization of each row of sig
    ((ch, n) int32): out[c, i] = (int32_t)(fwd_scale[i] * the sum over x,
    serially in f64, of (double)((float)sig[c, x] * cos[x, i]))
    (rn_dct_forward, signal_packer_dct.cpp:76-87). cos: (n, n) float32,
    torch_ops.dct_cos_table; fwd_scale: (n,) f64,
    torch_ops.dct_forward_scale. One launch; a new tensor."""
    if not _check_dct_args(sig, "sig", cos, "cos", fwd_scale, "fwd_scale",
                           torch.float64):
        return dct_forward_plain(sig, cos, fwd_scale)
    out = torch.empty_like(sig)
    if out.numel() == 0:
        return out
    ch, n = sig.shape
    _launch("dct_forward", _lib().rspt_dct_forward, sig.data_ptr(),
            out.data_ptr(), cos.data_ptr(), fwd_scale.data_ptr(), ch, n,
            device=sig.device)
    dct_forward.launches += 1
    return out


dct_forward.launches = 0


def dct_inverse(coef: torch.Tensor, cos_t: torch.Tensor, cs: torch.Tensor,
                inv_scale: float) -> torch.Tensor:
    """The exact inverse of each row of coef ((ch, n) int32): out[c, i] =
    (int32_t)(inv_scale * the sum over x, serially in f64, of
    (double)((cs[x] * (float)coef[c, x]) * cos_t[x, i]))
    (rn_dct_inverse, signal_packer_dct.cpp:89-100). cos_t: the transposed
    table (cos_t[x, i] = COS[i, x]), (n, n) float32; cs: (n,) float32;
    inv_scale: torch_ops.dct_inverse_scale. One launch; a new tensor."""
    if not _check_dct_args(coef, "coef", cos_t, "cos_t", cs, "cs",
                           torch.float32):
        return dct_inverse_plain(coef, cos_t, cs, inv_scale)
    out = torch.empty_like(coef)
    if out.numel() == 0:
        return out
    ch, n = coef.shape
    _launch("dct_inverse", _lib().rspt_dct_inverse, coef.data_ptr(),
            out.data_ptr(), cos_t.data_ptr(), cs.data_ptr(), float(inv_scale),
            ch, n, device=coef.device)
    dct_inverse.launches += 1
    return out


dct_inverse.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5 — hzr_decode (K6)
# ---------------------------------------------------------------------------

MAX_STEPS = 1088       # emission rows per tile: no legal segment needs more
SEG_PER_BLOCK = 1024   # max segments per block; fixpoint cap is this + 2
_DEEP = 1 << 30
_RLE_EBITS = (0, 0, 2, 4, 8, 14)     # by clamp(sym - 255, 0, 5)
_RLE_BASE = (0, 2, 3, 7, 23, 279)


def _decode_sweep_plain(sel, entry, x, emis):
    """One emitting lockstep sweep of the tiles `sel` from `entry`
    ((len(sel), 1024) int64). Writes their emission rows; returns
    (exits, lane step counts, counts, literal counts)."""
    dev = entry.device
    seg, pb, wb = x["segend"][sel], x["pbits"][sel], x["wbase"][sel]
    win, row = x["win"][sel], x["row"][sel]
    wseg = win.shape[1]
    eb = torch.tensor(_RLE_EBITS, device=dev)
    bs = torch.tensor(_RLE_BASE, device=dev)

    def fetch(wp):
        ok = (wp >= 0) & (wp < wseg)
        g = torch.gather(win, 1, wp.clamp(0, wseg - 1)[:, None])[:, 0]
        return torch.where(ok, g, 0)

    pos = entry.clone()
    active = (pos < seg) & (pos < pb)
    wptr = (pos >> 5) - wb
    c0 = fetch(wptr) >> (pos & 31)
    c1 = torch.zeros_like(pos)
    c2 = torch.zeros_like(pos)
    navail = torch.where(active, 32 - (pos & 31), 0)
    wptr = wptr + 1
    outc = torch.zeros_like(pos)
    lits = torch.zeros_like(pos)
    lsteps = torch.zeros_like(pos)
    step = 0
    while step < MAX_STEPS and bool(active.any()):
        for _ in range(2):   # refill to >= 40 bits: 2 -> 34 -> 66
            need = active & (navail < 40)
            w = fetch(wptr)
            nv = navail
            lo = torch.where(nv < 32, (w << nv.clamp(max=31)) & _M32, 0)
            mid = torch.where(nv < 32, w >> (32 - nv).clamp(0, 32),
                              (w << (nv - 32).clamp(min=0)) & _M32)
            hi = torch.where(nv > 32, w >> (64 - nv).clamp(max=32), 0)
            c0 = torch.where(need, c0 | lo, c0)
            c1 = torch.where(need, c1 | mid, c1)
            c2 = torch.where(need, c2 | hi, c2)
            navail = torch.where(need, navail + 32, navail)
            wptr = torch.where(need, wptr + 1, wptr)
        ent = x["l1"].reshape(-1)[row * 256 + (c0 & 255)]
        deep = active & ((ent & _DEEP) != 0)
        for k in range(4):
            if not bool(deep.any()):
                break
            lv = x["lv"][k]
            i = (ent & 0xFFFF) * 16 + ((c0 >> (8 + 4 * k)) & 15)
            n = lv.shape[1]
            ek = lv.reshape(-1)[row * n + i.clamp(0, n - 1)]
            ek = torch.where((i >= 0) & (i < n), ek, 0)
            ent = torch.where(deep, ek, ent)
            deep = deep & ((ek & _DEEP) != 0)
        sym = ent & 0x1FF
        cb = (ent >> 16) & 0xFF
        ridx = (sym - 255).clamp(0, 5)
        ebv, basev = eb[ridx], bs[ridx]
        tail = (c0 >> cb) | torch.where(
            cb > 0, (c1 << (32 - cb).clamp(0, 32)) & _M32, 0)
        extra = torch.where(ebv > 0, tail & ((torch.ones_like(ebv) << ebv) - 1),
                            0)
        is_rle = sym >= 256
        nout = torch.where(is_rle, basev + extra, 1)
        is_lit = active & ~is_rle & (sym > 0)
        emis[sel, step] = tops._wrap32((outc << 9) | torch.where(is_lit, sym, 0))
        consume = cb + ebv
        big = consume >= 32
        d0 = torch.where(big, c1, c0)
        d1 = torch.where(big, c2, c1)
        d2 = torch.where(big, 0, c2)
        cs = consume & 31
        inv = (32 - cs).clamp(max=31)
        n0 = torch.where(cs > 0, (d0 >> cs) | ((d1 << inv) & _M32), d0)
        n1 = torch.where(cs > 0, (d1 >> cs) | ((d2 << inv) & _M32), d1)
        n2 = torch.where(cs > 0, d2 >> cs, d2)
        c0 = torch.where(active, n0, c0)
        c1 = torch.where(active, n1, c1)
        c2 = torch.where(active, n2, c2)
        navail = torch.where(active, navail - consume, navail)
        outc = torch.where(active, outc + nout, outc)
        lits = lits + is_lit.long()
        step += 1
        lsteps = torch.where(active, step, lsteps)
        pos = torch.where(active, pos + consume, pos)
        active = active & (pos < seg) & (pos < pb)
    return pos, lsteps, outc, lits


def hzr_decode_plain(ntc, win, l1lo, l1hi, lv1, lv2, lv3, lv4, entry,
                     segend, pbits, first, wbase):
    dev = entry.device
    nrows = entry.shape[0]
    nt = nrows // 8
    wseg = win.shape[0]

    def lanes(a):
        return a.reshape(nt, 1024).long()

    x = dict(segend=lanes(segend), pbits=lanes(pbits), wbase=lanes(wbase),
             win=(win.reshape(wseg, nt, 1024).permute(1, 0, 2).long()
                  & _M32),
             row=lanes(torch.arange(nrows, device=dev)[:, None]
                       .expand(nrows, 128).contiguous()),
             l1=torch.cat([l1lo, l1hi], 1).long(),
             # level k as one flat table per row: (nrows, cap_k * 128)
             lv=[lv.permute(1, 0, 2).reshape(nrows, -1).long()
                 for lv in (lv1, lv2, lv3, lv4)])
    e0 = lanes(entry)
    pinned = lanes(first) != 0
    emis = torch.zeros((nt, MAX_STEPS, 1024), dtype=torch.int32, device=dev)
    counts = torch.zeros((nt, 1024), dtype=torch.int64, device=dev)
    stats = torch.zeros((nt, 5), dtype=torch.int64, device=dev)

    def sweep(sel, ent):
        exits, lsteps, outc, lits = _decode_sweep_plain(sel, ent, x, emis)
        counts[sel] = outc
        stats[sel, 0] = lsteps.max(1).values
        stats[sel, 2] = lits.sum(1)
        stats[sel, 4] = outc.max(1).values
        return exits

    # alignment fixpoint: emitting sweeps with entry(s+1) = exit(s) of
    # the previous lane until no entry changes; trusted tiles skip it,
    # and a cap exit re-emits from the last entries
    cur = e0.clone()
    trust = ntc[:, 4] != 0
    changed = ~trust
    iters = torch.zeros(nt, dtype=torch.int64, device=dev)
    while True:
        sel = torch.nonzero(changed & (iters < SEG_PER_BLOCK + 2))[:, 0]
        if sel.numel() == 0:
            break
        exits = sweep(sel, cur[sel])
        new = torch.where(pinned[sel], e0[sel], torch.roll(exits, 1, 1))
        changed[sel] = (new != cur[sel]).any(1)
        cur[sel] = new
        iters[sel] += 1
    sel = torch.nonzero(trust | changed)[:, 0]
    if sel.numel():
        sweep(sel, cur[sel])
    stats[:, 1] = iters
    return (emis.reshape(nt, MAX_STEPS, 8, 128),
            counts.reshape(nrows, 128).to(torch.int32),
            cur.reshape(nrows, 128).to(torch.int32), stats.to(torch.int32))


def hzr_decode(ntc, win, l1lo, l1hi, lv1, lv2, lv3, lv4, entry, segend,
               pbits, first, wbase):
    """Lockstep speculative hzr decode of every lane (one segment of a
    HUFF block) with the in-kernel alignment fixpoint.

    Inputs (int32, contiguous; nrows = 8 * tiles): ntc (tiles, 5) the
    tile's max level-k chunk counts and trust flag; win (wseg, nrows,
    128) each lane's payload words from wbase; l1lo/l1hi (nrows, 128)
    the row's 8-bit root LUT; lv1..lv4 (cap_k, nrows, 128) its nibble
    levels; entry, segend, pbits, first, wbase (nrows, 128).

    Returns (emis (tiles, MAX_STEPS, 8, 128): outc << 9 | literal byte
    (0 if the step was no literal) for every step below the tile's step
    count, rows past it are scratch; counts (nrows, 128) bytes decoded
    per lane; entry_out (nrows, 128) converged entries; stats (tiles,
    5): step count, fixpoint sweeps, literals, 0, max count)."""
    lvs = (lv1, lv2, lv3, lv4)
    args = (ntc, win, l1lo, l1hi, *lvs, entry, segend, pbits, first, wbase)
    for name, t in zip(("ntc", "win", "l1lo", "l1hi", "lv1", "lv2", "lv3",
                        "lv4", "entry", "segend", "pbits", "first",
                        "wbase"), args):
        _check(t, name, torch.int32)
    nrows = entry.shape[0]
    if entry.dim() != 2 or nrows % 8 or entry.shape[1] != 128 or nrows == 0:
        raise ValueError("entry: need (8 * tiles, 128)")
    nt = nrows // 8
    for name, t in (("l1lo", l1lo), ("l1hi", l1hi), ("segend", segend),
                    ("pbits", pbits), ("first", first), ("wbase", wbase)):
        _check(t, name, torch.int32, (nrows, 128))
    _check(ntc, "ntc", torch.int32, (nt, 5))
    if win.dim() != 3 or tuple(win.shape[1:]) != (nrows, 128) \
            or not 1 <= win.shape[0] <= 64:
        raise ValueError("win: need (wseg <= 64, nrows, 128)")
    for k, lv in enumerate(lvs):
        if lv.dim() != 3 or tuple(lv.shape[1:]) != (nrows, 128) \
                or lv.shape[0] < 1:
            raise ValueError(f"lv{k + 1}: need (cap >= 1, nrows, 128)")
    if not _on_cuda(*args):
        return hzr_decode_plain(*args)
    if not _aligned16(win, l1lo, l1hi, *lvs):
        raise ValueError("hzr_decode: win, l1lo, l1hi and lv1..lv4 must be "
                         "16-byte aligned")
    kw = dict(dtype=torch.int32, device=entry.device)
    emis = torch.empty((nt, MAX_STEPS, 8, 128), **kw)
    counts = torch.empty((nrows, 128), **kw)
    entry_out = torch.empty((nrows, 128), **kw)
    stats = torch.empty((nt, 5), **kw)
    _launch("hzr_decode", _lib().rspt_hzr_decode,
            *[t.data_ptr() for t in args], emis.data_ptr(),
            counts.data_ptr(), entry_out.data_ptr(), stats.data_ptr(), nt,
            win.shape[0], *[lv.shape[0] for lv in lvs], MAX_STEPS,
            device=entry.device)
    hzr_decode.launches += 1
    return emis, counts, entry_out, stats


hzr_decode.launches = 0


# ---------------------------------------------------------------------------
# Kernel 6 — place_literals (K7, K8a/K8b, K9a/K9b and their glue)
# ---------------------------------------------------------------------------

def place_literals_plain(emis, steps, out_base, out_limit, lane_live, out):
    nt, S = emis.shape[:2]
    smax = min(int(steps.max()) if nt else 0, S)
    e = emis[:, :smax].reshape(nt, smax, 1024).permute(0, 2, 1)
    e = e.reshape(nt * 1024, smax).long()
    s = torch.arange(smax, device=emis.device)
    sym = e & 0x1FF
    pos = out_base.long()[:, None] + (e >> 9)
    live = ((s[None, :] < steps.long().repeat_interleave(1024)[:, None])
            & lane_live[:, None] & (sym > 0) & (pos >= 0)
            & (pos < out_limit.long()[:, None]) & (pos < out.numel()))
    out.index_put_((pos[live],), (sym[live] & 0xFF).to(torch.uint8))
    return out


def place_literals(emis: torch.Tensor, steps: torch.Tensor,
                   out_base: torch.Tensor, out_limit: torch.Tensor,
                   lane_live: torch.Tensor, total: int,
                   out: torch.Tensor = None) -> torch.Tensor:
    """Write every literal of hzr_decode's emissions to its output byte:
    at step s < steps[tile] of a live lane, an emission with byte
    sym != 0 lands at pos = out_base[lane] + (emis >> 9) if pos <
    out_limit[lane] (the guard that drops symbols decoded from a
    block's padding bits). A lane's positions rise with the step and
    lanes' runs are disjoint (hzr_decode's contract, lane_out_base), so
    the kernel stores whole words, with atomicOr on each thread's two
    edge words only.

    emis (tiles, S, 8, 128) int32, steps (tiles,) int32, out_base and
    out_limit (tiles * 1024,) int32, lane_live (tiles * 1024,) bool.
    Writes into `out` ((total,) uint8) when given, else into zeros;
    returns it."""
    _check(emis, "emis", torch.int32)
    if emis.dim() != 4 or tuple(emis.shape[2:]) != (8, 128):
        raise ValueError("emis: need (tiles, S, 8, 128)")
    nt = emis.shape[0]
    nl = nt * 1024
    _check(steps, "steps", torch.int32, (nt,))
    _check(out_base, "out_base", torch.int32, (nl,))
    _check(out_limit, "out_limit", torch.int32, (nl,))
    _check(lane_live, "lane_live", torch.bool, (nl,))
    if not 0 <= total < 2**31:
        raise ValueError("total out of range")
    if out is None:
        out = torch.zeros(total, dtype=torch.uint8, device=emis.device)
    _check(out, "out", torch.uint8, (total,))
    args = (emis, steps, out_base, out_limit, lane_live, out)
    if not _on_cuda(*args):
        return place_literals_plain(*args)
    if nt == 0 or total == 0:
        return out
    _launch("place_literals", _lib().rspt_place_literals,
            *[t.data_ptr() for t in args], nt, emis.shape[1], total,
            device=emis.device)
    place_literals.launches += 1
    return out


place_literals.launches = 0


# ---------------------------------------------------------------------------
# Kernels 7-9 — the windows pack: group_windows (K14), place_windows_aligned
# (X1), windows_place_flat (K15)
# ---------------------------------------------------------------------------
#
# The TPU's flat pack in two stages: per 8,192-token group, each 128-token
# chunk's bits in a 256-word window (K14), then per super of 32 chunks the
# windows merged in an accumulator of ACC_ROWS (AR2) rows of 128 words,
# bit-shifted by the group's misalignment and added into the flat payload
# words (K5, X1). Both port the TPU functions as they compute, clamps and
# cyclic accumulator wraps included; on real input none of those fires.

GROUP_TOK = 8192          # tokens per windows group
R_TV = 64                 # 128-token chunks per group
SUP_CHUNKS = 32           # chunks merged per super placement
ACC_ROWS = 48             # K5 / K15 super accumulator rows
AR2 = 56                  # X1's accumulator rows (8 more for the alignment)
D_CLAMP = 40 * 128 - 1    # a chunk's largest word offset in its super
WIN = 256                 # words per chunk window


def group_windows_plain(tokc, lut3):
    ng = lut3.shape[0]
    nc = ng * R_TV
    dev = tokc.device
    sym, extra, ebits, valid = _unpack_tokw(tokc.reshape(-1).to(torch.int64))
    # the TPU kernel's three 128-entry LUT rows: row 2 for every sym >= 256
    idx = torch.where(sym < 256, sym, 256 + (sym & 127))
    grp = torch.arange(ng * GROUP_TOK, device=dev) // GROUP_TOK
    e = lut3.reshape(ng, 3 * 128).to(torch.int64)[grp, idx] & _M32
    cb = e >> 24
    nbits = torch.where(valid, cb + ebits, 0).reshape(ng, GROUP_TOK)
    val = torch.where(valid, (e & 0xFFFFFF) | (extra << cb), 0)
    excl = (torch.cumsum(nbits, 1) - nbits).reshape(nc, 128)
    word = excl >> 5
    cbase = word[:, 0]
    loc = (word - cbase[:, None]).clamp(0, WIN - 2)
    rows = torch.arange(nc, device=dev)[:, None].expand(nc, 128)
    win = _place_words(rows, loc * 32 + (excl & 31), val, nc, WIN)
    return (win[:, :128].reshape(1, nc, 128).contiguous(),
            win[:, 128:].reshape(1, nc, 128).contiguous(),
            cbase.to(torch.int32).reshape(1, nc),
            (nbits.reshape(nc, 128) > 0).any(1).to(torch.int32).reshape(1, nc),
            nbits.sum(1).to(torch.int32).reshape(1, ng))


def group_windows(tokc: torch.Tensor, lut3: torch.Tensor):
    """K14's windows of a flat compacted token stream whose 8,192-token
    groups each belong to one block: tokc (1, ng * 8192) int32 token
    words, lut3 (ng, 3, 128) int32 each group's LUT (code | cbits << 24,
    261 entries zero-padded to 384; a token of sym >= 256 reads entry
    256 + (sym & 127)).

    With excl a token's group-local exclusive bit offset and its value
    placed LSB-first from bit excl, chunk c's window holds the words
    cbase[c] = excl[first token] >> 5 onwards; a token's words land at
    min(excl >> 5 - cbase, 254) and the next two, and a word at window
    index >= 256 is dropped. Returns (w0, w1 (1, ng * 64, 128): window
    words 0-127 and 128-255; cbase, clive (1, ng * 64): base word and
    whether any token has bits; gtot (1, ng): each group's bit total),
    all int32."""
    _check(tokc, "tokc", torch.int32)
    if tokc.dim() != 2 or tokc.shape[0] != 1 or tokc.shape[1] % GROUP_TOK:
        raise ValueError(f"tokc: need (1, ng * {GROUP_TOK})")
    ng = tokc.shape[1] // GROUP_TOK
    _check(lut3, "lut3", torch.int32, (ng, 3, 128))
    if ng >= 2**31 // GROUP_TOK:
        raise ValueError("tokc: too many groups")
    if not _on_cuda(tokc, lut3):
        return group_windows_plain(tokc, lut3)
    nc = ng * R_TV
    kw = dict(dtype=torch.int32, device=tokc.device)
    outs = (torch.empty((1, nc, 128), **kw), torch.empty((1, nc, 128), **kw),
            torch.empty((1, nc), **kw), torch.empty((1, nc), **kw),
            torch.empty((1, ng), **kw))
    if ng == 0:
        return outs
    if not _aligned16(tokc):
        raise ValueError("group_windows: tokc must be 16-byte aligned")
    _launch("group_windows", _lib().rspt_group_windows, tokc.data_ptr(),
            lut3.data_ptr(), *[t.data_ptr() for t in outs], ng,
            device=tokc.device)
    group_windows.launches += 1
    return outs


group_windows.launches = 0


def windows_glue(w0, w1, cbase, clive, gtot, dbg, wog, gfirst, nrows: int,
                 ar: int):
    """The cumsum + broadcast glue between K14 and K5
    (jax_coder.py:648-670; tools/exp_place.py:182-206 with its `ar`), as
    torch ops on the windows' device: the global exclusive scan of the
    group bit totals restarted at each block's first group gfirst[g],
    group_base = wog * 8 + dbg + that scan (int32), and per super of 32
    chunks its chunks' word offsets d = clip(cbase - the super's first
    cbase, 0, D_CLAMP), its word base clip((group_base >> 5) + first
    cbase, 0, (nrows - ar) * 128), its bit misalignment group_base & 31
    and whether any chunk is live. Returns K5's seven inputs: w0, w1,
    drow (1, nc, 1), dlane (1, nsup, 32), wbase, sbits, slive (1, nsup,
    1), int32."""
    ng = gtot.shape[1]
    nc = cbase.shape[1]
    nsup = nc // SUP_CHUNKS
    g = gtot.reshape(ng).to(torch.int64)
    e = torch.cumsum(g, 0) - g
    e_in = e - e[gfirst.to(torch.int64)]
    group_base = tops._wrap32(wog.to(torch.int64) * 8 + dbg.to(torch.int64)
                              + e_in).to(torch.int64)
    cb = cbase.reshape(nsup, SUP_CHUNKS).to(torch.int64)
    superbase = cb[:, 0]
    d = (cb - superbase[:, None]).clamp(0, D_CLAMP)
    gb_s = group_base.repeat_interleave(nsup // ng if ng else 0)
    wbase = ((gb_s >> 5) + superbase).clamp(0, (nrows - ar) * 128)
    slive = (clive.reshape(nsup, SUP_CHUNKS) > 0).any(1)

    def i32(a, *shape):
        return a.to(torch.int32).reshape(shape).contiguous()

    return (w0, w1, i32(d, 1, nc, 1), i32(d, 1, nsup, SUP_CHUNKS),
            i32(wbase, 1, nsup, 1), i32(gb_s & 31, 1, nsup, 1),
            i32(slive, 1, nsup, 1))


def _place_supers(w0, w1, drow, dlane, wbase, sbits, slive, nrows: int,
                  ar: int, aligned: bool):
    """K5's placement (_super_place_body) with an ar-row accumulator, or
    X1's (_flat_kernel_aligned) with aligned: chunk c's window lands at
    word (rc * 128 + t + x) mod ar * 128 of its super's accumulator (rc
    = dlane >> 7 < ar, t = drow & 127), the accumulator is shifted left
    by sbits bits as a cyclic bit string, rotated by off and added at
    word base of the output: base = (wbase >> 7) * 128 (X1: the row
    rounded down to a multiple of 8), off = wbase - base. Words outside
    the output are dropped."""
    dev = w0.device
    nc = w0.shape[1]
    nsup = nc // SUP_CHUNKS
    n = ar * 128
    nout = nrows * 128
    out = torch.zeros(nout + 1, dtype=torch.int64, device=dev)
    live = torch.nonzero(slive.reshape(nsup) != 0)[:, 0]
    L = live.numel()
    if L:
        win = torch.cat([w0[0], w1[0]], 1).to(torch.int64) & _M32
        win = win.reshape(nsup, SUP_CHUNKS, WIN)[live]
        t = drow.reshape(nsup, SUP_CHUNKS)[live].to(torch.int64) & 127
        rc = dlane.reshape(nsup, SUP_CHUNKS)[live].to(torch.int64) >> 7
        ok = ((rc >= 0) & (rc < ar))[:, :, None]
        k = ((rc * 128 + t)[:, :, None]
             + torch.arange(WIN, device=dev)) % n
        idx = torch.arange(L, device=dev)[:, None, None] * n + k
        acc = torch.zeros(L * n + 1, dtype=torch.int64, device=dev)
        acc.index_add_(0, torch.where(ok, idx, L * n).reshape(-1),
                       torch.where(ok, win, 0).reshape(-1))
        acc = acc[:-1].reshape(L, n) & _M32
        sb = sbits.reshape(nsup)[live].to(torch.int64)[:, None] & 31
        # sb = 0: the previous word >> 32 is 0
        acc = ((acc << sb) & _M32) | (torch.roll(acc, 1, 1) >> (32 - sb))
        b = wbase.reshape(nsup)[live].to(torch.int64)
        row0 = b >> 7
        if aligned:
            row0 = row0 & ~7
        base = row0 * 128
        dest = base[:, None] + (torch.arange(n, device=dev)
                                + (b - base)[:, None]) % n
        inb = (dest >= 0) & (dest < nout)
        out.index_add_(0, torch.where(inb, dest, nout).reshape(-1),
                       torch.where(inb, acc, 0).reshape(-1))
    return tops._wrap32(out[:-1].reshape(nrows, 128))


def place_windows_aligned_plain(w0, w1, drow, dlane, wbase, sbits, slive,
                                nrows: int):
    return _place_supers(w0, w1, drow, dlane, wbase, sbits, slive, nrows,
                         AR2, True)


def place_windows_aligned(w0: torch.Tensor, w1: torch.Tensor,
                          drow: torch.Tensor, dlane: torch.Tensor,
                          wbase: torch.Tensor, sbits: torch.Tensor,
                          slive: torch.Tensor, nrows: int) -> torch.Tensor:
    """X1: K5's placement of chunk windows into one flat (nrows, 128)
    int32 word buffer, each super's span written from an 8-row-aligned
    row with a 56-row accumulator (_place_supers with aligned). Inputs
    are windows_glue's with ar = AR2: w0, w1 (1, nc, 128), drow (1, nc,
    1), dlane (1, nc / 32, 32), wbase, sbits, slive (1, nc / 32, 1), all
    int32; nrows >= 56. On the card each accumulator word is gathered
    from the window words that cover it and every nonzero placed word
    is added into the zeroed output, so the result is exact on every
    input, supers whose spans overlap included. K5
    (super_place_flat_pallas) computes the same words on the glue's
    arrays where no chunks overlap (it ORs its accumulator's byte sums),
    rc < 48 (its accumulator has 48 rows, so a window past word 6,143
    wraps elsewhere), sbits < 32 and wbase lies in [0, (nrows - 48) *
    128]; outside that the two differ by design."""
    _check(w0, "w0", torch.int32)
    if w0.dim() != 3 or w0.shape[0] != 1 or w0.shape[2] != 128 \
            or w0.shape[1] % SUP_CHUNKS:
        raise ValueError(f"w0: need (1, nc, 128), nc a multiple of "
                         f"{SUP_CHUNKS}")
    nc = w0.shape[1]
    nsup = nc // SUP_CHUNKS
    _check(w1, "w1", torch.int32, (1, nc, 128))
    _check(drow, "drow", torch.int32, (1, nc, 1))
    _check(dlane, "dlane", torch.int32, (1, nsup, SUP_CHUNKS))
    for name, t in (("wbase", wbase), ("sbits", sbits), ("slive", slive)):
        _check(t, name, torch.int32, (1, nsup, 1))
    if not AR2 <= nrows < 2**31 // 128:
        raise ValueError(f"nrows: need {AR2} <= nrows < 2^24")
    args = (w0, w1, drow, dlane, wbase, sbits, slive)
    if not _on_cuda(*args):
        return place_windows_aligned_plain(*args, nrows)
    out = torch.zeros((nrows, 128), dtype=torch.int32, device=w0.device)
    if nsup == 0:
        return out
    _launch("place_windows_aligned", _lib().rspt_place_windows_aligned,
            *[t.data_ptr() for t in args], out.data_ptr(), nsup, nrows,
            device=w0.device)
    place_windows_aligned.launches += 1
    return out


place_windows_aligned.launches = 0


def _flat_buffers(nrows: int, ng: int, device, lib=None):
    """One zeroed int32 buffer: the (nrows, 128) output words, then the
    state of lib's (default: the port's) windows_place_flat kernel (its
    tile ticket, its slow-path count and one word a tile): returns (out,
    state)."""
    lib = lib or _lib()
    n = nrows * 128
    buf = torch.zeros(n + lib.rspt_windows_place_flat_state(ng),
                      dtype=torch.int32, device=device)
    return buf[:n].view(nrows, 128), buf[n:]


def windows_place_flat_plain(tokc, lut3, dbg, wog, gfirst, ng: int,
                             nrows: int):
    w = group_windows_plain(tokc.reshape(-1)[:ng * GROUP_TOK].reshape(1, -1),
                            lut3)
    args = windows_glue(*w, dbg, wog, gfirst, nrows, ACC_ROWS)
    return _place_supers(*args, nrows, ACC_ROWS, False)


def windows_place_flat(tokc: torch.Tensor, lut3: torch.Tensor,
                       dbg: torch.Tensor, wog: torch.Tensor,
                       gfirst: torch.Tensor, ng: int,
                       nrows: int) -> torch.Tensor:
    """K15: the flat payload words of the first ng groups of compacted
    tokens tokc ((t_rows, 128) int32, t_rows >= ng * 64) in one kernel:
    K14's windows, the exclusive scan of the group bit totals restarted
    at each block's first group gfirst[g], the group's base bit wog[g] *
    8 + dbg[g] + that scan, and K5's placement with the 48-row
    accumulator (group_windows → windows_glue(ar=ACC_ROWS) → K5).
    lut3 (ng, 3, 128), dbg, wog, gfirst (ng,) int32 (description bits,
    payload byte offset and first group of each group's block); nrows
    >= 48. Returns (nrows, 128) int32.

    On the card a CTA codes one super (4,096 tokens) and places each
    value directly at its bit, which equals the accumulator's result
    while every valid token of the super has cbits <= 23, code <
    2^cbits and extra < 2^ebits and the super's word base needs no
    clamp; a live super that fails one goes through the accumulator as
    the plain version does. windows_place_flat.last_slow is a (1,) int32
    tensor on the card: the supers of the last call that took that slow
    path (None after a CPU call or with ng = 0). As in K5, supers whose
    spans share more than an edge word are not supported (real input
    never has them), and the card's carry sums groups max(gfirst[g], 0)
    .. g - 1, the plain version's scan for 0 <= gfirst[g] <= g. Where
    chunks pile up in the accumulator (a chunk past D_CLAMP or a token
    past window word 254: more than ~41 or 63.5 bits a token), the plain
    version and the kernel add the overlapping words, but
    token_windows_place_flat_pallas ORs its accumulator's byte sums,
    which is exact for disjoint bits only: such input lies outside the
    TPU kernel's exact domain (flat_plan's codes have cbits <= 23)."""
    _check(tokc, "tokc", torch.int32)
    if tokc.dim() != 2 or tokc.shape[1] != 128 or tokc.shape[0] < ng * R_TV:
        raise ValueError(f"tokc: need (t_rows >= {ng * R_TV}, 128)")
    if not 0 <= ng < 2**31 // GROUP_TOK:
        raise ValueError("ng out of range")
    _check(lut3, "lut3", torch.int32, (ng, 3, 128))
    for name, t in (("dbg", dbg), ("wog", wog), ("gfirst", gfirst)):
        _check(t, name, torch.int32, (ng,))
    if not ACC_ROWS <= nrows < 2**31 // 128:
        raise ValueError(f"nrows: need {ACC_ROWS} <= nrows < 2^24")
    args = (tokc, lut3, dbg, wog, gfirst)
    windows_place_flat.last_slow = None
    if not _on_cuda(*args):
        return windows_place_flat_plain(*args, ng, nrows)
    dev = tokc.device
    if ng == 0:
        return torch.zeros((nrows, 128), dtype=torch.int32, device=dev)
    if not _aligned16(tokc):
        raise ValueError("windows_place_flat: tokc must be 16-byte aligned")
    out, state = _flat_buffers(nrows, ng, dev)
    _launch("windows_place_flat", _lib().rspt_windows_place_flat,
            *[t.data_ptr() for t in args], out.data_ptr(), state.data_ptr(),
            ng, nrows, device=dev)
    windows_place_flat.launches += 1
    windows_place_flat.last_slow = state[1:2]
    return out


windows_place_flat.launches = 0
windows_place_flat.last_slow = None


# ---------------------------------------------------------------------------
# Kernels S1-S4 — iir_scan, iir_assoc, fir_apply, peak_gate (the batch
# signal ops; rows of float32 or float64 samples, one channel a row)
# ---------------------------------------------------------------------------

IIR_MAX_P = 8           # coefficients S1/S2 take (order 7)
FIR_MAX_TAPS = 256      # taps S3 takes
_FLOATS = (torch.float32, torch.float64)


def _rounded(vals: Sequence[float], dtype: torch.dtype):
    """Python floats of vals rounded to dtype, as the JAX package casts
    its static coefficients (jax_filters.py:60, :103)."""
    t = torch.tensor([float(v) for v in vals], dtype=torch.float64)
    return t.to(dtype).tolist()


def _feedforward_plain(x: torch.Tensor, d, xz: torch.Tensor) -> torch.Tensor:
    """u[t] = the sum over i, from 0 in order, of d[i]·x[t−i], with x's
    history xz (the newest first) before t = 0 (jax_filters._feedforward)."""
    p, T = len(d), x.shape[1]
    xp = torch.cat([xz.flip(1), x], 1)
    u = torch.zeros_like(x)
    for i in range(p):
        u = u + d[i] * xp[:, p - 1 - i:p - 1 - i + T]
    return u


def _recurrence_plain(u: torch.Tensor, n, s) -> torch.Tensor:
    """y[t] = u[t] − n[1]·s[0] − n[2]·s[1] − … in that order, a step of
    torch ops a sample; s: the p − 1 (rows,) y histories, the newest
    first, updated in place."""
    uT = u.t()
    out = torch.empty_like(uT)
    for t in range(uT.shape[0]):
        y = uT[t]
        for i in range(1, len(n)):
            y = y - n[i] * s[i - 1]
        out[t] = y
        s.insert(0, y)
        s.pop()
    return out.t()


def iir_scan_plain(x: torch.Tensor, n, d, xz: torch.Tensor,
                   yz: torch.Tensor) -> torch.Tensor:
    n, d = _rounded(n, x.dtype), _rounded(d, x.dtype)
    s = [yz[:, i] for i in range(len(n) - 1)]
    return _recurrence_plain(_feedforward_plain(x, d, xz), n,
                             s).contiguous()


def check_iir_coefficients(n, d) -> int:
    """p, the coefficients of each of n and d; raises ValueError unless
    2 <= p <= 8 (what S1 and S2 take)."""
    p = len(n)
    if len(d) != p or not 2 <= p <= IIR_MAX_P:
        raise ValueError(f"iir: 2..{IIR_MAX_P} coefficients, equal lengths "
                         f"(got {len(n)} and {len(d)})")
    return p


def _check_iir_args(x, n, d, xz, yz):
    if x.dtype not in _FLOATS:
        raise TypeError(f"x: expected float32 or float64, got {x.dtype}")
    _check(x, "x", x.dtype)
    if x.dim() != 2:
        raise ValueError("x: need (rows, T)")
    p = check_iir_coefficients(n, d)
    rows = x.shape[0]
    _check(xz, "xz", x.dtype, (rows, p - 1))
    _check(yz, "yz", x.dtype, (rows, p - 1))
    return _on_cuda(x, xz, yz)


def _coef_args(n, d, dtype):
    """The coefficients rounded to dtype as host double arrays (kept
    alive by the caller) and their addresses."""
    arrs = [(ctypes.c_double * len(v))(*_rounded(v, dtype)) for v in (n, d)]
    return arrs, [ctypes.addressof(a) for a in arrs]


def iir_scan(x: torch.Tensor, n: Sequence[float], d: Sequence[float],
             xz: torch.Tensor, yz: torch.Tensor) -> torch.Tensor:
    """S1: each row of x ((rows, T) float32 or float64) through the IIR
    with feedback n and feedforward d (2..8 coefficients each, rounded to
    x's type), serially: u[t] = sum_i d[i]·x[t−i] from 0 in order, y[t] =
    u[t] − n[1]·y[t−1] − … in order (filter_opt's order: in float64 the
    bits of the host runtime's iir_filter_channels(opt=1)). xz, yz: (rows,
    p − 1) histories of x and y, the newest first. One launch, a CTA a row
    (the feedback chain on one lane); a new tensor."""
    if not _check_iir_args(x, n, d, xz, yz):
        return iir_scan_plain(x, n, d, xz, yz)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    _keep, (nh, dh) = _coef_args(n, d, x.dtype)
    _launch("iir_scan", _lib().rspt_iir_scan, x.data_ptr(), xz.data_ptr(),
            yz.data_ptr(), y.data_ptr(), nh, dh, len(n), x.shape[0],
            x.shape[1], int(x.dtype == torch.float64), device=x.device)
    iir_scan.launches += 1
    return y


iir_scan.launches = 0


def companion_matrix(n: Sequence[float]) -> np.ndarray:
    """The feedback's companion matrix A ((p − 1) × (p − 1) float64):
    row 0 holds −n[1:], the subdiagonal 1 shifts the y history
    (jax_filters._companion, :36)."""
    m = len(n) - 1
    A = np.zeros((m, m))
    A[0] = -np.asarray(n[1:], np.float64)
    A[np.arange(1, m), np.arange(m - 1)] = 1.0
    return A


@functools.lru_cache(maxsize=64)
def _iir_tables(n: Tuple[float, ...], L: int, dtype: torch.dtype,
                device: torch.device):
    A = companion_matrix(n)
    pw = np.empty((L, len(n) - 1))
    row = A[0].copy()
    for j in range(L):
        pw[j] = row
        row = row @ A
    al = np.linalg.matrix_power(A, L)
    # copies from pageable memory: the host waits for the stream (on a
    # miss of the cache only)
    with tracing.sync("iir_tables", device):
        return (torch.from_numpy(al).to(dtype).contiguous().to(device),
                torch.from_numpy(pw).to(dtype).contiguous().to(device))


def iir_tables(n: Sequence[float], L: int, dtype: torch.dtype,
               device: torch.device):
    """S2's tables for tiles of L samples: (A^L (m, m), P (L, m)) with P[j]
    row 0 of A^(j+1), A the companion matrix of the feedback n (row 0
    −n[1:], the subdiagonal 1; m = p − 1). Powers in float64 on the host,
    stored in dtype. Cached by (n, L, dtype, device), so a second call
    makes no copy: a copy from pageable host memory to the card
    synchronises the stream, and iir_assoc would wait for the card before
    it launched. Shared tensors: read them, never write them."""
    return _iir_tables(tuple(float(v) for v in n), int(L), dtype,
                       torch.device(device))


def iir_assoc_plain(x: torch.Tensor, n, d, xz: torch.Tensor,
                    yz: torch.Tensor, L: int) -> torch.Tensor:
    """S2's arithmetic in torch ops: tiles of L samples, each from a zero
    state; the tiles' start states by a serial pass over them; the fix-up
    of each output by row 0 of A^(j+1)."""
    rows, T = x.shape
    m = len(n) - 1
    al, pw = iir_tables(n, L, x.dtype, x.device)
    n, d = _rounded(n, x.dtype), _rounded(d, x.dtype)
    nt = -(-T // L)
    u = torch.nn.functional.pad(_feedforward_plain(x, d, xz),
                                (0, nt * L - T))
    s = [x.new_zeros(rows * nt) for _ in range(m)]
    loc = _recurrence_plain(u.reshape(rows * nt, L), n, s)
    ends = torch.stack(s, 1).reshape(rows, nt, m)
    starts = x.new_empty((rows, nt, m))
    cur = yz
    for k in range(nt):
        starts[:, k] = cur
        if k + 1 == nt:
            break
        acc = x.new_zeros((rows, m))
        for c in range(m):
            acc = acc + al[:, c] * cur[:, c:c + 1]
        cur = acc + ends[:, k]
    f = x.new_zeros((rows, nt, L))
    for c in range(m):
        f = f + pw[:, c] * starts[:, :, c:c + 1]
    y = loc.reshape(rows, nt, L) + f
    return y.reshape(rows, nt * L)[:, :T].contiguous()


def iir_assoc(x: torch.Tensor, n: Sequence[float], d: Sequence[float],
              xz: torch.Tensor, yz: torch.Tensor, L: int) -> torch.Tensor:
    """S2: iir_scan's filter parallel in T, over tiles of L samples: each
    tile's recurrence from a zero state (a lane a tile, a warp 32 tiles),
    the tiles' start states s_(k+1) = A^L·s_k + e_k by a serial pass a row
    (a CTA a row), then each tile recomputed with y[kL + j] +=
    (A^(j+1)·s_k)[0]; the tables from iir_tables, cached on the device
    (no copy and no stream sync a call). Not iir_scan's bits: close to
    them. rows · ceil(T / L) < 2^31. One call, three launches (counted as
    one); a new tensor."""
    cuda = _check_iir_args(x, n, d, xz, yz)
    if L < 1:
        raise ValueError("L must be >= 1")
    if not cuda:
        return iir_assoc_plain(x, n, d, xz, yz, L)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    rows, T = x.shape
    m = len(n) - 1
    nt = -(-T // L)
    if rows * nt >= 2**31:
        raise ValueError("iir_assoc: rows * ceil(T / L) must be < 2^31")
    al, pw = iir_tables(n, L, x.dtype, x.device)
    scratch = torch.empty((2, rows, nt, m), dtype=x.dtype, device=x.device)
    _keep, (nh, dh) = _coef_args(n, d, x.dtype)
    _launch("iir_assoc", _lib().rspt_iir_assoc, x.data_ptr(), xz.data_ptr(),
            yz.data_ptr(), y.data_ptr(), scratch[0].data_ptr(),
            scratch[1].data_ptr(), al.data_ptr(), pw.data_ptr(), nh, dh,
            m + 1, rows, T, L, int(x.dtype == torch.float64),
            device=x.device)
    iir_assoc.launches += 1
    return y


iir_assoc.launches = 0


def fir_apply_plain(x: torch.Tensor, taps: torch.Tensor,
                    window=None) -> torch.Tensor:
    rows, T = x.shape
    ks = taps.numel()
    w = x.new_zeros((rows, ks)) if window is None else window
    xp = torch.cat([w, x], 1)
    y = torch.zeros_like(x)
    for i, k in enumerate(taps.tolist()):
        y = y + k * xp[:, i + 1:i + 1 + T]
    if window is None:
        y[:, :ks] = 0
    return y


def fir_apply(x: torch.Tensor, taps: torch.Tensor,
              window=None) -> torch.Tensor:
    """S3: each row of x ((rows, T) float32 or float64) through the FIR
    taps ((ks,) of x's type, 1..256): y[t] = the sum over i, from 0 in
    order, of taps[i]·xp[t + i + 1], xp = window then x; window: (rows,
    ks) prior samples, the oldest first, or None: fresh, and then y[t] = 0
    for t < ks (the reference's warm-up). One launch, a thread 16
    consecutive outputs; a new tensor."""
    if x.dtype not in _FLOATS:
        raise TypeError(f"x: expected float32 or float64, got {x.dtype}")
    _check(x, "x", x.dtype)
    if x.dim() != 2:
        raise ValueError("x: need (rows, T)")
    ks = taps.numel()
    _check(taps, "taps", x.dtype, (ks,))
    if not 1 <= ks <= FIR_MAX_TAPS:
        raise ValueError(f"taps: 1..{FIR_MAX_TAPS} of them, got {ks}")
    rows, T = x.shape
    if window is not None:
        _check(window, "window", x.dtype, (rows, ks))
    if not _on_cuda(*(t for t in (x, taps, window) if t is not None)):
        return fir_apply_plain(x, taps, window)
    if rows > 65535:
        raise ValueError("x: at most 65,535 rows")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    w = torch.zeros((rows, ks), dtype=x.dtype, device=x.device) \
        if window is None else window
    _launch("fir_apply", _lib().rspt_fir_apply, x.data_ptr(), w.data_ptr(),
            taps.data_ptr(), y.data_ptr(), rows, T, ks, int(window is None),
            int(x.dtype == torch.float64), device=x.device)
    fir_apply.launches += 1
    return y


fir_apply.launches = 0


def _f32(v: float) -> float:
    return float(np.float32(v))


def peak_gate_plain(sig: torch.Tensor, thr: torch.Tensor, nr_slope: int,
                    atten: float, marker: float) -> torch.Tensor:
    """peak_gate's state machine, a step of torch ops a sample."""
    atten, marker = _f32(atten), _f32(marker)
    rows, T = sig.shape
    prev_amp = sig.new_zeros(rows)
    prev_sig = sig.new_zeros(rows)
    searching = torch.zeros(rows, dtype=torch.bool, device=sig.device)
    count = torch.zeros(rows, dtype=torch.int32, device=sig.device)
    sT, gT = sig.t(), (thr * 1.5).t()
    out = torch.empty_like(sT)
    for t in range(T):
        s = sT[t]
        confirm = searching & (s > gT[t]) & (prev_sig > s)
        accept = confirm & ((prev_amp == 0) | (prev_sig > prev_amp * 0.5))
        attenuate = confirm & ~accept
        rising = ~confirm & (prev_sig < s)
        prev_amp = torch.where(accept, prev_sig, torch.where(
            attenuate, prev_amp * atten, prev_amp))
        count = torch.where(accept, 1, torch.where(rising, 0, count))
        searching = torch.where(accept, False, torch.where(
            rising, True, searching))
        count = torch.where(count > 0, count + 1, count)
        fire = count == nr_slope
        count = torch.where(fire, 0, count)
        out[t] = torch.where(fire, s if marker == -1.0 else marker, 0.0)
        prev_sig = s
    return out.t().contiguous()


def gate_schedule() -> Tuple[int, int, int]:
    """S4's default schedule from peaks.cu: (samples a chunk, warm-up
    samples before a chunk, samples between checkpoints)."""
    out = (ctypes.c_int * 3)()
    _lib().rspt_peak_gate_schedule(out)
    return tuple(out)


def peak_gate(sig: torch.Tensor, thr: torch.Tensor, nr_slope: int,
              atten: float, marker: float, chunk: Optional[int] = None,
              warmup: Optional[int] = None) -> torch.Tensor:
    """S4: the amplitude-gated state machine of the peak detectors
    (peak_detector.h:95-122) along each row of sig and thr ((rows, T)
    float32), in float32: threshold ratio 1.5, reference ratio 0.5, the
    attenuation factor atten (1 / (1 + a / sr)), a marker nr_slope samples
    after each accepted peak (marker, or the signal value if marker is
    −1). On the card, in chunks of `chunk` samples, each run from a state
    guessed `warmup` samples before it, then a repair walk a row that
    re-runs a chunk whose guess was wrong until it merges (peaks.cu): the
    serial result whatever the schedule. chunk (>= 1) and warmup (>= 0)
    default to gate_schedule()'s; warmup=0 and small chunks force re-runs,
    chunk=T is one serial walk a row. The plain version ignores them. Two
    launches (one when a row is one chunk), counted as one; the chunks and
    samples re-run a row ((rows, 2) int64 on the card) in
    peak_gate.last_reruns. A new (rows, T) float32 tensor."""
    _check(sig, "sig", torch.float32)
    if sig.dim() != 2:
        raise ValueError("sig: need (rows, T)")
    _check(thr, "thr", torch.float32, tuple(sig.shape))
    if (chunk is not None and chunk < 1) or (warmup is not None
                                             and warmup < 0):
        raise ValueError(f"chunk must be >= 1 and warmup >= 0, got "
                         f"{chunk}, {warmup}")
    peak_gate.last_reruns = None
    if not _on_cuda(sig, thr):
        return peak_gate_plain(sig, thr, nr_slope, atten, marker)
    out = torch.empty_like(sig)
    if out.numel() == 0:
        return out
    rows, T = sig.shape
    c_def, w_def, ckpt = gate_schedule()
    chunk = min(T, c_def if chunk is None else int(chunk))
    warm = min(T, w_def if warmup is None else int(warmup))
    nk = -(-T // chunk)
    if chunk + warm >= 2 ** 31 or rows * nk >= 2 ** 31:
        raise ValueError(f"peak_gate: chunk + warmup ({chunk + warm}) and "
                         f"rows x chunks ({rows * nk}) must be < 2^31")
    # the guessed starts, the ends and the checkpoints: 16 B a state
    state = torch.empty((rows * nk * (2 + (chunk - 1) // ckpt), 4),
                        dtype=torch.int32, device=sig.device)
    reruns = torch.empty((rows, 2), dtype=torch.int64, device=sig.device)
    _launch("peak_gate", _lib().rspt_peak_gate, sig.data_ptr(),
            thr.data_ptr(), out.data_ptr(), state.data_ptr(),
            reruns.data_ptr(), rows, T, chunk, warm, int(nr_slope),
            _f32(atten), _f32(marker), device=sig.device)
    peak_gate.launches += 1
    peak_gate.last_reruns = reruns
    return out


peak_gate.launches = 0
peak_gate.last_reruns = None


KERNELS = (xdelta_swizzle, xdelta_swizzle_batch, tokenize_planes,
           compact_tokens, pack_flat, pack_flat_lanes, pack_blocks,
           pack_blocks_tokw, fwht, dct_forward, dct_inverse, hzr_decode,
           place_literals, group_windows, place_windows_aligned,
           windows_place_flat, iir_scan, iir_assoc, fir_apply, peak_gate)
