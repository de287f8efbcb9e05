"""ctypes bindings of the port's host runtime (``rspt_torch_native.cpp``).

Each function computes what its plain Python version computes, byte for
byte: ``crc32c`` as ``formats.crc32c.crc32c_plain``, ``build_tables``
as ``hzr.torch_coder.host_tables_plain``, the decoders as
``hzr.pyref.decode``, ``verify`` as ``hzr.pyref.verify``,
``lut_nib_batch`` as ``hzr.gpu_decoder.build_lut_nib`` of
``hzr.pyref._recover_tree``, and ``iir_filter_array`` /
``iir_filter_channels`` as ``filters.streaming.IirFilter``'s
``filter_opt`` (opt 1) and ``filter`` (opt 0) loops, bit for bit. The LZ4
calls (``lz4_compress``, ``lz4_compress_hc``, ``lz4_decompress`` and the
plane batches ``lz4_encode_planes`` / ``lz4_decode_planes``) write and
read the reference runtime's LZ4 block bytes; ``formats.lz4_block`` is
their spec decoder.

The encode half serves the all-host engine (packers/native.py):
``hzr_encode`` writes ``hzr.torch_coder.encode``'s stream, and
``encode_planes_blocks`` a container's plane streams, every 64 KiB block
of every plane in threads; the elementwise ops (``delta_encode`` ...
``plane_merge``) compute what ``ops.torch_ops``' do; ``xdelta_preprocess``
/ ``xdelta_postprocess`` the xdelta packer's planes and their inverse,
with the port's growth rule (``ops.cuda_kernels._fits_planes``);
``dct_forward`` / ``dct_inverse`` and ``fwht`` the reference's exact
transforms; ``stream_filter_pack`` a streaming span's frames in one
call. ``nthreads`` bounds the threads of a call (0: one a hardware
thread); no thread count changes a byte.

Bad input raises ValueError, as the plain versions do. The library is
built on the first call (``_build``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np

from ..formats.hzr_constants import BLOCK_HEADER_SIZE, HEADER_SIZE, \
    MAX_BLOCK_SIZE, NUM_SYMBOLS
from . import _build

NIB_LEVELS = 4        # 4-bit levels past the 8-bit root LUT
NIB_CAP_SLOTS = 260   # slots a level can need: a tree has < 260 branches
NIB_CHUNK = 64        # blocks a LUT batch call: 4.3 MB of slot scratch

_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_I = ctypes.c_int
_LL = ctypes.c_longlong
_I32 = ctypes.c_int32
_D = ctypes.c_double
_SIGNATURES = {
    "rpt_crc32c": (ctypes.c_uint32, [_P, _SZ, ctypes.c_uint32]),
    "rpt_crc32c_sw": (ctypes.c_uint32, [_P, _SZ, ctypes.c_uint32]),
    "rpt_crc32c_hw_ok": (_I, []),
    "rpt_hzr_decode": (_I, [_P, _SZ, _P, _SZ, _P]),
    "rpt_hzr_verify": (_I, [_P, _SZ, _P]),
    "rpt_hzr_decode_blocks_mt": (_I, [_P, _SZ, _P, _SZ, _I]),
    "rpt_decode_planes_blocks_mt": (_I, [_P, _SZ, _I, _SZ, _P, _P, _I]),
    "rpt_build_tables": (_I, [_P, _I, _P, _P, _P, _SZ, _P, _P, _I]),
    "rpt_declutnib_batch": (_I, [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                                 _I]),
    "rpt_iir_filter_array": (None, [_P, _SZ, _P, _P, _I, _P, _P, _I, _P]),
    "rpt_iir_filter_channels": (None, [_P, _SZ, _SZ, _P, _P, _I, _P, _P, _I,
                                       _P, _I]),
    "rpt_lz4_max_compressed": (_LL, [_LL]),
    "rpt_lz4_compress": (_LL, [_P, _LL, _P, _LL]),
    "rpt_lz4_compress_hc": (_LL, [_P, _LL, _P, _LL, _I]),
    "rpt_lz4_decompress": (_LL, [_P, _LL, _P, _LL]),
    "rpt_lz4_encode_planes": (_I, [_P, _I, _SZ, _I, _P, _P]),
    "rpt_lz4_decode_planes": (_I, [_P, _SZ, _I, _SZ, _P, _P]),
    "rpt_threads": (_I, []),
    "rpt_hzr_max_size": (_SZ, [_SZ]),
    "rpt_hzr_encode": (_I, [_P, _SZ, _P, _SZ, _P]),
    "rpt_delta_encode": (None, [_P, _SZ]),
    "rpt_delta_decode": (None, [_P, _SZ]),
    "rpt_offset32": (None, [_P, _SZ, _I32]),
    "rpt_xor_encode": (None, [_P, _SZ]),
    "rpt_xor_decode": (None, [_P, _SZ]),
    "rpt_native_to_i32": (None, [_P, _P, _SZ, _SZ, _SZ]),
    "rpt_i32_to_native": (None, [_P, _P, _SZ, _SZ, _SZ]),
    "rpt_plane_split": (None, [_P, _SZ, _I, _P]),
    "rpt_plane_merge": (None, [_P, _SZ, _I, _P]),
    "rpt_encode_planes_blocks_mt": (_I, [_P, _SZ, _I, _P, _SZ, _P, _I]),
    "rpt_xdelta_preprocess_mt": (_I, [_P, _SZ, _SZ, _SZ, _I, _P, _I]),
    "rpt_xdelta_postprocess_mt": (_I, [_P, _SZ, _SZ, _SZ, _I, _P, _I]),
    "rpt_dct_forward_mt": (_I, [_P, _P, _P, _P, _I, _I, _D, _I]),
    "rpt_dct_inverse_mt": (_I, [_P, _P, _P, _P, _I, _I, _D, _I]),
    "rpt_fwht": (_I, [_P, _P, _SZ, _I, _I]),
    "rpt_fwht_normalize": (None, [_P, _SZ, _I, _D]),
    "rpt_fwht_normalize2": (None, [_P, _SZ, _D]),
    "rpt_stream_filter_pack": (_I, [_P, _SZ, _SZ, _SZ, _SZ, _P, _P, _I, _P,
                                    _P, _I, _I, _P, _SZ, _P, _P, _I]),
}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _u8(data) -> np.ndarray:
    """A contiguous uint8 view of bytes-like data (an ndarray's values
    taken as uint8)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.astype(np.uint8, copy=False)
                                    .reshape(-1))
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def _p(a: np.ndarray) -> int:
    return a.ctypes.data


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of ``data``; ``crc`` is the CRC32C of the bytes before it,
    so that crc32c(b, crc32c(a)) == crc32c(a + b)."""
    buf = _u8(data)
    return int(_lib().rpt_crc32c(_p(buf), buf.size, crc & 0xFFFFFFFF))


def crc32c_sw(data, crc: int = 0) -> int:
    """crc32c through the software slice-by-8 loop alone (for tests)."""
    buf = _u8(data)
    return int(_lib().rpt_crc32c_sw(_p(buf), buf.size, crc & 0xFFFFFFFF))


def crc32c_hw_ok() -> bool:
    """True when crc32c runs on the CPU's CRC32C instruction."""
    return bool(_lib().rpt_crc32c_hw_ok())


def build_tables(hists: np.ndarray, desc_stride: int):
    """Per-block Huffman tables of (nb, 261) histograms, in threads.

    Returns (codes u32 (nb, 261), cbits i32 (nb, 261), desc_bytes u8
    (nb, desc_stride), desc_bits i32 (nb,), is_fill bool (nb,)); a FILL
    block (one code class, or no symbol at all) has zero tables."""
    h = np.ascontiguousarray(hists, np.uint32).reshape(-1, NUM_SYMBOLS)
    nb = h.shape[0]
    codes = np.zeros((nb, NUM_SYMBOLS), np.uint32)
    cbits = np.zeros((nb, NUM_SYMBOLS), np.int32)
    desc_bytes = np.zeros((nb, desc_stride), np.uint8)
    desc_bits = np.zeros(nb, np.int32)
    is_fill = np.zeros(nb, np.uint8)
    if _lib().rpt_build_tables(_p(h), nb, _p(codes), _p(cbits),
                               _p(desc_bytes), desc_stride, _p(desc_bits),
                               _p(is_fill), 0):
        raise ValueError("hzr: a tree description passes desc_stride")
    return codes, cbits, desc_bytes, desc_bits, is_fill.astype(bool)


def _stream_size(buf: np.ndarray) -> int:
    """The stream's decoded size, checked against what its bytes can
    hold (a block takes >= 8 bytes and gives <= 64 KiB)."""
    if buf.size < HEADER_SIZE:
        raise ValueError("hzr: input too small")
    total = int.from_bytes(buf[:HEADER_SIZE].tobytes(), "little")
    if -(-total // MAX_BLOCK_SIZE) > (buf.size - HEADER_SIZE) // (
            BLOCK_HEADER_SIZE + 1):
        raise ValueError("hzr: truncated stream")
    return total


def hzr_decode(data) -> bytes:
    """hzr_decode of one stream, block after block."""
    buf = _u8(data)
    total = _stream_size(buf)
    out = np.empty(max(total, 1), np.uint8)
    if _lib().rpt_hzr_decode(_p(buf), buf.size, _p(out), total, None):
        raise ValueError("hzr: corrupt or truncated stream")
    return out[:total].tobytes()


def hzr_decode_blocks(data) -> bytes:
    """hzr_decode of one stream, its blocks decoded in threads."""
    buf = _u8(data)
    total = _stream_size(buf)
    out = np.empty(max(total, 1), np.uint8)
    if _lib().rpt_hzr_decode_blocks_mt(_p(buf), buf.size, _p(out), total, 0):
        raise ValueError("hzr: corrupt or truncated stream")
    return out[:total].tobytes()


def decode_planes_blocks(src, nplanes: int, plane_len: int,
                         nthreads: int = 0) -> Tuple[np.ndarray, int]:
    """A container's plane section — nplanes times [u32 length][hzr
    stream of plane_len bytes] — decoded with every plane's blocks in
    threads. Returns ((nplanes, plane_len) uint8, bytes consumed)."""
    buf = _u8(src)
    planes = np.empty((nplanes, plane_len), np.uint8)
    consumed = ctypes.c_size_t(0)
    if _lib().rpt_decode_planes_blocks_mt(
            _p(buf), buf.size, nplanes, plane_len, _p(planes),
            ctypes.addressof(consumed), int(nthreads)):
        raise ValueError("hzr: corrupt or truncated plane streams")
    return planes, consumed.value


def verify(data) -> int:
    """hzr_verify: every block's stored CRC32C checked. Returns the
    decoded size; raises ValueError on a mismatch or a bad stream."""
    buf = _u8(data)
    size = ctypes.c_size_t(0)
    if _lib().rpt_hzr_verify(_p(buf), buf.size, ctypes.addressof(size)):
        raise ValueError("hzr: CRC32C mismatch or bad stream")
    return size.value


def lut_nib_batch(payloads) -> Tuple[List[tuple], np.ndarray]:
    """The device decoder's LUTs of HUFF block payloads, each tree
    recovered from the payload bits, in threads.

    Returns (luts, dbits): luts[i] = (l1 (256,) int32, levels, chunks)
    in build_lut_nib's layout (levels[k] the (nslots_k * 16,) int32
    slots of nibble level k, chunks[k] = ceil(nslots_k * 16 / 128));
    dbits[i] the tree description's bits. The work goes in batches of
    NIB_CHUNK blocks, so the slot scratch stays bounded. Raises
    ValueError on a bad tree or a code longer than 24 bits."""
    lib = _lib()
    nb = len(payloads)
    luts: List[tuple] = []
    dbits = np.zeros(nb, np.int32)
    for lo in range(0, nb, NIB_CHUNK):
        part = [_u8(p) for p in payloads[lo:lo + NIB_CHUNK]]
        m = len(part)
        lens = np.array([p.size for p in part], np.int64)
        offs = np.cumsum(lens) - lens
        buf = np.concatenate(part) if m else np.zeros(0, np.uint8)
        l1 = np.zeros((m, 256), np.int32)
        lv = np.zeros((m, NIB_LEVELS, NIB_CAP_SLOTS, 16), np.int32)
        nslots = np.zeros((m, NIB_LEVELS), np.int32)
        ok = np.zeros(m, np.int32)
        lib.rpt_declutnib_batch(_p(buf), _p(offs), _p(lens), m, _p(l1),
                                _p(lv), _p(nslots), _p(dbits[lo:]), _p(ok),
                                NIB_CAP_SLOTS, 0)
        if ok.any():
            raise ValueError("hzr: bad tree or a code longer than 24 bits")
        for i in range(m):
            levels = [lv[i, k, :nslots[i, k]].reshape(-1).copy()
                      for k in range(NIB_LEVELS)]
            luts.append((l1[i].copy(), levels,
                         [-(-lev.size // 128) for lev in levels]))
    return luts, dbits


def _iir_coefficients(n, d):
    """The feedback (n, n[0] = 1) and feedforward (d) vectors as float64,
    of one length p >= 1."""
    na = np.ascontiguousarray(n, np.float64).reshape(-1)
    da = np.ascontiguousarray(d, np.float64).reshape(-1)
    if na.size < 1 or na.size != da.size:
        raise ValueError("iir: n and d need one length >= 1")
    return na, da


def iir_filter_array(x, n, d, xz, yz, opt: int):
    """One channel's serial IIR over x in the reference's accumulation
    order (opt 1: filter_opt, 0: filter), state rings xz / yz of length p
    (index 0 the newest). Returns (y float64, (xz', yz') as lists)."""
    na, da = _iir_coefficients(n, d)
    p = na.size
    xa = np.ascontiguousarray(x, np.float64).reshape(-1)
    xza = np.array(xz, np.float64).reshape(-1)
    yza = np.array(yz, np.float64).reshape(-1)
    if xza.size != p or yza.size != p:
        raise ValueError(f"iir: state of {p} values expected")
    y = np.empty_like(xa)
    _lib().rpt_iir_filter_array(_p(xa), xa.size, _p(na), _p(da), p,
                                _p(xza), _p(yza), int(opt), _p(y))
    return y, (xza.tolist(), yza.tolist())


def iir_filter_channels(x, n, d, xz: np.ndarray, yz: np.ndarray, opt: int,
                        nthreads: int = 0) -> np.ndarray:
    """Every channel of x (ch, n) through its own serial IIR in one call,
    the channels in threads; each channel's bits equal iir_filter_array's.
    xz / yz: (ch, p) float64 state, updated in place. Returns y (ch, n)
    float64."""
    na, da = _iir_coefficients(n, d)
    p = na.size
    xa = np.ascontiguousarray(x, np.float64)
    if xa.ndim != 2:
        raise ValueError("iir: x must be (channels, samples)")
    ch, ns = xa.shape
    for st in (xz, yz):
        if (not isinstance(st, np.ndarray) or st.dtype != np.float64
                or st.shape != (ch, p) or not st.flags.c_contiguous):
            raise ValueError(f"iir: state must be C-contiguous float64 "
                             f"({ch}, {p})")
    y = np.empty_like(xa)
    _lib().rpt_iir_filter_channels(_p(xa), ch, ns, _p(na), _p(da), p,
                                   _p(xz), _p(yz), int(opt), _p(y),
                                   int(nthreads))
    return y


def _lz4_out(n: int) -> np.ndarray:
    return np.empty(int(_lib().rpt_lz4_max_compressed(n)), np.uint8)


def lz4_compress(data) -> bytes:
    """Greedy LZ4 block compress (the reference runtime's
    rspt_lz4_compress bytes)."""
    buf = _u8(data)
    out = _lz4_out(buf.size)
    n = _lib().rpt_lz4_compress(_p(buf), buf.size, _p(out), out.size)
    if n <= 0:
        raise ValueError("lz4 compress failed")
    return out[:n].tobytes()


def lz4_compress_hc(data, depth: int = 256) -> bytes:
    """LZ4HC-class block compress: hash chains searched depth entries
    deep and one-step lazy matching (the reference runtime's
    rspt_lz4_compress_hc bytes; depth <= 0 means 256)."""
    buf = _u8(data)
    out = _lz4_out(buf.size)
    n = _lib().rpt_lz4_compress_hc(_p(buf), buf.size, _p(out), out.size,
                                   int(depth))
    if n <= 0:
        raise ValueError("lz4 hc compress failed")
    return out[:n].tobytes()


def lz4_decompress(data, out_len: int) -> bytes:
    """Bounds-checked LZ4 block decompress of exactly out_len bytes;
    raises ValueError on malformed input or another size."""
    buf = _u8(data)
    out = np.empty(max(out_len, 1), np.uint8)
    n = _lib().rpt_lz4_decompress(_p(buf), buf.size, _p(out), out_len)
    if n != out_len:
        raise ValueError(f"lz4 decompress failed (rc={n})")
    return out[:out_len].tobytes()


def lz4_encode_planes(planes: np.ndarray, hc: bool = False) -> List[bytes]:
    """Each row of planes ((nplanes, plane_len) uint8) as an LZ4 block,
    the rows in threads: [lz4_compress(row)] or, with hc,
    [lz4_compress_hc(row)], byte for byte."""
    a = np.ascontiguousarray(planes, np.uint8)
    if a.ndim != 2:
        raise ValueError("lz4: planes must be (nplanes, plane_len)")
    nplanes, plane_len = a.shape
    cap = int(_lib().rpt_lz4_max_compressed(plane_len))
    out = np.empty((nplanes, cap), np.uint8)
    lens = np.zeros(nplanes, np.int64)
    if _lib().rpt_lz4_encode_planes(_p(a), nplanes, plane_len, int(hc),
                                    _p(out), _p(lens)):
        raise ValueError("lz4 compress failed")
    return [out[k, :lens[k]].tobytes() for k in range(nplanes)]


def lz4_decode_planes(src, nplanes: int, plane_len: int
                      ) -> Tuple[np.ndarray, int]:
    """A container's plane section — nplanes times [u32 length][LZ4
    block of plane_len bytes] — decoded with the planes in threads.
    Returns ((nplanes, plane_len) uint8, bytes consumed); raises
    ValueError on a truncated section or a malformed plane."""
    buf = _u8(src)
    planes = np.empty((nplanes, plane_len), np.uint8)
    consumed = ctypes.c_size_t(0)
    if _lib().rpt_lz4_decode_planes(_p(buf), buf.size, nplanes, plane_len,
                                    _p(planes), ctypes.addressof(consumed)):
        raise ValueError("lz4: corrupt or truncated plane streams")
    return planes, consumed.value


# -- the encode half (the all-host engine) ------------------------------------

def _i32(a) -> np.ndarray:
    """A contiguous int32 copy of a (the in-place runtime ops write it)."""
    return np.array(a, dtype=np.int32, order="C", copy=True)


def _check_bps(bps: int) -> None:
    if not 1 <= bps <= 4:
        raise ValueError(f"bytes_per_sample must be 1-4, not {bps}")


def _check_planes(nr_planes: int) -> None:
    if not 1 <= nr_planes <= 4:
        raise ValueError(f"planes must be 1-4, not {nr_planes}")


def threads() -> int:
    """The threads of a runtime call at nthreads = 0: one a hardware
    thread."""
    return int(_lib().rpt_threads())


def hzr_encode(data) -> bytes:
    """One hzr stream of data (hzr_encode; block after block, each FILL,
    HUFF or COPY as the reference chooses)."""
    buf = _u8(data)
    lib = _lib()
    out = np.empty(int(lib.rpt_hzr_max_size(buf.size)), np.uint8)
    size = ctypes.c_size_t(0)
    if lib.rpt_hzr_encode(_p(buf), buf.size, _p(out), out.size,
                          ctypes.addressof(size)):
        raise ValueError("hzr: encode failed")
    return out[:size.value].tobytes()


def delta_encode(a) -> np.ndarray:
    """a[i] - a[i - 1] (a[-1] = 0), int32 wrap."""
    out = _i32(a)
    _lib().rpt_delta_encode(_p(out), out.size)
    return out


def delta_decode(a) -> np.ndarray:
    """The running sum of a, int32 wrap."""
    out = _i32(a)
    _lib().rpt_delta_decode(_p(out), out.size)
    return out


def offset32(a, val: int) -> np.ndarray:
    out = _i32(a)
    _lib().rpt_offset32(_p(out), out.size, int(val))
    return out


def xor_encode(a) -> np.ndarray:
    """a[i] ^ a[i - 1] (a[-1] = 0)."""
    out = _i32(a)
    _lib().rpt_xor_encode(_p(out), out.size)
    return out


def xor_decode(a) -> np.ndarray:
    """The running xor of a."""
    out = _i32(a)
    _lib().rpt_xor_decode(_p(out), out.size)
    return out


def native_to_i32(native, nr_samples: int, nr_channels: int,
                  bytes_per_sample: int) -> np.ndarray:
    """Interleaved little-endian samples [s0c0][s0c1]... → (channels,
    samples) int32, sign-extended from bit 8 * bps - 1."""
    _check_bps(bytes_per_sample)
    buf = _u8(native)
    if buf.size < nr_samples * nr_channels * bytes_per_sample:
        raise ValueError(f"native: {buf.size} B for {nr_channels} x "
                         f"{nr_samples} samples of {bytes_per_sample} B")
    out = np.empty((nr_channels, nr_samples), np.int32)
    _lib().rpt_native_to_i32(_p(out), _p(buf), nr_samples, nr_channels,
                             bytes_per_sample)
    return out


def i32_to_native(arr, bytes_per_sample: int) -> bytes:
    """(channels, samples) int32 → interleaved native low bytes."""
    _check_bps(bytes_per_sample)
    a = np.ascontiguousarray(arr, np.int32)
    if a.ndim != 2:
        raise ValueError("i32_to_native: arr must be (channels, samples)")
    ch, n = a.shape
    out = np.empty(n * ch * bytes_per_sample, np.uint8)
    _lib().rpt_i32_to_native(_p(out), _p(a), n, ch, bytes_per_sample)
    return out.tobytes()


def plane_split(flat, nr_planes: int) -> np.ndarray:
    """(nr_planes, n) uint8: plane k holds byte k of every value."""
    _check_planes(nr_planes)
    a = np.ascontiguousarray(flat, np.int32).reshape(-1)
    out = np.empty((nr_planes, a.size), np.uint8)
    _lib().rpt_plane_split(_p(a), a.size, nr_planes, _p(out))
    return out


def plane_merge(planes) -> np.ndarray:
    """The inverse of plane_split, sign-extended from 8 * nr_planes
    bits."""
    pl = np.ascontiguousarray(planes, np.uint8)
    if pl.ndim != 2:
        raise ValueError("plane_merge: planes must be (nr_planes, n)")
    _check_planes(pl.shape[0])
    out = np.empty(pl.shape[1], np.int32)
    _lib().rpt_plane_merge(_p(pl), pl.shape[1], pl.shape[0], _p(out))
    return out


def _stream_capacity(n: int) -> int:
    """A plane chunk's room: [u32 length] and a stream of n bytes."""
    return 4 + int(_lib().rpt_hzr_max_size(n))


def encode_planes_blocks(planes, nthreads: int = 0) -> List[bytes]:
    """Each row of planes ((nplanes, plane_len) uint8) as an hzr stream,
    every 64 KiB block of every row in threads: [hzr_encode(row)], byte
    for byte."""
    a = np.ascontiguousarray(planes, np.uint8)
    if a.ndim != 2:
        raise ValueError("hzr: planes must be (nplanes, plane_len)")
    nplanes, plane_len = a.shape
    stride = _stream_capacity(plane_len)
    out = np.empty((nplanes, stride), np.uint8)
    lens = np.zeros(nplanes, np.uint64)
    if _lib().rpt_encode_planes_blocks_mt(_p(a), plane_len, nplanes,
                                          _p(out), stride, _p(lens),
                                          int(nthreads)):
        raise ValueError("hzr: plane encode failed")
    return [out[k, 4:4 + int(lens[k])].tobytes() for k in range(nplanes)]


def xdelta_preprocess(native, nr_samples: int, nr_channels: int,
                      bytes_per_sample: int, nr_planes: int,
                      nthreads: int = 0) -> Tuple[np.ndarray, bool]:
    """The xdelta packer's pass 1 on the native samples: their flat
    channel-major values through delta, offset -128 and xor, as
    nr_planes byte planes ((nr_planes, channels * samples) uint8), and
    whether those planes keep every sample (the port's growth rule)."""
    _check_bps(bytes_per_sample)
    _check_planes(nr_planes)
    buf = _u8(native)
    n = nr_samples * nr_channels
    if buf.size < n * bytes_per_sample:
        raise ValueError(f"native: {buf.size} B for {n} samples of "
                         f"{bytes_per_sample} B")
    planes = np.empty((nr_planes, n), np.uint8)
    fit = _lib().rpt_xdelta_preprocess_mt(_p(buf), nr_samples, nr_channels,
                                          bytes_per_sample, nr_planes,
                                          _p(planes), int(nthreads))
    if fit < 0:
        raise ValueError("xdelta: bad arguments")
    return planes, bool(fit)


def xdelta_postprocess(planes, nr_samples: int, nr_channels: int,
                       bytes_per_sample: int, nthreads: int = 0) -> bytes:
    """The inverse of xdelta_preprocess: the planes merged (sign-extended),
    xor decoded, offset +128, delta decoded, as native bytes."""
    _check_bps(bytes_per_sample)
    pl = np.ascontiguousarray(planes, np.uint8)
    if pl.ndim != 2 or pl.shape[1] != nr_samples * nr_channels:
        raise ValueError("xdelta: planes must be (nr_planes, channels * "
                         "samples)")
    _check_planes(pl.shape[0])
    out = np.empty(pl.shape[1] * bytes_per_sample, np.uint8)
    if _lib().rpt_xdelta_postprocess_mt(_p(pl), nr_samples, nr_channels,
                                        bytes_per_sample, pl.shape[0],
                                        _p(out), int(nthreads)):
        raise ValueError("xdelta: bad arguments")
    return out.tobytes()


def _dct_operands(x, table, cs):
    a = np.ascontiguousarray(x, np.int32)
    a = a.reshape(1, -1) if a.ndim == 1 else a
    ch, n = a.shape
    t = np.ascontiguousarray(table, np.float32)
    c = np.ascontiguousarray(cs, np.float32)
    if n < 1 or t.shape != (n, n) or c.shape != (n,):
        raise ValueError(f"dct: a ({n}, {n}) table and {n} factors needed "
                         f"for rows of {n}")
    return a, t, c, ch, n


def dct_forward(src, cos_table, cs, quality: float,
                nthreads: int = 0) -> np.ndarray:
    """The reference's DCT-II with its quantization of each row of src
    ((channels, n) int32): output i the serial f64 sum over x of the
    float products src[x] * COS[x][i], times cs[i] * sqrt(2 / n) /
    quality, converted as x86 does (INT32_MIN out of range). cos_table is
    ops.torch_ops.dct_cos_table(n)."""
    a, t, c, ch, n = _dct_operands(src, cos_table, cs)
    out = np.empty((ch, n), np.int32)
    if _lib().rpt_dct_forward_mt(_p(a), _p(out), _p(t), _p(c), ch, n,
                                 float(quality), int(nthreads)):
        raise ValueError("dct: bad arguments")
    return out


def dct_inverse(coef, cos_table_t, cs, quality: float,
                nthreads: int = 0) -> np.ndarray:
    """The reference's inverse of each row of coef ((channels, n) int32):
    output i the serial f64 sum over x of the float products
    (cs[x] * coef[x]) * COS[i][x], times sqrt(2 / n) * quality, converted
    as x86 does. cos_table_t is the forward table transposed."""
    a, t, c, ch, n = _dct_operands(coef, cos_table_t, cs)
    out = np.empty((ch, n), np.int32)
    if _lib().rpt_dct_inverse_mt(_p(a), _p(out), _p(t), _p(c), ch, n,
                                 float(quality), int(nthreads)):
        raise ValueError("dct: bad arguments")
    return out


def fwht(src, nthreads: int = 0) -> np.ndarray:
    """The Walsh-Hadamard transform of each row of src ((rows, n) int32,
    n = 2^k; a 1-D array is one row), int32 wraparound butterflies in the
    reference's order; same shape out."""
    a = np.ascontiguousarray(src, np.int32)
    rows = a.reshape(-1, a.shape[-1])
    out = np.empty_like(rows)
    if _lib().rpt_fwht(_p(rows), _p(out), rows.shape[0], rows.shape[1],
                       int(nthreads)):
        raise ValueError("fwht: rows of 2^k values needed")
    return out.reshape(a.shape)


def fwht_normalize(a, n: int, ratio: float) -> np.ndarray:
    """The encode quantization (int)(a / (n / ratio)), as x86 converts."""
    out = _i32(a)
    _lib().rpt_fwht_normalize(_p(out), out.size, int(n), float(ratio))
    return out


def fwht_normalize2(a, ratio: float) -> np.ndarray:
    """The decode's (int)(a / ratio), as x86 converts."""
    out = _i32(a)
    _lib().rpt_fwht_normalize2(_p(out), out.size, float(ratio))
    return out


def stream_filter_pack(span, nr_samples: int, nframes: int, nr_channels: int,
                       bytes_per_sample: int, n, d, xz, yz, opt: int,
                       nr_planes: int, nthreads: int = 0
                       ) -> Tuple[List[bytes], int]:
    """A streaming span (nframes blocks of nr_samples interleaved native
    samples) → each block's xdelta_hzr container, in one call: every
    channel through its serial IIR (n feedback, d feedforward, opt as in
    iir_filter_array; state xz / yz (channels, p) float64, updated in
    place; n None: no filter), each output converted as x86 does and kept
    as its low bytes_per_sample bytes, then each frame's xdelta planes
    from nr_planes up, growing as sequential compress calls on one packer
    grow, and their hzr streams. Returns (frames, the final plane
    count)."""
    _check_bps(bytes_per_sample)
    _check_planes(nr_planes)
    buf = _u8(span)
    f = nr_samples * nr_channels
    if nr_samples < 1 or nframes < 1 or nr_channels < 1 or \
            buf.size < nframes * f * bytes_per_sample:
        raise ValueError("stream: the span holds no whole frame")
    if n is None:
        p = 0
        na = da = np.zeros(1, np.float64)
        xz = yz = np.zeros((nr_channels, 1), np.float64)
    else:
        na, da = _iir_coefficients(n, d)
        p = na.size
        for st in (xz, yz):
            if (not isinstance(st, np.ndarray) or st.dtype != np.float64
                    or st.shape != (nr_channels, p)
                    or not st.flags.c_contiguous):
                raise ValueError(f"iir: state must be C-contiguous float64 "
                                 f"({nr_channels}, {p})")
    stride = 1 + 4 * _stream_capacity(f)
    out = np.empty((nframes, stride), np.uint8)
    lens = np.zeros(nframes, np.uint64)
    planes = np.zeros(nframes, np.int32)
    rc = _lib().rpt_stream_filter_pack(
        _p(buf), nr_samples, nframes, nr_channels, bytes_per_sample, _p(na),
        _p(da), p, _p(xz), _p(yz), int(opt), nr_planes, _p(out), stride,
        _p(lens), _p(planes), int(nthreads))
    if rc < 0:
        raise ValueError("stream: span pack failed")
    return [out[k, :int(lens[k])].tobytes() for k in range(nframes)], rc
