"""The port's host runtime (rspt_tpu_torch/native) against the port's
plain Python versions and the reference's own runtime
(rspt_tpu.native.bindings), on the CPU at small sizes.

Every output is integers or bytes: every comparison is exact (tolerance
0). Streams come from torch_coder.encode(..., device="cpu").
"""

import platform

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from conftest import to_native  # noqa: E402
from rspt_tpu.hzr import pyref as jref  # noqa: E402
from rspt_tpu.native import bindings as ref_native  # noqa: E402
from rspt_tpu_torch import packers  # noqa: E402
from rspt_tpu_torch.formats.crc32c import crc32c, crc32c_plain  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import pyref, walk  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.native import bindings as native  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.ops import torch_ops as tops  # noqa: E402
from test_torch_cuda import (DCT_EDGE_CASES, dct_edge_batch,  # noqa: E402
                             dct_tables)

B = 65536


# -- CRC32C -------------------------------------------------------------------

# around the 3 x 2,048 B legs of the hardware loop and their recombination
LEG_LENGTHS = [6140, 6143, 6144, 6145, 6151, 12287, 12288, 12289, 18431,
               18432, 18440]
CRC_LENGTHS = {
    "random": [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 63, 64, 65, 100, 1000, 2047,
               2048, 2049, 4095, 4096, 8191, 10000, 20000],
    "zeros": [0, 1, 8, 9, 6144, 6145, 20000],
    "legs": LEG_LENGTHS,
}


@pytest.mark.parametrize("kind", sorted(CRC_LENGTHS))
def test_crc32c_matches_plain_and_reference(kind):
    """crc32c == crc32c_plain == the software loop alone == the
    reference runtime's, from 0 to 20,000 B."""
    rng = np.random.default_rng(len(kind))
    for n in CRC_LENGTHS[kind]:
        a = (np.zeros(n, np.uint8) if kind == "zeros"
             else rng.integers(0, 256, n).astype(np.uint8))
        want = crc32c_plain(a)
        assert crc32c(a) == want == native.crc32c_sw(a), n
        assert crc32c(a.tobytes()) == ref_native.crc32c(a) == want, n


def test_crc32c_chained():
    """crc32c(b, crc32c(a)) equals one call over a + b, cut anywhere
    around the leg lengths, on the runtime, its software loop and the
    plain version."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 20000).astype(np.uint8)
    whole = crc32c(a)
    for cut in [0, 1, 7, 8, 2048, 6143, 6144, 6145, 13001, 19999, 20000]:
        head, tail = a[:cut], a[cut:]
        assert crc32c(tail, crc32c(head)) == whole, cut
        assert native.crc32c_sw(tail, native.crc32c_sw(head)) == whole, cut
    assert crc32c_plain(a[9:], crc32c_plain(a[:9])) == whole
    parts = np.array_split(a, 7)
    c = 0
    for p in parts:
        c = crc32c(p, c)
    assert c == whole


def test_crc32c_hardware_matches_software():
    """The CPU's CRC32C instruction (three interleaved legs) gives the
    software loop's CRC on random lengths; x86-64 has the instruction."""
    if platform.machine() in ("x86_64", "AMD64"):
        assert native.crc32c_hw_ok()
    rng = np.random.default_rng(5)
    for n in list(rng.integers(0, 70000, 40)) + LEG_LENGTHS:
        a = rng.integers(0, 256, int(n)).astype(np.uint8)
        seed = int(rng.integers(0, 2 ** 32))
        assert crc32c(a, seed) == native.crc32c_sw(a, seed), n


# -- Huffman tables ---------------------------------------------------------

def _fib_hist(nsym):
    fib = [1, 1]
    while len(fib) < nsym:
        fib.append(fib[-1] + fib[-2])
    h = np.zeros(tc.NUM_SYMBOLS, np.int64)
    h[1:nsym + 1] = fib[:nsym]
    return h


def _table_case(name):
    rng = np.random.default_rng(17)
    if name == "random":
        h = rng.integers(0, 3000, (12, tc.NUM_SYMBOLS))
        h[:, rng.random(tc.NUM_SYMBOLS) < 0.4] = 0
        h[3] = rng.geometric(0.05, tc.NUM_SYMBOLS)
        return h, np.full(12, B)
    if name == "single_and_empty":
        h = np.zeros((5, tc.NUM_SYMBOLS), np.int64)
        h[0, 7] = 100                   # one literal: FILL
        h[1, 0], h[1, 260] = 5, 2       # zeros only: FILL
        h[2, 7], h[2, 9] = 4, 4         # two symbols
        h[3] = 0                        # an empty block
        h[4, 1:256] = 1                 # every literal once
        return h, np.array([B, B, 8, 0, 255])
    if name == "ties":
        h = np.zeros((4, tc.NUM_SYMBOLS), np.int64)
        h[0] = 1                        # every weight ties
        h[1, ::3] = 7
        h[2, :40] = np.repeat([5, 3, 5, 2, 3], 8)
        h[3, 100:110] = 1
        h[3, 256:261] = 1
        return h, np.full(4, B)
    # Fibonacci weights: 24 symbols give 23-bit codes, the most allowed
    h = np.stack([_fib_hist(24), _fib_hist(20), _fib_hist(23)])
    return h, np.full(3, B)


@pytest.mark.parametrize("name", ["random", "single_and_empty", "ties",
                                  "fibonacci_23"])
def test_build_tables_matches_plain(name):
    """host_tables (the runtime) == host_tables_plain (pyref's tree, one
    block at a time) == the reference runtime's build_tables."""
    hist, lengths = _table_case(name)
    got = tc.host_tables(hist, lengths)
    want = tc.host_tables_plain(hist, lengths)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ref = ref_native.build_tables(hist, tc.DESC_STRIDE)
    live = lengths > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[live], r[live])
    if name == "fibonacci_23":
        assert int(got[1].max()) == 23
    if name == "single_and_empty":
        assert got[4].tolist() == [True, True, False, True, False]


def test_build_tables_rejects_24_bit_codes():
    """25 Fibonacci weights need a 24-bit code: both versions raise."""
    hist = np.stack([_fib_hist(25)])
    lengths = np.array([B])
    with pytest.raises(ValueError, match="code length"):
        tc.host_tables(hist, lengths)
    with pytest.raises(ValueError, match="code length"):
        tc.host_tables_plain(hist, lengths)


# -- decoders -----------------------------------------------------------------

def _mixed_data(seed):
    """Blocks that encode as COPY (random), FILL (one byte, zeros), HUFF
    (low entropy, sparse) and a short HUFF tail."""
    rng = np.random.default_rng(seed)
    sparse = np.zeros(B, np.uint8)
    idx = rng.choice(B, 3000, replace=False)
    sparse[idx] = rng.integers(1, 255, idx.size)
    return np.concatenate([
        rng.integers(0, 256, B).astype(np.uint8),
        np.full(B, 9, np.uint8),
        rng.integers(0, 6, B).astype(np.uint8),
        np.zeros(B, np.uint8),
        sparse,
        rng.integers(0, 30, 1234).astype(np.uint8)])


@pytest.fixture(scope="module")
def streams():
    datas = [_mixed_data(1), np.zeros(0, np.uint8), np.full(5, 3, np.uint8),
             np.random.default_rng(2).integers(0, 4, 777).astype(np.uint8)]
    return [(d.tobytes(), tc.encode(d, device="cpu")) for d in datas]


def test_stream_modes_cover_copy_fill_huff(streams):
    modes = set()
    for _, s in streams:
        pos, left = 4, int.from_bytes(s[:4], "little")
        while left > 0:
            esz = int.from_bytes(s[pos:pos + 2], "little") + 1
            mode = s[pos + 6]
            modes.add(mode)
            pos += 7 + (1 if mode == 2 else esz)
            left -= min(left, B)
    assert modes == {0, 1, 2}


def test_decode_matches_pyref(streams):
    """hzr_decode_blocks (threads) and hzr_decode (serial) == pyref.decode
    == the data == the reference runtime's block decoder."""
    for data, s in streams:
        assert pyref.decode(s) == data
        assert native.hzr_decode_blocks(s) == data
        assert native.hzr_decode(s) == data
        assert ref_native.hzr_decode_blocks_mt(s) == data


def _section(streams_):
    return b"".join(len(s).to_bytes(4, "little") + s for s in streams_)


def test_decode_planes_blocks_matches_pyref():
    """decode_planes_blocks on a plane section == pyref.decode of each
    plane, with the bytes consumed; also on a container whose planes
    grew from 1 (xdelta growth) and one that started at 3."""
    rng = np.random.default_rng(8)
    n = 3 * B + 500
    planes = [_mixed_data(4)[:n], rng.integers(0, 3, n).astype(np.uint8),
              np.zeros(n, np.uint8)]
    ss = [tc.encode(p, device="cpu") for p in planes]
    sec = _section(ss)
    got, used = native.decode_planes_blocks(sec + b"tail", 3, n)
    assert used == len(sec)
    for k in range(3):
        assert got[k].tobytes() == pyref.decode(ss[k]) == planes[k].tobytes()
    sig = np.cumsum(rng.normal(0, 3000, (2, 3000)), axis=1).astype(np.int32)
    nat = np.ascontiguousarray(sig.T).astype("<i4").tobytes()
    for start in (1, 3):
        p = packers.new_xdelta_hzr(4, 2, 3000, start, device="cpu")
        comp = p.compress(nat)
        assert p.nr_planes == 3
        header, streams_, pos = p._streams(comp, p.nr_planes, 0)
        got, used = native.decode_planes_blocks(
            np.frombuffer(comp, np.uint8)[1:], p.nr_planes, 6000)
        assert used + 1 == pos == len(comp)
        for k, s in enumerate(streams_):
            assert got[k].tobytes() == pyref.decode(s, 6000)
        assert p.decompress(comp) == (nat, len(comp))


def _bad_inputs(s):
    """Corruptions of a stream whose first block is COPY, that pyref
    rejects: cuts, an invalid mode, a COPY size that is not the block's,
    a claimed size past what the bytes hold."""
    out = {f"cut{k}": s[:k] for k in (0, 3, 4, 9, len(s) // 2, len(s) - 1)}
    bad_mode = bytearray(s)
    bad_mode[4 + 6] = 3
    out["mode"] = bytes(bad_mode)
    bad_size = bytearray(s)
    bad_size[4:6] = (100).to_bytes(2, "little")
    out["copy_size"] = bytes(bad_size)
    out["huge"] = (2 ** 32 - 1).to_bytes(4, "little") + s[4:]
    return out


def test_decoders_reject_bad_input(streams):
    """Every corruption raises ValueError in pyref.decode and in both
    runtime decoders; a plane section raises on a bad plane, a plane of
    another size, and a cut length prefix."""
    data, s = streams[0]
    assert s[4 + 6] == 0
    for name, bad in _bad_inputs(s).items():
        for dec in (pyref.decode, native.hzr_decode_blocks,
                    native.hzr_decode):
            with pytest.raises(ValueError):
                dec(bad)
        with pytest.raises(ValueError):
            native.decode_planes_blocks(_section([s, bad]), 2, len(data))
    small = tc.encode(data[:100], device="cpu")
    for sec, nplanes in ((_section([s, small]), 2), (_section([s])[:-1], 1),
                         (_section([s])[:3], 1), (_section([s]), 2)):
        with pytest.raises(ValueError):
            native.decode_planes_blocks(sec, nplanes, len(data))


@pytest.mark.parametrize("case", ["good", "bad_crc"])
def test_verify_matches_reference(streams, case):
    """pyref.verify (the port's copy), the runtime's verify and the
    reference's pyref.verify agree: the decoded size on good streams,
    ValueError where a stored CRC32C was changed; decoded_size too."""
    for data, s in streams:
        assert pyref.decoded_size(s) == jref.decoded_size(s) == len(data)
        if case == "good":
            assert native.verify(s) == pyref.verify(s) == jref.verify(s) \
                == len(data)
            continue
        if len(data) == 0:
            continue
        pos, left = 4, len(data)
        for _ in range(4):          # every block up to the fourth
            bad = bytearray(s)
            bad[pos + 2] ^= 0x10
            for fn in (native.verify, pyref.verify, jref.verify):
                with pytest.raises(ValueError):
                    fn(bytes(bad))
            esz = int.from_bytes(s[pos:pos + 2], "little") + 1
            pos += 7 + (1 if s[pos + 6] == 2 else esz)
            left -= min(left, B)
            if left <= 0:
                break


# -- the device decoder's LUTs ----------------------------------------------

def _fib_bytes(nsym, seed=13):
    fib = [1, 1]
    while len(fib) < nsym:
        fib.append(fib[-1] + fib[-2])
    x = np.repeat(np.arange(1, nsym + 1, dtype=np.uint8), fib[:nsym])
    np.random.default_rng(seed).shuffle(x)
    return x


def _lut_streams(name):
    rng = np.random.default_rng(21)
    if name == "mixed":
        return [tc.encode(_mixed_data(6), device="cpu")]
    if name == "deep":
        return [tc.encode(np.minimum(rng.geometric(0.5, 9000), 255)
                          .astype(np.uint8), device="cpu"),
                tc.encode(_fib_bytes(22), device="cpu"),
                tc.encode(_fib_bytes(18), device="cpu")]
    return [tc.encode(rng.integers(0, k, 300 + 37 * k).astype(np.uint8),
                      device="cpu") for k in range(2, 40)]


@pytest.mark.parametrize("name", ["mixed", "deep", "many"])
def test_lut_nib_batch_matches_plain(name, monkeypatch):
    """lut_nib_batch == build_lut_nib(pyref._recover_tree(...)) with its
    description bits == br.pos, for every HUFF block (the reference
    runtime's declutnib_batch too); the light walk queues the same
    blocks as the plain one. "many": 38 blocks in batches of 5."""
    if name == "many":
        monkeypatch.setattr(native, "NIB_CHUNK", 5)
    ss = _lut_streams(name)
    huff, light = [], []
    for s in ss:
        src = np.frombuffer(s, np.uint8)
        size = int.from_bytes(s[:4], "little")
        out_a, out_b = np.zeros(size, np.uint8), np.zeros(size, np.uint8)
        walk.walk_stream(src, size, 0, out_a, huff)
        walk.walk_stream(src, size, 0, out_b, light, light=True)
        np.testing.assert_array_equal(out_a, out_b)
    assert len(huff) == len(light) > 0
    luts, dbits = native.lut_nib_batch([h[0] for h in light])
    rl1, rlv, rns, rdb, rok = ref_native.declutnib_batch([h[0] for h in huff])
    assert not rok.any()
    deepest = 0
    for i, (h, lh) in enumerate(zip(huff, light)):
        assert lh[2] == -1 and lh[5] is None
        np.testing.assert_array_equal(lh[0], h[0])
        assert lh[1:2] + lh[3:5] + lh[6:] == h[1:2] + h[3:5] + h[6:]
        l1, levels, chunks = gd.build_lut_nib(h[5])
        assert int(dbits[i]) == h[2] == int(rdb[i])
        np.testing.assert_array_equal(luts[i][0], l1)
        np.testing.assert_array_equal(rl1[i], l1)
        for k in range(gd.NIB_LEVELS):
            assert luts[i][1][k].dtype == np.int32
            np.testing.assert_array_equal(luts[i][1][k], levels[k])
            np.testing.assert_array_equal(
                rlv[i, k, :rns[i, k]].reshape(-1), levels[k])
        assert luts[i][2] == chunks
        deepest = max(deepest, sum(1 for c in chunks if c))
    if name == "deep":
        assert deepest == 4
    if name == "many":
        assert len(light) > 3 * native.NIB_CHUNK


def test_lut_nib_batch_rejects_a_bad_tree():
    """A payload whose tree description runs out raises ValueError, as
    pyref._recover_tree does; the device decoder raises too."""
    s = tc.encode(np.random.default_rng(2).integers(0, 9, 5000)
                  .astype(np.uint8), device="cpu")
    huff = []
    walk.walk_stream(np.frombuffer(s, np.uint8), 5000, 0,
                     np.zeros(5000, np.uint8), huff, light=True)
    cut = huff[0][0][:3]
    with pytest.raises(ValueError):
        pyref._recover_tree(pyref._BitReader(memoryview(cut.tobytes()), 0, 3))
    with pytest.raises(ValueError):
        native.lut_nib_batch([huff[0][0], cut])
    # the stream with its HUFF payload cut to those 3 bytes
    bad = s[:4] + (2).to_bytes(2, "little") + s[6:11] + s[11:14]
    with pytest.raises(ValueError):
        gd.decode_many([bad], device="cpu")


def test_lut_nib_batch_from_many_threads():
    """Callers in more Python threads than cores share the runtime's
    thread pool (ctypes drops the GIL): every result stays its own."""
    import sys
    import threading
    rng = np.random.default_rng(9)
    sets = []
    for k in range(12):
        s = tc.encode(rng.integers(0, 3 + 5 * k, 70000).astype(np.uint8),
                      device="cpu")
        huff = []
        walk.walk_stream(np.frombuffer(s, np.uint8), 70000, 0,
                         np.zeros(70000, np.uint8), huff, light=True)
        payloads = [h[0] for h in huff]
        sets.append((payloads, native.lut_nib_batch(payloads)))
    bad = []

    def worker(k):
        payloads, (want, want_dbits) = sets[k]
        for _ in range(100):
            got, dbits = native.lut_nib_batch(payloads)
            if not (np.array_equal(dbits, want_dbits) and all(
                    np.array_equal(g[0], w[0]) for g, w in zip(got, want))):
                bad.append(k)
                return

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


# -- the encode half (the all-host engine) -------------------------------------

def _encode_case(name):
    rng = np.random.default_rng(23)
    if name == "empty":
        return b""
    if name == "one_byte":
        return b"\x07"
    if name.startswith("random_"):
        return rng.integers(0, 256, int(name[7:])).astype(np.uint8).tobytes()
    if name == "zeros":
        return bytes(3 * B + 11)
    if name == "periodic":
        return bytes(range(7)) * 40000
    if name == "sparse":     # runs of every length class, literals between
        a = rng.integers(1, 9, 2 * B + 99).astype(np.uint8)
        a[rng.random(a.size) < 0.6] = 0
        a[5000:25000] = 0
        return a.tobytes()
    assert name == "single_literal"
    return bytes([9]) * (B + 5)


ENCODE_CASES = ["empty", "one_byte", "random_65535", "random_65536",
                "random_65537", "zeros", "periodic", "sparse",
                "single_literal"]


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_hzr_encode_matches_reference_and_torch_coder(name):
    """hzr_encode (FILL for one code class, HUFF, the COPY fallback, the
    empty stream) gives the reference runtime's stream and
    torch_coder.encode's on the CPU, byte for byte; encode_planes_blocks
    gives each row's stream, at 1 and 4 threads."""
    data = _encode_case(name)
    got = native.hzr_encode(data)
    assert got == ref_native.hzr_encode(data)
    assert got == tc.encode(data, device="cpu")
    assert pyref.decode(got) == data
    if data:
        rows = np.frombuffer(data[:len(data) // 2 * 2], np.uint8).reshape(
            2, -1)
        want = [native.hzr_encode(r) for r in rows]
        for nt in (1, 4):
            assert native.encode_planes_blocks(rows, nt) == want


def test_elementwise_ops_match_reference_and_torch_ops():
    """The scans, the swizzles and the byte planes equal the reference
    runtime's and the port's torch ops on int32 extremes and random
    values, at bps 1-4 and 1-4 planes."""
    rng = np.random.default_rng(31)
    x = rng.integers(-2 ** 31, 2 ** 31, 3 * 997, dtype=np.int64).astype(
        np.int32)
    x[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
    t = torch.from_numpy(x)
    ops = {"delta_encode": tops.delta_encode, "xor_encode": tops.xor_encode,
           "xor_decode": tops.xor_decode}
    for name, op in ops.items():
        got = getattr(native, name)(x)
        np.testing.assert_array_equal(got, getattr(ref_native, name)(x))
        np.testing.assert_array_equal(got, op(t).numpy())
    np.testing.assert_array_equal(native.delta_decode(x),
                                  tops.delta_decode(t).numpy())
    np.testing.assert_array_equal(native.delta_decode(x),
                                  ref_native.delta_decode(x, 0))
    for v in (-128, 128):
        np.testing.assert_array_equal(native.offset32(x, v),
                                      tops.offset32(t, v).numpy())
    for bps in (1, 2, 3, 4):
        nat = rng.integers(0, 256, 3 * 997 * bps).astype(np.uint8)
        sig = native.native_to_i32(nat, 997, 3, bps)
        np.testing.assert_array_equal(
            sig, ref_native.native_to_i32(nat, 997, 3, bps))
        np.testing.assert_array_equal(sig, tops.native_to_i32(
            torch.from_numpy(nat), 997, 3, bps).numpy())
        assert native.i32_to_native(x.reshape(3, 997), bps) == \
            ref_native.i32_to_native(x.reshape(3, 997), bps)
        assert native.i32_to_native(sig, bps) == nat.tobytes()
    for p in (1, 2, 3, 4):
        planes = native.plane_split(x, p)
        np.testing.assert_array_equal(planes, ref_native.plane_split(x, p))
        np.testing.assert_array_equal(planes, tops.plane_split(t, p).numpy())
        np.testing.assert_array_equal(native.plane_merge(planes),
                                      tops.plane_merge(torch.from_numpy(
                                          planes)).numpy())


def _xdelta_input(rng, bps, kind):
    n = 3 * 700
    if kind == "quiet":
        sig = np.cumsum(rng.integers(-2, 3, n), dtype=np.int64)
    elif kind == "wrap":            # a ramp through the bps range and round
        sig = np.arange(n, dtype=np.int64) * (2 ** (8 * bps) // 600 + 1)
    else:
        sig = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
    return np.frombuffer(to_native(sig.astype(np.int32).reshape(3, 700),
                                   bps), np.uint8)


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_xdelta_preprocess_matches_plain(bps):
    """xdelta_preprocess gives the planes and the growth flag of the card
    packer's pass 1 (ck.xdelta_swizzle_plain: the flag is _fits_planes,
    the port's rule) at 1-4 planes, at 1 and 4 threads, on quiet, wrapping
    and full-range samples; xdelta_postprocess gives the samples back
    from any count that fits, and equals the reference runtime's
    postprocess."""
    rng = np.random.default_rng(bps)
    for kind in ("quiet", "wrap", "full"):
        nat = _xdelta_input(rng, bps, kind)
        for p in (1, 2, 3, 4):
            enc, ok = ck.xdelta_swizzle_plain(torch.from_numpy(nat.copy()),
                                              700, 3, p, bps, True)
            want = tops.plane_split(enc, p).numpy()
            for nt in (1, 4):
                planes, fits = native.xdelta_preprocess(nat, 700, 3, bps, p,
                                                        nt)
                np.testing.assert_array_equal(planes, want)
                assert fits == bool(ok.item()), (kind, p)
            if fits:
                back = native.xdelta_postprocess(planes, 700, 3, bps, 3)
                assert back == nat.tobytes(), (kind, p)
                assert back == ref_native.xdelta_postprocess_mt(
                    planes, 700, 3, bps, 3)


@pytest.mark.parametrize("case", DCT_EDGE_CASES)
def test_dct_matches_plain_and_reference(case):
    """dct_forward and dct_inverse (tiles of outputs in threads) equal the
    card kernels' plain versions and the reference runtime's serial
    kernels on the card tests' dct_edge_batch, out-of-range sums
    (INT32_MIN, x86's conversion) included, at 1 and 4 threads."""
    x = dct_edge_batch(np.random.default_rng(14), case)
    n = x.shape[1]
    cos, cos_t, cs, fwd, inv = dct_tables(n, torch.device("cpu"))
    t = torch.from_numpy(x)
    want_f = ck.dct_forward_plain(t, cos, fwd).numpy()
    want_i = ck.dct_inverse_plain(t, cos_t, cs, inv).numpy()
    for nt in (1, 4):
        got_f = native.dct_forward(x, cos.numpy(), cs.numpy(), 128.0, nt)
        got_i = native.dct_inverse(x, cos_t.numpy(), cs.numpy(), 128.0, nt)
        np.testing.assert_array_equal(got_f, want_f)
        np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_f[:1], ref_native.dct_forward_mt(
        x[:1], cos.numpy(), cs.numpy(), 128.0))
    np.testing.assert_array_equal(got_i[:1], ref_native.dct_inverse_mt(
        x[:1], cos_t.numpy(), cs.numpy(), 128.0))


def test_fwht_matches_plain_and_reference():
    """fwht of rows at n = 1, 2, 64 and 2^14 (int32 extremes among the
    values) equals ck.fwht_plain and the reference runtime's rn_fwht row
    by row; fwht_normalize and fwht_normalize2 equal the reference's,
    INT32_MIN included."""
    rng = np.random.default_rng(44)
    for n in (1, 2, 64, 1 << 14):
        x = rng.integers(-2 ** 31, 2 ** 31, (3, n), dtype=np.int64).astype(
            np.int32)
        x[0, 0] = -2 ** 31
        for nt in (1, 4):
            got = native.fwht(x, nt)
            np.testing.assert_array_equal(got, ck.fwht_plain(
                torch.from_numpy(x)).numpy())
        for row, g in zip(x, got):
            np.testing.assert_array_equal(g, ref_native.fwht(row))
        np.testing.assert_array_equal(
            native.fwht_normalize(got, n, 1.0),
            np.stack([ref_native.fwht_normalize(r, n, 1.0) for r in got]))
        np.testing.assert_array_equal(native.fwht_normalize2(got, 1.0), got)
    assert native.fwht_normalize([-2 ** 31, 5, -5], 4, 1.0).tolist() == [
        -2 ** 29, 1, -1]


def test_encode_half_rejects_bad_arguments():
    """Bad sizes, sample widths, plane counts and shapes raise ValueError
    before the runtime is called."""
    with pytest.raises(ValueError):
        native.native_to_i32(bytes(11), 4, 3, 1)
    with pytest.raises(ValueError):
        native.native_to_i32(bytes(12), 4, 3, 5)
    with pytest.raises(ValueError):
        native.xdelta_preprocess(bytes(12), 4, 3, 1, 0)
    with pytest.raises(ValueError):
        native.xdelta_preprocess(bytes(11), 4, 3, 1, 1)
    with pytest.raises(ValueError):
        native.xdelta_postprocess(np.zeros((2, 11), np.uint8), 4, 3, 1)
    with pytest.raises(ValueError):
        native.plane_split(np.zeros(4, np.int32), 5)
    with pytest.raises(ValueError, match="2\\^k"):
        native.fwht(np.zeros((2, 6), np.int32))
    with pytest.raises(ValueError, match="dct"):
        native.dct_forward(np.zeros((2, 6), np.int32),
                           np.zeros((5, 5), np.float32),
                           np.zeros(6, np.float32), 128.0)
    with pytest.raises(ValueError, match="whole frame"):
        native.stream_filter_pack(bytes(11), 4, 1, 3, 1, None, None, None,
                                  None, 1, 1)
    with pytest.raises(ValueError, match="state"):
        native.stream_filter_pack(bytes(12), 4, 1, 3, 1, [1.0, 0.5],
                                  [0.5, 0.5], np.zeros((3, 1)),
                                  np.zeros((3, 2)), 1, 1)
