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

from rspt_tpu.hzr import pyref as jref  # noqa: E402
from rspt_tpu.native import bindings as ref_native  # noqa: E402
from rspt_tpu_torch import packers  # noqa: E402
from rspt_tpu_torch.formats.crc32c import crc32c, crc32c_plain  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import pyref, walk  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.native import bindings as native  # noqa: E402

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
