"""The port's device hzr decoder (rspt_tpu_torch.hzr.gpu_decoder) on the
CPU, where its two kernels run as their plain PyTorch versions, against
rspt_tpu.hzr.pallas_decoder with its Pallas kernels in interpret mode
and against rspt_tpu.hzr.pyref.

Decoded bytes, LUTs, lane arrays, counts, converged entries and literal
emissions are integers: every comparison is exact (tolerance 0). The
JAX kernel counts its steps in fours (4x unrolled loop), so step counts
are compared up to that and emissions below each side's own count.
Streams stay a few KB: the interpret-mode decoder is slow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.hzr import jax_decoder  # noqa: E402
from rspt_tpu.hzr import pallas_decoder as pd  # noqa: E402
from rspt_tpu.hzr import pyref as jref  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import walk  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import decode_batch, rank_edge_payloads  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- fixtures: payload sets, each made from its own seed ---------------------

def _ecg_planes(rng, n):
    t = np.arange(n)
    x = (np.cumsum(rng.normal(0, 3, n)) + 40 * np.sin(t / 37.0) ** 63)
    x = x.astype(np.int32)
    return [(x & 255).astype(np.uint8), ((x >> 8) & 255).astype(np.uint8)]


def _padding_pair():
    """test_padding_bit_speculation_regression's pair: bogus symbols
    from a block's padding bits must not leak into the next stream."""
    r = np.random.default_rng(4)
    a = r.integers(0, 8, 900).astype(np.uint8)
    b = np.zeros(600, np.uint8)
    b[::53] = r.integers(1, 255, b[::53].size)
    return [a, b]


def _payloads(name):
    rng = np.random.default_rng(
        {"mix": 5, "fused": 6, "tier2": 7}[name])
    if name == "mix":
        sparse = np.zeros(8000, np.uint8)
        idx = rng.choice(8000, 60, replace=False)
        sparse[idx] = rng.integers(1, 255, 60)
        deep = np.random.default_rng(11).normal(0, 30, 3000)
        skewed = np.where(rng.random(6000) < 0.9, 1,
                          rng.integers(2, 6, 6000))
        return (_ecg_planes(rng, 6000)
                + [rng.integers(0, 256, 3000).astype(np.uint8),   # COPY
                   np.full(2000, 9, np.uint8),                     # FILL
                   sparse,                                         # high plane
                   deep.astype(np.int32).astype(np.uint8),
                   _fibonacci(18),                                 # level 3
                   skewed.astype(np.uint8)]                        # s_eff > 128
                + _padding_pair())
    if name == "fused":   # short codes only: at most 128 steps a lane
        return _ecg_planes(rng, 4000)[:1] + _padding_pair()
    # tier2: a dense block, a sparse one whose 128-literal chunks span
    # more than the 254-word pack windows, a super-sparse one
    sparse = np.zeros(65536, np.uint8)
    idx = rng.choice(sparse.size, 400, replace=False)
    sparse[idx] = rng.integers(1, 255, idx.size)
    super_sparse = np.zeros(30000, np.uint8)
    super_sparse[np.arange(8, 30000, 5000)] = rng.integers(1, 255, 6)
    return [rng.integers(0, 12, 6000).astype(np.uint8), sparse,
            super_sparse]


def _fibonacci(nsym, seed=13):
    """Symbol k (1..nsym) fib(k) times, shuffled: the deepest Huffman
    tree for its size, codes of nsym - 1 bits (18 symbols reach the
    third nibble level, 22 the fourth)."""
    fib = [1, 1]
    while len(fib) < nsym:
        fib.append(fib[-1] + fib[-2])
    x = np.repeat(np.arange(1, nsym + 1, dtype=np.uint8), fib)
    np.random.default_rng(seed).shuffle(x)
    return x


_RUNS = {}


def jax_run(name):
    """pallas_decoder.decode_many(interpret=True, return_hints=True) on a
    payload set, with _run_kernel's and _place_emissions' arguments and
    results captured. Runs once per module; RSPT_DEC_DEVICE_CHUNKS is
    raised so that JAX decodes the very deep block on its device path
    too, as the port does every block."""
    if name in _RUNS:
        return _RUNS[name]
    payloads = _payloads(name)
    streams = [jref.encode(p.tobytes()) for p in payloads]
    cap = {}
    run_kernel, place = pd._run_kernel, pd._place_emissions

    def spy_kernel(*args, **kw):
        out = run_kernel(*args, **kw)
        cap["kernel"] = ([np.asarray(a) for a in args],
                         [np.asarray(a) for a in out])
        return out

    def spy_place(*args, **kw):
        out = place(*args, **kw)
        cap["place"] = ([np.asarray(a) for a in args], kw, np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RSPT_DEC_DEVICE_CHUNKS", "1000")
        mp.setattr(pd, "_run_kernel", spy_kernel)
        mp.setattr(pd, "_place_emissions", spy_place)
        mp.setattr(pd, "_hint_registry", type(pd._hint_registry)())
        outs, hints = pd.decode_many(streams, interpret=True,
                                     return_hints=True)
    for p, o in zip(payloads, outs):
        assert o == p.tobytes()
    _RUNS[name] = dict(payloads=payloads, streams=streams, outs=outs,
                       hints=hints, **cap)
    return _RUNS[name]


@pytest.fixture()
def fresh_hints(monkeypatch):
    """An empty hint registry and validation state for one test."""
    monkeypatch.setattr(gd, "_hint_registry", type(gd._hint_registry)())
    monkeypatch.setattr(gd, "_validated_digests",
                        type(gd._validated_digests)())
    monkeypatch.setattr(gd, "_hints_disabled", False)


def _huff(streams, walker):
    huff = []
    for st in streams:
        src = np.frombuffer(st, np.uint8)
        size = int.from_bytes(st[:4], "little")
        walker(src, size, 0, np.zeros(size, np.uint8), huff)
    return huff


# -- (a) walk, LUTs and lane layout ------------------------------------------

@pytest.mark.parametrize("name", ["skewed", "deep", "very_deep"])
def test_walk_luts_and_lane_rows_match_jax(name):
    """walk_stream, build_lut_nib and lane_rows against JAX's on the
    skewed (test_deep_codes), deep (normal(0, 30), ~40 KB) and very deep
    (Fibonacci counts, 21-bit codes) fixtures."""
    if name == "skewed":
        x = np.repeat(np.arange(1, 40, dtype=np.uint8),
                      np.geomspace(1, 4000, 39).astype(int))
        np.random.default_rng(1234).shuffle(x)
    elif name == "deep":
        x = np.random.default_rng(11).normal(0, 30, 40000).astype(
            np.int32).astype(np.uint8)
    else:
        x = _fibonacci(22)
    streams = [jref.encode(x.tobytes())]
    ours = _huff(streams, walk.walk_stream)
    ref = _huff(streams, jax_decoder._walk_stream)
    assert len(ours) == len(ref) > 0
    deepest = 0
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o[0], r[0])
        assert o[1:] == r[1:]
        got, want = gd.build_lut_nib(o[5]), pd.build_lut_nib(r[5])
        np.testing.assert_array_equal(got[0], want[0])
        for k in range(gd.NIB_LEVELS):
            np.testing.assert_array_equal(got[1][k], want[1][k])
        assert got[2] == want[2]
        deepest = max(deepest, max([k + 1 for k in range(4) if got[2][k]],
                                   default=0))
    assert deepest == {"skewed": 2, "deep": 2, "very_deep": 4}[name]
    geom = [(h[1], h[2]) for h in ours] * 5
    assert gd.lane_rows(geom) == pd.lane_rows(geom)


# -- (b) lane arrays ---------------------------------------------------------

def _lane_arrays(run):
    _, _, huff = gd._walk_all(run["streams"])
    dev, _ = gd._device_blocks(huff)
    return gd.lane_arrays(dev)


@pytest.mark.parametrize("name", ["mix", "fused"])
def test_lane_arrays_match_jax(name):
    """The kernel inputs and placement's lane metadata equal what JAX's
    decode_many hands _run_kernel and _place_emissions."""
    run = jax_run(name)
    la = _lane_arrays(run)
    kargs, _ = run["kernel"]
    assert len(la.kernel_inputs()) == len(kargs)
    for got, want in zip(la.kernel_inputs(), kargs):
        np.testing.assert_array_equal(got, want)
    pargs, _, _ = run["place"]
    for got, want in zip((la.block_first, la.out_off, la.out_limit,
                          la.lane_live), pargs[3:7]):
        np.testing.assert_array_equal(got, want)


# -- (c) hzr_decode_plain against _run_kernel(interpret=True) ----------------

def _check_decode(got, want):
    emis, counts, entry_out, stats = got
    w_emis, w_counts, w_stats, w_entry = want
    np.testing.assert_array_equal(counts.numpy(), w_counts)
    np.testing.assert_array_equal(entry_out.numpy(), w_entry)
    np.testing.assert_array_equal(
        gd.valid_emissions(emis, stats[:, 0], literals_only=True).numpy(),
        gd.valid_emissions(_t(w_emis), _t(w_stats[:, 0]),
                           literals_only=True).numpy())
    st = stats.numpy()
    np.testing.assert_array_equal(-(-st[:, 0] // 4) * 4, w_stats[:, 0])
    np.testing.assert_array_equal(st[:, 1], w_stats[:, 1])   # fp sweeps
    np.testing.assert_array_equal(st[:, 2], w_stats[:, 2])   # literals
    np.testing.assert_array_equal(st[:, 4], w_stats[:, 4])   # max count


def test_hzr_decode_plain_matches_pallas():
    """Untrusted entries: the alignment fixpoint on both sides."""
    kargs, kout = jax_run("mix")["kernel"]
    got = ck.hzr_decode(*[_t(a) for a in kargs])
    _check_decode(got, kout)
    assert (got[3][:, 1] >= 1).all()


def test_hzr_decode_plain_matches_pallas_trusted():
    """Trusted entries (ntc[:, 4] = 1, the converged entries): one sweep
    on both sides, no fixpoint iteration."""
    kargs, kout = jax_run("fused")["kernel"]
    kargs = [a.copy() for a in kargs]
    kargs[0][:, 4] = 1
    kargs[8] = kout[3]
    want = [np.asarray(a) for a in pd._run_kernel(
        *[jnp.asarray(a) for a in kargs], interpret=True)]
    got = ck.hzr_decode(*[_t(a) for a in kargs])
    _check_decode(got, want)
    assert (got[3][:, 1] == 0).all()


# -- (d) place_literals_plain against _place_emissions(interpret=True) -------

@pytest.mark.parametrize("name,fused", [("fused", True), ("mix", False),
                                        ("tier2", True)])
def test_place_literals_plain_matches_pallas(name, fused):
    """The fused branch (K7, s_eff <= 128), the non-fused one (K3 + K8,
    s_eff > 128) and the tier-2 / scatter branches (K9, sparse and
    super-sparse blocks): the bytes of the JAX placement equal the
    plain masked scatter on the same emissions."""
    run = jax_run(name)
    pargs, kw, words = run["place"]
    emis, steps, counts, block_first, out_off, out_limit, live = pargs[:7]
    s_eff = int(pargs[7])
    assert kw["fused"] == fused
    assert (s_eff <= 128) == fused
    total = sum(p.size for p in run["payloads"])
    want = words.reshape(-1).view("<u4").view(np.uint8)[:total]
    base = gd.lane_out_base(_t(counts), _t(live), _t(out_off),
                            _t(block_first))
    got = ck.place_literals(_t(emis), _t(steps[:, 0]), base, _t(out_limit),
                            _t(live), total)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "tier2":
        # the sparse block's 128-literal chunks overspan the windows
        pos = np.flatnonzero(np.concatenate(run["payloads"]))
        last = pos[127::128]
        spans = (last - pos[::128][:last.size]) >> 2
        assert 0 < (spans > 248).sum() <= 128


def test_place_literals_plain_keeps_host_bytes():
    """place_literals handed an `out` that holds the host-resolved bytes
    (the COPY and FILL blocks, nonzero, zero over every device block), as
    decode_device hands it: the JAX placement's bytes over the device
    blocks, the host bytes everywhere else, and together the payloads."""
    run = jax_run("mix")
    pargs, _, words = run["place"]
    emis, steps, counts, block_first, out_off, out_limit, live = pargs[:7]
    total = sum(p.size for p in run["payloads"])
    jax_bytes = words.reshape(-1).view("<u4").view(np.uint8)[:total]
    _, host, _ = gd._walk_all(run["streams"])
    assert host.size == total and host.any()
    assert not (host.astype(bool) & jax_bytes.astype(bool)).any()
    base = gd.lane_out_base(_t(counts), _t(live), _t(out_off),
                            _t(block_first))
    out = _t(host)
    got = ck.place_literals(_t(emis), _t(steps[:, 0]), base, _t(out_limit),
                            _t(live), total, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(got.numpy(), host | jax_bytes)
    assert got.numpy().tobytes() == b"".join(p.tobytes()
                                             for p in run["payloads"])


# -- (e) decode_many end to end ------------------------------------------------

def _decode(streams, hints=None, return_hints=False):
    """gpu_decoder.decode_device on the CPU: (bytes per stream, hints,
    what the decode did)."""
    out, spans, h, info = gd.decode_device(streams, "cpu", hints,
                                           return_hints)
    out = out.numpy()
    return [out[a:a + n].tobytes() for a, n in spans], h, info


@pytest.mark.parametrize("name", ["mix", "fused", "tier2"])
def test_decode_many_matches_pallas_and_pyref(name, fresh_hints):
    """ECG-like planes, random bytes (COPY), FILL, a sparse high plane,
    deep and very deep trees, 1-bit codes, the padding-bit regression
    pair, sparse and super-sparse blocks: bytes equal JAX's, pyref's
    and the input's, every HUFF block decoded on the device."""
    run = jax_run(name)
    outs = gd.decode_many(run["streams"], device="cpu", hints=False)
    assert outs == run["outs"]
    for st, o, p in zip(run["streams"], outs, run["payloads"]):
        assert o == p.tobytes()
        if len(st) < 4096:
            assert o == jref.decode(st)
    assert _lane_arrays(run).lane_live.any()


def test_rank_edge_batch_layout():
    """tests/test_torch_cuda.py's rank-edge batch (the card test of
    hzr_decode's cluster boundaries) lays out as it says: tile 0 is 8
    live rows of one block, tile 1 two blocks then padding rows, tile 2
    a block then padding."""
    la, _, _ = decode_batch(rank_edge_payloads(np.random.default_rng(91)),
                            "cpu")
    first = la.block_first.reshape(-1, 8, 128)
    live = la.lane_live.reshape(-1, 8, 128)
    assert live.shape[0] == 3
    assert live[0].any(1).all() and (first[0][live[0]] == 0).all()
    assert live[1].any(1).tolist() == [True] * 6 + [False] * 2
    assert live[2].any(1).tolist() == [True] * 3 + [False] * 5
    assert len({int(f) for f in first[1][live[1]]}) == 2
    # every lane but a block's first takes its left neighbour's exit
    assert la.first.reshape(-1, 1024)[0].sum() == 1 + (~live[0]).sum()


@pytest.mark.parametrize("trusted", [False, True])
def test_rank_edge_batch_plain_decode(trusted, fresh_hints):
    """hzr_decode_plain on the rank-edge batch converges (untrusted:
    more than one sweep; trusted with its converged entries: none) and
    the device decode path round-trips it to the payloads."""
    payloads = rank_edge_payloads(np.random.default_rng(91))
    _, args, _ = decode_batch(payloads, "cpu")
    want = ck.hzr_decode_plain(*args)
    if trusted:
        args[8] = want[2]
        args[0] = args[0].clone()
        args[0][:, 4] = 1
        got = ck.hzr_decode(*args)
        assert int(got[3][:, 1].max()) == 0
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert torch.equal(gd.valid_emissions(got[0], got[3][:, 0]),
                           gd.valid_emissions(want[0], want[3][:, 0]))
    else:
        assert int(want[3][:, 1].min()) >= 2
    streams = [jref.encode(x.tobytes()) for x in payloads]
    assert gd.decode_many(streams, device="cpu", hints=False) == [
        x.tobytes() for x in payloads]


def test_very_deep_codes_decode_on_device(fresh_hints):
    """21-bit codes: all four nibble levels, decoded by the device path
    to the input bytes."""
    x = _fibonacci(22)
    outs, _, info = _decode([jref.encode(x.tobytes())])
    assert outs == [x.tobytes()]
    assert info["device_blocks"] == 1


def test_dense_trees_decode_on_device(fresh_hints):
    """A block with codes in the nibble levels (whose 128-entry chunks
    the JAX decoder counts to route blocks to a host decoder) and a
    flat one both decode on the device, exactly."""
    x = np.random.default_rng(13).geometric(0.5, 8000)
    deep = np.minimum(x, 255).astype(np.uint8)
    flat = np.random.default_rng(3).integers(0, 4, 3000).astype(np.uint8)
    streams = [jref.encode(deep.tobytes()), jref.encode(flat.tobytes())]
    outs, _, info = _decode(streams)
    assert outs == [deep.tobytes(), flat.tobytes()]
    assert info["device_blocks"] == 2
    _, _, huff = gd._walk_all(streams)
    assert max(sum(gd.build_lut_nib(h[5])[2]) for h in huff) > 0


# -- (f) hints -----------------------------------------------------------------

def test_hint_entries_match_jax_and_hinted_decode_is_exact(fresh_hints):
    """return_hints' entries equal JAX's; a hinted decode is exact and
    runs no fixpoint sweep; wrong-shape, bare-array and other-content
    hints are not trusted."""
    run = jax_run("mix")
    outs, h = gd.decode_many(run["streams"], device="cpu", hints=False,
                             return_hints=True)
    assert outs == run["outs"]
    np.testing.assert_array_equal(h.entries, np.asarray(run["hints"].entries))

    got, _, info = _decode(run["streams"], hints=h)
    assert got == outs
    assert info["hinted"] and set(info["fp_iters"]) == {0}
    assert h.digest in gd._validated_digests and not gd._hints_disabled

    gd._hint_registry.clear()
    for bad in (gd.DecodeHints(h.digest, h.entries[:, :64]), h.entries):
        got, _, info = _decode(run["streams"], hints=bad)
        assert got == outs and not info["hinted"]

    # other content with the same stream sizes (so the same lane layout)
    other = [bytearray(p.tobytes()) for p in run["payloads"]]
    other[-2][100:140] = bytes(np.roll(np.frombuffer(other[-2][100:140],
                                                     np.uint8), 3))
    other_streams = [jref.encode(bytes(p)) for p in other]
    assert other_streams[-2] != run["streams"][-2]
    assert [len(s) for s in other_streams] == [len(s) for s in run["streams"]]
    got, _, info = _decode(other_streams, hints=h)
    assert got == [bytes(p) for p in other] and not info["hinted"]


def test_registry_hints_and_opt_out(fresh_hints):
    """Returned hints register by digest: a later decode of the same
    streams trusts them without being passed them; hints=False opts
    out."""
    streams = jax_run("fused")["streams"]
    outs, _, _ = _decode(streams, return_hints=True)
    got, _, info = _decode(streams)
    assert got == outs and info["hinted"]
    got, _, info = _decode(streams, hints=False)
    assert got == outs and not info["hinted"]


def test_hint_cross_check_disables_bad_hints(fresh_hints):
    """Hints whose digest matches but whose entries are wrong decode
    wrong bytes once: the cross-check against the unhinted decode
    catches them, disables hint trust and returns the fixpoint's
    bytes."""
    streams = jax_run("fused")["streams"]
    outs, h, _ = _decode(streams, hints=False, return_hints=True)
    bad = gd.DecodeHints(h.digest, h.entries + 5 * (h.entries > 0))
    got, _, info = _decode(streams, hints=bad)
    assert got == outs
    assert gd._hints_disabled and not info["hinted"]
