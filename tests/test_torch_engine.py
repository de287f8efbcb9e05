"""The all-host engine (rspt_tpu_torch.packers.native, engine="native")
on the CPU: every packer kind's containers and decodes against the
oracle, rspt_tpu.packers.host, and against the port's card packers on
device="cpu" (the kernels' plain versions); the engine's arguments.

Containers are a byte format and decodes integers: every comparison is
exact (tolerance 0). The reference's own native engine grows xdelta
planes by another rule at bps < 4 (ROADMAP §3, hazards), so it is held
equal only at bps 4, and the bps-1 case where the two rules part is
pinned.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from conftest import make_ecg_like, to_native  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu.packers import native as jnative  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.native import bindings as native  # noqa: E402
from rspt_tpu_torch.packers import container  # noqa: E402
from rspt_tpu_torch.packers import gpu  # noqa: E402

NT = 2          # the runtime's threads in these tests
KINDS = ("hzr", "xdelta", "dct", "hadamard")
SHAPES = ((1, 1), (1, 7), (3, 64), (2, 1000), (12, 256))
SIGNALS = ("random", "zero", "sine")
I32_MIN = -(2 ** 31)


def _signal(kind, bps, ch, n, seed):
    if kind == "zero":
        return np.zeros((ch, n), np.int32)
    if kind == "random":
        lim = 1 << (8 * bps - 1)
        return np.random.default_rng(seed).integers(
            -lim, lim, (ch, n)).astype(np.int32)
    t = np.arange(n)
    return np.stack([(2.0 ** (8 * bps - 2) * np.sin(t / 7.0 + c)).astype(
        np.int32) for c in range(ch)])


def _makers(kind, bps, ch, n):
    """(name, factory(module, **kw)) of a packer kind at one shape: the
    xdelta packer at every starting plane count, Hadamard only at 2^k."""
    if kind == "xdelta":
        return [(f"xdelta{p}", lambda m, p=p, **kw: m.new_xdelta_hzr(
            bps, ch, n, p, **kw)) for p in range(1, 5)]
    if kind == "hadamard" and n & (n - 1):
        return []
    make = {"hzr": "new_hzr", "dct": "new_dct", "hadamard": "new_hadamard"}
    return [(kind, lambda m, **kw: getattr(m, make[kind])(bps, ch, n, **kw))]


def _native(mk, **kw):
    return mk(gpack, engine="native", nthreads=NT, **kw)


@pytest.mark.parametrize("bps", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_engine_equals_host_and_cpu(kind, bps):
    """engine="native" gives the containers of rspt_tpu.packers.host and
    of the port's device="cpu" packers (the xdelta plane count too), at
    shapes 1x1, 1x7, 3x64, 2x1,000 and 12x256, on random, zero and sine
    input (Hadamard at n = 1 and 2^k); it decodes them to the host's
    bytes, with the bytes consumed, and the host and device="cpu"
    packers decode its containers."""
    cases = 0
    for ch, n in SHAPES:
        for sk in SIGNALS:
            nat = to_native(_signal(sk, bps, ch, n, bps * 100 + ch), bps)
            for name, mk in _makers(kind, bps, ch, n):
                h, g, nv = mk(hpack), mk(gpack, device="cpu"), _native(mk)
                comp = h.compress(nat)
                got = nv.compress(nat)
                what = (name, ch, n, sk)
                assert got == comp == g.compress(nat), what
                if kind == "xdelta":
                    assert nv.nr_planes == h.nr_planes == g.nr_planes, what
                want = h.decompress(comp)[0]
                if kind in ("hzr", "xdelta"):
                    assert want == nat, what
                assert nv.decompress(got) == (want, len(got)), what
                assert nv.decompress_many([got, got]) == [want] * 2, what
                assert g.decompress(got)[0] == h.decompress(got)[0] == want
                cases += 1
    assert cases == {"xdelta": 60, "hadamard": 9}.get(kind, 15)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_equals_reference_native_engine_at_bps4(kind):
    """At 4 bytes a sample, where the two growth rules agree, the port's
    native engine equals rspt_tpu.packers.native byte for byte, growth
    from every starting plane count included, on an ECG-like walk and on
    full-scale random samples."""
    rng = np.random.default_rng(40)
    for sig in (make_ecg_like(rng, 3, 512, bits=32),
                rng.integers(I32_MIN, 2 ** 31, (2, 256), dtype=np.int64)
                .astype(np.int32)):
        ch, n = sig.shape
        nat = to_native(sig, 4)
        for name, mk in _makers(kind, 4, ch, n):
            j, nv = mk(jnative), _native(mk)
            comp = j.compress(nat)
            assert nv.compress(nat) == comp, name
            if kind == "xdelta":
                assert nv.nr_planes == j.nr_planes, name
            assert nv.decompress(comp) == j.decompress(comp), name


def _growth_case():
    """bps 1, 2 channels x 512 samples of a sine, from 1 plane: 1 plane
    keeps every sample by the reference's test, so the host packer and
    the port stay at 1 plane (407 B); the reference's native engine adds
    a plane because the xdelta values do not sign-extend from one byte
    (427 B)."""
    t = np.arange(512)
    sig = np.stack([(64 * np.sin(t / 7.0 + c)).astype(np.int32)
                    for c in range(2)])
    return to_native(sig, 1)


def test_growth_rule_is_the_references_at_bps1():
    """The pinned bps-1 case: the native engine, the host oracle and the
    device="cpu" packer give the same 407-byte, 1-plane container; the
    reference's native engine grows to 2 planes (427 B), its hazard that
    the port does not copy; every one of them decodes to the input."""
    nat = _growth_case()
    packers_ = {"host": hpack.new_xdelta_hzr(1, 2, 512, 1),
                "cpu": gpack.new_xdelta_hzr(1, 2, 512, 1, device="cpu"),
                "native": gpack.new_xdelta_hzr(1, 2, 512, 1,
                                               engine="native")}
    comps = {k: p.compress(nat) for k, p in packers_.items()}
    assert len(set(comps.values())) == 1
    assert len(comps["native"]) == 407
    assert {p.nr_planes for p in packers_.values()} == {1}
    j = jnative.new_xdelta_hzr(1, 2, 512, 1)
    jcomp = j.compress(nat)
    assert (len(jcomp), j.nr_planes) == (427, 2)
    assert packers_["native"].decompress(comps["native"])[0] == nat
    assert j.decompress(jcomp)[0] == nat


@pytest.mark.parametrize("kind", KINDS)
def test_thread_counts_give_the_same_bytes(kind):
    """nthreads 1, 4 and 0 (every hardware thread) give the same
    containers and decodes, on a shape of two 64 KiB blocks a plane (the
    DCT at 96 x 1,024: its tables grow as n squared)."""
    rng = np.random.default_rng(9)
    ch, n = (96, 1 << 10) if kind == "dct" else (3, 1 << 15)
    nat = to_native(make_ecg_like(rng, ch, n, bits=24), 3)
    mk = _makers(kind, 3, ch, n)[0][1]
    outs = set()
    for nt in (1, 4, 0):
        p = mk(gpack, engine="native", nthreads=nt)
        comp = p.compress(nat)
        outs.add((comp, p.decompress(comp)[0]))
    assert len(outs) == 1


def _nr_planes(comp: bytes) -> int:
    """The plane streams of a container without a header."""
    pos, k = 1, 0
    while pos < len(comp):
        pos += 4 + int.from_bytes(comp[pos:pos + 4], "little")
        k += 1
    return k


def test_compress_many_grows_as_sequential_calls():
    """compress_many equals sequential compress calls on one packer and
    the host's: three quiet payloads fit one plane, the fourth grows the
    count for every later one; decompress_many gives them back."""
    bps, ch, n = 2, 3, 300
    rng = np.random.default_rng(11)
    srcs = [to_native((np.cumsum(rng.integers(-3, 4, (ch, n)), axis=1)
                       * (0 if i < 3 else 300)).astype(np.int32), bps)
            for i in range(6)]
    many = gpack.new_xdelta_hzr(bps, ch, n, 1, engine="native")
    seq = gpack.new_xdelta_hzr(bps, ch, n, 1, engine="native")
    host = hpack.new_xdelta_hzr(bps, ch, n, 1)
    got = many.compress_many(srcs)
    assert got == [seq.compress(s) for s in srcs]
    assert got == [host.compress(s) for s in srcs]
    assert many.nr_planes == host.nr_planes == 2
    assert [_nr_planes(c) for c in got] == [1, 1, 1, 2, 2, 2]
    assert many.decompress_many(got[3:]) == srcs[3:]
    assert many.compress_many([]) == []


@pytest.mark.parametrize("backend", ["lz4", "lz4hc"])
@pytest.mark.parametrize("kind", KINDS)
def test_lz4_backends(kind, backend):
    """'lz4' and 'lz4hc' on every kind: the host's and the device="cpu"
    packer's containers (method byte | 0x40) at bps 1-4; the native
    packer decodes them, and its hzr packer decodes them too, as the
    host does."""
    for bps in (1, 2, 3, 4):
        ch, n = 3, 64
        nat = to_native(make_ecg_like(np.random.default_rng(bps), ch, n,
                                      bits=8 * bps), bps)
        for name, mk in _makers(kind, bps, ch, n):
            h = mk(hpack, plane_backend=backend)
            nv = _native(mk, plane_backend=backend)
            comp = h.compress(nat)
            assert nv.compress(nat) == comp == mk(
                gpack, device="cpu", plane_backend=backend).compress(nat)
            assert comp[0] == h.METHOD | container.PLANE_LZ4
            want = h.decompress(comp)[0]
            other = _native(mk)
            other.nr_planes = nv.nr_planes
            assert nv.decompress(comp) == other.decompress(comp) == \
                (want, len(comp)), (name, bps)


@pytest.mark.parametrize("kind", KINDS)
def test_decodes_either_backend_and_checks_the_method(kind):
    """A native packer decodes hzr and LZ4 containers alike, in one
    decompress_many too; a container of another packer type raises."""
    bps, ch, n = 3, 3, 256
    nat = to_native(make_ecg_like(np.random.default_rng(4), ch, n, bits=20),
                    bps)
    mk = _makers(kind, bps, ch, n)[-1][1]
    comps = [_native(mk, plane_backend=be).compress(nat)
             for be in ("hzr", "lz4", "lz4hc")]
    want = mk(hpack).decompress(comps[0])[0]
    p = _native(mk)
    assert p.decompress_many(comps) == [want] * 3
    other = "dct" if kind in ("hzr", "xdelta") else "hzr"
    q = _native(_makers(other, bps, ch, n)[-1][1])
    for comp in comps:
        with pytest.raises(ValueError, match="unsupported"):
            q.decompress(comp)


def test_dct_out_of_range_sums_as_x86():
    """A DCT container whose coefficients are the ramp 30000 (k + 1) at
    4,096 samples: its inverse sums leave the int32 range, and the native
    engine gives the host's bytes, INT32_MIN (x86's conversion) at 210 of
    the 4,096 samples; the device="cpu" packer gives them too. The native
    compress of the same shape equals the host's on a full-scale
    square."""
    n = 4096
    coef = (30000 * (np.arange(n) + 1)).astype(np.int32)
    flat = native.xor_encode(native.offset32(native.delta_encode(coef),
                                             -128))
    comp = container.container(
        1, gpu._means_header(np.zeros(1, np.int32)),
        native.encode_planes_blocks(native.plane_split(flat, 2)))
    nv = gpack.new_dct(4, 1, n, engine="native")
    out, used = nv.decompress(comp)
    assert (out, used) == (hpack.new_dct(4, 1, n).decompress(comp)[0],
                           len(comp))
    assert gpack.new_dct(4, 1, n, device="cpu").decompress(comp)[0] == out
    assert int((np.frombuffer(out, "<i4") == I32_MIN).sum()) == 210
    sq = np.where((np.arange(2 * 300) // 7) % 2, 2 ** 31 - 1, I32_MIN)
    nat = to_native(sq.reshape(2, 300).astype(np.int32), 4)
    assert gpack.new_dct(4, 2, 300, engine="native").compress(nat) == \
        hpack.new_dct(4, 2, 300).compress(nat)


def test_engine_arguments():
    """engine="auto" and "host" raise ValueError naming the choices; the
    native engine raises on device=, device_decode=True and encoder=, and
    the card engine on nthreads=; the default engine is the card's."""
    for engine in ("auto", "host", "tpu"):
        with pytest.raises(ValueError, match="cuda"):
            gpack.new_hzr(4, 2, 8, engine=engine)
    for make in (lambda **kw: gpack.new_xdelta_hzr(4, 2, 8, 3, **kw),
                 lambda **kw: gpack.new_hzr(4, 2, 8, **kw),
                 lambda **kw: gpack.new_dct(4, 2, 8, **kw),
                 lambda **kw: gpack.new_hadamard(4, 2, 8, **kw)):
        for kw in ({"device": "cpu"}, {"device_decode": True},
                   {"encoder": object()}):
            with pytest.raises(ValueError, match="engine='native'"):
                make(engine="native", **kw)
        with pytest.raises(ValueError, match="nthreads"):
            make(device="cpu", nthreads=2)
        assert isinstance(make(device="cpu"), gpu._GpuPackerBase)
        assert make(engine="native").nthreads == 0
        assert make(engine="native", nthreads=3).nthreads == 3
    with pytest.raises(ValueError, match="plane backend"):
        gpack.new_hzr(4, 2, 8, engine="native", plane_backend="zstd")
    with pytest.raises(ValueError, match="2\\^k"):
        gpack.new_hadamard(4, 2, 6, engine="native")
    p = gpack.new_xdelta_hzr(4, 2, 8, 3, engine="native")
    assert not hasattr(p, "compress_with_hints")
    with pytest.raises(TypeError):
        p.decompress_many([], hints=None)
    with pytest.raises(ValueError, match="native"):
        p.compress(bytes(63))


def test_default_engine_raises_without_card(monkeypatch):
    """With no card, engine="cuda" (the default, or named) raises as the
    factories always have; engine="native" builds and runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nat = bytes(range(64))
    for engine in (None, "cuda"):
        kw = {} if engine is None else {"engine": engine}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gpack.new_xdelta_hzr(4, 2, 8, 3, **kw)
    p = gpack.new_xdelta_hzr(4, 2, 8, 3, engine="native")
    assert p.decompress(p.compress(nat))[0] == nat
