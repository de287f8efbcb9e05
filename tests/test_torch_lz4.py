"""The port's LZ4 plane backend on the CPU: the LZ4 block codec of its
host runtime (rspt_tpu_torch/native) against the reference runtime's
(rspt_tpu.native.bindings, called directly, so that no fallback of the
reference to its Python spec codec can hide a difference), the plane
batches, the decoders on malformed input, the four packers with
plane_backend 'lz4' and 'lz4hc' against rspt_tpu.packers.host, decoding
across backends, compress_many, and the Hadamard packer at one sample
(F4).

The streams and containers are a byte format: every comparison is exact.
Inputs are made with numpy from a seed.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from conftest import make_ecg_like, to_native  # noqa: E402
from test_lz4 import _cases  # noqa: E402
from rspt_tpu.native import bindings as rb  # noqa: E402
from rspt_tpu.ops import numpy_ops as nops  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.formats import lz4_block as spec  # noqa: E402
from rspt_tpu_torch.native import bindings as pb  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.packers import container  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("lz4", "lz4hc")
PACKERS = ("hzr", "xdelta", "dct", "hadamard")
SHAPES = ((1, 1), (3, 64), (2, 1000), (12, 256))
SIGNALS = ("random", "zero", "sine")


def _fuzz(alpha: int):
    """Seeded inputs of 0-100,000 bytes over an alphabet of alpha
    symbols, the ends of the range included."""
    rng = np.random.default_rng(alpha)
    lens = [0, 100_000] + rng.integers(1, 100_000, 6).tolist()
    return [(rng.integers(0, alpha, n) % 256).astype(np.uint8).tobytes()
            for n in lens]


def _xdelta_planes():
    """The byte planes of the xdelta values of seeded ECG-like signals
    (the reference's numpy ops) at 3 and 4 planes."""
    out = []
    for seed, (ch, n, planes) in enumerate(((12, 2048, 3), (3, 9000, 4))):
        sig = make_ecg_like(np.random.default_rng(seed), ch, n)
        enc = nops.xor_encode(nops.offset32(nops.delta_encode(
            sig.reshape(-1)), -128))
        out += [p.tobytes() for p in nops.plane_split(enc, planes)]
    return out


INPUTS = {
    "cases": lambda: _cases(np.random.default_rng(1234)),
    "alphabet2": lambda: _fuzz(2),
    "alphabet16": lambda: _fuzz(16),
    "alphabet256": lambda: _fuzz(256),
    "xdelta_planes": _xdelta_planes,
}


def _lz4_both(data, hc, depth=256):
    """(port bytes, reference runtime bytes) of one input."""
    if hc:
        return pb.lz4_compress_hc(data, depth), rb.lz4_compress_hc(data, depth)
    return pb.lz4_compress(data), rb.lz4_compress(data)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hc", [False, True], ids=["greedy", "hc"])
@pytest.mark.parametrize("inputs", list(INPUTS))
def test_codec_equals_reference(inputs, hc):
    """The port's greedy and HC streams equal the reference runtime's,
    and decode back through the port's runtime, its spec copy and the
    reference runtime."""
    for data in INPUTS[inputs]():
        got, want = _lz4_both(data, hc)
        assert got == want, (inputs, len(data))
        n = len(data)
        assert pb.lz4_decompress(got, n) == data
        assert spec.decompress(got, n) == data
        assert rb.lz4_decompress(got, n) == data


@pytest.mark.parametrize("depth", [1, 4, 16, 0])
def test_hc_depths_equal_reference(depth):
    """HC at shallow chains (where the match search gives up early and
    matches extend backwards over inserted positions, the reference's
    chain hazard) and at depth 0 (= 256) equals the reference."""
    rng = np.random.default_rng(depth)
    for alpha in (2, 3, 16):
        base = (rng.integers(0, alpha, 9000) % 256).astype(np.uint8)
        for data in (base.tobytes(), np.tile(base[:700], 13).tobytes()):
            got, want = _lz4_both(data, True, depth)
            assert got == want, (alpha, len(data))
            assert spec.decompress(got, len(data)) == data


@pytest.mark.parametrize("hc", [False, True], ids=["greedy", "hc"])
def test_plane_batches_equal_single_calls(hc):
    """lz4_encode_planes gives each row's single-call bytes, and
    lz4_decode_planes reads a container's plane section back, with the
    bytes it spans."""
    rng = np.random.default_rng(5)
    for nplanes, plane_len in ((1, 0), (1, 1), (3, 5000), (24, 777)):
        planes = (rng.integers(0, 7, (nplanes, plane_len)) * (
            rng.random((nplanes, plane_len)) < 0.3)).astype(np.uint8)
        streams = pb.lz4_encode_planes(planes, hc)
        one = pb.lz4_compress_hc if hc else pb.lz4_compress
        assert streams == [one(row.tobytes()) for row in planes]
        section = container.container(0, b"", streams)[1:]
        got, used = pb.lz4_decode_planes(section + b"tail", nplanes,
                                         plane_len)
        np.testing.assert_array_equal(got, planes)
        assert used == len(section)


def test_plane_batches_from_threads():
    """Callers in several threads at once (ctypes drops the GIL; the
    runtime's pool takes one call at a time) each get their own planes'
    bytes back."""
    from concurrent.futures import ThreadPoolExecutor
    rng = np.random.default_rng(6)
    jobs = [(rng.integers(0, 5, (4, 3000)) * (k % 3)).astype(np.uint8)
            for k in range(12)]
    want = [[pb.lz4_compress(row.tobytes()) for row in j] for j in jobs]

    def run(k):
        for _ in range(10):
            streams = pb.lz4_encode_planes(jobs[k], k % 2 == 1)
            section = container.container(0, b"", streams)[1:]
            back, _ = pb.lz4_decode_planes(section, 4, 3000)
            if not np.array_equal(back, jobs[k]):
                return False
            if k % 2 == 0 and streams != want[k]:
                return False
        return True

    with ThreadPoolExecutor(16) as ex:
        done = [f.result(timeout=60) for f in
                [ex.submit(run, k) for k in range(len(jobs))]]
    assert all(done)


def test_decoders_reject_malformed():
    """Cut short, a wrong size and empty input raise ValueError; 200
    single-byte corruptions either raise ValueError or decode to the
    size asked, always as the spec decoder and the reference runtime do
    (never a crash)."""
    data = bytes(np.random.default_rng(3).integers(0, 8, 5000, np.uint8))
    comp = pb.lz4_compress(data)
    for bad, n in ((comp[:-2], len(data)), (comp, len(data) - 1),
                   (comp, len(data) + 1), (b"", 0), (b"", len(data))):
        with pytest.raises(ValueError):
            pb.lz4_decompress(bad, n)
        with pytest.raises(ValueError):
            spec.decompress(bad, n)
    rng = np.random.default_rng(7)
    buf = np.frombuffer(comp, np.uint8).copy()
    outcomes = set()
    for _ in range(200):
        i = int(rng.integers(0, buf.size))
        old = buf[i]
        buf[i] = rng.integers(0, 256)
        results = []
        for dec in (pb.lz4_decompress, spec.decompress, rb.lz4_decompress):
            try:
                results.append(dec(buf.tobytes(), len(data)))
            except ValueError:
                results.append(None)
        assert results[0] == results[1] == results[2]
        assert results[0] is None or len(results[0]) == len(data)
        outcomes.add(results[0] is None)
        buf[i] = old
    assert outcomes == {True, False}


def test_plane_section_rejects_malformed():
    """A section cut inside a length or a stream, a length past its end
    or a plane of another size raises ValueError."""
    planes = np.random.default_rng(9).integers(0, 4, (3, 2000)).astype(
        np.uint8)
    section = container.container(0, b"", pb.lz4_encode_planes(planes))[1:]
    for cut in (0, 2, 4, len(section) - 1):
        with pytest.raises(ValueError):
            pb.lz4_decode_planes(section[:cut], 3, 2000)
    for plane_len in (1999, 2001):
        with pytest.raises(ValueError):
            pb.lz4_decode_planes(section, 3, plane_len)
    big = bytearray(section)
    big[0:4] = (len(section)).to_bytes(4, "little")
    with pytest.raises(ValueError):
        pb.lz4_decode_planes(bytes(big), 3, 2000)


# ---------------------------------------------------------------------------
# The packers
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("kind", PACKERS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_packers_equal_host(backend, kind):
    """Each port packer's container on device="cpu" equals
    rspt_tpu.packers.host's with the same backend (the xdelta packer's
    growth and plane count too), at bps 1-4, shapes 1x1, 3x64, 2x1,000
    and 12x256, on random, zero and sine input; it decodes to the host
    reference's bytes through the port (host and device_decode packers,
    decompress and decompress_many) and through the host reference."""
    cases = 0
    for bps in (1, 2, 3, 4):
        for ch, n in SHAPES:
            for sk in SIGNALS:
                nat = to_native(_signal(sk, bps, ch, n, bps * 100 + ch), bps)
                for name, mk in _makers(kind, bps, ch, n):
                    h = mk(hpack, plane_backend=backend)
                    g = mk(gpack, device="cpu", plane_backend=backend)
                    gd = mk(gpack, device="cpu", plane_backend=backend,
                            device_decode=True)
                    comp = h.compress(nat)
                    got = g.compress(nat)
                    what = (name, bps, ch, n, sk)
                    assert got == comp, what
                    assert got[0] == h.METHOD | container.PLANE_LZ4, what
                    if kind == "xdelta":
                        assert g.nr_planes == h.nr_planes, what
                        gd.nr_planes = g.nr_planes
                    want = h.decompress(comp)[0]
                    if kind in ("hzr", "xdelta"):
                        assert want == nat, what
                    assert g.decompress(got) == (want, len(got)), what
                    assert gd.decompress(got) == (want, len(got)), what
                    assert gd.decompress_many([got, got]) == [want] * 2
                    assert h.decompress(got)[0] == want, what
                    cases += 1
    assert cases == {"xdelta": 192, "hadamard": 36}.get(kind, 48)


@pytest.mark.parametrize("kind", PACKERS)
def test_cross_backend_decoding(kind):
    """An hzr-backend packer decodes LZ4 and LZ4HC containers, an LZ4
    packer decodes hzr ones, on both decode paths; decompress_many takes
    a mixed batch (its hints cover the hzr containers alone)."""
    bps, ch, n = 3, 3, 256
    nat = to_native(make_ecg_like(np.random.default_rng(4), ch, n, bits=20),
                    bps)
    mk = _makers(kind, bps, ch, n)[-1][1]
    comps = {be: mk(gpack, device="cpu", plane_backend=be).compress(nat)
             for be in ("hzr", *BACKENDS)}
    want = mk(hpack).decompress(comps["hzr"])[0]
    for be in ("hzr", *BACKENDS):
        for dd in (False, True):
            p = mk(gpack, device="cpu", plane_backend=be, device_decode=dd)
            for cbe, comp in comps.items():
                assert p.decompress(comp) == (want, len(comp)), (be, cbe, dd)
    d = mk(gpack, device="cpu", device_decode=True)
    batch = [comps["lz4"], comps["hzr"], comps["lz4hc"], comps["hzr"]]
    outs, hints = d.decompress_many(batch, return_hints=True)
    assert outs == [want] * 4 and hints is not None
    assert d.decompress_many(batch, hints=hints) == [want] * 4
    assert d.decode_info["hinted"]
    outs, hints = d.decompress_many([comps["lz4"]], return_hints=True)
    assert outs == [want] and hints is None
    assert mk(gpack, device="cpu").decompress_many(batch) == [want] * 4


def test_method_byte_checked():
    """A container of another packer type raises, whatever its flag; an
    unknown flag bit above PLANE_LZ4 is masked as the reference masks
    it."""
    nat = to_native(make_ecg_like(np.random.default_rng(2), 2, 64), 4)
    x = gpack.new_xdelta_hzr(4, 2, 64, 3, device="cpu", plane_backend="lz4")
    comp = x.compress(nat)
    for dd in (False, True):
        dct = gpack.new_dct(4, 2, 64, device="cpu", device_decode=dd)
        with pytest.raises(ValueError, match="unsupported"):
            dct.decompress(comp)
        with pytest.raises(ValueError, match="unsupported"):
            dct.decompress_many([comp])
    hz = gpack.new_hzr(4, 2, 64, device="cpu").compress(nat)
    odd = bytes([0x80]) + hz[1:]
    assert gpack.new_hzr(4, 2, 64, device="cpu").decompress(odd)[0] == nat
    assert hpack.new_hzr(4, 2, 64).decompress(odd)[0] == nat


def _nr_planes(comp: bytes) -> int:
    """The plane streams of a container without a header."""
    pos, k = 1, 0
    while pos < len(comp):
        pos += 4 + int.from_bytes(comp[pos:pos + 4], "little")
        k += 1
    return k


@pytest.mark.parametrize("backend", BACKENDS)
def test_compress_many_equals_sequential(backend):
    """compress_many on an LZ4 xdelta packer equals sequential compress
    calls, growth included (three zero payloads fit one plane, the
    fourth grows the count for the later ones), and equals the host
    reference's."""
    bps, ch, n = 2, 3, 300
    rng = np.random.default_rng(11)
    srcs = [to_native((np.cumsum(rng.integers(-3, 4, (ch, n)), axis=1)
                       * (0 if i < 3 else 300)).astype(np.int32), bps)
            for i in range(6)]
    many = gpack.new_xdelta_hzr(bps, ch, n, 1, device="cpu",
                                plane_backend=backend)
    seq = gpack.new_xdelta_hzr(bps, ch, n, 1, device="cpu",
                               plane_backend=backend)
    host = hpack.new_xdelta_hzr(bps, ch, n, 1, plane_backend=backend)
    got = many.compress_many(srcs)
    assert got == [seq.compress(s) for s in srcs]
    assert got == [host.compress(s) for s in srcs]
    assert many.nr_planes == seq.nr_planes == host.nr_planes == 2
    assert [_nr_planes(c) for c in got] == [1, 1, 1, 2, 2, 2]
    assert set(many.stage_seconds) == {"pass1", "fetch", "lz4"}
    assert many.compress_many([]) == []
    fresh = gpack.new_xdelta_hzr(bps, ch, n, 1, device="cpu",
                                 plane_backend=backend)
    assert fresh.compress_with_hints(srcs[0]) == (got[0], None)


def test_backend_arguments():
    """An unknown backend raises, encoder= with an LZ4 backend raises
    (the sharded encoder codes hzr planes), and an LZ4 packer with no
    device raises without a card."""
    from rspt_tpu_torch.parallel import ShardedHzrEncoder, make_mesh
    for make in (lambda **kw: gpack.new_hzr(4, 2, 64, **kw),
                 lambda **kw: gpack.new_xdelta_hzr(4, 2, 64, 3, **kw),
                 lambda **kw: gpack.new_dct(4, 2, 64, **kw),
                 lambda **kw: gpack.new_hadamard(4, 2, 64, **kw)):
        for bad in ("lz5", "", "LZ4", None):
            with pytest.raises(ValueError, match="plane backend"):
                make(device="cpu", plane_backend=bad)
        enc = ShardedHzrEncoder(make_mesh(["cpu"]))
        for be in BACKENDS:
            with pytest.raises(ValueError, match="encoder"):
                make(device="cpu", encoder=enc, plane_backend=be)
            assert make(device="cpu", plane_backend=be).plane_backend == be


def test_lz4_route_without_card_or_runtime(monkeypatch):
    """No device and no card: an LZ4 packer raises. No host runtime: its
    compress and decompress raise; the spec codec is never a fallback."""
    nat = np.arange(300, dtype="<i4").tobytes()
    p = gpack.new_xdelta_hzr(4, 3, 100, 3, device="cpu", plane_backend="lz4")
    comp = p.compress(nat)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpack.new_xdelta_hzr(4, 3, 100, 3, plane_backend="lz4")

    def unavailable():
        raise RuntimeError("runtime unavailable")

    def no_spec(*a, **kw):
        raise AssertionError("spec codec called")

    monkeypatch.setattr(pb, "_lib", unavailable)
    monkeypatch.setattr(spec, "compress", no_spec)
    monkeypatch.setattr(spec, "decompress", no_spec)
    for call in (lambda: p.compress(nat), lambda: p.decompress(comp),
                 lambda: p.compress_many([nat])):
        with pytest.raises(RuntimeError, match="runtime unavailable"):
            call()


def test_lz4_process_loads_neither_jax_nor_rspt_tpu():
    """A process that compresses and decompresses with LZ4 planes and
    uses the containers imports no jax and nothing of rspt_tpu, and maps
    the port's runtime, not the reference's."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from rspt_tpu_torch import packers\n"
        "from rspt_tpu_torch.containers import tensor_i32\n"
        "from rspt_tpu_torch.formats import lz4_block\n"
        "nat = np.arange(3000, dtype='<i4').tobytes()\n"
        "for be in ('lz4', 'lz4hc'):\n"
        "    p = packers.new_xdelta_hzr(4, 3, 1000, 3, device='cpu', "
        "plane_backend=be)\n"
        "    assert p.decompress(p.compress(nat))[0] == nat\n"
        "assert tensor_i32(2, 3).to_torch('cpu').shape == (2, 3)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'librspt_torch_native.so' in maps\n"
        "assert 'librspt_native.so' not in maps\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rspt_tpu' or m.startswith('rspt_tpu.')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# ---------------------------------------------------------------------------
# F4: the Hadamard packer at one sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["hzr", *BACKENDS])
def test_hadamard_one_sample(backend):
    """new_hadamard(bps, ch, 1) builds, and its containers equal the host
    packer's at bps 1-4 and 1 and 3 channels (hzr: 52 B and 58 B), and
    decode to the host's bytes on both paths; fwht at n = 1 is a copy
    with no launch. n = 0 still raises."""
    for bps in (1, 2, 3, 4):
        for ch in (1, 3):
            nat = np.random.default_rng(bps * 10 + ch).integers(
                0, 256, bps * ch, np.uint8).tobytes()
            h = hpack.new_hadamard(bps, ch, 1, plane_backend=backend)
            comp = h.compress(nat)
            want = h.decompress(comp)[0]
            for dd in (False, True):
                g = gpack.new_hadamard(bps, ch, 1, device="cpu",
                                       plane_backend=backend,
                                       device_decode=dd)
                got = g.compress(nat)
                assert got == comp, (bps, ch, dd)
                assert g.decompress(got) == (want, len(got))
            if backend == "hzr":
                assert len(comp) == {1: 52, 3: 58}[ch]
    x = torch.tensor([[5], [-7], [2 ** 31 - 1]], dtype=torch.int32)
    before = ck.fwht.launches
    for fn in (ck.fwht, ck.fwht_plain):
        y = fn(x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert ck.fwht.launches == before
    with pytest.raises(ValueError, match="2\\^k"):
        gpack.new_hadamard(4, 1, 0, device="cpu")
