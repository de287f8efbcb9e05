"""The port's sharding (rspt_tpu_torch.parallel) on CPU shards: the
sharded hzr encoder, its flat and compact routes, the packers' encoder=
hook, the sharded decoder and its hints, the cross-shard scans, and two
gloo processes. Every stream, container and decode is byte-equal to the
unsharded port's, to rspt_tpu.hzr.pyref and rspt_tpu.packers.host, and
to the JAX package's ShardedHzrEncoder / ShardedHzrDecoder /
make_sharded_scans on conftest's 8-device CPU mesh (tolerance 0: the
streams are a byte format).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from rspt_tpu.hzr import pyref as jref  # noqa: E402
from rspt_tpu.ops import numpy_ops as nops  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.parallel import (ShardedHzrDecoder,  # noqa: E402
                                     ShardedHzrEncoder, make_mesh,
                                     make_sharded_scans, mesh as pmesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [1, 2, 4, 8]
I32 = np.iinfo(np.int32)


def cpu_mesh(k):
    return make_mesh(["cpu"] * k)


@pytest.fixture(scope="module")
def payload():
    """tests/test_tpu_packers.py:74-84's payload (8 blocks) and its
    streams from pyref and the unsharded port."""
    data = np.random.default_rng(1234).integers(0, 50, 500000,
                                                np.int64).astype(np.uint8)
    want = jref.encode(data)
    assert tc.encode(data, device="cpu") == want
    return data, want


@pytest.fixture(scope="module")
def dec_streams():
    """tests/test_tpu_packers.py:143-160's payload (HUFF, FILL and COPY
    blocks) and two more streams, with the JAX sharded decoder's output
    and its hinted rerun on the 8-device mesh."""
    from rspt_tpu.parallel.mesh import ShardedHzrDecoder as JaxDecoder
    rng = np.random.default_rng(1234)
    payload = np.concatenate([
        rng.integers(0, 10, 90000).astype(np.uint8),
        np.zeros(30000, np.uint8),
        rng.integers(0, 256, 5000).astype(np.uint8)])
    more = [np.minimum(rng.geometric(0.2, 70000), 255).astype(np.uint8),
            rng.integers(0, 3, 140000).astype(np.uint8)]
    datas = [p.tobytes() for p in [payload] + more]
    streams = [jref.encode(p) for p in datas]
    jd = JaxDecoder()
    outs, hints = jd.decode_many(streams, return_hints=True)
    assert outs == datas
    assert jd.decode_many(streams, hints=hints) == datas
    return streams, datas


@pytest.mark.parametrize("k", SHARDS)
def test_encode_matches_pyref_and_unsharded(payload, k):
    """encode on k CPU shards == pyref.encode == torch_coder.encode."""
    data, want = payload
    enc = ShardedHzrEncoder(cpu_mesh(k))
    assert enc.encode(data) == want
    assert set(enc.stage_seconds) == {"tokenize", "tables", "pack", "fetch",
                                      "gather"}


def test_encode_matches_jax_sharded_encoder(payload):
    """The port on 8 CPU shards == JAX's ShardedHzrEncoder on conftest's
    8-device mesh, by its compact and its flat route."""
    import jax
    from rspt_tpu.parallel.mesh import ShardedHzrEncoder as JaxEncoder
    assert len(jax.devices()) == 8
    data, want = payload
    assert JaxEncoder().encode(data) == want
    enc = ShardedHzrEncoder(cpu_mesh(8))
    blocks, lengths = tc.split_blocks(data)
    assert tc.assemble_compact(*enc.encode_blocks_flat(blocks, lengths)) \
        == enc.encode(data) == want


@pytest.mark.parametrize("k", SHARDS)
def test_flat_and_compact_routes(payload, k):
    """encode_blocks_flat and encode_blocks_compact assembled == pyref;
    an all-COPY batch: the flat route declines (None) and the compact
    route is equal; COPY blocks beside HUFF ones: the flat route takes
    them."""
    data, want = payload
    enc = ShardedHzrEncoder(cpu_mesh(k))
    blocks, lengths = tc.split_blocks(data)
    for route in (enc.encode_blocks_flat, enc.encode_blocks_compact):
        res = route(blocks, lengths)
        assert len(res) == 7 and tc.assemble_compact(*res) == want
    rng = np.random.default_rng(21)
    rnd = rng.integers(0, 256, 3 * 65536).astype(np.uint8)
    b, ln = tc.split_blocks(rnd)
    assert enc.encode_blocks_flat(b, ln) is None
    assert tc.assemble_compact(*enc.encode_blocks_compact(b, ln)) \
        == jref.encode(rnd)
    mixed = np.concatenate([rnd[:70000], data[:200000], rnd[:9]])
    b, ln = tc.split_blocks(mixed)
    res = enc.encode_blocks_flat(b, ln)
    assert res is not None and res[4].any()            # COPY bytes
    assert tc.assemble_compact(*res) == jref.encode(mixed)


@pytest.mark.parametrize("size", [5 * 65536 - 100, 65536, 3000, 1, 0],
                         ids=["5-blocks", "1-block", "short", "1-byte",
                              "empty"])
def test_block_counts_that_do_not_divide(size):
    """5 blocks and 1 block over 4 shards, and empty input: every route
    and encode_blocks + assemble equal the unsharded encode; the
    zero-length padding blocks add no byte."""
    rng = np.random.default_rng(size)
    data = np.minimum(rng.geometric(0.3, size) - 1, 255).astype(np.uint8)
    want = tc.encode(data, device="cpu")
    assert want == jref.encode(data)
    enc = ShardedHzrEncoder(cpu_mesh(4))
    blocks, lengths = tc.split_blocks(data)
    assert enc.encode(data) == want
    assert tc.assemble_compact(*enc.encode_blocks_compact(blocks, lengths)) \
        == want
    flat = enc.encode_blocks_flat(blocks, lengths)
    assert flat is not None and tc.assemble_compact(*flat) == want
    packed, total_bits, is_fill = enc.encode_blocks(blocks, lengths)
    assert packed.shape[0] == total_bits.size == is_fill.size \
        == blocks.shape[0]
    assert tc.assemble(blocks, lengths, packed, total_bits, is_fill) == want


@pytest.mark.parametrize("k", [1, 4])
def test_out_capacity_as_unsharded(payload, k):
    """encode(data, cap) == torch_coder.encode(data, cap) == pyref's:
    the exact length, a cap that turns the last blocks into COPY, and a
    cap too small raises ValueError as they do."""
    data, want = payload
    data = np.concatenate([data[:200000],
                           np.random.default_rng(3).integers(
                               0, 256, 70000).astype(np.uint8)])
    enc = ShardedHzrEncoder(cpu_mesh(k))
    full = tc.encode(data, device="cpu")
    for cap in (len(full) + 5, len(full), len(full) - 1, 120000, 50):
        try:
            want_c = tc.encode(data, cap, device="cpu")
        except ValueError:
            with pytest.raises(ValueError, match="too small"):
                enc.encode(data, cap)
            with pytest.raises(ValueError):
                jref.encode(data, cap)
            continue
        assert enc.encode(data, cap) == want_c == jref.encode(data, cap)


def _ecg(rng, ch, n, scale=300.0):
    return np.cumsum(rng.normal(0, scale, (ch, n)), axis=1).astype(np.int32)


def _native(sig, bps):
    v = np.ascontiguousarray(sig.T).astype(np.uint32)
    return np.stack([(v >> np.uint32(8 * k)) & np.uint32(255)
                     for k in range(bps)], -1).astype(np.uint8).tobytes()


PACKERS = {
    # kind: (factory args after bps, ch, n), bps, ch, n
    "xdelta_hzr": ((3,), 4, 3, 30011),
    "hzr": ((), 3, 2, 40000),
    "hadamard": ((), 4, 3, 16384),
    "dct": ((), 3, 2, 1024),
}


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("kind", list(PACKERS))
def test_packers_with_encoder(kind, k):
    """Each packer with an encoder: the container equals the unsharded
    port's and rspt_tpu.packers.host's, and decompresses as theirs."""
    extra, bps, ch, n = PACKERS[kind]
    sig = _ecg(np.random.default_rng(7), ch, n)
    if kind == "xdelta_hzr":
        sig[1, 5000:25000] = 0            # FILL blocks among HUFF
    native = _native(sig, bps)
    make = getattr(gpack, "new_" + kind)
    p = make(bps, ch, n, *extra, device="cpu",
             encoder=ShardedHzrEncoder(cpu_mesh(k)))
    comp = p.compress(native)
    assert {"pass1", "shards", "assemble"} <= set(p.stage_seconds)
    assert comp == make(bps, ch, n, *extra, device="cpu").compress(native)
    host = getattr(hpack, "new_" + kind)(bps, ch, n, *extra)
    assert comp == host.compress(native)
    assert p.decompress(comp)[0] == host.decompress(comp)[0]


def test_compress_many_and_hints_with_encoder():
    """compress_many with an encoder (a batch larger than a wave, plane
    growth within it) equals the unsharded port's and a sequential run
    of the host packer's compress; compress_with_hints gives the same
    container and no hints."""
    rng = np.random.default_rng(11)
    ch, n = 3, 8000
    srcs = [_native(_ecg(rng, ch, n, s), 4) for s in (30, 30, 300, 3000,
                                                      30, 30000)]
    enc = ShardedHzrEncoder(cpu_mesh(3))
    p = gpack.new_xdelta_hzr(4, ch, n, 1, device="cpu", encoder=enc)
    q = gpack.new_xdelta_hzr(4, ch, n, 1, device="cpu")
    got = p.compress_many(srcs)
    assert got == q.compress_many(srcs)
    assert p.nr_planes == q.nr_planes > 1
    h = hpack.new_xdelta_hzr(4, ch, n, 1)
    assert got == [h.compress(s) for s in srcs]
    comp, hints = p.compress_with_hints(srcs[2])
    assert hints is None and comp == q.compress(srcs[2])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_decoder_matches_jax_sharded_decoder(dec_streams, k):
    """decode_many on k CPU shards == the JAX ShardedHzrDecoder's output
    == the payloads, and so does the hinted rerun (every tile 0 sweeps),
    which the first time is held against an unhinted decode."""
    streams, datas = dec_streams
    dec = ShardedHzrDecoder(cpu_mesh(k))
    outs, hints = dec.decode_many(streams, return_hints=True)
    assert outs == datas
    info = dec.decode_info
    assert len(info["blocks"]) == k and sum(info["blocks"]) \
        == info["device_blocks"] > 0 and not info["hinted"]
    assert info["cuts"] == pmesh.shard_cuts(
        [b[1] for b in gd.lane_rows([(h[1], h[2]) for h in gd._device_blocks(
            gd._walk_all(streams, light=True)[2])[0]])[1]], k)
    assert dec.decode_many(streams, hints=hints) == datas
    assert dec.decode_info["hinted"]
    assert all(f == 0 for fs in dec.decode_info["fp_iters"] for f in fs)
    assert dec.decode_many(streams, hints=False) == datas
    assert not dec.decode_info["hinted"]


@pytest.fixture()
def fresh_hints(monkeypatch):
    """An empty hint registry and validation state for one test."""
    monkeypatch.setattr(gd, "_hint_registry", type(gd._hint_registry)())
    monkeypatch.setattr(gd, "_validated_digests",
                        type(gd._validated_digests)())
    monkeypatch.setattr(gd, "_hints_disabled", False)


def test_hints_bind_the_shard_layout(dec_streams, fresh_hints):
    """A hint from a 4-shard decode is refused by a 2-shard decoder and
    by the unsharded one (their fixpoints run), and theirs by it; the
    bytes stay right. (The registry, which would hand each decoder its
    own earlier hints, is emptied first.)"""
    streams, datas = dec_streams
    d4, d2 = ShardedHzrDecoder(cpu_mesh(4)), ShardedHzrDecoder(cpu_mesh(2))
    _, h4 = d4.decode_many(streams, return_hints=True)
    _, h2 = d2.decode_many(streams, return_hints=True)
    assert h4.digest != h2.digest
    gd._hint_registry.clear()
    assert d2.decode_many(streams, hints=h4) == datas
    assert not d2.decode_info["hinted"]
    _, _, _, info = gd.decode_device(streams, "cpu", hints=h4)
    assert not info["hinted"]
    _, _, hu, _ = gd.decode_device(streams, "cpu", hints=False,
                                   return_hints=True)
    gd._hint_registry.clear()
    assert d4.decode_many(streams, hints=hu) == datas
    assert not d4.decode_info["hinted"]
    assert d4.decode_many(streams, hints=h4) == datas
    assert d4.decode_info["hinted"]


def test_decoder_edge_cases():
    """decode_many([]) gives ([], None) and []; streams with no HUFF
    block decode on the host; one HUFF block over 4 shards launches on
    one."""
    dec = ShardedHzrDecoder(cpu_mesh(4))
    assert dec.decode_many([], return_hints=True) == ([], None)
    assert dec.decode_many([]) == []
    rnd = np.random.default_rng(2).integers(0, 256, 9000).astype(np.uint8)
    plain = [jref.encode(rnd), jref.encode(np.zeros(100, np.uint8)),
             jref.encode(b"")]
    assert dec.decode_many(plain, return_hints=True) == (
        [rnd.tobytes(), bytes(100), b""], None)
    one = np.random.default_rng(3).integers(0, 5, 1000).astype(np.uint8)
    assert dec.decode_many([jref.encode(one)]) == [one.tobytes()]
    assert dec.decode_info["blocks"] == [0, 0, 0, 1]


def test_decode_span_is_a_slice_of_the_whole(dec_streams):
    """gpu_decoder.decode_span over the blocks of one stream, at that
    stream's output span and from zeros, gives that span's HUFF bytes of
    decode_device's output (zeros elsewhere)."""
    streams, datas = dec_streams
    spans, _, huff = gd._walk_all(streams, light=True)
    dev, _ = gd._device_blocks(huff)
    base, size = spans[1]
    part = [d for d in dev if base <= d[3] < base + size]
    res = gd.decode_span(part, base, size, "cpu")
    got = res.out.numpy()
    want = np.zeros(size, np.uint8)
    for d in part:
        lo = d[3] - base
        want[lo:lo + d[4]] = np.frombuffer(datas[1], np.uint8)[lo:lo + d[4]]
    np.testing.assert_array_equal(got, want)
    assert res.entry_out.shape == gd.lane_shape(part)
    assert set(res.times) == {"lanes", "kernel", "place"}


def _scan_input(rng, n):
    a = rng.integers(I32.min, I32.max, n, np.int64, endpoint=True).astype(
        np.int32)
    a[[0, 5, n // 2, n - 1]] = [I32.min, I32.max, I32.min, I32.max]
    return a


@pytest.fixture(scope="module")
def jax_scans():
    """8 x 4,096 words with INT32_MIN and INT32_MAX in them, and JAX's
    make_sharded_scans outputs on the 8-device mesh."""
    from rspt_tpu.parallel.mesh import make_mesh as jax_mesh
    from rspt_tpu.parallel.scans import make_sharded_scans as jax_scans
    a = _scan_input(np.random.default_rng(99), 8 * 4096)
    fns = jax_scans(jax_mesh())
    out = {name: np.asarray(fns[name](a)) for name in
           ("delta_encode", "xor_encode", "delta_decode", "xor_decode")}
    return a, out


@pytest.mark.parametrize("k", SHARDS)
def test_scans_match_jax_and_numpy(jax_scans, k):
    """Each sharded scan on k CPU shards == JAX's make_sharded_scans on 8
    devices == numpy_ops over the whole, and the round trips are exact."""
    a, jout = jax_scans
    fns = make_sharded_scans(cpu_mesh(k))
    parts = fns["shard"](a)
    assert len(parts) == k and all(p.dtype == torch.int32 for p in parts)
    want = {"delta_encode": nops.delta_encode(a),
            "xor_encode": nops.xor_encode(a),
            "delta_decode": nops.delta_decode(a),
            "xor_decode": nops.xor_decode(a)}
    for name, w in want.items():
        got = fns["gather"](fns[name](parts)).numpy()
        np.testing.assert_array_equal(got, w, err_msg=name)
        np.testing.assert_array_equal(got, jout[name], err_msg=name)
    enc = fns["xor_encode"](fns["delta_encode"](parts))
    back = fns["delta_decode"](fns["xor_decode"](enc))
    np.testing.assert_array_equal(fns["gather"](back).numpy(), a)


def test_scans_check_their_shards():
    """Shards of other lengths, dtypes or counts raise; a length that
    does not divide raises; empty shards pass through."""
    fns = make_sharded_scans(cpu_mesh(2))
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        fns["delta_encode"]([x, x[:3]])
    with pytest.raises(ValueError):
        fns["xor_decode"]([x, x.long()])
    with pytest.raises(ValueError):
        fns["delta_decode"]([x])
    with pytest.raises(ValueError):
        fns["shard"](np.zeros(7, np.int32))
    e = torch.zeros(0, dtype=torch.int32)
    assert [p.numel() for p in fns["xor_encode"]([e, e])] == [0, 0]


def test_make_mesh():
    """Devices named by the caller, a shard count over several
    processes, devices of one type only."""
    m = make_mesh(["cpu"] * 3)
    assert (m.local, m.size, m.world, m.rank, m.group) == (3, 3, 1, 0, None)
    assert list(m.shard_ids()) == [0, 1, 2]
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError):
        make_mesh(["cpu", "meta"])
    assert pmesh.pad_blocks(5, 4) == 8 and pmesh.pad_blocks(8, 4) == 8
    assert pmesh.shard_cuts([1, 1, 1, 1], 2) == [0, 1, 4]


# a worker of the two-process test: 2 CPU shards, rank and port from
# argv, its results written to argv[3]
GLOO_WORKER = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
from rspt_tpu_torch.hzr import torch_coder as tc
from rspt_tpu_torch.parallel import (ShardedHzrEncoder, make_mesh,
                                     make_sharded_scans)
mesh = make_mesh(["cpu"] * 2)
assert (mesh.size, mesh.rank, mesh.world) == (4, rank, 2)
rng = np.random.default_rng(42)
data = rng.integers(0, 60, 300000).astype(np.uint8)
enc = ShardedHzrEncoder(mesh)
blocks, lengths = tc.split_blocks(data)
fns = make_sharded_scans(mesh)
x = rng.integers(-2**31, 2**31, 4 * 4096).astype(np.int32)
x[:2] = [-2**31, 2**31 - 1]
parts = fns["shard"](x)
de = fns["delta_encode"](parts)
xe = fns["xor_encode"](de)
back = fns["delta_decode"](fns["xor_decode"](xe))
np.savez(path, stream=np.frombuffer(enc.encode(data), np.uint8),
         capped=np.frombuffer(enc.encode(data, 10 ** 6), np.uint8),
         flat=np.frombuffer(tc.assemble_compact(*enc.encode_blocks_flat(
             blocks, lengths)), np.uint8),
         compact=np.frombuffer(tc.assemble_compact(
             *enc.encode_blocks_compact(blocks, lengths)), np.uint8),
         x=x, de=fns["gather"](de).numpy(), xe=fns["gather"](xe).numpy(),
         back=fns["gather"](back).numpy())
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_two_processes(tmp_path):
    """Two gloo processes of 2 CPU shards each (4 shards): on both ranks
    the sharded encode (encode, with out_capacity, and both routes)
    equals pyref, and the scans (delta and xor, encode and decode) cross
    the processes exactly. Each worker has 120 s."""
    env = dict(os.environ, PYTHONPATH=REPO)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", GLOO_WORKER, str(r), str(port),
         str(tmp_path / f"rank{r}.npz")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    data = np.random.default_rng(42).integers(0, 60, 300000).astype(np.uint8)
    want = jref.encode(data)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key in ("stream", "capped", "flat", "compact"):
            assert got[key].tobytes() == want, (r, key)
        x = got["x"]
        np.testing.assert_array_equal(got["de"], nops.delta_encode(x))
        np.testing.assert_array_equal(got["xe"],
                                      nops.xor_encode(nops.delta_encode(x)))
        np.testing.assert_array_equal(got["back"], x)


def test_hint_cross_check_disables_bad_hints(dec_streams, fresh_hints):
    """Hints whose digest matches but whose entries are wrong: the first
    hinted decode's cross-check against the unhinted one catches them,
    disables hint trust and returns the fixpoint's bytes."""
    streams, datas = dec_streams
    dec = ShardedHzrDecoder(cpu_mesh(2))
    outs, h = dec.decode_many(streams, hints=False, return_hints=True)
    bad = gd.DecodeHints(h.digest, h.entries + 5 * (h.entries > 0))
    assert dec.decode_many(streams, hints=bad) == outs == datas
    assert gd._hints_disabled and not dec.decode_info["hinted"]
