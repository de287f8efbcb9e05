"""The port's batched serving path on the CPU (kernels' plain versions):
GpuXdeltaHzrPacker.compress_many against sequential compress on one
packer, the host packer, and at bps 4 the JAX packer's compress_many
(Pallas in interpret mode); xdelta_swizzle_batch and the 2-D
tokenize_planes against the JAX vmapped K1 and the batched K2.

Containers are a byte format and the kernels' outputs integer words:
every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.ops import jax_ops as jops  # noqa: E402
from rspt_tpu.ops import pallas_kernels as pk  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import native_bytes, xdelta_batch  # noqa: E402

CH, NS = 3, 4096


@pytest.fixture()
def tpack(monkeypatch):
    """rspt_tpu.packers.tpu with its fused pass 1 and flat pack in
    interpret mode (as tests/test_torch_packer.py runs them)."""
    monkeypatch.setenv("RSPT_FUSED_PASS1", "interp")
    from rspt_tpu.hzr import jax_coder
    monkeypatch.setattr(jax_coder, "_PACK_MODE", "interp")
    from rspt_tpu.packers import tpu
    return tpu


def _native(sig, bps):
    return native_bytes(np.ascontiguousarray(sig.T), bps).tobytes()


@pytest.fixture(scope="module")
def payloads():
    """8 ECG-like random walks of growing amplitude (3 planes fit all)."""
    rng = np.random.default_rng(1234)
    return [_native(np.cumsum(rng.normal(0, 300 * (k + 1), (CH, NS)),
                              axis=1).astype(np.int32), 4)
            for k in range(8)]


def _sequential(make, srcs):
    p = make()
    return [p.compress(s) for s in srcs], p.nr_planes


def _check_batch(srcs, bps, ch, ns, planes, tpack=None):
    """compress_many == sequential port compress == sequential host
    compress (== JAX compress_many), equal plane counts after, exact
    round trips at each container's plane count. Returns the packer."""
    pb = gpack.new_xdelta_hzr(bps, ch, ns, planes, device="cpu")
    got = pb.compress_many(srcs)
    want, n_seq = _sequential(lambda: gpack.new_xdelta_hzr(
        bps, ch, ns, planes, device="cpu"), srcs)
    host, n_host = _sequential(lambda: hpack.new_xdelta_hzr(
        bps, ch, ns, planes), srcs)
    assert got == want == host
    assert pb.nr_planes == n_seq == n_host
    if tpack is not None:
        pt = tpack.new_xdelta_hzr(bps, ch, ns, planes)
        assert got == pt.compress_many(srcs)
        assert pt.nr_planes == pb.nr_planes
    return pb, got


@pytest.mark.parametrize("batch", [0, 1, 4, 8])
def test_compress_many_matches_sequential_host_and_jax(payloads, tpack,
                                                       batch):
    """Batches 0, 1, 4 and 8 (two pipelined waves) at bps 4: equal to
    sequential compress, the host packer and the JAX compress_many."""
    srcs = payloads[:batch]
    pb, got = _check_batch(srcs, 4, CH, NS, 3, tpack)
    assert pb.nr_planes == 3
    dec = gpack.new_xdelta_hzr(4, CH, NS, 3, device="cpu")
    assert [dec.decompress(c)[0] for c in got] == srcs
    if batch == 0:
        assert got == [] and pb.stage_seconds == {}


def test_mixed_plane_growth(rng, tpack):
    """test_batch_mixed_plane_growth's [fits, needs4, fits]: planes 3, 4,
    4 as a sequential run gives them, equal to host and JAX."""
    ch, n = 2, 4096
    small = np.cumsum(rng.normal(0, 200, (ch, n)), axis=1).astype(np.int32)
    big = np.zeros((ch, n), np.int32)
    big[:, 1::2] = 2 ** 24
    fits, needs4 = _native(small, 4), _native(big, 4)
    srcs = [fits, needs4, fits]
    pb, got = _check_batch(srcs, 4, ch, n, 3, tpack)
    assert pb.nr_planes == 4
    for s, comp, planes in zip(srcs, got, (3, 4, 4)):
        assert gpack.new_xdelta_hzr(4, ch, n, planes,
                                    device="cpu").decompress(comp)[0] == s


@pytest.mark.parametrize("bps,planes,grown", [(2, 1, 2), (3, 2, 3)])
def test_small_bps_growth_follows_reference(bps, planes, grown):
    """At bps < 4 a batch whose middle payloads need one plane more grows
    by the reference's rule (the host packer's, F1), over two pipelined
    waves; the JAX packer's rule differs here and is not compared."""
    rng = np.random.default_rng(7)
    ch, n = 2, 3000
    lim = 1 << (8 * bps - 1)
    quiet = rng.integers(-20, 20, (ch, n)).astype(np.int32)
    loud = rng.integers(-lim, lim, (ch, n)).astype(np.int32)
    srcs = [_native(s, bps) for s in
            (quiet, quiet, loud, quiet, loud, quiet, quiet)]
    pb, _ = _check_batch(srcs, bps, ch, n, planes)
    assert pb.nr_planes == grown


def test_copy_blocks_in_pipelined_waves(rng):
    """Payloads with an incompressible (COPY) plane block in both waves of
    a batch of 9 (waves of 4, 4, 1), beside compressible ones."""
    ch, n = 2, 17011
    rand = [_native(rng.integers(-(1 << 23), 1 << 23, (ch, n))
                    .astype(np.int32), 4) for _ in range(2)]
    walk = [_native(np.cumsum(rng.normal(0, 900, (ch, n)), axis=1)
                    .astype(np.int32), 4) for _ in range(3)]
    srcs = [walk[0], rand[0], walk[1], walk[2], walk[0], rand[1], walk[1],
            walk[2], rand[0]]
    pb, got = _check_batch(srcs, 4, ch, n, 4)
    assert pb.stage_seconds.keys() == {"pass1", "tables", "pack", "wait",
                                       "assemble"}
    dec = gpack.new_xdelta_hzr(4, ch, n, 4, device="cpu")
    assert [dec.decompress(c)[0] for c in got] == srcs
    # the random payloads' containers hold COPY blocks
    hist = ck.tokenize_planes(ck.xdelta_swizzle(
        torch.from_numpy(np.frombuffer(rand[0], "<i4").copy()), n, ch, 4,
        4)[0], 4)[2].numpy()
    _, lengths = tc.block_layout(ch * n, 4)
    assert tc.flat_plan(hist, lengths).is_copy.any()


def test_compress_many_launches_per_level_and_wave(payloads, monkeypatch):
    """One xdelta_swizzle_batch and one tokenize_planes call for each plane
    count probed; one compact_tokens and one pack_flat for each wave of 4
    payloads (8 payloads from 1 plane: 3 levels probed, 2 waves)."""
    calls = dict.fromkeys(("xdelta_swizzle_batch", "tokenize_planes",
                           "compact_tokens", "pack_flat", "xdelta_swizzle"),
                          0)
    for name in calls:
        real = getattr(ck, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ck, name, spy)
    pb = gpack.new_xdelta_hzr(4, CH, NS, 1, device="cpu")
    pb.compress_many(payloads)
    assert pb.nr_planes == 3
    assert calls == {"xdelta_swizzle_batch": 3, "tokenize_planes": 3,
                     "compact_tokens": 2, "pack_flat": 2,
                     "xdelta_swizzle": 0}


def test_entropy_streams_pipelined_matches_one_call(payloads):
    """The pipelined entropy stage over 5 payloads (waves of 4 and 1)
    gives entropy_streams' streams over the whole batch, stage times
    summed over the waves."""
    raw = torch.from_numpy(np.stack([np.frombuffer(s, "<i4")
                                     for s in payloads[:5]]))
    enc, _ = ck.xdelta_swizzle_batch(raw, NS, CH, 3, 4)
    tokw, bwords, hist = ck.tokenize_planes(enc, 3)
    times = {}
    got = tc.entropy_streams_pipelined(tokw, bwords, hist.numpy(), CH * NS,
                                       5, 3, times)
    want, _ = tc.entropy_streams(tokw, bwords, hist.numpy(), CH * NS, 15, {})
    assert got == want and len(got) == 15
    assert times.keys() == {"tables", "pack", "wait", "assemble"}


# -- the batched kernels against JAX -------------------------------------------

@pytest.mark.parametrize("bps", [4, 3])
def test_xdelta_swizzle_batch_vs_jax_vmap(bps):
    """xdelta_swizzle_batch's plain version against the vmapped
    native_to_i32 + xdelta_preprocess_pallas (interpret) of
    packers/tpu.py:_pass1_xdelta_batch, at a batch of 3 whose payloads
    (12 x 1,000) end inside a 272-sample tile; each payload's chain
    starts fresh. The flags at bps 4 equal JAX's (the rules agree
    there)."""
    x, ns, ch, planes = xdelta_batch(np.random.default_rng(31), bps, 3,
                                     1000, 12)
    enc, ok = ck.xdelta_swizzle_batch(torch.from_numpy(x), ns, ch, planes,
                                      bps)

    def pre(raw):
        e = jops.native_to_i32(raw, ns, ch, bps).reshape(-1)
        e = pk.xdelta_preprocess_pallas(e, interpret=True)
        sh = jnp.int32(32 - 8 * planes)
        return e, jnp.all(jnp.right_shift(jnp.left_shift(e, sh), sh) == e)

    j_enc, j_ok = jax.vmap(pre)(jnp.asarray(x))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(j_enc))
    if bps == 4:
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.tolist() == [1, 0, 1]
    for b in range(3):
        e1, ok1 = ck.xdelta_swizzle_plain(torch.from_numpy(x[b]), ns, ch,
                                          planes, bps, True)
        assert torch.equal(enc[b], e1) and int(ok[b]) == int(ok1)


def test_tokenize_planes_2d_vs_jax_batch():
    """The 2-D tokenize_planes (payload-major, then plane-major rows)
    against tokenize_planes_pallas's batched form (interpret) and
    hist_from_tokw, at a batch of 3 payloads of 70,000 words (two slabs a
    plane, the second short)."""
    from rspt_tpu.hzr import jax_coder
    rng = np.random.default_rng(32)
    n = 70000
    x = rng.integers(-(1 << 12), 1 << 12, (3, n)).astype(np.int32)
    x[rng.random((3, n)) < 0.6] = 0
    x[1, :20000] = 0
    tokw, bwords, hist = ck.tokenize_planes(torch.from_numpy(x), 2)
    jt, jb = pk.tokenize_planes_pallas(jnp.asarray(x), 2, n, interpret=True)
    assert tokw.shape == (12, 65536) and bwords.shape == (12, 16384)
    np.testing.assert_array_equal(tokw.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bwords.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(jax_coder.hist_from_tokw(jt)))
    for b in range(3):
        one = ck.tokenize_planes(torch.from_numpy(x[b]), 2)
        for got, want in zip((tokw, bwords, hist), one):
            assert torch.equal(got[4 * b:4 * b + 4], want)


def test_batch_wrappers_validate_inputs():
    """Wrong dtype or shape raises before any kernel work."""
    x = torch.zeros((2, 12), dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.xdelta_swizzle_batch(x, 4, 3, 1, 2)       # words need bps 4
    with pytest.raises(ValueError):
        ck.xdelta_swizzle_batch(x.reshape(-1), 4, 3, 1, 4)
    with pytest.raises(TypeError):
        ck.xdelta_swizzle_batch(x.to(torch.int64), 4, 3, 1, 4)
    with pytest.raises(ValueError):
        ck.tokenize_planes(torch.zeros((2, 3, 4), dtype=torch.int32), 1)
    assert ck.xdelta_swizzle_batch(x, 4, 3, 1, 4)[0].shape == (2, 12)
    with pytest.raises(ValueError, match="every payload"):
        gpack.new_xdelta_hzr(4, 3, 4, 1, device="cpu").compress_many(
            [bytes(48), bytes(40)])
