"""GpuXdeltaHzrPacker(device="cpu") — the port's packer on the kernels'
plain versions — against the JAX packer (Pallas in interpret mode) and
the host packer: containers byte-identical, round trips exact
(tolerance 0 throughout: the containers are a byte format).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402


@pytest.fixture()
def tpack(monkeypatch):
    """rspt_tpu.packers.tpu with its fused pass 1 and flat pack in
    interpret mode (as tests/test_pallas.py runs them)."""
    monkeypatch.setenv("RSPT_FUSED_PASS1", "interp")
    from rspt_tpu.hzr import jax_coder
    monkeypatch.setattr(jax_coder, "_PACK_MODE", "interp")
    from rspt_tpu.packers import tpu
    return tpu


def _native(sig, bps):
    return np.ascontiguousarray(sig.T).astype(f"<i{bps}").tobytes()


def _check_all(tpack, native, bps, ch, n, planes):
    """Port == JAX == host, with exact round trips and equal growth."""
    pg = gpack.new_xdelta_hzr(bps, ch, n, planes, device="cpu")
    pt = tpack.new_xdelta_hzr(bps, ch, n, planes)
    ph = hpack.new_xdelta_hzr(bps, ch, n, planes)
    comp = pg.compress(native)
    assert comp == pt.compress(native)
    assert comp == ph.compress(native)
    assert pg.nr_planes == pt.nr_planes == ph.nr_planes
    out, used = pg.decompress(comp)
    assert out == native and used == len(comp)
    return pg, comp


def test_fill_and_copy_planes(rng, tpack):
    """FILL planes (constant after xdelta) and an incompressible COPY
    plane, which JAX sends down its per-block path and the port packs
    on its one flat path (cases of test_flat_pack_fill_and_copy_routing)."""
    ch, n = 2, 19000
    sig = rng.normal(0, 2, (ch, n)).astype(np.int32)
    _check_all(tpack, _native(sig, 4), 4, ch, n, 3)
    ch2, n2 = 2, 17011
    sig2 = rng.integers(-(1 << 23), 1 << 23, (ch2, n2)).astype(np.int32)
    _check_all(tpack, _native(sig2, 4), 4, ch2, n2, 4)


@pytest.mark.parametrize("ch,n,bps,planes,sigma", [
    (1, 70001, 4, 2, 900.0),    # multi-block single channel
    (5, 13000, 4, 3, 3.0),      # tiny amplitude (FILL planes)
    (2, 33333, 4, 4, 2e6),      # wide dynamic range
    (3, 8192, 2, 2, 120.0),     # 16-bit samples
    (7, 11111, 4, 1, 0.4),      # 1 plane, near-constant
])
def test_fuzz_shapes(rng, tpack, ch, n, bps, planes, sigma):
    """The cases of test_flat_pack_fuzz_shapes."""
    sig = np.cumsum(rng.normal(0, sigma, (ch, n)), axis=1).astype(np.int32)
    if bps < 4:
        sig >>= 16
    _check_all(tpack, _native(sig, bps), bps, ch, n, planes)


def test_bps3_samples(rng, tpack):
    """24-bit samples through the u8 native_to_i32 path."""
    from conftest import make_ecg_like, to_native
    sig = make_ecg_like(rng, 3, 9000, 300.0, 24)
    _check_all(tpack, to_native(sig, 3), 3, 3, 9000, 3)


def test_plane_growth(rng, tpack):
    """1 plane does not fit the xdelta values, 2 do: every packer grows
    to 2, and the grown count persists into the next call."""
    ch, n = 2, 9000
    sig = np.cumsum(rng.normal(0, 30, (ch, n)), axis=1).astype(np.int32)
    native = _native(sig, 4)
    pg, _ = _check_all(tpack, native, 4, ch, n, 1)
    assert pg.nr_planes == 2
    quiet = np.zeros((ch, n), np.int32)
    comp = pg.compress(_native(quiet, 4))
    assert pg.nr_planes == 2
    assert comp == hpack.new_xdelta_hzr(4, ch, n, 2).compress(
        _native(quiet, 4))


def test_zero_run_longer_than_cap(rng, tpack):
    """A constant stretch gives an xdelta zero run > 16,662 in every
    plane, cut at the cap."""
    ch, n = 1, 40000
    sig = np.full((ch, n), 12345, np.int32)
    sig[0, 30000:] += np.cumsum(rng.integers(-9, 9, n - 30000)).astype(
        np.int32)
    _check_all(tpack, _native(sig, 4), 4, ch, n, 3)


def test_device_decode_matches_jax_device_decode(rng, tpack, monkeypatch):
    """decompress(device_decode=True) on the plain versions equals the JAX
    packer's device decode (pallas_decoder in interpret mode) and the
    input; decompress_many equals sequential decompress, with a payload
    that made the packer grow its plane count."""
    monkeypatch.setenv("RSPT_DECODER", "interp")
    ch, n = 4, 5000
    sig = np.cumsum(rng.normal(0, 300, (ch, n)), axis=1).astype(np.int32)
    native = _native(sig, 4)
    pg = gpack.new_xdelta_hzr(4, ch, n, 3, device="cpu", device_decode=True)
    comp = pg.compress(native)
    out, used = pg.decompress(comp)
    assert out == native and used == len(comp)
    assert set(pg.stage_seconds) == {"walk_luts", "kernel", "place",
                                     "postprocess"}
    pt = tpack.new_xdelta_hzr(4, ch, n, 3, device_decode=True)
    assert pt.decompress(comp)[0] == out

    # a packer that starts at 1 plane grows on the first payload
    grow = gpack.new_xdelta_hzr(4, ch, n, 1, device="cpu", device_decode=True)
    quiet = (sig // 97).astype(np.int32)
    comps = [grow.compress(_native(s, 4)) for s in (sig, quiet, sig[::-1])]
    assert grow.nr_planes == 2
    seq = [grow.decompress(c)[0] for c in comps]
    assert seq == [_native(s, 4) for s in (sig, quiet, sig[::-1])]
    assert grow.decompress_many(comps) == seq
    outs, hints = grow.decompress_many(comps, return_hints=True)
    assert outs == seq and hints is not None
    assert grow.decompress_many(comps, hints=hints) == seq
    host = gpack.new_xdelta_hzr(4, ch, n, 2, device="cpu")
    assert host.decompress_many(comps) == seq
    assert host.decompress_many(comps, return_hints=True) == (seq, None)


def _native_small(vals, bps):
    v = np.asarray(vals, np.int64)
    return np.stack([(v >> (8 * k)) & 255 for k in range(bps)],
                    -1).astype(np.uint8).tobytes()


@pytest.mark.parametrize("bps,vals,planes,size", [
    (1, [-1, -1], 1, 18),
    (2, [0, 32767, -32768, 0], 2, 39),
    (3, [0, 2 ** 23 - 1, -2 ** 23, 0], 3, 58)])
def test_small_bps_growth_follows_reference(bps, vals, planes, size):
    """At bps < 4 the planes grow only when they would not give back the
    native samples (the reference's compress, decompress and compare,
    which the host packer simulates): the port's container, plane count
    and size equal the host packer's, from 1 plane; exact round trip."""
    native = _native_small(vals, bps)
    pg = gpack.new_xdelta_hzr(bps, 1, len(vals), 1, device="cpu")
    ph = hpack.new_xdelta_hzr(bps, 1, len(vals), 1)
    comp = pg.compress(native)
    assert comp == ph.compress(native)
    assert pg.nr_planes == ph.nr_planes == planes and len(comp) == size
    assert pg.decompress(comp) == (native, len(comp))


@pytest.mark.parametrize("bps", [2, 3])
def test_small_bps_random_growth(rng, bps):
    """A random walk at bps 2 or 3 from 1 plane: the port grows as the
    host packer does (to bps planes), the containers are equal and round
    trip exactly, and the grown count persists."""
    ch, n = 2, 3000
    lim = 1 << (8 * bps - 1)
    sig = np.clip(np.cumsum(rng.normal(0, 0.01 * lim, (ch, n)), axis=1),
                  -lim, lim - 1).astype(np.int64)
    native = _native_small(sig.T.reshape(-1), bps)
    pg = gpack.new_xdelta_hzr(bps, ch, n, 1, device="cpu")
    ph = hpack.new_xdelta_hzr(bps, ch, n, 1)
    comp = pg.compress(native)
    assert comp == ph.compress(native)
    assert pg.nr_planes == ph.nr_planes == bps
    assert pg.decompress(comp)[0] == native
    quiet = _native_small(np.zeros(ch * n, np.int64), bps)
    assert pg.compress(quiet) == hpack.new_xdelta_hzr(
        bps, ch, n, bps).compress(quiet)
    assert pg.nr_planes == bps


@pytest.mark.parametrize("bps", [1, 2, 3])
def test_small_bps_pass1_is_one_call(rng, tpack, monkeypatch, bps):
    """At bps < 4 each pass 1 hands the native bytes to one xdelta_swizzle
    call (no native_to_i32 before it): a smooth walk at bps planes gives
    the host packer's container in one call, and the JAX packer's at bps
    2-3 (at bps 1 the JAX packer grows wherever a value does not fit one
    signed byte: F1); a rough walk from 1 plane grows as the host packer
    does, one call a plane count."""
    from rspt_tpu_torch.packers import gpu
    calls = []
    real = gpu.ck.xdelta_swizzle

    def spy(x, *args, **kw):
        calls.append(x.dtype)
        return real(x, *args, **kw)

    monkeypatch.setattr(gpu.ck, "xdelta_swizzle", spy)
    ch, n = 3, 3001
    lim = 1 << (8 * bps - 1)
    walk = np.cumsum(rng.normal(0, 0.002 * lim + 0.3, (ch, n)), axis=1)
    smooth = np.clip(walk, -lim, lim - 1).astype(np.int64)
    native = _native_small(smooth.T.reshape(-1), bps)
    if bps > 1:
        _check_all(tpack, native, bps, ch, n, bps)
    else:
        pg = gpack.new_xdelta_hzr(bps, ch, n, bps, device="cpu")
        comp = pg.compress(native)
        assert comp == hpack.new_xdelta_hzr(bps, ch, n, bps).compress(native)
        assert pg.decompress(comp)[0] == native
    assert calls == [torch.uint8]
    if bps == 1:
        return
    calls.clear()
    rough = np.clip(np.cumsum(rng.normal(0, 0.01 * lim, (ch, n)), axis=1),
                    -lim, lim - 1).astype(np.int64)
    native = _native_small(rough.T.reshape(-1), bps)
    pg = gpack.new_xdelta_hzr(bps, ch, n, 1, device="cpu")
    comp = pg.compress(native)
    assert comp == hpack.new_xdelta_hzr(bps, ch, n, 1).compress(native)
    assert pg.nr_planes == bps and pg.decompress(comp)[0] == native
    assert calls == [torch.uint8] * bps


@pytest.mark.parametrize("device_decode", [False, True])
def test_decompress_many_empty(device_decode):
    """decompress_many of no containers: [] alone, ([], None) with
    return_hints, on both decode paths (the reference's device branch
    returns a bare [] there, which breaks callers that unpack the
    pair)."""
    p = gpack.new_xdelta_hzr(4, 2, 100, 3, device="cpu",
                             device_decode=device_decode)
    assert p.decompress_many([]) == []
    assert p.decompress_many([], return_hints=True) == ([], None)
