"""Encode-time decode hints of the port (hzr/sidecar.py and
GpuXdeltaHzrPacker.compress_with_hints) on the CPU, mirroring
tests/test_sidecar.py: the container is unchanged by hints; the hints
are trusted by the port's decoder (one sweep, 0 fixpoint iterations)
and the decode is exact; the entries equal the decoder's converged
entries on every active lane and the JAX packer's entries where both
lane layouts agree (no COPY block, no host-routed block); a stale
digest falls back to the fixpoint and stays exact.

Tolerance 0 throughout (byte format, integer entries). The JAX side
runs once per module (interpret mode is slow).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.formats.hzr_constants import (  # noqa: E402
    ENCODING_COPY, ENCODING_HUFF_RLE)
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import PACK_FLAT_JAX_CASES  # noqa: E402

CH, N, BPS, PLANES = 2, 40000, 4, 3


def _native(rng, ch, n, amp):
    sig = np.cumsum(rng.normal(0, amp, (ch, n)), axis=1).astype(np.int32)
    return np.ascontiguousarray(sig.T).astype("<i4").tobytes()


@pytest.fixture(scope="module")
def jax_case():
    """A payload whose blocks are all HUFF (no COPY, no host routing in
    the JAX decoder) through the JAX packer's compress_with_hints."""
    native = _native(np.random.default_rng(21), CH, N, 14.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RSPT_FUSED_PASS1", "interp")
        from rspt_tpu.hzr import jax_coder
        mp.setattr(jax_coder, "_PACK_MODE", "interp")
        from rspt_tpu.packers import tpu as tpack
        p = tpack.new_xdelta_hzr(BPS, CH, N, PLANES, device_decode=True)
        comp, hints = p.compress_with_hints(native)
    assert hints is not None
    return native, comp, hints


@pytest.fixture()
def fresh_registry():
    gd._hint_registry.clear()
    gd._validated_digests.clear()
    yield
    gd._hint_registry.clear()


def _port(planes=PLANES, ch=CH, n=N):
    return gpack.new_xdelta_hzr(BPS, ch, n, planes, device="cpu",
                                device_decode=True)


def _segend(p, comp):
    """Segment ends of the decoder's lanes for a container's streams."""
    _, streams, _ = p._streams(comp, p.nr_planes, 0)
    _, _, huff = gd._walk_all(streams)
    blocks, _ = gd._device_blocks(huff)
    return gd.lane_arrays(blocks).segend


def test_container_unchanged_by_hints(jax_case, fresh_registry):
    native, jax_comp, _ = jax_case
    p = _port()
    comp, hints = p.compress_with_hints(native)
    assert comp == p.compress(native) == jax_comp
    assert hints is not None and hints.entries.size > 0


def test_hints_trusted_and_exact(jax_case, fresh_registry):
    """decompress_many([comp], hints=h): trusted, 0 fixpoint sweeps in
    every tile, exact; the first hinted decode was cross-checked."""
    native = jax_case[0]
    p = _port()
    comp, hints = p.compress_with_hints(native)
    gd._hint_registry.clear()
    assert p.decompress_many([comp], hints=hints) == [native]
    assert p.decode_info["hinted"]
    assert p.decode_info["fp_iters"] and max(p.decode_info["fp_iters"]) == 0
    assert hints.digest in gd._validated_digests
    assert not gd._hints_disabled


def test_entries_equal_converged_and_jax(jax_case, fresh_registry):
    """The entries equal the unhinted decode's converged entries on every
    active lane (entry < segment end) and the JAX entries everywhere
    (same lanes: every block HUFF and device-decoded in both); the
    digests differ by design (LAYOUT_VERSION)."""
    native, _, jax_hints = jax_case
    p = _port()
    comp, hints = p.compress_with_hints(native)
    outs, dec = p.decompress_many([comp], hints=False, return_hints=True)
    assert outs == [native] and max(p.decode_info["fp_iters"]) > 0
    assert dec.digest == hints.digest
    active = hints.entries < _segend(p, comp)
    assert active.sum() > 100
    np.testing.assert_array_equal(hints.entries[active],
                                  dec.entries[active])
    np.testing.assert_array_equal(hints.entries, jax_hints.entries)


def test_stale_digest_falls_back(fresh_registry):
    """Hints of another payload, or with a wrong digest, are not
    trusted: the fixpoint runs and the decode stays exact."""
    a = _native(np.random.default_rng(5), CH, 30000, 18.0)
    b = _native(np.random.default_rng(6), CH, 30000, 18.0)
    p = _port(n=30000)
    comp_a, hints_a = p.compress_with_hints(a)
    comp_b = _port(n=30000).compress(b)
    gd._hint_registry.clear()
    assert p.decompress_many([comp_b], hints=hints_a) == [b]
    assert not p.decode_info["hinted"]
    bad = gd.DecodeHints(hints_a.digest ^ 1, hints_a.entries)
    assert p.decompress_many([comp_a], hints=bad) == [a]
    assert not p.decode_info["hinted"]
    assert max(p.decode_info["fp_iters"]) > 0


def test_sub_block_payload(fresh_registry):
    """One block a plane, few segments: hints trusted, exact."""
    native = _native(np.random.default_rng(9), 1, 9000, 9.0)
    p = _port(planes=2, ch=1, n=9000)
    comp, hints = p.compress_with_hints(native)
    assert p.decompress(comp)[0] == native
    gd._hint_registry.clear()
    assert p.decompress_many([comp], hints=hints) == [native]
    assert p.decode_info["hinted"] and max(p.decode_info["fp_iters"]) == 0


def test_copy_blocks_give_hints(fresh_registry):
    """A payload with COPY blocks (an incompressible plane 0) still gets
    hints for its HUFF blocks; they are trusted."""
    rng = np.random.default_rng(11)
    ch, n = 2, 30000
    sig = (rng.integers(-(1 << 7), 1 << 7, (ch, n))
           + np.cumsum(rng.normal(0, 3, (ch, n)), 1).astype(np.int64) * 256)
    native = np.ascontiguousarray(sig.astype(np.int32).T).astype(
        "<i4").tobytes()
    p = _port(planes=4, ch=ch, n=n)
    comp, hints = p.compress_with_hints(native)
    _, streams, _ = p._streams(comp, p.nr_planes, 0)
    modes = {s[4 + 6] for s in streams}      # each plane's first block
    assert {ENCODING_COPY, ENCODING_HUFF_RLE} <= modes
    assert hints is not None
    gd._hint_registry.clear()
    assert p.decompress_many([comp], hints=hints) == [native]
    assert p.decode_info["hinted"] and max(p.decode_info["fp_iters"]) == 0


def test_lanes_mode_words_unchanged(rng):
    """pack_flat_lanes writes the same payload words as pack_flat, and
    its entry lanes keep the init plane where no token start lands."""
    enc, _ = ck.xdelta_swizzle(torch.from_numpy(np.frombuffer(
        _native(rng, 2, 20000, 40.0), "<i4").copy()), 20000, 2, 3, 4)
    tokw, _, hist = ck.tokenize_planes(enc, 3)
    _, lengths = tc.block_layout(enc.numel(), 3)
    plan = tc.flat_plan(hist.numpy(), lengths)
    from rspt_tpu_torch.hzr import sidecar
    hp = sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                            plan.comp_len > 0)
    bases = torch.from_numpy(plan.bases)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    args = (tokc, bases, torch.from_numpy(plan.ntok),
            torch.from_numpy(plan.bit0), torch.from_numpy(plan.lut),
            plan.nwords)
    words, entries = ck.pack_flat_lanes(*args, torch.from_numpy(hp.meta),
                                        torch.from_numpy(hp.init))
    assert torch.equal(words, ck.pack_flat(*args))
    changed = entries.numpy() != hp.init
    assert changed.sum() > 0
    assert (entries.numpy()[~changed] == hp.init[~changed]).all()


@pytest.mark.parametrize("case", PACK_FLAT_JAX_CASES)
def test_lanes_tile_edges_vs_jax(case):
    """pack_flat_lanes' plain version on tests/test_torch_cuda.py's
    pack_flat_edge_batch (segment boundaries crossed by a tile's first
    token and by a block's last token, which writes no entry; blocks of
    2, 2,047-2,049 and several 2,048-token tiles; COPY/FILL/empty blocks
    between; a block cut to one token, nwords one word short, tokc cut
    inside a block) against the JAX hints, K10 + K11 through
    jax_coder.pack_tokens_flat2 on the same tokens and lanes (the cut
    ones made invalid): the entries where a store lands and the init
    plane elsewhere, and the payload bytes; tolerance 0."""
    from test_torch_kernels import jax_pack_flat2, pack_flat_edges
    x = pack_flat_edges(case)
    plan = x["plan"]
    meta, init = (t.numpy() for t in x["lanes"])
    words, entries = ck.pack_flat_lanes(*x["plain_args"], *x["lanes"])
    g2b = plan.g2b
    gmeta = np.stack([(np.arange(g2b.size) == plan.gfirst), meta[g2b, 0],
                      meta[g2b, 1] + 1, meta[g2b, 2]], 1).astype(np.int32)
    nrows = init.size // 128
    jw, raw = jax_pack_flat2(x["jax_tokw"], plan, gmeta, nrows + 32)
    raw = np.asarray(raw)[:nrows].reshape(-1)
    want = np.where(raw > 0, raw, init)
    assert (want != init).sum() > 200
    np.testing.assert_array_equal(entries.numpy(), want)
    nbytes = min(plan.total_payload, 4 * words.numel())
    np.testing.assert_array_equal(
        words.numpy().view(np.uint8)[:nbytes],
        np.asarray(jw).reshape(-1).view(np.uint8)[:nbytes])
