"""The port's kernels, by their plain PyTorch versions (the wrappers take
them for CPU tensors), against the Pallas kernels they replace, run in
interpret mode on the CPU.

All outputs are integer words, so every comparison is bit-exact
(tolerance 0). Inputs are made with numpy from a seed. Shapes stay at
one or two 64 KiB slabs a plane: interpret-mode tokenize is slow.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.hzr import jax_coder  # noqa: E402
from rspt_tpu.ops import jax_ops as jops  # noqa: E402
from rspt_tpu.ops import pallas_kernels as pk  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import TOKENIZE_EDGE_CASES, tokenize_edge_batch  # noqa: E402,E501
from test_torch_cuda import (XDELTA_EDGE_CASES, _extreme_signal,  # noqa: E402,E501
                             native_bytes, xdelta_edge_batch)
from test_torch_cuda import (PACK_FLAT_EDGE_CASES, PACK_FLAT_JAX_CASES,  # noqa: E402,E501
                             check_pack_flat_edges_covered,
                             pack_flat_edge_batch, pack_flat_edges_covered)

B = 65536


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _runs_signal(rng, n, zero_frac=0.6, amp=2 ** 23):
    """int32 signal with long zero runs: one > MAX_ZERO_RUN at the start,
    and a stretch of one repeated literal."""
    x = rng.integers(-amp, amp, n, dtype=np.int64)
    x[rng.random(n) < zero_frac] = 0
    x[:min(n, 17000)] = 0
    if n > 30000:
        x[25000:29000] = 0x01010101 * 9
    return x.astype(np.int32)


def _ecg_words(rng, ch, ns, scale):
    sig = np.cumsum(rng.normal(0, scale, (ch, ns)), axis=1).astype(np.int32)
    return np.ascontiguousarray(sig.T).reshape(-1)


@pytest.mark.parametrize("planes", [1, 3])
def test_xdelta_swizzle_vs_pallas(rng, planes):
    """K1 xdelta_preprocess_pallas on the native_to_i32 layout, and the
    verify flag of packers/tpu.py:169-174; tolerance 0."""
    ch, ns = 3, 5001
    words = _ecg_words(rng, ch, ns, 3000.0)
    words[:4] = [2 ** 31 - 1, -(2 ** 31), -1, 0]
    enc, ok = ck.xdelta_swizzle(_t(words), ns, ch, planes, 4)
    flat = jops.native_to_i32(jnp.asarray(words), ns, ch, 4).reshape(-1)
    want = np.asarray(pk.xdelta_preprocess_pallas(flat, interpret=True))
    np.testing.assert_array_equal(enc.numpy(), want)
    sh = 32 - 8 * planes
    want_ok = planes == 4 or bool(((want << sh) >> sh == want).all())
    assert int(ok[0]) == int(want_ok)
    # channel-major input without the swizzle gives the same values
    enc2, ok2 = ck.xdelta_swizzle(_t(np.asarray(flat)), ns, ch, planes, 4,
                                  swizzle=False)
    assert torch.equal(enc2, enc) and torch.equal(ok2, ok)


def _xdelta_jax(x, ns, ch, bps, swizzle):
    """The reference's pass 1: jax_ops.native_to_i32 (of the native bytes
    or the '<i4' words) then xdelta_preprocess_pallas in interpret mode."""
    if swizzle:
        flat = jops.native_to_i32(jnp.asarray(x), ns, ch,
                                  bps if x.dtype == np.uint8 else 4)
    else:
        flat = jnp.asarray(x[:ns * ch])
    return np.asarray(pk.xdelta_preprocess_pallas(flat.reshape(-1),
                                                  interpret=True))


@pytest.mark.parametrize("bps", [1, 2, 3])
def test_xdelta_native_bytes_vs_pallas(rng, bps):
    """K1 on the native bytes (the uint8 form) against native_to_i32 then
    xdelta_preprocess_pallas, and its flag against _fits_planes of the
    reference's values, at every plane count up to bps: the extremes
    -2^(8·bps-1) and 2^(8·bps-1) - 1 at the channel boundaries (the chain
    wraps across them), 1-3 samples at 1 and 12 channels, and a tail
    tile; tolerance 0."""
    shapes = [(ns, ch) for ns in (1, 2, 3) for ch in (1, 12)]
    for ns, ch in shapes + [(3001, 12)]:   # tiles of 32, the last of 25
        x = native_bytes(_extreme_signal(rng, ns, ch, bps), bps)
        want = _xdelta_jax(x, ns, ch, bps, True)
        for planes in range(1, bps + 1):
            enc, ok = ck.xdelta_swizzle(_t(x), ns, ch, planes, bps)
            np.testing.assert_array_equal(enc.numpy(), want)
            assert torch.equal(ok, ck._fits_planes(_t(want), planes, bps))


@pytest.mark.parametrize("case", XDELTA_EDGE_CASES)
def test_xdelta_edges_vs_pallas(case):
    """K1's plain version on tests/test_torch_cuda.py's xdelta_edge_batch
    (the inputs the card holds the kernel to) against the reference's
    pass 1, values and flag; tolerance 0."""
    for x, ns, ch, planes, bps, swizzle, _ in xdelta_edge_batch(
            np.random.default_rng(120), case):
        want = _xdelta_jax(x, ns, ch, bps, swizzle)
        enc, ok = ck.xdelta_swizzle(_t(x), ns, ch, planes, bps, swizzle)
        np.testing.assert_array_equal(enc.numpy(), want)
        assert torch.equal(ok, ck._fits_planes(_t(want), planes, bps))
        if case.startswith("fail"):
            assert int(ok[0]) == 0


def test_xdelta_native_bytes_validated():
    """The uint8 form is interleaved and needs n * bps bytes; other dtypes
    raise."""
    x = torch.zeros(24, dtype=torch.uint8)
    with pytest.raises(ValueError):
        ck.xdelta_swizzle(x, 4, 3, 1, 2, swizzle=False)
    with pytest.raises(ValueError):
        ck.xdelta_swizzle(x, 4, 3, 1, 3)
    with pytest.raises(TypeError):
        ck.xdelta_swizzle(x.to(torch.int16), 4, 3, 1, 2)
    assert ck.xdelta_swizzle(x, 4, 3, 1, 2)[0].shape == (12,)


@pytest.mark.parametrize("planes,plane_len", [(3, B + 4321), (2, 1000)])
def test_tokenize_planes_vs_pallas(rng, planes, plane_len):
    """K2 tokenize_planes_pallas: token words and plane bytes, and the
    histograms vs jax_coder.hist_from_tokw; tolerance 0. Covers a run
    > 16,662, runs across slab rows, an odd tail and a literal stretch."""
    x = _runs_signal(rng, plane_len)
    tokw, bwords, hist = ck.tokenize_planes(_t(x), planes)
    jt, jb = pk.tokenize_planes_pallas(jnp.asarray(x), planes, plane_len,
                                       interpret=True)
    np.testing.assert_array_equal(tokw.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bwords.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(jax_coder.hist_from_tokw(jt)))


def test_tokenize_all_zero_and_all_literal_slabs(rng):
    """The TPU kernel's closed-form branches: an all-zero slab and an
    all-literal slab; tolerance 0."""
    lit = (rng.integers(1, 256, (B, 4)) * (1 << np.arange(0, 32, 8))).sum(1)
    x = np.concatenate([np.zeros(B, np.int64), lit[:999]])
    x = x.astype(np.uint32).view(np.int32)
    tokw, bwords, hist = ck.tokenize_planes(_t(x), 1)
    jt, jb = pk.tokenize_planes_pallas(jnp.asarray(x), 1, x.size,
                                       interpret=True)
    np.testing.assert_array_equal(tokw.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(bwords.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(hist.numpy(),
                                  np.asarray(jax_coder.hist_from_tokw(jt)))


@functools.lru_cache(maxsize=None)
def _tokenize_edges_jax(case):
    """The edge signal and the Pallas kernel's 4-plane token words, plane
    bytes and histograms (rows are plane-major, so fewer planes are the
    first rows)."""
    x = tokenize_edge_batch(np.random.default_rng(90), case)
    jt, jb = pk.tokenize_planes_pallas(jnp.asarray(x), 4, x.size,
                                       interpret=True)
    return x, np.asarray(jt), np.asarray(jb), np.asarray(
        jax_coder.hist_from_tokw(jt))


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
@pytest.mark.parametrize("case", TOKENIZE_EDGE_CASES)
def test_tokenize_tile_edges_vs_pallas(case, planes):
    """K2 and hist_from_tokw on the CUDA kernel's tile edges
    (tests/test_torch_cuda.py's tokenize_edge_batch: runs starting and
    ending on 4,096 multiples, a run > 16,662 across 8 tiles with a
    chunk start on a tile boundary, all-zero and all-literal slabs, last
    slabs of 4,097, 4,095 and 1 positions); tolerance 0."""
    x, jt, jb, jh = _tokenize_edges_jax(case)
    tokw, bwords, hist = ck.tokenize_planes(_t(x), planes)
    rows = planes * 2
    np.testing.assert_array_equal(tokw.numpy(), jt[:rows])
    np.testing.assert_array_equal(bwords.numpy(), jb[:rows])
    np.testing.assert_array_equal(hist.numpy(), jh[:rows])


def _plan(x, planes):
    tokw, bwords, hist = ck.tokenize_planes(_t(x), planes)
    _, lengths = tc.block_layout(x.size, planes)
    hist_np = hist.numpy()
    return tokw, hist_np, tc.flat_plan(hist_np, lengths)


def test_compact_tokens_vs_pallas(rng):
    """K3 compact_tokens_pallas on the flat pack's layout, compared on
    [:T] (JAX adds every non-HUFF block at the trash base T); FILL and
    COPY blocks included; tolerance 0."""
    n = B + 3000
    x = (rng.integers(0, 256, n)                     # plane 0: COPY
         | (3 << 8)                                  # plane 1: FILL
         | ((rng.random(n) < 0.05) << 16)).astype(np.int32)
    tokw, hist_np, plan = _plan(x, 3)
    assert plan.is_copy.any() and plan.is_fill.any() and plan.T > 0
    got = ck.compact_tokens(tokw, _t(plan.bases), plan.T)
    want = pk.compact_tokens_pallas(jnp.asarray(tokw.numpy()),
                                    jnp.asarray(plan.bases),
                                    plan.T // 128 + 512 + 24,
                                    interpret=True, r_ct=256)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1)[:plan.T])


def test_compact_tokens_nonzero_valid_vs_pallas(rng):
    """K3 in its decode form (valid = word != 0); tolerance 0."""
    w = rng.integers(-3, 3, (3, 2 * 128 * 128)).astype(np.int32)
    bases = np.array([0, 40000, 70000], np.int32)
    T = 110000
    got = ck.compact_tokens(_t(w), _t(bases), T, nonzero_valid=True)
    want = pk.compact_tokens_pallas(jnp.asarray(w), jnp.asarray(bases),
                                    T // 128 + 512 + 24, interpret=True,
                                    nonzero_valid=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1)[:T])


def _compact_case(rng, case):
    """(tokw, bases, T) of one edge case of compact_tokens (valid = bit
    27; the kernel's tiles are 4,096 words): four rows packed in order,
    about 40% of their words valid."""
    ntok = 2 * 4096 + 1000 if case == "ragged_ntok" else 3 * 4096
    w = (rng.integers(0, 1 << 27, (4, ntok))
         | ((rng.random((4, ntok)) < 0.4).astype(np.int64) << 27))
    if case == "all_valid_row":
        w[1] |= 1 << 27
    cnt = (w >> 27) & 1
    rows = [1, 3] if case == "trash_rows_between" else [0, 1, 2, 3]
    bases = np.zeros(4, np.int64)
    bases[rows] = np.concatenate([[0], np.cumsum(cnt[rows].sum(1))[:-1]])
    T = int(cnt[rows].sum())
    if case == "trash_rows_between":
        bases[[0, 2]] = [T, T + 9]       # the TPU layout's trash base
    if case == "t_total_mid_tile":
        # T ends 100 words into row 3's second tile of valid words
        T = int(bases[3] + cnt[3, :4096].sum() + 100)
    return w.astype(np.int32), bases.astype(np.int32), T


@pytest.mark.parametrize("case", ["t_total_mid_tile", "all_valid_row",
                                  "ragged_ntok", "trash_rows_between"])
def test_compact_tokens_edges_vs_pallas(rng, case):
    """compact_tokens against K3 on the edges of the kernel's tile split
    and look-back: t_total cutting a row in mid-tile, a row whose words
    are all valid, ntok not a multiple of the tile, rows with bases >=
    t_total between packed rows; compared on [:T], tolerance 0."""
    w, bases, T = _compact_case(rng, case)
    got = ck.compact_tokens(_t(w), _t(bases), T)
    span = int((bases.astype(np.int64) + w.shape[1]).max())
    want = pk.compact_tokens_pallas(jnp.asarray(w), jnp.asarray(bases),
                                    span // 128 + 128 + 16, interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1)[:T])
    assert got.shape == (T,) and T > 0


def test_pack_tokens_flat_vs_pallas(rng):
    """K3 + K4 + glue + K5 through jax_coder.pack_tokens_flat2 against
    the port's compact_tokens + pack_flat: payload words compared on
    [:total_payload] bytes; tolerance 0."""
    ch, ns = 2, 40000
    x = np.asarray(jops.xor_encode(jops.offset32(jops.delta_encode(
        jnp.asarray(_ecg_words(rng, ch, ns, 40.0))), -128)))
    tokw, hist_np, plan = _plan(x, 3)
    assert plan.T > 0 and not plan.is_copy.any()
    words = tc.pack_tokens_flat(tokw, _t(plan.bases), plan.T,
                                _t(plan.ntok), _t(plan.bit0), _t(plan.lut),
                                plan.nwords)

    _, T, ng, g2b, gfirst = tc.flat_compact_layout(
        hist_np, plan.ntok > 0)
    assert (T, ng) == (plan.T, plan.g2b.size)
    assert np.array_equal(g2b, plan.g2b)
    assert np.array_equal(gfirst, plan.gfirst)
    want = jax_pack_flat2(tokw.numpy(), plan)
    nbytes = plan.total_payload
    np.testing.assert_array_equal(
        words.numpy().view(np.uint8)[:nbytes],
        np.asarray(want).reshape(-1).view(np.uint8)[:nbytes])


def jax_pack_flat2(tokw, plan, gmeta=None, hint_rows=0):
    """jax_coder.pack_tokens_flat2 in interpret mode on pass-1 token
    words under a flat plan: K3 + K4 + glue + K5, or with gmeta and
    hint_rows K3 + K10 + glue + K11 + K5 (returns (words, entries))."""
    ng, g2b = plan.g2b.size, plan.g2b
    lut3 = np.zeros((ng, 3 * 128), np.int32)
    lut3[:, :261] = plan.lut[g2b]
    desc_bits = plan.bit0 - plan.hoff * 8
    nrows_f = -(-(plan.total_payload // 4 + 2) // 128) + pk.ACC_ROWS
    nrows_f = -(-nrows_f // 8) * 8
    return jax_coder.pack_tokens_flat2(
        jnp.asarray(tokw), jnp.asarray(plan.bases),
        jnp.asarray(lut3.reshape(ng, 3, 128)),
        jnp.asarray(desc_bits[g2b].astype(np.int32)),
        jnp.asarray(plan.hoff[g2b].astype(np.int32)),
        jnp.asarray(plan.gfirst), t_rows=plan.T // 128 + 512 + 24,
        T=plan.T, nrows_f=nrows_f, interpret=True,
        gmeta=None if gmeta is None else jnp.asarray(gmeta),
        hint_rows=hint_rows)


@functools.lru_cache(maxsize=None)
def pack_flat_edges(case):
    return pack_flat_edge_batch(np.random.default_rng(110), case)


@pytest.mark.parametrize("case", PACK_FLAT_EDGE_CASES)
def test_pack_flat_edges_reach_their_paths(case):
    """Each pack_flat_edge_batch case, counted from its kernel arguments
    with the kernel's 2,048-token tile, reaches what it is built for:
    tile-first tokens crossing segment boundaries, block-last ones,
    tokens spanning the word two tiles share, more tiles than status
    words (overlap), more than 132 x 8 tiles (many_tiles), a block of
    more than 33 tiles (long_block)."""
    check_pack_flat_edges_covered(case,
                                  pack_flat_edges_covered(pack_flat_edges(case)))


@pytest.mark.parametrize("case", PACK_FLAT_JAX_CASES)
def test_pack_flat_edges_vs_pallas(case):
    """pack_flat's plain version on tests/test_torch_cuda.py's
    pack_flat_edge_batch (the CUDA kernel's 2,048-token tiles: blocks of
    2, 2,047-2,049 and several tiles, COPY/FILL/empty blocks between,
    tokens spanning the word two tiles share; a block cut to one token,
    nwords one word short, tokc cut inside a block) against K3 + K4 +
    glue + K5 through jax_coder.pack_tokens_flat2 on the same tokens
    (the cut ones made invalid); payload bytes, tolerance 0."""
    x = pack_flat_edges(case)
    check_pack_flat_edges_covered(case, pack_flat_edges_covered(x))
    words = ck.pack_flat(*x["plain_args"])
    want = np.asarray(jax_pack_flat2(x["jax_tokw"], x["plan"]))
    nbytes = min(x["plan"].total_payload, 4 * words.numel())
    assert nbytes > 4 * 1500
    np.testing.assert_array_equal(
        words.numpy().view(np.uint8)[:nbytes],
        want.reshape(-1).view(np.uint8)[:nbytes])


def test_wrappers_validate_inputs():
    """Wrong dtype, layout or shape raises before any kernel work."""
    x = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(TypeError):
        ck.xdelta_swizzle(x, 8, 8, 3, 4)
    with pytest.raises(ValueError):
        ck.tokenize_planes(torch.zeros((4, 8), dtype=torch.int32)[:, ::2]
                           .reshape(-1)[:0], 3)
    tokw = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        ck.compact_tokens(tokw.T, torch.zeros(16, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        ck.compact_tokens(tokw, torch.zeros(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        ck.pack_flat(tokw.reshape(-1), torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int64),
                     torch.zeros((2, 260), dtype=torch.int32), 4)
