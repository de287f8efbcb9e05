"""The windows routes of the flat pack: the plain versions of
group_windows (K14), windows_place_flat (K15), place_windows_aligned (X1)
and compact_tokens (K3, which also replaces X2), the glue windows_glue, and
torch_coder's pack_tokens_fused and pack_tokens_windows, against the
Pallas kernels they replace in interpret mode and against pack_flat.

All outputs are integer words: every comparison is bit-exact (tolerance
0). The batch is made with numpy from a seed: 3 planes of 65,536 + 3,000
values, so that one block holds 8 groups (its last one short), a one-group
tail block follows (the bit carry restarts at each block), a sparse block
has one group, and FILL and COPY blocks sit between them. Each JAX result
is computed once for the module.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.hzr import jax_coder  # noqa: E402
from rspt_tpu.ops import pallas_kernels as pk  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

B = 65536


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bytes(words, n):
    return words.numpy().reshape(-1).view(np.uint8)[:n]


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(606)
    n = B + 3000
    p0 = np.minimum(rng.geometric(0.45, n), 200)     # dense, skewed
    p0[20000:25000] = 0                              # a long zero run
    p2 = np.where(rng.random(n) < 0.05, rng.integers(1, 256, n), 0)
    p2[B:] = rng.integers(0, 256, n - B)             # a COPY tail
    x = (p0 | (3 << 8) | (p2 << 16)).astype(np.int32)   # plane 1: FILL
    tokw, _, hist = ck.tokenize_planes(_t(x), 3)
    _, lengths = tc.block_layout(n, 3)
    plan = tc.flat_plan(hist.numpy(), lengths)
    gl = tc.group_layout(plan, "cpu")
    bases = _t(plan.bases)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    words = tc.pack_tokens_flat(tokw, bases, plan.T, _t(plan.ntok),
                                _t(plan.bit0), _t(plan.lut), plan.nwords)
    return dict(tokw=tokw, plan=plan, gl=gl, bases=bases, tokc=tokc,
                words=words)


@pytest.fixture(scope="module")
def jax_windows(batch):
    """K14 in interpret mode, called directly."""
    gl = batch["gl"]
    return tuple(np.asarray(a) for a in pk.token_group_windows_grouped_pallas(
        jnp.asarray(batch["tokc"].numpy()[None]), jnp.asarray(gl.lut3.numpy()),
        interpret=True))


def test_batch_layout(batch):
    """The batch holds what the tests below rely on."""
    plan, gl = batch["plan"], batch["gl"]
    assert gl.ng == 10 and plan.is_fill.sum() == 2 and plan.is_copy.sum() == 1
    assert plan.gfirst.tolist() == [0] * 8 + [8, 9]
    assert -(-int(plan.ntok[0]) // 8192) == 8 and plan.ntok[0] % 8192


def test_group_windows_vs_pallas(batch, jax_windows):
    """K14: w0, w1, cbase, clive and gtot of group_windows' plain version
    equal token_group_windows_grouped_pallas's; tolerance 0."""
    got = ck.group_windows(batch["tokc"].reshape(1, -1), batch["gl"].lut3)
    assert len(got) == len(jax_windows) == 5
    for g, w in zip(got, jax_windows):
        np.testing.assert_array_equal(g.numpy(), w)


def _jax_glue(jw, gl, nrows, ar):
    """The glue of jax_coder.py:651-670 with tools/exp_place.py's `ar`."""
    w0, w1, cbase, clive, gtot = (jnp.asarray(a) for a in jw)
    dbg, wog, gfirst = (jnp.asarray(a.numpy()) for a in (gl.dbg, gl.wog,
                                                         gl.gfirst))
    e = jnp.cumsum(gtot, axis=1) - gtot
    e_in = e - jnp.take(e[0], gfirst)[None, :]
    group_base = wog[None, :] * 8 + dbg[None, :] + e_in
    ng, nc = gtot.shape[1], cbase.shape[1]
    nsup = nc // pk.SUP_CHUNKS
    c3 = cbase.reshape(1, nsup, pk.SUP_CHUNKS)
    superbase = c3[:, :, 0]
    d3 = jnp.clip(c3 - superbase[:, :, None], 0, pk.D_CLAMP)
    gb_s = jnp.broadcast_to(group_base.reshape(1, ng, 1),
                            (1, ng, nsup // ng)).reshape(1, nsup)
    wbase = jnp.clip(jnp.right_shift(gb_s, 5) + superbase, 0,
                     (nrows - ar) * 128)
    slive = jnp.any(clive.reshape(1, nsup, pk.SUP_CHUNKS) > 0, axis=2)
    return (w0, w1, d3.reshape(1, nc, 1), d3, wbase[:, :, None],
            (gb_s & 31)[:, :, None], slive[:, :, None].astype(jnp.int32))


@pytest.mark.parametrize("ar", [ck.ACC_ROWS, ck.AR2])
def test_windows_glue_vs_jax(batch, jax_windows, ar):
    """windows_glue's seven arrays equal the JAX glue's, for K5's 48-row
    and X1's 56-row accumulators; tolerance 0."""
    gl = batch["gl"]
    nrows = gl.nrows_fused if ar == ck.ACC_ROWS else gl.nrows_windows
    got = ck.windows_glue(*(_t(a) for a in jax_windows), gl.dbg, gl.wog,
                          gl.gfirst, nrows, ar)
    want = _jax_glue(jax_windows, gl, nrows, ar)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_place_windows_aligned_vs_super_place(batch):
    """X1: place_windows_aligned's plain version on the glue's ar = 56
    outputs equals K5, super_place_flat_pallas, on the same inputs (X1
    itself is nested in tools/exp_place.py's main() and takes no
    interpret; the tool asserts the two equal); tolerance 0."""
    gl = batch["gl"]
    w = ck.group_windows(batch["tokc"].reshape(1, -1), gl.lut3)
    args = ck.windows_glue(*w, gl.dbg, gl.wog, gl.gfirst, gl.nrows_windows,
                           ck.AR2)
    got = ck.place_windows_aligned(*args, gl.nrows_windows)
    want = pk.super_place_flat_pallas(
        *(jnp.asarray(a.numpy()) for a in args), gl.nrows_windows,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_tokens_windows_vs_pack_flat(batch):
    """The windows route (compact → K14 → glue → X1) gives pack_flat's
    payload bytes; tolerance 0."""
    plan, gl = batch["plan"], batch["gl"]
    got = tc.pack_tokens_windows(batch["tokw"], batch["bases"], plan.T, gl)
    assert tuple(got.shape) == (gl.nrows_windows, 128)
    n = plan.total_payload
    np.testing.assert_array_equal(_bytes(got, n), _bytes(batch["words"], n))


def test_windows_place_flat_vs_pallas(batch):
    """K15: windows_place_flat's plain version equals
    token_windows_place_flat_pallas on every (nrows, 128) word, and
    pack_flat on the payload bytes; tolerance 0."""
    gl = batch["gl"]
    tokc = batch["tokc"].reshape(-1, 128)
    got = ck.windows_place_flat(tokc, gl.lut3, gl.dbg, gl.wog, gl.gfirst,
                                gl.ng, gl.nrows_fused)
    want = pk.token_windows_place_flat_pallas(
        jnp.asarray(tokc.numpy()), *(jnp.asarray(a.numpy()) for a in (
            gl.lut3, gl.dbg, gl.wog, gl.gfirst)),
        ng=gl.ng, nrows=gl.nrows_fused, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = batch["plan"].total_payload
    np.testing.assert_array_equal(_bytes(got, n), _bytes(batch["words"], n))


def test_pack_tokens_fused_vs_jax(batch):
    """pack_tokens_fused against
    jax_coder._pack_tokens_flat2_impl(fuse_place=True) (K3 + K15 in
    interpret mode; the impl, since fuse_place is not a static argname of
    the jitted form): every word; tolerance 0."""
    plan, gl = batch["plan"], batch["gl"]
    got = tc.pack_tokens_fused(batch["tokw"], batch["bases"], plan.T, gl)
    want = jax_coder._pack_tokens_flat2_impl(
        jnp.asarray(batch["tokw"].numpy()), jnp.asarray(plan.bases),
        *(jnp.asarray(a.numpy()) for a in (gl.lut3, gl.dbg, gl.wog,
                                           gl.gfirst)),
        t_rows=plan.T // 128 + 512 + 24, T=plan.T, nrows_f=gl.nrows_fused,
        interpret=True, fuse_place=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_tokens_ballot_vs_pallas(rng):
    """X2's function, now computed by compact_tokens (its kernel took X2's
    warp-ballot loads): equal to K3, compact_tokens_pallas, on
    test_compact_tokens_vs_pallas's input (FILL and COPY blocks), on
    [:T] (X2 is nested in tools/exp_compact.py's main(); the tool asserts
    it equals K3); tolerance 0."""
    n = B + 3000
    x = (rng.integers(0, 256, n)
         | (3 << 8)
         | ((rng.random(n) < 0.05) << 16)).astype(np.int32)
    tokw, _, hist = ck.tokenize_planes(_t(x), 3)
    _, lengths = tc.block_layout(n, 3)
    plan = tc.flat_plan(hist.numpy(), lengths)
    assert plan.is_copy.any() and plan.is_fill.any() and plan.T > 0
    got = ck.compact_tokens(tokw, _t(plan.bases), plan.T)
    want = pk.compact_tokens_pallas(jnp.asarray(tokw.numpy()),
                                    jnp.asarray(plan.bases),
                                    plan.T // 128 + 512 + 24,
                                    interpret=True, r_ct=256)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1)[:plan.T])
    assert torch.equal(got, ck.compact_tokens_plain(tokw, _t(plan.bases),
                                                    plan.T))


def test_no_huff_block_gives_zero_words():
    """A batch with no HUFF block (ng = 0): both routes return zero words
    of their row counts, and the windows kernels return empty arrays."""
    rng = np.random.default_rng(7)
    tokw = _t(rng.integers(0, 1 << 27, (2, B)).astype(np.int32) | (1 << 27))
    _, lengths = tc.block_layout(B, 2)
    plan = tc.flat_plan(np.full((2, 261), 300, np.int32), lengths)
    gl = tc.group_layout(plan, "cpu")
    assert gl.ng == 0 and plan.T == 0 and plan.is_copy.all()
    bases = _t(plan.bases)
    w = tc.pack_tokens_windows(tokw, bases, 0, gl)
    f = tc.pack_tokens_fused(tokw, bases, 0, gl)
    assert tuple(w.shape) == (gl.nrows_windows, 128) and not w.any()
    assert tuple(f.shape) == (gl.nrows_fused, 128) and not f.any()
    out = ck.group_windows(torch.zeros((1, 0), dtype=torch.int32), gl.lut3)
    assert [tuple(a.shape) for a in out] == [(1, 0, 128), (1, 0, 128),
                                             (1, 0), (1, 0), (1, 0)]


def test_window_wrappers_validate_inputs(batch):
    """Wrong dtype, shape or layout raises before any kernel work."""
    gl = batch["gl"]
    tokc = batch["tokc"]
    with pytest.raises(TypeError):
        ck.group_windows(tokc.reshape(1, -1).long(), gl.lut3)
    with pytest.raises(ValueError):
        ck.group_windows(tokc[:-128].reshape(1, -1), gl.lut3)
    with pytest.raises(ValueError):
        ck.group_windows(tokc.reshape(1, -1), gl.lut3[1:])
    with pytest.raises(ValueError):
        ck.windows_place_flat(tokc.reshape(-1, 128).T, gl.lut3, gl.dbg,
                              gl.wog, gl.gfirst, gl.ng, gl.nrows_fused)
    with pytest.raises(ValueError):
        ck.windows_place_flat(tokc.reshape(-1, 128), gl.lut3, gl.dbg,
                              gl.wog, gl.gfirst, gl.ng, ck.ACC_ROWS - 1)
    w = ck.group_windows(tokc.reshape(1, -1), gl.lut3)
    args = list(ck.windows_glue(*w, gl.dbg, gl.wog, gl.gfirst,
                                gl.nrows_windows, ck.AR2))
    with pytest.raises(ValueError):
        ck.place_windows_aligned(*args, ck.AR2 - 1)
    bad = list(args)
    bad[3] = args[3].reshape(1, -1, 16)
    with pytest.raises(ValueError):
        ck.place_windows_aligned(*bad, gl.nrows_windows)
    bad = list(args)
    bad[0] = args[0][:, :, ::2]
    with pytest.raises((ValueError, TypeError)):
        ck.place_windows_aligned(*bad, gl.nrows_windows)
    with pytest.raises(ValueError):
        ck.compact_tokens(batch["tokw"], batch["bases"][1:],
                          batch["plan"].T)
