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
from test_torch_cuda import (K14_EDGE_CASES, K14_TILE,  # noqa: E402
                             WINDOWS_EDGE_CASES, X1_EDGE_CASES,
                             group_windows_args, k14_edge_batch,
                             window_bits, windows_edge_batch, x1_edge_batch,
                             x1_inputs)

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


# ---------------------------------------------------------------------------
# Models of the card's designs (ops/csrc/windows.cu) against the plain
# versions, and the plain versions against the JAX kernels, on the batch
# and on tests/test_torch_cuda.py's edge inputs
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF
TILE = 4096                  # K15's tile: one super, a CTA
X1_WORDS = ck.AR2 * 128      # X1's accumulator words


def _written(n, writes):
    """The words an output of n words holds after the kernels' writes,
    (super, words, values, add) each: a plain store, or an atomic add
    into the zeroed output. Words outside [0, n) are dropped. Asserts the
    kernels' domain, in which the result does not depend on the order of
    the CTAs: a word stored by one super is written by no other."""
    sup, wd, val, add = (np.concatenate([np.broadcast_to(np.asarray(w[k]),
                                                         np.shape(w[1]))
                                         for w in writes])
                         if writes else np.zeros(0, np.int64)
                         for k in range(4))
    keep = (wd >= 0) & (wd < n)
    sup, wd, val, add = (a[keep] for a in (sup, wd, val, add))
    out = np.zeros(n, np.int64)
    stored = wd[~add.astype(bool)]
    assert np.unique(stored).size == stored.size, "a word stored twice"
    shared = np.isin(wd, stored)
    for w in np.unique(wd[shared]):
        assert np.unique(sup[wd == w]).size == 1, f"word {w}: two supers"
    out[stored] = val[~add.astype(bool)]
    np.add.at(out, wd[add.astype(bool)], val[add.astype(bool)])
    return (out & M32).astype(np.uint32).view(np.int32)


def _contributions(bit, val):
    """A value's three word contributions from bit `bit`: (word, value)
    arrays of the c0, c1, c2 of windows.cu (val uint64)."""
    s = (bit & 31).astype(np.uint64)
    wi = bit >> 5
    vlo, vhi = val & np.uint64(M32), val >> np.uint64(32)
    m = np.uint64(M32)
    c0 = (vlo << s) & m
    c1 = np.where(s > 0, vlo >> (np.uint64(32) - s), 0) | ((vhi << s) & m)
    c2 = np.where(s > 0, vhi >> (np.uint64(32) - s), 0)
    return [(wi + k, c.astype(np.uint64)) for k, c in enumerate((c0, c1,
                                                                c2))]


def _wrap32(v: int) -> int:
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def k14_model(tokc, lut3, tile=K14_TILE):
    """group_windows as windows.cu's kernel computes it, in numpy. A tile
    of `tile` tokens (tile / 128 chunks) a CTA, a group's tiles a
    cluster: each tile codes its tokens and scans their bits, and its
    group-local bit is the sum of the bits of the group's lower tiles
    (what each tile leaves in its shared memory); a chunk's base word is
    its first token's bit >> 5, its liveness whether any token has bits;
    each valid token's three words are added mod 2^32 into its chunk's
    window at min(bit >> 5 - base, 254) and the next two (index 256
    dropped); gtot comes from the group's last tile, its prefix plus its
    own bits. Returns (w0, w1, cbase, clive, gtot) shaped as
    group_windows returns them, int32."""
    ng = lut3.shape[0]
    nt = ck.GROUP_TOK // tile
    tok = tokc.numpy().reshape(ng, nt, tile).astype(np.int64)
    lut = lut3.numpy().reshape(ng, 384).astype(np.int64)
    nct = tile // 128
    chunk = np.arange(tile) // 128
    win = np.zeros((ng * ck.R_TV, ck.WIN), np.int64)
    cbase, clive = (np.zeros(ng * ck.R_TV, np.int64) for _ in range(2))
    gtot = np.zeros(ng, np.int64)
    for g in range(ng):
        nb_t = window_bits(tok[g], np.broadcast_to(lut[g], (nt, 384)))
        tile_bits = nb_t.sum(1)           # each tile's, in its cluster
        for j in range(nt):
            prefix = int(tile_bits[:j].sum())
            own, nb = tok[g, j], nb_t[j]
            valid = ((own >> 27) & 1) == 1
            sym = own & 511
            e = lut[g, np.where(sym < 256, sym, 256 + (sym & 127))] & M32
            cb = e >> 24
            assert (cb[valid] < 64).all()
            val = ((e & 0xFFFFFF).astype(np.uint64)
                   | (((own >> 13) & 16383).astype(np.uint64)
                      << np.where(valid, cb, 0).astype(np.uint64)))
            bit = prefix + np.cumsum(nb) - nb
            base = bit[::128] >> 5
            loc = np.minimum((bit >> 5) - base[chunk], ck.WIN - 2)
            row = g * ck.R_TV + j * nct + chunk
            for x, c in _contributions(loc * 32 + (bit & 31), val):
                keep = valid & (x < ck.WIN)
                np.add.at(win, (row[keep], x[keep]), c[keep].astype(np.int64))
            cbase[row[::128]] = base
            clive[row[::128]] = (nb.reshape(nct, 128) > 0).any(1)
        gtot[g] = tile_bits[:-1].sum() + tile_bits[-1]
    win = (win & M32).astype(np.uint32).view(np.int32)
    nc = ng * ck.R_TV
    return tuple(torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
                 for a in (win[:, :128].reshape(1, nc, 128),
                           win[:, 128:].reshape(1, nc, 128),
                           cbase.reshape(1, nc), clive.reshape(1, nc),
                           gtot.reshape(1, ng)))


def k15_model(tokc, lut3, dbg, wog, gfirst, ng, nrows):
    """windows_place_flat as windows.cu's kernel computes it, in numpy.
    A tile of 4,096 tokens (one super) a CTA: its tokens coded and
    scanned; its bits published; its carry summed from the published
    bits of the tiles of its block's earlier groups (groups max(gfirst,
    0) .. g - 1), its group-local bit from the group's earlier tile; gb =
    wog * 8 + dbg + carry in int32. A dead super (no token with bits)
    places nothing. A live super whose valid tokens all have cbits <=
    23, code < 2^cbits and extra < 2^ebits and whose base (gb >> 5) +
    sbase lies in [0, (nrows - 48) * 128] is placed at its bits: its
    words ORed from its first bit (the fields' bits disjoint: OR equals
    the sum), the first and last added, the rest stored. Any other live
    super takes the slow path: its 32 windows (sums), the 48-row
    accumulator (sums), the cyclic shift by gb & 31, the rotation to the
    clamped base, its first and last nonzero words added and the words
    between stored. Returns ((nrows, 128) int32 words, slow supers)."""
    nt = 2 * ng
    tok = tokc.numpy().reshape(-1)[:ng * ck.GROUP_TOK].astype(np.int64)
    tok = tok.reshape(nt, TILE)
    lut = lut3.numpy().reshape(ng, 384).astype(np.int64) & M32
    sym = tok & 511
    valid = ((tok >> 27) & 1) == 1
    eb, ex = (tok >> 9) & 15, (tok >> 13) & 16383
    idx = np.where(sym < 256, sym, 256 + (sym & 127))
    e = np.where(valid, lut[(np.arange(nt) // 2)[:, None], idx], 0)
    cb, code = e >> 24, e & 0xFFFFFF
    nb = np.where(valid, cb + eb, 0)
    bad = valid & ((cb > 23) | ((code >> np.minimum(cb, 24)) != 0)
                   | ((ex >> eb) != 0))
    assert (cb < 64).all()
    val = (code.astype(np.uint64)
           | (ex.astype(np.uint64) << cb.astype(np.uint64)))
    total = nb.sum(1)
    excl = np.cumsum(nb, 1) - nb        # tile-local
    dbg, wog, gfirst = (a.numpy().astype(np.int64) for a in (dbg, wog,
                                                              gfirst))
    top = (nrows - ck.ACC_ROWS) * 128
    n_acc = ck.ACC_ROWS * 128
    writes, slow = [], 0
    for i in range(nt):
        g = i // 2
        gt0 = 2 * g
        carry = int(total[min(2 * max(int(gfirst[g]), 0), gt0):gt0].sum())
        pre = int(total[gt0:i].sum())
        gb = _wrap32(int(wog[g]) * 8 + int(dbg[g]) + carry)
        if total[i] == 0:
            continue
        sbase = pre >> 5
        b = (gb >> 5) + sbase
        live = nb[i] > 0
        if not bad[i].any() and 0 <= b <= top:
            p0 = gb + pre
            nw = (p0 % 32 + int(total[i]) + 31) >> 5
            cs = _contributions(p0 % 32 + excl[i][live], val[i][live])
            orw = np.zeros(nw + 2, np.uint64)
            sums = np.zeros(nw + 2, np.uint64)
            for w, c in cs:
                np.bitwise_or.at(orw, w, c)
                np.add.at(sums, w, c)
            assert (orw == sums).all() and not orw[nw:].any()
            k = np.arange(nw)
            edge = (k == 0) | (k == nw - 1)
            put = ~edge | (orw[:nw] != 0)
            writes.append((i, (p0 >> 5) + k[put],
                           orw[:nw][put].astype(np.int64), edge[put]))
            continue
        slow += 1
        bitg = pre + excl[i]
        chunk = np.arange(TILE) // 128
        cbase = bitg[::128] >> 5
        loc = np.minimum((bitg >> 5) - cbase[chunk], ck.WIN - 2)
        win = np.zeros((32, ck.WIN), np.int64)
        for k, (_, c) in enumerate(_contributions(bitg, val[i])):
            put = valid[i] & (loc + k < ck.WIN) & (c != 0)
            np.add.at(win, (chunk[put], loc[put] + k), c[put].astype(np.int64))
        win &= M32
        d = np.clip(cbase - sbase, 0, ck.D_CLAMP)
        kk = ((d >> 7) * 128 + (d & 127))[:, None] + np.arange(ck.WIN)
        acc = np.zeros(n_acc, np.int64)
        np.add.at(acc, kk % n_acc, win)
        acc &= M32
        sb = gb & 31
        acc = ((acc << sb) & M32) | (np.roll(acc, 1) >> (32 - sb))
        bc = min(max(b, 0), top)
        base = (bc >> 7) * 128
        rot = np.zeros(n_acc, np.int64)
        rot[(np.arange(n_acc) + bc - base) % n_acc] = acc
        nz = np.flatnonzero(rot)
        if nz.size:
            j = np.arange(nz[0], nz[-1] + 1)
            writes.append((i, base + j, rot[j], (j == nz[0]) | (j == nz[-1])))
    return _written(nrows * 128, writes).reshape(nrows, 128), slow


def x1_model(w0, w1, drow, dlane, wbase, sbits, slive, nrows):
    """place_windows_aligned as windows.cu's kernel computes it, in
    numpy: a 256-thread CTA a live super; thread tid owns the
    accumulator words k = tid (mod 256) and takes from each chunk c with
    0 <= rc < 56 (rc = dlane >> 7) the one window word x = (tid - st_c)
    mod 256, st_c = rc * 128 + (drow & 127), adding it into word (st_c +
    x) mod 7,168, which lies in its column; each word is then shifted by
    sb with its predecessor (cyclic), rotated by off = wbase - base (base
    the row rounded down to a multiple of 8) and, if nonzero, added into
    the zeroed output. Returns (nrows, 128) int32."""
    nsup = wbase.numel()
    win = (torch.cat([w0[0], w1[0]], 1).numpy().astype(np.int64) & M32)
    win = win.reshape(nsup, 32, ck.WIN)
    drow, dlane, wbase, sbits, slive = (
        a.numpy().astype(np.int64).reshape(nsup, -1)
        for a in (drow, dlane, wbase, sbits, slive))
    tid = np.arange(256)[:, None]
    chunk = np.arange(32)[None, :]
    writes = []
    for s in range(nsup):
        if not slive[s, 0]:
            continue
        rc = dlane[s] >> 7
        st = np.where((rc >= 0) & (rc < ck.AR2), rc * 128 + (drow[s] & 127),
                      -1)[None, :]
        x = (tid - st) & (ck.WIN - 1)
        k = (st + x) % X1_WORDS
        ok = np.broadcast_to(st >= 0, k.shape)
        assert (k % 256 == tid)[ok].all()
        acc = np.zeros(X1_WORDS, np.int64)
        np.add.at(acc, k[ok], np.broadcast_to(win[s][chunk, x], k.shape)[ok])
        acc &= M32
        sb = int(sbits[s, 0]) & 31
        u = ((acc << sb) & M32) | (np.roll(acc, 1) >> (32 - sb))
        b = int(wbase[s, 0])
        base = ((b >> 7) & ~7) * 128
        r = (np.arange(X1_WORDS) + b - base) % X1_WORDS
        nz = u != 0
        writes.append((s, base + r[nz], u[nz], True))
    return torch.from_numpy(_written(nrows * 128, writes).reshape(nrows,
                                                                  128))


def test_k15_model_equals_plain_on_batch(batch):
    """The K15 design's order (k15_model) gives windows_place_flat_plain's
    words on the batch (10 groups, 20 tiles), with no super on the slow
    path; tolerance 0."""
    gl = batch["gl"]
    args = (batch["tokc"].reshape(-1, 128), gl.lut3, gl.dbg, gl.wog,
            gl.gfirst, gl.ng, gl.nrows_fused)
    got, slow = k15_model(*args)
    assert slow == 0
    np.testing.assert_array_equal(got, ck.windows_place_flat_plain(
        *args).numpy())


@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES))
def test_k15_model_equals_plain_on_edges(case):
    """k15_model equals windows_place_flat_plain on every
    WINDOWS_EDGE_CASES case, with the case's supers on the slow path;
    tolerance 0."""
    args = windows_edge_batch(np.random.default_rng(140), case)
    got, slow = k15_model(*args)
    assert slow == WINDOWS_EDGE_CASES[case]
    np.testing.assert_array_equal(got, ck.windows_place_flat_plain(
        *args).numpy())


def test_x1_model_equals_plain_on_batch(batch):
    """The X1 design's order (x1_model: the column gather and the
    register shift) gives place_windows_aligned_plain's words on the
    batch's windows and glue; tolerance 0."""
    gl = batch["gl"]
    w = ck.group_windows(batch["tokc"].reshape(1, -1), gl.lut3)
    args = ck.windows_glue(*w, gl.dbg, gl.wog, gl.gfirst, gl.nrows_windows,
                           ck.AR2)
    assert torch.equal(x1_model(*args, gl.nrows_windows),
                       ck.place_windows_aligned_plain(*args,
                                                      gl.nrows_windows))


@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES) + [
    "x1/" + c for c in X1_EDGE_CASES])
def test_x1_model_equals_plain_on_edges(case):
    """x1_model equals place_windows_aligned_plain on each
    WINDOWS_EDGE_CASES case's windows and glue and on each
    X1_EDGE_CASES case; tolerance 0."""
    if case.startswith("x1/"):
        *args, nrows = x1_edge_batch(np.random.default_rng(150), case[3:])
    else:
        *args, nrows = x1_inputs(windows_edge_batch(
            np.random.default_rng(140), case))
    assert torch.equal(x1_model(*args, nrows),
                       ck.place_windows_aligned_plain(*args, nrows))


# The edge cases the JAX kernels compute exactly. On the others chunks
# pile up in the accumulator (cbits 27-31: past D_CLAMP; 49-63: past loc
# 254 and D_CLAMP, so overlapping words), and the TPU kernels OR their
# accumulator's byte sums, exact for disjoint bits only, where the plain
# versions and the card add; X1's own cases also feed
# super_place_flat_pallas what it does not take: rc of 48-55 or a cyclic
# wrap (its accumulator has 48 rows), sbits past 31, wbase outside its
# pre-clamped range, overlapping windows.
WINDOWS_JAX_CASES = [c for c in WINDOWS_EDGE_CASES
                     if not c.startswith("cbits_")]
X1_JAX_CASES = ("sbits_0", "sbits_31", "dead_supers")


@pytest.mark.parametrize("case", WINDOWS_JAX_CASES)
def test_windows_place_flat_plain_vs_pallas_on_edges(case):
    """windows_place_flat's plain version equals
    token_windows_place_flat_pallas in interpret mode on the JAX-able
    WINDOWS_EDGE_CASES cases (out-of-field extras and codes, both base
    clamps, one token, dead supers, 20 groups of a block); tolerance
    0."""
    tokc, lut3, dbg, wog, gfirst, ng, nrows = windows_edge_batch(
        np.random.default_rng(140), case)
    want = pk.token_windows_place_flat_pallas(
        *(jnp.asarray(a.numpy()) for a in (tokc, lut3, dbg, wog, gfirst)),
        ng=ng, nrows=nrows, interpret=True)
    np.testing.assert_array_equal(ck.windows_place_flat_plain(
        tokc, lut3, dbg, wog, gfirst, ng, nrows).numpy(), np.asarray(want))


@pytest.mark.parametrize("case", WINDOWS_JAX_CASES + [
    "x1/" + c for c in X1_JAX_CASES])
def test_place_windows_aligned_plain_vs_super_place_on_edges(case):
    """X1's placement (place_windows_aligned's plain version) equals
    super_place_flat_pallas in interpret mode on the same aligned-row
    inputs, as test_place_windows_aligned_vs_super_place holds it, on the
    JAX-able edge cases; tolerance 0."""
    if case.startswith("x1/"):
        *args, nrows = x1_edge_batch(np.random.default_rng(150), case[3:])
    else:
        *args, nrows = x1_inputs(windows_edge_batch(
            np.random.default_rng(140), case))
    want = pk.super_place_flat_pallas(
        *(jnp.asarray(a.numpy()) for a in args), nrows, interpret=True)
    np.testing.assert_array_equal(ck.place_windows_aligned_plain(
        *args, nrows).numpy(), np.asarray(want))


def _same_windows(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _k14_case(case):
    """group_windows' arguments for a WINDOWS_EDGE_CASES case's groups or
    a "k14/" K14_EDGE_CASES case."""
    if case.startswith("k14/"):
        return k14_edge_batch(np.random.default_rng(160), case[4:])
    return group_windows_args(windows_edge_batch(np.random.default_rng(140),
                                                 case))


@pytest.mark.parametrize("tile", [K14_TILE, 1024, 4096])
def test_k14_model_equals_plain_on_batch(batch, tile):
    """The K14 design's order (k14_model: tiles, each tile's prefix from
    its cluster's lower tiles, window sums mod 2^32) gives
    group_windows_plain's five arrays on the batch (10 groups) at the
    kernel's tile and at the other tile sizes kernel_ab.py times;
    tolerance 0."""
    args = (batch["tokc"].reshape(1, -1), batch["gl"].lut3)
    _same_windows(k14_model(*args, tile), ck.group_windows_plain(*args))


@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES) + [
    "k14/" + c for c in K14_EDGE_CASES])
def test_k14_model_equals_plain_on_edges(case):
    """k14_model equals group_windows_plain on every WINDOWS_EDGE_CASES
    case's groups (cbits_49_63: tokens past loc 254, words dropped) and
    on the K14_EDGE_CASES cases (one group; tile prefixes ending at bit 0
    and bit 31 of a word; all chunks dead but the last); tolerance 0."""
    args = _k14_case(case)
    _same_windows(k14_model(*args), ck.group_windows_plain(*args))


def test_k14_edge_cases_hold_what_they_name():
    """The K14 cases hold their edges: prefixes at the tile edges of
    0 and 31 (mod 32), the dead group's live last chunk alone."""
    tok, lut = k14_edge_batch(np.random.default_rng(160), "prefix_bit_0_31")
    tok = tok.numpy().reshape(2, ck.GROUP_TOK).astype(np.int64)
    bits = np.cumsum(window_bits(tok, lut.numpy().reshape(2, 384)
                                 .astype(np.int64)), 1)
    ends = bits[:, K14_TILE - 1::K14_TILE][:, :-1].reshape(-1)
    assert (ends % 32 == np.arange(ends.size) % 2 * 31).all()
    _, _, _, clive, gtot = ck.group_windows_plain(*k14_edge_batch(
        np.random.default_rng(160), "dead_but_last"))
    assert clive[0, ck.R_TV:].tolist() == [0] * 63 + [1]
    assert int(gtot[0, 1]) > 0


# group_windows' plain version against the TPU kernel: every edge case
# (its sums mod 2^32 are the plain version's, past cbits 32 included, as
# the MXU prefix of nbits <= 78 is exact)
@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES) + [
    "k14/" + c for c in K14_EDGE_CASES])
def test_group_windows_plain_vs_pallas_on_edges(case):
    """group_windows_plain equals token_group_windows_grouped_pallas in
    interpret mode on the edge cases; tolerance 0."""
    tokc, lut3 = _k14_case(case)
    want = pk.token_group_windows_grouped_pallas(
        jnp.asarray(tokc.numpy()), jnp.asarray(lut3.numpy()), interpret=True)
    _same_windows(ck.group_windows_plain(tokc, lut3), want)
