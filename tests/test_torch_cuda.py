"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``; every test skips where torch sees no card.

    python -m pytest tests/test_torch_cuda.py -m cuda

All outputs are integer words: bit-exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.hzr import gpu_decoder as gd  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.ops import torch_ops as tops  # noqa: E402
from rspt_tpu_torch import parallel  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _sig(rng, ch, ns, scale):
    sig = np.cumsum(rng.normal(0, scale, (ch, ns)), axis=1).astype(np.int32)
    return np.ascontiguousarray(sig.T).reshape(-1)


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_kernel_chain_matches_plain(rng, dev, planes):
    """Each kernel vs its plain version along one pass-1 → pass-2 chain."""
    ch, ns = 4, 30011
    words = torch.from_numpy(_sig(rng, ch, ns, 900.0)).to(dev)
    enc, ok = ck.xdelta_swizzle(words, ns, ch, planes, 4)
    enc_p, ok_p = ck.xdelta_swizzle_plain(words, ns, ch, planes, 4, True)
    assert torch.equal(enc, enc_p) and torch.equal(ok, ok_p)
    got = ck.tokenize_planes(enc, planes)
    want = ck.tokenize_planes_plain(enc, planes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tokw, _, hist = want
    _, lengths = tc.block_layout(enc.numel(), planes)
    plan = tc.flat_plan(hist.cpu().numpy(), lengths)
    bases = torch.from_numpy(plan.bases).to(dev)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    assert torch.equal(tokc, ck.compact_tokens_plain(tokw, bases, plan.T))
    args = (tokc, bases, torch.from_numpy(plan.ntok).to(dev),
            torch.from_numpy(plan.bit0).to(dev),
            torch.from_numpy(plan.lut).to(dev), plan.nwords)
    assert torch.equal(ck.pack_flat(*args), ck.pack_flat_plain(*args))


def test_packer_card_equals_cpu(rng, dev):
    """Containers from the card equal the plain path's; exact round trip."""
    ch, ns = 3, 40000
    native = _sig(rng, ch, ns, 700.0).astype("<i4").tobytes()
    pc = gpack.new_xdelta_hzr(4, ch, ns, 1, device=dev)
    comp = pc.compress(native)
    assert comp == gpack.new_xdelta_hzr(4, ch, ns, 1, device="cpu").compress(
        native)
    assert pc.decompress(comp)[0] == native


def decode_batch(payloads, dev):
    """hzr_decode's inputs for the HUFF blocks of the payloads' streams
    (one stream each), made by gpu_decoder's host half; returns
    (LaneArrays, kernel arguments, decoded size)."""
    streams = [tc.encode(p.tobytes(), device=dev) for p in payloads]
    _, out, huff = gd._walk_all(streams)
    blocks, _ = gd._device_blocks(huff)
    la = gd.lane_arrays(blocks)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in la.kernel_inputs()]
    return la, args, out.size


def _decode_batch(rng, dev):
    """hzr_decode's inputs for a mixed batch: ECG-like planes, a sparse
    plane and 21-bit codes (all four nibble levels)."""
    walk = np.cumsum(rng.normal(0, 3, 30000)).astype(np.int32)
    sparse = np.zeros(40000, np.uint8)
    sparse[rng.choice(40000, 300, replace=False)] = rng.integers(1, 255, 300)
    fib = [1, 1]
    while len(fib) < 22:
        fib.append(fib[-1] + fib[-2])
    deep = np.repeat(np.arange(1, 23, dtype=np.uint8), fib)
    rng.shuffle(deep)
    payloads = [(walk & 255).astype(np.uint8),
                ((walk >> 8) & 255).astype(np.uint8), sparse, deep]
    return decode_batch(payloads, dev)


def rank_edge_payloads(rng):
    """Payloads (24 symbols, ~4.6 bits a byte: HUFF) whose blocks lay out
    as: one 64 KiB block filling all 8 rows of tile 0, so that lane exits
    cross every CTA boundary of hzr_decode's cluster; two 3-row blocks
    and padding rows 6-7 in tile 1, between them and the next tile's
    3-row block (tile 2, padding rows 3-7)."""
    return ([rng.integers(0, 24, 65536).astype(np.uint8)]
            + [rng.integers(0, 24, 20000).astype(np.uint8)
               for _ in range(3)])


def check_decode_vs_plain(args, trusted):
    """hzr_decode vs hzr_decode_plain on one batch: counts, converged
    entries, stats (with the sweep count) and every emission below the
    tile's step count; with trusted (converged) entries, one sweep."""
    if trusted:
        args = list(args)
        args[8] = ck.hzr_decode_plain(*args)[2]
        args[0] = args[0].clone()
        args[0][:, 4] = 1
    got = ck.hzr_decode(*args)
    want = ck.hzr_decode_plain(*args)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert torch.equal(gd.valid_emissions(got[0], got[3][:, 0]),
                       gd.valid_emissions(want[0], want[3][:, 0]))
    assert bool((got[3][:, 1] == 0).all()) == trusted
    return got


@pytest.mark.parametrize("trusted", [False, True])
def test_hzr_decode_matches_plain(rng, dev, trusted):
    """hzr_decode vs hzr_decode_plain on the mixed batch."""
    _, args, _ = _decode_batch(rng, dev)
    check_decode_vs_plain(args, trusted)


@pytest.mark.parametrize("trusted", [False, True])
def test_hzr_decode_rank_edges_match_plain(rng, dev, trusted):
    """hzr_decode vs hzr_decode_plain where one block fills a whole tile
    (every row a CTA of the cluster, exits crossing each boundary) and
    padding rows sit between blocks; place_literals gives the same
    bytes from it."""
    la, args, total = decode_batch(rank_edge_payloads(rng), dev)
    got = check_decode_vs_plain(args, trusted)
    live = torch.from_numpy(la.lane_live).to(dev)
    base = gd.lane_out_base(got[1], live,
                            torch.from_numpy(la.out_off).to(dev),
                            torch.from_numpy(la.block_first).to(dev))
    pa = (got[3][:, 0].contiguous(), base,
          torch.from_numpy(la.out_limit).to(dev), live)
    assert torch.equal(
        ck.place_literals(got[0], *pa, total),
        ck.place_literals_plain(got[0], *pa, torch.zeros(
            total, dtype=torch.uint8, device=dev)))


def test_place_literals_matches_plain(rng, dev):
    """place_literals vs place_literals_plain on the same emissions."""
    la, args, total = _decode_batch(rng, dev)
    emis, counts, _, stats = ck.hzr_decode_plain(*args)
    live = torch.from_numpy(la.lane_live).to(dev)
    base = gd.lane_out_base(counts, live,
                            torch.from_numpy(la.out_off).to(dev),
                            torch.from_numpy(la.block_first).to(dev))
    limit = torch.from_numpy(la.out_limit).to(dev)
    steps = stats[:, 0].contiguous()
    got = ck.place_literals(emis, steps, base, limit, live, total)
    want = ck.place_literals_plain(
        emis, steps, base, limit, live,
        torch.zeros(total, dtype=torch.uint8, device=dev))
    assert torch.equal(got, want)


TOKENIZE_EDGE_CASES = ("tile_edges", "all_zero_slab", "all_literal_slab")


def tokenize_edge_batch(rng, case):
    """An int32 signal of one 64 KiB slab and a short last slab on the
    edges of tokenize_planes' tiles (2,048 positions; the edges below are
    multiples of 4,096, so they hold at 4,096 too), in all four byte
    planes. "tile_edges": zero runs starting and ending on tile edges; in
    plane p a run of 2 x 16,662 + 500 zeros from 4,096 * (5 + p) -
    16,662, so that its second chunk starts on a tile edge and it
    crosses many tiles; a last slab of 4,097 positions whose first 4,096
    are one zero run. "all_zero_slab": a last slab of 4,095 ending in a
    zero run. "all_literal_slab": every byte of the first slab non-zero,
    a last slab of 1 position, a zero."""
    tail = {"tile_edges": 4097, "all_zero_slab": 4095,
            "all_literal_slab": 1}[case]
    n = 65536 + tail
    by = rng.integers(1, 256, (n, 4))
    if case == "tile_edges":
        by[rng.random((n, 4)) < 0.3] = 0
        for a, b in ((53248, 57344), (59000, 61440), (65536, 69632)):
            by[a:b] = 0
            by[b] = rng.integers(1, 256, 4)
            if a != 65536:
                by[a - 1] = rng.integers(1, 256, 4)
        for p in range(4):
            a = 4096 * (5 + p) - 16662
            by[a - 1, p] = 7
            by[a:a + 2 * 16662 + 500, p] = 0
            by[a + 2 * 16662 + 500, p] = 9
    elif case == "all_zero_slab":
        by[:65536] = 0
        by[rng.random((n, 4)) < 0.3] = 0
        by[n - 700:] = 0
    else:
        by[-1] = 0
    word = (by.astype(np.uint32) << (8 * np.arange(4, dtype=np.uint32))).sum(
        1, dtype=np.uint32)
    return word.view(np.int32)


@pytest.mark.parametrize("case", TOKENIZE_EDGE_CASES)
def test_tokenize_edges_match_plain(dev, case):
    """tokenize_planes vs its plain version on its tile edges (token
    words, plane bytes, histograms), planes 1-4."""
    x = torch.from_numpy(tokenize_edge_batch(np.random.default_rng(90),
                                             case)).to(dev)
    for planes in (1, 2, 3, 4):
        for g, w in zip(ck.tokenize_planes(x, planes),
                        ck.tokenize_planes_plain(x, planes)):
            assert torch.equal(g, w)


def compact_edge_batch(rng, case):
    """(tokw, bases, T, nonzero_valid) of one edge case of compact_tokens
    (the kernel's tiles are 4,096 words): six rows of 65,536 + 1,000 words
    (17 tiles, the last ragged) packed in order, about 40% valid."""
    nb, ntok = (1, 65536) if case == "single_row" else (6, 65536 + 1000)
    valid = rng.random((nb, ntok)) < 0.4
    if case == "nonzero_valid":
        w = np.where(valid, rng.integers(1, 1 << 31, (nb, ntok)), 0)
    else:
        w = rng.integers(0, 1 << 27, (nb, ntok)) | (valid.astype(np.int64)
                                                    << 27)
    if case == "all_valid_row":
        w[2] |= 1 << 27
        valid[2] = True
    cnt = valid.sum(1)
    rows = [1, 3, 4] if case == "trash_rows_between" else list(range(nb))
    bases = np.zeros(nb, np.int64)
    bases[rows] = np.concatenate([[0], np.cumsum(cnt[rows])[:-1]])
    T = int(cnt[rows].sum())
    if case == "trash_rows_between":
        bases[[0, 2, 5]] = [T, T + 9, -1]
    if case == "t_total_mid_tile":
        T = int(bases[4] + valid[4, :3 * 4096].sum() + 100)
    return (w.astype(np.int32), bases.astype(np.int32), T,
            case == "nonzero_valid")


@pytest.mark.parametrize("case", ["t_total_mid_tile", "all_valid_row",
                                  "ragged_ntok", "trash_rows_between",
                                  "nonzero_valid", "single_row"])
def test_compact_tokens_edges_match_plain(rng, dev, case):
    """compact_tokens vs its plain version on the edges of its tile split
    and look-back carry: t_total cutting a row in mid-tile, an all-valid
    row, a ragged last tile, rows with bases >= t_total (or < 0) between
    packed rows, nonzero_valid, a single-row batch; 10 launches give the
    same words (the carry does not depend on the ticket order)."""
    w, bases, T, nzv = compact_edge_batch(rng, case)
    tokw = torch.from_numpy(w).to(dev)
    b = torch.from_numpy(bases).to(dev)
    want = ck.compact_tokens_plain(tokw, b, T, nzv)
    assert T > 0 and bool(want.any())
    for _ in range(10):
        assert torch.equal(ck.compact_tokens(tokw, b, T, nzv), want)


PACK_TILE = 2048          # pack_flat's tile: the tokens of one CTA
# pack_flat_edge_batch's cases; the first five also go through the JAX
# chain on the CPU (tests/test_torch_kernels.py, test_torch_sidecar.py)
PACK_FLAT_EDGE_CASES = ("ntok_edges", "copy_fill_between", "one_token",
                        "nwords_short", "avail_guard", "overlap",
                        "many_tiles", "long_block")
PACK_FLAT_JAX_CASES = PACK_FLAT_EDGE_CASES[:5]
_RUN_EBITS = np.array([0, 2, 4, 8, 14])   # extra bits of syms 256-260


def _pass1_tokens(rng, n):
    """n valid pass-1 token words (sym | ebits << 9 | extra << 13 | 1 <<
    27): skewed literals, single zeros and run symbols with their extra
    bits."""
    u = rng.random(n)
    sym = np.where(u < 0.15, 0, np.minimum(rng.geometric(0.12, n), 60))
    run = u > 0.9
    sym = np.where(run, rng.integers(256, 261, n), sym)
    eb = np.where(run, _RUN_EBITS[np.clip(sym - 256, 0, 4)], 0)
    extra = rng.integers(0, 1 << 14, n) & ((1 << eb) - 1)
    return sym | (eb << 9) | (extra << 13) | (1 << 27)


def _token_lengths(tok, lut_row):
    """Bits of each token word under one block's LUT row (0 if invalid)."""
    cb = (np.asarray(lut_row).astype(np.int64) & 0xFFFFFFFF) >> 24
    valid = ((tok >> 27) & 1) != 0
    return np.where(valid, cb[np.minimum(tok & 511, 260)]
                    + ((tok >> 9) & 15), 0)


def _steer(tok, L, mid, lo, ilim, hi, mod, shift, win, rng):
    """Swap tokens i in [lo, ilim) with j in (mid, hi) until the bits
    before token mid, plus shift, lie in [win[0], win[1]] modulo mod.
    Each swap raises that sum, never past win[1], so it converges."""
    x = int(L[:mid].sum())
    for _ in range(200000):
        r = (x + shift) % mod
        if win[0] <= r <= win[1]:
            return
        room = (win[0] - r) % mod + win[1] - win[0]
        i, j = int(rng.integers(lo, ilim)), int(rng.integers(mid + 1, hi))
        d = int(L[j] - L[i])
        if 0 < d <= room:
            tok[[i, j]], L[[i, j]] = tok[[j, i]], L[[j, i]]
            x += d
    raise AssertionError("pack_flat_edge_batch: no token order found")


def _swap_in(tok, L, at, j):
    tok[[at, j]], L[[at, j]] = tok[[j, at]], L[[j, at]]


def _huff_block(rng, n, hoff, cross=(), straddle=(), last=False):
    """A HUFF block of n tokens whose payload starts at byte hoff, its
    token order chosen so that the first token of each tile start in
    `cross` crosses a decode segment boundary, the token before each
    tile start in `straddle` spans the word it shares with the next
    tile, and (last) the block's last token crosses a boundary. Returns
    (token words in order, payload bytes)."""
    last = last or n - 1 in cross
    cross = tuple(p for p in cross if p != n - 1)
    steered = sorted(cross + tuple(straddle))
    for _ in range(100):
        tok = _pass1_tokens(rng, n)
        tables = tc.build_block_tables(np.bincount(tok & 511,
                                                   minlength=261))
        if tables is None:    # one code class: a FILL block
            continue
        _, cbits, _, dbits = tables
        L = cbits[tok & 511].astype(np.int64) + ((tok >> 9) & 15)
        total = int(L.sum())
        comp = (dbits + total + 7) // 8
        # the decoder's segment width (gpu_decoder.lane_rows)
        body = -(-max(comp * 8 - dbits, 1) // 32)
        W = max(8, -(-body // 1024)) * 32
        lo = steered[-1] + 1 if steered else 0
        if last:   # a last token longer than the bits past a boundary
            cand = np.flatnonzero(L[lo:n - 1] > total % W) + lo
            if cand.size == 0:
                continue
            _swap_in(tok, L, n - 1, int(cand[0]))
        lo = 0
        for P in steered:
            if P in cross:
                _swap_in(tok, L, P, P + 1 + int(np.argmax(L[P + 1:n - 1])))
                _steer(tok, L, P, lo, P, n - 1, W, 0,
                       (W - int(L[P]), W - 1), rng)
            else:
                _swap_in(tok, L, P - 1, lo + int(np.argmax(L[lo:P - 1])))
                _steer(tok, L, P, lo, P - 1, n - 1, 32, hoff * 8 + dbits,
                       (1, int(L[P - 1]) - 1), rng)
            lo = P + 1
        return tok, comp
    raise AssertionError("pack_flat_edge_batch: no HUFF block found")


def _pass1_rows(rng, blocks):
    """(tokw (nb, 65536) int32, lengths) of blocks given as ("huff", n,
    _huff_block's options), ("copy",), ("fill",) or ("empty",): each
    block's tokens at sorted random positions of its row, junk words
    without the valid bit between them."""
    nb = len(blocks)
    tokw = rng.integers(0, 1 << 27, (nb, 65536))
    lengths = np.full(nb, 65536, np.int32)
    hoff = 0
    for b, spec in enumerate(blocks):
        if spec[0] == "huff":
            tok, comp = _huff_block(rng, spec[1], hoff, **spec[2])
            hoff += comp
        elif spec[0] == "copy":   # ~8 bits a token: Huffman >= 64 KiB
            tok = rng.integers(0, 256, 65536) | (1 << 27)
        elif spec[0] == "fill":   # one code class
            tok = np.full(3000, 7 | (1 << 27))
        else:
            lengths[b] = 0
            continue
        pos = np.sort(rng.choice(65536, tok.size, replace=False))
        tokw[b, pos] = tok
    return tokw.astype(np.int32), lengths


def pack_flat_edges_covered(x):
    """What a pack_flat_edge_batch case exercises, counted from its
    kernel arguments alone: tiles (tiles), the kernel's status words
    (status_words: one a tile of non-overlapping blocks; tiles past them
    sum their block's earlier tokens directly), the most tiles of one
    block (block_tiles: look-backs past 32 tiles need more than 33),
    tiles whose first token crosses a decode segment boundary
    (first_cross), blocks whose last token does (last_cross), tile
    starts whose previous token spans the word the two tiles share
    (straddle)."""
    tokc, tok_base, ntok, bit0, lut, _ = (
        a.numpy() if torch.is_tensor(a) else a for a in x["args"])
    meta = x["lanes"][0].numpy()
    got = dict(tiles=0, block_tiles=0, first_cross=0, last_cross=0,
               straddle=0,
               status_words=-(-tokc.size // PACK_TILE) + ntok.size)
    for b in range(ntok.size):
        n = min(int(ntok[b]), max(tokc.size - int(tok_base[b]), 0))
        if n <= 0:
            continue
        tok = tokc[tok_base[b]:tok_base[b] + n].astype(np.int64)
        L = _token_lengths(tok, lut[b])
        xs = np.cumsum(L) - L
        W = int(meta[b, 0])
        cross = xs // W < (xs + L) // W
        got["tiles"] += -(-n // PACK_TILE)
        got["block_tiles"] = max(got["block_tiles"], -(-n // PACK_TILE))
        got["last_cross"] += int(cross[-1] and n == int(ntok[b]))
        for P in range(PACK_TILE, n, PACK_TILE):
            got["first_cross"] += int(cross[P])
            a = int(bit0[b]) + int(xs[P])
            got["straddle"] += int(0 < a % 32 < int(L[P - 1]))
    return got


def check_pack_flat_edges_covered(case, cov):
    """Assert that a pack_flat_edge_batch case reaches the kernel paths
    it is built for (cov: pack_flat_edges_covered's counts)."""
    need = {"tiles"}
    if case in PACK_FLAT_JAX_CASES:
        need |= {"first_cross", "last_cross", "straddle"}
    elif case != "overlap":
        need |= {"first_cross", "straddle"}
    assert all(cov[k] > 0 for k in need), (case, cov)
    if case == "overlap":
        assert cov["tiles"] > cov["status_words"], cov
    if case == "many_tiles":
        assert cov["tiles"] > 132 * 8, cov
    if case == "long_block":
        assert cov["block_tiles"] > 33, cov


def pack_flat_edge_batch(rng, case):
    """One edge case of pack_flat / pack_flat_lanes (tiles of 2,048
    tokens, a status word a tile, each tile's first and last words
    shared with its neighbours).

    Pass-1 token words (nb, 65536) of HUFF, COPY, FILL and empty blocks
    and their flat plan, so that the same input feeds the JAX chain and
    the port: ntok_edges (HUFF blocks of 2,047, 2,048, 2,049, 2 and
    6,144 tokens: a tile's first token, also its block's last,
    crossing a segment boundary, a token spanning the word two tiles
    share, block-final tokens crossing boundaries), copy_fill_between
    (COPY, FILL and empty blocks between HUFF blocks of 4,097, 5,000 and
    10,241 tokens), many_tiles (36 blocks of 61,000 tokens: 1,080 tiles,
    more than 132 x 8 resident CTAs). The direct cases change
    ntok_edges' (or many_tiles') kernel arguments: one_token (the
    2-token block cut to 1), nwords_short (nwords one word short of the
    last block's end), avail_guard (tokc cut 1,000 tokens before the
    last block's end), overlap (two blocks over the same tokens: more
    tiles than status words), long_block (one block over all of
    many_tiles' tokens: 1,152 tiles, look-backs past 32 tiles).

    Returns a dict: tokw, lengths and plan, and jax_tokw (the token
    words that the JAX chain packs to the same words: the cut tokens
    made invalid; None where no such words exist) as numpy; args
    (tokc, tok_base, ntok, bit0, lut, nwords), plain_args (the same
    function's arguments for the plain version, which reads every token
    of a block: avail_guard's tokc zero-padded to its full length) and
    lanes (meta, init) as CPU tensors."""
    from rspt_tpu_torch.hzr import sidecar
    T = PACK_TILE
    if case in ("many_tiles", "long_block"):
        blocks = [("huff", 61000, {})] * 36
    elif case == "copy_fill_between":
        blocks = [("huff", 2 * T + 1, dict(straddle=(T,), last=True)),
                  ("copy",), ("huff", 5000, dict(cross=(T,))), ("fill",),
                  ("empty",), ("huff", 5 * T + 1,
                               dict(cross=(3 * T,), straddle=(T, 2 * T)))]
    else:
        blocks = [("huff", T - 1, {}), ("huff", T, dict(last=True)),
                  ("huff", T + 1, dict(cross=(T,))), ("huff", 2, {}),
                  ("huff", 3 * T, dict(cross=(T,), straddle=(2 * T,),
                                       last=True))]
    tokw, lengths = _pass1_rows(rng, blocks)
    hist = np.stack([np.bincount(r[((r >> 27) & 1) != 0] & 511,
                                 minlength=261) for r in tokw])
    plan = tc.flat_plan(hist, lengths)
    assert list(np.flatnonzero(plan.ntok > 0)) == [
        b for b, s in enumerate(blocks) if s[0] == "huff"]
    assert list(plan.is_copy) == [s[0] == "copy" for s in blocks]
    bases = torch.from_numpy(plan.bases)
    tokc = ck.compact_tokens_plain(torch.from_numpy(tokw), bases, plan.T)
    hp = sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                            plan.comp_len > 0)
    args = [tokc, bases, torch.from_numpy(plan.ntok),
            torch.from_numpy(plan.bit0), torch.from_numpy(plan.lut),
            plan.nwords]
    meta, init = torch.from_numpy(hp.meta), torch.from_numpy(hp.init)
    jax_tokw = tokw.copy()
    plain_args = None

    def drop_tail(b, k):   # block b's last k valid tokens made invalid
        pos = np.flatnonzero((jax_tokw[b] >> 27) & 1)[-k:]
        jax_tokw[b, pos] &= ~(1 << 27)

    if case == "one_token":
        args[2] = args[2].clone()
        args[2][3] = 1
        drop_tail(3, 1)
    elif case == "nwords_short":
        tok = tokc[plan.bases[4]:plan.bases[4] + plan.ntok[4]].numpy()
        end = int(plan.bit0[4]) + int(_token_lengths(
            tok.astype(np.int64), plan.lut[4]).sum())
        args[5] = (end - 1) // 32
    elif case == "avail_guard":
        args[0] = tokc[:int(plan.bases[4]) + int(plan.ntok[4]) - 1000].clone()
        drop_tail(4, 1000)
        # the plain version reads every token: the same words from tokc
        # with the cut tokens made zero (invalid)
        plain_args = (torch.cat([args[0], torch.zeros_like(
            tokc[args[0].numel():])]), *args[1:])
    elif case in ("overlap", "long_block"):
        jax_tokw = None
        rows = [4, 2] if case == "overlap" else [0]
        k = len(rows)
        tok = tokc.numpy().astype(np.int64)
        totals = [int(_token_lengths(tok, plan.lut[r]).sum()) for r in rows]
        bit0 = np.array([0, totals[0] + 5][:k], np.int64)
        nseg = [t // 256 + 1 for t in totals]
        nlanes = 4096 if case == "long_block" else sum(nseg) + 3
        args = [tokc, torch.zeros(k, dtype=torch.int32),
                torch.full((k,), tokc.numel(), dtype=torch.int32),
                torch.from_numpy(bit0),
                torch.from_numpy(plan.lut[rows].copy()),
                (int(bit0[-1]) + totals[-1]) // 32 + 2]
        meta = torch.from_numpy(np.stack(
            [np.full(k, 256), np.concatenate([[0], np.cumsum(nseg)[:-1]]),
             np.array([0, 7][:k])], 1).astype(np.int32))
        init = torch.from_numpy(np.arange(nlanes, dtype=np.int32) * 3)
    return dict(tokw=tokw, lengths=lengths, plan=plan, jax_tokw=jax_tokw,
                args=tuple(args), plain_args=plain_args or tuple(args),
                lanes=(meta, init))


@pytest.mark.parametrize("case", PACK_FLAT_EDGE_CASES)
def test_pack_flat_edges_match_plain(dev, case):
    """pack_flat and pack_flat_lanes vs their plain versions on
    pack_flat_edge_batch, tolerance 0: blocks of 1, 2, 2,047-2,049 and
    several tiles' tokens, COPY/FILL/empty blocks between HUFF ones, a
    token spanning the word two tiles share, segment boundaries crossed
    by a tile's first token and by a block's last one (no entry), nwords
    one word short, tokc cut inside a block, overlapping blocks (more
    tiles than status words), 1,080-1,152 tiles (more than the resident
    CTAs; look-backs past 32 tiles); 3 launches give the same words."""
    x = pack_flat_edge_batch(np.random.default_rng(110), case)
    cov = pack_flat_edges_covered(x)
    check_pack_flat_edges_covered(case, cov)
    assert ck._lib().rspt_pack_flat_tile() == PACK_TILE
    assert ck._lib().rspt_pack_flat_state(
        x["args"][2].numel(), x["args"][0].numel()) == 2 * (
            1 + cov["status_words"])
    args, plain_args = (tuple(a.to(dev) if torch.is_tensor(a) else a
                              for a in x[k]) for k in ("args", "plain_args"))
    lanes = tuple(t.to(dev) for t in x["lanes"])
    want = ck.pack_flat_plain(*plain_args)
    want_l = ck.pack_flat_lanes_plain(*plain_args, *lanes)
    assert torch.equal(want_l[0], want) and bool(want.any())
    for _ in range(3):
        assert torch.equal(ck.pack_flat(*args), want)
        got = ck.pack_flat_lanes(*args, *lanes)
        assert torch.equal(got[0], want) and torch.equal(got[1], want_l[1])


def place_edge_batch(rng, steps, S):
    """place_literals inputs that keep hzr_decode's contract, with the
    edges of the kernel's word stores: emissions (len(steps), S, 8, 128)
    whose lanes each emit literals (sym 0x100 | byte or a nonzero byte,
    one output byte), zero runs (2-8 bytes) and idle steps, garbage in the
    rows at and past a tile's step count and in dead lanes; blocks of 1-300
    lanes whose runs start and end in mid-word, separated by 0-13 host
    bytes (so neighbouring lanes and blocks share words), each block's
    out_limit cutting its last lanes' literals; host bytes (nonzero)
    outside the blocks. Returns (emis, steps, out_base, out_limit,
    lane_live, host) as CPU tensors."""
    nt = len(steps)
    nl = nt * 1024
    emis = rng.integers(-2 ** 31, 2 ** 31 - 1, (nt, S, 1024))
    adv = np.zeros((nt, S, 1024), np.int64)
    for t in range(nt):
        n = min(steps[t], S)
        kind = rng.choice(3, (n, 1024), p=[0.6, 0.15, 0.25])
        adv[t, :n] = np.where(kind == 0, 1, np.where(
            kind == 1, rng.integers(2, 9, (n, 1024)), 0))
        outc = np.cumsum(adv[t, :n], 0) - adv[t, :n]
        byte = rng.integers(0, 256, (n, 1024))
        sym = np.where(rng.random((n, 1024)) < 0.5, 0x100 | byte,
                       np.maximum(byte, 1))
        emis[t, :n] = (outc << 9) | np.where(kind == 0, sym, 0)
    counts = adv.sum(1).reshape(-1)
    live = rng.random(nl) < 0.95
    base = np.zeros(nl, np.int64)
    limit = np.zeros(nl, np.int64)
    blocks = []
    pos, lane = int(rng.integers(0, 14)), 0
    while lane < nl:
        k = min(int(rng.integers(1, 301)), nl - lane)
        lanes = np.arange(lane, lane + k)
        c = np.where(live[lanes], counts[lanes], 0)
        base[lanes] = pos + np.cumsum(c) - c
        end = pos + max(int(c.sum()) - int(rng.integers(0, 6)), 0)
        limit[lanes] = end
        blocks.append((pos, end))
        pos, lane = end + int(rng.integers(0, 14)), lane + k
    host = rng.integers(1, 256, pos + int(rng.integers(0, 14)))
    for a, b in blocks:
        host[a:b] = 0
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    return (i32(emis.reshape(nt, S, 8, 128)), i32(np.asarray(steps)),
            i32(base), i32(limit), torch.from_numpy(live),
            torch.from_numpy(host.astype(np.uint8)))


def place_at_offsets(batch, dev, emis_off, out_off):
    """place_literals on a place_edge_batch with emis at emis_off words
    and out at out_off bytes into larger zeroed buffers, out holding the
    host bytes: (kernel bytes, plain bytes, the buffer around out)."""
    emis, steps, base, limit, live, host = (t.to(dev) for t in batch)
    total = host.numel()
    flat = torch.zeros(emis.numel() + emis_off, dtype=torch.int32,
                       device=dev)
    e = flat[emis_off:].view(emis.shape)
    e.copy_(emis)
    buf = torch.zeros(total + 8, dtype=torch.uint8, device=dev)
    out = buf[out_off:out_off + total]
    out.copy_(host)
    got = ck.place_literals(e, steps, base, limit, live, total, out=out)
    assert got.data_ptr() == out.data_ptr()
    want = ck.place_literals_plain(emis, steps, base, limit, live,
                                   host.clone())
    assert bool(((want != host) & (host != 0)).sum() == 0)
    return got, want, torch.cat([buf[:out_off], buf[out_off + total:]])


@pytest.mark.parametrize("emis_off,out_off", [(0, 0), (1, 3), (2, 1)])
def test_place_literals_word_edges(rng, dev, emis_off, out_off):
    """place_literals vs its plain version on place_edge_batch: runs that
    start and end in mid-word, neighbouring lanes sharing a word, a
    thread's step run (8 of a chunk's 32 steps) ending in mid-word,
    out_limit cutting a word, steps[t] < S and S = 300 (not a multiple of
    the chunk; the deepest tile loops over its chunks), host bytes around
    the device blocks; emis at a
    4-byte but not 16-byte offset (emis_off words) and out at an odd
    byte offset (out_off), with the bytes around out untouched."""
    S = 300
    batch = place_edge_batch(rng, [S, 45, 137, S + 5], S)
    got, want, around = place_at_offsets(batch, dev, emis_off, out_off)
    assert torch.equal(got, want)
    assert not around.any()


def test_packer_device_decode(rng, dev):
    """decompress(device_decode=True) on the card: exact, through both
    kernels; decompress_many equals it."""
    ch, ns = 3, 40000
    native = _sig(rng, ch, ns, 700.0).astype("<i4").tobytes()
    pc = gpack.new_xdelta_hzr(4, ch, ns, 3, device=dev, device_decode=True)
    comp = pc.compress(native)
    before = (ck.hzr_decode.launches, ck.place_literals.launches)
    assert pc.decompress(comp)[0] == native
    assert (ck.hzr_decode.launches, ck.place_literals.launches) == (
        before[0] + 1, before[1] + 1)
    assert pc.decompress_many([comp, comp]) == [native, native]


# fwht's (rows, n): the Hadamard shape and the global passes (n > 2^15),
# n = 2 and 8, rows of 32 and 64 words (the warp's reach), every change
# of the cluster size (1 CTA for n <= 2,048, then 2, 4, 8, 16 CTAs a
# row, then a global pass), 1 and 13 rows, and 1,001 rows of 8 words (no
# multiple of a CTA's 256-row grouping: a partial last CTA)
FWHT_CASES = ((12, 2 ** 14), (3, 2 ** 17), (1, 2 ** 20), (5, 2), (7, 8),
              (13, 32), (13, 64), (1001, 8), (13, 2 ** 11), (1, 2 ** 11),
              (13, 2 ** 12), (1, 2 ** 13), (13, 2 ** 13), (1, 2 ** 14),
              (13, 2 ** 14), (1, 2 ** 15), (13, 2 ** 15), (1, 2 ** 16),
              (13, 2 ** 16))


def fwht_case(rng, rows, n):
    """(rows, n) random int32 words with INT32_MIN/MAX spliced in."""
    x = rng.integers(-2 ** 31, 2 ** 31 - 1, (rows, n), dtype=np.int64)
    x[0, :2] = [-2 ** 31, 2 ** 31 - 1]
    return x.astype(np.int32)


@pytest.mark.parametrize("rows,n", FWHT_CASES)
def test_fwht_matches_plain(rng, dev, rows, n):
    """fwht vs fwht_plain, tolerance 0, at FWHT_CASES' shapes; x is
    unchanged by the call."""
    t = torch.from_numpy(fwht_case(rng, rows, n)).to(dev)
    x0 = t.clone()
    assert torch.equal(ck.fwht(t), ck.fwht_plain(t))
    assert torch.equal(t, x0)


def test_pack_flat_lanes_matches_plain(rng, dev):
    """pack_flat_lanes vs its plain version; its words equal pack_flat's."""
    from rspt_tpu_torch.hzr import sidecar
    ch, ns = 4, 30011
    words = torch.from_numpy(_sig(rng, ch, ns, 60.0)).to(dev)
    enc, _ = ck.xdelta_swizzle(words, ns, ch, 3, 4)
    tokw, _, hist = ck.tokenize_planes(enc, 3)
    _, lengths = tc.block_layout(enc.numel(), 3)
    plan = tc.flat_plan(hist.cpu().numpy(), lengths)
    hp = sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                            plan.comp_len > 0)
    bases = torch.from_numpy(plan.bases).to(dev)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    args = (tokc, bases, torch.from_numpy(plan.ntok).to(dev),
            torch.from_numpy(plan.bit0).to(dev),
            torch.from_numpy(plan.lut).to(dev), plan.nwords,
            torch.from_numpy(hp.meta).to(dev),
            torch.from_numpy(hp.init).to(dev))
    got = ck.pack_flat_lanes(*args)
    want = ck.pack_flat_lanes_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], ck.pack_flat(*args[:6]))


@pytest.mark.parametrize("kind", ["hadamard", "hzr"])
def test_transform_packers_card_equal_cpu(rng, dev, kind):
    """new_hadamard / new_hzr on the card: the CPU's container, and the
    CPU's reconstruction on both decode paths."""
    ch, ns = 3, 8192
    native = _sig(rng, ch, ns, 700.0).astype("<i4").tobytes()
    make = getattr(gpack, "new_" + kind)
    comp = make(4, ch, ns, device=dev).compress(native)
    cpu = make(4, ch, ns, device="cpu")
    assert comp == cpu.compress(native)
    want = cpu.decompress(comp)[0]
    before = ck.fwht.launches
    for dd in (False, True):
        assert make(4, ch, ns, device=dev,
                    device_decode=dd).decompress(comp)[0] == want
    assert ck.fwht.launches - before == (2 if kind == "hadamard" else 0)
    assert (want == native) == (kind == "hzr")


def _block_batch(rng):
    """A HUFF tail block (random padding), a random block, an all-zero
    block and an empty one, with their tables; the random block's codes
    made 20 bits long so that its bits overflow its row."""
    blocks = np.zeros((4, 65536), np.uint8)
    blocks[0] = rng.integers(1, 256, 65536)
    blocks[0, :40000] = np.minimum(rng.geometric(0.3, 40000) - 1, 255)
    blocks[1] = rng.integers(0, 256, 65536)
    lengths = np.array([40000, 65536, 65536, 0], np.int32)
    fields = tc.tokenize_blocks(torch.from_numpy(blocks),
                                torch.from_numpy(lengths))
    codes, cbits, _, desc_bits, _ = tc.host_tables(fields[4].numpy(), lengths)
    codes[1] = np.arange(261) * 2477 & 0xFFFFF
    cbits[1] = 20
    return fields, tc.lut_words(codes, cbits), desc_bits


BLOCKS_TILE = 2048        # pack_blocks' tile: the slots of one CTA
# pack_blocks_edge_batch's cases; the first four also go through the JAX
# pack on the CPU (tests/test_torch_blocks.py)
PACK_BLOCKS_EDGE_CASES = ("n65536", "n2040", "n2056", "n65528",
                          "many_blocks")
PACK_BLOCKS_JAX_CASES = PACK_BLOCKS_EDGE_CASES[:4]


def _slot_tokens(rng, n, straddle=()):
    """n valid pass-1 token words, one a slot, their codes and code bits
    and description bits (the tables' own, moved off a multiple of 32),
    the order chosen so that the token before each tile start in
    `straddle` spans the word it shares with that tile."""
    tok = _pass1_tokens(rng, n)
    codes, cbits, _, dbits = tc.build_block_tables(
        np.bincount(tok & 511, minlength=261))
    dbits += 0 if dbits % 32 else 5
    L = cbits[tok & 511].astype(np.int64) + ((tok >> 9) & 15)
    lo = 0
    for P in straddle:
        _swap_in(tok, L, P - 1, lo + int(np.argmax(L[lo:P - 1])))
        _steer(tok, L, P, lo, P - 1, n, 32, dbits, (1, int(L[P - 1]) - 1),
               rng)
        lo = P + 1
    return tok, codes, cbits, dbits


def _sparse_slots(rng, n, skip):
    """A block of n slots: valid tokens at sorted random slots outside the
    slot range `skip`, junk words without the valid bit elsewhere; with
    its codes, code bits and description bits."""
    row = rng.integers(0, 1 << 27, n)
    free = np.setdiff1d(np.arange(n), np.arange(*skip))
    pos = np.sort(rng.choice(free, free.size // 3, replace=False))
    tok, codes, cbits, dbits = _slot_tokens(rng, pos.size)
    row[pos] = tok
    return row, codes, cbits, dbits


def pack_blocks_edge_batch(rng, case):
    """One edge case of pack_blocks / pack_blocks_tokw (tiles of 2,048
    slots of one block, a status word a tile, each tile's first and last
    words shared with its neighbours).

    n65536: 4 blocks of 65,536 slots: every slot a token, the tokens
    before the starts of tiles 1 and 30 spanning the word two tiles
    share; every slot a token under 20-bit codes, whose bits pass the
    row's nwords in a middle tile (a COPY candidate: total_bits exact);
    sparse tokens with no valid slot in tile 2, between valid tiles;
    junk without a valid slot. n2040: one block of one partial tile.
    n2056: 3 blocks of a full and an 8-slot tile, the token before the
    second spanning the shared word. n65528: 2 blocks of 31 tiles and a
    partial one (dense, the last start straddled; sparse). many_blocks:
    48 dense blocks of 65,536 slots (1,536 tiles, more than 132 x 8
    resident CTAs wait in the look-back). Every description bit count
    is off a multiple of 32.

    Returns a dict of numpy arrays: tokw (nb, n) int32, fields (syms,
    extras, ebits, tvalid: tokw's fields, tokenize_blocks' layout),
    codes (nb, 261) uint32, cbits (nb, 261) int32, lut (nb, 261) int32
    (code | cbits << 24) and desc_bits (nb,) int32."""
    T = BLOCKS_TILE
    if case == "n65536":
        n = 65536
        dense = _slot_tokens(rng, n, (T, 30 * T))
        tok = _pass1_tokens(rng, n)
        wide = (tok, np.arange(261, dtype=np.uint32) * 2477 & 0xFFFFF,
                np.full(261, 20, np.int32), 3)
        blocks = [dense, wide, _sparse_slots(rng, n, (2 * T, 3 * T)),
                  (rng.integers(0, 1 << 27, n), np.zeros(261, np.uint32),
                   np.zeros(261, np.int32), 33)]
    elif case == "n2040":
        blocks = [_slot_tokens(rng, 2040)]
    elif case == "n2056":
        blocks = [_slot_tokens(rng, 2056, (T,)) for _ in range(3)]
    elif case == "n65528":
        blocks = [_slot_tokens(rng, 65528, (31 * T,)),
                  _sparse_slots(rng, 65528, (0, 0))]
    else:
        blocks = [_slot_tokens(rng, 65536) for _ in range(48)]
    tokw = np.stack([b[0] for b in blocks]).astype(np.int32)
    codes = np.stack([b[1] for b in blocks]).astype(np.uint32)
    cbits = np.stack([b[2] for b in blocks]).astype(np.int32)
    desc = np.array([b[3] for b in blocks], np.int32)
    fields = (tokw & 511, (tokw >> 13) & 16383, (tokw >> 9) & 15,
              (tokw >> 27) & 1)
    return dict(tokw=tokw, fields=fields, codes=codes, cbits=cbits,
                lut=tc.lut_words(codes, cbits), desc_bits=desc)


def pack_blocks_edges_covered(x):
    """What a pack_blocks_edge_batch case exercises, counted from its
    arrays with the kernel's 2,048-slot tile: blocks (nb), slots (n),
    tiles, tile starts whose previous token spans the word the two tiles
    share (straddle), tiles without a token between tiles with tokens
    (empty_between), blocks whose bits pass the row in a tile that is
    neither the block's first nor its last (overflow_mid), description
    bit counts off a multiple of 32 (odd_desc)."""
    tokw, lut, desc = x["tokw"].astype(np.int64), x["lut"], x["desc_bits"]
    nb, n = tokw.shape
    T = BLOCKS_TILE
    ntiles = -(-n // T)
    row_bits = 32 * ck.blocks_nwords(n)
    got = dict(nb=nb, n=n, tiles=nb * ntiles, straddle=0, empty_between=0,
               overflow_mid=0, odd_desc=int((desc % 32 != 0).sum()))
    for b in range(nb):
        L = _token_lengths(tokw[b], lut[b])
        xs = int(desc[b]) + np.cumsum(L) - L
        for P in range(T, n, T):
            prev = np.flatnonzero(L[:P])
            if prev.size:
                a = int(xs[P])
                got["straddle"] += int(0 < a % 32 and
                                       xs[prev[-1]] < a - a % 32)
        live = np.add.reduceat(L, np.arange(0, n, T)) > 0
        for k in range(1, ntiles - 1):
            got["empty_between"] += int(not live[k] and live[:k].any()
                                        and live[k + 1:].any())
        end = xs + L
        if end[-1] > row_bits:
            k = int(np.argmax(end > row_bits)) // T
            got["overflow_mid"] += int(0 < k < ntiles - 1)
    return got


def check_pack_blocks_edges_covered(case, cov):
    """Assert that a pack_blocks_edge_batch case reaches what it is built
    for (cov: pack_blocks_edges_covered's counts)."""
    assert cov["odd_desc"] == cov["nb"], cov
    if case != "n2040":
        assert cov["straddle"] > 0, cov
    if case == "n65536":
        assert cov["empty_between"] > 0 and cov["overflow_mid"] > 0, cov
    if case in ("n2040", "n2056", "n65528"):
        assert cov["n"] % BLOCKS_TILE, cov
    if case == "n2040":
        assert cov["nb"] == 1 and cov["tiles"] == 1, cov
    if case == "many_blocks":
        assert cov["nb"] >= 40 and cov["tiles"] > 132 * 8, cov


@pytest.mark.parametrize("case", PACK_BLOCKS_EDGE_CASES)
def test_pack_blocks_edges_match_plain(dev, case):
    """pack_blocks and pack_blocks_tokw vs their plain versions on
    pack_blocks_edge_batch, tolerance 0: n = 65,536, 2,040, 2,056 and
    65,528 (partial last tiles), a token spanning the word two tiles
    share, an empty tile between valid ones, a row overflowing nwords in
    a middle tile (total_bits exact), description bits off a multiple of
    32, nb = 1 and 48 (1,536 tiles); 3 launches give the same words."""
    x = pack_blocks_edge_batch(np.random.default_rng(120), case)
    check_pack_blocks_edges_covered(case, pack_blocks_edges_covered(x))
    assert ck._lib().rspt_pack_blocks_tile() == BLOCKS_TILE
    fields = [torch.from_numpy(np.ascontiguousarray(f)).to(dev)
              for f in x["fields"]]
    tokw, lut, d = (torch.from_numpy(x[k]).to(dev)
                    for k in ("tokw", "lut", "desc_bits"))
    want = ck.pack_blocks_plain(*fields, lut, d)
    assert torch.equal(ck.pack_blocks_tokw_plain(tokw, lut, d)[0], want[0])
    for _ in range(3):
        got = ck.pack_blocks(*fields, lut, d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = ck.pack_blocks_tokw(tokw, lut, d)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pack_blocks_matches_plain(rng, dev):
    """pack_blocks (K13a form) and pack_blocks_tokw (K13b form) vs their
    plain versions: every row (both drop the same overflowing bits) and
    every bit total."""
    fields, lut, desc_bits = _block_batch(rng)
    f = [t.to(dev) for t in fields[:4]]
    lut_d = torch.from_numpy(lut).to(dev)
    d = torch.from_numpy(desc_bits).to(dev)
    got = ck.pack_blocks(*f, lut_d, d)
    want = ck.pack_blocks_plain(*f, lut_d, d)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][1]) > 32 * got[0].shape[1]
    tokw = f[0] | (f[2] << 9) | (f[1] << 13) | (f[3] << 27)
    got_w = ck.pack_blocks_tokw(tokw, lut_d, d)
    assert torch.equal(got_w[0], want[0]) and torch.equal(got_w[1], want[1])
    assert torch.equal(got_w[0], ck.pack_blocks_tokw_plain(tokw, lut_d, d)[0])


def test_encode_card_equals_cpu(rng, dev):
    """encode on the card: the CPU's stream, one pack_blocks launch and no
    flat-pack launch, an exact device decode, the capacity rule."""
    walk = np.cumsum(rng.normal(0, 3, 150000)).astype(np.int64)
    data = (walk & 255).astype(np.uint8)
    data[70000:75000] = 0
    before = (ck.pack_blocks.launches, ck.pack_flat.launches,
              ck.compact_tokens.launches)
    got = tc.encode(data, device=dev)
    assert (ck.pack_blocks.launches, ck.pack_flat.launches,
            ck.compact_tokens.launches) == (before[0] + 1, *before[1:])
    assert got == tc.encode(data, device="cpu")
    assert gd.decode_many([got], device=dev) == [data.tobytes()]
    assert tc.encode(data, len(got), device=dev) == got
    with pytest.raises(ValueError, match="output buffer too small"):
        tc.encode(data, len(got) - 1, device=dev)


def test_compress_with_hints_on_card(rng, dev):
    """compress_with_hints on the card: compress()'s container, the CPU's
    entries, a trusted 0-sweep decode that is exact."""
    ch, ns = 3, 40000
    native = _sig(rng, ch, ns, 30.0).astype("<i4").tobytes()
    p = gpack.new_xdelta_hzr(4, ch, ns, 3, device=dev, device_decode=True)
    comp, hints = p.compress_with_hints(native)
    assert comp == p.compress(native)
    _, h_cpu = gpack.new_xdelta_hzr(4, ch, ns, 3, device="cpu"
                                    ).compress_with_hints(native)
    assert np.array_equal(hints.entries, h_cpu.entries)
    gd._hint_registry.clear()
    assert p.decompress_many([comp], hints=hints) == [native]
    assert p.decode_info["hinted"] and max(p.decode_info["fp_iters"]) == 0


@pytest.mark.parametrize("bps,vals,planes,size", [
    (1, [-1, -1], 1, 18),
    (2, [0, 32767, -32768, 0], 2, 39),
    (3, [0, 2 ** 23 - 1, -2 ** 23, 0], 3, 58)])
def test_xdelta_growth_small_bps_on_card(dev, bps, vals, planes, size):
    """The verify-and-grow flag at bps < 4 on the card: the reference's
    plane count and container (the CPU port's), an exact round trip."""
    v = np.array(vals, np.int64)
    native = np.stack([(v >> (8 * k)) & 255 for k in range(bps)],
                      -1).astype(np.uint8).tobytes()
    p = gpack.new_xdelta_hzr(bps, 1, len(vals), 1, device=dev)
    comp = p.compress(native)
    cpu = gpack.new_xdelta_hzr(bps, 1, len(vals), 1, device="cpu")
    assert comp == cpu.compress(native)
    assert (p.nr_planes, len(comp)) == (planes, size)
    assert p.decompress(comp)[0] == native


XDELTA_TILE_WORDS = 4096  # xdelta_swizzle's most samples x channels a CTA
XDELTA_BAND = 32          # xdelta_swizzle's most channels a CTA
XDELTA_CHUNK = 6          # xdelta_swizzle's channels a thread
H100_SMS = 132
XDELTA_EDGE_CASES = ("tiles", "short", "ch1", "band_split", "misaligned",
                     "native", "fail_first", "fail_last")


def xdelta_tile(ns, ch, sms=H100_SMS):
    """Samples of one xdelta_swizzle tile of ns x ch on a card of sms SMs:
    a multiple of 16, at most XDELTA_TILE_WORDS / band and 1,024 / the
    channel groups of XDELTA_CHUNK (a thread each), as few as fill whole
    waves of one CTA an SM."""
    band = min(ch, XDELTA_BAND)
    bands = -(-ch // band)
    groups = -(-band // XDELTA_CHUNK)
    s_max = min(XDELTA_TILE_WORDS // band, 1024 // groups) // 16 * 16
    ctas = -(-ns // s_max) * bands
    tiles = max(1, -(-ctas // sms)) * sms // bands
    per = -(-ns // tiles)
    return -(-per // 16) * 16


def native_bytes(sig, bps):
    """(samples, channels) int64 → interleaved little-endian bps-byte
    samples, flat uint8."""
    v = sig.reshape(-1).astype(np.int64)
    return np.stack([(v >> (8 * k)) & 255 for k in range(bps)],
                    -1).astype(np.uint8).reshape(-1)


def _extreme_signal(rng, ns, ch, bps):
    """(ns, ch) int64 samples of bps bytes: random, with the extremes
    -2^(8·bps-1) and 2^(8·bps-1) - 1 at the first sample and at each
    channel boundary (the last sample of a channel, then the first of the
    next: the chain's wrap across channels)."""
    lo, hi = -(1 << (8 * bps - 1)), (1 << (8 * bps - 1)) - 1
    sig = rng.integers(lo, hi + 1, (ns, ch), dtype=np.int64)
    sig[0, 0] = lo
    sig[-1, :] = hi
    sig[0, 1:] = lo
    if ns > 1:
        sig[1, 0] = hi
    return sig


def _spike(ns, ch, s, c, planes):
    """A zero signal (xdelta -128, 0, 0, ...: fits one plane) with one
    sample at (s, c) whose xdelta values need more than `planes` bytes."""
    sig = np.zeros((ns, ch), np.int64)
    sig[s, c] = (1 << (8 * planes + 1)) + 3
    return sig


def xdelta_edge_batch(rng, case, sms=H100_SMS):
    """xdelta_swizzle's inputs on the edges of its tiles, bands, loads and
    flag, as (x, ns, ch, planes, bps, swizzle, off) with x a numpy array:
    int32 interleaved words (swizzle) or a channel-major signal (not), or
    uint8 native bytes; off the elements by which the card's view of x
    starts past a 16-byte-aligned address (off > 0: the scalar loads).
    Tiles of S = xdelta_tile(ns, ch, sms) samples: "tiles": at 12
    channels a last tile of S - 1 samples, all tiles full, a last tile of
    1 sample (S = 16, 132 CTAs), and two waves of tiles; "short": 1, 2
    and 3 samples at 1 and 12 channels; "ch1": one channel, and a flat
    signal; "band_split": 40 channels (a band of 32 and one of 8);
    "misaligned": word and byte views 4, 1 and 8 bytes off alignment;
    "native": the bytes at bps 1-4 with their extremes; "fail_first" /
    "fail_last": one value that does not fit the planes, in the first CTA
    / the last CTA (of the last band)."""
    out = []

    def add(sig, planes, bps, u8=True, off=0):
        ns, ch = sig.shape
        x = (native_bytes(sig, bps) if u8
             else sig.reshape(-1).astype(np.uint32).view(np.int32))
        out.append((x, ns, ch, planes, bps, True, off))

    if case == "tiles":
        s16 = 16 * sms
        for ns in (s16 - 1, s16, s16 - 15, 50001):
            add(_extreme_signal(rng, ns, 12, 4), 3, 4, u8=False)
        for ns in (s16 - 1, s16 - 15):
            add(_extreme_signal(rng, ns, 12, 2), 1, 2)
    elif case == "short":
        for ns in (1, 2, 3):
            for ch in (1, 12):
                add(_extreme_signal(rng, ns, ch, 4), 2, 4, u8=False)
                add(_extreme_signal(rng, ns, ch, 3), 2, 3)
    elif case == "ch1":
        add(_extreme_signal(rng, 4097, 1, 4), 3, 4, u8=False)
        add(_extreme_signal(rng, 4097, 1, 1), 1, 1)
        flat = np.cumsum(rng.integers(-300, 300, 70001)).astype(np.int32)
        out.append((flat, flat.size, 1, 1, 3, False, 0))
        out.append((flat, 1, flat.size, 2, 4, False, 0))
    elif case == "band_split":
        ns = 16 * sms // 2 + 1
        add(_extreme_signal(rng, ns, 40, 4), 3, 4, u8=False)
        add(_extreme_signal(rng, ns, 40, 3), 2, 3)
        add(_extreme_signal(rng, 2, 40, 2), 1, 2)
        add(np.zeros((ns, 40), np.int64), 1, 4, u8=False)   # flag 1
    elif case == "misaligned":
        sig = _extreme_signal(rng, 3001, 12, 4)
        add(sig, 3, 4, u8=False, off=1)
        add(sig, 3, 4, off=1)
        add(_extreme_signal(rng, 3001, 12, 3), 2, 3, off=1)
        add(_extreme_signal(rng, 3001, 12, 2), 1, 2, off=8)
    elif case == "native":
        for bps in (1, 2, 3, 4):
            sig = _extreme_signal(rng, 3001, 12, bps)
            for planes in range(1, 5):
                add(sig, planes, bps)
    else:
        ns = 5003
        at = (5, 0) if case == "fail_first" else (ns - 1, 11)
        add(_spike(ns, 12, *at, 1), 1, 4, u8=False)
        add(_spike(ns, 12, *at, 1), 1, 2)
        add(_spike(ns, 12, *at, 2), 2, 3)
        if case == "fail_last":
            n40 = 2003
            add(_spike(n40, 40, n40 - 1, 39, 1), 1, 4, u8=False)
    return out


def device_view(x, off, dev):
    """x on the card as a view starting off elements past a 16-byte
    aligned address."""
    buf = torch.zeros(x.size + off, dtype=torch.from_numpy(x[:0]).dtype,
                      device=dev)
    buf[off:].copy_(torch.from_numpy(np.ascontiguousarray(x)))
    v = buf[off:]
    assert v.data_ptr() % 16 == (off * x.itemsize) % 16
    return v


@pytest.mark.parametrize("case", XDELTA_EDGE_CASES)
def test_xdelta_edges_match_plain(dev, case):
    """xdelta_swizzle vs its plain version on its tile, band, load and
    flag edges, values and flag bit for bit; the tile and band sizes
    equal the kernel's; a failing case's flag is 0."""
    lib = ck._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lib.rspt_xdelta_band() == XDELTA_BAND
    batch = xdelta_edge_batch(np.random.default_rng(120), case, sms)
    for _, ns, ch, _, _, swizzle, _ in batch:
        shape = (ns, ch) if swizzle else (ns * ch, 1)
        assert lib.rspt_xdelta_tile(*shape) == xdelta_tile(*shape, sms)
    for x, ns, ch, planes, bps, swizzle, off in batch:
        t = device_view(x, off, dev)
        got = ck.xdelta_swizzle(t, ns, ch, planes, bps, swizzle)
        want = ck.xdelta_swizzle_plain(t, ns, ch, planes, bps, swizzle)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        if case.startswith("fail"):
            assert int(got[1]) == 0


def xdelta_alternating(dev, calls=100):
    """calls xdelta_swizzle launches in a row on one stream, alternating a
    passing input and one failing in the first or the last CTA: each flag
    and each output equal to the plain version's (every call leaves the
    kernel's flag state ready for the next). Returns the flags."""
    ns, ch = 5003, 12
    ins = [torch.from_numpy(native_bytes(sig, 4).view(np.int32)).to(dev)
           for sig in (np.zeros((ns, ch), np.int64),
                       _spike(ns, ch, 5, 0, 1),
                       _spike(ns, ch, ns - 1, ch - 1, 1))]
    wants = [ck.xdelta_swizzle_plain(x, ns, ch, 1, 4, True) for x in ins]
    flags = []
    for k in range(calls):
        i = 0 if k % 2 == 0 else 1 + (k // 2) % 2
        got = ck.xdelta_swizzle(ins[i], ns, ch, 1, 4)
        assert torch.equal(got[0], wants[i][0]), k
        assert torch.equal(got[1], wants[i][1]), k
        flags.append(int(got[1]))
    assert flags == [1 - k % 2 for k in range(calls)]
    return flags


def test_xdelta_flag_state_resets(dev):
    """100 calls alternating passing and failing inputs: every flag right,
    so the flag state is ready for the next call after each one."""
    xdelta_alternating(dev)


def xdelta_batch(rng, bps, batch, ns, ch, fail=(1,)):
    """xdelta_swizzle_batch's input: `batch` payloads of ns x ch samples
    of bps bytes at planes = max(1, bps - 1) (the flag is checked below
    bps), as (x, ns, ch, planes): x (batch, ns * ch) int32 words at bps
    4, else (batch, ns * ch * bps) uint8 native bytes. Payloads in `fail`
    hold one sample, in their last tile, whose xdelta values need more
    than `planes` bytes (flag 0 where planes < bps); the others are
    random within what `planes` planes keep (zeros at 1 plane: flag 1)."""
    planes = max(1, bps - 1)
    rows = []
    for b in range(batch):
        if b in fail:
            sig = _spike(ns, ch, ns - 2, ch // 2, planes)
        elif planes == 1:
            sig = np.zeros((ns, ch), np.int64)
        else:
            lim = 1 << (8 * planes - 5)
            sig = rng.integers(-lim, lim, (ns, ch), dtype=np.int64)
        rows.append(native_bytes(sig, bps))
    x = np.stack(rows)
    if bps == 4:
        x = x.view(np.int32)
    return x, ns, ch, planes


# (batch, bps, ns, ch): batches of 1, 2 and 9, bps 1-4, payloads that end
# inside a tile, 40 channels in two bands
XDELTA_BATCH_CASES = ((1, 4, 5003, 12), (2, 3, 4096, 12), (9, 2, 1000, 12),
                      (9, 4, 4096, 12), (3, 1, 1001, 40), (2, 4, 3001, 40))


# (batch, planes, plane_len) of the 2-D tokenize_planes: batches of 1, 2
# and 9, planes 1-4, plane lengths on and off the 64 KiB slab
TOKENIZE_BATCH_CASES = ((1, 3, 70001), (2, 1, 2 * 65536), (9, 4, 49152),
                        (9, 2, 4097))


@pytest.mark.parametrize("batch,bps,ns,ch", XDELTA_BATCH_CASES)
def test_xdelta_swizzle_batch_matches_plain(dev, batch, bps, ns, ch):
    """xdelta_swizzle_batch vs its plain version on XDELTA_BATCH_CASES."""
    check_xdelta_batch_case(dev, batch, bps, ns, ch)


def check_xdelta_batch_case(dev, batch, bps, ns, ch):
    """xdelta_swizzle_batch vs its plain version and vs xdelta_swizzle a
    payload, values and flags bit for bit, with flags that differ per
    payload; the tile equals the kernel's; every ticket counter is back
    at 0."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = ck._lib()
    assert lib.rspt_xdelta_tile_batch(ns, ch, batch) == xdelta_tile(
        ns, ch, max(1, sms // batch))
    assert lib.rspt_xdelta_tile_batch(ns, ch, 1) == lib.rspt_xdelta_tile(
        ns, ch)
    x, ns, ch, planes = xdelta_batch(np.random.default_rng(140 + batch), bps,
                                     batch, ns, ch, range(1, batch, 2))
    t = torch.from_numpy(x).to(dev)
    n0 = ck.xdelta_swizzle_batch.launches
    enc, ok = ck.xdelta_swizzle_batch(t, ns, ch, planes, bps)
    assert ck.xdelta_swizzle_batch.launches == n0 + 1
    want = ck.xdelta_swizzle_batch_plain(t, ns, ch, planes, bps)
    assert torch.equal(enc, want[0]) and torch.equal(ok, want[1])
    flags = [int(planes >= bps or b % 2 == 0) for b in range(batch)]
    assert ok.tolist() == flags
    for b in range(batch):
        e1, ok1 = ck.xdelta_swizzle(t[b], ns, ch, planes, bps)
        assert torch.equal(enc[b], e1) and int(ok1) == flags[b]
    torch.cuda.synchronize()
    assert not ck._xdelta_ticket(dev, batch).any()


@pytest.mark.parametrize("batch,planes,plane_len", TOKENIZE_BATCH_CASES)
def test_tokenize_planes_2d_matches_plain(dev, batch, planes, plane_len):
    """The 2-D tokenize_planes vs its plain version on
    TOKENIZE_BATCH_CASES."""
    check_tokenize_batch_case(dev, batch, planes, plane_len)


def check_tokenize_batch_case(dev, batch, planes, plane_len):
    """The 2-D tokenize_planes vs its plain version and vs the 1-D form
    on the first and last payload (rows payload-major), in one launch."""
    rng = np.random.default_rng(150 + batch)
    x = rng.integers(-(1 << 20), 1 << 20, (batch, plane_len)).astype(np.int32)
    x[rng.random(x.shape) < 0.5] = 0
    x[0, :min(plane_len, 20000)] = 0
    t = torch.from_numpy(x).to(dev)
    n0 = ck.tokenize_planes.launches
    got = ck.tokenize_planes(t, planes)
    assert ck.tokenize_planes.launches == n0 + 1
    for g, w in zip(got, ck.tokenize_planes_plain(t, planes)):
        assert torch.equal(g, w)
    nb = planes * -(-plane_len // 65536)
    for b in (0, batch - 1):
        one = ck.tokenize_planes(t[b], planes)
        for g, w in zip(got, one):
            assert torch.equal(g[b * nb:(b + 1) * nb], w)


def test_compress_many_card_equals_cpu(rng, dev):
    """compress_many on the card: the CPU's containers (8 payloads, two
    pipelined waves, and a batch of 3 whose middle payload grows the
    planes to 4), one xdelta_swizzle_batch and one tokenize_planes launch
    per level probed, one compact_tokens and one pack_flat per wave or
    per level packed."""
    ch, ns = 3, 4096
    srcs = [np.ascontiguousarray(np.cumsum(rng.normal(
        0, 300 * (k + 1), (ch, ns)), axis=1).astype(np.int32).T)
        .astype("<i4").tobytes() for k in range(8)]
    big = np.zeros((ns, ch), np.int32)
    big[1::2] = 2 ** 24
    for batch in (srcs, [srcs[0], big.tobytes(), srcs[1]]):
        for k in ck.KERNELS:
            k.launches = 0
        pg = gpack.new_xdelta_hzr(4, ch, ns, 3)
        got = pg.compress_many(batch)
        pc = gpack.new_xdelta_hzr(4, ch, ns, 3, device="cpu")
        assert got == pc.compress_many(batch)
        assert pg.nr_planes == pc.nr_planes == 3 + (len(batch) == 3)
        # probed: 3 planes (and 4); packed: 2 waves of the one level, or
        # the levels 3 and 4 one call each
        assert ck.xdelta_swizzle_batch.launches == pg.nr_planes - 2
        assert ck.tokenize_planes.launches == pg.nr_planes - 2
        assert ck.compact_tokens.launches == 2
        assert ck.pack_flat.launches == 2
        assert ck.xdelta_swizzle.launches == 0


def _windows_batch(rng, dev):
    """A 3-plane batch with a block of 8 groups (a dense skewed plane 0
    with one long zero run), a short one-group block, FILL blocks and a
    COPY block: its token words, plan, bases, group layout and
    histograms."""
    n = 65536 + 3000
    p0 = np.minimum(rng.geometric(0.45, n), 200)
    p0[20000:25000] = 0
    p2 = np.where(rng.random(n) < 0.05, rng.integers(1, 256, n), 0)
    p2[65536:] = rng.integers(0, 256, n - 65536)
    x = (p0 | (3 << 8) | (p2 << 16)).astype(np.int32)
    tokw, _, hist = ck.tokenize_planes(torch.from_numpy(x).to(dev), 3)
    _, lengths = tc.block_layout(n, 3)
    hist_np = hist.cpu().numpy()
    plan = tc.flat_plan(hist_np, lengths)
    bases = torch.from_numpy(plan.bases).to(dev)
    return tokw, plan, bases, tc.group_layout(plan, dev), hist_np


def test_windows_kernels_match_plain(rng, dev):
    """compact_tokens, group_windows, place_windows_aligned and
    windows_place_flat against their plain versions on the card; both
    routes' payload bytes equal pack_flat's."""
    tokw, plan, bases, gl, _ = _windows_batch(rng, dev)
    assert gl.ng == 10 and plan.is_copy.any() and plan.is_fill.any()
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    assert torch.equal(ck.compact_tokens_plain(tokw, bases, plan.T), tokc)
    w = ck.group_windows(tokc.reshape(1, -1), gl.lut3)
    for g, p in zip(w, ck.group_windows_plain(tokc.reshape(1, -1), gl.lut3)):
        assert torch.equal(g, p)
    glue = ck.windows_glue(*w, gl.dbg, gl.wog, gl.gfirst, gl.nrows_windows,
                           ck.AR2)
    x1 = ck.place_windows_aligned(*glue, gl.nrows_windows)
    assert torch.equal(x1, ck.place_windows_aligned_plain(
        *glue, gl.nrows_windows))
    fargs = (tokc.reshape(-1, 128), gl.lut3, gl.dbg, gl.wog, gl.gfirst,
             gl.ng, gl.nrows_fused)
    k15 = ck.windows_place_flat(*fargs)
    assert torch.equal(k15, ck.windows_place_flat_plain(*fargs))
    words = ck.pack_flat(tokc, bases, torch.from_numpy(plan.ntok).to(dev),
                         torch.from_numpy(plan.bit0).to(dev),
                         torch.from_numpy(plan.lut).to(dev), plan.nwords)
    nbytes = plan.total_payload
    want = words.cpu().numpy().view(np.uint8)[:nbytes]
    for got in (x1, k15):
        assert np.array_equal(
            got.cpu().numpy().reshape(-1).view(np.uint8)[:nbytes], want)


def test_windows_routes_launch_their_kernels(rng, dev):
    """pack_tokens_fused launches compact_tokens and
    windows_place_flat once, pack_tokens_windows compact_tokens,
    group_windows and place_windows_aligned once; a batch with no HUFF
    block launches no windows kernel."""
    tokw, plan, bases, gl, _ = _windows_batch(rng, dev)
    names = ("compact_tokens", "group_windows", "place_windows_aligned",
             "windows_place_flat", "pack_flat")

    def count(fn):
        for k in ck.KERNELS:
            k.launches = 0
        fn()
        return tuple(getattr(ck, n).launches for n in names)

    assert count(lambda: tc.pack_tokens_fused(
        tokw, bases, plan.T, gl)) == (1, 0, 0, 1, 0)
    assert count(lambda: tc.pack_tokens_windows(
        tokw, bases, plan.T, gl)) == (1, 1, 1, 0, 0)
    copy = torch.from_numpy(rng.integers(0, 1 << 27, (2, 65536)).astype(
        np.int32) | (1 << 27)).to(dev)
    _, lengths = tc.block_layout(65536, 2)
    empty = tc.flat_plan(np.full((2, 261), 300, np.int32), lengths)
    gl0 = tc.group_layout(empty, dev)
    assert gl0.ng == 0
    eb = torch.from_numpy(empty.bases).to(dev)
    for route in (tc.pack_tokens_windows, tc.pack_tokens_fused):
        assert count(lambda: route(copy, eb, 0, gl0))[1:4] == (0, 0, 0)


def windows_many_groups(rng, dev):
    """windows_place_flat's arguments on the card for 160 groups (the
    windows batch 16 times over, more groups than the card has SMs) and
    the plain version's words, checked against pack_flat's payload
    bytes."""
    tokw, _, _, _, hist = _windows_batch(rng, dev)
    _, lengths = tc.block_layout(65536 + 3000, 3)
    big = tokw.repeat(16, 1).contiguous()
    bplan = tc.flat_plan(np.tile(hist, (16, 1)), np.tile(lengths, 16))
    gl = tc.group_layout(bplan, dev)
    assert gl.ng == 160
    bases = torch.from_numpy(bplan.bases).to(dev)
    tokc = ck.compact_tokens(big, bases, bplan.T)
    args = (tokc.reshape(-1, 128), gl.lut3, gl.dbg, gl.wog, gl.gfirst,
            gl.ng, gl.nrows_fused)
    want = ck.windows_place_flat_plain(*args)
    words = ck.pack_flat(tokc, bases, torch.from_numpy(bplan.ntok).to(dev),
                         torch.from_numpy(bplan.bit0).to(dev),
                         torch.from_numpy(bplan.lut).to(dev), bplan.nwords)
    n = bplan.total_payload
    assert np.array_equal(want.cpu().numpy().reshape(-1).view(np.uint8)[:n],
                          words.cpu().numpy().view(np.uint8)[:n])
    return args, want


def test_windows_place_flat_many_groups(rng, dev):
    """windows_place_flat on 160 groups (the batch 16 times over, more
    groups than the card has SMs): its look-back carry gives the plain
    version's words, and pack_flat's payload bytes, on every one of 10
    launches, with no super on the slow path."""
    args, want = windows_many_groups(rng, dev)
    for _ in range(10):
        assert torch.equal(ck.windows_place_flat(*args), want)
        assert int(ck.windows_place_flat.last_slow) == 0


# windows_place_flat (K15) places a live super (4,096 tokens, one CTA)
# directly at its bits unless a valid token has cbits > 23, code >=
# 2^cbits or extra >= 2^ebits, or the super's word base needs the clamp;
# each case: the supers it sends to that exact slow path, which
# tests/test_torch_windows.py's model of the kernel counts the same. X1
# runs on each case's windows and glue too.
WINDOWS_EDGE_CASES = {
    "extra_out_of_field": 1,   # one token's extra past its ebits
    "code_out_of_field": 1,    # one LUT code past its cbits
    "cbits_27_31": 2,          # ebits 15: chunks past D_CLAMP in a super
    "cbits_49_63": 2,          # ebits 15: tokens past loc 254 in a chunk
    "base_clamp_low": 1,       # a negative dbg: the base below word 0
    "base_clamp_high": 1,      # a short nrows: the base past the top
    "one_token": 0,            # one group, one valid token (its last)
    "all_dead": 0,             # no token with bits, codes past cbits 0
    "many_groups": 0,          # 20 groups of one block: 38 tiles back
}


def _window_groups(rng, ng, cbits=(1, 12), ebits=(0, 3), extra=True,
                   nsym=250):
    """ng groups of valid tokens (sym < nsym, ebits in the range, extra
    < 2^ebits, or 0) and their LUTs (cbits in the range, code <
    2^min(cbits, 24); entries 261-383 zero): (tok (ng, 8192), lut (ng,
    384)) int64."""
    cb = rng.integers(cbits[0], cbits[1] + 1, (ng, 384))
    code = rng.integers(0, 1 << 24, (ng, 384)) & ((1 << np.minimum(cb, 24))
                                                   - 1)
    lut = code | (cb << 24)
    lut[:, 261:] = 0
    eb = rng.integers(ebits[0], ebits[1] + 1, (ng, ck.GROUP_TOK))
    ex = rng.integers(0, 1 << 14, (ng, ck.GROUP_TOK)) & ((1 << eb) - 1)
    if not extra:
        ex[:] = 0
    tok = (rng.integers(0, nsym, (ng, ck.GROUP_TOK)) | (eb << 9) | (ex << 13)
           | (1 << 27))
    return tok, lut


def window_bits(tok, lut):
    """Each token's bits (0 for an invalid one): (ng, 8192) int64."""
    sym = tok & 511
    idx = np.where(sym < 256, sym, 256 + (sym & 127))
    e = np.take_along_axis(lut & 0xFFFFFFFF, idx, 1)
    return np.where((tok >> 27) & 1 == 1, (e >> 24) + ((tok >> 9) & 15), 0)


def window_layout(tok, lut, blocks, dbg=None, gap=64, nrows=None):
    """K15's inputs for groups tok/lut in blocks of the given group
    counts: each block's payload at a byte offset past the previous
    one's end plus gap bytes, dbg[b] description bits (random < 300 by
    default); nrows: the payload words + 2 and 48 rows, rounded up to 8
    (torch_coder.group_layout's fused rows) unless given. Returns
    (tokc (ng * 64, 128), lut3 (ng, 3, 128), dbg, wog, gfirst (ng,)),
    int32 CPU tensors, ng and nrows."""
    ng = tok.shape[0]
    if dbg is None:
        dbg = np.random.default_rng(ng).integers(0, 300, len(blocks))
    gtot = window_bits(tok, lut).sum(1)
    wog, gdbg, gfirst = (np.zeros(ng, np.int64) for _ in range(3))
    g = off = 0
    for b, n in enumerate(blocks):
        wog[g:g + n], gdbg[g:g + n], gfirst[g:g + n] = off, dbg[b], g
        off += -(-(int(dbg[b]) + int(gtot[g:g + n].sum())) // 8) + gap
        g += n
    assert g == ng
    if nrows is None:
        nrows = -(-(-(-(off // 4 + 2) // 128) + 48) // 8) * 8

    def t(a, *shape):
        return torch.from_numpy(np.asarray(a).astype(np.int32).reshape(shape))

    return (t(tok, ng * 64, 128), t(lut, ng, 3, 128), t(gdbg, ng),
            t(wog, ng), t(gfirst, ng), ng, nrows)


def windows_edge_batch(rng, case):
    """windows_place_flat's arguments for a WINDOWS_EDGE_CASES case (CPU
    tensors). Supers whose placement is clamped or piles chunks up stay
    clear of every other super's span."""
    if case == "extra_out_of_field":
        tok, lut = _window_groups(rng, 3)
        # tile 1's token 2,000: extra 100 with ebits 2
        tok[0, 4096 + 2000] = 7 | (2 << 9) | (100 << 13) | (1 << 27)
        return window_layout(tok, lut, [2, 1])
    if case == "code_out_of_field":
        tok, lut = _window_groups(rng, 3)
        lut[1, 255] = 9 | (3 << 24)          # code 9 with cbits 3
        tok[1, 1234] = 255 | (1 << 27)       # the only sym 255: tile 2
        return window_layout(tok, lut, [2, 1])
    if case in ("cbits_27_31", "cbits_49_63"):
        lo = 27 if case == "cbits_27_31" else 49
        wide, wlut = _window_groups(rng, 1, cbits=(lo, lo + 4 + 10 * (
            lo == 49)), ebits=(15, 15), extra=lo == 27)
        tok, lut = _window_groups(rng, 1)
        return window_layout(np.concatenate([wide, tok]),
                             np.concatenate([wlut, lut]), [1, 1])
    if case == "base_clamp_low":
        tok, lut = _window_groups(rng, 2)
        tok[0, 4096:] &= ~(1 << 27)          # super 1 dead
        # gb = -2,085: (gb >> 5) = -66 words, clamped to 0
        return window_layout(tok, lut, [1, 1], dbg=np.array([-2085, 37]),
                             gap=1024)
    if case == "base_clamp_high":
        tok, lut = _window_groups(rng, 2)
        tok[1, 4096:] &= ~(1 << 27)          # super 3 dead
        a = window_layout(tok[:1], lut[:1], [1])
        top = (a[-1] - 48) * 128             # the clamp of nrows rows
        dbg = np.array([int(a[2][0]), 5])
        b = window_layout(tok, lut, [1, 1], dbg=dbg, nrows=a[-1])
        b[3][1] = 4 * (top + 300)            # group 1 above the clamp
        return b
    if case == "one_token":
        tok, lut = _window_groups(rng, 1)
        tok[0, :-1] &= ~(1 << 27)
        lut[0, 5] = 45 | (6 << 24)
        tok[0, -1] = 5 | (3 << 9) | (5 << 13) | (1 << 27)   # 9 bits
        return window_layout(tok, lut, [1])
    if case == "all_dead":
        tok, lut = _window_groups(rng, 2, cbits=(0, 0), ebits=(0, 0))
        lut[:, :261] |= rng.integers(1, 1 << 24, (2, 261))  # past cbits 0
        tok[:, ::3] &= ~(1 << 27)
        return window_layout(tok, lut, [1, 1])
    if case == "many_groups":
        tok, lut = _window_groups(rng, 20)
        return window_layout(tok, lut, [20])
    raise ValueError(case)


def group_windows_args(args):
    """group_windows' arguments for windows_place_flat's (a
    WINDOWS_EDGE_CASES case, or windows_many_groups' batch): the groups'
    tokens as one (1, ng * 8192) row and their LUTs."""
    tokc, lut3, *_ = args
    return tokc.reshape(1, -1)[:, :lut3.shape[0] * ck.GROUP_TOK], lut3


# group_windows (K14) takes a tile of K14_TILE tokens a CTA
# (windows.cu's kGwTile, rspt_group_windows_tile()), its group-local bit
# from the bits of its group's earlier tokens. Its own edges: one group;
# tile prefixes ending at bit 0 and at bit 31 of a word; a group whose
# chunks are all dead but its last.
K14_TILE = 2048
K14_EDGE_CASES = ("one_group", "prefix_bit_0_31", "dead_but_last")


def k14_edge_batch(rng, case):
    """group_windows' arguments for a K14_EDGE_CASES case: (tokc (1, ng *
    8192), lut3 (ng, 3, 128)) int32 CPU tensors."""
    if case == "one_group":
        tok, lut = _window_groups(rng, 1)
    elif case == "prefix_bit_0_31":
        # at each tile edge k * K14_TILE of 2 groups in turn, the group's
        # bits before it = 0 (mod 32), then 31: the 3 tokens before the
        # edge get ebits summing to what is missing
        tok, lut = _window_groups(rng, 2)
        edges = [(g, k * K14_TILE) for g in range(2)
                 for k in range(1, ck.GROUP_TOK // K14_TILE)]
        for n, (g, e) in enumerate(edges):
            want = 31 * (n % 2)
            tok[g, e - 3:e] &= ~np.int64((15 << 9) | (16383 << 13))
            d = (want - int(window_bits(tok[g:g + 1, :e], lut[g:g + 1])
                            .sum())) % 32
            for i, eb in enumerate((min(d, 15), min(max(d - 15, 0), 15),
                                    max(d - 30, 0))):
                tok[g, e - 3 + i] |= (eb << 9) | (int(
                    rng.integers(0, 1 << eb)) << 13)
            got = int(window_bits(tok[g:g + 1, :e], lut[g:g + 1]).sum())
            assert got % 32 == want and got > 0
    elif case == "dead_but_last":
        tok, lut = _window_groups(rng, 2)
        tok[1, :-128] &= ~(1 << 27)          # group 1: chunks 0-62 dead
        tok[1, -128:] = (rng.integers(0, 250, 128) | (2 << 9) | (3 << 13)
                         | (1 << 27))
    else:
        raise ValueError(case)
    ng = tok.shape[0]
    return (torch.from_numpy(tok.astype(np.int32).reshape(1, -1)),
            torch.from_numpy(lut.astype(np.int32).reshape(ng, 3, 128)))


def x1_inputs(args):
    """place_windows_aligned's arguments for windows_place_flat's: its
    windows (group_windows' plain version) and windows_glue's 56-row
    arrays at nrows + 8 (group_layout's windows rows)."""
    _, _, dbg, wog, gfirst, _, nrows = args
    w = ck.group_windows_plain(*group_windows_args(args))
    return (*ck.windows_glue(*w, dbg, wog, gfirst, nrows + 8, ck.AR2),
            nrows + 8)


# place_windows_aligned's own edges, on the windows of 3 groups (6
# supers), each live super's span in its own 8,192 words
X1_EDGE_CASES = ("nonmonotone", "dropped_chunks", "wrap", "t_apart",
                 "sbits_0", "sbits_31", "sbits_past_31", "wbase_edges",
                 "dead_supers")


def x1_edge_batch(rng, case):
    """place_windows_aligned's arguments for an X1_EDGE_CASES case: the
    windows of 3 groups with the glue's arrays replaced. Super s's span
    lies in words [8,192 (s + 1), + 7,168) (its base rounds down to a
    multiple of 1,024 words), so no two share a word."""
    tok, lut = _window_groups(rng, 3)
    tokc, lut3, dbg, wog, gfirst, ng, _ = window_layout(tok, lut, [2, 1])
    w0, w1, *_ = ck.group_windows_plain(tokc.reshape(1, -1), lut3)
    nsup = ng * 2
    nc = nsup * 32
    nrows = (nsup + 2) * 64
    d = np.minimum(np.arange(32) * 150, ck.D_CLAMP)[None].repeat(nsup, 0)
    t = d.copy()
    wbase = 8192 * np.arange(1, nsup + 1) + rng.integers(0, 1024, nsup)
    sbits = rng.integers(0, 32, nsup)
    slive = np.ones(nsup, np.int64)
    if case == "nonmonotone":
        d = rng.integers(0, 56 * 128, (nsup, 32))
        t = d
    elif case == "dropped_chunks":   # rc >= 56 or < 0: the chunk dropped
        d[:, ::5] = 56 * 128 + rng.integers(0, 5000, (nsup, 7))
        d[:, 1::7] = -rng.integers(1, 5000, (nsup, 5))
        t = rng.integers(-1000, 1000, (nsup, 32))
    elif case == "wrap":   # windows past word 7,167 wrap to word 0
        d = 55 * 128 + rng.integers(0, 128, (nsup, 32))
        d[:, :8] = np.arange(8) * 40
        t = d
    elif case == "t_apart":   # t (drow) and rc (dlane) from other offsets
        t = rng.integers(0, 1 << 20, (nsup, 32))
    elif case == "sbits_0":
        sbits[:] = 0
    elif case == "sbits_31":
        sbits[:] = 31
    elif case == "sbits_past_31":   # the kernel reads sbits & 31
        sbits += 32 * rng.integers(1, 4, nsup)
    elif case == "wbase_edges":   # spans cut at word 0 and at the top
        wbase[0] = -3000
        wbase[-1] = (nrows - 56) * 128 + 4000
    elif case == "dead_supers":
        slive[1::2] = 0
    else:
        raise ValueError(case)

    def i32(a, *shape):
        return torch.from_numpy(np.asarray(a).astype(np.int32).reshape(shape))

    return (w0, w1, i32(t, 1, nc, 1), i32(d, 1, nsup, 32),
            i32(wbase, 1, nsup, 1), i32(sbits, 1, nsup, 1),
            i32(slive, 1, nsup, 1), nrows)


@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES))
def test_windows_edges_match_plain(dev, case):
    """windows_place_flat on each WINDOWS_EDGE_CASES case equals its plain
    version, with the case's supers on the slow path, in 3 launches; X1
    on the case's windows and glue equals its plain version."""
    args = tuple(a.to(dev) if torch.is_tensor(a) else a
                 for a in windows_edge_batch(np.random.default_rng(140),
                                             case))
    want = ck.windows_place_flat_plain(*args)
    for _ in range(3):
        assert torch.equal(ck.windows_place_flat(*args), want)
        assert int(ck.windows_place_flat.last_slow) == \
            WINDOWS_EDGE_CASES[case]
    *x1, nrows = x1_inputs(args)
    assert torch.equal(ck.place_windows_aligned(*x1, nrows),
                       ck.place_windows_aligned_plain(*x1, nrows))


def _same_windows(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", list(WINDOWS_EDGE_CASES) + [
    "k14/" + c for c in K14_EDGE_CASES])
def test_group_windows_edges_match_plain(dev, case):
    """group_windows on each WINDOWS_EDGE_CASES case's groups and on each
    K14_EDGE_CASES case equals its plain version in 3 launches; the
    library's tile is K14_TILE tokens."""
    assert ck._lib().rspt_group_windows_tile() == K14_TILE
    if case.startswith("k14/"):
        args = k14_edge_batch(np.random.default_rng(160), case[4:])
    else:
        args = group_windows_args(windows_edge_batch(
            np.random.default_rng(140), case))
    args = [a.to(dev) for a in args]
    want = ck.group_windows_plain(*args)
    for _ in range(3):
        _same_windows(ck.group_windows(*args), want)


def test_group_windows_many_groups(rng, dev):
    """group_windows on 160 groups (more tiles than the card has SMs)
    equals its plain version on every one of 10 launches."""
    args = group_windows_args(windows_many_groups(rng, dev)[0])
    assert args[1].shape[0] == 160
    want = ck.group_windows_plain(*args)
    for _ in range(10):
        _same_windows(ck.group_windows(*args), want)


def test_group_windows_one_group(rng, dev):
    """group_windows on one group (ng = 1): the first group of the
    windows batch's pass 1 with its LUT."""
    tokw, plan, bases, gl, _ = _windows_batch(rng, dev)
    tokc = ck.compact_tokens(tokw, bases, plan.T)
    args = (tokc[:ck.GROUP_TOK].reshape(1, -1).contiguous(),
            gl.lut3[:1].contiguous())
    _same_windows(ck.group_windows(*args), ck.group_windows_plain(*args))


@pytest.mark.parametrize("case", X1_EDGE_CASES)
def test_place_windows_aligned_edges_match_plain(dev, case):
    """place_windows_aligned on each X1_EDGE_CASES case equals its plain
    version."""
    *args, nrows = x1_edge_batch(np.random.default_rng(150), case)
    args = [a.to(dev) for a in args]
    assert torch.equal(ck.place_windows_aligned(*args, nrows),
                       ck.place_windows_aligned_plain(*args, nrows))


# dct_forward / dct_inverse: a CTA takes 32 outputs i of 4 channels and
# walks x in chunks of 128. The cases: n of 1-3, n not a multiple of the
# tile or the chunk (33, 65, 1,000), config 4's 4,096, 1-17 channels
# (17: a last CTA row with 1 channel of 4), full-range int32 words, and
# the inverse's overflow inputs, which must give x86's
# INT32_MIN: every coefficient 2^31 - 1, a DC of 2^28 (2^27 stays in
# range), and the ramp 30000 (k + 1) whose flat xdelta tail fits 2 planes.
DCT_EDGE_CASES = ("n1", "n2", "n3_ch1", "n33_ch5", "n65_ch17",
                  "n1000_ch12", "n4096_ch12", "n4096_ch1", "all_max",
                  "dc_2p28", "dc_2p27", "ramp")
DCT_OVERFLOW = {"all_max": True, "dc_2p28": True, "dc_2p27": False,
                "ramp": True}


def dct_edge_batch(rng, case):
    """The (channels, n) int32 rows of a case, fed to both transforms."""
    full = lambda ch, n: rng.integers(-2 ** 31, 2 ** 31 - 1, (ch, n),
                                      dtype=np.int64).astype(np.int32)
    if case == "n1":
        return full(3, 1)
    if case == "n2":
        return full(2, 2)
    if case == "n3_ch1":
        return full(1, 3)
    if case == "n33_ch5":
        return rng.integers(-2 ** 23, 2 ** 23, (5, 33)).astype(np.int32)
    if case == "n65_ch17":
        return full(17, 65)
    if case == "n1000_ch12":
        return np.cumsum(rng.normal(0, 3000, (12, 1000)), axis=1).astype(
            np.int32)
    if case == "n4096_ch12":
        return full(12, 4096)
    if case == "n4096_ch1":
        return np.cumsum(rng.normal(0, 900, (1, 4096)), axis=1).astype(
            np.int32)
    if case == "all_max":
        return np.full((1, 64), 2 ** 31 - 1, np.int32)
    if case in ("dc_2p28", "dc_2p27"):
        x = np.zeros((1, 64), np.int32)
        x[0, 0] = 1 << int(case[-2:])
        return x
    assert case == "ramp"
    return (30000 * (np.arange(4096) + 1)).astype(np.int32)[None]


def dct_tables(n, dev):
    """(cos, cos_t, cs, fwd_scale, inv_scale) of n samples on dev."""
    cos, cs = tops.dct_cos_table(n), tops.dct_cs(n)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (up(cos), up(cos.T), up(cs),
            up(tops.dct_forward_scale(cs, 128.0)),
            tops.dct_inverse_scale(n, 128.0))


def check_dct_case(x, dev):
    """Both kernels vs their plain versions on x, bit-exact, one launch
    each; returns the inverse's output."""
    cos, cos_t, cs, fwd, inv = dct_tables(x.shape[1], dev)
    t = torch.from_numpy(x).to(dev)
    before = (ck.dct_forward.launches, ck.dct_inverse.launches)
    f = ck.dct_forward(t, cos, fwd)
    assert torch.equal(f, ck.dct_forward_plain(t, cos, fwd))
    r = ck.dct_inverse(t, cos_t, cs, inv)
    assert torch.equal(r, ck.dct_inverse_plain(t, cos_t, cs, inv))
    assert (ck.dct_forward.launches - before[0],
            ck.dct_inverse.launches - before[1]) == (1, 1)
    return r


@pytest.mark.parametrize("case", DCT_EDGE_CASES)
def test_dct_edges_match_plain(rng, dev, case):
    """dct_forward and dct_inverse vs their plain versions on the card,
    tolerance 0; the overflow inputs give INT32_MIN where x86 does."""
    r = check_dct_case(dct_edge_batch(rng, case), dev)
    if case in DCT_OVERFLOW:
        assert bool((r == -2 ** 31).any()) == DCT_OVERFLOW[case]


@pytest.mark.parametrize("bps", [3, 4])
def test_dct_packer_card_equals_cpu(rng, dev, bps):
    """new_dct on the card: the CPU's container, and the CPU's
    reconstruction on both decode paths and through decompress_many; one
    dct_forward a compress, one dct_inverse a decompress."""
    ch, ns = 12, 4096
    sig = np.cumsum(rng.normal(0, 700.0, (ch, ns)), axis=1).astype(np.int32)
    if bps == 3:
        sig = sig >> 8
    native = np.stack([(np.ascontiguousarray(sig.T).astype(np.uint32)
                        >> np.uint32(8 * k)) & np.uint32(255)
                       for k in range(bps)], -1).astype(np.uint8).tobytes()
    before = ck.dct_forward.launches
    comp = gpack.new_dct(bps, ch, ns, device=dev).compress(native)
    assert ck.dct_forward.launches - before == 1
    cpu = gpack.new_dct(bps, ch, ns, device="cpu")
    assert comp == cpu.compress(native)
    want = cpu.decompress(comp)[0]
    before = ck.dct_inverse.launches
    for dd in (False, True):
        p = gpack.new_dct(bps, ch, ns, device=dev, device_decode=dd)
        assert p.decompress(comp)[0] == want
        assert p.decompress_many([comp, comp]) == [want, want]
    assert ck.dct_inverse.launches - before == 6


# --- S1-S4: the batch signal ops (float outputs: equal values, NaN equal
# to NaN, tolerance 0) ---

def same_floats(got, want):
    """Equal values, a NaN equal to a NaN (tolerance 0)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def iir_edge_batch(rng, rows, T, p, dtype):
    """iir_scan / iir_assoc inputs: a stable random IIR of p coefficients,
    (rows, T) samples with an all-zero row 0 (and a zero history) and a
    NaN in the last row, random histories."""
    poles = rng.uniform(-0.9, 0.9, p - 1)
    n = list(np.poly(poles))
    d = list(rng.normal(0, 0.5, p))
    x = rng.normal(0, 100, (rows, T))
    xz = rng.normal(0, 100, (rows, p - 1))
    yz = rng.normal(0, 100, (rows, p - 1))
    x[0] = xz[0] = yz[0] = 0
    if rows > 1 and T:
        x[-1, T // 2] = np.nan
    t = [torch.from_numpy(a).to(dtype) for a in (x, xz, yz)]
    return t[0], n, d, t[1], t[2]


S1_SLAB = 512   # iir.cu kSlab: the samples of S1's slabs
S2_CTA_TILES = 128   # iir.cu 32 * kTileWarps: the tiles of an S2 tile CTA
S2_CARRY_SLAB = 128   # iir.cu kCarrySlab: the tiles of a carry slab

# (rows, T, p, dtype, L): T = 0 and 1, T < L, T on and off a tile's end
# and S1's slab ends (slab - 1, slab, slab + 1, 3 slab + 7), 13 rows, p 2-8
# in both types; S2: tile counts off a warp's 32 and a CTA's 128 tiles
# (34, 70; 129: a CTA of one tile ending the row), a carry slab full,
# three with a partial last (301 tiles), L off the 128-byte chunk (7, 33,
# 100) and one sample a tile, one row of 13 samples with L > T; p = 2 and
# 3 (M = 1 and 2, as the detectors' low-passes) past two carry slabs
IIR_EDGE_CASES = ((3, 1, 2, "float32", 512), (3, 300, 8, "float64", 512),
                  (4, 5000, 3, "float32", 512), (4, 5000, 5, "float64", 7),
                  (2, 4096, 8, "float32", 256), (13, 1025, 4, "float32", 1),
                  (1, 2048, 2, "float64", 512), (2, 0, 3, "float32", 512),
                  (13, S1_SLAB - 1, 3, "float32", 512),
                  (3, S1_SLAB, 8, "float64", 100),
                  (13, S1_SLAB + 1, 2, "float32", 512),
                  (2, 3 * S1_SLAB + 7, 5, "float64", 512),
                  (13, 3 * S1_SLAB + 7, 3, "float32", 256),
                  (2, 33 * 100 + 5, 5, "float32", 100),
                  (3, 70 * 100, 6, "float64", 100),
                  (2, (S2_CTA_TILES + 1) * 64, 5, "float32", 64),
                  (2, S2_CARRY_SLAB * 16, 4, "float64", 16),
                  (3, 300 * 7 + 3, 7, "float32", 7),
                  (2, 3000, 6, "float32", 33), (2, 2500, 3, "float64", 256),
                  (2, 2500, 4, "float64", 512), (2, 2500, 7, "float64", 33),
                  (1, 13, 5, "float32", 512), (1, 13, 6, "float64", 512),
                  (2, 300 * 16 + 5, 2, "float32", 16),
                  (3, 300 * 16 + 5, 2, "float64", 16),
                  (2, 300 * 16 + 5, 3, "float32", 16),
                  (3, 300 * 16 + 5, 3, "float64", 16))


def check_iir_case(dev, rows, T, p, dtype, L, seed=150):
    """iir_scan and iir_assoc (tiles of L) against their plain versions,
    one launch counted each."""
    x, n, d, xz, yz = (a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in iir_edge_batch(np.random.default_rng(seed),
                                               rows, T, p,
                                               getattr(torch, dtype)))
    before = (ck.iir_scan.launches, ck.iir_assoc.launches)
    same_floats(ck.iir_scan(x, n, d, xz, yz),
                ck.iir_scan_plain(x, n, d, xz, yz))
    same_floats(ck.iir_assoc(x, n, d, xz, yz, L),
                ck.iir_assoc_plain(x, n, d, xz, yz, L))
    launched = int(dev.type == "cuda" and T > 0)
    assert (ck.iir_scan.launches - before[0],
            ck.iir_assoc.launches - before[1]) == (launched, launched)


@pytest.mark.parametrize("rows,T,p,dtype,L", IIR_EDGE_CASES)
def test_iir_kernels_match_plain(dev, rows, T, p, dtype, L):
    """S1 and S2 vs their plain versions on IIR_EDGE_CASES."""
    check_iir_case(dev, rows, T, p, dtype, L)


def test_iir_assoc_tables_stay_on_the_card(dev):
    """A second iir_assoc call with the same coefficients, L and type
    builds and copies no table: the device cache hands back the same
    tensors (a copy from pageable host memory would wait for the card)."""
    x, n, d, xz, yz = (a.to(dev) if isinstance(a, torch.Tensor) else a
                       for a in iir_edge_batch(np.random.default_rng(5), 2,
                                               3000, 5, torch.float32))
    ck.iir_assoc(x, n, d, xz, yz, 512)
    tables = ck.iir_tables(n, 512, torch.float32, x.device)
    info = ck._iir_tables.cache_info()
    y = ck.iir_assoc(x, n, d, xz, yz, 512)
    after = ck._iir_tables.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    assert all(a is b for a, b in
               zip(ck.iir_tables(n, 512, torch.float32, x.device), tables))
    assert all(t.device == x.device for t in tables)
    same_floats(y, ck.iir_assoc_plain(x, n, d, xz, yz, 512))


def test_iir_coefficient_limit_raises_on_card(dev):
    """More than 8 coefficients: the card wrappers raise ValueError, no
    launch and no plain version."""
    x = torch.zeros((2, 100), device=dev)
    z = torch.zeros((2, 8), device=dev)
    before = (ck.iir_scan.launches, ck.iir_assoc.launches)
    for call in (lambda: ck.iir_scan(x, [1.0] * 9, [0.1] * 9, z, z),
                 lambda: ck.iir_assoc(x, [1.0] * 9, [0.1] * 9, z, z, 512)):
        with pytest.raises(ValueError, match="coefficients"):
            call()
    assert (ck.iir_scan.launches, ck.iir_assoc.launches) == before


def test_filters_empty_time_axis_on_card(dev):
    """F3 on the card: iir_apply (both modes) and fir_apply at T = 0 give
    y of shape (2, 0) and the state passed through (the zero state, the
    given window or zeros), with no launch."""
    from rspt_tpu_torch.filters import torch_filters as tf
    x = torch.zeros((2, 0), device=dev)
    zi = (torch.tensor([[1.0, 2.0], [3.0, 4.0]], device=dev),
          torch.tensor([[5.0, 6.0], [7.0, 8.0]], device=dev))
    before = [k.launches for k in ck.KERNELS]
    for mode in ("scan", "assoc"):
        y, (xz, yz) = tf.iir_apply(x, [1.0, -1.5, 0.7], [0.05, 0.1, 0.05],
                                   zi=zi, mode=mode, device=dev)
        assert y.shape == (2, 0) and y.device.type == "cuda"
        assert torch.equal(xz, zi[0]) and torch.equal(yz, zi[1])
    window = torch.arange(6.0, device=dev).reshape(2, 3)
    for w, want in ((None, torch.zeros_like(window)), (window, window)):
        y, wout = tf.fir_apply(x, [0.2, 0.3, 0.5], w, device=dev)
        assert y.shape == (2, 0) and torch.equal(wout, want)
    assert [k.launches for k in ck.KERNELS] == before


FIR_CTA_OUT = 16 * 128   # fir.cu kR * kThreads: the outputs of a tile

# (rows, T, ks, dtype, fresh): ks 1 and 256, T = 0, T < ks, a window or
# fresh; ks off kR = 16 (7, 9, 61, 65), T on and off a tile's outputs
FIR_EDGE_CASES = ((3, 5000, 1, "float32", True), (2, 4097, 256, "float32",
                                                   False),
                  (2, 100, 256, "float64", True), (5, 1, 7, "float32", False),
                  (4, 3000, 65, "float64", False), (3, 0, 3, "float32", True),
                  (2, 0, 7, "float64", False),
                  (3, 5000, 61, "float32", True),
                  (2, 2 * FIR_CTA_OUT, 9, "float64", False),
                  (2, FIR_CTA_OUT + 1, 256, "float64", True),
                  (2, 30, 61, "float32", True),
                  (2, FIR_CTA_OUT - 1, 1, "float64", True),
                  (3, 3 * FIR_CTA_OUT + 5, 16, "float32", False))


def fir_edge_batch(rng, rows, T, ks, dtype, fresh):
    """fir_apply inputs: (x with an all-zero row 0 and a NaN in the last
    row, taps, window or None)."""
    x = rng.normal(0, 10, (rows, T))
    x[0] = 0
    if rows > 1 and T:
        x[-1, T // 2] = np.nan
    dt = getattr(torch, dtype)
    w = None if fresh else torch.from_numpy(rng.normal(0, 10, (rows, ks))
                                            ).to(dt)
    return (torch.from_numpy(x).to(dt),
            torch.from_numpy(rng.normal(0, 0.3, ks)).to(dt), w)


def check_fir_case(dev, rows, T, ks, dtype, fresh, seed=160):
    x, k, w = (None if a is None else a.to(dev) for a in fir_edge_batch(
        np.random.default_rng(seed), rows, T, ks, dtype, fresh))
    before = ck.fir_apply.launches
    same_floats(ck.fir_apply(x, k, w), ck.fir_apply_plain(x, k, w))
    assert ck.fir_apply.launches - before == int(dev.type == "cuda" and T > 0)


@pytest.mark.parametrize("rows,T,ks,dtype,fresh", FIR_EDGE_CASES)
def test_fir_apply_matches_plain(dev, rows, T, ks, dtype, fresh):
    """S3 vs its plain version on FIR_EDGE_CASES."""
    check_fir_case(dev, rows, T, ks, dtype, fresh)


GATE_CHUNK, GATE_WARMUP, GATE_CKPT = 1024, 512, 64   # peaks.cu's schedule

# (rows, T, marker, chunk, warmup, kind); chunk / warmup None: peaks.cu's
# defaults. Bumps that fire with a NaN row and an all-zero row, at the
# default schedule and at forced re-runs (warmup 0, chunks of 64 and 256);
# rows that never merge ("flat"); accepts just before chunk ends ("late");
# a prev_amp of -0.0 against +0.0 ("zeros"); T = 1, T < C, T = C - 1, C,
# C + 1; the serial schedule (chunk = T); 130 rows of 34 chunks (a partial
# CTA of chunks); 1,250 chunks a row (the repair's walk over two windows
# of 1,024 chunks)
GATE_EDGE_CASES = (
    (3, 4000, 1.0, None, None, "bumps"), (3, 4000, -1.0, None, None, "bumps"),
    (1, 1, 1.0, None, None, "bumps"), (130, 999, -1.0, None, None, "bumps"),
    (3, 4000, 1.0, 64, 0, "bumps"), (3, 4000, -1.0, 256, 0, "bumps"),
    (4, 3000, 1.0, 256, 0, "flat"), (4, 5000, 1.0, None, None, "flat"),
    (3, 4096, 1.0, 256, 0, "late"), (2, 3 * GATE_CHUNK, -1.0, None, 0, "late"),
    (2, 3 * GATE_CHUNK, 1.0, None, None, "late"),
    (2, 3000, 1.0, 64, 0, "zeros"), (2, 5000, -1.0, None, None, "zeros"),
    (2, GATE_CHUNK - 1, 1.0, None, None, "bumps"),
    (2, GATE_CHUNK, -1.0, None, None, "bumps"),
    (2, GATE_CHUNK + 1, 1.0, None, 0, "bumps"),
    (3, 4000, 1.0, 4000, 0, "bumps"), (130, 2117, -1.0, 64, 16, "bumps"),
    (2, 20000, 1.0, 16, 4, "bumps"))


def gate_edge_batch(rng, rows, T, kind="bumps", chunk=None):
    """peak_gate inputs (sig, thr), a threshold of 40 unless said:
    "bumps": smooth bumps of rising amplitude a row (row 0 all zero, a NaN
    in the last row); "flat": each row (but an all-zero row 0) rises once,
    at a random sample, and stays flat: searching from then on, never an
    accept, so a chunk whose guessed start missed the rise never merges;
    "late": a narrow bump peaking 12 samples before each chunk's end (of
    `chunk`, or GATE_CHUNK samples) on a level of 5: its accept falls 11
    samples before the end, its marker 23 samples into the next chunk;
    "zeros": periods
    of 300 samples (-3, z, -1, then -1) against a threshold of -10, each
    accepting at prev_sig = z (prev_amp = z): z = -0.0 in even rows, +0.0
    in odd ones."""
    t = np.arange(T)
    thr = np.full((rows, T), 40.0)
    if kind == "bumps":
        amp = rng.uniform(100, 900, (rows, 1)) + t / 10.0
        sig = np.sin(t / rng.uniform(15, 40, (rows, 1))) ** 8 * amp
        sig += rng.normal(0, 0.01, (rows, T))
        sig[0] = 0
        if rows > 1:
            sig[-1, T // 2] = np.nan
    elif kind == "flat":
        start = rng.integers(0, max(T // 2, 1), (rows, 1))
        sig = np.clip((t - start) / 5.0, 0, 1) * rng.uniform(100, 900,
                                                             (rows, 1))
        sig[0] = 0
    elif kind == "late":
        c = chunk or GATE_CHUNK
        sig = np.full((rows, T), 5.0)
        for b in range(c, T, c):
            if b >= 17:
                h = rng.uniform(600, 900, rows)[:, None]
                sig[:, b - 16:b - 7] += h * (1 - np.abs(np.arange(-4, 5)) / 5)
    else:
        sig = np.full((rows, T), -1.0)
        sig[:, t % 300 == 0] = -3.0
        sig[:, t % 300 == 1] = 0.0
        sig[0::2, t % 300 == 1] = -0.0
        thr[:] = -10.0
    return (torch.from_numpy(sig.astype(np.float32)),
            torch.from_numpy(thr.astype(np.float32)))


def _gate_step(st, s, g, nr_slope, atten, marker):
    """One step of the state machine (peaks.cu step) on numpy float32
    arrays or scalars: st = (prev_amp, prev_sig, searching, count), g =
    thr * 1.5; returns (the next state, the output)."""
    amp, ps, se, cnt = st
    with np.errstate(invalid="ignore"):
        confirm = se & (s > g) & (ps > s)
        accept = confirm & ((amp == 0) | (ps > amp * np.float32(0.5)))
        rising = ~confirm & (ps < s)
    amp = np.where(accept, ps, np.where(confirm, amp * atten, amp)
                   ).astype(np.float32)
    cnt = np.where(accept, 1, np.where(rising, 0, cnt))
    cnt = np.where(cnt > 0, cnt + 1, cnt)
    fire = cnt == nr_slope
    y = np.where(fire, s if marker == -1 else marker, 0).astype(np.float32)
    return (amp, s, np.where(accept, False, se | rising),
            np.where(fire, 0, cnt)), y


def _gate_step1(st, s, g, nr_slope, atten, marker):
    """_gate_step on numpy float32 scalars (the repair walk's re-runs)."""
    amp, ps, se, cnt = st
    confirm = se and s > g and ps > s
    accept = confirm and (amp == 0 or ps > amp * np.float32(0.5))
    rising = not confirm and ps < s
    if accept:
        amp, cnt, se = ps, 1, False
    elif confirm:
        amp = amp * atten
    elif rising:
        cnt, se = 0, True
    if cnt > 0:
        cnt += 1
    if cnt == nr_slope:
        return (amp, s, se, 0), s if marker == -1 else marker
    return (amp, s, se, cnt), np.float32(0)


def _state_bits(st, i):
    amp, ps, se, cnt = (np.asarray(v).reshape(-1)[i] for v in st)
    return (int(np.float32(amp).view(np.uint32)),
            int(np.float32(ps).view(np.uint32)), bool(se), int(cnt))


def gate_schedule_model(sig, thr, nr_slope, atten, marker, chunk=None,
                        warmup=None):
    """peaks.cu's schedule in numpy, as the kernel runs it: chunks of
    `chunk` samples, each from the state guessed `warmup` samples before
    it (both clamped to T; None: the defaults), checkpoints every
    GATE_CKPT samples, then the repair walk a row with states compared by
    their bits. Returns (out, reruns): reruns[r] = (chunks, samples)
    re-run in row r, what the kernel reports in peak_gate.last_reruns."""
    sig = np.asarray(sig, np.float32)
    g = np.asarray(thr, np.float32) * np.float32(1.5)
    atten, marker = np.float32(atten), np.float32(marker)
    rows, T = sig.shape
    out = np.zeros((rows, T), np.float32)
    reruns = np.zeros((rows, 2), np.int64)
    if T == 0:
        return out, reruns
    chunk = min(T, GATE_CHUNK if chunk is None else chunk)
    warm = min(T, GATE_WARMUP if warmup is None else warmup)
    nk = -(-T // chunk)
    r_of = np.repeat(np.arange(rows), nk)
    c0 = np.tile(np.arange(nk), rows) * chunk
    ln = np.minimum(chunk, T - c0)
    p0 = c0 - warm
    st = (np.zeros(rows * nk, np.float32),
          np.where(p0 >= 1, sig[r_of, np.maximum(p0 - 1, 0)],
                   np.float32(0)).astype(np.float32),
          np.zeros(rows * nk, bool), np.zeros(rows * nk, np.int64))
    ends = tuple(v.copy() for v in st)
    guess, ckpt = None, {}
    for tau in range(warm + chunk):      # speculate: every chunk at once
        o = tau - warm
        if o == 0:
            guess = st
        p = p0 + tau
        act = (p >= 0) & (o < ln)
        pc = np.clip(p, 0, T - 1)
        nxt, y = _gate_step(st, sig[r_of, pc], g[r_of, pc], nr_slope, atten,
                            marker)
        st = tuple(np.where(act, a, b) for a, b in zip(nxt, st))
        if o >= 0:
            out[r_of[act], pc[act]] = y[act]
            if (o + 1) % GATE_CKPT == 0:
                ckpt[o + 1] = st
            e = act & (o + 1 == ln)
            for a, b in zip(ends, st):
                a[e] = b[e]
    for r in range(rows):                # repair
        spec, exact = True, None
        for k in range(1, nk):
            i = r * nk + k
            if spec:
                if _state_bits(guess, i) == _state_bits(ends, i - 1):
                    continue
                exact = _state_bits(ends, i - 1)
            elif exact == _state_bits(guess, i):
                spec = True
                continue
            cur = (np.uint32(exact[0]).view(np.float32),
                   np.uint32(exact[1]).view(np.float32), exact[2], exact[3])
            merged = False
            for off in range(ln[i]):
                q = c0[i] + off
                cur, out[r, q] = _gate_step1(cur, sig[r, q], g[r, q],
                                             nr_slope, atten, marker)
                reruns[r, 1] += 1
                bits, o = _state_bits(cur, 0), off + 1
                if o == ln[i]:
                    merged = bits == _state_bits(ends, i)
                elif o % GATE_CKPT == 0 and bits == _state_bits(ckpt[o], i):
                    merged = True
                    break
            exact, spec = bits, merged
            reruns[r, 0] += 1
    return out, reruns


def check_gate_case(dev, rows, T, marker, chunk=None, warmup=None,
                    kind="bumps", seed=170):
    """peak_gate at the schedule (chunk, warmup) against its plain version
    and the schedule's model against both (on the card also the re-run
    counts, row by row), one launch counted; returns (out, the model's
    re-run counts)."""
    sig, thr = (a.to(dev) for a in gate_edge_batch(
        np.random.default_rng(seed), rows, T, kind, chunk))
    before = ck.peak_gate.launches
    atten = 1.0 / (1.0 + 70.0 / 360.0)
    got = ck.peak_gate(sig, thr, 36, atten, marker, chunk=chunk,
                       warmup=warmup)
    want = ck.peak_gate_plain(sig, thr, 36, atten, marker)
    same_floats(got, want)
    model, reruns = gate_schedule_model(sig.cpu().numpy(), thr.cpu().numpy(),
                                        36, atten, marker, chunk, warmup)
    same_floats(torch.from_numpy(model), want.cpu())
    cuda = dev.type == "cuda"
    assert ck.peak_gate.launches - before == int(cuda)
    if cuda:
        assert torch.equal(ck.peak_gate.last_reruns.cpu(),
                           torch.from_numpy(reruns))
    return got, reruns


def check_gate_expectations(case, got, reruns):
    """What each kind of GATE_EDGE_CASES must show: bumps fire (more than
    once a row and 1,000 samples); flat rows
    never do; a late bump's marker falls 23 samples into the next chunk;
    zeros fire, and at a forced schedule the -0.0 row re-runs more samples
    than the +0.0 one; warmup 0 re-runs chunks wherever a row has more
    than one."""
    rows, T, _, chunk, warmup, kind = case
    got = got.cpu()
    c = min(T, chunk or GATE_CHUNK)
    if kind == "bumps" and T > 1:
        assert int((got != 0).sum()) > rows * T // 1000
    elif kind == "flat":
        assert not bool((got != 0).any())
    elif kind == "late":
        for b in range(c, T - 23, c):
            assert bool((got[:, b + 23] != 0).all()), b
    elif kind == "zeros":
        assert int((got != 0).sum()) > 10
        if warmup == 0:
            assert reruns[0, 1] > reruns[1, 1]
    if warmup == 0 and c < T:
        assert reruns[:, 0].sum() > 0


@pytest.mark.parametrize("case", GATE_EDGE_CASES)
def test_peak_gate_matches_plain(dev, case):
    """S4 vs its plain version on GATE_EDGE_CASES at each case's schedule,
    its re-run counts equal to the schedule model's."""
    check_gate_expectations(case, *check_gate_case(dev, *case))


def test_peak_gate_schedule_constants(dev):
    """GATE_CHUNK, GATE_WARMUP and GATE_CKPT are peaks.cu's."""
    assert ck.gate_schedule() == (GATE_CHUNK, GATE_WARMUP, GATE_CKPT)


# ---------------------------------------------------------------------------
# Sharding: k shards on one card
# ---------------------------------------------------------------------------

def _launch_counts():
    return {k.__name__: k.launches for k in ck.KERNELS}


def _launched(before):
    return {k: v - before[k] for k, v in _launch_counts().items()
            if v != before[k]}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_encode_on_card(rng, dev, k):
    """ShardedHzrEncoder over k shards of the card: encode (the compact
    route, K13a once a shard), the flat route (K3 and K4 once a shard
    with a HUFF block; none on a shard of padding) and out_capacity equal
    the CPU's
    torch_coder.encode; an all-COPY batch declines the flat route."""
    data = np.minimum(rng.geometric(0.2, 5 * 65536 - 77) - 1, 255).astype(
        np.uint8)
    want = tc.encode(data, device="cpu")
    enc = parallel.ShardedHzrEncoder(parallel.make_mesh([dev] * k))
    before = _launch_counts()
    assert enc.encode(data) == want
    assert _launched(before) == {"pack_blocks": k}
    blocks, lengths = tc.split_blocks(data)
    before = _launch_counts()
    assert tc.assemble_compact(*enc.encode_blocks_flat(blocks, lengths)) \
        == want
    # 5 blocks in runs of loc: the shards past the data hold padding only
    loc = parallel.pad_blocks(5, k) // k
    assert _launched(before) == {"compact_tokens": -(-5 // loc),
                                 "pack_flat": -(-5 // loc)}
    assert enc.encode(data, len(want)) == want
    with pytest.raises(ValueError):
        enc.encode(data, len(want) - 1)
    rnd = rng.integers(0, 256, 3 * 65536).astype(np.uint8)
    b, ln = tc.split_blocks(rnd)
    assert enc.encode_blocks_flat(b, ln) is None
    assert tc.assemble_compact(*enc.encode_blocks_compact(b, ln)) \
        == tc.encode(rnd, device="cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_decode_on_card(rng, dev, k):
    """ShardedHzrDecoder over k shards of the card equals the payloads and
    gpu_decoder.decode_many; its hinted rerun too
    (0 sweeps); a hint of another shard count is refused. K6 and K7
    launch once on each shard that holds a HUFF block."""
    datas = [np.minimum(rng.geometric(0.2, n), 255).astype(np.uint8)
             .tobytes() for n in (200000, 70000, 3)]
    streams = [tc.encode(d, device="cpu") for d in datas]
    dec = parallel.ShardedHzrDecoder(parallel.make_mesh([dev] * k))
    before = _launch_counts()
    outs, hints = dec.decode_many(streams, return_hints=True)
    held = sum(1 for n in dec.decode_info["blocks"] if n)
    assert held >= 2 and _launched(before) == {"hzr_decode": held,
                                               "place_literals": held}
    assert outs == datas == gd.decode_many(streams, device=dev)
    assert dec.decode_many(streams, hints=hints) == datas
    assert dec.decode_info["hinted"]
    other = parallel.ShardedHzrDecoder(parallel.make_mesh([dev] * (6 - k)))
    gd._hint_registry.clear()
    assert other.decode_many(streams, hints=hints) == datas
    assert not other.decode_info["hinted"]


def test_sharded_scans_on_card(rng, dev):
    """The scans over 4 shards of the card equal torch_ops over the whole
    on the CPU, INT32_MIN and INT32_MAX included."""
    a = rng.integers(-2**31, 2**31, 4 * 5000).astype(np.int32)
    a[:2] = [-2**31, 2**31 - 1]
    fns = parallel.make_sharded_scans(parallel.make_mesh([dev] * 4))
    parts = fns["shard"](a)
    whole = torch.from_numpy(a)
    for name in ("delta_encode", "xor_encode", "delta_decode", "xor_decode"):
        out = fns[name](parts)
        assert all(o.device.type == "cuda" for o in out)
        assert torch.equal(fns["gather"](out), getattr(tops, name)(whole))


def test_packer_with_encoder_on_card(rng, dev):
    """new_xdelta_hzr with an encoder of 2 card shards: the container
    equals the CPU packer's, compress_many too."""
    ch, ns = 3, 40000
    native = _sig(rng, ch, ns, 700.0).astype("<i4").tobytes()
    enc = parallel.ShardedHzrEncoder(parallel.make_mesh([dev] * 2))
    p = gpack.new_xdelta_hzr(4, ch, ns, 3, device=dev, encoder=enc)
    q = gpack.new_xdelta_hzr(4, ch, ns, 3, device="cpu")
    assert p.compress(native) == q.compress(native)
    assert p.compress_many([native] * 5) == q.compress_many([native] * 5)
