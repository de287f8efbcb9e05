"""The port's per-block hzr pack and stream encoder against the JAX
package: tokenize_blocks, pack_blocks (K13a) and pack_blocks_tokw (K13b)
by their plain PyTorch versions against the Pallas kernels in interpret
mode, compact_payloads, encode(data, out_capacity) against
jax_coder.encode and pyref.encode, and entropy_streams_blocks against
the flat path and the JAX packer.

Every output is an integer or a byte: tolerance 0. Inputs are made with
numpy from a seed; at most 3 blocks go through an interpret-mode call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.hzr import jax_coder, pyref  # noqa: E402
from rspt_tpu.ops import pallas_kernels as pk  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.hzr import torch_coder as tc  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from test_torch_cuda import (PACK_BLOCKS_EDGE_CASES,  # noqa: E402
                             PACK_BLOCKS_JAX_CASES,
                             check_pack_blocks_edges_covered,
                             pack_blocks_edge_batch,
                             pack_blocks_edges_covered)

B = 65536
RUNS = (1, 2, 3, 6, 7, 22, 23, 278, 279, 16662, 40000)


def _case(name):
    """The byte strings of tests/test_pallas.py:43-53, and tails."""
    rng = np.random.default_rng(5)
    if name == "empty":
        return np.zeros(0, np.uint8)
    if name == "text":
        return rng.choice(np.frombuffer(b"the quick brown fox 0123", np.uint8),
                          50000)
    if name == "runs":
        return np.concatenate([np.concatenate([
            np.zeros(r, np.uint8), rng.integers(1, 256, 17).astype(np.uint8)])
            for r in RUNS])
    if name == "random":
        return rng.integers(0, 256, 70000).astype(np.uint8)
    if name == "five_letter":
        return rng.integers(0, 5, 100).astype(np.uint8)
    if name == "zeros":
        return np.zeros(5000, np.uint8)
    # tails: a full walk block, a random one, then a 3,152-byte tail
    walk = np.cumsum(rng.normal(0, 3, 2 * B + 3152)).astype(np.int64)
    out = (walk & 255).astype(np.uint8)
    out[B:2 * B] = rng.integers(0, 256, B)
    return out


CASES = ["empty", "text", "runs", "random", "five_letter", "zeros", "tails"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _mixed_blocks():
    """A HUFF tail block (40,000 geometric bytes, zero runs among them,
    the padding filled with random bytes that must not count), a random
    block and an all-zero (FILL) block."""
    rng = np.random.default_rng(11)
    blocks = np.zeros((3, B), np.uint8)
    blocks[0] = rng.integers(1, 256, B)
    blocks[0, :40000] = np.minimum(rng.geometric(0.3, 40000) - 1, 255)
    blocks[1] = rng.integers(0, 256, B)
    return blocks, np.array([40000, B, B], np.int32)


@pytest.mark.parametrize("name", CASES)
def test_tokenize_blocks_vs_jax(name):
    """tokenize_blocks vs jax_coder.tokenize_blocks on the CPU: syms,
    extras, ebits, tvalid and the histograms (single zeros under 0)."""
    blocks, lengths = tc.split_blocks(_case(name))
    got = tc.tokenize_blocks(_t(blocks), _t(lengths))
    want = jax_coder.tokenize_blocks(jnp.asarray(blocks), jnp.asarray(lengths))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int32))


def test_tokenize_blocks_ignores_padding():
    """Bytes past a block's length hold no token, whatever they are."""
    blocks, lengths = _mixed_blocks()
    got = tc.tokenize_blocks(_t(blocks), _t(lengths))
    want = jax_coder.tokenize_blocks(jnp.asarray(blocks), jnp.asarray(lengths))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(w).astype(np.int32))
    assert int(got[3][0, 40000:].sum()) == 0


def _compare_rows(got, want, huff):
    """total_bits equal for every block; rows equal for HUFF blocks (a
    COPY block's row is never read, and JAX's Pallas path leaves
    clamped scratch there)."""
    packed, total = got
    np.testing.assert_array_equal(total.numpy(), np.asarray(want[1]))
    jp = np.asarray(want[0])
    assert packed.shape == jp.shape
    for b in np.flatnonzero(huff):
        np.testing.assert_array_equal(packed[b].numpy(), jp[b])


def test_pack_blocks_plain_vs_k13a_interp():
    """pack_blocks_plain (the wrapper on CPU tensors) vs jax_coder.
    pack_blocks in interpret mode (K13a, the group scan and K8b): a HUFF
    tail, a random block under 20-bit codes whose bits overflow its row
    (a COPY candidate), and a FILL block."""
    blocks, lengths = _mixed_blocks()
    fields = tc.tokenize_blocks(_t(blocks), _t(lengths))
    codes, cbits, _, desc_bits, is_fill = tc.host_tables(fields[4].numpy(),
                                                         lengths)
    _, _, is_huff, _ = tc.host_layout(fields[4].numpy(), lengths, cbits,
                                      desc_bits, is_fill)
    assert is_huff.tolist() == [True, False, False]
    codes[1] = np.arange(261) * 2477 & 0xFFFFF
    cbits[1] = 20
    got = tc.pack_blocks(*fields[:4], codes, cbits, desc_bits)
    want = jax_coder.pack_blocks(
        *[jnp.asarray(f.numpy()) for f in fields[:4]], jnp.asarray(codes),
        jnp.asarray(cbits), jnp.asarray(desc_bits), mode="interp")
    assert int(got[1][1]) > 8 * got[0].shape[1]      # overflows its row
    assert is_fill.tolist() == [False, False, True]
    _compare_rows(got, want, [True, False, False])


def _plane_tokens():
    """tokenize_planes_pallas (interpret) of a 40,000-word signal: plane
    0 random (COPY), plane 1 constant (FILL), plane 2 sparse (HUFF)."""
    rng = np.random.default_rng(12)
    n = 40000
    x = (rng.integers(0, 256, n) | (7 << 8)
         | ((rng.random(n) < 0.03) << 16)).astype(np.int32)
    tokw, bwords = pk.tokenize_planes_pallas(jnp.asarray(x), 3, n,
                                             interpret=True)
    return np.asarray(tokw), np.asarray(bwords), n


def test_pack_blocks_tokw_plain_vs_k13b_interp():
    """pack_blocks_tokw_plain vs jax_coder.pack_blocks_tokw in interpret
    mode (K13b) on the Pallas tokenizer's token words."""
    tokw, _, n = _plane_tokens()
    hist = np.asarray(jax_coder.hist_from_tokw(jnp.asarray(tokw)))
    _, lengths = tc.block_layout(n, 3)
    codes, cbits, _, desc_bits, is_fill = tc.host_tables(hist, lengths)
    _, comp_len, is_huff, is_copy = tc.host_layout(hist, lengths, cbits,
                                                   desc_bits, is_fill)
    assert is_copy.tolist() == [True, False, False]
    assert is_fill.tolist() == [False, True, False] and is_huff[2]
    got = tc.pack_blocks_tokw(_t(tokw), codes, cbits, desc_bits)
    want = jax_coder.pack_blocks_tokw(jnp.asarray(tokw), jnp.asarray(codes),
                                      jnp.asarray(cbits),
                                      jnp.asarray(desc_bits), mode="interp")
    _compare_rows(got, want, is_huff)


def pack_blocks_edges(case):
    return pack_blocks_edge_batch(np.random.default_rng(120), case)


@pytest.mark.parametrize("case", PACK_BLOCKS_EDGE_CASES)
def test_pack_blocks_edges_reach_their_paths(case):
    """Each pack_blocks_edge_batch case, counted from its arrays with the
    kernel's 2,048-slot tile, reaches what it is built for: partial last
    tiles (n = 2,040, 2,056, 65,528), tokens spanning the word two tiles
    share, an empty tile between valid ones and a row passing nwords in
    a middle tile (n65536), one block of one tile (n2040), 48 blocks of
    more tiles than the card holds at once (many_blocks), description
    bits off a multiple of 32 everywhere."""
    check_pack_blocks_edges_covered(
        case, pack_blocks_edges_covered(pack_blocks_edges(case)))


@pytest.mark.parametrize("case", PACK_BLOCKS_JAX_CASES)
def test_pack_blocks_edges_vs_k13_interp(case):
    """pack_blocks_plain and pack_blocks_tokw_plain (the wrappers on CPU
    tensors) on pack_blocks_edge_batch against jax_coder.pack_blocks
    (K13a) and pack_blocks_tokw (K13b) in interpret mode: every bit
    total, and every row whose bits fit its n + 512 bytes (an
    overflowing row falls back to COPY and JAX's clamps leave scratch
    there); the two forms give the same rows."""
    x = pack_blocks_edges(case)
    check_pack_blocks_edges_covered(case, pack_blocks_edges_covered(x))
    fields = [_t(f) for f in x["fields"]]
    tables = (x["codes"], x["cbits"], x["desc_bits"])
    got = tc.pack_blocks(*fields, *tables)
    got_w = tc.pack_blocks_tokw(_t(x["tokw"]), *tables)
    assert torch.equal(got[0], got_w[0]) and torch.equal(got[1], got_w[1])
    jt = [jnp.asarray(a) for a in tables]
    fits = got[1].numpy() <= 8 * got[0].shape[1]
    _compare_rows(got, jax_coder.pack_blocks(
        *[jnp.asarray(f) for f in x["fields"]], *jt, mode="interp"), fits)
    _compare_rows(got_w, jax_coder.pack_blocks_tokw(
        jnp.asarray(x["tokw"]), *jt, mode="interp"), fits)
    assert fits.sum() >= len(fits) - 1


def test_pack_blocks_forms_agree():
    """The K13a and K13b forms give the same rows on the same tokens."""
    blocks, lengths = _mixed_blocks()
    s, e, b, v, hist = tc.tokenize_blocks(_t(blocks), _t(lengths))
    codes, cbits, _, desc_bits, _ = tc.host_tables(hist.numpy(), lengths)
    tokw = s | (b << 9) | (e << 13) | (v << 27)
    a = tc.pack_blocks(s, e, b, v, codes, cbits, desc_bits)
    w = tc.pack_blocks_tokw(tokw, codes, cbits, desc_bits)
    assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])


@pytest.mark.parametrize("name", CASES)
def test_encode_vs_jax_and_pyref(name):
    """encode(data, device="cpu") == jax_coder.encode == pyref.encode; an
    out_capacity of exactly the stream's size gives the same bytes, one
    byte less raises ValueError wherever pyref.encode does."""
    data = _case(name)
    got = tc.encode(data, device="cpu")
    assert got == jax_coder.encode(data) == pyref.encode(data)
    assert tc.encode(data.tobytes(), device="cpu") == got
    assert tc.encode(data, len(got), device="cpu") == got
    try:
        pyref.encode(data, len(got) - 1)
        ref_raises = False
    except ValueError:
        ref_raises = True
    assert ref_raises == (name != "empty")
    if ref_raises:
        with pytest.raises(ValueError, match="output buffer too small"):
            tc.encode(data, len(got) - 1, device="cpu")
    else:
        assert tc.encode(data, len(got) - 1, device="cpu") == got


def test_encode_capacity_forces_copy():
    """Capacity rule of hzr_encode.c:376-382: with room for the stream
    but not its last HUFF block's payload, the block falls back to COPY
    and then does not fit: ValueError, as pyref.encode."""
    data = _case("tails")
    full = tc.encode(data, device="cpu")
    for cap in (len(full) - 1, len(full) - 3000, 5):
        with pytest.raises(ValueError, match="output buffer too small"):
            tc.encode(data, cap, device="cpu")
        with pytest.raises(ValueError):
            pyref.encode(data, cap)


def test_compact_payloads_vs_jax():
    """compact_payloads vs jax_coder.compact_payloads on a mixed batch
    (HUFF tail, COPY, FILL, an empty block): meta equal, data equal on
    the bytes the host reads (JAX's buffer runs on with scratch)."""
    blocks, lengths = _mixed_blocks()
    blocks = np.concatenate([blocks, np.zeros((1, B), np.uint8)])
    lengths = np.append(lengths, 0).astype(np.int32)
    fields = tc.tokenize_blocks(_t(blocks), _t(lengths))
    codes, cbits, _, desc_bits, is_fill = tc.host_tables(fields[4].numpy(),
                                                         lengths)
    packed, total = tc.pack_blocks(*fields[:4], codes, cbits, desc_bits)
    data, meta = tc.compact_payloads(packed, _t(blocks), total, _t(lengths),
                                     _t(is_fill))
    jd, jm = jax_coder.compact_payloads(
        jnp.asarray(packed.numpy()), jnp.asarray(blocks),
        jnp.asarray(total.numpy()), jnp.asarray(lengths),
        jnp.asarray(is_fill))
    jm = np.asarray(jm)
    np.testing.assert_array_equal(meta.numpy(), jm)
    comp_len, copy_len, _ = np.split(jm, 3)
    assert comp_len.tolist()[2:] == [0, 0] and copy_len.tolist() == [
        0, B, 0, 0] and comp_len[0] > 0
    assert data.numel() == comp_len.sum() + copy_len.sum()
    np.testing.assert_array_equal(data.numpy(), np.asarray(jd)[:data.numel()])


@pytest.fixture()
def tpack(monkeypatch):
    """rspt_tpu.packers.tpu with its fused pass 1 and pack in interpret
    mode: a COPY block sends it down its per-block path (K13b)."""
    monkeypatch.setenv("RSPT_FUSED_PASS1", "interp")
    monkeypatch.setattr(jax_coder, "_PACK_MODE", "interp")
    from rspt_tpu.packers import tpu
    return tpu


def test_entropy_streams_blocks(rng, tpack):
    """entropy_streams_blocks == entropy_streams (the flat path) == the
    streams of TpuXdeltaHzrPacker's container, on a payload whose plane 0
    is COPY."""
    ch, ns, planes = 2, 20000, 3
    sig = np.cumsum(rng.normal(0, 3000, (ch, ns)), axis=1).astype(np.int32)
    native = np.ascontiguousarray(sig.T).astype("<i4").tobytes()
    pg = gpack.new_xdelta_hzr(4, ch, ns, planes, device="cpu")
    comp = pg.compress(native)
    assert comp == tpack.new_xdelta_hzr(4, ch, ns, planes).compress(native)
    _, want, _ = pg._streams(comp, planes, 0)
    words = torch.from_numpy(np.frombuffer(native, "<i4").copy())
    enc, _ = ck.xdelta_swizzle(words, ns, ch, planes, 4)
    tokw, bwords, hist = ck.tokenize_planes(enc, planes)
    hist_np = hist.numpy()
    times = {}
    got = tc.entropy_streams_blocks(tokw, bwords, hist_np, ch * ns, planes,
                                    times)
    flat, _ = tc.entropy_streams(tokw, bwords, hist_np, ch * ns, planes, {})
    assert got == flat == want
    assert set(times) == {"tables", "pack", "assemble"}
    _, lengths = tc.block_layout(ch * ns, planes)
    assert tc.flat_plan(hist_np, lengths).is_copy[0]


def test_pack_blocks_validates_inputs():
    """Wrong dtype, shape or width raises before any kernel work."""
    z = torch.zeros((2, 64), dtype=torch.int32)
    lut = torch.zeros((2, 261), dtype=torch.int32)
    d = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        ck.pack_blocks(z, z, z, z.to(torch.int64), lut, d)
    with pytest.raises(ValueError):
        ck.pack_blocks(z, z, z, z[:, :60].contiguous(), lut, d)
    with pytest.raises(ValueError):
        ck.pack_blocks_tokw(z[:, :60].contiguous(), lut, d)
    with pytest.raises(ValueError):
        ck.pack_blocks_tokw(z, lut[:, :260].contiguous(), d)
    with pytest.raises(ValueError):
        ck.pack_blocks_tokw(torch.zeros((2, B + 8), dtype=torch.int32), lut,
                            d)
    words, total = ck.pack_blocks_tokw(z, lut, d)
    assert words.shape == (2, ck.blocks_nwords(64)) and total.tolist() == [0,
                                                                           0]
