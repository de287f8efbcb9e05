"""rspt_tpu_torch.ops.torch_ops vs rspt_tpu.ops.jax_ops on the CPU.

Every op is integer, so each comparison is bit-exact (tolerance 0).
Inputs are made with numpy from a seed and handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from rspt_tpu.ops import jax_ops as jops  # noqa: E402
from rspt_tpu_torch.ops import torch_ops as tops  # noqa: E402

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _signal(rng, n):
    """int32 values with the wrap edges spliced in."""
    x = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64).astype(np.int32)
    x[:6] = [I32_MIN, I32_MAX, 0, -1, I32_MIN, I32_MAX]
    x[-3:] = [I32_MAX, I32_MIN, 1]
    return x


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_native_to_i32_u8(rng, bps):
    """u8 native bytes → (channels, samples) int32; tolerance 0."""
    ns, ch = 257, 5
    raw = rng.integers(0, 256, ns * ch * bps, dtype=np.int64).astype(np.uint8)
    raw[:bps] = 0x80 if bps < 4 else 0xFF   # sign bits set
    got = tops.native_to_i32(torch.from_numpy(raw), ns, ch, bps)
    _eq(got, jops.native_to_i32(jnp.asarray(raw), ns, ch, bps))


def test_native_to_i32_words(rng):
    """bps 4 '<i4' word view → same layout as the u8 path; tolerance 0."""
    ns, ch = 300, 7
    w = _signal(rng, ns * ch)
    got = tops.native_to_i32(torch.from_numpy(w), ns, ch, 4)
    _eq(got, jops.native_to_i32(jnp.asarray(w), ns, ch, 4))
    _eq(got, jops.native_to_i32(jnp.asarray(w.view(np.uint8)), ns, ch, 4))


@pytest.mark.parametrize("bps", [2, 3, 4])
def test_i32_to_native(rng, bps):
    """(channels, samples) int32 → interleaved low bytes; tolerance 0."""
    a = _signal(rng, 6 * 111).reshape(6, 111)
    _eq(tops.i32_to_native(torch.from_numpy(a), bps),
        jops.i32_to_native(jnp.asarray(a), bps))


@pytest.mark.parametrize("op", ["delta_encode", "delta_decode",
                                "xor_encode", "xor_decode"])
def test_scans(rng, op):
    """int32-wrap scans and their inverses; tolerance 0."""
    x = _signal(rng, 4099)
    _eq(getattr(tops, op)(torch.from_numpy(x)),
        getattr(jops, op)(jnp.asarray(x)))


@pytest.mark.parametrize("val", [-128, 128, I32_MAX, I32_MIN])
def test_offset32(rng, val):
    """int32 wraparound offset; tolerance 0."""
    x = _signal(rng, 1000)
    _eq(tops.offset32(torch.from_numpy(x), val),
        jops.offset32(jnp.asarray(x), val))


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_plane_split_merge(rng, planes):
    """Byte planes out and back with sign extension; tolerance 0."""
    x = _signal(rng, 2000)
    sp = tops.plane_split(torch.from_numpy(x), planes)
    _eq(sp, jops.plane_split(jnp.asarray(x), planes))
    _eq(tops.plane_merge(sp), jops.plane_merge(jnp.asarray(sp.numpy())))


def test_xdelta_chain_round_trip(rng):
    """The packer's pre- and post-processing chains invert each other
    exactly at the int32 edges; tolerance 0."""
    x = torch.from_numpy(_signal(rng, 5000))
    enc = tops.xor_encode(tops.offset32(tops.delta_encode(x), -128))
    back = tops.delta_decode(tops.offset32(tops.xor_decode(enc), 128))
    assert torch.equal(back, x)
