"""The port's Walsh-Hadamard path and its hzr packer against the JAX
package on the CPU: fwht_plain (the plain version of the fwht kernel)
against jax_ops.fwht and fwht_pallas in interpret mode, the
quantization, the means and their header, and the GpuHadamardPacker and
GpuHzrPacker containers (device="cpu") against the JAX packers (Pallas
in interpret mode) and the host packers.

Every value is integer and the containers are a byte format: tolerance
0 throughout. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from conftest import make_ecg_like, to_native  # noqa: E402
from rspt_tpu.ops import jax_ops as jops  # noqa: E402
from rspt_tpu.ops import numpy_ops as nops  # noqa: E402
from rspt_tpu.ops import pallas_kernels as pk  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.ops import torch_ops as tops  # noqa: E402
from rspt_tpu_torch.packers import gpu  # noqa: E402

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


@pytest.fixture()
def tpack(monkeypatch):
    """rspt_tpu.packers.tpu with its fused pass 1 and flat pack in
    interpret mode (as tests/test_pallas.py runs them)."""
    monkeypatch.setenv("RSPT_FUSED_PASS1", "interp")
    from rspt_tpu.hzr import jax_coder
    monkeypatch.setattr(jax_coder, "_PACK_MODE", "interp")
    from rspt_tpu.packers import tpu
    return tpu


def _rows(rng, rows, n):
    return rng.integers(I32_MIN, I32_MAX, (rows, n), dtype=np.int64).astype(
        np.int32)


def _extremes():
    """Rows of INT32_MIN, of INT32_MAX and of both alternating: every
    stage wraps."""
    x = np.full((4, 64), I32_MIN, np.int32)
    x[1] = I32_MAX
    x[2, 1::2] = I32_MAX
    x[3, ::3] = -1
    return x


@pytest.mark.parametrize("case", ["3x4096", "n2", "extremes", "13x2048",
                                  "1001x8"])
def test_fwht_plain_vs_jax(rng, case):
    """fwht_plain == jops.fwht == fwht_pallas(interpret=True), on shapes
    of the card tests' FWHT_CASES too (13 rows of 2,048: the longest
    rows one CTA holds; 1,001 rows of 8 words); x is unchanged."""
    x = {"3x4096": lambda: _rows(rng, 3, 4096),
         "n2": lambda: _rows(rng, 5, 2),
         "extremes": _extremes,
         "13x2048": lambda: _rows(rng, 13, 2048),
         "1001x8": lambda: _rows(rng, 1001, 8)}[case]()
    t = torch.from_numpy(x.copy())
    got = ck.fwht(t).numpy()
    np.testing.assert_array_equal(t.numpy(), x)
    np.testing.assert_array_equal(got, np.asarray(jops.fwht(jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, np.asarray(pk.fwht_pallas(jnp.asarray(x), interpret=True)))
    np.testing.assert_array_equal(got[0], nops.fwht(x[0]))


def test_fwht_rejects_bad_rows():
    with pytest.raises(ValueError):
        ck.fwht(torch.zeros((2, 12), dtype=torch.int32))
    with pytest.raises(TypeError):
        ck.fwht(torch.zeros((2, 16), dtype=torch.int64))


@pytest.mark.parametrize("n", [16384, 2])
def test_normalize_vs_jax(rng, n):
    """The encode quantization equals jops.fwht_normalize_pow2 on every
    value but INT32_MIN, and the decode one jops.fwht_normalize2_int."""
    x = _rows(rng, 3, 4096)
    x[0, :6] = [I32_MAX, I32_MIN + 1, -1, 0, 1, -n]
    x[x == I32_MIN] = 0
    got = tops.fwht_normalize_pow2(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.fwht_normalize_pow2(jnp.asarray(x), n)))
    np.testing.assert_array_equal(got, nops.fwht_normalize(x, n, 1.0))
    for ratio in (1.0, 4.0):
        np.testing.assert_array_equal(
            tops.fwht_normalize2_int(torch.from_numpy(x), ratio).numpy(),
            np.asarray(jops.fwht_normalize2_int(jnp.asarray(x), ratio)))


def test_normalize_int32_min_hazard():
    """jops.fwht_normalize_pow2 negates INT32_MIN (a no-op in int32),
    shifts it as unsigned and negates again: +131072 at n = 16384. The
    reference (fwht.c:30-34, int /= double) and nops.fwht_normalize
    truncate toward zero to -131072; the port follows them."""
    x = np.array([[I32_MIN, I32_MIN, 5]], np.int32)
    got = tops.fwht_normalize_pow2(torch.from_numpy(x), 16384).numpy()
    np.testing.assert_array_equal(got, nops.fwht_normalize(x, 16384, 1.0))
    assert got[0, 0] == -131072
    assert int(np.asarray(jops.fwht_normalize_pow2(
        jnp.asarray(x), 16384))[0, 0]) == 131072


def test_means_vs_jax(rng):
    """row_sums64 + average32_host == average32_host(*sum64_parts) and
    nops.average32, on rows whose sums are negative (the reference's
    unsigned division then wraps) and positive."""
    x = _rows(rng, 6, 1000) // 3
    x[0] = -(2 ** 30)
    x[1] = I32_MIN
    x[2] = I32_MAX
    x[3, :] = -7
    got = tops.average32_host(
        tops.row_sums64(torch.from_numpy(x)).numpy(), x.shape[1])
    want = jops.average32_host(*jops.sum64_parts(jnp.asarray(x)),
                               x.shape[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [nops.average32(r) for r in x])
    assert (x.astype(np.int64).sum(1) < 0).sum() >= 3


def test_means_header_roundtrip(rng):
    """The 24-bit header round-trips every mean that fits 24 bits and
    equals the host packer's bytes."""
    means = rng.integers(-(1 << 23), 1 << 23, 50).astype(np.int32)
    means[:3] = [-(1 << 23), (1 << 23) - 1, -1]
    head = gpu._means_header(means)
    assert head == hpack._means_header(means)
    np.testing.assert_array_equal(gpu._means_from_header(head, 50), means)
    np.testing.assert_array_equal(
        gpu._means_from_header(head, 50), hpack._means_from_header(head, 50))


def _check_packer(port, jax_p, host_p, native):
    """Port == JAX == host container; decompress on both of the port's
    decode paths equals the host packer's."""
    comp = port("cpu", False).compress(native)
    assert comp == jax_p.compress(native)
    assert comp == host_p.compress(native)
    want = host_p.decompress(comp)[0]
    for dd in (False, True):
        out, used = port("cpu", dd).decompress(comp)
        assert out == want and used == len(comp)
    return comp, want


@pytest.mark.parametrize("bps", [3, 4])
def test_hadamard_packer_vs_jax(rng, tpack, bps):
    ch, n = 3, 4096
    sig = make_ecg_like(rng, ch, n, 200.0, 8 * bps)
    comp, out = _check_packer(
        lambda d, dd: gpack.new_hadamard(bps, ch, n, device=d,
                                         device_decode=dd),
        tpack.new_hadamard(bps, ch, n, use_pallas=True),
        hpack.new_hadamard(bps, ch, n), to_native(sig, bps))
    assert comp[0] == 2
    assert out != to_native(sig, bps)        # lossy


@pytest.mark.parametrize("bps,ch,n", [(3, 3, 5000), (4, 2, 9001)])
def test_hzr_packer_vs_jax(rng, tpack, bps, ch, n):
    sig = make_ecg_like(rng, ch, n, 300.0, 8 * bps)
    native = to_native(sig, bps)
    _, out = _check_packer(
        lambda d, dd: gpack.new_hzr(bps, ch, n, device=d, device_decode=dd),
        tpack.new_hzr(bps, ch, n), hpack.new_hzr(bps, ch, n), native)
    assert out == native


def test_hadamard_many_and_non_pow2(rng):
    """decompress_many keeps each payload's means header apart; a length
    that is not 2^k raises when the packer is built."""
    ch, n = 2, 2048
    p = gpack.new_hadamard(4, ch, n, device="cpu", device_decode=True)
    natives = [to_native(make_ecg_like(np.random.default_rng(s), ch, n,
                                       100.0 * (s + 1), 24), 4)
               for s in range(3)]
    comps = [p.compress(x) for x in natives]
    assert p.decompress_many(comps) == [p.decompress(c)[0] for c in comps]
    for bad in (3000, 0):
        with pytest.raises(ValueError, match="2\\^k"):
            gpack.new_hadamard(4, ch, bad, device="cpu")
