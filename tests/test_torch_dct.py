"""The port's DCT path against the JAX package on the CPU: the plain
versions of the dct_forward / dct_inverse kernels against the JAX
package's exact serial kernels (rspt_tpu.native.bindings.dct_forward /
dct_inverse), and GpuDctPacker's containers and round trips
(device="cpu") against the JAX packer (rspt_tpu.packers.tpu, Pallas in
interpret mode), the host packer and, where it builds, the C++
reference; the port's metrics against rspt_tpu.utils.metrics.

Every value is integer and the containers are a byte format: tolerance
0 throughout. Inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from chip_smoke import from_native, make_ecg  # noqa: E402
from conftest import make_ecg_like, to_native  # noqa: E402
from rspt_tpu.native import bindings as rn  # noqa: E402
from rspt_tpu.ops import numpy_ops as nops  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu.utils import metrics as jmetrics  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from rspt_tpu_torch.ops import torch_ops as tops  # noqa: E402
from rspt_tpu_torch.packers import gpu  # noqa: E402
from rspt_tpu_torch.utils import metrics  # noqa: E402
from test_torch_cuda import (DCT_EDGE_CASES, DCT_OVERFLOW,  # noqa: E402
                             dct_edge_batch, dct_tables)

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1
Q = 128.0


@functools.lru_cache(maxsize=8)
def _tables(n):
    return dct_tables(n, torch.device("cpu"))


def _port(x, inverse):
    cos, cos_t, cs, fwd, inv = _tables(x.shape[1])
    t = torch.from_numpy(np.ascontiguousarray(x, np.int32))
    if inverse:
        return ck.dct_inverse(t, cos_t, cs, inv).numpy()
    return ck.dct_forward(t, cos, fwd).numpy()


@functools.lru_cache(maxsize=8)
def _reference_tables(n):
    return nops.dct_cos_table(n), nops.dct_cs(n)


def _reference(x, inverse):
    """The JAX package's exact path: its native serial kernel, a channel
    at a time (rspt_native.cpp:1274, :1290)."""
    cos, cs = _reference_tables(x.shape[1])
    fn = rn.dct_inverse if inverse else rn.dct_forward
    return np.stack([fn(row, cos, cs, Q) for row in x])


def test_tables_equal_the_reference():
    for n in (1, 3, 1000):
        np.testing.assert_array_equal(tops.dct_cos_table(n),
                                      nops.dct_cos_table(n))
        np.testing.assert_array_equal(tops.dct_cs(n), nops.dct_cs(n))
        ratio1 = np.sqrt(2.0 / n)
        cs = nops.dct_cs(n)
        want = np.array([cs[i] * ratio1 / Q for i in range(n)])
        np.testing.assert_array_equal(tops.dct_forward_scale(cs, Q), want)
        assert tops.dct_inverse_scale(n, Q) == ratio1 * Q


SIGNALS = ("zero", "random", "walk", "extreme3", "extreme4")


def _signal(kind, ch, n, rng):
    if kind == "zero":
        return np.zeros((ch, n), np.int32)
    if kind == "random":
        return rng.integers(-(1 << 20), 1 << 20, (ch, n)).astype(np.int32)
    if kind == "walk":
        return np.cumsum(rng.normal(0, 500, (ch, n)), axis=1).astype(np.int32)
    lo, hi = ((-(1 << 23), (1 << 23) - 1) if kind == "extreme3"
              else (I32_MIN, I32_MAX))
    x = np.where(rng.random((ch, n)) < 0.5, lo, hi).astype(np.int32)
    x[:, ::7] = hi
    return x


@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 64, 1000, 4096])
def test_dct_plain_vs_reference(rng, n, ch):
    """dct_forward_plain and dct_inverse_plain (the wrappers on CPU
    tensors) equal the reference's serial kernels, channel by channel:
    the forward of each signal, the inverse of its coefficients and of
    the signal itself (full-range inputs overflow: INT32_MIN as x86)."""
    for kind in SIGNALS:
        x = _signal(kind, ch, n, rng)
        f = _port(x, False)
        np.testing.assert_array_equal(f, _reference(x, False), err_msg=kind)
        for y in (f, x):
            np.testing.assert_array_equal(_port(y, True),
                                          _reference(y, True), err_msg=kind)


@pytest.mark.parametrize("case", DCT_EDGE_CASES)
def test_dct_edge_batch_vs_reference(case):
    """The card tests' dct_edge_batch through the plain versions equals
    the reference; the overflow inputs give x86's INT32_MIN where it does
    (every coefficient 2^31 - 1: 61 of 64 outputs; a DC of 2^28: all 64;
    of 2^27: none; the ramp 30000 (k + 1): 210 of 4,096)."""
    x = dct_edge_batch(np.random.default_rng(14), case)
    for inverse in (False, True):
        got = _port(x, inverse)
        np.testing.assert_array_equal(got, _reference(x, inverse))
    mins = {"all_max": 61, "dc_2p28": 64, "dc_2p27": 0, "ramp": 210}
    if case in DCT_OVERFLOW:
        assert int((got == I32_MIN).sum()) == mins[case]


def test_x86_conversion():
    """Out-of-range f64 values and NaN give INT32_MIN, positive overflow
    included; in range, trunc toward zero."""
    s = torch.tensor([2147483647.9, 2147483648.0, -2147483648.9,
                      -2147483649.0, 1e300, -1e300, float("nan"), -0.7, 3.9],
                     dtype=torch.float64)
    assert ck._x86_i32(s).tolist() == [
        I32_MAX, I32_MIN, I32_MIN, I32_MIN, I32_MIN, I32_MIN, I32_MIN, 0, 3]


def test_dct_wrappers_check_args():
    cos, cos_t, cs, fwd, inv = _tables(64)
    with pytest.raises(ValueError):
        ck.dct_forward(torch.zeros((2, 32), dtype=torch.int32), cos, fwd)
    with pytest.raises(TypeError):
        ck.dct_forward(torch.zeros((2, 64), dtype=torch.int64), cos, fwd)
    with pytest.raises(TypeError):
        ck.dct_inverse(torch.zeros((2, 64), dtype=torch.int32), cos_t,
                       fwd, inv)
    with pytest.raises(ValueError):
        gpack.new_dct(4, 2, 0, device="cpu")


# -- the packer against the JAX and host packers ------------------------------

def _square(ch, n, period):
    x = np.where((np.arange(n) // period) % 2 == 0, I32_MAX, I32_MIN)
    return np.tile(x.astype(np.int32), (ch, 1))


def _case(name):
    """(bps, ch, n, channel-major signal) of a packer case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "bps3_3x1024":      # test_tpu_packers.py:45-59's shape
        return 3, 3, 1024, make_ecg_like(rng, 3, 1024, 200.0, 24)
    if name == "bps4_2x4096":      # test_pallas.py:240-258's
        return 4, 2, 4096, np.cumsum(rng.normal(0, 150, (2, 4096)),
                                     axis=1).astype(np.int32)
    if name == "bps4_2x1000":      # no 2^k rule
        return 4, 2, 1000, make_ecg_like(rng, 2, 1000, 300.0, 32)
    if name == "bps1_2x300":
        return 1, 2, 300, make_ecg_like(rng, 2, 300, 2.0, 8)
    if name == "bps2_2x300":
        return 2, 2, 300, make_ecg_like(rng, 2, 300, 30.0, 16)
    if name == "bps4_random_extreme":
        return 4, 2, 512, rng.integers(I32_MIN, I32_MAX, (2, 512),
                                       dtype=np.int64).astype(np.int32)
    assert name == "bps4_square_extreme"
    return 4, 2, 512, _square(2, 512, 37)


JAX_CASES = ("bps3_3x1024", "bps4_2x4096", "bps4_2x1000", "bps1_2x300",
             "bps2_2x300", "bps4_square_extreme")
HOST_CASES = ("bps4_random_extreme",)


def _ramp_container(n=4096):
    """A one-channel container whose coefficients are the ramp 30000 (k +
    1), made with the port's tokenizer and encoder and a zero means
    header: its flat tail [29872, 0, 0, ...] fits 2 planes, and its
    inverse overflows."""
    p = gpack.new_dct(4, 1, n, device="cpu")
    coef = torch.from_numpy((30000 * (np.arange(n) + 1)).astype(np.int32))
    flat = tops.xor_encode(tops.offset32(tops.delta_encode(coef), -128))
    hist, tokw, bwords = p._tokenize(flat)
    return p._encode(tokw, bwords, hist,
                     gpu._means_header(np.zeros(1, np.int32)))[0]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX packer's containers and decompressions of JAX_CASES and of
    the ramp container, computed once (its fused pass 1 and flat pack in
    interpret mode, as tests/test_pallas.py runs them)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RSPT_FUSED_PASS1", "interp")
        from rspt_tpu.hzr import jax_coder
        mp.setattr(jax_coder, "_PACK_MODE", "interp")
        from rspt_tpu.packers import tpu
        runs = {}
        for name in JAX_CASES:
            bps, ch, n, sig = _case(name)
            native = to_native(sig, bps)
            tp = tpu.new_dct(bps, ch, n)
            comp = tp.compress(native)
            runs[name] = (native, comp, tp.decompress(comp)[0])
        ramp = _ramp_container()
        runs["ramp"] = (None, ramp,
                        tpu.new_dct(4, 1, 4096).decompress(ramp)[0])
    return runs


def _check_port(bps, ch, n, native, comp_want, out_want):
    """The port's container equals comp_want; decompress on the host
    decode and with device_decode, and decompress_many of 3, equal
    out_want."""
    comp = gpack.new_dct(bps, ch, n, device="cpu").compress(native)
    assert comp == comp_want
    for dd in (False, True):
        p = gpack.new_dct(bps, ch, n, device="cpu", device_decode=dd)
        out, used = p.decompress(comp)
        assert out == out_want and used == len(comp)
        assert p.decompress_many([comp] * 3) == [out_want] * 3
    return comp


@pytest.mark.parametrize("name", JAX_CASES)
def test_dct_packer_vs_jax_and_host(jax_runs, name):
    bps, ch, n, _ = _case(name)
    native, comp, out = jax_runs[name]
    hp = hpack.new_dct(bps, ch, n)
    assert comp == hp.compress(native)
    assert out == hp.decompress(comp)[0]
    _check_port(bps, ch, n, native, comp, out)
    assert comp[0] == 1 and out != native       # method 1, lossy


@pytest.mark.parametrize("name", HOST_CASES)
def test_dct_packer_vs_host(name):
    bps, ch, n, sig = _case(name)
    native = to_native(sig, bps)
    hp = hpack.new_dct(bps, ch, n)
    comp = hp.compress(native)
    _check_port(bps, ch, n, native, comp, hp.decompress(comp)[0])


def test_dct_ramp_container_overflows_as_reference(jax_runs):
    """Decompressing the ramp container gives the JAX and host packers'
    bytes, INT32_MIN (x86's overflow) at 210 of its 4,096 samples."""
    _, comp, want = jax_runs["ramp"]
    assert want == hpack.new_dct(4, 1, 4096).decompress(comp)[0]
    for dd in (False, True):
        p = gpack.new_dct(4, 1, 4096, device="cpu", device_decode=dd)
        assert p.decompress(comp)[0] == want
    assert int((np.frombuffer(want, "<i4") == I32_MIN).sum()) == 210


def test_dct_decompress_many_keeps_headers_apart():
    """decompress_many of 3 payloads with different means equals their
    host packer decompressions, on both decode paths."""
    ch, n = 2, 1000
    natives = [to_native(make_ecg_like(np.random.default_rng(s), ch, n,
                                       100.0 * (s + 1), 24), 4)
               for s in range(3)]
    hp = hpack.new_dct(4, ch, n)
    comps = [hp.compress(x) for x in natives]
    want = [hp.decompress(c)[0] for c in comps]
    for dd in (False, True):
        p = gpack.new_dct(4, ch, n, device="cpu", device_decode=dd)
        assert [p.compress(x) for x in natives] == comps
        assert p.decompress_many(comps) == want


@pytest.mark.parametrize("bps,ch,n", [(3, 3, 1024), (4, 2, 4096)])
def test_dct_vs_reference(ref, rng, bps, ch, n):
    """The port's container and decompression equal the C++ reference's
    (test_tpu_packers.py:45-59's inputs; skips where the oracle does not
    build)."""
    t = np.arange(n)
    sig = (3000 * np.sin(t / 11.0)[None, :]
           + rng.normal(0, 30, (ch, n))).astype(np.int32)
    lim = 2 ** 23 - 1
    native = to_native(np.clip(sig, -lim, lim), bps)
    want_comp, _, want_out, _ = ref.roundtrip("dct", native, bps, ch, n)
    p = gpack.new_dct(bps, ch, n, device="cpu")
    comp = p.compress(native)
    assert comp == want_comp
    assert p.decompress(comp)[0] == want_out


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("bps", [4, 3])
def test_metrics_on_config4_round_trip(bps):
    """prdn and compression_ratio equal rspt_tpu.utils.metrics' on the
    config-4 round trip (the main synthetic ECG's first 4,096 samples of
    12 channels; bps 3: shifted down into 24 bits)."""
    sig, _ = make_ecg(12, 4096)
    if bps == 3:
        sig = sig >> 8
    native = to_native(sig, bps)
    p = gpack.new_dct(bps, 12, 4096, device="cpu")
    comp = p.compress(native)
    orig = from_native(native, bps, 12, 4096)
    dec = from_native(p.decompress(comp)[0], bps, 12, 4096)
    np.testing.assert_array_equal(orig, sig)
    assert metrics.prdn(orig, dec) == jmetrics.prdn(orig, dec) > 0
    assert (metrics.compression_ratio(len(native), len(comp))
            == jmetrics.compression_ratio(len(native), len(comp)))
    assert metrics.prdn(orig, orig) == 0.0
