"""The port's batched filters (rspt_tpu_torch.filters.torch_filters, on
the plain versions of S1 iir_scan, S2 iir_assoc and S3 fir_apply) and its
host FIR and delay against rspt_tpu's, on the CPU. The same numpy inputs
from a seed go through both packages; the tolerances are
tests/test_filters.py's own (rtol 1e-3 / atol 1e-1 for float32 filters
against the serial path, rtol 1e-4 / atol 1e-3 for a resumed stream,
rtol 1e-5 / atol 1e-4 for the FIR)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)
pytest.importorskip("jax")

from rspt_tpu.filters import jax_filters as jf  # noqa: E402
from rspt_tpu.filters import streaming as ref_streaming  # noqa: E402
from rspt_tpu_torch.filters import design, streaming  # noqa: E402
from rspt_tpu_torch.filters import torch_filters as tf  # noqa: E402
from rspt_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

# well-conditioned float32 designs (tests/test_filters.py's and the peak
# detectors' at 360 Hz), as (b, a)
DESIGNS = {
    "lp2_100_2000": design.butterworth_2nd(design.FilterType.LOW_PASS,
                                           2000.0, 100.0),
    "hp1_1_500": design.create_filter_iir(
        design.FilterKind.BUTTERWORTH, design.FilterType.HIGH_PASS, 1, 500.0,
        1.0),
    "bp1_15_25_1000": design.butterworth_bandpass_1st(1000.0, 15.0, 25.0),
    "lp2_40_1000": design.butterworth_2nd(design.FilterType.LOW_PASS, 1000.0,
                                          40.0),
}
CPU = "cpu"


def _serial_f64(x, b, a):
    """Each row through the host IirFilter (filter_opt's order, f64)."""
    return np.stack([streaming.IirFilter(a, b).process(row) for row in x])


@pytest.mark.parametrize("name", sorted(DESIGNS))
@pytest.mark.parametrize("mode", ["scan", "assoc"])
def test_iir_apply_matches_jax_and_serial(rng, name, mode):
    """float32 iir_apply in each mode against jax_filters.iir_apply in the
    same mode and against the serial f64 path; the state out equals
    JAX's."""
    b, a = DESIGNS[name]
    x = rng.normal(0, 1000, (3, 4096)).astype(np.float32)
    y, (xz, yz) = tf.iir_apply(x, a, b, mode=mode, device=CPU)
    yj, (xzj, yzj) = jf.iir_apply(x, a, b, mode=mode)
    assert y.dtype == torch.float32 and y.shape == (3, 4096)
    assert np.allclose(y.numpy(), np.asarray(yj), rtol=1e-3, atol=1e-1)
    assert np.allclose(y.numpy(), _serial_f64(x, b, a), rtol=1e-3, atol=1e-1)
    assert np.array_equal(xz.numpy(), np.asarray(xzj))
    assert np.allclose(yz.numpy(), np.asarray(yzj), rtol=1e-3, atol=1e-1)


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_scan_f64_bit_exact_with_host_filters(rng, p):
    """S1's plain version in float64 equals the port's IirFilter.process
    (the host runtime, filter_opt's order) and rspt_tpu's, bit for bit,
    from a nonzero state."""
    d = rng.normal(0, 0.3, p)
    n = np.concatenate([[1.0], rng.uniform(-0.2, 0.2, p - 1)])
    x = rng.normal(0, 1000, (2, 3000))
    xz = rng.normal(0, 100, (2, p - 1))
    yz = rng.normal(0, 100, (2, p - 1))
    y = ck.iir_scan(torch.from_numpy(x), n, d, torch.from_numpy(xz),
                    torch.from_numpy(yz))
    for r in range(2):
        for mod in (streaming, ref_streaming):
            f = mod.IirFilter(n, d)
            f.set_state(([*xz[r], 0.0], [*yz[r], 0.0]))
            assert np.array_equal(y[r].numpy(), f.process(x[r], opt=True))


@pytest.mark.parametrize("mode", ["scan", "assoc"])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_streaming_two_calls_equal_one_pass(rng, mode, source):
    """Filtering in two calls, the second from the first's state (the
    port's, or JAX's zf as numpy arrays), equals one pass."""
    b, a = design.butterworth_bandpass_1st(1000.0, 15.0, 25.0)
    x = rng.normal(0, 100, (2, 3000)).astype(np.float32)
    full, _ = tf.iir_apply(x, a, b, mode=mode, device=CPU)
    if source == "port":
        y1, st = tf.iir_apply(x[:, :1100], a, b, mode=mode, device=CPU)
    else:
        y1, st = jf.iir_apply(x[:, :1100], a, b, mode=mode)
        y1, st = torch.from_numpy(np.array(y1)), tuple(
            np.asarray(s) for s in st)
    y2, _ = tf.iir_apply(x[:, 1100:], a, b, zi=st, mode=mode, device=CPU)
    got = torch.cat([y1, y2], 1).numpy()
    assert np.allclose(got, full.numpy(), rtol=1e-4, atol=1e-3)


def test_state_out_short_block_is_the_history(rng):
    """With T < p − 1 the state out is the true newest-first history: a
    resumed host IirFilter gives the same output as one that filtered
    the whole stream."""
    b, a = design.butterworth_bandpass_2nd(2000.0, 10.0, 20.0)   # p = 5
    x = rng.normal(0, 100, 12)
    _, st = tf.iir_apply(x[:6], a, b, mode="scan", device=CPU)
    _, st = tf.iir_apply(x[6:8], a, b, zi=st, mode="scan", device=CPU)
    y3, _ = tf.iir_apply(x[8:], a, b, zi=st, mode="scan", device=CPU)
    f = streaming.IirFilter(a, b)
    want = f.process(x)
    assert np.array_equal(y3.numpy(), want[8:])


@pytest.mark.parametrize("L", [1, 7, 256, 3000])
def test_assoc_tiles_close_to_scan(rng, L):
    """S2's plain version at tiles of L samples (L = T: one tile) against
    S1's, from a nonzero state."""
    b, a = DESIGNS["lp2_100_2000"]
    x = torch.from_numpy(rng.normal(0, 1000, (2, 3000)).astype(np.float32))
    xz = torch.from_numpy(rng.normal(0, 1000, (2, 2)).astype(np.float32))
    yz = torch.from_numpy(rng.normal(0, 300, (2, 2)).astype(np.float32))
    ys = ck.iir_scan(x, a, b, xz, yz)
    ya = ck.iir_assoc(x, a, b, xz, yz, L)
    assert np.allclose(ya.numpy(), ys.numpy(), rtol=1e-3, atol=1e-1)


def _s2_model(x, n, d, xz, yz, L):
    """S2 as iir.cu's three passes compute it, in numpy in x's type (every
    product and sum rounded, never fused), a tile a lane: pass 1 runs each
    tile's recurrence from the zero state (its feedforward on the real
    history) and stages its ends, the last m outputs, the newest first;
    pass 2 walks the carry over the staged ends, s_(k+1)[i] = (sum over c
    of A^L[i][c]·s_k[c]) + e_k[i], one step more after the last tile
    (dropped); pass 3 recomputes each tile from zero and adds (sum over c
    of P[j][c]·s_k[c]) to each output."""
    dt = x.dtype
    rows, T = x.shape
    m = len(n) - 1
    nt = -(-T // L)
    tdt = torch.float32 if dt == np.float32 else torch.float64
    al, pw = (t.numpy() for t in ck.iir_tables(n, L, tdt, torch.device(CPU)))
    nn = np.asarray(n, np.float64).astype(dt)
    dd = np.asarray(d, np.float64).astype(dt)
    # x[t - i] = xp[:, m + t - i]; zeros past T (the last tile's tail is
    # dropped)
    xp = np.concatenate([xz[:, ::-1], x, np.zeros((rows, nt * L - T), dt)],
                        1)

    def tiles(starts=None):
        s = [np.zeros((rows, nt), dt) for _ in range(m)]
        y = np.zeros((rows, nt, L), dt)
        for j in range(L):
            t = np.arange(nt) * L + j
            u = np.zeros((rows, nt), dt)
            for i in range(m + 1):
                u = u + dd[i] * xp[:, m + t - i]
            yl = u
            for i in range(m):
                yl = yl - nn[i + 1] * s[i]
            s = [yl] + s[:-1]
            if starts is not None:
                f = np.zeros((rows, nt), dt)
                for c in range(m):
                    f = f + pw[j, c] * starts[:, :, c]
                y[:, :, j] = yl + f
        return np.stack(s, 2), y

    ends, _ = tiles()
    starts = np.empty((rows, nt, m), dt)
    cur = yz.copy()
    for k in range(nt):
        starts[:, k] = cur
        nxt = np.empty_like(cur)
        for i in range(m):
            acc = np.zeros(rows, dt)
            for c in range(m):
                acc = acc + al[i, c] * cur[:, c]
            nxt[:, i] = acc + ends[:, k, i]
        cur = nxt
    return tiles(starts)[1].reshape(rows, nt * L)[:, :T]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("L", [1, 7, 512])
def test_assoc_passes_keep_the_plain_order(rng, dtype, p, L):
    """The order S2's kernel keeps: _s2_model (tiles from zero, staged
    ends, the serial carry, the tiles recomputed with the fix-up) equals
    iir_assoc_plain bit for bit (NaN equal to NaN) on the detectors'
    designs at 360 Hz (the integrator's low-pass, m = 2; the band-pass,
    m = 4), from a nonzero state, with a NaN in the last row and T not a
    multiple of L."""
    b, a = design.create_filter_iir(
        design.FilterKind.BUTTERWORTH,
        design.FilterType.LOW_PASS if p == 3 else design.FilterType.BAND_PASS,
        2, 360.0, *((3.0,) if p == 3 else (10.0, 20.0)))
    assert len(a) == p
    T = 3 * 512 + 100
    x = rng.normal(0, 100, (3, T)).astype(dtype)
    x[-1, T // 2] = np.nan
    xz = rng.normal(0, 100, (3, p - 1)).astype(dtype)
    yz = rng.normal(0, 10, (3, p - 1)).astype(dtype)
    want = ck.iir_assoc_plain(*(torch.from_numpy(v) for v in (x,)), a, b,
                              torch.from_numpy(xz), torch.from_numpy(yz),
                              L).numpy()
    got = _s2_model(x, a, b, xz, yz, L)
    assert np.isfinite(want[:2]).all()
    np.testing.assert_array_equal(got, want)


def test_iir_tables_are_the_companion_powers():
    """A^L and row 0 of A^(j+1) against numpy's matrix powers."""
    b, a = design.butterworth_bandpass_2nd(360.0, 10.0, 20.0)
    al, pw = ck.iir_tables(a, 9, torch.float64, torch.device(CPU))
    A = np.zeros((4, 4))
    A[0] = -np.asarray(a[1:])
    A[1:, :3] += np.eye(3)
    assert np.allclose(al.numpy(), np.linalg.matrix_power(A, 9), rtol=1e-12)
    for j in range(9):
        assert np.allclose(pw[j].numpy(),
                           np.linalg.matrix_power(A, j + 1)[0], rtol=1e-12)


def test_iir_apply_types_and_limits():
    """A float input keeps its type, an integer one becomes float32
    (jax_filters.py:84); more than 8 coefficients or fewer than 2 raise
    ValueError (S1/S2 take 2..8), as does an unknown mode."""
    b, a = DESIGNS["lp2_100_2000"]
    x = np.arange(50)
    assert tf.iir_apply(x, a, b, device=CPU)[0].dtype == torch.float32
    assert tf.iir_apply(x.astype(np.float64), a, b,
                        device=CPU)[0].dtype == torch.float64
    y, _ = tf.iir_apply(x, a, b, mode="scan", device=CPU)
    assert np.allclose(y.numpy(), _serial_f64(x[None].astype(np.float64),
                                              b, a)[0], rtol=1e-5)
    for p in (1, 9):
        with pytest.raises(ValueError, match="coefficients"):
            tf.iir_apply(x, [1.0] + [0.01] * (p - 1), [0.1] * p, device=CPU)
    with pytest.raises(ValueError, match="mode"):
        tf.iir_apply(x, a, b, mode="fast", device=CPU)


def test_iir_scan_from_a_guessed_state_never_merges():
    """Why S1 stays serial: split in time, it could not keep its bits.
    The offline detector's threshold low-pass (order 2 at 0.15 Hz, 360 Hz:
    poles ~2e-3 from the unit circle) over its own input (a synthetic ECG
    through the 15-25 Hz band-pass, squared, the 3 Hz low-pass), run by
    S1's plain version from the zero state 1,000, 4,000 or 16,000 samples
    before t = 20,000, against the run from the row's start: fewer than 1%
    of the 16,000 samples from t on are bit-equal, and the last differs.
    (The gate, S4, merges: an accept resets its state.)"""
    sr = 360.0
    t = np.arange(40000) / sr
    ecg = (np.sin(2 * np.pi * 1.1 * t) ** 63 * 900
           + np.random.default_rng(7).normal(0, 15, t.size) + 50)
    x = torch.from_numpy(ecg[None].astype(np.float32))
    designs = [design.create_filter_iir(
        design.FilterKind.BUTTERWORTH, kind, order, sr, *f) for kind, order,
        f in ((design.FilterType.BAND_PASS, 1, (15.0, 25.0)),
              (design.FilterType.LOW_PASS, 1, (3.0,)),
              (design.FilterType.LOW_PASS, 2, (0.15,)))]
    v, _ = tf.iir_apply(x, designs[0][1], designs[0][0], mode="scan",
                        device=CPU)
    f, _ = tf.iir_apply(v * v, designs[1][1], designs[1][0], mode="scan",
                        device=CPU)
    f = f[:, 4000:].contiguous()
    b, a = designs[2]
    z = f.new_zeros((1, 2))
    full = ck.iir_scan(f, a, b, z, z)[0, 20000:].numpy()
    for lead in (1000, 4000, 16000):
        part = ck.iir_scan(f[:, 20000 - lead:].contiguous(), a, b, z, z)
        part = part[0, lead:].numpy()
        same = full.view(np.uint32) == part.view(np.uint32)
        assert same.mean() < 0.01 and not same[-1], lead


def test_empty_time_axis_matches_jax():
    """F3: at T = 0, iir_apply (both modes) and fir_apply give y of shape
    (2, 0) and the state or window jax_filters gives (the zero state, the
    given window or zeros); a given IIR state passes through (yz as JAX's; xz the true history, which JAX's xz_out reverses
    at T < p - 1)."""
    x = np.zeros((2, 0), np.float32)
    n, d, fir = [1.0, -1.5, 0.7], [0.05, 0.1, 0.05], [0.2, 0.3, 0.5]
    zi = (np.array([[1, 2], [3, 4]], np.float32),
          np.array([[5, 6], [7, 8]], np.float32))
    for mode in ("scan", "assoc"):
        y, (xz, yz) = tf.iir_apply(x, n, d, mode=mode, device=CPU)
        yj, (xzj, yzj) = jf.iir_apply(x, n, d, mode=mode)
        assert y.shape == np.asarray(yj).shape == (2, 0)
        assert np.array_equal(xz.numpy(), np.asarray(xzj))
        assert np.array_equal(yz.numpy(), np.asarray(yzj))
        y, (xz, yz) = tf.iir_apply(x, n, d, zi=zi, mode=mode, device=CPU)
        _, (_, yzj) = jf.iir_apply(x, n, d, zi=zi, mode=mode)
        assert y.shape == (2, 0) and np.array_equal(xz.numpy(), zi[0])
        assert np.array_equal(yz.numpy(), np.asarray(yzj))
    window = np.arange(6, dtype=np.float32).reshape(2, 3)
    for w in (None, window):
        y, wout = tf.fir_apply(x, fir, w, device=CPU)
        yj, woutj = jf.fir_apply(x, fir, w)
        assert y.shape == np.asarray(yj).shape == (2, 0)
        assert np.array_equal(wout.numpy(), np.asarray(woutj))


@pytest.mark.parametrize("ks", [1, 5, 64])
@pytest.mark.parametrize("fresh", [True, False])
def test_fir_apply_matches_jax_and_host(rng, ks, fresh):
    """fir_apply against jax_filters.fir_apply and the host FirFilter,
    fresh (0 until the window fills) and from a window (JAX's window_out,
    numpy); the window out equals JAX's."""
    kernel = rng.normal(0, 0.3, ks)
    x = rng.normal(0, 10, (2, 700)).astype(np.float32)
    prior = rng.normal(0, 10, (2, 300)).astype(np.float32)
    window = None if fresh else np.asarray(jf.fir_apply(prior, kernel)[1])
    y, wout = tf.fir_apply(x, kernel, window, device=CPU)
    yj, woutj = jf.fir_apply(x, kernel, window)
    assert np.allclose(y.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-4)
    assert np.array_equal(wout.numpy(), np.asarray(woutj))
    for r in range(2):
        f = streaming.FirFilter(kernel)
        if not fresh:
            f.set_state([float(v) for v in prior[r, -ks:]])
        want = np.array([f.filter(float(v)) for v in x[r]], np.float32)
        assert np.allclose(y[r].numpy(), want, rtol=1e-5, atol=1e-4)
        if fresh:
            assert not y[r, :ks].any()


def _s3_model(x, taps, window, R=16, threads=128):
    """S3 as fir.cu sums it, in numpy in x's type: a CTA R · threads
    outputs of a row, a thread R consecutive ones; each tap in order adds
    its product to the R sums, the inputs from a window of R values that
    turns a tap at a time (tap i0 + u reads win[(u + q) % R] for output q,
    then win[u] takes the input R further on), the last ks % R taps
    apart."""
    rows, T = x.shape
    ks = len(taps)
    dt = x.dtype
    w = np.zeros((rows, ks), dt) if window is None else window
    out = R * threads
    nb = -(-T // out)
    xp = np.concatenate([w, x, np.zeros((rows, nb * out - T + R), dt)], 1)
    base = R * np.arange(threads)
    y = np.zeros((rows, nb * out), dt)
    for blk in range(nb):
        xs = xp[:, blk * out + 1:]     # xs[:, q] = xp[t0 + 1 + q]
        acc = [np.zeros((rows, threads), dt) for _ in range(R)]
        win = [xs[:, base + q] for q in range(R)]
        i0 = 0

        def tap(u):
            kv = taps[i0 + u]
            for q in range(R):
                acc[q] = acc[q] + kv * win[(u + q) % R]
            win[u] = xs[:, base + i0 + R + u]

        while i0 + R <= ks:
            for u in range(R):
                tap(u)
            i0 += R
        for u in range(R - 1):
            if i0 + u < ks:
                tap(u)
        for q in range(R):
            y[:, blk * out + base + q] = acc[q]
    y = y[:, :T]
    if window is None:
        y[:, :ks] = 0
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ks", [1, 61, 256])
@pytest.mark.parametrize("fresh", [True, False])
def test_fir_blocked_sums_keep_the_plain_order(rng, dtype, ks, fresh):
    """The order S3's kernel keeps: _s3_model (R = 16 outputs a thread, a
    window of inputs turned a tap at a time) equals fir_apply_plain bit
    for bit, fresh and from a window, over two tiles and a partial third
    (NaN equal to NaN)."""
    T = 2 * 2048 + 300
    x = rng.normal(0, 10, (2, T)).astype(dtype)
    x[-1, T // 3] = np.nan
    taps = rng.normal(0, 0.3, ks).astype(dtype)
    window = None if fresh else rng.normal(0, 10, (2, ks)).astype(dtype)
    want = ck.fir_apply_plain(
        torch.from_numpy(x), torch.from_numpy(taps),
        None if fresh else torch.from_numpy(window)).numpy()
    got = _s3_model(x, taps, window)
    assert np.isfinite(want[0]).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_types_raise(dtype):
    """A deliberate difference from jax_filters.py:84, which keeps a half
    type: S1-S3 take float32 and float64 only, so iir_apply (both modes)
    and fir_apply raise TypeError for a half-type input."""
    b, a = DESIGNS["lp2_100_2000"]
    x = torch.ones((1, 20), dtype=dtype)
    for mode in ("scan", "assoc"):
        with pytest.raises(TypeError, match="float32 or float64"):
            tf.iir_apply(x, a, b, mode=mode, device=CPU)
    with pytest.raises(TypeError, match="float32 or float64"):
        tf.fir_apply(x, np.ones(3), device=CPU)


def test_fir_apply_limits():
    """S3 takes 1..256 taps of the input's type."""
    x = np.zeros((1, 10), np.float32)
    with pytest.raises(ValueError, match="taps"):
        tf.fir_apply(x, np.ones(257), device=CPU)
    assert tf.fir_apply(x, np.ones(256), device=CPU)[0].shape == (1, 10)


@pytest.mark.parametrize("name", ["lp2_100_2000", "bp1_15_25_1000"])
def test_iir_warmup_state_matches_jax(rng, name):
    """The closed-form warm-up state against JAX's, and against the host
    filter's literal 4·sr-step warm-up."""
    b, a = DESIGNS[name]
    x0 = rng.normal(0, 500, 3).astype(np.float32)
    xz, yz = tf.iir_warmup_state(x0, a, b, 4000, device=CPU)
    xzj, yzj = jf.iir_warmup_state(x0, a, b, 4000)
    assert np.array_equal(xz.numpy(), np.asarray(xzj))
    assert np.allclose(yz.numpy(), np.asarray(yzj), rtol=1e-4, atol=1e-2)
    for r in range(3):
        f = streaming.IirFilter(a, b)
        f.init_history_values(float(x0[r]), 1000, opt=True)
        assert np.allclose(yz[r].numpy(), f.yz[:len(a) - 1], rtol=1e-3,
                           atol=1e-1)


def test_fir_and_delay_equal_rspt_tpu(rng):
    """FirFilter (filter, filter_opt, warm-up, state), Delay and new_fir
    equal rspt_tpu's, bit for bit."""
    kernel = list(rng.normal(0, 1, 7))
    ours, theirs = streaming.new_fir(kernel, 5), ref_streaming.new_fir(
        kernel, 5)
    assert ours.kernel == theirs.kernel and ours.ksize == 5
    ours.init_history_values(3.5, 99)
    theirs.init_history_values(3.5, 99)
    for v in rng.normal(0, 100, 300):
        assert ours.filter(float(v)) == theirs.filter(float(v))
    assert ours.get_state() == theirs.get_state()
    for v in rng.normal(0, 100, 50):
        assert ours.filter_opt(float(v)) == theirs.filter_opt(float(v))
    d1, d2 = streaming.Delay(4), ref_streaming.Delay(4)
    for v in rng.normal(0, 1, 20):
        assert d1.get_delayed(float(v)) == d2.get_delayed(float(v))
