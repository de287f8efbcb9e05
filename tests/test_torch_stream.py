"""The port's streaming path (BASELINE config 5) on the CPU: the filter
design and the runtime's serial IIR against the reference's, and
rspt_tpu_torch.pipeline.StreamingCodec(device="cpu") frames against
rspt_tpu.pipeline.StreamingCodec's on the same pushes; the fused route
(a codec whose packer is the all-host engine's xdelta packer) against
both.

The IIR is bit-exact f64 and the frames a byte format: every comparison
is exact (tolerance 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread a process: the suite runs in several worker
# processes on the same cores, where more threads each contend
torch.set_num_threads(1)

from rspt_tpu import pipeline as rpipe  # noqa: E402
from rspt_tpu.packers import host as hpack  # noqa: E402
from rspt_tpu.filters import design as rdesign  # noqa: E402
from rspt_tpu.filters import streaming as rstreaming  # noqa: E402
from rspt_tpu.native import bindings as ref_native  # noqa: E402
from rspt_tpu_torch import packers as gpack  # noqa: E402
from rspt_tpu_torch import pipeline as gpipe  # noqa: E402
from rspt_tpu_torch.filters import design, streaming  # noqa: E402
from rspt_tpu_torch.native import bindings as native  # noqa: E402
from test_filters import DESIGNS  # noqa: E402

FS = 1000.0


@pytest.mark.parametrize("kind,ftype,order,fs,lo,hi", DESIGNS)
def test_design_matches_reference(kind, ftype, order, fs, lo, hi):
    """create_filter_iir's coefficients equal the reference's as floats,
    bit for bit, on tests/test_filters.py's designs (bench.py's band-pass
    among them)."""
    got = design.create_filter_iir(design.FilterKind(kind),
                                   design.FilterType(int(ftype)), order, fs,
                                   lo, hi)
    want = rdesign.create_filter_iir(rdesign.FilterKind(kind), ftype, order,
                                     fs, lo, hi)
    assert got == want
    assert [np.float64(v).tobytes() for v in got[0] + got[1]] == \
        [np.float64(v).tobytes() for v in want[0] + want[1]]


def _coefficients(p, rng):
    """(n, d) of p taps: the designs where one has p taps, else random
    with a small feedback."""
    if p == 2:
        b, a = design.butterworth_1st(design.FilterType.HIGH_PASS, FS, 0.4)
    elif p == 3:
        b, a = design.butterworth_2nd(design.FilterType.LOW_PASS, FS, 100.0)
    elif p == 5:
        b, a = design.create_filter_iir(design.FilterKind.BUTTERWORTH,
                                        design.FilterType.BAND_PASS, 2, FS,
                                        0.4, 200.0)
    else:
        a = [1.0] + list(rng.uniform(-0.3, 0.3, p - 1))
        b = list(rng.uniform(-1, 1, p))
    return a, b


@pytest.mark.parametrize("opt", [0, 1])
@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_runtime_iir_matches_loops_and_reference(p, opt):
    """The runtime's IIR at p = 2..5 in both accumulation orders, its
    state carried across two calls, equals the port's per-sample Python
    loop (filter_opt / filter) and the reference runtime's
    iir_filter_array and iir_filter_channels, bit for bit; the channel
    call equals one array call a channel."""
    rng = np.random.default_rng(60 + p)
    n, d = _coefficients(p, rng)
    x = rng.normal(0, 1000, (3, 700))
    f = streaming.IirFilter(n, d)
    step = f.filter_opt if opt else f.filter
    loop = np.array([[step(v) for v in x[0]]])
    g = streaming.IirFilter(n, d)
    y = np.concatenate([g.process(x[0, :301], opt=bool(opt)),
                        g.process(x[0, 301:], opt=bool(opt))])
    assert y.tobytes() == loop[0].tobytes()
    assert (g.xz, g.yz) == (f.xz, f.yz)
    ry, rst = ref_native.iir_filter_array(x[0], n, d, [0.0] * p, [0.0] * p,
                                          opt)
    assert ry.tobytes() == y.tobytes() and rst == (g.xz, g.yz)
    xz, yz = np.zeros((3, p)), np.zeros((3, p))
    rxz, ryz = np.zeros((3, p)), np.zeros((3, p))
    parts, rparts = [], []
    for sl in (slice(0, 301), slice(301, None)):
        parts.append(native.iir_filter_channels(x[:, sl], n, d, xz, yz, opt))
        rparts.append(ref_native.iir_filter_channels(x[:, sl], n, d, rxz,
                                                     ryz, opt))
    yc = np.concatenate(parts, axis=1)
    assert yc.tobytes() == np.concatenate(rparts, axis=1).tobytes()
    assert xz.tobytes() == rxz.tobytes() and yz.tobytes() == ryz.tobytes()
    for j in range(3):
        want, _ = native.iir_filter_array(x[j], n, d, [0.0] * p, [0.0] * p,
                                          opt)
        assert yc[j].tobytes() == want.tobytes()


def test_warmup_matches_reference():
    """init_history_values (4 x nr_samples of the generic order, in the
    runtime) leaves the reference filter's state, bit for bit."""
    b, a = design.butterworth_bandpass_2nd(FS, 0.4, 200.0)
    f = streaming.IirFilter(n=a, d=b)
    r = rstreaming.IirFilter(n=a, d=b)
    f.init_history_values(-1234.0, int(FS))
    r.init_history_values(-1234.0, int(FS))
    assert (f.xz, f.yz) == (r.xz, r.yz)
    g = streaming.new_iir(a + [9.0], b + [9.0], nr_coefficients=5)
    for _ in range(4 * int(FS)):
        g.filter(-1234.0)
    assert (g.xz, g.yz) == (f.xz, f.yz)


# -- the streaming codec --------------------------------------------------------

def _bandpass():
    b, a = design.create_filter_iir(design.FilterKind.BUTTERWORTH,
                                    design.FilterType.BAND_PASS, 2, FS, 0.4,
                                    200.0)
    return a, b


def _configs(bps, ch, ns, filtered, planes=3):
    kw = dict(sampling_rate=FS, nr_bytes_to_encode=planes,
              filter_coeffs=_bandpass() if filtered else None)
    return (gpipe.StreamConfig(bps, ch, ns, **kw),
            rpipe.StreamConfig(bps, ch, ns, **kw))


def _stream(rng, bps, ch, n, amp=4000.0):
    """Interleaved native bytes of an ECG-like sine plus noise."""
    t = np.arange(n)
    sig = (amp * np.sin(t / 50.0)[None, :]
           + rng.normal(0, amp / 100, (ch, n))).astype(np.int64)
    return gpipe.i32_to_native(sig.astype(np.int32), bps)


def _push_all(codec, chunks):
    frames = []
    for c in chunks:
        frames += codec.push(c)
    return [bytes(f) for f in frames]


@pytest.mark.parametrize("filtered", [False, True])
def test_frames_match_reference(rng, filtered):
    """Pushes in 17 irregular chunks (config 5's band-pass, or no filter):
    the port's frames equal the reference codec's, one compress_many over
    each push's whole blocks; the port's decoder gives back the packed
    (filtered) signal, as the reference's decoder does."""
    bps, ch, ns = 3, 3, 2048
    gcfg, rcfg = _configs(bps, ch, ns, filtered)
    data = _stream(rng, bps, ch, 6 * ns + 500)
    chunks = np.array_split(data, 17)
    codec = gpipe.StreamingCodec(gcfg, device="cpu")
    got = _push_all(codec, chunks)
    want = _push_all(rpipe.StreamingCodec(rcfg), chunks)
    assert len(got) == 6 and got == want
    assert codec.flush_stats()["frames"] == 6
    assert len(codec._ring) == 500 * ch * bps
    dec = gpipe.StreamingDecoder(gcfg, device="cpu")
    rdec = rpipe.StreamingDecoder(rcfg)
    out = b"".join(dec.push(f) for f in got)
    assert out == b"".join(rdec.push(f) for f in want)
    if not filtered:
        assert out == data[:6 * ns * ch * bps].tobytes()


def test_bench_config_one_push(rng):
    """bench.py's config 5 at 2 channels: 4,096-sample blocks of 32-bit
    samples, the band-pass, 3 planes; one push of 4 blocks and a tail
    (one compress_many of 4), then a push that completes one block
    (compress): frames equal the reference's; the host and device decoders
    give back the filtered signal, which equals the port's own filter."""
    bps, ch, ns = 4, 2, 4096
    gcfg, rcfg = _configs(bps, ch, ns, True)
    data = _stream(rng, bps, ch, 5 * ns, amp=2.0 ** 20)
    cut = (4 * ns + 100) * ch * bps
    codec, ref = gpipe.StreamingCodec(gcfg, device="cpu"), \
        rpipe.StreamingCodec(rcfg)
    got = [_push_all(c, [data[:cut], data[cut:]]) for c in (codec, ref)]
    assert len(got[0]) == 5 and got[0] == got[1]
    assert codec.stage_seconds.keys() == {"filter", "pack"}
    sig = gpipe.native_to_i32(data, 5 * ns, ch, bps)
    want = np.empty_like(sig)
    for j in range(ch):
        f = streaming.IirFilter(*_bandpass())
        f.init_history_values(float(sig[j, 0]), int(FS))
        want[j] = f.process(sig[j].astype(np.float64)).astype(np.int32)
    for dd in (False, True):
        dec = gpipe.StreamingDecoder(gcfg, device="cpu", device_decode=dd)
        out = np.frombuffer(b"".join(dec.push(f) for f in got[0]), np.uint8)
        np.testing.assert_array_equal(
            gpipe.native_to_i32(out, 5 * ns, ch, bps), want)


def test_out_of_range_filter_output_is_int32_min(rng):
    """A full-scale square wave at bps 4 drives the band-pass past the
    int32 range: the host conversion gives INT32_MIN there, as the
    reference's does, and the frames stay equal."""
    bps, ch, ns = 4, 2, 1024
    gcfg, rcfg = _configs(bps, ch, ns, True, planes=4)
    sq = np.where((np.arange(3 * ns) // 7) % 2, 2 ** 31 - 1, -2 ** 31)
    data = gpipe.i32_to_native(np.stack([sq, -sq - 1]).astype(np.int32), bps)
    codec = gpipe.StreamingCodec(gcfg, device="cpu")
    got = _push_all(codec, [data])
    assert got == _push_all(rpipe.StreamingCodec(rcfg), [data])
    dec = gpipe.StreamingDecoder(gcfg, device="cpu")
    out = np.frombuffer(b"".join(dec.push(f) for f in got), np.uint8)
    assert (gpipe.native_to_i32(out, 3 * ns, ch, bps) == -2 ** 31).any()


@pytest.mark.parametrize("source", ["port", "reference"])
def test_state_resume(rng, source):
    """A codec's state taken mid-stream (a partial block in its ring, the
    filters warmed) and loaded into a fresh port codec continues with the
    frames of an uninterrupted run: from the port's own codec, and from
    the reference's (state_from_reference)."""
    bps, ch, ns = 3, 2, 2048
    gcfg, rcfg = _configs(bps, ch, ns, True)
    data = _stream(rng, bps, ch, 5 * ns)
    cut = (2 * ns + 333) * ch * bps
    whole = _push_all(gpipe.StreamingCodec(gcfg, device="cpu"), [data])
    if source == "port":
        first = gpipe.StreamingCodec(gcfg, device="cpu")
        frames = _push_all(first, [data[:cut]])
        st = first.get_state()
    else:
        first = rpipe.StreamingCodec(rcfg)
        frames = _push_all(first, [data[:cut]])
        st = gpipe.state_from_reference(first.get_state())
    assert len(frames) == 2 and len(st["ring"]) == 333 * ch * bps
    resumed = gpipe.StreamingCodec(gcfg, device="cpu")
    resumed.set_state(st)
    frames += _push_all(resumed, [data[cut:]])
    assert frames == whole
    assert resumed.flush_stats()["frames"] == 5


# -- the fused route (the all-host engine) ---------------------------------------

def _fused_codec(cfg, nthreads=2):
    """A codec on the all-host engine's xdelta packer: its pushes take the
    fused route (one runtime call a span)."""
    p = gpack.new_xdelta_hzr(cfg.bytes_per_sample, cfg.nr_channels,
                             cfg.nr_samples, cfg.nr_bytes_to_encode,
                             engine="native", nthreads=nthreads)
    return gpipe.StreamingCodec(cfg, packer=p)


def _growing_stream(rng, bps, ch, ns, nblocks):
    """Three quiet blocks, then loud ones: from one plane, the count grows
    in the fourth block (at bps > 1), and the band-pass's output leaves
    the bps range on the loud part."""
    n = nblocks * ns + 300
    t = np.arange(n)
    amp = np.where(t < 3 * ns, 2.0, 2.0 ** (8 * bps - 2))
    sig = (amp * np.sin(t / 9.0)[None, :]
           + rng.normal(0, 1.0, (ch, n)) * amp / 40).astype(np.int64)
    return gpipe.i32_to_native(sig.astype(np.int32), bps)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("bps", [1, 2, 3, 4])
def test_fused_frames_match_unfused_and_reference(bps, filtered):
    """From 1 plane, pushes cut at 0.5, 4.5 and 6.2 blocks (the growth
    falls inside a span, after frames that fit) and the rest: the fused
    route's frames equal the port's unfused codec on device="cpu" and the
    reference codec on rspt_tpu.packers.host's packer; so do the plane
    count and the filters' state; the port's decoder on the native packer
    gives back the packed signal."""
    ch, ns, nblocks = 3, 512, 8
    gcfg, rcfg = _configs(bps, ch, ns, filtered, planes=1)
    data = _growing_stream(np.random.default_rng(70 + bps), bps, ch, ns,
                           nblocks)
    blk = ch * ns * bps
    cuts = [blk // 2, 9 * blk // 2, 31 * blk // 5]
    chunks = np.split(data, cuts)
    fused = _fused_codec(gcfg)
    got = _push_all(fused, chunks)
    cpu = gpipe.StreamingCodec(gcfg, device="cpu")
    ref = rpipe.StreamingCodec(rcfg, packer=hpack.new_xdelta_hzr(
        bps, ch, ns, 1))
    assert len(got) == nblocks
    assert got == _push_all(cpu, chunks) == _push_all(ref, chunks)
    assert fused.packer.nr_planes == cpu.packer.nr_planes == \
        ref.packer.nr_planes
    assert fused.packer.nr_planes == (1 if bps == 1 else bps)
    assert fused.stage_seconds.keys() == {"span"}
    if filtered:
        assert [f.xz for f in fused._filters] == [f.xz for f in cpu._filters]
        assert [f.yz for f in fused._filters] == [f.yz for f in cpu._filters]
    dec = gpipe.StreamingDecoder(gcfg, packer=gpack.new_xdelta_hzr(
        bps, ch, ns, fused.packer.nr_planes, engine="native"))
    rdec = gpipe.StreamingDecoder(gcfg, device="cpu")
    rdec.packer.nr_planes = fused.packer.nr_planes
    tail = b"".join(dec.push(f) for f in got[4:])
    assert tail == b"".join(rdec.push(f) for f in got[4:])
    if not filtered:
        assert tail == data[4 * blk:nblocks * blk].tobytes()


@pytest.mark.parametrize("first", ["fused", "unfused"])
def test_fused_state_hand_over(first):
    """A state taken mid-stream (a partial block in the ring, the filters
    warmed) from one route and loaded into a codec of the other
    continues with the frames of an uninterrupted run."""
    bps, ch, ns = 3, 2, 1024
    gcfg, _ = _configs(bps, ch, ns, True)
    data = _stream(np.random.default_rng(5), bps, ch, 5 * ns)
    cut = (2 * ns + 333) * ch * bps
    make = {"fused": _fused_codec,
            "unfused": lambda c: gpipe.StreamingCodec(c, device="cpu")}
    second = "unfused" if first == "fused" else "fused"
    whole = _push_all(make[second](gcfg), [data])
    a = make[first](gcfg)
    frames = _push_all(a, [data[:cut]])
    b = make[second](gcfg)
    b.set_state(a.get_state())
    frames += _push_all(b, [data[cut:]])
    assert len(frames) == 5 and frames == whole
    assert b.flush_stats()["frames"] == 5


def test_fused_out_of_range_filter_output():
    """The full-scale square wave at bps 4 through the fused route: the
    band-pass's out-of-range outputs convert to INT32_MIN as x86 does,
    and the frames equal the unfused codec's, at 1 and 4 threads."""
    bps, ch, ns = 4, 2, 1024
    gcfg, _ = _configs(bps, ch, ns, True, planes=4)
    sq = np.where((np.arange(3 * ns) // 7) % 2, 2 ** 31 - 1, -2 ** 31)
    data = gpipe.i32_to_native(np.stack([sq, -sq - 1]).astype(np.int32), bps)
    want = _push_all(gpipe.StreamingCodec(gcfg, device="cpu"), [data])
    for nt in (1, 4):
        assert _push_all(_fused_codec(gcfg, nt), [data]) == want
    out = np.frombuffer(b"".join(gpipe.StreamingDecoder(
        gcfg, device="cpu").push(f) for f in want), np.uint8)
    assert (gpipe.native_to_i32(out, 3 * ns, ch, bps) == -2 ** 31).any()


def test_fused_route_needs_hzr_planes():
    """A native xdelta packer with LZ4 planes takes the unfused route
    (compress_many on the native packer), with the host packer's
    frames."""
    bps, ch, ns = 2, 2, 256
    gcfg, rcfg = _configs(bps, ch, ns, True)
    data = _stream(np.random.default_rng(8), bps, ch, 3 * ns, amp=3000.0)
    codec = gpipe.StreamingCodec(gcfg, packer=gpack.new_xdelta_hzr(
        bps, ch, ns, 3, engine="native", plane_backend="lz4"))
    ref = rpipe.StreamingCodec(rcfg, packer=hpack.new_xdelta_hzr(
        bps, ch, ns, 3, plane_backend="lz4"))
    assert _push_all(codec, [data]) == _push_all(ref, [data])
    assert codec.stage_seconds.keys() == {"filter", "pack"}
