"""Chip smoke test of the PyTorch/CUDA port (rspt_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ops/csrc, holds each kernel against
its plain PyTorch version on the card (bit-exact, tolerance 0: every
output is integer), then drives the main path — the xdelta_hzr packer's
compress and decompress at the full width of BASELINE config 2, a
12-channel, 32-bit, 34,199-sample ECG-like signal made from seed 1234 —
and checks that the container from the card equals the one from the
CPU (plain versions), that decompress round-trips it exactly, and that
every kernel of the path launched. The other paths are driven the same
way, each with the launch counts set to 0 just before it: the Hadamard
packer at BASELINE config 3 (the same signal cut to 2^14 samples), the
hzr packer at the main shape and on config 1's 8,192-sample sine,
compress_with_hints at the main shape, the hzr stream encoder
torch_coder.encode on the main payload's bytes as one stream, the
windows routes of the flat pack on the main pass 1, and the DCT packer
at BASELINE config 4 (the same signal cut to 4,096 samples, at 4 and 3
bytes a sample), and the streaming path at BASELINE config 5 (the whole
signal pushed into a StreamingCodec with 4,096-sample blocks and the
band-pass pre-filter: 8 frames in one compress_many), and the batch
signal ops (the peak detectors, the FIR and the rolling medians on 12
channels of 1,048,576 float32 samples at 360 Hz, the same formula).

Phases: 1 build (the kernels with nvcc and the host runtime,
rspt_tpu_torch/native, with g++, at once); 2 encode kernels vs plain on
every chain, xdelta_swizzle also on the main signal's native bytes at
bps 1-4, on the edges of its tiles, bands, loads and flag
(tests/test_torch_cuda.py's xdelta_edge_batch) and in 100 calls
alternating passing and failing inputs (its flag state resets)
(pack_flat_lanes too; group_windows, place_windows_aligned and
windows_place_flat, with both windows routes' payload bytes equal to
pack_flat's and no super of the main pass 1 on K15's slow path;
windows_place_flat and place_windows_aligned also on
tests/test_torch_cuda.py's WINDOWS_EDGE_CASES, each in 3 launches with
its count of supers on K15's slow path, on X1_EDGE_CASES and on 160
groups in 10 launches; group_windows on the same cases' groups, on
K14_EDGE_CASES and on the 160 groups), compact_tokens on
the edges of its tile split and look-back (tests/test_torch_cuda.py's
compact_edge_batch), tokenize_planes on the edges of its tiles
(tokenize_edge_batch, planes 1-4), and pack_flat and pack_flat_lanes on
the edges of their tiles and look-back (pack_flat_edge_batch: blocks of
1-2, 2,047-2,049 and several tiles, COPY/FILL/empty blocks between, a
token spanning the word two tiles share, segment boundaries crossed by a
tile's first token and by a block's last, nwords one word short, tokc
cut inside a block, overlapping blocks, 1,080-1,152 tiles); 3 compress /
host-decode decompress, and a pass 1 at bps 2 and 3 (one xdelta_swizzle
on the native bytes, no elementwise kernel or fill beside it); 5 decode kernels (hzr_decode, place_literals)
vs plain at the main-path shape and on edge inputs (rank_edge_payloads: a block across every CTA of
a tile's cluster, padding rows between blocks; trusted and not),
place_literals also on the word-store edges of place_edge_batch; 6
decompress(device_decode=True) and decompress_many with and without
hints; 7 fwht vs plain (tests/test_torch_cuda.py's FWHT_CASES: every
change of its cluster size, 1, 13 and 1,001 rows, the global passes; x
unchanged); 8 the Hadamard path; 9 the hzr path; 10 the hints path; 11
the stream encoder: pack_blocks and pack_blocks_tokw vs plain (the main
payload as 26 blocks, the main pass 1's 21 blocks, an edge batch with an
overflowing row and pack_blocks_edge_batch: partial last tiles, tokens
spanning the word two tiles share, an empty tile between valid ones, a
row passing nwords in a middle tile, 1 and 48 blocks), encode on the
card against the CPU, a device decode and the out_capacity rule,
entropy_streams_blocks against the flat path; 12 the windows routes
(pack_tokens_fused and pack_tokens_windows give the main container's
streams, each through its kernels once), compact_tokens on the main
pass 1 in 10 launches with
equal words, and the xdelta growth rule at bps 1-3 on the card; 13 the
host runtime against its plain Python versions at the main path's
shapes (CRC32C over the main container and each of its blocks,
build_tables on the main pass 1's histograms, decode_planes_blocks on
the main, Hadamard and hzr containers, lut_nib_batch on the main
decode's 14 HUFF blocks), each equal, with both times; 14 the DCT path:
dct_forward and dct_inverse vs plain on tests/test_torch_cuda.py's
dct_edge_batch (n of 1-4,096, 1-17 channels, the inverse's overflow
inputs giving x86's INT32_MIN), then compress, host decompress,
decompress(device_decode=True) and decompress_many of 3, each equal to
the CPU's, one dct_forward a compress and one dct_inverse a decompress
(the profiler sees both kernels; the plain versions are never called),
with CR and PRDN; 15 the streaming path: xdelta_swizzle_batch and the
2-D tokenize_planes vs plain on tests/test_torch_cuda.py's batch cases
and at config 5's 8 x 12 x 4,096 (bps 4 and 3), then one push of the
main signal into a StreamingCodec: 8 frames through one
xdelta_swizzle_batch, one tokenize_planes and two waves of
compact_tokens and pack_flat, no plain version called, the frames equal
to the CPU codec's, host and device decoders giving back the filtered
signal; its timings (CUDA events; compress_many against 8 compress
calls; cold and steady pushes; a decoder push a frame) come next; 16
the batch signal ops: iir_scan, iir_assoc, fir_apply and peak_gate vs
plain on tests/test_torch_cuda.py's IIR_EDGE_CASES, FIR_EDGE_CASES and
GATE_EDGE_CASES (tolerance 0, NaN equal to NaN; peak_gate at each case's
schedule, its re-run counts equal to tests/test_torch_cuda.py's model of
the schedule), then at 12 x 2^20 (iir_assoc and fir_apply against their
plain versions on the card, iir_scan in float32 and float64 and
peak_gate on detect_batch's gate against theirs on the CPU, the float64
iir_scan also equal to the host runtime, peak_gate on the offline
detector's gate against its own serial schedule; peak_gate's re-run
counts on both gates logged),
detect_batch, detect_offline_batch and fir_apply
through the entry points (exact launches, no plain version), both
detectors on 2 x 120,000 against the host detectors and the rolling
medians at test_8's windows on 1,000,000 samples against
RollingWindowMedian; its timings (each kernel's CUDA-event time, fir_apply
in turns with conv1d, the detectors' and medians' walls) last; 4,
times each kernel's call (profiler device time of every device operation
of the wrapper's call: kernels, memsets, copies; xdelta_swizzle on the
'<i4' words and on 16-bit native bytes, each one device operation a
call) beside its bound, its
plain version and a library yardstick (tokenize_planes in turns with
bincount, compact_tokens with masked_select, place_literals with
index_put_; both xdelta_swizzle rows, fwht, pack_blocks and
pack_blocks_tokw as medians of 5
rounds beside their rounds; dct_forward and dct_inverse in turns with
an f64 torch.matmul over the same operands), hzr_decode's and fwht's
clusters,
tokenize_planes', pack_flat's and pack_blocks' working blocks, and the
host stages and wall times of every path (the Hadamard path, encode and
entropy_streams_blocks with their spread; the DCT walls and its
table construction). The last two lines are a
JSON object of the kernels and the result line.

Phase 17, after phase 16's timings: the sharded codec
(rspt_tpu_torch.parallel) on meshes of 1, 2 and 4 shards of the card
(and of every card where there are more): the xdelta packer with the
sharded encoder (its container equal to the unsharded one, K3 and K4
once on each shard holding a HUFF block), the hzr packer on the 3 x 64
KiB random input (all COPY: K13a once a shard), the stream encode equal
to torch_coder.encode (out_capacity too), the decode of the main
streams equal to gpu_decoder.decode_many (K6 and K7 once on each shard
holding a block; the hinted rerun too) and the scans over the main
signal's words equal to torch_ops; a 4-shard hint refused by 2 shards;
(b) this script re-run as two gloo workers (--gloo-worker RANK PORT) of
2 shards of the card each: the 2 MiB encode equal to torch_coder.encode
on both ranks and the scans across them, within 180 s; (c) the
profiler's device operations of a 4-shard encode and decode; (d) the
walls of the sharded encode, compress and decode against the unsharded
calls, in turns, medians of 5 [min, max].

Phase 18, after phase 17: the LZ4 plane backend (plane_backend 'lz4'
and 'lz4hc') on the main signal (xdelta at 3 planes: one xdelta_swizzle
a compress and no tokenize_planes; compress_many of 4 payloads one
xdelta_swizzle_batch, equal to sequential compress calls; a
device_decode packer decoding a mixed LZ4 / hzr batch), the Hadamard
packer at config 3 (fwht), the DCT packer at config 4 at bps 3
(dct_forward, dct_inverse) and the Hadamard packer at one sample (no
fwht launch; the hzr containers 52 and 58 B): every container equal to
the device="cpu" packer's, every decode (host, device_decode,
decompress_many) equal to the CPU's, the plain versions never called,
the profiler's device operations holding the path's kernels; then the
walls of compress (with its LZ4 host stage), decompress and
decompress(device_decode) beside the hzr packer's, in turns, medians of
5 [min, max], and the CRs.

Phase 19, after phase 18: the all-host engine (engine="native",
packers/native.py), which launches no kernel: config 2's main signal
(xdelta at 3 planes, hzr and 'lz4' planes), config 1's sine (hzr),
config 3's Hadamard at 2^14 and config 4's DCT at 4,096 (bps 4 and 3),
each native container equal to the card packer's and each native decode
equal to the card's; config 5's frames through the fused streaming route
equal to the card codec's over the same pushes; no launch counted and no
device operation seen by the profiler during the native calls; then the
walls of each, in turns with the card, beside the host's CPU model,
os.cpu_count() and the runtime's threads.
Exits nonzero, with no result line, when there is no CUDA card or any
check fails. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor fp32 rate, for int ops
F64_ADDS_PER_S = 34e12 / 2     # H100 SXM non-tensor fp64: 34 TFLOP/s of FMA
# f32 -> f64 conversions: 16 a clock an SM on compute capability 9.0 (CUDA
# C++ Programming Guide, arithmetic instruction throughput), 132 SMs at
# the 1.98 GHz boost clock
F2F_PER_S = 16 * 132 * 1.98e9
REPS = 30


_T0 = time.perf_counter()


def log(*a):
    """Print a line; a phase's line with the seconds since the start."""
    if a and str(a[0]).startswith("phase"):
        a = (f"[{time.perf_counter() - _T0:.1f} s]",) + a
    print(*a, flush=True)


def make_ecg(channels=12, samples=34199, seed=1234):
    """ECG-like synthetic of BASELINE config 2's shape (the formula of
    bench.py's make_ecg fallback)."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples)
    wander = 200000.0 * np.sin(t / 700.0)[None, :] \
        + 150000.0 * np.sin(t / 1300.0 + np.arange(channels)[:, None])
    beat = 800000.0 * (np.sin(t / 37.0) ** 63)[None, :]
    noise = np.cumsum(rng.normal(0, 800.0, (channels, samples)), axis=1)
    sig = (wander + beat + noise).astype(np.int64)
    lim = 2 ** 31 - 1
    sig = np.clip(sig, -lim, lim).astype(np.int32)
    return sig, np.ascontiguousarray(sig.T).astype("<i4").tobytes()


def to_native(sig: np.ndarray, bps: int) -> bytes:
    """Channel-major int32 → interleaved little-endian bps-byte samples."""
    v = np.ascontiguousarray(sig.T).astype(np.uint32)
    return np.stack([(v >> np.uint32(8 * k)) & np.uint32(255)
                     for k in range(bps)], -1).astype(np.uint8).tobytes()


def equal(name, got, want):
    """Bit-exact comparison of tensors (or tuples of them)."""
    if isinstance(got, (tuple, list)):
        for k, (g, w) in enumerate(zip(got, want)):
            equal(f"{name}[{k}]", g, w)
        return 0
    g, w = got.cpu(), want.cpu()
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                             f"{w.shape}/{w.dtype}")
    diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
    err = int(diff.max()) if diff.numel() else 0
    if err:
        first = int(torch.nonzero(diff.reshape(-1))[0])
        raise AssertionError(f"{name}: differs, max |err| {err}, first at "
                             f"flat index {first}")
    return err


def cuda_ms(fn, reps=REPS, warm=3):
    """Median of per-launch CUDA-event times, after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_events(fn, reps, tries=4):
    """The device activity of reps calls of fn, in order. The profiler
    may lose events (a whole trace of them, or a few), never add one: the
    calls are traced until two traces in a row hold as many device events
    (at most tries traces), and the fullest trace is kept."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, last = [], None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(evs) > len(best):
            best = evs
        if evs and len(evs) == last:
            break
        last = len(evs)
    return best


def device_ms(fn, reps=REPS, kernel=None):
    """Device time per call from torch.profiler's CUDA activity: the
    median of the kernel named `kernel`, else the sum of every device
    activity of the call. None if the profiler saw no device activity."""
    evs = [e for e in _device_events(fn, reps)
           if kernel is None or kernel in e.name]
    if not evs:
        return None
    us = [e.time_range.elapsed_us() for e in evs]
    return (statistics.median(us) if kernel else sum(us) / reps) / 1e3


def device_op_names(fn, reps=5, traces=2):
    """The distinct names of the device operations (kernels, memsets,
    copies) of reps calls, in the order they first ran, over `traces`
    measurements: the profiler may drop an event, never add one, so
    every name seen ran, and one that a trace lost turns up in another."""
    names = {}
    for _ in range(traces):
        for e in _device_events(fn, reps):
            names.setdefault(e.name, None)
    return list(names)


def device_ops(fn, reps=30):
    """The device operations of reps calls from the profiler's CUDA
    activity: (their distinct names, operations a call). The profiler may
    drop an event, never add one."""
    evs = _device_events(fn, reps)
    return sorted({e.name for e in evs}), len(evs) / reps


def wall_times(fn, reps=3):
    """Wall seconds of reps calls, each ended by a synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def wall_s(fn, reps=3):
    return statistics.median(wall_times(fn, reps))


def spread(times, digits=4):
    """median [min, max] of a list of times, for a log line."""
    return (f"{statistics.median(times):.{digits}f} [{min(times):.{digits}f}, "
            f"{max(times):.{digits}f}]")


def hadamard_input(native, ch, dev, n3=2 ** 14):
    """The centred (ch, n3) rows that the Hadamard compress at BASELINE
    config 3 (the main signal cut to n3 samples) gives fwht."""
    from rspt_tpu_torch.ops import torch_ops as tops
    w3 = torch.from_numpy(np.frombuffer(native[:n3 * ch * 4], "<i4").copy())
    sig3 = tops.native_to_i32(w3.to(dev), n3, ch, 4).contiguous()
    m3 = tops.average32_host(tops.row_sums64(sig3).cpu().numpy(), n3)
    return tops._wrap32(sig3.long() - torch.from_numpy(
        m3.astype(np.int64)).to(dev)[:, None])


def stream_blocks_args(tc, native, dev):
    """pack_blocks' arguments for the main payload's bytes as one hzr
    stream (26 blocks): (syms, extras, ebits, tvalid, lut, desc_bits),
    and the blocks and lengths."""
    blk, lengths = tc.split_blocks(np.frombuffer(native, np.uint8))
    f = tc.tokenize_blocks(torch.from_numpy(blk).to(dev),
                           torch.from_numpy(lengths).to(dev))
    return (*f[:4], *block_tables(tc, f[4], lengths, dev)), blk, lengths


def pass1_blocks_args(tc, x, dev):
    """pack_blocks_tokw's arguments for a pass 1 of 3 planes
    (kernel_inputs' x): (tokw, lut, desc_bits)."""
    _, lengths = tc.block_layout(x["enc"].numel(), 3)
    return (x["tokw"], *block_tables(tc, x["hist"], lengths, dev))


def kernel_inputs(ck, tc, raw, ns, ch, planes, bps=4, swizzle=True,
                  tokenize_raw=False):
    from rspt_tpu_torch.hzr import sidecar
    """Every kernel's inputs along the pass-1 → plan → pass-2 chain, made
    with the plain versions (so a kernel fault cannot feed the next).
    tokenize_raw: tokenize `raw` itself (crafted edge inputs) instead of
    its xdelta."""
    enc, ok = ck.xdelta_swizzle_plain(raw, ns, ch, planes, bps, swizzle)
    if tokenize_raw:
        enc = raw
    tokw, bwords, hist = ck.tokenize_planes_plain(enc, planes)
    _, lengths = tc.block_layout(enc.numel(), planes)
    plan = tc.flat_plan(hist.cpu().numpy(), lengths)
    dev = raw.device

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    bases = d(plan.bases)
    tokc = ck.compact_tokens_plain(tokw, bases, plan.T)
    hp = sidecar.plan_hints(lengths, plan.comp_len, plan.desc_bits,
                            plan.comp_len > 0)
    lanes = None if hp is None else (d(hp.meta), d(hp.init))
    return dict(enc=enc, tokw=tokw, bwords=bwords, hist=hist, plan=plan,
                bases=bases, tokc=tokc, ntok=d(plan.ntok), bit0=d(plan.bit0),
                lut=d(plan.lut), lanes=lanes)


def check_chain(ck, tc, name, raw, ns, ch, planes, bps=4, swizzle=True,
                tokenize_raw=False):
    """Each kernel against its plain version along one input's chain."""
    x = kernel_inputs(ck, tc, raw, ns, ch, planes, bps, swizzle,
                      tokenize_raw)
    p = x["plan"]
    equal(f"{name}/xdelta_swizzle",
          ck.xdelta_swizzle(raw, ns, ch, planes, bps, swizzle),
          ck.xdelta_swizzle_plain(raw, ns, ch, planes, bps, swizzle))
    equal(f"{name}/tokenize_planes", ck.tokenize_planes(x["enc"], planes),
          ck.tokenize_planes_plain(x["enc"], planes))
    equal(f"{name}/compact_tokens",
          ck.compact_tokens(x["tokw"], x["bases"], p.T), x["tokc"])
    args = (x["tokc"], x["bases"], x["ntok"], x["bit0"], x["lut"], p.nwords)
    words = ck.pack_flat(*args)
    equal(f"{name}/pack_flat", words, ck.pack_flat_plain(*args))
    if x["lanes"] is not None:
        got = ck.pack_flat_lanes(*args, *x["lanes"])
        equal(f"{name}/pack_flat_lanes", got,
              ck.pack_flat_lanes_plain(*args, *x["lanes"]))
        equal(f"{name}/pack_flat_lanes words", got[0], words)
    # the windows routes' kernels (K14, X1, K15)
    gl = tc.group_layout(p, raw.device)
    flat = x["tokc"].reshape(1, -1)
    w = ck.group_windows(flat, gl.lut3)
    equal(f"{name}/group_windows", w, ck.group_windows_plain(flat, gl.lut3))
    glue = ck.windows_glue(*w, gl.dbg, gl.wog, gl.gfirst, gl.nrows_windows,
                           ck.AR2)
    x1 = ck.place_windows_aligned(*glue, gl.nrows_windows)
    equal(f"{name}/place_windows_aligned", x1,
          ck.place_windows_aligned_plain(*glue, gl.nrows_windows))
    fused = (x["tokc"].reshape(-1, 128), gl.lut3, gl.dbg, gl.wog, gl.gfirst,
             gl.ng, gl.nrows_fused)
    k15 = ck.windows_place_flat(*fused)
    equal(f"{name}/windows_place_flat", k15,
          ck.windows_place_flat_plain(*fused))
    # the supers K15 sent to its slow path (none without a group)
    x["k15_slow"] = (int(ck.windows_place_flat.last_slow)
                     if gl.ng else 0)
    for route, got in (("windows", x1), ("fused", k15)):
        equal(f"{name}/{route} route payload",
              payload_bytes(got, p.total_payload),
              payload_bytes(words, p.total_payload))
    torch.cuda.synchronize()
    x["groups"] = gl
    return x


def check_group_windows(ck, args, what, launches):
    """group_windows against its plain version in `launches` launches."""
    plain = ck.group_windows_plain(*args)
    for k in range(launches):
        equal(f"group_windows {what}, launch {k}", ck.group_windows(*args),
              plain)


def check_windows_edges(ck, edges, dev):
    """K14, K15 and X1 against their plain versions on the card tests'
    edge inputs: every WINDOWS_EDGE_CASES case in 3 launches, each with
    the case's count of supers on K15's slow path, K14 on its groups and
    X1 on its windows and glue; every K14_EDGE_CASES case in 3 launches;
    every X1_EDGE_CASES case; 160 groups in 10 launches of K14 and of K15
    (no super on the slow path). Returns the slow-path counts by case."""
    if ck._lib().rspt_group_windows_tile() != edges.K14_TILE:
        raise AssertionError("group_windows: the library's tile is not "
                             "the tests' K14_TILE")
    slow = {}
    for case in edges.K14_EDGE_CASES:
        check_group_windows(ck, [v.to(dev) for v in edges.k14_edge_batch(
            np.random.default_rng(160), case)], f"k14/{case}", 3)
    for case, want in edges.WINDOWS_EDGE_CASES.items():
        a = tuple(v.to(dev) if torch.is_tensor(v) else v
                  for v in edges.windows_edge_batch(
                      np.random.default_rng(140), case))
        check_group_windows(ck, edges.group_windows_args(a), case, 3)
        plain = ck.windows_place_flat_plain(*a)
        for k in range(3):
            equal(f"windows_place_flat {case}, launch {k}",
                  ck.windows_place_flat(*a), plain)
            slow[case] = int(ck.windows_place_flat.last_slow)
            if slow[case] != want:
                raise AssertionError(f"windows_place_flat {case}: "
                                     f"{slow[case]} slow supers, not {want}")
        *x1, nrows = edges.x1_inputs(a)
        equal(f"place_windows_aligned {case}",
              ck.place_windows_aligned(*x1, nrows),
              ck.place_windows_aligned_plain(*x1, nrows))
    for case in edges.X1_EDGE_CASES:
        *x1, nrows = edges.x1_edge_batch(np.random.default_rng(150), case)
        x1 = [v.to(dev) for v in x1]
        equal(f"place_windows_aligned x1/{case}",
              ck.place_windows_aligned(*x1, nrows),
              ck.place_windows_aligned_plain(*x1, nrows))
    args, want = edges.windows_many_groups(np.random.default_rng(1234), dev)
    check_group_windows(ck, edges.group_windows_args(args), "160 groups", 10)
    for k in range(10):
        equal(f"windows_place_flat 160 groups, launch {k}",
              ck.windows_place_flat(*args), want)
        if int(ck.windows_place_flat.last_slow):
            raise AssertionError("windows_place_flat 160 groups: a super "
                                 "on the slow path")
    torch.cuda.synchronize()
    return slow


def payload_bytes(words, n):
    """The first n bytes of a word buffer (either layout)."""
    return words.reshape(-1).view(torch.uint8)[:n]


def route_streams(tc, x, words, plane_len, planes):
    """The plane streams that entropy_streams would assemble around
    payload words of a pack route, from the chain's plan, histograms and
    COPY rows."""
    plan = x["plan"]
    nb_per, lengths = tc.block_layout(plane_len, planes)
    copy_rows = np.flatnonzero(plan.is_copy)
    copy_len = np.where(plan.is_copy, lengths, 0).astype(np.int64)
    copy_np = np.zeros(0, np.uint8)
    if copy_rows.size:
        raw = x["bwords"][torch.from_numpy(copy_rows).to(
            x["bwords"].device)].cpu().numpy().view(np.uint8)
        copy_np = np.concatenate([raw[j, :lengths[b]]
                                  for j, b in enumerate(copy_rows)])
    tight = payload_bytes(words, plan.total_payload).cpu().numpy().copy()
    tc._or_descriptions(tight, plan.comp_len, plan.desc_bytes)
    return tc.plane_streams(lengths, nb_per, planes, tight, plan.comp_len,
                            copy_np, copy_len, plan.is_fill,
                            tc.fill_bytes_from_hist(x["hist"].cpu().numpy()))


def fibonacci_bytes(nsym, rng):
    """Symbol k (1..nsym) fib(k) times, shuffled: the deepest Huffman
    tree for its size (22 symbols: 21-bit codes, four nibble levels)."""
    fib = [1, 1]
    while len(fib) < nsym:
        fib.append(fib[-1] + fib[-2])
    x = np.repeat(np.arange(1, nsym + 1, dtype=np.uint8), fib)
    rng.shuffle(x)
    return x


def decode_inputs(gd, streams, dev):
    """hzr_decode's inputs for a stream batch, made by gpu_decoder's host
    half (the kernels' own path), and the batch's output size."""
    _, out, huff = gd._walk_all(streams)
    blocks, _ = gd._device_blocks(huff)
    la = gd.lane_arrays(blocks)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in la.kernel_inputs()]
    return la, args, out.size, blocks


def place_inputs(gd, la, counts, stats, dev):
    live = torch.from_numpy(la.lane_live).to(dev)
    base = gd.lane_out_base(counts, live,
                            torch.from_numpy(la.out_off).to(dev),
                            torch.from_numpy(la.block_first).to(dev))
    return (stats[:, 0].contiguous(), base,
            torch.from_numpy(la.out_limit).to(dev), live)


def check_decode(ck, gd, name, la, args, total, dev):
    """hzr_decode and place_literals against their plain versions on one
    batch; returns the kernel's outputs."""
    got = ck.hzr_decode(*args)
    want = ck.hzr_decode_plain(*args)
    equal(f"{name}/hzr_decode counts, entries, stats", got[1:], want[1:])
    equal(f"{name}/hzr_decode emissions",
          gd.valid_emissions(got[0], got[3][:, 0]),
          gd.valid_emissions(want[0], want[3][:, 0]))
    pa = place_inputs(gd, la, got[1], got[3], dev)
    equal(f"{name}/place_literals",
          ck.place_literals(got[0], *pa, total),
          ck.place_literals_plain(
              got[0], *pa, torch.zeros(total, dtype=torch.uint8, device=dev)))
    torch.cuda.synchronize()
    return got


def block_tables(tc, hist, lengths, dev):
    """pack_blocks' LUT words and description bit counts on the card
    from a batch's histograms."""
    codes, cbits, _, desc_bits, _ = tc.host_tables(hist.cpu().numpy(),
                                                   lengths)
    return (torch.from_numpy(tc.lut_words(codes, cbits)).to(dev),
            torch.from_numpy(desc_bits).to(dev))


def block_modes(stream):
    """The encoding byte of every block header of an hzr stream."""
    modes = []
    left = int.from_bytes(stream[:4], "little")
    pos = 4
    while left > 0:
        size = int.from_bytes(stream[pos:pos + 2], "little") + 1
        modes.append(stream[pos + 6])
        pos += 7 + size
        left -= min(left, 65536)
    return modes


def block_crcs(stream):
    """(stored CRC32C, the bytes it covers) of every block of an hzr
    stream."""
    out = []
    left = int.from_bytes(stream[:4], "little")
    pos = 4
    while left > 0:
        size = int.from_bytes(stream[pos:pos + 2], "little") + 1
        n = 1 if stream[pos + 6] == 2 else size
        out.append((int.from_bytes(stream[pos + 2:pos + 6], "little"),
                    np.frombuffer(stream[pos + 7:pos + 7 + n], np.uint8)))
        pos += 7 + n
        left -= min(left, 65536)
    return out


def timed(fn):
    """(fn(), its wall seconds)."""
    t0 = time.perf_counter()
    r = fn()
    return r, time.perf_counter() - t0


def check_runtime(containers, hist_m, plane_len):
    """Phase 13: each function of the host runtime against its plain
    Python version at the main path's shapes, equal, with both times
    (the runtime's a median of 5 calls, the plain version's of one).
    containers: {name: (container, planes, header bytes, plane bytes)},
    the main one first."""
    from rspt_tpu_torch.formats.crc32c import crc32c, crc32c_plain
    from rspt_tpu_torch.hzr import gpu_decoder as gd
    from rspt_tpu_torch.hzr import pyref, walk
    from rspt_tpu_torch.hzr import torch_coder as tc
    from rspt_tpu_torch.native import bindings as rt

    times = {}

    def both(name, fast, plain):
        want, tp = timed(plain)
        got = fast()
        times[name] = (wall_s(fast, reps=5), tp)
        return got, want

    comp = containers["main"][0]
    buf = np.frombuffer(comp, np.uint8)
    got, want = both("crc32c container", lambda: crc32c(buf),
                     lambda: crc32c_plain(buf))
    if got != want:
        raise AssertionError(f"crc32c over the container: {got} != {want}")
    streams = _plane_streams(comp, 3, 0)
    blocks = [b for s in streams for b in block_crcs(s)]
    got, want = both("crc32c blocks",
                     lambda: [crc32c(b) for _, b in blocks],
                     lambda: [crc32c_plain(b) for _, b in blocks])
    if not got == want == [c for c, _ in blocks]:
        raise AssertionError("crc32c of the main container's blocks")
    lengths = tc.block_layout(plane_len, 3)[1]
    got, want = both("build_tables",
                     lambda: tc.host_tables(hist_m, lengths),
                     lambda: tc.host_tables_plain(hist_m, lengths))
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError("build_tables differs from host_tables_plain")
    decoded = {}
    for name, (c, nplanes, hsize, n) in containers.items():
        cb = np.frombuffer(c, np.uint8)
        ss = _plane_streams(c, nplanes, hsize)
        (got, used), want = both(
            f"decode_planes_blocks {name}",
            lambda: rt.decode_planes_blocks(cb[1 + hsize:], nplanes, n),
            lambda: [pyref.decode(s, n) for s in ss])
        if used + 1 + hsize != len(c) or [g.tobytes() for g in got] != want:
            raise AssertionError(f"decode_planes_blocks {name} != pyref")
        decoded[name] = len(c)

    def walked(light):
        huff = []
        for st in streams:
            size = int.from_bytes(st[:4], "little")
            walk.walk_stream(np.frombuffer(st, np.uint8), size, 0,
                             np.zeros(size, np.uint8), huff, light)
        return huff

    huff = walked(False)
    (luts, dbits), want = both(
        "lut_nib_batch",
        lambda: rt.lut_nib_batch([h[0] for h in walked(True)]),
        lambda: [gd.build_lut_nib(h[5]) for h in walked(False)])
    if len(luts) != 14 or dbits.tolist() != [h[2] for h in huff]:
        raise AssertionError(f"lut_nib_batch: {len(luts)} blocks, dbits")
    for g, w in zip(luts, want):
        if (not np.array_equal(g[0], w[0]) or g[2] != w[2] or not all(
                np.array_equal(a, b) for a, b in zip(g[1], w[1]))):
            raise AssertionError("lut_nib_batch differs from build_lut_nib")
    log(f"phase 13: host runtime equal to its plain versions: crc32c over "
        f"the {len(comp)} B main container and its {len(blocks)} blocks "
        f"(stored CRCs), build_tables on the main pass 1's "
        f"{hist_m.reshape(-1, 261).shape[0]} histograms, "
        f"decode_planes_blocks on {decoded} B containers, lut_nib_batch on "
        f"the main decode's {len(luts)} HUFF blocks (walk included)")
    for name, (tn, tp) in times.items():
        log(f"phase 13: {name}: runtime {tn:.6f} s, plain {tp:.6f} s "
            f"({tp / tn:.0f}x)")


def _plane_streams(comp, nplanes, hsize):
    """The stream of each plane of a container."""
    out, pos = [], 1 + hsize
    for _ in range(nplanes):
        n = int.from_bytes(comp[pos:pos + 4], "little")
        out.append(comp[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def symbols_decoded(emis, counts, steps):
    """Symbols of the final sweep: every step below a lane's own step
    count raises its output count (by 1 for a byte, >= 2 for a zero run);
    the rows from there to the tile's step count repeat the final count,
    and the rows past it are scratch."""
    nt = emis.shape[0]
    s_max = int(steps.max())
    o = (emis[:, :s_max].reshape(nt, s_max, 1024) >> 9).long()
    fin = counts.reshape(nt, 1, 1024).long()
    s = torch.arange(s_max, device=emis.device)[None, :, None]
    st = steps.reshape(nt, 1, 1)
    nxt = torch.where(s + 1 < st, torch.cat([o[:, 1:], fin], 1), fin)
    return int(((nxt != o) & (s < st)).sum())


def measure_row(name, r, launches):
    """The kernels JSON line of the kernel row r (see main's rows), with
    its log line: the device time of the wrapper's call from the
    profiler (every device operation of it: kernels, memsets, copies; the
    named kernel alone for the log; CUDA events around one call, host
    launch cost included, where it sees no device activity) and its
    library call's, its plain version's call from CUDA events, and its
    bound: the larger of its bytes
    over the memory rate and its operations' time (r["ops_ms"], or
    r["ops"] integer operations over INT_OPS_PER_S)."""
    call_ms = cuda_ms(r["fn"])
    ms = device_ms(r["fn"]) or call_ms
    kern_ms = device_ms(r["fn"], kernel=r.get("kernel", name + "_kernel"))
    # the plain versions (hundreds to thousands of small kernels a call):
    # CUDA events around each call, median, not the profiler, whose
    # traces of them took minutes
    plain_ms = cuda_ms(r["plain"], r.get("plain_reps", 10), warm=1)
    lib_ms = None
    if r["library"]:
        lib_ms = device_ms(r["library"]) or cuda_ms(r["library"])
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = r.get("ops_ms", r.get("ops", 0) / INT_OPS_PER_S * 1e3)
    row = dict(
        name=name, route="cuda", source=r["source"],
        replaces=r["replaces"], launches=launches[name], max_abs_err=0,
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms)
    log(f"phase 4: {name}: {ms:.6f} ms of device time a call (the "
        f"kernel alone {kern_ms}), "
        f"{call_ms:.4f} ms a call with launch (bound "
        f"{max(t_bytes, t_ops):.4f} ms by {row['bound_by']}, "
        f"{r['bytes']} B), plain {plain_ms:.4f} ms, library "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    return row


def measure_in_turns(name, r, row):
    """The kernel and its library yardstick in turns (device times of
    the whole call, medians of 5 rounds) into row's ms and library_ms."""
    ts = {"kernel": [], "library": []}
    for _ in range(5):
        ts["kernel"].append(device_ms(r["fn"]) or cuda_ms(r["fn"]))
        ts["library"].append(device_ms(r["library"])
                             or cuda_ms(r["library"]))
    med = {k: statistics.median(v) for k, v in ts.items()}
    row.update(ms=med["kernel"], library_ms=med["library"])
    log(f"phase 4: in turns (medians of 5): {name} {med['kernel']:.6f} "
        f"ms, library {med['library']:.6f} ms "
        f"({med['library'] / med['kernel']:.2f}x), bound "
        f"{row['bound_ms']:.6f} ms ({med['kernel'] / row['bound_ms']:.1f}"
        f"x); rounds { {k: [round(t, 6) for t in v] for k, v in ts.items()} }")


def from_native(buf: bytes, bps: int, ch: int, n: int) -> np.ndarray:
    """Interleaved little-endian bps-byte samples → channel-major int32."""
    b = np.frombuffer(buf, np.uint8).reshape(n, ch, bps).astype(np.uint32)
    v = sum(b[..., k] << np.uint32(8 * k) for k in range(bps))
    top = np.uint32(1 << (8 * bps - 1))
    v = ((v ^ top) - top) if bps < 4 else v     # sign-extend
    return np.ascontiguousarray(v.astype(np.uint32).view(np.int32).T)


class CountCalls:
    """Within a with block, module attributes replaced by wrappers that
    count their calls (``calls``)."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.calls = dict.fromkeys(names, 0)

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, f in self.saved.items():
            def counted(*a, _n=n, _f=f, **kw):
                self.calls[_n] += 1
                return _f(*a, **kw)
            setattr(self.module, n, counted)
        return self

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(self.module, n, f)


class RecordAssoc:
    """Within a with block, ck.iir_assoc replaced by a wrapper that keeps
    each call's inputs and output (``calls``: (args, y), cloned). The
    wrapper carries the launch count: iir_assoc counts its launches on
    the module's name, which is then the wrapper's."""

    def __init__(self, ck):
        self.ck, self.calls = ck, []

    def __enter__(self):
        self.kernel = kernel = self.ck.iir_assoc

        def record(*a):
            y = kernel(*a)
            self.calls.append(([v.clone() if torch.is_tensor(v) else v
                                for v in a], y.clone()))
            return y
        record.launches = kernel.launches
        self.ck.iir_assoc = record
        return self

    def __exit__(self, *exc):
        self.kernel.launches = self.ck.iir_assoc.launches
        self.ck.iir_assoc = self.kernel


def check_dct_path(packers, ck, edges, sig, native, ch, dev, n4=4096):
    """Phase 14: the DCT path at BASELINE config 4, the main signal cut
    to its first n4 samples (as bench.py:263-265 cuts the real ECG), at
    bps 4 and, shifted down into 24 bits, bps 3. dct_forward and
    dct_inverse bit-exact against their plain versions on the card
    tests' dct_edge_batch; then, with every launch count at 0, compress,
    host decompress, decompress(device_decode=True) and decompress_many
    of 3 through the entry points, each equal to the device="cpu"
    packer's, one dct_forward a compress and one dct_inverse a
    decompress, the plain versions never called. Returns what phase 4
    times."""
    from rspt_tpu_torch.utils import metrics
    rng14 = np.random.default_rng(14)
    for case in edges.DCT_EDGE_CASES:
        x14 = edges.dct_edge_batch(rng14, case)
        r14 = edges.check_dct_case(x14, dev)
        if (case in edges.DCT_OVERFLOW
                and bool((r14 == -2 ** 31).any()) != edges.DCT_OVERFLOW[case]):
            raise AssertionError(f"dct_inverse {case}: INT32_MIN not as x86")
    torch.cuda.synchronize()
    log(f"phase 14: dct_forward and dct_inverse bit-exact against their "
        f"plain versions at {list(edges.DCT_EDGE_CASES)}; INT32_MIN as x86 "
        f"gives it on {[c for c, v in edges.DCT_OVERFLOW.items() if v]}; "
        f"{ck._lib().rspt_dct_ctas(ch, n4)} CTAs of 128 threads (4 "
        f"channels x 32 outputs) at {ch} x {n4}")
    sig4 = np.ascontiguousarray(sig[:, :n4])
    out = {}
    for bps in (4, 3):
        nat = native[:n4 * ch * 4] if bps == 4 else to_native(sig4 >> 8, 3)
        pd = packers.new_dct(bps, ch, n4)
        pdd = packers.new_dct(bps, ch, n4, device_decode=True)
        for k in ck.KERNELS:
            k.launches = 0
        with CountCalls(ck, ("dct_forward_plain",
                             "dct_inverse_plain")) as plain:
            comp = pd.compress(nat)
            torch.cuda.synchronize()
            fwd_c = ck.dct_forward.launches
            rec = pd.decompress(comp)[0]
            inv_d = ck.dct_inverse.launches
            rec_dd = pdd.decompress(comp)[0]
            rec_many = pdd.decompress_many([comp] * 3)
            torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in ck.KERNELS}
        log(f"phase 14: DCT bps {bps} path launches {launches}; plain "
            f"versions called {plain.calls}")
        if (fwd_c, inv_d, launches["dct_forward"],
                launches["dct_inverse"]) != (1, 1, 1, 5):
            raise AssertionError("dct: not one dct_forward a compress and "
                                 f"one dct_inverse a decompress ({launches})")
        missing = [k for k in ("tokenize_planes", "compact_tokens",
                               "pack_flat", "hzr_decode", "place_literals")
                   if not launches[k]]
        if missing or any(plain.calls.values()):
            raise AssertionError(f"dct: missing {missing}, plain "
                                 f"{plain.calls}")
        dct_names = ("dct_forward_kernel", "dct_inverse_kernel")
        # 3 calls: a trace may lose the first kernels of its first call
        names = device_op_names(lambda: pd.decompress(pd.compress(nat)),
                                reps=3)
        ran = [k for k in dct_names if any(k in o for o in names)]
        log(f"phase 14: the profiler's device operations of a compress and "
            f"a decompress: {len(names)} kinds, the DCT kernels among them "
            f"{[o for o in names if 'dct_' in o]}")
        if len(ran) != 2:
            raise AssertionError(f"dct: the profiler saw only {ran}")
        cpu = packers.new_dct(bps, ch, n4, device="cpu")
        if comp != cpu.compress(nat):
            raise AssertionError(f"dct bps {bps}: card and CPU containers "
                                 "differ")
        want = cpu.decompress(comp)[0]
        if not rec == rec_dd == want or rec_many != [want] * 3:
            raise AssertionError(f"dct bps {bps}: decompress differs from "
                                 "the CPU's")
        orig = from_native(nat, bps, ch, n4)
        dec = from_native(rec, bps, ch, n4)
        cr = metrics.compression_ratio(len(nat), len(comp))
        prd = metrics.prdn(orig, dec)
        if not (np.isfinite(prd) and prd > 0 and cr > 1):
            raise AssertionError(f"dct bps {bps}: CR {cr}, PRDN {prd}")
        log(f"phase 14: DCT bps {bps}: {len(nat)} B -> {len(comp)} B (CR "
            f"{cr:.4f}), PRDN {prd:.6f}%, container equal to the CPU's, "
            f"decompress on the host, with device_decode and "
            f"decompress_many of 3 equal to the CPU's; "
            f"{pdd.decode_info['device_blocks']} device blocks")
        out[bps] = dict(packer=pd, packer_dd=pdd, native=nat, comp=comp,
                        launches=launches)
    return out


def time_dct(ck, dct_path):
    """Phase 4's DCT part: D1 and D2 at config 4 (12 x 4,096) beside
    their bound, plain versions and an f64 torch.matmul over the same
    operands (not exact: another summation order), in turns; the DCT
    walls (medians of 3 [min, max], with the stages of the last call).
    Returns the two kernels JSON lines."""
    # the DCT pair at config 4 (12 x 4,096): the centred signal its
    # compress gives dct_forward and the coefficients its decompress
    # gives dct_inverse; the bound is the table read once, or the f64
    # adds, or the f32 -> f64 conversions of the ch * n * n products
    pd4 = dct_path[4]["packer"]
    cen4 = pd4._centred(dct_path[4]["native"])[0]
    coef4 = ck.dct_forward(cen4, pd4._cos, pd4._fwd_scale)
    ch4, n4 = cen4.shape
    terms4 = ch4 * n4 * n4
    ops_ms4 = max(terms4 / F64_ADDS_PER_S, terms4 / F2F_PER_S) * 1e3
    # the library yardstick, f64 torch.matmul over the same operands (not
    # exact: another summation order)
    cen4_64, cos4_64 = cen4.double(), pd4._cos.double()
    q4_64 = (pd4._cs * coef4.float()).double()
    cos4t_64 = pd4._cos_t.double()
    launches = {k: dct_path[4]["launches"][k]
                for k in ("dct_forward", "dct_inverse")}
    rows = {}
    rows["dct_forward"] = dict(
        replaces="rspt_tpu/native/rspt_native.cpp:1274",
        source="rspt_tpu_torch/ops/csrc/dct.cu",
        fn=lambda: ck.dct_forward(cen4, pd4._cos, pd4._fwd_scale),
        plain=lambda: ck.dct_forward_plain(cen4, pd4._cos, pd4._fwd_scale),
        plain_reps=2,
        library=lambda: torch.matmul(cen4_64, cos4_64),
        # table, signal and factors read once, coefficients written once
        bytes=4 * n4 * n4 + 2 * 4 * ch4 * n4 + 8 * n4, ops_ms=ops_ms4)
    rows["dct_inverse"] = dict(
        replaces="rspt_tpu/native/rspt_native.cpp:1290",
        source="rspt_tpu_torch/ops/csrc/dct.cu",
        fn=lambda: ck.dct_inverse(coef4, pd4._cos_t, pd4._cs,
                                  pd4._inv_scale),
        plain=lambda: ck.dct_inverse_plain(coef4, pd4._cos_t, pd4._cs,
                                           pd4._inv_scale),
        plain_reps=2,
        library=lambda: torch.matmul(q4_64, cos4t_64),
        bytes=4 * n4 * n4 + 2 * 4 * ch4 * n4 + 4 * n4, ops_ms=ops_ms4)
    log(f"phase 4: dct pair at {ch4} x {n4}: {terms4} products, f64 adds "
        f"{terms4 / F64_ADDS_PER_S * 1e3:.6f} ms, f32 -> f64 conversions "
        f"{terms4 / F2F_PER_S * 1e3:.6f} ms, table "
        f"{4 * n4 * n4 / HBM_BYTES_PER_S * 1e3:.6f} ms; "
        f"{ck._lib().rspt_dct_ctas(ch4, n4)} CTAs")
    # the DCT path at config 4: walls, medians of 3 [min, max], with the
    # stages of the last call
    for bps, d in dct_path.items():
        dc = wall_times(lambda: d["packer"].compress(d["native"]))
        dc_st = dict(d["packer"].stage_seconds)
        dd = wall_times(lambda: d["packer"].decompress(d["comp"]))
        dd_st = dict(d["packer"].stage_seconds)
        ddd = wall_times(lambda: d["packer_dd"].decompress(d["comp"]))
        ddd_st = dict(d["packer_dd"].stage_seconds)
        log(f"phase 4: DCT bps {bps} compress {spread(dc)} s {dc_st}; "
            f"decompress {spread(dd)} s {dd_st}; device-decode decompress "
            f"{spread(ddd)} s {ddd_st}")
    kernels = []
    for name in ("dct_forward", "dct_inverse"):
        kernels.append(measure_row(name, rows[name], launches))
        measure_in_turns(name, rows[name], kernels[-1])
    return kernels


def events_ms(fn, n=40, rounds=5):
    """Device time of one call of fn from CUDA events around n calls that
    run back to back: a sleep kernel holds the card while the host queues
    them, so no launch gap of the host's is counted. The median of rounds
    rounds, and the rounds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)        # ~10 ms at 1.98 GHz
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times), times


STREAM_NS = 4096     # samples a block at BASELINE config 5 (bench.py:206)
STREAM_FS = 1000.0


def stream_config(bps, ch):
    """BASELINE config 5 (bench.py:201-213): blocks of 4,096 samples,
    3 planes, the order-2 Butterworth band-pass 0.4-200 Hz at 1 kHz."""
    from rspt_tpu_torch.filters import design
    from rspt_tpu_torch.pipeline import StreamConfig
    b, a = design.create_filter_iir(design.FilterKind.BUTTERWORTH,
                                    design.FilterType.BAND_PASS, 2,
                                    STREAM_FS, 0.4, 200.0)
    return StreamConfig(bps, ch, STREAM_NS, sampling_rate=STREAM_FS,
                        nr_bytes_to_encode=3, filter_coeffs=(a, b))


def check_stream_path(ck, edges, sig, native, ch, dev):
    """Phase 15: the streaming path at BASELINE config 5. K1's batched
    form (xdelta_swizzle_batch) and K2's 2-D form (tokenize_planes) bit-
    exact against their plain versions on tests/test_torch_cuda.py's
    batch cases and at config 5's shape (8 x 12 x 4,096 at bps 4 and 3);
    then, with every launch count at 0, one push of the main signal's
    1,641,552 B into a fresh StreamingCodec on the card: 8 frames, one
    compress_many of one level, so one xdelta_swizzle_batch, one
    tokenize_planes, and one compact_tokens and one pack_flat for each of
    the 2 waves; no plain version called; the frames equal the
    device="cpu" codec's; the host and the device decoder give back the
    filtered signal. Returns what phase 4 times."""
    from rspt_tpu_torch import pipeline
    from rspt_tpu_torch.filters import streaming
    from rspt_tpu_torch.hzr import torch_coder as tc
    for case in edges.XDELTA_BATCH_CASES:
        edges.check_xdelta_batch_case(dev, *case)
    for case in edges.TOKENIZE_BATCH_CASES:
        edges.check_tokenize_batch_case(dev, *case)
    nblk = 8
    per = STREAM_NS * ch
    inputs = {}
    for bps in (4, 3):
        nat = native if bps == 4 else to_native(sig, 3)
        flat = np.frombuffer(nat, np.uint8)[:nblk * per * bps]
        x = torch.from_numpy((flat.view("<i4") if bps == 4 else flat).copy())
        x = x.reshape(nblk, -1).to(dev)
        enc, ok = ck.xdelta_swizzle_batch(x, STREAM_NS, ch, 3, bps)
        equal(f"xdelta_swizzle_batch bps {bps}", (enc, ok),
              ck.xdelta_swizzle_batch_plain(x, STREAM_NS, ch, 3, bps))
        equal(f"tokenize_planes 2-D bps {bps}", ck.tokenize_planes(enc, 3),
              ck.tokenize_planes_plain(enc, 3))
        inputs[bps] = (x, enc)
    torch.cuda.synchronize()
    log(f"phase 15: xdelta_swizzle_batch and the 2-D tokenize_planes bit-"
        f"exact against their plain versions on {edges.XDELTA_BATCH_CASES} "
        f"/ {edges.TOKENIZE_BATCH_CASES} and at config 5's {nblk} x {ch} x "
        f"{STREAM_NS} (bps 4 and 3); K1 tiles of "
        f"{ck._lib().rspt_xdelta_tile_batch(STREAM_NS, ch, nblk)} samples, "
        f"{nblk * -(-STREAM_NS // ck._lib().rspt_xdelta_tile_batch(STREAM_NS, ch, nblk))} CTAs")

    cfg = stream_config(4, ch)
    codec = pipeline.StreamingCodec(cfg)
    seen = {}
    real_many = codec.packer.compress_many

    def many(blocks):
        seen["blocks"] = [bytes(b) for b in blocks]
        return real_many(blocks)

    codec.packer.compress_many = many
    plains = [n for n in dir(ck) if n.endswith("_plain")]
    for k in ck.KERNELS:
        k.launches = 0
    with CountCalls(ck, plains) as plain, \
            CountCalls(streaming.IirFilter, ("filter", "filter_opt")) as loops, \
            CountCalls(tc, ("host_tables_plain",)) as tables:
        t0 = time.perf_counter()
        frames = codec.push(native)
        cold_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ck.KERNELS}
    called = {**plain.calls, **loops.calls, **tables.calls}
    log(f"phase 15: config 5 push launches "
        f"{ {k: v for k, v in launches.items() if v} }; plain versions "
        f"called { {k: v for k, v in called.items() if v} }")
    want = {"xdelta_swizzle_batch": 1, "tokenize_planes": 1,
            "compact_tokens": 2, "pack_flat": 2}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"stream: launches {launches}, want {want}")
    if any(called.values()):
        raise AssertionError(f"stream: plain versions called {called}")
    codec.packer.compress_many = real_many
    rest = len(native) - nblk * per * 4
    if (len(frames) != nblk or codec.packer.nr_planes != 3
            or len(codec._ring) != rest):
        raise AssertionError(f"stream: {len(frames)} frames, planes "
                             f"{codec.packer.nr_planes}, ring "
                             f"{len(codec._ring)}")
    cpu = pipeline.StreamingCodec(cfg, device="cpu")
    frames_cpu = cpu.push(native)
    if frames != frames_cpu:
        raise AssertionError("stream: card and CPU frames differ")
    # the filtered signal, channel by channel through the runtime's IIR
    want_sig = np.empty((ch, nblk * STREAM_NS), np.int32)
    for j in range(ch):
        f = streaming.IirFilter(*cfg.filter_coeffs)
        f.init_history_values(float(sig[j, 0]), int(STREAM_FS))
        want_sig[j] = f.process(sig[j, :nblk * STREAM_NS].astype(
            np.float64)).astype(np.int32)
    decs = {dd: pipeline.StreamingDecoder(cfg, device_decode=dd)
            for dd in (False, True)}
    for dd, dec in decs.items():
        out = b"".join(dec.push(f) for f in frames)
        got = from_native(out, 4, ch, nblk * STREAM_NS)
        if not np.array_equal(got, want_sig):
            raise AssertionError(f"stream: decode (device_decode={dd}) is "
                                 "not the filtered signal")
    sizes = [len(f) for f in frames]
    log(f"phase 15: one push of {len(native)} B (cold {cold_s:.4f} s, "
        f"stages {codec.stage_seconds}): {nblk} frames of {per * 4} B at "
        f"{min(sizes)}-{max(sizes)} B, {codec.packer.nr_planes} planes, "
        f"{len(codec._ring)} B left in the ring; frames equal the CPU "
        f"codec's; host and device decoders give back the filtered signal")
    return dict(inputs=inputs, launches=launches, blocks=seen["blocks"],
                frames=frames, cfg=cfg, decoders=decs)


def time_stream(ck, stream, native, ch, dev):
    """Phase 4's streaming part: K1's batched form and K2's 2-D form at
    config 5's shape, device times from CUDA events (back-to-back calls)
    beside 8 single-payload calls of each, in turns, their bounds and
    plain versions; then the walls, medians of 5 [min, max] with the
    rounds: compress_many of the 8 config-5 payloads against 8 sequential
    compress calls in turns, the codec's cold and steady pushes of the
    whole signal, and a decoder push a frame (host and device decode).
    Returns the two kernels JSON lines."""
    from rspt_tpu_torch import packers, pipeline
    nblk = 8
    per = STREAM_NS * ch
    rows = []
    for bps in (4, 3):
        x, enc = stream["inputs"][bps]
        k1 = lambda: ck.xdelta_swizzle_batch(x, STREAM_NS, ch, 3, bps)
        k1s = lambda: [ck.xdelta_swizzle(x[b], STREAM_NS, ch, 3, bps)
                       for b in range(nblk)]
        k2 = lambda: ck.tokenize_planes(enc, 3)
        k2s = lambda: [ck.tokenize_planes(enc[b], 3) for b in range(nblk)]
        t = {k: [] for k in ("k1", "k1s", "k2", "k2s")}
        for _ in range(5):
            for k, f in (("k1", k1), ("k1s", k1s), ("k2", k2), ("k2s", k2s)):
                t[k].append(events_ms(f, n=40 if k in ("k1", "k2") else 5,
                                      rounds=1)[0])
        med = {k: statistics.median(v) for k, v in t.items()}
        in_b = nblk * per * bps
        k1_bytes = in_b + 4 * nblk * per + 4 * nblk
        nb = 3 * nblk
        k2_bytes = 4 * nblk * per + nb * 4 * (65536 + 16384 + 261)
        log(f"phase 4: config 5 bps {bps} in turns (CUDA events, medians of "
            f"5): xdelta_swizzle_batch {med['k1']:.6f} ms against 8 "
            f"xdelta_swizzle calls {med['k1s']:.6f} ms (bound "
            f"{k1_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms, {k1_bytes} B); "
            f"tokenize_planes 2-D {med['k2']:.6f} ms against 8 1-D calls "
            f"{med['k2s']:.6f} ms (bound {k2_bytes / HBM_BYTES_PER_S * 1e3:.6f} "
            f"ms, {k2_bytes} B); rounds "
            f"{ {k: [round(v, 6) for v in vs] for k, vs in t.items()} }")
        if bps != 4:
            continue
        for name, ms, nbytes, plain, src, rep, launches in (
                ("xdelta_swizzle_batch", med["k1"], k1_bytes,
                 lambda: ck.xdelta_swizzle_batch_plain(x, STREAM_NS, ch, 3,
                                                       4),
                 "xdelta.cu", "rspt_tpu/ops/pallas_kernels.py:1615",
                 stream["launches"]["xdelta_swizzle_batch"]),
                ("tokenize_planes_batch", med["k2"], k2_bytes,
                 lambda: ck.tokenize_planes_plain(enc, 3), "tokenize.cu",
                 "rspt_tpu/ops/pallas_kernels.py:1813",
                 stream["launches"]["tokenize_planes"])):
            plain_ms = cuda_ms(plain, reps=3, warm=1)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append(dict(
                name=name, route="cuda",
                source=f"rspt_tpu_torch/ops/csrc/{src}", replaces=rep,
                launches=launches, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=t_bytes, bound_by="bytes", library_ms=None))
    # walls: compress_many against 8 sequential compress calls, in turns
    blocks = stream["blocks"]
    pm = packers.new_xdelta_hzr(4, ch, STREAM_NS, 3)
    ps = packers.new_xdelta_hzr(4, ch, STREAM_NS, 3)
    pm.compress_many(blocks)
    [ps.compress(b) for b in blocks]
    many_t, seq_t = [], []
    for _ in range(5):
        many_t += wall_times(lambda: pm.compress_many(blocks), 1)
        seq_t += wall_times(lambda: [ps.compress(b) for b in blocks], 1)
    many_st, seq_st = dict(pm.stage_seconds), dict(ps.stage_seconds)
    log(f"phase 4: config 5 compress_many of {nblk} payloads {spread(many_t)}"
        f" s (stages of the last {many_st}) against {nblk} compress calls "
        f"{spread(seq_t)} s (stages of the last call {seq_st}), in turns; "
        f"rounds {[round(v, 6) for v in many_t]} / "
        f"{[round(v, 6) for v in seq_t]}")
    # the codec: 5 cold pushes (fresh codecs), then 5 steady pushes
    cold, cold_st = [], []
    for _ in range(5):
        c = pipeline.StreamingCodec(stream["cfg"])
        cold += wall_times(lambda: c.push(native), 1)
        cold_st.append(dict(c.stage_seconds))
    steady, steady_st, nframes = [], [], []
    for _ in range(5):
        out = []
        steady += wall_times(lambda: out.extend(c.push(native)), 1)
        steady_st.append(dict(c.stage_seconds))
        nframes.append(len(out))
    mb = len(native) / 1e6
    log(f"phase 4: config 5 push of {len(native)} B: cold {spread(cold)} s "
        f"({mb / statistics.median(cold):.1f} MB/s), steady {spread(steady)}"
        f" s ({mb / statistics.median(steady):.1f} MB/s; frames a push "
        f"{nframes}); rounds {[round(v, 6) for v in cold]} / "
        f"{[round(v, 6) for v in steady]}; stages cold {cold_st}; steady "
        f"{steady_st}")
    for dd, dec in stream["decoders"].items():
        per_frame = []
        for _ in range(5):
            per_frame.append(statistics.median(wall_times(
                lambda f=f: dec.push(f), 1)[0] for f in stream["frames"]))
        log(f"phase 4: StreamingDecoder.push a frame (device_decode={dd}) "
            f"{spread(per_frame)} s (median over the {nblk} frames, 5 "
            f"rounds); stages of the last {dec.packer.stage_seconds}")
    return rows


SIG_SR = 360.0           # the MIT-BIH rate of tests/test_jax_analysis.py
SIG_NS = 1 << 20         # 48.5 minutes a channel: 12 x 1,048,576 float32
DET_CUT = (2, 120000)    # the detectors against the host detectors
MEDIAN_NS = 1000000      # the reference's test_8 (rspt_test.cpp:327-395)
MEDIAN_WINDOWS = (5, 6, 7, 1500)
FIR_TAPS = 61
# S1, S4 and S2's carry each run a serial chain on one lane, so their
# design is bounded by its steps x the cycles of one step's dependent
# chain; an estimate from the source (not
# from SASS), at 4 cycles a dependent float or integer operation (the
# microbenchmarked latency of the FMA and ALU pipes since Volta)
DEP_LAT = 4
CLOCK_HZ = 1.98e9
# H100 SXM float32 outside the tensor cores: 67e12 FLOP/s counts an FMA as
# two; S1-S4 run separate multiplies and adds, one instruction each
F32_INSTR_PER_S = 33.5e12


def held(edges, name, got, want):
    """got equal to want (edges.same_floats: tolerance 0, a NaN equal to a
    NaN), compared on the CPU; returns the measured max |got - want| over
    the values that are not NaN in both."""
    g, w = got.cpu(), want.cpu()
    try:
        edges.same_floats(g, w)
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None
    if not g.numel():
        return 0.0
    return float(torch.nan_to_num((g.double() - w.double()).abs(),
                                  nan=0.0).max())


def signal_designs():
    """The batch detectors' filters at 360 Hz, as (b, a): detect_batch's
    band-pass (order 4 digital, p = 5) and its threshold low-pass (p =
    3), and a 61-tap Hamming-windowed sinc low-pass at 40 Hz for the FIR."""
    from rspt_tpu_torch.analysis import torch_peaks
    bp, _, th = torch_peaks._coeffs(SIG_SR)
    k = np.arange(FIR_TAPS) - (FIR_TAPS - 1) / 2
    taps = np.sinc(2 * 40.0 / SIG_SR * k) * np.hamming(FIR_TAPS)
    return bp, th, taps / taps.sum()


def check_signal_path(ck, edges, dev):
    """Phase 16: the batch signal ops (S1 iir_scan, S2 iir_assoc, S3
    fir_apply, S4 peak_gate). Each kernel against its plain version on the
    card tests' edge cases; at full width (12 x 1,048,576 float32 of
    make_ecg at 360 Hz) each bit for bit against its plain version: S2
    (the band-pass from its warm-up state in float32 and float64, and each
    of the 9 calls the two detectors make, at M = 4, 2 and 1, with
    detect_batch's M = 2 integrator also in float64) and S3 on the card,
    S1 in
    float32 and float64 and S4 (on detect_batch's signal and threshold)
    on CPU copies (their plain versions take a step of torch ops a
    sample), S1 in float64 also equal to the host runtime's
    iir_filter_channels(opt=1), S4 on the offline detector's gate equal
    to its own serial schedule (chunk = T); S4's re-runs on both gates
    logged. Then, with every launch count at
    0, detect_batch and detect_offline_batch at full width: exact launch
    counts, no plain version called; both on 2 channels cut to 120,000
    samples against the host detectors (equal counts and positions within
    +-3 of PeakDetector's; indexes equal to PeakDetectorOffline's); the
    rolling medians at test_8's windows on 1,000,000 samples equal to
    RollingWindowMedian. Returns what phase 4 times."""
    from rspt_tpu_torch.analysis import peaks, torch_peaks
    from rspt_tpu_torch.analysis.rolling_median import (
        rolling_median, torch_rolling_median, torch_rolling_median_large)
    from rspt_tpu_torch.filters import torch_filters as tf
    from rspt_tpu_torch.native import bindings as rt
    t0 = time.perf_counter()
    for case in edges.IIR_EDGE_CASES:
        edges.check_iir_case(dev, *case)
    for case in edges.FIR_EDGE_CASES:
        edges.check_fir_case(dev, *case)
    for case in edges.GATE_EDGE_CASES:
        edges.check_gate_expectations(case, *edges.check_gate_case(dev,
                                                                   *case))
    torch.cuda.synchronize()
    log(f"phase 16: iir_scan, iir_assoc, fir_apply, peak_gate equal to "
        f"their plain versions on {edges.IIR_EDGE_CASES}, "
        f"{edges.FIR_EDGE_CASES}, {edges.GATE_EDGE_CASES} "
        f"({time.perf_counter() - t0:.1f} s)")

    ch = 12
    sig, _ = make_ecg(ch, SIG_NS)
    x = torch.from_numpy(sig.astype(np.float32)).to(dev)
    (bp_b, bp_a), (th_b, th_a), taps = signal_designs()
    m_bp, m_th = len(bp_a) - 1, len(th_a) - 1
    xz, yz = tf.iir_warmup_state(x[:, 0], bp_a, bp_b, 4 * int(SIG_SR),
                                 device=dev)
    args = {
        "iir_assoc": (x, bp_a, bp_b, xz, yz.contiguous(), tf.IIR_TILE),
        "iir_scan": (x, th_a, th_b, x.new_zeros((ch, m_th)),
                     x.new_zeros((ch, m_th))),
        "fir_apply": (x, torch.from_numpy(taps.astype(np.float32)).to(dev),
                      None),
    }
    err, plain_s = {}, {}
    err["iir_assoc"] = held(edges, "iir_assoc full width",
                            ck.iir_assoc(*args["iir_assoc"]),
                            ck.iir_assoc_plain(*args["iir_assoc"]))
    a64 = [v.double() if torch.is_tensor(v) else v
           for v in args["iir_assoc"]]
    err["iir_assoc"] = max(err["iir_assoc"], held(
        edges, "iir_assoc float64 full width", ck.iir_assoc(*a64),
        ck.iir_assoc_plain(*a64)))
    err["fir_apply"] = held(edges, "fir_apply full width",
                            ck.fir_apply(*args["fir_apply"]),
                            ck.fir_apply_plain(*args["fir_apply"]))

    def on_cpu(fn, call):
        # a serial plain version (a step of torch ops a sample) on CPU
        # copies of the inputs; its wall, synchronous, in ms
        cpu = [v.cpu() if torch.is_tensor(v) else v for v in call]
        t1 = time.perf_counter()
        out = fn(*cpu)
        return out, (time.perf_counter() - t1) * 1e3

    want, plain_s["iir_scan"] = on_cpu(ck.iir_scan_plain, args["iir_scan"])
    err["iir_scan"] = held(edges, "iir_scan float32 full width",
                           ck.iir_scan(*args["iir_scan"]), want)
    x64 = x.double()
    z64 = x64.new_zeros((ch, m_th))
    y64 = ck.iir_scan(x64, th_a, th_b, z64, z64)
    want, plain64_ms = on_cpu(ck.iir_scan_plain, (x64, th_a, th_b, z64, z64))
    err["iir_scan"] = max(err["iir_scan"], held(
        edges, "iir_scan float64 full width", y64, want))
    st = np.zeros((ch, m_th + 1))
    host = rt.iir_filter_channels(x64.cpu().numpy(), th_a, th_b, st,
                                  st.copy(), 1)
    held(edges, "iir_scan float64 vs the host runtime", y64,
         torch.from_numpy(host))
    # the gate on detect_batch's own signal and threshold at full width
    nr_slope = int(100.0 * SIG_SR / 1000.0)
    with RecordAssoc(ck) as rec:
        _, sg, th = torch_peaks.detect_batch(x, SIG_SR)
        _, filt, thr_o, _ = torch_peaks.offline_filters(x, SIG_SR)
    # every iir_assoc call of both detectors (M = p - 1: detect_batch's
    # band-pass, integrator and threshold, offline_filters' baseline,
    # band-pass and integrator forward and backward) bit for bit
    ms = [len(a[1]) - 1 for a, _ in rec.calls]
    if ms != [4, 2, 2, 1, 1, 2, 2, 1, 1]:
        raise AssertionError(f"the detectors' iir_assoc orders: {ms}")
    for i, (a, y) in enumerate(rec.calls):
        err["iir_assoc"] = max(err["iir_assoc"], held(
            edges, f"iir_assoc detectors' call {i} (M = {ms[i]})", y,
            ck.iir_assoc_plain(*a)))
    # detect_batch's integrator low-pass (M = 2) in float64
    b64 = [v.double() if torch.is_tensor(v) else v for v in rec.calls[1][0]]
    err["iir_assoc"] = max(err["iir_assoc"], held(
        edges, "iir_assoc float64 M = 2 full width", ck.iir_assoc(*b64),
        ck.iir_assoc_plain(*b64)))
    del rec, b64
    gate = (sg, th, nr_slope, 1.0 / (1.0 + 25.0 / SIG_SR), 1.0)
    want, plain_s["peak_gate"] = on_cpu(ck.peak_gate_plain, gate)
    got = ck.peak_gate(*gate)
    reruns = {"detect_batch": ck.peak_gate.last_reruns.sum(0).tolist()}
    err["peak_gate"] = held(edges, "peak_gate full width", got, want)
    # the offline gate (attenuation 70) on offline_filters' signal and
    # threshold, against the kernel's serial schedule (one chunk a row)
    gate_o = (filt.contiguous(), thr_o.contiguous(), nr_slope,
              1.0 / (1.0 + 70.0 / SIG_SR), 1.0)
    got = ck.peak_gate(*gate_o)
    reruns["offline"] = ck.peak_gate.last_reruns.sum(0).tolist()
    serial = ck.peak_gate(*gate_o, chunk=SIG_NS)
    if ck.peak_gate.last_reruns.any():
        raise AssertionError("peak_gate's serial schedule re-ran chunks")
    err["peak_gate"] = max(err["peak_gate"], held(
        edges, "peak_gate offline full width vs its serial schedule", got,
        serial))
    chunk, warm, _ = ck.gate_schedule()
    nk = ch * (-(-SIG_NS // chunk) - 1)      # chunks the repair checks
    torch.cuda.synchronize()
    log(f"phase 16: peak_gate's re-runs at the default schedule (chunks of "
        f"{chunk}, warm-up {warm}) on the full-width gates: " + "; ".join(
            f"{k} {c} of {nk} chunks ({100.0 * c / nk:.3f}%), {n} samples"
            for k, (c, n) in reruns.items()))
    log(f"phase 16: at full width ({ch} x {SIG_NS}): iir_assoc ({len(bp_a)} "
        f"coefficients, tiles of {tf.IIR_TILE}) in float32 and float64, "
        f"the detectors' 9 iir_assoc calls (M {ms}; the second, M = 2, "
        f"also in float64) and fir_apply "
        f"({FIR_TAPS} taps) equal to their plain versions; iir_scan ({len(th_a)} "
        f"coefficients) in float32 and float64 and peak_gate (on "
        f"detect_batch's signal and threshold) equal to their plain "
        f"versions on the CPU (iir_scan {plain_s['iir_scan'] / 1e3:.1f} s / "
        f"{plain64_ms / 1e3:.1f} s, peak_gate "
        f"{plain_s['peak_gate'] / 1e3:.1f} s), iir_scan float64 to the host "
        f"runtime's iir_filter_channels(opt=1), peak_gate on the offline "
        f"gate to its serial schedule; max |err| {err}")

    # the entry points at full width: both detectors and the FIR
    plains = [n for n in dir(ck) if n.endswith("_plain")]
    runs, launches = {}, {}
    fir_taps = args["fir_apply"][1].cpu().numpy()
    for name, fn in (("detect_batch", lambda: torch_peaks.detect_batch(
                          x, SIG_SR)),
                     ("detect_offline_batch",
                      lambda: torch_peaks.detect_offline_batch(x, SIG_SR)),
                     ("fir_apply", lambda: tf.fir_apply(x, fir_taps))):
        for k in ck.KERNELS:
            k.launches = 0
        with CountCalls(ck, plains) as plain:
            runs[name] = fn()
            torch.cuda.synchronize()
        launches[name] = {k.__name__: k.launches for k in ck.KERNELS
                          if k.launches}
        if any(plain.calls.values()):
            raise AssertionError(f"{name}: plain versions called "
                                 f"{plain.calls}")
    want = {"detect_batch": {"iir_assoc": 3, "peak_gate": 1},
            "detect_offline_batch": {"iir_assoc": 6, "iir_scan": 2,
                                     "peak_gate": 1},
            "fir_apply": {"fir_apply": 1}}
    if launches != want:
        raise AssertionError(f"detectors: launches {launches}, want {want}")
    pk_b = runs["detect_batch"][0]
    pk_o = runs["detect_offline_batch"][0]
    counts_b = (pk_b != 0).sum(1).tolist()
    counts_o = (pk_o != 0).sum(1).tolist()
    if (pk_b.shape != x.shape or pk_o.shape != tuple(x.shape)
            or min(counts_b + counts_o) < SIG_NS // 400):
        raise AssertionError(f"detectors: shapes {pk_b.shape} {pk_o.shape},"
                             f" peaks {counts_b} {counts_o}")
    held(edges, "fir_apply entry point", runs["fir_apply"][0],
         ck.fir_apply(*args["fir_apply"]))
    log(f"phase 16: detect_batch, detect_offline_batch and fir_apply at "
        f"full width through the entry points: launches {launches}, no "
        f"plain version called; peaks a channel {counts_b} / {counts_o}")

    rows, ns = DET_CUT
    xc = x[:rows, :ns].contiguous()
    xc_np = xc.cpu().numpy().astype(np.float64)
    pkc = torch_peaks.detect_batch(xc, SIG_SR)[0].cpu().numpy()
    idx = torch_peaks.detect_offline_batch(xc, SIG_SR,
                                           return_indexes=True)[3]
    for r in range(rows):
        pd = peaks.PeakDetector(SIG_SR)
        host_pk = np.array([pd.detect(float(v))[0] for v in xc_np[r]])
        got, want_i = np.flatnonzero(pkc[r]), np.flatnonzero(host_pk)
        if len(got) != len(want_i) or np.abs(got - want_i).max() > 3:
            raise AssertionError(f"detect_batch row {r}: {len(got)} peaks "
                                 f"against the host's {len(want_i)}")
        want_o = peaks.PeakDetectorOffline(SIG_SR).detect(
            xc_np[r], return_indexes=True)[3]
        if not np.array_equal(idx[r], want_o):
            raise AssertionError(f"detect_offline_batch row {r}: indexes "
                                 f"differ from PeakDetectorOffline's")
    log(f"phase 16: on {rows} x {ns}: detect_batch's peaks "
        f"{[int((pkc[r] != 0).sum()) for r in range(rows)]} equal in count "
        f"to PeakDetector's, positions within +-3; detect_offline_batch's "
        f"indexes ({[len(i) for i in idx]}) equal PeakDetectorOffline's")

    rng = np.random.default_rng(1234)
    vals = np.concatenate([
        np.array([9, 1, 8, 2, 7, 3, 6, 4, 5, 5, 4, 6, 3, 7, 2, 8, 1, 9, 0,
                  10], np.float64),
        rng.normal(0, 100, MEDIAN_NS - 20)]).astype(np.float32)
    med_in = torch.from_numpy(vals).to(dev)
    for w in MEDIAN_WINDOWS:
        fn = torch_rolling_median_large if w > 1024 else torch_rolling_median
        got = fn(med_in, w)
        want_m = rolling_median(vals.astype(np.float64), w)
        held(edges, f"rolling median w={w}", got,
             torch.from_numpy(want_m.astype(np.float32)))
    log(f"phase 16: rolling medians of {MEDIAN_NS} samples at windows "
        f"{MEDIAN_WINDOWS} (torch_rolling_median, torch_rolling_median_large"
        f" at 1,500) equal RollingWindowMedian as float32")
    return dict(x=x, args=args, launches=launches, gate=gate, err=err,
                plain_ms=plain_s, med_in=med_in, reruns=reruns)


def time_signal(ck, sp):
    """Phase 4's batch-signal part: each kernel at its path's shape (12 x
    1,048,576 float32), device time from CUDA events around back-to-back
    calls (median of 5 rounds [min, max]), its launches on the detectors'
    path, its bound (and S1, S2 and S4's serial chain's; S2's three
    passes by the profiler), its plain version
    (CUDA events around a call; S1 and S4's the wall of phase 16's call on
    the CPU, at the same shape); S3 in turns with torch.nn.functional.conv1d at
    the same shape (cuDNN, TF32 off: not the same order of sums); then the
    walls of both detectors (detect_offline_batch's device part and host
    relocation apart) and of the two medians. Returns the kernels JSON
    lines."""
    from rspt_tpu_torch.analysis import torch_peaks
    from rspt_tpu_torch.analysis.rolling_median import (
        torch_rolling_median, torch_rolling_median_large)
    x = sp["x"]
    rows_n, T = x.shape
    n = rows_n * T
    (bp_b, bp_a), (th_b, th_a), _ = signal_designs()
    a = sp["args"]
    fir_x, taps = a["fir_apply"][0], a["fir_apply"][1]
    ks = taps.numel()
    w_conv = taps.flip(0).reshape(1, 1, ks)
    xpad = torch.nn.functional.pad(fir_x, (ks - 1, 0)).reshape(rows_n, 1, -1)

    def conv():
        return torch.nn.functional.conv1d(xpad, w_conv)

    m_th, m_bp = len(th_a) - 1, len(bp_a) - 1
    # each design's longest loop-carried chain, counted from the source:
    # from y[t-1] to y[t] a multiply and M subtractions, T steps a row (S1);
    # the count's select (accept / rising), its compare with 0, the
    # increment, the compare with nr_slope and the select of 0 (S4; prev_
    # amp's cycle, a multiply, a compare, accept and a select, is 4), warm
    # + chunk steps a thread (the speculation; the repair walk re-runs
    # little, its count is the row's "reruns")
    # (S2) its carry, nt steps a row of a multiply and M + 1 adds
    chunk, warm, _ = ck.gate_schedule()
    nt = -(-T // a["iir_assoc"][5])
    steps = {"iir_scan": (T, 1 + m_th), "peak_gate": (warm + chunk, 5),
             "iir_assoc": (nt, 2 + m_bp)}
    chain = {k: n_ * v * DEP_LAT / CLOCK_HZ * 1e3
             for k, (n_, v) in steps.items()}
    on_cpu = ("iir_scan", "peak_gate")   # plain versions timed on the CPU
    spec = {
        "iir_scan": dict(
            fn=lambda: ck.iir_scan(*a["iir_scan"]), n=3,
            bytes=8 * n, ops=n * (2 * (m_th + 1) + 2 * m_th),
            src="iir.cu", rep="rspt_tpu/filters/jax_filters.py:96"),
        "iir_assoc": dict(
            fn=lambda: ck.iir_assoc(*a["iir_assoc"]), n=20,
            plain=lambda: ck.iir_assoc_plain(*a["iir_assoc"]),
            bytes=8 * n, ops=n * (2 * (m_bp + 1) + 4 * m_bp + 1),
            src="iir.cu", rep="rspt_tpu/filters/jax_filters.py:109"),
        "fir_apply": dict(
            fn=lambda: ck.fir_apply(*a["fir_apply"]), n=20,
            plain=lambda: ck.fir_apply_plain(*a["fir_apply"]),
            bytes=8 * n + 4 * ks, ops=2 * ks * n,
            src="fir.cu", rep="rspt_tpu/filters/jax_filters.py:134"),
        "peak_gate": dict(
            fn=lambda: ck.peak_gate(*sp["gate"]), n=3,
            bytes=12 * n, ops=15 * n,
            src="peaks.cu", rep="rspt_tpu/analysis/jax_peaks.py:58"),
    }
    rows = []
    for name, r in spec.items():
        ts, lib_ts = [], []
        for _ in range(5):
            ts.append(events_ms(r["fn"], n=r["n"], rounds=1)[0])
            if name == "fir_apply":
                prev = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                lib_ts.append(events_ms(conv, n=20, rounds=1)[0])
                torch.backends.cudnn.allow_tf32 = prev
        ms = statistics.median(ts)
        # S1 and S4's plain versions: phase 16's wall on the CPU
        plain_ms = (sp["plain_ms"][name] if name in on_cpu
                    else cuda_ms(r["plain"], reps=1, warm=0))
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / F32_INSTR_PER_S * 1e3
        launches = sum(run.get(name, 0) for run in sp["launches"].values())
        row = dict(name=name, route="cuda",
                   source=f"rspt_tpu_torch/ops/csrc/{r['src']}",
                   replaces=r["rep"], launches=launches,
                   max_abs_err=sp["err"][name], ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   library_ms=statistics.median(lib_ts) if lib_ts else None)
        if name in chain:    # the bound of the design's serial chain
            row["chain_ms"] = chain[name]
        if name == "peak_gate":   # chunks and samples re-run, summed
            row["reruns"] = sp["reruns"]
        rows.append(row)
        if name == "iir_assoc":      # its three passes, from the profiler
            parts = {k: device_ms(r["fn"], reps=10, kernel=k) for k in (
                "iir_ends_kernel", "iir_carry_kernel", "iir_final_kernel")}
            log(f"phase 4: iir_assoc's kernels (profiler, medians of 10 "
                f"calls): { {k: v and round(v, 6) for k, v in parts.items()} }")
        log(f"phase 4: {name} at {rows_n} x {T}: {ms:.6f} ms "
            f"[{min(ts):.6f}, {max(ts):.6f}] (CUDA events, medians of 5), "
            f"bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
            f"({r['bytes']} B, {r['ops']} operations)"
            + (f", the design's chain bound {chain[name]:.4f} ms "
               f"({steps[name][0]} steps x {steps[name][1]} dependent "
               f"operations x {DEP_LAT} cycles at {CLOCK_HZ / 1e9} GHz, an "
               f"estimate)" if name in chain else "")
            + f"; plain {plain_ms:.4f} ms"
            + (" (on the CPU)" if name in on_cpu else " (on the card)")
            + (f"; conv1d {row['library_ms']:.6f} ms [{min(lib_ts):.6f}, "
               f"{max(lib_ts):.6f}] in turns" if lib_ts else ""))
    # walls; detect_offline_batch's two parts apart: its device part
    # (offline_filters and the copies to the host) and the relocation
    radius = int(10.0 * SIG_SR / 1000.0)
    parts = {}

    def offline_device():
        moved, _, _, base = torch_peaks.offline_filters(x, SIG_SR)
        parts["host"] = (moved.cpu().numpy(),
                         x.cpu().numpy().astype(np.float64),
                         base.cpu().numpy().astype(np.float64))

    def offline_relocate():
        pk, ecg, base = (a.copy() for a in parts["host"])
        for r in range(rows_n):
            torch_peaks.relocate(pk[r], ecg[r], base[r], radius)

    for name, fn in (("detect_batch",
                      lambda: torch_peaks.detect_batch(x, SIG_SR)),
                     ("detect_offline_batch",
                      lambda: torch_peaks.detect_offline_batch(x, SIG_SR)),
                     ("detect_offline_batch device part", offline_device),
                     ("detect_offline_batch host relocation",
                      offline_relocate),
                     ("torch_rolling_median w=7",
                      lambda: torch_rolling_median(sp["med_in"], 7)),
                     ("torch_rolling_median_large w=1500",
                      lambda: torch_rolling_median_large(sp["med_in"],
                                                         1500))):
        ts = []
        for _ in range(5):
            ts += wall_times(fn, 1)
        log(f"phase 4: {name} wall {spread(ts)} s (5 calls); rounds "
            f"{[round(t, 6) for t in ts]}")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: sharding (rspt_tpu_torch.parallel)
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)     # shards on one card (a device may repeat)
GLOO_TIMEOUT_S = 180         # the two-process part, start to end
GLOO_PAYLOAD = 2 * 1024 * 1024   # tools/run_multihost.py's payload


def launched_by(ck, fn):
    """fn's result and the kernel launches of its run (every count set to
    0 just before, read just after)."""
    for k in ck.KERNELS:
        k.launches = 0
    r = fn()
    torch.cuda.synchronize()
    return r, {k.__name__: k.launches for k in ck.KERNELS if k.launches}


def shard_meshes(parallel, dev):
    """Meshes of 1, 2 and 4 shards on the card, and of every visible card
    when there is more than one."""
    meshes = {f"{k} x {dev}": parallel.make_mesh([dev] * k)
              for k in SHARD_COUNTS}
    if torch.cuda.device_count() > 1:
        meshes["every card"] = parallel.make_mesh()
    return meshes


def shards_holding(mask, nshards):
    """Shards whose contiguous run of a padded batch holds a True block."""
    loc = -(-len(mask) // nshards)
    return sum(bool(np.any(mask[g * loc:(g + 1) * loc]))
               for g in range(nshards))


def check_shard_path(ck, tc, gd, packers, tops, native, words, comp,
                     main_streams, s11, rnd, s_rnd, huff, ch, ns, dev):
    """Phase 17 (a): on each mesh, the main path's packer with the
    sharded encoder (the flat route: K3 + K4 on each shard holding a
    HUFF block; the container equal to the unsharded packer's, decoded
    exactly), the hzr packer on the 3 x 64 KiB random input (all COPY:
    the compact route, K13a on each shard), the stream encoder (K13a on
    each shard; out_capacity exact and one byte short), the sharded
    decoder of the main streams (K6 + K7 on each shard holding a block;
    equal to gpu_decoder.decode_many, hinted rerun too) and the scans
    over the main signal's words; a 4-shard hint is refused by a 2-shard
    decoder. Returns what the timings use."""
    from rspt_tpu_torch import parallel
    meshes = shard_meshes(parallel, dev)
    want_dec = gd.decode_many(main_streams, device=dev, hints=False)
    raw = np.frombuffer(rnd.tobytes(), np.uint8)
    p_rnd = packers.new_hzr(4, 1, raw.size // 4)
    c_rnd = p_rnd.compress(raw)
    host_words = words.cpu().numpy()
    out = {"meshes": meshes, "enc": {}, "dec": {}, "packer": {},
           "hints": {}}
    for name, mesh in meshes.items():
        S = mesh.size
        enc = parallel.ShardedHzrEncoder(mesh)
        p = packers.new_xdelta_hzr(4, ch, ns, 3, encoder=enc)
        c, got = launched_by(ck, lambda: p.compress(native))
        e = shards_holding(huff, S)
        want = {"xdelta_swizzle": 1, "tokenize_planes": 1,
                "compact_tokens": e, "pack_flat": e}
        if c != comp or got != want:
            raise AssertionError(f"{name}: sharded packer: container equal "
                                 f"{c == comp}, launches {got}, not {want}")
        if packers.new_xdelta_hzr(4, ch, ns, 3).decompress(c)[0] != native:
            raise AssertionError(f"{name}: sharded container: no round trip")
        pr = packers.new_hzr(4, 1, raw.size // 4, encoder=enc)
        cr, got_r = launched_by(ck, lambda: pr.compress(raw))
        if cr != c_rnd or got_r != {"tokenize_planes": 1,
                                    "pack_blocks": mesh.local}:
            raise AssertionError(f"{name}: random input: {got_r}, equal "
                                 f"{cr == c_rnd}")
        b, ln = tc.split_blocks(rnd)
        if enc.encode_blocks_flat(b, ln) is not None or tc.assemble_compact(
                *enc.encode_blocks_compact(b, ln)) != s_rnd:
            raise AssertionError(f"{name}: all-COPY batch: flat route taken "
                                 f"or compact route differs")
        s, got_s = launched_by(ck, lambda: enc.encode(native))
        if s != s11 or got_s != {"pack_blocks": mesh.local}:
            raise AssertionError(f"{name}: encode: equal {s == s11}, "
                                 f"launches {got_s}")
        if enc.encode(native, len(s11)) != s11:
            raise AssertionError(f"{name}: encode: exact out_capacity")
        try:
            enc.encode(native, len(s11) - 1)
            raise AssertionError(f"{name}: encode: one byte short fit")
        except ValueError:
            pass
        dec = parallel.ShardedHzrDecoder(mesh)
        (outs, h), got_d = launched_by(ck, lambda: dec.decode_many(
            main_streams, hints=False, return_hints=True))
        held = sum(1 for n in dec.decode_info["blocks"] if n)
        if outs != want_dec or got_d != {"hzr_decode": held,
                                         "place_literals": held}:
            raise AssertionError(f"{name}: decode: equal {outs == want_dec},"
                                 f" launches {got_d}")
        if (dec.decode_many(main_streams, hints=h) != want_dec
                or not dec.decode_info["hinted"]
                or any(f for fs in dec.decode_info["fp_iters"] for f in fs)):
            raise AssertionError(f"{name}: hinted decode {dec.decode_info}")
        fns = parallel.make_sharded_scans(mesh)
        parts = fns["shard"](host_words)
        for fn in ("delta_encode", "xor_encode", "delta_decode",
                   "xor_decode"):
            equal(f"{name}: sharded {fn}", fns["gather"](fns[fn](parts)),
                  getattr(tops, fn)(words).cpu())
        out["enc"][name], out["dec"][name] = enc, dec
        out["packer"][name], out["hints"][S] = p, h
        log(f"phase 17: {name} ({S} shards): packer container equal to the "
            f"unsharded one ({len(c)} B), flat route {got}; random 3 x 64 "
            f"KiB through new_hzr: compact route {got_r}; encode equal "
            f"({len(s)} B) {got_s}, out_capacity exact / one short raises; "
            f"decode equal, blocks a shard {dec.decode_info['blocks']}, "
            f"{got_d}, hinted rerun 0 sweeps; scans over "
            f"{host_words.size} words equal")
    d2 = out["dec"][f"2 x {dev}"]
    gd._hint_registry.clear()
    if (d2.decode_many(main_streams, hints=out["hints"][4]) != want_dec
            or d2.decode_info["hinted"]):
        raise AssertionError("a 4-shard hint was trusted by 2 shards")
    log("phase 17: a 4-shard decode's hint given to a 2-shard decoder is "
        "refused (the fixpoint ran), bytes equal")
    out["want_dec"] = want_dec
    return out


def kernel_counts(evs, reps):
    """Device operations of reps calls, a call: the port's kernels by
    name, then the rest (torch ops, copies, fills) together, then all."""
    ours, rest = {}, 0
    for e in evs:
        m = re.search(r"namespace\)::(\w+_kernel)\(", e.name)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0) + 1 / reps
        else:
            rest += 1
    return ours, rest / reps, len(evs) / reps


def time_shard_path(tc, gd, packers, native, main_streams, shard, ch, ns,
                    dev, smi):
    """Phase 17 (c) and (d): the profiler's device operations of a
    4-shard encode and decode, then the walls of the sharded encode,
    packer compress and decode against the unsharded calls, in turns,
    medians of 5 [min, max]."""
    four = f"4 x {dev}"
    enc4, dec4 = shard["enc"][four], shard["dec"][four]
    for what, fn in (("encode", lambda: enc4.encode(native)),
                     ("decode", lambda: dec4.decode_many(main_streams,
                                                         hints=False))):
        kern, rest, per = kernel_counts(_device_events(fn, 3), 3)
        log(f"phase 17 (c): 4-shard {what}: {per:.1f} device operations a "
            f"call (profiler, 3 calls): the port's kernels {kern}, "
            f"{rest:.1f} others (torch ops, copies, fills)")
    p = packers.new_xdelta_hzr(4, ch, ns, 3)
    calls = {"encode unsharded": lambda: tc.encode(native, device=dev),
             "compress unsharded": lambda: p.compress(native),
             "decode unsharded": lambda: gd.decode_many(
                 main_streams, device=dev, hints=False)}
    for name in shard["meshes"]:
        e, d, pk = (shard["enc"][name], shard["dec"][name],
                    shard["packer"][name])
        calls[f"encode {name}"] = lambda e=e: e.encode(native)
        calls[f"compress {name}"] = lambda pk=pk: pk.compress(native)
        calls[f"decode {name}"] = lambda d=d: d.decode_many(main_streams,
                                                            hints=False)
    for fn in calls.values():
        fn()
    times = {k: [] for k in calls}
    for _ in range(5):
        for k, fn in calls.items():
            times[k] += wall_times(fn, reps=1)
    for what in ("encode", "compress", "decode"):
        log(f"phase 17 (d): {what} walls on {smi}, s, medians of 5 [min, "
            f"max] in turns: " + "; ".join(
                f"{k[len(what) + 1:]} {spread(v)}" for k, v in times.items()
                if k.startswith(what)))
    log(f"phase 17 (d): stages of the last 4-shard encode "
        f"{enc4.stage_seconds}, decode {dec4.decode_info['times']}")
    return times


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_gloo_processes():
    """Phase 17 (b): this script as two gloo workers of 2 shards each on
    cuda:0 (4 shards): each encodes the same 2 MiB payload, equal on both
    ranks to torch_coder.encode, and runs the scans across the
    processes. A worker that fails or is not done within GLOO_TIMEOUT_S
    fails the run."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--gloo-worker",
         str(r), str(port)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    end = time.monotonic() + GLOO_TIMEOUT_S
    results = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=max(1.0, end - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"gloo worker rc {p.returncode}: "
                                     f"{so[-2000:]} {se[-4000:]}")
            results.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in results:
        if not (r["encode_equal"] and r["scans_equal"]
                and r["launches"].get("pack_blocks") == 2):
            raise AssertionError(f"gloo worker: {r}")
    log(f"phase 17 (b): two gloo processes x 2 shards of cuda:0: the "
        f"{GLOO_PAYLOAD} B encode equal to torch_coder.encode on both "
        f"ranks, scans exact across them: {results}")


# ---------------------------------------------------------------------------
# Phase 18: the LZ4 plane backend ('lz4', 'lz4hc') on every packer
# ---------------------------------------------------------------------------

LZ4_BACKENDS = ("lz4", "lz4hc")
LZ4_PLAIN = ("xdelta_swizzle_plain", "xdelta_swizzle_batch_plain",
             "tokenize_planes_plain", "fwht_plain", "dct_forward_plain",
             "dct_inverse_plain")


def lz4_route(ck, name, make, nat, want_launches, kernel_names, dev):
    """One packer of the LZ4 route on the card: its compress (launch
    counts read just after, every count set to 0 just before) and its
    decompress, the device_decode packer's decompress and
    decompress_many of 2, the plain versions never called; the container
    equal to the device="cpu" packer's, every decode equal to the CPU
    packer's; the profiler's device operations of 3 compress +
    decompress calls hold kernel_names and no tokenize kernel. Returns
    the container."""
    p, pd = make(), make(device_decode=True)
    with CountCalls(ck, LZ4_PLAIN) as plain:
        comp, got_c = launched_by(ck, lambda: p.compress(nat))
        rec, got_d = launched_by(ck, lambda: p.decompress(comp)[0])
        rec_dd = pd.decompress(comp)[0]
        rec_many = pd.decompress_many([comp, comp])
        torch.cuda.synchronize()
    cpu = make(device="cpu")
    cpu_comp = cpu.compress(nat)
    want = cpu.decompress(cpu_comp)[0]
    if comp != cpu_comp or not comp[0] & 0x40:
        raise AssertionError(f"{name}: card and CPU containers differ")
    if not rec == rec_dd == want or rec_many != [want] * 2:
        raise AssertionError(f"{name}: a decode differs from the CPU's")
    if (got_c, got_d) != want_launches or any(plain.calls.values()):
        raise AssertionError(f"{name}: launches {got_c} / {got_d}, not "
                             f"{want_launches}; plain {plain.calls}")
    names = device_op_names(lambda: p.decompress(p.compress(nat)), reps=3)
    ran = [k for k in kernel_names if any(k in o for o in names)]
    if ran != list(kernel_names) or any("tokenize" in o for o in names):
        raise AssertionError(f"{name}: the profiler saw {names}")
    ours = [m.group(1) for m in (re.search(r"namespace\)::(\w+_kernel)", o)
                                 for o in names) if m]
    log(f"phase 18: {name}: {len(nat)} B -> {len(comp)} B, container equal "
        f"to the CPU's; decompress, with device_decode and decompress_many "
        f"of 2 equal to the CPU's; launches compress {got_c}, decompress "
        f"{got_d}; no plain version called; device operations of a "
        f"compress and a decompress: {len(names)} kinds, the port's "
        f"kernels among them {ours}")
    return comp


def check_lz4_path(packers, ck, sig, native, comp, ch, ns, dev, smi,
                   n3=2 ** 14, n4=4096):
    """Phase 18: the LZ4 plane backend, both encoders ('lz4' greedy,
    'lz4hc' hash chains), on the card. The main signal (12 x 34,199, bps
    4, xdelta at 3 planes): a compress is one xdelta_swizzle and no
    tokenize_planes, a decompress no kernel; compress_many of 4 payloads
    one xdelta_swizzle_batch, equal to sequential compress calls; the
    device_decode packer decodes a batch of LZ4 and hzr containers. The
    Hadamard packer at config 3 (2^14 samples: fwht on compress and on
    decompress), the DCT packer at config 4 (4,096 samples at bps 3:
    dct_forward, dct_inverse) and the Hadamard packer at one sample (no
    fwht launch), each against its device="cpu" packer. Then the walls
    of compress, its LZ4 host stage, decompress and decompress with
    device_decode beside the hzr packer's, in turns, medians of 5 [min,
    max], and each CR beside the hzr container's."""
    from rspt_tpu_torch.utils import metrics
    nat3 = native[:n3 * ch * 4]
    nat4 = to_native(np.ascontiguousarray(sig[:, :n4]) >> 8, 3)
    one = {c: native[:4 * c] for c in (1, 3)}
    rolled = [to_native(np.roll(sig, 977 * k, axis=1), 4) for k in range(4)]
    crs = {}
    for be in LZ4_BACKENDS:
        def xd(be=be, **kw):
            return packers.new_xdelta_hzr(4, ch, ns, 3, plane_backend=be,
                                          **kw)
        c_lz = lz4_route(ck, f"xdelta {be}", xd, native,
                         ({"xdelta_swizzle": 1}, {}),
                         ("xdelta_swizzle_kernel",), dev)
        pm = xd()
        many, got = launched_by(ck, lambda: pm.compress_many(rolled))
        seq = xd()
        if many != [seq.compress(r) for r in rolled] or got != {
                "xdelta_swizzle_batch": 1}:
            raise AssertionError(f"{be}: compress_many of 4: launches {got},"
                                 f" equal to sequential {many == seq}")
        pdd = packers.new_xdelta_hzr(4, ch, ns, 3, device_decode=True)
        mixed = pdd.decompress_many([c_lz, comp, c_lz])
        if mixed != [native] * 3 or not pdd.decode_info["tiles"]:
            raise AssertionError(f"{be}: a mixed LZ4 / hzr batch")
        log(f"phase 18: xdelta {be}: compress_many of 4 payloads {got}, "
            f"equal to 4 compress calls, stages {pm.stage_seconds}; an hzr "
            f"device_decode packer decodes [lz4, hzr, lz4] exactly")

        def had(be=be, **kw):
            return packers.new_hadamard(4, ch, n3, plane_backend=be, **kw)
        lz4_route(ck, f"Hadamard 2^14 {be}", had, nat3,
                  ({"fwht": 1}, {"fwht": 1}), ("fwht_kernel",), dev)

        def dct(be=be, **kw):
            return packers.new_dct(3, ch, n4, plane_backend=be, **kw)
        lz4_route(ck, f"DCT 4,096 bps 3 {be}", dct, nat4,
                  ({"dct_forward": 1}, {"dct_inverse": 1}),
                  ("dct_forward_kernel", "dct_inverse_kernel"), dev)
        for c in (1, 3):
            def had1(be=be, c=c, **kw):
                return packers.new_hadamard(4, c, 1, plane_backend=be, **kw)
            lz4_route(ck, f"Hadamard n = 1, {c} channels, {be}", had1,
                      one[c], ({}, {}), (), dev)
    for c in (1, 3):
        h1, ch1 = packers.new_hadamard(4, c, 1), packers.new_hadamard(
            4, c, 1, device="cpu")
        c1, got = launched_by(ck, lambda: h1.compress(one[c]))
        rec1, got_d = launched_by(ck, lambda: h1.decompress(c1)[0])
        if (c1 != ch1.compress(one[c]) or len(c1) != {1: 52, 3: 58}[c]
                or rec1 != ch1.decompress(c1)[0] or "fwht" in got
                or got_d):
            raise AssertionError(f"Hadamard n = 1 hzr, {c} channels: "
                                 f"{len(c1)} B, launches {got} / {got_d}")
        log(f"phase 18: Hadamard n = 1 hzr, {c} channels: {len(c1)} B equal "
            f"to the CPU's, decoded; launches {got} / {got_d} (no fwht)")
    for name, nat, mk in (
            ("xdelta", native,
             lambda **kw: packers.new_xdelta_hzr(4, ch, ns, 3, **kw)),
            ("Hadamard 2^14", nat3,
             lambda **kw: packers.new_hadamard(4, ch, n3, **kw)),
            ("DCT 4,096 bps 3", nat4,
             lambda **kw: packers.new_dct(3, ch, n4, **kw))):
        crs[name] = {be: metrics.compression_ratio(
            len(nat), len(mk(plane_backend=be).compress(nat)))
            for be in ("hzr", *LZ4_BACKENDS)}
    log("phase 18: CR hzr / lz4 / lz4hc: " + "; ".join(
        f"{k} " + " / ".join(f"{v:.4f}" for v in r.values())
        for k, r in crs.items()))
    time_lz4_path(packers, native, ch, ns, smi)


def time_lz4_path(packers, native, ch, ns, smi):
    """Phase 18's walls on the main signal: compress (with its LZ4 host
    stage), decompress on the host path and with device_decode, for the
    hzr, lz4 and lz4hc packers in turns, medians of 5 [min, max]."""
    pk = {be: packers.new_xdelta_hzr(4, ch, ns, 3, plane_backend=be)
          for be in ("hzr", *LZ4_BACKENDS)}
    pdd = packers.new_xdelta_hzr(4, ch, ns, 3, device_decode=True)
    comps = {be: p.compress(native) for be, p in pk.items()}
    walls = {f"{w} {be}": [] for w in ("compress", "lz4 stage", "fetch "
                                       "stage", "decompress",
                                       "device_decode") for be in pk}
    stages = {}
    for be in pk:
        pdd.decompress(comps[be])
    for _ in range(5):
        for be, p in pk.items():
            walls[f"compress {be}"] += wall_times(
                lambda: p.compress(native), reps=1)
            stages[be] = dict(p.stage_seconds)
            walls[f"lz4 stage {be}"].append(p.stage_seconds.get("lz4", 0.0))
            walls[f"fetch stage {be}"].append(
                p.stage_seconds.get("fetch", 0.0))
            walls[f"decompress {be}"] += wall_times(
                lambda: p.decompress(comps[be]), reps=1)
            walls[f"device_decode {be}"] += wall_times(
                lambda: pdd.decompress(comps[be]), reps=1)
    for w in ("compress", "lz4 stage", "fetch stage", "decompress",
              "device_decode"):
        log(f"phase 18: {w} walls on {smi}, s, medians of 5 [min, max] in "
            f"turns: " + "; ".join(
                f"{be} {spread(walls[f'{w} {be}'], 6)}" for be in pk
                if w not in ("lz4 stage", "fetch stage") or be != "hzr"))
    log(f"phase 18: stages of the last compress: {stages}; of the last "
        f"decompress: lz4 {pk['lz4'].stage_seconds}, hzr "
        f"{pk['hzr'].stage_seconds}")


CPUINFO_KEYS = ("model name", "vendor_id", "cpu family", "model",
                "cpu MHz")


def host_cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names its first processor: model
    name, vendor, family, model and clock ("not read" without the
    file)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return "not read"
    found = {}
    for line in text.split("\n\n")[0].splitlines():
        key, _, val = line.partition(":")
        if key.strip() in CPUINFO_KEYS:
            found.setdefault(key.strip(), val.strip())
    return ", ".join(f"{k} {found[k]}" for k in CPUINFO_KEYS if k in found)


def native_cases(packers, sig, native, ch, ns, n3=2 ** 14, n4=4096):
    """Phase 19's configurations: (name, native bytes, factory(**kw)) of
    config 2's main signal (xdelta at 3 planes, hzr and LZ4 planes),
    config 1's sine (hzr), config 3's Hadamard at 2^14 and config 4's
    DCT at 4,096 samples, bps 4 and 3."""
    sine = (np.sin(np.arange(8192) / 100.0) * 1000.0).astype(
        np.int32).astype("<i4").tobytes()
    sig4 = np.ascontiguousarray(sig[:, :n4])
    return [
        ("config 2 xdelta", native,
         lambda **kw: packers.new_xdelta_hzr(4, ch, ns, 3, **kw)),
        ("config 2 xdelta lz4", native,
         lambda **kw: packers.new_xdelta_hzr(4, ch, ns, 3,
                                             plane_backend="lz4", **kw)),
        ("config 1 sine hzr", sine,
         lambda **kw: packers.new_hzr(4, 1, 8192, **kw)),
        ("config 3 Hadamard 2^14", native[:n3 * ch * 4],
         lambda **kw: packers.new_hadamard(4, ch, n3, **kw)),
        ("config 4 DCT bps 4", native[:n4 * ch * 4],
         lambda **kw: packers.new_dct(4, ch, n4, **kw)),
        ("config 4 DCT bps 3", to_native(sig4 >> 8, 3),
         lambda **kw: packers.new_dct(3, ch, n4, **kw)),
    ]


def stream_pushes(native, ch):
    """Config 5's input cut into 3 irregular pushes (2.5, 3.25 and the
    rest of the main signal's 8.35 blocks)."""
    blk = STREAM_NS * ch * 4
    return [native[:5 * blk // 2], native[5 * blk // 2:23 * blk // 4],
            native[23 * blk // 4:]]


def check_native_engine(packers, ck, sig, native, ch, ns, smi):
    """Phase 19: the all-host engine (engine="native"), which launches no
    kernel. For each of native_cases, the native container equals the
    card packer's byte for byte, the native decode equals the card's
    (the input itself where lossless) and the native packer decodes the
    card's container; config 5's frames through the fused route (one
    runtime call a push) equal the card codec's over the same 3 pushes.
    The wrappers count no launch during the native calls and the
    profiler sees no device operation (a card compress in the same way
    shows that it sees them). Then the walls, in turns with the card:
    compress and decompress of each case, and config 5's steady push
    (fused against the card codec), medians of 5 [min, max]."""
    import os
    from rspt_tpu_torch import pipeline
    from rspt_tpu_torch.native import bindings as rt
    log(f"phase 19: host CPU {host_cpu_model()}, os.cpu_count() "
        f"{os.cpu_count()}, the runtime's threads {rt.threads()}; card {smi}")
    cases = []
    for name, nat, make in native_cases(packers, sig, native, ch, ns):
        card, nv = make(), make(engine="native")
        c_card = card.compress(nat)
        want = card.decompress(c_card)[0]
        (c_nat, rec, rec_card), got = launched_by(ck, lambda: (
            nv.compress(nat), nv.decompress(c_card)[0],
            make(engine="native").decompress(c_card)[0]))
        if c_nat != c_card:
            raise AssertionError(f"{name}: native and card containers "
                                 f"differ ({len(c_nat)} / {len(c_card)} B)")
        lossless = "xdelta" in name or "hzr" in name
        if rec != want or rec_card != want or (lossless and rec != nat):
            raise AssertionError(f"{name}: a native decode differs")
        if got:
            raise AssertionError(f"{name}: the native engine launched {got}")
        cases.append((name, nat, card, nv, c_card))
        log(f"phase 19: {name}: {len(nat)} B -> {len(c_nat)} B, the native "
            f"container equal to the card's; decodes equal"
            f"{' to the input' if lossless else ''}; no launch")
    cfg = stream_config(4, ch)
    pushes = stream_pushes(native, ch)
    codecs = {"card": pipeline.StreamingCodec(cfg),
              "fused": pipeline.StreamingCodec(
                  cfg, packer=packers.new_xdelta_hzr(4, ch, STREAM_NS, 3,
                                                     engine="native"))}
    frames = {}
    for k, c in codecs.items():
        frames[k], got = launched_by(ck, lambda c=c: [
            f for chunk in pushes for f in c.push(chunk)])
        if k == "fused" and got:
            raise AssertionError(f"fused stream: launched {got}")
    if frames["fused"] != frames["card"] or len(frames["card"]) != 8:
        raise AssertionError(f"config 5: fused and card frames differ "
                             f"({len(frames['fused'])} / "
                             f"{len(frames['card'])})")
    fresh = pipeline.StreamingCodec(cfg, packer=packers.new_xdelta_hzr(
        4, ch, STREAM_NS, 3, engine="native"))

    def native_calls():
        for _, nat, _, nv, _ in cases:
            nv.decompress(nv.compress(nat))
        for chunk in pushes:
            fresh.push(chunk)

    # the fullest of up to 4 traces each: the profiler may lose a trace's
    # events, never add one
    seen = len(_device_events(native_calls, 1))
    card_seen = len(_device_events(
        lambda: cases[0][2].compress(cases[0][1]), 1))
    if seen or not card_seen:
        raise AssertionError(f"profiler: {seen} device operations during the"
                             f" native calls, {card_seen} in a card compress")
    log(f"phase 19: config 5: {len(pushes)} pushes, {len(frames['card'])} "
        f"frames through the fused route equal to the card codec's; the "
        f"profiler saw {seen} device operations during every native call "
        f"of this phase (a card compress: {card_seen})")
    time_native_engine(cases, codecs, native, smi)


def time_native_engine(cases, codecs, native, smi):
    """Phase 19's walls, in turns with the card: compress and decompress
    of each case, then config 5's steady push of the whole main signal
    (8 frames) through the fused route and the card codec; medians of 5
    [min, max]."""
    walls = {}
    for name, nat, card, nv, comp in cases:
        w = {k: [] for k in ("compress card", "compress native",
                             "decompress card", "decompress native")}
        for _ in range(5):
            for eng, p in (("card", card), ("native", nv)):
                w[f"compress {eng}"] += wall_times(lambda: p.compress(nat), 1)
                w[f"decompress {eng}"] += wall_times(
                    lambda: p.decompress(comp), 1)
        walls[name] = w
        log(f"phase 19: {name} walls on {smi}, s, medians of 5 [min, max] "
            f"in turns: " + "; ".join(f"{k} {spread(v, 6)}"
                                      for k, v in w.items()))
    w = {k: [] for k in codecs}
    st = {}
    for _ in range(5):
        for k, c in codecs.items():
            w[k] += wall_times(lambda: c.push(native), 1)
            st[k] = dict(c.stage_seconds)
    walls["config 5 steady push"] = w
    log(f"phase 19: config 5 steady push of {len(native)} B on {smi}, s, "
        f"medians of 5 [min, max] in turns: card {spread(w['card'], 6)}; "
        f"fused {spread(w['fused'], 6)}; stages of the last {st}")
    log("phase 19: " + json.dumps({"native_walls": {
        k: {m: statistics.median(v) for m, v in w.items()}
        for k, w in walls.items()}}))


def gloo_worker(rank: int, port: int) -> int:
    """One of check_gloo_processes' two workers."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from rspt_tpu_torch import parallel
    from rspt_tpu_torch.hzr import torch_coder as tc
    from rspt_tpu_torch.ops import cuda_kernels as ck
    from rspt_tpu_torch.ops import torch_ops as tops
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=2, timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    mesh = parallel.make_mesh([dev] * 2)
    rng = np.random.default_rng(42)       # the same payload on both ranks
    data = rng.integers(0, 60, GLOO_PAYLOAD).astype(np.uint8)
    enc = parallel.ShardedHzrEncoder(mesh)
    enc.encode(data)
    t0 = time.perf_counter()
    stream, launches = launched_by(ck, lambda: enc.encode(data))
    enc_s = time.perf_counter() - t0
    want = tc.encode(data, device=dev)
    fns = parallel.make_sharded_scans(mesh)
    x = rng.integers(-2**31, 2**31, 4 * 65536).astype(np.int32)
    x[:2] = [-2**31, 2**31 - 1]
    parts = fns["shard"](x)
    coded = fns["xor_encode"](fns["delta_encode"](parts))
    back = fns["gather"](fns["delta_decode"](fns["xor_decode"](coded)))
    whole = torch.from_numpy(x).to(dev)
    scans_ok = (torch.equal(back, torch.from_numpy(x)) and torch.equal(
        fns["gather"](coded),
        tops.xor_encode(tops.delta_encode(whole)).cpu()))
    print(json.dumps(dict(rank=rank, shards=mesh.size,
                          encode_equal=stream == want, stream_bytes=len(stream),
                          launches=launches, encode_s=enc_s,
                          scans_equal=bool(scans_ok))), flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from rspt_tpu_torch import packers
    from rspt_tpu_torch.formats.crc32c import crc32c
    from rspt_tpu_torch.hzr import gpu_decoder as gd
    from rspt_tpu_torch.hzr import torch_coder as tc
    from rspt_tpu_torch.native import _build as native_build
    from rspt_tpu_torch.native import bindings as rt_bindings
    from rspt_tpu_torch.ops import _build
    from rspt_tpu_torch.ops import cuda_kernels as ck
    from rspt_tpu_torch.ops import torch_ops as tops
    # the card tests' edge inputs of compact_tokens and place_literals
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_cuda as edges

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # phase 1: build the kernels (nvcc) and the host runtime (g++) at once
    t0 = time.perf_counter()
    rt_built = {}

    def build_runtime():
        try:
            rt_built["lib"] = native_build.load_library()
        except Exception as e:  # re-raised below
            rt_built["error"] = e
        rt_built["s"] = time.perf_counter() - t0

    rt_thread = threading.Thread(target=build_runtime)
    rt_thread.start()
    lib = _build.load_library()
    log(f"phase 1: kernels built/loaded in {time.perf_counter() - t0:.2f} s "
        f"({lib._name})")
    rt_thread.join()
    if "error" in rt_built:
        raise rt_built["error"]
    log(f"phase 1: host runtime built/loaded in {rt_built['s']:.2f} s "
        f"({rt_built['lib']._name}), CRC32C instruction "
        f"{rt_bindings.crc32c_hw_ok()}")
    ptxas = _build.BUILD_ROOT / _build.source_hash() / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or line.startswith("=="):
                log("  " + line.strip())

    # phase 2: each kernel vs its plain version on the card, bit-exact
    ch, ns = 12, 34199
    sig, native = make_ecg(ch, ns)
    words = torch.from_numpy(np.frombuffer(native, "<i4").copy()).to(dev)
    main_x = check_chain(ck, tc, "main", words, ns, ch, 3)
    main_gl = main_x["groups"]
    log(f"phase 2: main-path shapes ok: tokw {tuple(main_x['tokw'].shape)}, "
        f"T {main_x['plan'].T}, payload {main_x['plan'].total_payload} B, "
        f"COPY blocks {int(main_x['plan'].is_copy.sum())}, {main_gl.ng} "
        f"groups, rows {main_gl.nrows_fused} (fused) and "
        f"{main_gl.nrows_windows} (windows)")
    if main_x["k15_slow"]:
        raise AssertionError(f"windows_place_flat: {main_x['k15_slow']} "
                             "supers of the main pass 1 on the slow path")
    chain_groups = {"main": main_gl.ng}
    chain_slow = {"main": 0}
    rng = np.random.default_rng(7)
    n2 = 65536 + 12345                       # odd tail, two slabs a plane
    edge = rng.integers(-(1 << 23), 1 << 23, n2).astype(np.int32)
    edge[rng.random(n2) < 0.5] = 0
    edge[100:40100] = 0                      # zero run > 16,662
    edge[65536 + 1000:65536 + 5000] = 0x01010101 * 7   # literal stretch
    cases = {
        "edge_runs_tail": edge,
        "all_zero_slab": np.concatenate([np.zeros(65536, np.int32),
                                         edge[:5000]]),
        "all_literal_slab": (rng.integers(1, 256, (65536 + 77, 4))
                             * (1 << np.arange(0, 32, 8))).sum(1)
        .astype(np.uint32).view(np.int32),
        # plane 0 random (COPY), plane 1 constant (FILL), plane 2 sparse
        "fill_copy": (rng.integers(0, 256, 70001)
                      | (5 << 8)
                      | ((rng.random(70001) < 0.02) << 16)).astype(np.int32),
    }
    for name, x in cases.items():
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for planes in (1, 3, 4):
            cx = check_chain(ck, tc, f"{name}/p{planes}", t, x.size, 1,
                             planes, swizzle=False, tokenize_raw=True)
            chain_groups[f"{name}/p{planes}"] = cx["groups"].ng
            chain_slow[f"{name}/p{planes}"] = cx["k15_slow"]
    toks = torch.from_numpy(rng.integers(-5, 5, (3, 65536)).astype(
        np.int32)).to(dev)
    tb = torch.tensor([0, 200000, 70000], dtype=torch.int32, device=dev)
    equal("nonzero_valid", ck.compact_tokens(toks, tb, 150000, True),
          ck.compact_tokens_plain(toks, tb, 150000, True))
    for case in ("t_total_mid_tile", "all_valid_row", "ragged_ntok",
                 "trash_rows_between", "nonzero_valid", "single_row"):
        w, b, T, nzv = edges.compact_edge_batch(np.random.default_rng(70),
                                                case)
        w, b = torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)
        equal(f"compact_tokens {case}", ck.compact_tokens(w, b, T, nzv),
              ck.compact_tokens_plain(w, b, T, nzv))
    pf_cover = {}
    if ck._lib().rspt_pack_flat_tile() != edges.PACK_TILE:
        raise AssertionError("pack_flat's tile differs from PACK_TILE: the "
                             "edge cases miss the kernel's tile edges")
    for case in edges.PACK_FLAT_EDGE_CASES:
        pe = edges.pack_flat_edge_batch(np.random.default_rng(110), case)
        pf_cover[case] = edges.pack_flat_edges_covered(pe)
        edges.check_pack_flat_edges_covered(case, pf_cover[case])
        if ck._lib().rspt_pack_flat_state(pe["args"][2].numel(),
                                          pe["args"][0].numel()) != 2 * (
                1 + pf_cover[case]["status_words"]):
            raise AssertionError(f"pack_flat {case}: status words differ "
                                 "from the kernel's")
        a, pa = (tuple(v.to(dev) if torch.is_tensor(v) else v
                       for v in pe[k]) for k in ("args", "plain_args"))
        ln = tuple(v.to(dev) for v in pe["lanes"])
        want = ck.pack_flat_plain(*pa)
        equal(f"pack_flat {case}", ck.pack_flat(*a), want)
        got = ck.pack_flat_lanes(*a, *ln)
        equal(f"pack_flat_lanes {case}", got,
              ck.pack_flat_lanes_plain(*pa, *ln))
        equal(f"pack_flat_lanes {case} words", got[0], want)
    for case in edges.TOKENIZE_EDGE_CASES:
        t = torch.from_numpy(edges.tokenize_edge_batch(
            np.random.default_rng(90), case)).to(dev)
        for planes in (1, 2, 3, 4):
            equal(f"tokenize_planes {case}/p{planes}",
                  ck.tokenize_planes(t, planes),
                  ck.tokenize_planes_plain(t, planes))
    flags = {}   # (the flag, whether every value fits the planes as int32)
    for bps in (2, 3):
        small = (sig >> (32 - 8 * bps)) if bps < 4 else sig
        u8 = torch.from_numpy(np.frombuffer(to_native(small, bps),
                                            np.uint8).copy()).to(dev)
        sig32 = tops.native_to_i32(u8, ns, ch, bps).reshape(-1)
        cx = check_chain(ck, tc, f"bps{bps}", sig32, ns, ch, bps, bps=bps,
                         swizzle=False)
        chain_groups[f"bps{bps}"] = cx["groups"].ng
        chain_slow[f"bps{bps}"] = cx["k15_slow"]
        # the growth flag from fewer planes than bps at full size: the
        # ECG, and a wrapping ramp (steps 0..127) whose xdelta values keep
        # their low 8·bps bits in one plane, though not as int32
        lim = 1 << (8 * bps)
        steps = np.random.default_rng(bps).integers(0, 128, ns * ch)
        ramp = np.cumsum(steps) % lim
        ramp = torch.from_numpy(np.where(ramp >= lim // 2, ramp - lim, ramp)
                                .astype(np.int32)).to(dev)
        for sname, sv in (("ecg", sig32), ("ramp", ramp)):
            for planes in range(1, bps):
                got = ck.xdelta_swizzle(sv, ns, ch, planes, bps, False)
                equal(f"bps{bps}/{sname}/p{planes}/xdelta_swizzle", got,
                      ck.xdelta_swizzle_plain(sv, ns, ch, planes, bps, False))
                enc = got[0]
                sh = 32 - 8 * planes
                flags[f"bps{bps}/{sname}/p{planes}"] = (
                    int(got[1]), bool((((enc << sh) >> sh) == enc).all()))
    # xdelta_swizzle: the native bytes of the main signal at bps 1-4,
    # every plane count; the edge batch; 100 calls on one flag state
    for bps in (1, 2, 3, 4):
        u8 = torch.from_numpy(np.frombuffer(to_native(
            sig >> (32 - 8 * bps), bps), np.uint8).copy()).to(dev)
        for planes in range(1, 5):
            equal(f"u8 bps{bps}/p{planes}/xdelta_swizzle",
                  ck.xdelta_swizzle(u8, ns, ch, planes, bps),
                  ck.xdelta_swizzle_plain(u8, ns, ch, planes, bps, True))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    xd_tile = ck._lib().rspt_xdelta_tile(ns, ch)
    if (ck._lib().rspt_xdelta_band() != edges.XDELTA_BAND
            or xd_tile != edges.xdelta_tile(ns, ch, sms)):
        raise AssertionError("xdelta_swizzle's tile or band differs from "
                             "the edge batch's")
    xd_flags = {}
    for case in edges.XDELTA_EDGE_CASES:
        for k, (xe, ens, ech, epl, ebps, esw, off) in enumerate(
                edges.xdelta_edge_batch(np.random.default_rng(120), case,
                                        sms)):
            shape = (ens, ech) if esw else (ens * ech, 1)
            if ck._lib().rspt_xdelta_tile(*shape) != edges.xdelta_tile(
                    *shape, sms):
                raise AssertionError(f"xdelta_swizzle {case}[{k}]: tile")
            t = edges.device_view(xe, off, dev)
            got = ck.xdelta_swizzle(t, ens, ech, epl, ebps, esw)
            equal(f"xdelta_swizzle {case}[{k}]", got,
                  ck.xdelta_swizzle_plain(t, ens, ech, epl, ebps, esw))
            xd_flags.setdefault(case, []).append(int(got[1]))
    if any(xd_flags[c] != [0] * len(xd_flags[c])
           for c in ("fail_first", "fail_last")):
        raise AssertionError(f"xdelta_swizzle failing cases: {xd_flags}")
    alt = edges.xdelta_alternating(dev)
    win_slow = check_windows_edges(ck, edges, dev)
    torch.cuda.synchronize()
    if 0 not in chain_groups.values():
        raise AssertionError("no chain without a HUFF block (0 groups)")
    want_flags = {"bps2/ecg/p1": (0, False), "bps2/ramp/p1": (1, False),
                  "bps3/ecg/p1": (0, False), "bps3/ecg/p2": (1, True),
                  "bps3/ramp/p1": (1, False), "bps3/ramp/p2": (1, False)}
    if flags != want_flags:
        raise AssertionError(f"xdelta flags at bps < 4: {flags}")
    log(f"phase 2: xdelta_swizzle bit-exact on the main signal's native "
        f"bytes at bps 1-4 (planes 1-4; tiles of {xd_tile} samples, "
        f"{-(-ns // xd_tile)} CTAs on {sms} SMs), on xdelta_edge_batch "
        f"(bands of {edges.XDELTA_BAND}; flags {xd_flags}) and in "
        f"{len(alt)} calls "
        f"alternating passing and failing inputs (flags {''.join(map(str, alt[:8]))}...)")
    log(f"phase 2: windows_place_flat bit-exact on the main pass 1's "
        f"{main_gl.ng} groups with 0 supers on its slow path (slow supers "
        f"per chain {chain_slow}), on WINDOWS_EDGE_CASES in 3 launches each "
        f"(slow supers {win_slow}, as the cases state) and on 160 groups "
        "in 10 launches (0 slow); group_windows (tiles of "
        f"{edges.K14_TILE} tokens) on the same cases' groups, on "
        f"K14_EDGE_CASES {list(edges.K14_EDGE_CASES)} in 3 launches each and "
        "on the 160 groups in 10 launches; place_windows_aligned on every "
        f"case's windows and glue and on X1_EDGE_CASES "
        f"{list(edges.X1_EDGE_CASES)}")
    log("phase 2: all kernels bit-exact against their plain versions "
        "(edge: runs > 16,662, odd tail, all-zero and all-literal slabs, "
        "tokenize_planes on its tile edges at planes 1-4, "
        "FILL/COPY planes, nonzero_valid, bps 2 and 3, and xdelta_swizzle "
        "at bps 2 and 3 from fewer planes on the ECG and a wrapping ramp, "
        f"flags {flags}); compact_tokens on t_total in mid-tile, an "
        "all-valid row, ragged tiles, trash rows between packed rows, "
        "nonzero_valid and a single row; pack_flat_lanes too, its words "
        "equal to pack_flat's; both windows routes' payload bytes equal "
        f"to pack_flat's on every chain (groups per chain {chain_groups}); "
        "pack_flat and pack_flat_lanes on their edge batch (tiles, "
        "segment crossings by a tile's first token and a block's last, "
        f"tokens straddling a shared word: {pf_cover})")

    # phase 3: the main path through the packer's entry points
    for k in ck.KERNELS:
        k.launches = 0
    p = packers.new_xdelta_hzr(4, ch, ns, 3)
    comp = p.compress(native)
    torch.cuda.synchronize()
    comp_stages = dict(p.stage_seconds)
    out, used = p.decompress(comp)
    dec_stages = dict(p.stage_seconds)
    launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 3: main-path launches {launches}")
    missing = [k for k in ("xdelta_swizzle", "tokenize_planes",
                           "compact_tokens", "pack_flat") if not launches[k]]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    if out != native or used != len(comp):
        raise AssertionError("main path: decompress did not round-trip")
    pc = packers.new_xdelta_hzr(4, ch, ns, 3, device="cpu")
    comp_cpu = pc.compress(native)
    if comp != comp_cpu:
        raise AssertionError("main path: card and CPU containers differ")
    plan = main_x["plan"]
    n_copy = int(plan.is_copy.sum())
    if n_copy != 7:
        raise AssertionError(f"expected 7 COPY blocks, got {n_copy}")
    log(f"phase 3: {len(native)} B -> {len(comp)} B (CR "
        f"{len(native) / len(comp):.4f}), container equal to CPU's, exact "
        f"round trip, {n_copy} COPY blocks, planes {p.nr_planes}")
    # verify-and-grow: 1 plane does not fit the ECG's xdelta values
    pg = packers.new_xdelta_hzr(4, ch, ns, 1)
    pg_cpu = packers.new_xdelta_hzr(4, ch, ns, 1, device="cpu")
    cg = pg.compress(native)
    if cg != pg_cpu.compress(native) or pg.nr_planes != pg_cpu.nr_planes:
        raise AssertionError("growth: card and CPU differ")
    if pg.decompress(cg)[0] != native or pg.nr_planes < 2:
        raise AssertionError(f"growth: planes {pg.nr_planes} / round trip")
    pass1_ops, small_packers = {}, {}
    for bps in (2, 3):
        small = to_native(sig >> (32 - 8 * bps), bps)
        a = packers.new_xdelta_hzr(bps, ch, ns, 2)
        b = packers.new_xdelta_hzr(bps, ch, ns, 2, device="cpu")
        for k in ck.KERNELS:
            k.launches = 0
        ca = a.compress(small)
        torch.cuda.synchronize()
        if bps == 2:
            u8_launches = ck.xdelta_swizzle.launches
        if ca != b.compress(small) or a.decompress(ca)[0] != small:
            raise AssertionError(f"bps {bps}: card/CPU or round trip")
        small_packers[bps] = (a, small)
        # one pass 1 on the native bytes: its launches, and the device
        # operations of 5 (no elementwise kernel of native_to_i32, no
        # fill)
        raw = a._to_dev(np.frombuffer(small, np.uint8).copy())
        for k in ck.KERNELS:
            k.launches = 0
        a._pass1(raw)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in ck.KERNELS if k.launches}
        ops = device_op_names(lambda: a._pass1(raw))
        pass1_ops[bps] = (got, ops)
        allowed = ("xdelta_swizzle_kernel", "tokenize_summary_kernel",
                   "tokenize_planes_kernel", "CatArrayBatchedCopy",
                   "Memcpy DtoH")
        if (got != {"xdelta_swizzle": 1, "tokenize_planes": 1}
                or not any("xdelta_swizzle_kernel" in o for o in ops)
                or not all(any(a in o for a in allowed) for o in ops)):
            raise AssertionError(f"bps {bps} pass 1: {got}, {ops}")
    log(f"phase 3: growth 1 -> {pg.nr_planes} planes equal to CPU; bps 2 "
        f"and 3 containers equal to CPU, exact round trips")
    for bps, (got, ops) in pass1_ops.items():
        log(f"phase 3: bps {bps} pass 1 on the native bytes: launches {got}; "
            f"device operations of 5 calls, as first seen: {ops}")

    # phase 5: the decode kernels vs their plain versions on the card
    _, main_streams, _ = p._streams(comp, p.nr_planes, 0)
    dla, dargs, dtotal, dblocks = decode_inputs(gd, main_streams, dev)
    dec = check_decode(ck, gd, "decode main", dla, dargs, dtotal, dev)
    ntiles = dargs[0].shape[0]
    deep_levels = [k + 1 for k in range(4) if dla.ntc[:, k].max() > 0]
    log(f"phase 5: main-path decode shapes ok: {ntiles} tiles, "
        f"{ntiles * 1024} lanes, window {tuple(dargs[1].shape)}, nibble "
        f"levels used {deep_levels}, step counts "
        f"{dec[3][:, 0].tolist()}, fixpoint sweeps {dec[3][:, 1].tolist()}")
    targs = list(dargs)
    targs[0] = dargs[0].clone()
    targs[0][:, 4] = 1
    targs[8] = dec[2]
    tdec = check_decode(ck, gd, "decode trusted", dla, targs, dtotal, dev)
    if int(tdec[3][:, 1].max()) != 0:
        raise AssertionError("trusted entries ran the fixpoint")
    rng5 = np.random.default_rng(13)
    r4 = np.random.default_rng(4)
    pad_a = r4.integers(0, 8, 900).astype(np.uint8)
    pad_b = np.zeros(600, np.uint8)
    pad_b[::53] = r4.integers(1, 255, pad_b[::53].size)
    sparse = np.zeros(2 * 65536, np.uint8)
    idx = rng5.choice(sparse.size, 2500, replace=False)
    sparse[idx] = rng5.integers(1, 255, idx.size)
    super_sparse = np.zeros(65536, np.uint8)
    super_sparse[8::5000] = rng5.integers(1, 255, super_sparse[8::5000].size)
    edge_sets = {
        # test_very_deep_codes_on_device's stream and 21-bit codes
        "very_deep": [np.minimum(np.random.default_rng(13).geometric(
            0.5, 250000), 255).astype(np.uint8),
            fibonacci_bytes(22, rng5)],
        # test_tier2_sparse_chunk_repack's dense, sparse and super-sparse
        "sparse_tier2": [rng5.integers(0, 12, 3 * 65536).astype(np.uint8),
                         sparse, super_sparse],
        # several streams in one batch with the padding-bit pair
        "multi_stream": [pad_a, pad_b, sparse[:40000],
                         rng5.integers(0, 256, 3000).astype(np.uint8),
                         np.full(2000, 9, np.uint8)],
    }
    for name, payloads in edge_sets.items():
        streams = [tc.encode(x.tobytes(), device=dev) for x in payloads]
        ela, eargs, etotal, _ = decode_inputs(gd, streams, dev)
        e = check_decode(ck, gd, name, ela, eargs, etotal, dev)
        if gd.decode_many(streams, hints=False) != [x.tobytes()
                                                   for x in payloads]:
            raise AssertionError(f"{name}: decode_many is not exact")
        levels = [k + 1 for k in range(4) if ela.ntc[:, k].max() > 0]
        log(f"phase 5: {name}: {eargs[0].shape[0]} tiles, nibble levels "
            f"{levels}, steps max {int(e[3][:, 0].max())}, bit-exact, "
            f"decode_many exact")
    rla, rargs, rtotal = edges.decode_batch(
        edges.rank_edge_payloads(np.random.default_rng(91)), dev)
    rdec = check_decode(ck, gd, "rank_edges", rla, rargs, rtotal, dev)
    rt = list(rargs)
    rt[0] = rargs[0].clone()
    rt[0][:, 4] = 1
    rt[8] = rdec[2]
    rtdec = check_decode(ck, gd, "rank_edges trusted", rla, rt, rtotal, dev)
    if int(rtdec[3][:, 1].max()) != 0 or int(rdec[3][:, 1].min()) < 2:
        raise AssertionError("rank_edges: sweeps "
                             f"{rdec[3][:, 1].tolist()} / "
                             f"{rtdec[3][:, 1].tolist()}")
    log(f"phase 5: rank_edges (a block over all 8 CTAs of tile 0, padding "
        f"rows between blocks): {rargs[0].shape[0]} tiles, sweeps "
        f"{rdec[3][:, 1].tolist()}, bit-exact untrusted and trusted")
    pb = edges.place_edge_batch(np.random.default_rng(71),
                                [300, 45, 137, 305], 300)
    for emis_off, out_off in ((0, 0), (1, 3), (2, 1)):
        got, want, around = edges.place_at_offsets(pb, dev, emis_off,
                                                    out_off)
        equal(f"place_literals edges {emis_off}/{out_off}", got, want)
        if around.any():
            raise AssertionError("place_literals wrote outside out")
    log("phase 5: hzr_decode and place_literals bit-exact against their "
        "plain versions (main path, trusted entries, levels 3-4, sparse "
        "and super-sparse tier-2 blocks, multi-stream padding-bit pair); "
        "place_literals on word-store edges (mid-word runs, shared words, "
        "chunk splits, out_limit cuts, S = 300, host bytes, emis and out "
        "misaligned), nothing written outside out")

    # phase 6: the device-decode main path
    for k in ck.KERNELS:
        k.launches = 0
    pd = packers.new_xdelta_hzr(4, ch, ns, 3, device_decode=True)
    out6, used6 = pd.decompress(comp)
    torch.cuda.synchronize()
    dd_stages = dict(pd.stage_seconds)
    dd_launches = {k.__name__: k.launches for k in ck.KERNELS}
    info = pd.decode_info
    log(f"phase 6: device-decode launches {dd_launches}")
    for k in ("hzr_decode", "place_literals"):
        if dd_launches[k] == 0:
            raise AssertionError(f"device decode did not launch {k}")
    if out6 != native or used6 != len(comp) or out6 != out:
        raise AssertionError("device decode: not the native bytes")
    if info["device_blocks"] != 14:
        raise AssertionError(f"device decode blocks: {info}")
    log(f"phase 6: decompress(device_decode=True) exact, equal to the host "
        f"path; {info['tiles']} tiles, {info['lanes']} lanes, "
        f"{info['device_blocks']} device blocks, step counts {info['steps']}, fixpoint sweeps "
        f"{info['fp_iters']}, {info['literals']} literals")
    sig3, native3 = make_ecg(ch, ns, seed=99)
    comp3 = pd.compress(native3)
    if pg.nr_planes != pd.nr_planes:
        raise AssertionError("grown container has another plane count")
    comps = [comp, cg, comp3]
    seq = [pd.decompress(c)[0] for c in comps]
    if seq != [native, native, native3] or pd.decompress_many(comps) != seq:
        raise AssertionError("decompress_many differs from decompress")
    log(f"phase 6: decompress_many of 3 containers (one grown from 1 "
        f"plane) equals sequential decompress; one batch of "
        f"{pd.decode_info['tiles']} tiles")
    dd_s = wall_s(lambda: pd.decompress(comp), reps=3)
    dd_stages_t = dict(pd.stage_seconds)
    outs_h, hints = pd.decompress_many([comp], return_hints=True)
    t6 = time.perf_counter()
    outs_h2 = pd.decompress_many([comp], hints=hints)
    torch.cuda.synchronize()
    hd_first_s = time.perf_counter() - t6
    hd_first_stages = dict(pd.stage_seconds)
    if outs_h != [native] or outs_h2 != [native] \
            or not pd.decode_info["hinted"] or max(pd.decode_info["fp_iters"]):
        raise AssertionError("hinted decode: not exact or ran the fixpoint")
    if "check" not in hd_first_stages:
        raise AssertionError("first hinted decode was not cross-checked")
    hd_s = wall_s(lambda: pd.decompress(comp), reps=3)
    hd_stages = dict(pd.stage_seconds)
    log(f"phase 6: hinted decode exact, fixpoint sweeps "
        f"{pd.decode_info['fp_iters']}")
    gd._hint_registry.clear()

    # phase 7: fwht vs its plain version, the global passes included
    # (the card tests' FWHT_CASES: every change of the cluster size, rows
    # of 1, 13 and 1,001, the global passes)
    rng7 = np.random.default_rng(17)
    fw_cases = {f"{rows}x{n}": edges.fwht_case(rng7, rows, n)
                for rows, n in edges.FWHT_CASES}
    ext = np.full((4, 1024), -2 ** 31, np.int32)
    ext[1] = 2 ** 31 - 1
    ext[2, 1::2] = 2 ** 31 - 1
    ext[3, ::3] = -1
    fw_cases["int32_extremes"] = ext
    for name, a in fw_cases.items():
        t = torch.from_numpy(a).to(dev)
        equal(f"fwht {name}", ck.fwht(t), ck.fwht_plain(t))
        equal(f"fwht {name}: x after the call", t.cpu(), torch.from_numpy(a))
    torch.cuda.synchronize()
    clusters = {n: ck._lib().rspt_fwht_cluster(n.bit_length() - 1)
                for n in sorted({n for _, n in edges.FWHT_CASES})}
    log(f"phase 7: fwht bit-exact against fwht_plain at {list(fw_cases)}, "
        f"x unchanged; CTAs a row's cluster by n {clusters}")

    # phase 8: the Hadamard path at BASELINE config 3
    n3 = 2 ** 14
    nat3 = native[:n3 * ch * 4]
    for k in ck.KERNELS:
        k.launches = 0
    ph = packers.new_hadamard(4, ch, n3)
    c_had = ph.compress(nat3)
    torch.cuda.synchronize()
    fw_c = ck.fwht.launches
    o_had = ph.decompress(c_had)[0]
    fw_d = ck.fwht.launches - fw_c
    phd = packers.new_hadamard(4, ch, n3, device_decode=True)
    o_had_dev = phd.decompress(c_had)[0]
    torch.cuda.synchronize()
    had_launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 8: Hadamard path launches {had_launches}")
    if (fw_c, fw_d, had_launches["fwht"]) != (1, 1, 3):
        raise AssertionError("fwht: not one launch per compress and per "
                             f"decompress ({fw_c}, {fw_d})")
    missing = [k for k in ("tokenize_planes", "compact_tokens", "pack_flat",
                           "hzr_decode", "place_literals")
               if not had_launches[k]]
    if missing:
        raise AssertionError(f"Hadamard path did not launch {missing}")
    hc = packers.new_hadamard(4, ch, n3, device="cpu")
    if c_had != hc.compress(nat3):
        raise AssertionError("Hadamard: card and CPU containers differ")
    if not o_had == o_had_dev == hc.decompress(c_had)[0]:
        raise AssertionError("Hadamard: decompress differs from the CPU's")
    s_in = np.frombuffer(nat3, "<i4").reshape(n3, ch).T.astype(np.float64)
    s_out = np.frombuffer(o_had, "<i4").reshape(n3, ch).T.astype(np.float64)
    mean3 = tops.average32_host(s_in.astype(np.int64).sum(1), n3)
    prdn3 = 100 * np.sqrt(((s_in - s_out) ** 2).sum()
                          / ((s_in - mean3[:, None]) ** 2).sum())
    if not 0 < prdn3 < 5:
        raise AssertionError(f"Hadamard: PRDN {prdn3}%")
    log(f"phase 8: Hadamard {len(nat3)} B -> {len(c_had)} B (CR "
        f"{len(nat3) / len(c_had):.4f}), PRDN {prdn3:.4f}%, container and "
        f"reconstruction (host and device decode) equal to the CPU's; "
        f"{phd.decode_info['device_blocks']} device blocks")

    # phase 9: the hzr path at the main shape and on config 1's sine
    for k in ck.KERNELS:
        k.launches = 0
    pz = packers.new_hzr(4, ch, ns)
    c_hzr = pz.compress(native)
    torch.cuda.synchronize()
    o_hzr = pz.decompress(c_hzr)[0]
    pzd = packers.new_hzr(4, ch, ns, device_decode=True)
    o_hzr_dev = pzd.decompress(c_hzr)[0]
    torch.cuda.synchronize()
    hzr_launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 9: hzr path launches {hzr_launches}")
    missing = [k for k in ("tokenize_planes", "compact_tokens", "pack_flat",
                           "hzr_decode", "place_literals")
               if not hzr_launches[k]]
    if missing:
        raise AssertionError(f"hzr path did not launch {missing}")
    if c_hzr != packers.new_hzr(4, ch, ns, device="cpu").compress(native):
        raise AssertionError("hzr: card and CPU containers differ")
    if o_hzr != native or o_hzr_dev != native:
        raise AssertionError("hzr: round trip not exact")
    sine = (np.sin(np.arange(8192) / 100.0) * 1000.0).astype(
        np.int32).astype("<i4").tobytes()
    p1 = packers.new_hzr(4, 1, 8192)
    c1 = p1.compress(sine)
    if (p1.decompress(c1)[0] != sine
            or packers.new_hzr(4, 1, 8192, device_decode=True)
            .decompress(c1)[0] != sine):
        raise AssertionError("hzr: config 1 sine round trip not exact")
    log(f"phase 9: hzr {len(native)} B -> {len(c_hzr)} B (CR "
        f"{len(native) / len(c_hzr):.4f}), container equal to the CPU's, "
        f"exact on both decode paths, {pzd.decode_info['device_blocks']} "
        f"device blocks; config 1 sine {len(sine)} B -> {len(c1)} B, exact")

    # phase 10: encode-time decode hints at the main shape
    gd._hint_registry.clear()
    gd._validated_digests.clear()
    for k in ck.KERNELS:
        k.launches = 0
    pw = packers.new_xdelta_hzr(4, ch, ns, 3, device_decode=True)
    c_h, hints_h = pw.compress_with_hints(native)
    torch.cuda.synchronize()
    hint_launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 10: compress_with_hints launches {hint_launches}")
    if hint_launches["pack_flat_lanes"] != 1 or hint_launches["pack_flat"]:
        raise AssertionError("compress_with_hints did not pack with lanes")
    if c_h != comp or hints_h is None:
        raise AssertionError("compress_with_hints: container differs")
    gd._hint_registry.clear()
    if pw.decompress_many([c_h], hints=hints_h) != [native]:
        raise AssertionError("hinted decode not exact")
    hinfo = dict(pw.decode_info)
    if not hinfo["hinted"] or max(hinfo["fp_iters"]) != 0 \
            or "check" not in pw.stage_seconds:
        raise AssertionError(f"encode hints not trusted: {hinfo}")
    outs_c, conv = pw.decompress_many([c_h], hints=False, return_hints=True)
    if outs_c != [native] or max(pw.decode_info["fp_iters"]) == 0:
        raise AssertionError("unhinted decode ran no fixpoint")
    active = hints_h.entries < dla.segend
    diff = hints_h.entries != conv.entries
    if conv.digest != hints_h.digest or (diff & active).any():
        raise AssertionError("encode entries differ from the converged "
                             "ones on active lanes")
    log(f"phase 10: container equal to compress()'s; hinted decode exact, "
        f"trusted, fixpoint sweeps {hinfo['fp_iters']}; entries equal the "
        f"converged ones on all {int(active.sum())} active lanes "
        f"({int(diff.sum())} inactive lanes differ: "
        f"{[(int(a), int(b), int(c)) for a, b, c in zip(hints_h.entries[diff], conv.entries[diff], dla.segend[diff])][:8]}"
        f" as (hint, converged, segment end))")
    gd._hint_registry.clear()

    # phase 11: the hzr stream encoder and the per-block pack kernels
    # (the main payload as one stream)
    k13a_args, blk11, len11 = stream_blocks_args(tc, native, dev)
    if blk11.shape[0] != 26 or int(len11[-1]) != 3152:
        raise AssertionError(f"stream blocks: {blk11.shape}, {len11[-1]}")
    equal("tokenize_blocks card vs CPU", k13a_args[:4],
          tc.tokenize_blocks(torch.from_numpy(blk11),
                             torch.from_numpy(len11))[:4])
    equal("pack_blocks main", ck.pack_blocks(*k13a_args),
          ck.pack_blocks_plain(*k13a_args))
    # K13b on the main path's own pass 1 (21 blocks, 3 planes, 7 COPY)
    plane_len = main_x["enc"].numel()
    k13b_args = pass1_blocks_args(tc, main_x, dev)
    equal("pack_blocks_tokw main", ck.pack_blocks_tokw(*k13b_args),
          ck.pack_blocks_tokw_plain(*k13b_args))
    # edge batch: a random block under 20-bit codes (its bits overflow the
    # row: a COPY candidate), an all-zero (FILL) block, a short tail with
    # random padding; every row and bit total compared (kernel and plain
    # drop the same overflowing bits)
    r11 = np.random.default_rng(23)
    eb = np.zeros((3, 65536), np.uint8)
    eb[0] = r11.integers(0, 256, 65536)
    eb[2] = r11.integers(1, 256, 65536)
    eb[2, :3152] = np.minimum(r11.geometric(0.3, 3152) - 1, 255)
    elen = np.array([65536, 65536, 3152], np.int32)
    fe = tc.tokenize_blocks(torch.from_numpy(eb).to(dev),
                            torch.from_numpy(elen).to(dev))
    codes_e, cbits_e, _, dbits_e, fill_e = tc.host_tables(
        fe[4].cpu().numpy(), elen)
    codes_e[0] = np.arange(261) * 2477 & 0xFFFFF
    cbits_e[0] = 20
    lut_e = torch.from_numpy(tc.lut_words(codes_e, cbits_e)).to(dev)
    d_e = torch.from_numpy(dbits_e).to(dev)
    got_e = ck.pack_blocks(*fe[:4], lut_e, d_e)
    equal("pack_blocks edge", got_e, ck.pack_blocks_plain(*fe[:4], lut_e, d_e))
    tokw_e = fe[0] | (fe[2] << 9) | (fe[1] << 13) | (fe[3] << 27)
    equal("pack_blocks_tokw edge", ck.pack_blocks_tokw(tokw_e, lut_e, d_e),
          got_e)
    equal("pack_blocks_tokw_plain edge",
          ck.pack_blocks_tokw_plain(tokw_e, lut_e, d_e), got_e)
    torch.cuda.synchronize()
    if not (int(got_e[1][0]) > 32 * got_e[0].shape[1]
            and fill_e.tolist() == [False, True, False]):
        raise AssertionError("edge batch: no overflow row or no FILL block")
    # the card tests' pack_blocks_edge_batch: partial last tiles, tokens
    # spanning the word two tiles share, an empty tile between valid
    # ones, a row passing nwords in a middle tile, 1 and 48 blocks
    pb_cov = {}
    for case in edges.PACK_BLOCKS_EDGE_CASES:
        xb = edges.pack_blocks_edge_batch(np.random.default_rng(120), case)
        pb_cov[case] = edges.pack_blocks_edges_covered(xb)
        edges.check_pack_blocks_edges_covered(case, pb_cov[case])
        fb = [torch.from_numpy(np.ascontiguousarray(f)).to(dev)
              for f in xb["fields"]]
        tb, lb, db = (torch.from_numpy(xb[k]).to(dev)
                      for k in ("tokw", "lut", "desc_bits"))
        want_b = ck.pack_blocks_plain(*fb, lb, db)
        equal(f"pack_blocks {case}", ck.pack_blocks(*fb, lb, db), want_b)
        equal(f"pack_blocks_tokw {case}", ck.pack_blocks_tokw(tb, lb, db),
              want_b)
    torch.cuda.synchronize()
    log(f"phase 11: pack_blocks bit-exact against its plain version at "
        f"{tuple(k13a_args[0].shape)} (the main payload as one stream), "
        f"pack_blocks_tokw at {tuple(main_x['tokw'].shape)} (main pass 1); "
        f"edge batch (overflow {int(got_e[1][0])} bits, FILL, 3,152 B "
        f"tail) equal in both forms; tokenize_blocks equal to the CPU's; "
        f"pack_blocks_edge_batch equal in both forms: {pb_cov}")
    for k in ck.KERNELS:
        k.launches = 0
    s11 = tc.encode(native, device=dev)
    torch.cuda.synchronize()
    enc_launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 11: encode launches {enc_launches}")
    if (enc_launches["pack_blocks"] != 1 or enc_launches["compact_tokens"]
            or enc_launches["pack_flat"]):
        raise AssertionError("encode did not pack with one pack_blocks")
    if s11 != tc.encode(native, device="cpu"):
        raise AssertionError("encode: card and CPU streams differ")
    if gd.decode_many([s11]) != [native]:
        raise AssertionError("encode: device decode is not exact")
    if tc.encode(native, len(s11), device=dev) != s11:
        raise AssertionError("encode: exact out_capacity changed the stream")
    raised = False
    try:
        tc.encode(native, len(s11) - 1, device=dev)
    except ValueError:
        raised = True
    if not raised:
        raise AssertionError("encode: one byte short did not raise")
    modes11 = block_modes(s11)
    rnd = np.random.default_rng(21).integers(0, 256, 3 * 65536).astype(
        np.uint8)
    s_rnd = tc.encode(rnd, device=dev)
    if s_rnd != tc.encode(rnd, device="cpu") or block_modes(s_rnd) != [0] * 3:
        raise AssertionError("random 3 x 64 KiB: not the CPU's or not COPY")
    log(f"phase 11: encode {len(native)} B -> {len(s11)} B (CR "
        f"{len(native) / len(s11):.4f}; {modes11.count(1)} HUFF, "
        f"{modes11.count(0)} COPY, {modes11.count(2)} FILL blocks), equal to "
        f"the CPU's, decoded exactly on the card; out_capacity exact gives "
        f"the same bytes, one byte less raises; 3 x 64 KiB random: all COPY, "
        f"equal to the CPU's")
    for k in ck.KERNELS:
        k.launches = 0
    hist_m = main_x["hist"].cpu().numpy()
    st_blk = tc.entropy_streams_blocks(main_x["tokw"], main_x["bwords"],
                                       hist_m, plane_len, 3, {})
    torch.cuda.synchronize()
    esb_launches = {k.__name__: k.launches for k in ck.KERNELS}
    log(f"phase 11: entropy_streams_blocks launches {esb_launches}")
    if esb_launches["pack_blocks_tokw"] != 1 or esb_launches["pack_flat"]:
        raise AssertionError("entropy_streams_blocks: not one "
                             "pack_blocks_tokw")
    st_flat, _ = tc.entropy_streams(main_x["tokw"], main_x["bwords"], hist_m,
                                    plane_len, 3, {})
    if not st_blk == st_flat == main_streams:
        raise AssertionError("entropy_streams_blocks differs from the flat "
                             "path")
    log("phase 11: entropy_streams_blocks on the main pass 1 equals "
        "entropy_streams and the main container's streams")

    # phase 12: the windows routes of the flat pack on the main pass 1,
    # compact_tokens there alone, and the growth rule at bps < 4
    routes = {
        "fused": lambda: tc.pack_tokens_fused(
            main_x["tokw"], main_x["bases"], plan.T, main_gl),
        "windows": lambda: tc.pack_tokens_windows(
            main_x["tokw"], main_x["bases"], plan.T, main_gl),
        "compact": lambda: ck.compact_tokens(main_x["tokw"],
                                             main_x["bases"], plan.T),
    }
    route_launches, route_out = {}, {}
    for route, fn in routes.items():
        for k in ck.KERNELS:
            k.launches = 0
        route_out[route] = fn()
        torch.cuda.synchronize()
        route_launches[route] = {k.__name__: k.launches for k in ck.KERNELS
                                 if k.launches}
    log(f"phase 12: launches {route_launches}")
    want_launches = {
        "fused": {"compact_tokens": 1, "windows_place_flat": 1},
        "windows": {"compact_tokens": 1, "group_windows": 1,
                    "place_windows_aligned": 1},
        "compact": {"compact_tokens": 1}}
    if route_launches != want_launches:
        raise AssertionError(f"routes launched {route_launches}")
    for route in ("fused", "windows"):
        if route_streams(tc, main_x, route_out[route], plane_len,
                         3) != main_streams:
            raise AssertionError(f"{route} route: not the main container's "
                                 "streams")
    equal("compact_tokens main", route_out["compact"], main_x["tokc"])
    for k in range(10):    # the look-back carry does not depend on tickets
        equal(f"compact_tokens main, launch {k}",
              ck.compact_tokens(main_x["tokw"], main_x["bases"], plan.T),
              main_x["tokc"])
    if len(comp) != 782762:
        raise AssertionError(f"main container {len(comp)} B, not 782,762")
    f1_cases = ((1, [-1, -1], 1, 18), (2, [0, 32767, -32768, 0], 2, 39),
                (3, [0, 2 ** 23 - 1, -2 ** 23, 0], 3, 58))
    for bps, vals, want_planes, want_size in f1_cases:
        v = np.array(vals, np.int64)
        nat = np.stack([(v >> (8 * k)) & 255 for k in range(bps)],
                       -1).astype(np.uint8).tobytes()
        pc = packers.new_xdelta_hzr(bps, 1, len(vals), 1)
        c12 = pc.compress(nat)
        if (c12 != packers.new_xdelta_hzr(bps, 1, len(vals), 1, device="cpu")
                .compress(nat) or (pc.nr_planes, len(c12))
                != (want_planes, want_size) or pc.decompress(c12)[0] != nat):
            raise AssertionError(f"bps {bps} growth: {pc.nr_planes} planes, "
                                 f"{len(c12)} B")
    log(f"phase 12: pack_tokens_fused ({main_gl.ng} groups, "
        f"{tuple(route_out['fused'].shape)} words) and pack_tokens_windows "
        f"({tuple(route_out['windows'].shape)} words) give the main "
        "container's streams; compact_tokens equals its plain version on "
        "the main pass 1 in 10 more launches; the main container is "
        "782,762 B; bps 1/2/3 growth "
        "from 1 plane gives 1/2/3 planes and 18/39/58 B, equal to the CPU, "
        "exact round trips")

    # phase 13: the host runtime against its plain versions
    check_runtime({
        "main": (comp, 3, 0, plane_len),
        "Hadamard": (c_had, 3, 3 * ch, ch * n3),
        "hzr": (c_hzr, 4, 0, plane_len)}, hist_m, plane_len)

    # phase 4: timings at main-path shapes
    u8_2 = torch.from_numpy(np.frombuffer(to_native(sig >> 16, 2), np.uint8)
                            .copy()).to(dev)
    x = main_x
    e = x["enc"]
    tokw, hist = x["tokw"], x["hist"]
    nb = tokw.shape[0]
    huff = torch.from_numpy(plan.ntok > 0).to(dev)
    n_huff = int(huff.sum())
    n = ch * ns
    ntok_total = int(plan.ntok.sum())
    pk_args = (x["tokc"], x["bases"], x["ntok"], x["bit0"], x["lut"],
               plan.nwords)
    valid = ((tokw >> 27) & 1) != 0
    sym_idx = (torch.where(valid, tokw & 511, 261).to(torch.int64)
               + 262 * torch.arange(nb, device=dev)[:, None]).reshape(-1)
    tok_huff = tokw[huff]
    valid_huff = valid[huff]
    # ops: a nominal count of integer operations per element, an
    # estimate; every kernel's byte bound is the larger
    rows = {
        "xdelta_swizzle": dict(
            replaces="rspt_tpu/ops/pallas_kernels.py:1615",
            source="rspt_tpu_torch/ops/csrc/xdelta.cu",
            fn=lambda: ck.xdelta_swizzle(words, ns, ch, 3, 4),
            plain=lambda: ck.xdelta_swizzle_plain(words, ns, ch, 3, 4, True),
            library=None,
            bytes=2 * 4 * n + 4, ops=8 * n),
        # the native bytes at bps 2, one plane: the flag on
        "xdelta_swizzle_u8": dict(
            replaces="rspt_tpu/ops/pallas_kernels.py:1615",
            source="rspt_tpu_torch/ops/csrc/xdelta.cu",
            kernel="xdelta_swizzle_kernel",
            fn=lambda: ck.xdelta_swizzle(u8_2, ns, ch, 1, 2),
            plain=lambda: ck.xdelta_swizzle_plain(u8_2, ns, ch, 1, 2, True),
            library=None,
            bytes=2 * n + 4 * n + 4, ops=10 * n),
        "tokenize_planes": dict(
            replaces="rspt_tpu/ops/pallas_kernels.py:1813",
            source="rspt_tpu_torch/ops/csrc/tokenize.cu",
            fn=lambda: ck.tokenize_planes(e, 3),
            plain=lambda: ck.tokenize_planes_plain(e, 3),
            library=lambda: torch.bincount(sym_idx, minlength=nb * 262),
            bytes=4 * n + nb * 4 * (65536 + 16384 + 261),
            ops=nb * 65536 * 30),
        "compact_tokens": dict(     # K3 and X2
            replaces="rspt_tpu/ops/pallas_kernels.py:1237; "
                     "tools/exp_compact.py:137",
            source="rspt_tpu_torch/ops/csrc/compact.cu",
            fn=lambda: ck.compact_tokens(tokw, x["bases"], plan.T),
            plain=lambda: ck.compact_tokens_plain(tokw, x["bases"], plan.T),
            library=lambda: torch.masked_select(tok_huff, valid_huff),
            bytes=4 * n_huff * 65536 + 4 * plan.T + 4 * nb,
            ops=n_huff * 65536 * 6),
        "pack_flat": dict(
            replaces="rspt_tpu/ops/pallas_kernels.py:835",
            source="rspt_tpu_torch/ops/csrc/pack_flat.cu",
            fn=lambda: ck.pack_flat(*pk_args),
            plain=lambda: ck.pack_flat_plain(*pk_args),
            library=None,
            bytes=4 * ntok_total + nb * (4 * 261 + 16) + 4 * plan.nwords,
            ops=ntok_total * 30),
    }
    # decode rows: the main path's batch (10 tiles, 14 HUFF blocks)
    d_emis, d_counts, _, d_stats = dec
    d_steps = d_stats[:, 0]
    pa = place_inputs(gd, dla, d_counts, d_stats, dev)
    payload_b = sum(int(b[0].size) for b in dblocks)
    lut_b = sum(4 * (256 + sum(lv.size for lv in b[6])) for b in dblocks)
    emis_b = int(d_steps.sum()) * 4096
    n_sym = symbols_decoded(d_emis, d_counts, d_steps)
    nl = ntiles * 1024
    # the library yardstick: one index_put_ of the pre-masked literals
    em = d_emis.reshape(ntiles, -1, 1024)
    s_ix = torch.arange(em.shape[1], device=dev)[None, :, None]
    e_pos = pa[1].reshape(ntiles, 1, 1024).long() + (em >> 9)
    lit = ((s_ix < d_steps.reshape(-1, 1, 1)) & ((em & 0x1FF) != 0)
           & pa[3].reshape(ntiles, 1, 1024)
           & (e_pos < pa[2].reshape(ntiles, 1, 1024)))
    lit_pos, lit_val = e_pos[lit], (em[lit] & 0xFF).to(torch.uint8)
    n_placed = int(lit.sum())
    lib_out = torch.zeros(dtotal, dtype=torch.uint8, device=dev)
    launches = {**launches, "xdelta_swizzle_u8": u8_launches,
                "hzr_decode": dd_launches["hzr_decode"],
                "place_literals": dd_launches["place_literals"],
                "pack_flat_lanes": hint_launches["pack_flat_lanes"],
                "fwht": had_launches["fwht"]}
    rows["hzr_decode"] = dict(
        replaces="rspt_tpu/hzr/pallas_decoder.py:644",
        source="rspt_tpu_torch/ops/csrc/hzr_decode.cu",
        fn=lambda: ck.hzr_decode(*dargs),
        plain=lambda: ck.hzr_decode_plain(*dargs), plain_reps=2,
        library=None,
        # payload and LUTs read once; emission rows, counts, entries
        # and stats written once
        bytes=payload_b + lut_b + emis_b + 8 * nl + 20 * ntiles,
        ops=40 * n_sym)
    rows["place_literals"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:1405",
        source="rspt_tpu_torch/ops/csrc/place_literals.cu",
        fn=lambda: ck.place_literals(d_emis, *pa, dtotal),
        plain=lambda: ck.place_literals_plain(
            d_emis, *pa, torch.zeros(dtotal, dtype=torch.uint8, device=dev)),
        library=lambda: lib_out.index_put_((lit_pos,), lit_val),
        # emission rows below the step counts and lane metadata read
        # once, each literal byte stored once (the COPY, FILL and
        # zero-run bytes are not this kernel's work)
        bytes=emis_b + 9 * nl + 4 * ntiles + n_placed,
        ops=8 * emis_b // 4)
    # fwht at config 3: the centred signal the Hadamard compress gives it
    cen3 = hadamard_input(native, ch, dev, n3)
    rows["fwht"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:56",
        source="rspt_tpu_torch/ops/csrc/fwht.cu",
        kernel="fwht_kernel",
        fn=lambda: ck.fwht(cen3),
        plain=lambda: ck.fwht_plain(cen3),
        library=None,
        # x read once, out written once (no copy of x: out of place)
        bytes=2 * 4 * ch * n3, ops=ch * n3 * 14)
    nl_h = main_x["lanes"][1].numel()
    rows["pack_flat_lanes"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:871,1569",
        source="rspt_tpu_torch/ops/csrc/pack_flat.cu",
        fn=lambda: ck.pack_flat_lanes(*pk_args, *main_x["lanes"]),
        plain=lambda: ck.pack_flat_lanes_plain(*pk_args, *main_x["lanes"]),
        library=None,
        # pack_flat's bytes, the lane meta and init plane read and the
        # entry lanes written once
        bytes=rows["pack_flat"]["bytes"] + 12 * nb + 8 * nl_h,
        ops=ntok_total * 34)
    # the per-block packs: every token slot read once (four int32 fields
    # or one token word), the LUTs and description bit counts read once,
    # the rows and bit totals written once
    nb11, nb_m = k13a_args[0].shape[0], main_x["tokw"].shape[0]
    row_b = 4 * ck.blocks_nwords(65536)
    launches.update(pack_blocks=enc_launches["pack_blocks"],
                    pack_blocks_tokw=esb_launches["pack_blocks_tokw"])
    rows["pack_blocks"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:507",
        source="rspt_tpu_torch/ops/csrc/pack_blocks.cu",
        fn=lambda: ck.pack_blocks(*k13a_args),
        plain=lambda: ck.pack_blocks_plain(*k13a_args),
        library=None,     # no PyTorch call computes a Huffman bit pack
        bytes=nb11 * (4 * 4 * 65536 + 4 * 261 + 4 + row_b + 4),
        ops=nb11 * 65536 * 30)
    rows["pack_blocks_tokw"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:558",
        source="rspt_tpu_torch/ops/csrc/pack_blocks.cu",
        fn=lambda: ck.pack_blocks_tokw(*k13b_args),
        plain=lambda: ck.pack_blocks_tokw_plain(*k13b_args),
        library=None,
        bytes=nb_m * (4 * 65536 + 4 * 261 + 4 + row_b + 4),
        ops=nb_m * 65536 * 30)
    # the windows kernels at the main pass 1's 83 groups: every input
    # read once and every output written once
    gl = main_gl
    flat_m = x["tokc"].reshape(1, -1)
    win_m = ck.group_windows(flat_m, gl.lut3)
    glue_m = ck.windows_glue(*win_m, gl.dbg, gl.wog, gl.gfirst,
                             gl.nrows_windows, ck.AR2)
    k15_m = (x["tokc"].reshape(-1, 128), gl.lut3, gl.dbg, gl.wog, gl.gfirst,
             gl.ng, gl.nrows_fused)
    nc_m = gl.ng * ck.R_TV
    nsup_m = nc_m // ck.SUP_CHUNKS
    tok_lut_b = 4 * plan.T + gl.ng * 4 * 384    # tokens and LUTs
    for k in ("group_windows", "place_windows_aligned", "windows_place_flat"):
        launches[k] = route_launches["windows" if k != "windows_place_flat"
                                     else "fused"][k]
    rows["group_windows"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:782",
        source="rspt_tpu_torch/ops/csrc/windows.cu",
        fn=lambda: ck.group_windows(flat_m, gl.lut3),
        plain=lambda: ck.group_windows_plain(flat_m, gl.lut3),
        library=None,     # no PyTorch call builds bit windows
        bytes=tok_lut_b + nc_m * (2 * 512 + 8) + 4 * gl.ng,
        ops=plan.T * 30)
    rows["place_windows_aligned"] = dict(
        replaces="tools/exp_place.py:157",
        source="rspt_tpu_torch/ops/csrc/windows.cu",
        fn=lambda: ck.place_windows_aligned(*glue_m, gl.nrows_windows),
        plain=lambda: ck.place_windows_aligned_plain(*glue_m,
                                                     gl.nrows_windows),
        library=None,
        bytes=nc_m * (2 * 512 + 8) + 12 * nsup_m + 512 * gl.nrows_windows,
        ops=nc_m * 256 * 4)
    rows["windows_place_flat"] = dict(
        replaces="rspt_tpu/ops/pallas_kernels.py:1023",
        source="rspt_tpu_torch/ops/csrc/windows.cu",
        fn=lambda: ck.windows_place_flat(*k15_m),
        plain=lambda: ck.windows_place_flat_plain(*k15_m),
        library=None,
        # K14's inputs and dbg, wog, gfirst in, the rows out
        bytes=tok_lut_b + 12 * gl.ng + 512 * gl.nrows_fused,
        ops=plan.T * 40)
    log(f"phase 4: pack_flat_lanes' own bytes beyond pack_flat: "
        f"{12 * nb + 8 * nl_h} B ({nl_h} lanes), bound "
        f"{(12 * nb + 8 * nl_h) / HBM_BYTES_PER_S * 1e3:.6f} ms")
    huff_out_b = sum(int(b[4]) for b in dblocks)
    pair_bound = (payload_b + huff_out_b) / HBM_BYTES_PER_S * 1e3
    log(f"phase 4: decode batch: {len(dblocks)} HUFF blocks, {payload_b} B "
        f"of payload, {n_sym} symbols, {int(lit.sum())} literals placed, "
        f"{huff_out_b} B decoded; bound of the pair (payload read and "
        f"decoded bytes written once) {pair_bound:.6f} ms")
    # occupancy of the two kernels redesigned for the whole card
    lib = ck._lib()
    per_cta = 8 // lib.rspt_hzr_decode_cluster()
    tok_tile = 65536 // lib.rspt_tokenize_tiles()
    limits = [min(65536, e.numel() - j * 65536)
              for j in range(-(-e.numel() // 65536))]
    log(f"phase 4: hzr_decode at the main path: {ntiles} clusters (one a "
        f"tile) of {8 // per_cta} CTAs, {ntiles * 8 // per_cta} CTAs of "
        f"{128 * per_cta} threads ({per_cta} row(s) a CTA); "
        f"tokenize_planes: {len(limits) * (65536 // tok_tile)} blocks of "
        f"{tok_tile} positions, {sum(-(-n // tok_tile) for n in limits)} "
        f"working (slab lengths {limits})")
    fw_cl = lib.rspt_fwht_cluster(14)
    pb_tile = lib.rspt_pack_blocks_tile()
    log(f"phase 4: fwht at config 3 ({ch} x {n3}): {ch} clusters (one a "
        f"row) of {fw_cl} CTAs, {ch * fw_cl} CTAs of {n3 // fw_cl} words, "
        f"{lib.rspt_fwht_launches(14)} launch; pack_blocks: "
        f"{nb11 * -(-65536 // pb_tile)} working tiles of {pb_tile} slots "
        f"({nb11} blocks of the main payload as one stream), "
        f"pack_blocks_tokw: {nb_m * -(-65536 // pb_tile)} ({nb_m} blocks of "
        f"the main pass 1), a CTA a tile")
    pf_tile = lib.rspt_pack_flat_tile()
    pf_work = sum(-(-int(n) // pf_tile) for n in plan.ntok)
    log(f"phase 4: pack_flat / pack_flat_lanes at the main path: a grid of "
        f"{-(-plan.T // pf_tile) + nb} CTAs of {pf_tile} tokens, {pf_work} "
        f"working over {n_huff} HUFF blocks (at most "
        f"{-(-int(plan.ntok.max()) // pf_tile)} tiles a block)")
    kernels = [measure_row(name, r, launches) for name, r in rows.items()]
    # the supers K15's timed calls sent to its slow path (X1 has none)
    for k in kernels:
        if k["name"] == "windows_place_flat":
            k["slow_supers"] = int(ck.windows_place_flat.last_slow)
        elif k["name"] == "place_windows_aligned":
            k["slow_supers"] = None
    log(f"phase 4: windows_place_flat's slow-path supers in its timed "
        f"calls: {int(ck.windows_place_flat.last_slow)} of "
        f"{2 * main_gl.ng}")
    # K1's device operations a call: its kernel and nothing else
    k1_ops = {name: device_ops(rows[name]["fn"])
              for name in ("xdelta_swizzle", "xdelta_swizzle_u8")}
    log(f"phase 4: device operations of 30 calls (names, a call) {k1_ops}")
    if any(len(kinds) != 1 or "xdelta_swizzle_kernel" not in kinds[0]
           or per > 1 for kinds, per in k1_ops.values()):
        raise AssertionError(f"xdelta_swizzle: {k1_ops}: not one kernel "
                             "a call")
    # K14: one device operation a call, its kernel (no memset)
    k14_ops = device_ops(rows["group_windows"]["fn"])
    k14_tile = lib.rspt_group_windows_tile()
    log(f"phase 4: group_windows: device operations of 30 calls (names, a "
        f"call) {k14_ops}; {main_gl.ng} groups in tiles of {k14_tile} "
        f"tokens, {main_gl.ng * ck.GROUP_TOK // k14_tile} CTAs")
    if (len(k14_ops[0]) != 1 or "group_windows_kernel" not in k14_ops[0][0]
            or k14_ops[1] > 1):
        raise AssertionError(f"group_windows: {k14_ops}: not one kernel a "
                             "call")
    # the kernels redesigned last: device times of the whole call,
    # medians of 5 rounds, beside their rounds
    for name in ("xdelta_swizzle", "xdelta_swizzle_u8", "fwht",
                 "pack_blocks", "pack_blocks_tokw", "group_windows"):
        r = rows[name]
        ts = [device_ms(r["fn"]) or cuda_ms(r["fn"]) for _ in range(5)]
        row = next(k for k in kernels if k["name"] == name)
        row.update(ms=statistics.median(ts))
        log(f"phase 4: {name} medians of 5: {row['ms']:.6f} ms "
            f"[{min(ts):.6f}, {max(ts):.6f}], bound {row['bound_ms']:.6f} "
            f"ms ({row['ms'] / row['bound_ms']:.1f}x); rounds "
            f"{[round(t, 6) for t in ts]}")
    # the kernels against their library yardsticks, in turns (device
    # times of the whole call, medians of 5 rounds)
    for name in ("tokenize_planes", "compact_tokens", "place_literals"):
        measure_in_turns(name, rows[name],
                         next(k for k in kernels if k["name"] == name))
    # host stages and end to end
    crc_s = wall_s(lambda: crc32c(np.frombuffer(comp, np.uint8)), reps=3)
    enc_s = wall_s(lambda: p.compress(native))
    enc_stages = dict(p.stage_seconds)
    dec_s = wall_s(lambda: p.decompress(comp), reps=2)
    dec_stages = dict(p.stage_seconds)
    for bps, (pk, small) in small_packers.items():
        sb_s = wall_s(lambda: pk.compress(small))
        log(f"phase 4: bps {bps} compress {sb_s:.4f} s (median of 3), "
            f"stages of the last {pk.stage_seconds}")
    log(f"phase 4: host stages, first compress {comp_stages}")
    log(f"phase 4: host stages, compress (last of 3) {enc_stages}")
    log(f"phase 4: host stages, decompress (last of 2) {dec_stages}")
    log(f"phase 4: crc32c over the {len(comp)} B container: {crc_s:.4f} s")
    log(f"phase 4: end to end compress {enc_s:.4f} s, decompress "
        f"{dec_s:.4f} s (median wall, {len(native)} B payload)")
    log(f"phase 4: device-decode decompress {dd_s:.4f} s (median of 3), "
        f"stages of the first {dd_stages}, of the last {dd_stages_t}; "
        f"hinted {hd_s:.4f} s, stages {hd_stages}; first hinted decode "
        f"(cross-checked against the unhinted one) {hd_first_s:.4f} s, "
        f"stages {hd_first_stages}")
    fw20 = torch.from_numpy(fw_cases["1x1048576"]).to(dev)
    fw20_ms = device_ms(lambda: ck.fwht(fw20), reps=10)
    log(f"phase 4: fwht at 1 x 2^20 (a global pass, then a cluster "
        f"launch): {'not measured' if fw20_ms is None else f'{fw20_ms:.4f}'}"
        f" ms of device time a call, "
        f"{cuda_ms(lambda: ck.fwht(fw20), reps=10):.4f} ms a call")
    # the new paths' wall times, medians of 3 [min, max]
    had_c = wall_times(lambda: ph.compress(nat3))
    had_c_st = dict(ph.stage_seconds)
    had_d = wall_times(lambda: ph.decompress(c_had))
    had_d_st = dict(ph.stage_seconds)
    had_dd = wall_times(lambda: phd.decompress(c_had))
    had_dd_st = dict(phd.stage_seconds)
    log(f"phase 4: Hadamard compress {spread(had_c)} s {had_c_st}; "
        f"decompress {spread(had_d)} s {had_d_st}; device-decode decompress "
        f"{spread(had_dd)} s {had_dd_st}")
    hzr_c = wall_s(lambda: pz.compress(native))
    hzr_c_st = dict(pz.stage_seconds)
    hzr_d = wall_s(lambda: pz.decompress(c_hzr))
    hzr_d_st = dict(pz.stage_seconds)
    hzr_dd = wall_s(lambda: pzd.decompress(c_hzr))
    hzr_dd_st = dict(pzd.stage_seconds)
    log(f"phase 4: hzr compress {hzr_c:.4f} s {hzr_c_st}; decompress "
        f"{hzr_d:.4f} s {hzr_d_st}; device-decode decompress {hzr_dd:.4f} s "
        f"{hzr_dd_st}")
    cw, cwh = [], []
    for _ in range(5):      # in turns: compress, compress_with_hints
        cw.append(wall_s(lambda: pw.compress(native), reps=1))
        cwh.append(wall_s(lambda: pw.compress_with_hints(native), reps=1))
    gd._hint_registry.clear()
    log(f"phase 4: compress {statistics.median(cw):.4f} s against "
        f"compress_with_hints {statistics.median(cwh):.4f} s (medians of 5 "
        f"in turns), stages of the last with hints {pw.stage_seconds}")
    enc11 = wall_times(lambda: tc.encode(native, device=dev))
    st11 = {}
    t11 = time.perf_counter()
    pk11, tb11, fl11 = tc.encode_blocks_device(blk11, len11, dev, st11)
    t11b = time.perf_counter()
    tc.assemble(blk11, len11, pk11, tb11, fl11)
    st11["assemble"] = time.perf_counter() - t11b
    log(f"phase 4: encode {spread(enc11)} s (median of 3 [min, max], "
        f"{len(native)} B as "
        f"one stream); stages of a staged run {st11} "
        f"({t11b - t11 + st11['assemble']:.4f} s)")
    eb_t, ef_t = [], []
    st_b, st_f = {}, {}
    for _ in range(3):      # in turns: per-block pack, flat pack
        eb_t.append(wall_s(lambda: tc.entropy_streams_blocks(
            main_x["tokw"], main_x["bwords"], hist_m, plane_len, 3, st_b),
            reps=1))
        ef_t.append(wall_s(lambda: tc.entropy_streams(
            main_x["tokw"], main_x["bwords"], hist_m, plane_len, 3, st_f),
            reps=1))
    log(f"phase 4: main pass-1 streams: entropy_streams_blocks "
        f"{spread(eb_t)} s {st_b} against entropy_streams {spread(ef_t)} s "
        f"{st_f} (medians of 3 [min, max] in turns, stages of the last)")
    # phase 14 and its timings last, so that the DCT packers' 64 MiB
    # tables (host and device) are built after the earlier paths' walls
    dct_path = check_dct_path(packers, ck, edges, sig, native, ch, dev)
    kernels += time_dct(ck, dct_path)
    # phase 15 and its timings: the streaming path at BASELINE config 5
    stream = check_stream_path(ck, edges, sig, native, ch, dev)
    kernels += time_stream(ck, stream, native, ch, dev)
    # phase 16 and its timings: the batch signal ops at 12 x 2^20
    del stream
    sp = check_signal_path(ck, edges, dev)
    kernels += time_signal(ck, sp)
    # phase 17: sharding, on 1, 2 and 4 shards of the card and across two
    # processes
    del sp
    torch.cuda.empty_cache()
    shard = check_shard_path(ck, tc, gd, packers, tops, native, words, comp,
                             main_streams, s11, rnd, s_rnd, plan.ntok > 0,
                             ch, ns, dev)
    check_gloo_processes()
    time_shard_path(tc, gd, packers, native, main_streams, shard, ch, ns,
                    dev, smi)
    # phase 18: the LZ4 plane backend on every packer, and its walls
    del shard
    check_lz4_path(packers, ck, sig, native, comp, ch, ns, dev, smi)
    # phase 19: the all-host engine against the card, and its walls
    check_native_engine(packers, ck, sig, native, ch, ns, smi)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-worker"]:
        sys.exit(gloo_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
