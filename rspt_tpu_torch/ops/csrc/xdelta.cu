// xdelta_swizzle: the channel-major xdelta chain of an interleaved signal
// (layout swizzle, native sample assembly, delta -> offset(-128) -> xor)
// and the verify-and-grow flag, in one kernel and one device operation.
//
// Replaces K1, rspt_tpu/ops/pallas_kernels.py:xdelta_preprocess_pallas
// (:1594-1653), and fuses in the jax_ops.native_to_i32 transpose and
// byte assembly (jax_ops.py:43-69) and the flag of packers/tpu.py:169-174.
//
//   v[j] = sample j % ns of channel j / ns, j = c * ns + s (flat,
//          channel-major): an int32 word, or bps little-endian bytes
//          sign-extended from bit 8 * bps - 1
//   d[j] = v[j] - v[j-1] - 128,  x[j] = d[j] ^ d[j-1]   (int32 wrap,
//   v[-1] = d[-1] = 0; the chain crosses channel boundaries)
//   ok   = sign-extending the low 8 * nr_planes bits of every x leaves
//          its low 8 * bps bits unchanged (1 when nr_planes >= bps)
//
// The flag follows the reference, which decompresses and compares the
// native bps-byte samples (signal_packer_xdelta_hzr.cpp:59-71): their low
// 8 * bps bits depend only on the low 8 * bps bits of the xdelta values.
//
// Input forms: int32 words of the interleaved signal ([s0c0][s0c1]...,
// the '<i4' view at bps 4), or its native bytes at bps 1-4 (uint8). The
// channel-major int32 form (no swizzle) is the interleaved one with one
// channel of n samples: flat tiles with a two-word halo.
//
// Bound: bytes, one read of the input and one write of n int32 (2 x 1.64
// MB on the 12 x 34,199 main path: 0.00098 ms at 3.35 TB/s). At that size
// the time goes to latency and instruction issue, not bandwidth: a launch,
// one round trip to L2 for the loads, two passes through shared memory,
// the flag's atomic. Design:
//  - A CTA takes a tile of S consecutive samples over a band of up to
//    kBand channels: one contiguous span of the input when the band is
//    every channel. S (a multiple of 16) is as small as fills one CTA an
//    SM (tile_samples): 272 samples x 12 channels on the main path, 126
//    CTAs over 132 SMs, none with two tiles to do.
//  - Stage A: 16-byte loads of the span (up to four in flight a thread)
//    when the input is 16-byte aligned, else one sample a load; each input
//    byte is read once. Words go straight to a channel-major buffer (rows
//    of S + 3 words: an odd stride); native bytes are staged as they lie,
//    then each sample is assembled once, sign-extended from bit 8 bps - 1.
//    The halo, each channel's two flat predecessors (see halo()), is
//    fetched while the tile's loads fly. Divisions by small divisors are
//    float products (div_small), with the reciprocals from the host.
//  - Stage B: thread (g, s) computes sample s of kChunk channels from
//    three consecutive words of each row (conflict-free) into registers,
//    and the tile's verdict.
//  - Stage C: the stores, consecutive threads on consecutive samples of a
//    channel: coalesced 4-byte stores (a row starts at c * ns + s0, odd on
//    the main path).
//  - One device operation a call: no memset of ok. Each CTA adds
//    1 + (failed << 32) to a 64-bit ticket counter before its stores (the
//    round trip overlaps them); the CTA that draws the last ticket holds
//    every verdict in the old value, writes ok and resets the counter to
//    0 for the next call. The verdict rides in the atomic itself, so no
//    fence is needed. Without a flag to check (nr_planes >= bps) CTA 0
//    writes ok = 1 and no ticket is drawn.
//  - Concurrent calls: the counter is the caller's (the wrapper keeps one
//    for each device and stream, zeroed once when it is made). Calls on
//    one stream run in order and each leaves the counter at 0; calls on
//    two streams use two counters, so they may overlap. A call must not
//    share its counter with a call that can run at the same time (a CUDA
//    graph replayed on two streams at once would).
//  - A batch of payloads of one shape (the serving path, the vmap of
//    packers/tpu.py:_pass1_xdelta_batch :243-257) is one launch: payload
//    b takes CTAs b * per .. (b + 1) * per - 1 (per = tiles x bands), so
//    no tile straddles two payloads and each payload's chain starts at its
//    own first sample; each payload has its own flag and its own ticket
//    counter, which its last CTA resets. The tile is sized as for one
//    payload on sms / batch SMs, so the batch still makes about one wave.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTileWords = 4096;  // most samples x channels a tile
constexpr int kBand = 32;         // most channels one CTA takes
constexpr int kChunk = 6;         // channels a thread in stage B
constexpr bool kVector = true;    // 16-byte loads where the input allows
constexpr int kMinWaves = 1;      // CTAs an SM, at least

struct Args {
  const uint8_t* in;
  int32_t* out;
  int32_t* ok;
  unsigned long long* ticket;  // a counter a payload, 0 between calls
  int64_t in_stride;   // bytes of one payload's input
  int per;             // CTAs of one payload: tiles x bands
  int ns, ch;
  int u8;     // the input is native bytes (else int32 words)
  int sb;     // bytes of one sample in the input: bps, or 4
  int vec;    // 16-byte loads of a tile's span
  int S;      // samples a tile
  int band;   // channels a band
  int bands;
  int raw_off;     // byte offset of the staged native bytes (sb < 4)
  float inv_band;  // 1 / band
  float inv_s;     // 1 / S
  int check;       // nr_planes < bps: the flag depends on the values
  int sh;          // 32 - 8 * nr_planes
  uint32_t keep;   // the low 8 * bps bits
};

inline int band_of(int ch) { return ch < kBand ? ch : kBand; }

// Channel groups of stage B: a thread takes kChunk channels of a sample.
inline int groups_of(int band) { return (band + kChunk - 1) / kChunk; }

// Samples a tile: a multiple of 16 (a tile's span stays 16-byte aligned)
// with S * band <= kTileWords and S * groups <= kMaxThreads, as few as
// fill whole waves of one CTA an SM, so that no SM takes a tile more
// than another.
inline int tile_samples(int ns, int ch, int sms) {
  const int band = band_of(ch), bands = (ch + band - 1) / band;
  const int a = kTileWords / band, b = kMaxThreads / groups_of(band);
  const int s_max = (a < b ? a : b) / 16 * 16;
  const long long ctas = (long long)((ns + s_max - 1) / s_max) * bands;
  long long waves = (ctas + sms - 1) / sms;
  if (waves < kMinWaves) waves = kMinWaves;
  const int tiles = (int)(waves * sms / bands);
  const int per = (ns + tiles - 1) / tiles;
  return (per + 15) / 16 * 16;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

__device__ __forceinline__ uint32_t sext(uint32_t u, int sb) {
  if (sb >= 4) return u;
  const int sh = 32 - 8 * sb;
  return (uint32_t)((int32_t)(u << sh) >> sh);
}

// Sample e of the interleaved input (element e = s * ch + c).
__device__ __forceinline__ uint32_t load_sample(const Args& a, int64_t e) {
  if (!a.u8) return (uint32_t)__ldg((const int32_t*)a.in + e);
  const uint8_t* p = a.in + e * a.sb;
  uint32_t u = 0;
  for (int k = 0; k < a.sb; ++k) u |= (uint32_t)__ldg(p + k) << (8 * k);
  return sext(u, a.sb);
}

// w / d by a float product, exact for the operands here (w < 4096 with
// d <= 32, or w < 1024 with d <= 1024): (w + 0.5) / d lies at least
// 0.5 / d from an integer, and the product errs by less than 2^-10.
__device__ __forceinline__ int div_small(int w, float inv_d) {
  return __float2int_rz(((float)w + 0.5f) * inv_d);
}

// Threads a CTA: kChunk channels of a sample a thread, whole warps.
inline int threads_of(int S, int band) {
  return (groups_of(band) * S + 31) / 32 * 32;
}

// kWords: samples of 4 bytes, which stage A stores channel-major as they
// arrive; else native bytes of sb < 4, staged as they lie and assembled.
template <bool kWords>
__global__ void __launch_bounds__(kMaxThreads, 1)
    xdelta_swizzle_kernel(Args a) {
  // the payload of this CTA, and the CTA within it
  const int pay = blockIdx.x / a.per;
  const int bid = blockIdx.x - pay * a.per;
  a.in += pay * a.in_stride;
  a.out += (int64_t)pay * a.ns * a.ch;
  a.ok += pay;
  a.ticket += pay;
  extern __shared__ int4 smem[];
  // the tile's samples channel-major, rows of R words (a row for each
  // channel of the stage B groups): the two flat predecessors of the
  // row's first sample (the halo), then S samples; at sb < 4 the native
  // bytes staged after them
  uint32_t* sv = (uint32_t*)smem;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int S = a.S;
  const int R = S + 3;
  const int t = a.bands == 1 ? bid : bid / a.bands;
  const int c0 = (bid - t * a.bands) * a.band;
  const int s0 = t * S;
  const int rows = min(S, a.ns - s0);
  const int cb = min(a.band, a.ch - c0);
  const int n_tile = rows * cb;
  // 1 / cb: the host's for a whole band, else (the last band) here
  const float inv_cb = cb == a.band ? a.inv_band : __frcp_rn((float)cb);

  // stage A: the tile's samples into shared memory, channel-major; the
  // halo fetched while the tile's loads fly: the flat predecessors 2 - h
  // places before (c0 + c, s0), the same channel's samples at s0 >= 2
  // (S >= 16), else the previous channel's last two (ns >= 2) or the
  // first samples of the two channels before (ns = 1)
  auto halo = [&]() {
    for (int u = tid; u < 2 * cb; u += nthreads) {
      const int c = u >> 1, h = u & 1;
      int cc = c0 + c, ss = s0 - 2 + h;
      if (ss < 0) {
        if (a.ns >= 2) {
          cc -= 1;
          ss += a.ns;
        } else {
          cc += ss;
          ss = 0;
        }
      }
      sv[c * R + h] = cc < 0 ? 0u : load_sample(a, (int64_t)ss * a.ch + cc);
    }
  };
  if (a.vec && a.bands == 1) {
    // one span, 16-byte aligned (S * ch * sb is a multiple of 16)
    const int row_b = cb * a.sb;
    const uint8_t* src = a.in + (int64_t)s0 * row_b;
    const int len = n_tile * a.sb;
    const int nv = len >> 4;
    const int4* s4 = (const int4*)src;
    uint8_t* raw = (uint8_t*)smem + a.raw_off;
    int k0 = 0;
    do {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + tid + u * nthreads;
        if (k < nv) v[u] = __ldg(s4 + k);
      }
      if (k0 == 0) halo();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k0 + tid + u * nthreads;
        if (k >= nv) continue;
        if (kWords) {
          // four samples (r, c), (r, c + 1), ...: to their rows
          int r = div_small(4 * k, inv_cb);
          int c = 4 * k - r * cb;
          const uint32_t w[4] = {(uint32_t)v[u].x, (uint32_t)v[u].y,
                                 (uint32_t)v[u].z, (uint32_t)v[u].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sv[c * R + 2 + r] = w[q];
            if (++c == cb) c = 0, ++r;
          }
        } else {
          ((int4*)raw)[k] = v[u];
        }
      }
      k0 += 4 * nthreads;
    } while (k0 < nv);
    if (kWords) {
      for (int w = 4 * nv + tid; w < n_tile; w += nthreads) {
        const int r = div_small(w, inv_cb);
        sv[(w - r * cb) * R + 2 + r] = __ldg((const uint32_t*)src + w);
      }
    } else {
      for (int k = (nv << 4) + tid; k < len; k += nthreads)
        raw[k] = __ldg(src + k);
      __syncthreads();
      // each sample assembled once from two aligned words (the staging
      // has a word of slack after it)
      const uint32_t* raw32 = (const uint32_t*)raw;
      for (int w = tid; w < n_tile; w += nthreads) {
        const int r = div_small(w, inv_cb);
        const int b = w * a.sb;
        const uint32_t u =
            __funnelshift_r(raw32[b >> 2], raw32[(b >> 2) + 1], 8 * (b & 3));
        sv[(w - r * cb) * R + 2 + r] = sext(u, a.sb);
      }
    }
  } else {
    // one sample a load
    halo();
    for (int w = tid; w < n_tile; w += nthreads) {
      const int r = div_small(w, inv_cb);
      const int c = w - r * cb;
      sv[c * R + 2 + r] = load_sample(a, (int64_t)(s0 + r) * a.ch + c0 + c);
    }
  }
  __syncthreads();

  // stage B: thread (g, s) takes sample s of channels g kChunk .. +
  // kChunk - 1: the stencil from its rows (conflict-free: consecutive
  // threads read consecutive words; rows past cb hold garbage, never
  // stored or counted), the values kept in registers
  const int g = div_small(tid, a.inv_s);
  const int s = tid - g * S;
  const int cg = g * kChunk;
  uint32_t x[kChunk];
  uint32_t bad = 0;
  const bool live = s < rows && cg < cb;
  if (live) {
    const uint32_t* p = sv + cg * R + s;
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      x[q] = (p[q * R + 2] - p[q * R + 1] - 128u) ^
             (p[q * R + 1] - p[q * R] - 128u);
    // the chain's start, flat index 0: d[-1] = 0 (and v[-1] = 0)
    if (c0 + cg + s0 + s == 0) x[0] = p[2] - 128u;
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (cg + q < cb)
        bad |= ((uint32_t)((int32_t)(x[q] << a.sh) >> a.sh) ^ x[q]) & a.keep;
  }
  // the ticket drawn before the stores, so its round trip overlaps them
  const int fits = __syncthreads_and(bad == 0 || !a.check);
  unsigned long long old = 0;
  if (tid == 0 && a.check)
    old = atomicAdd(a.ticket, 1ull | ((unsigned long long)!fits << 32));

  // stage C: the stores, coalesced along each channel's row
  if (live) {
    int32_t* out = a.out + (c0 + cg) * a.ns + s0 + s;
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (cg + q < cb) out[q * a.ns] = (int32_t)x[q];
  }
  if (tid != 0) return;
  if (!a.check) {
    if (bid == 0) *a.ok = 1;
  } else if ((unsigned)old == a.per - 1) {
    *a.ok = (old >> 32) + !fits == 0;
    atomicExch(a.ticket, 0ull);
  }
}

}  // namespace

// Samples a tile of a batch of ns x ch payloads on the current device
// (tests size their edges by it): one payload's tile on sms / batch SMs.
inline int batch_tile(int ns, int ch, int batch) {
  const int sms = sm_count() / batch;
  return tile_samples(ns, ch, sms > 0 ? sms : 1);
}

// Samples a tile of ns x ch on the current device (tests size their
// edges by it).
extern "C" int rspt_xdelta_tile(int ns, int ch) { return batch_tile(ns, ch, 1); }

// The same for a batch of payloads.
extern "C" int rspt_xdelta_tile_batch(int ns, int ch, int batch) {
  return batch_tile(ns, ch, batch);
}

// Most channels one CTA takes: more are split into bands.
extern "C" int rspt_xdelta_band() { return kBand; }

// in: `batch` interleaved signals back to back, int32 words (u8 = 0) or
// native bytes at bps (u8 = 1); out: batch x ns * ch int32, each payload
// channel-major; ok: batch int32; ticket: batch uint64 of the caller's
// stream, 0 between calls (see above); vec: in is 16-byte aligned; bps:
// bytes per native sample (1..4). Returns cudaGetLastError().
extern "C" int rspt_xdelta_swizzle_batch(const void* in, void* out, void* ok,
                                         void* ticket, int ns, int ch,
                                         int u8, int vec, int nr_planes,
                                         int bps, int batch, void* stream) {
  Args a;
  a.in = (const uint8_t*)in;
  a.out = (int32_t*)out;
  a.ok = (int32_t*)ok;
  a.ticket = (unsigned long long*)ticket;
  a.ns = ns;
  a.ch = ch;
  a.u8 = u8;
  a.sb = u8 ? bps : 4;
  a.in_stride = (int64_t)ns * ch * a.sb;
  // 16-byte loads need every payload's span aligned
  a.vec = vec && kVector && (batch == 1 || a.in_stride % 16 == 0);
  a.band = band_of(ch);
  a.bands = (ch + a.band - 1) / a.band;
  a.S = batch_tile(ns, ch, batch);
  a.inv_band = 1.0f / a.band;
  a.inv_s = 1.0f / a.S;
  a.raw_off = (4 * groups_of(a.band) * kChunk * (a.S + 3) + 15) & ~15;
  a.check = nr_planes < bps;
  a.sh = 32 - 8 * nr_planes;
  a.keep = bps >= 4 ? 0xffffffffu : (1u << (8 * bps)) - 1u;
  const int tiles = (ns + a.S - 1) / a.S;
  a.per = tiles * a.bands;
  const bool words = a.sb == 4;
  const int smem =
      a.raw_off + (words ? 0 : (a.band * a.S * a.sb + 4 + 15) & ~15);
  auto kernel = words ? xdelta_swizzle_kernel<true>
                      : xdelta_swizzle_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<a.per * batch, threads_of(a.S, a.band), smem,
           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// One payload: in, the interleaved signal; out: ns * ch int32,
// channel-major; ok: one int32; ticket: one uint64 (see
// rspt_xdelta_swizzle_batch).
extern "C" int rspt_xdelta_swizzle(const void* in, void* out, void* ok,
                                   void* ticket, int ns, int ch, int u8,
                                   int vec, int nr_planes, int bps,
                                   void* stream) {
  return rspt_xdelta_swizzle_batch(in, out, ok, ticket, ns, ch, u8, vec,
                                   nr_planes, bps, 1, stream);
}
