// dct: the DCT packer's exact transform pair, the DCT-II with folded
// quantization (dct_forward) and its inverse (dct_inverse), each output
// one serial f64 sum in the reference's order.
//
// Replaces D1 and D2, the JAX package's exact transform: the host's serial
// kernels rn_dct_forward / rn_dct_inverse (rspt_tpu/native/
// rspt_native.cpp:1274, :1290), which it runs on the host because a TPU
// has no f64, and its df32 device path jax_ops.dct_forward_exact /
// dct_inverse_exact (jax_ops.py:362, :386), off by +-1 on about 0.3 per
// mille of samples. No pallas_call.
//
// For a row of n samples (one channel), output i is
//   forward  cvt(scale[i] * S_i), S_i = the sum over x = 0 .. n-1, in
//            that order, of (double)((float)in[x] * tab[x][i]), with
//            tab = COS (COS[x][i] = cos((2x + 1) i pi / 2n), float32 from
//            the host) and scale[i] = cs[i] * ratio1 / quality, f64 from
//            the host (signal_packer_dct.cpp:76-87)
//   inverse  cvt(inv_scale * S_i), S_i as above with (float)in[x]
//            replaced by q[x] = cs[x] * (float)in[x], one float product
//            (hoisted per channel and x as rn_dct_inverse_mt does,
//            rspt_native.cpp:1371-1397), tab = COS transposed (tab[x][i]
//            = COS[i][x]) and inv_scale = ratio1 * quality
//            (signal_packer_dct.cpp:89-100).
// Every product and partial sum is rounded as in the reference: the
// intrinsics __fmul_rn, __dadd_rn and __dmul_rn are never contracted into
// an FMA, whatever the build's -fmad setting. cvt is x86's (int32_t) of a
// double (cvttsd2si): trunc inside the int32 range, INT32_MIN for
// everything else, positive overflow and NaN included; CUDA's own
// conversion saturates instead.
//
// Design: a CTA of 4 warps takes 32 outputs i (a warp's lanes) of 4
// channels, one a warp: a thread sums one output, one f64 chain. The
// sums are serial in x, so the card's parallelism is the ch * n chains
// alone (49,152 at 12 x 4,096: 384 CTAs, 3 an SM, 3 warps on each SM
// sub-partition); more chains a thread (fewer CTAs) was slower: the
// chains' latency, not the f64 rate, sets the pace. The CTA walks x in
// chunks of kX = 128: cp.async copies the next chunk's 128 x 32 table
// words (a row a warp copy, coalesced over i; zero past n) and its
// channels' 128 input words into the other half of a double buffer in
// shared memory while the threads sum the current half (loads into
// registers were sunk by the compiler to their stores, which exposed
// their latency every chunk); after a barrier the landed inputs are
// converted to float in place (and, for the inverse, multiplied by cs)
// once for the 32 threads that use them. Each warp reads 4 x of its
// channel as one broadcast 16-byte load. Past n the inputs are 0 and the
// products +-0, which leave every partial sum unchanged (a sum that starts
// at +0 never becomes -0). The table is read from device memory once and
// the 3 CTAs of an i-tile share it through L2 (all 384 are resident).
// kernel_ab.py on the H100 at 12 x 4,096: 0.0967 ms forward, 0.0988
// inverse; chunks of 64 x 1.07x / 1.24x slower, 8 warps a CTA 1.13x /
// 1.14x, the widening by integer bit operations 1.17x / 1.19x. Without
// the copies after the first chunk 0.061 ms, without the widening 0.063
// (diag). The first design (3 channels a thread, 128 CTAs, chunks staged
// through registers) took 0.159-0.176 ms.
// Bound: operations, the f32 -> f64 conversion of each of ch * n * n
// products (F2F.F64.F32, 16 a clock an SM on sm_90): 2.0e8 of them at
// 12 x 4,096, about 0.048 ms at 1.98 GHz; the table (67 MB read once)
// takes 0.020 ms at 3.35 TB/s and the f64 adds 0.012 ms.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;   // channels a CTA, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;   // outputs i a CTA: a warp's lanes
constexpr int kX = 128;     // x a chunk
constexpr int kRows = kX / kWarps;        // table rows a thread copies
constexpr int kIn = kWarps * kX / kThreads;  // input words a thread copies
static_assert(kX % kWarps == 0 && kX % 32 == 0, "chunk split over threads");

// x86's (int32_t) of a double (cvttsd2si): INT32_MIN out of range.
__device__ __forceinline__ int32_t x86_i32(double s) {
  return (s > -2147483649.0 && s < 2147483648.0) ? __double2int_rz(s)
                                                 : INT32_MIN;
}

// A float32 product as the f64 term of a sum (F2F.F64.F32).
__device__ __forceinline__ double widen(float p) {
  return (double)p;
}

// One 4-byte word from global to shared memory, asynchronously; 0 when
// the source is past the data.
__device__ __forceinline__ void copy4(uint32_t* smem, const void* gmem,
                                      bool valid) {
  if (!valid) {
    *smem = 0;
    return;
  }
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

template <bool kInverse>
__device__ __forceinline__ void dct_body(
    const int32_t* __restrict__ in, int32_t* __restrict__ out,
    const float* __restrict__ tab, const float* __restrict__ cs,
    const double* __restrict__ scale, double inv_scale, int ch, int n) {
  __shared__ __align__(16) uint32_t tab_s[2][kX][kTile];
  __shared__ __align__(16) uint32_t in_s[2][kWarps][kX];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kTile + lane;
  const int il = i < n ? i : n - 1;             // a column the copies may read
  const int c0 = blockIdx.y * kWarps;
  const int chunks = (n + kX - 1) / kX;

  // start the copies of the chunk at x0 into half b
  auto fetch = [&](int x0, int b) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = warp + kWarps * j, x = x0 + r;
      copy4(&tab_s[b][r][lane], tab + (size_t)(x < n ? x : 0) * n + il,
            x < n);
    }
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      const int c = c0 + idx / kX, x = x0 + idx % kX;
      const bool ok = c < ch && x < n;
      copy4(&in_s[b][idx / kX][idx % kX], in + (ok ? (size_t)c * n + x : 0),
            ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // wait for them, then make the landed input words the products' float
  // factors: (float)in[x], or cs[x] * (float)in[x] for the inverse
  auto land = [&](int x0, int b) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const int idx = threadIdx.x + kThreads * j;
      uint32_t* w = &in_s[b][idx / kX][idx % kX];
      float v = __int2float_rn((int32_t)*w);
      if (kInverse) {
        const int x = x0 + idx % kX;
        v = __fmul_rn(cs[x < n ? x : n - 1], v);
      }
      *w = __float_as_uint(v);
    }
    __syncthreads();
  };

  double acc = 0.0;
  fetch(0, 0);
  land(0, 0);
  for (int ck = 0; ck < chunks; ++ck) {
    const int b = ck & 1;
    const bool more = ck + 1 < chunks;
    // the other half was last read before the previous barrier
    if (more) fetch((ck + 1) * kX, b ^ 1);
#pragma unroll
    for (int xx = 0; xx < kX; xx += 4) {
      const uint4 s = *reinterpret_cast<const uint4*>(&in_s[b][warp][xx]);
      const float t0 = __uint_as_float(tab_s[b][xx][lane]);
      const float t1 = __uint_as_float(tab_s[b][xx + 1][lane]);
      const float t2 = __uint_as_float(tab_s[b][xx + 2][lane]);
      const float t3 = __uint_as_float(tab_s[b][xx + 3][lane]);
      acc = __dadd_rn(acc, widen(__fmul_rn(__uint_as_float(s.x), t0)));
      acc = __dadd_rn(acc, widen(__fmul_rn(__uint_as_float(s.y), t1)));
      acc = __dadd_rn(acc, widen(__fmul_rn(__uint_as_float(s.z), t2)));
      acc = __dadd_rn(acc, widen(__fmul_rn(__uint_as_float(s.w), t3)));
    }
    if (more) land((ck + 1) * kX, b ^ 1);
  }
  const int c = c0 + warp;
  if (i < n && c < ch) {
    const double f = kInverse ? inv_scale : scale[i];
    out[(size_t)c * n + i] = x86_i32(__dmul_rn(acc, f));
  }
}

__global__ void __launch_bounds__(kThreads)
    dct_forward_kernel(const int32_t* __restrict__ in,
                       int32_t* __restrict__ out,
                       const float* __restrict__ tab,
                       const double* __restrict__ scale, int ch, int n) {
  dct_body<false>(in, out, tab, nullptr, scale, 0.0, ch, n);
}

__global__ void __launch_bounds__(kThreads)
    dct_inverse_kernel(const int32_t* __restrict__ in,
                       int32_t* __restrict__ out,
                       const float* __restrict__ tab,
                       const float* __restrict__ cs, double inv_scale, int ch,
                       int n) {
  dct_body<true>(in, out, tab, cs, nullptr, inv_scale, ch, n);
}

dim3 grid_of(int ch, int n) {
  return dim3((n + kTile - 1) / kTile, (ch + kWarps - 1) / kWarps);
}

}  // namespace

// CTAs of a launch for (ch, n): ceil(n / 32) * ceil(ch / 4).
extern "C" int rspt_dct_ctas(int ch, int n) {
  const dim3 g = grid_of(ch, n);
  return (int)(g.x * g.y);
}

// sig, out: (ch, n) int32; cos: (n, n) float32, COS[x][i]; scale: (n,)
// f64, the forward's factor of each output. ch, n >= 1 and
// ceil(ch / 4) <= 65,535. Returns cudaGetLastError() after the launch.
extern "C" int rspt_dct_forward(const void* sig, void* out, const void* cos,
                                const void* scale, int ch, int n,
                                void* stream) {
  dct_forward_kernel<<<grid_of(ch, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)sig, (int32_t*)out, (const float*)cos,
      (const double*)scale, ch, n);
  return (int)cudaGetLastError();
}

// coef, out: (ch, n) int32; cos_t: (n, n) float32, the transposed table
// (cos_t[x][i] = COS[i][x]); cs: (n,) float32; inv_scale = ratio1 *
// quality. As rspt_dct_forward otherwise.
extern "C" int rspt_dct_inverse(const void* coef, void* out,
                                const void* cos_t, const void* cs,
                                double inv_scale, int ch, int n,
                                void* stream) {
  dct_inverse_kernel<<<grid_of(ch, n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)coef, (int32_t*)out, (const float*)cos_t,
      (const float*)cs, inv_scale, ch, n);
  return (int)cudaGetLastError();
}
