// fir: S3 fir_apply, the batched FIR filter with the reference's warm-up
// (fir_filter.cpp:41-60). Replaces rspt_tpu/filters/jax_filters.py
// fir_apply (:134-162), shifted multiply-adds on XLA; no pallas_call.
//
// For each row (one channel) of x and its window w (ks prior samples, the
// oldest first), with xp = w then x:
//   y[t] = the sum over i = 0 .. ks-1, from 0 and in that order, of
//          k[i] * xp[t + i + 1],
// and y[t] = 0 for t < ks when the window is fresh (the reference returns
// 0 until its window fills). Products and sums are rounded as floats or
// doubles of the input's type (__fmul_rn / __fadd_rn, __dmul_rn /
// __dadd_rn: never an FMA), as the plain PyTorch version
// (ops/cuda_kernels.py) rounds them.
//
// Design: a thread sums kR consecutive outputs, a tile of kR * 128
// outputs of one row a CTA of 128 threads at a time. The CTAs stay on the
// card (as many as fit at once) and walk the tiles in turns, with the
// next tile's inputs copied in by cp.async while they sum this one: two
// input buffers in shared memory, each kR * 128 + ks inputs in coalesced
// copies (xp is read from w and x in place: no concatenated copy), with one
// pad word every kR, so that lanes kR inputs apart hit different banks. The
// taps (up to 256) are copied once a CTA. A thread keeps its kR sums and a
// window of kR inputs in registers: each tap costs one broadcast tap load,
// one input load and kR multiplies and adds (the i loop unrolled by kR,
// so the window turns without moves; the last ks % kR taps apart). The
// sums go back through the tile's buffer and out coalesced. Bound: the ks
// multiplies and adds a sample (FP32 instructions) at the detectors' 61 taps;
// bytes (x read once, y written once: 8 bytes a float sample) below about
// 16 taps.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTaps = 256;
constexpr int kR = 16;                 // outputs a thread
constexpr int kOut = kR * kThreads;    // outputs a tile

// An input's place in a buffer: a pad word after every kR.
__host__ __device__ constexpr int padded(int q) { return q + q / kR; }
constexpr int kXs = padded(kOut + kMaxTaps);  // values a buffer

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
constexpr int smem_bytes() {
  return (kMaxTaps + 2 * kXs) * (int)sizeof(T);
}

// Row r's tile of outputs from t0 into xs: xs[padded(q)] = xp[t0 + 1 + q]
// for q < kOut + ks, 0 past xp's end. A tile inside x (most) copies from
// one base at fixed offsets: padded(q + kThreads) = padded(q) + kThreads +
// kThreads / kR.
template <typename T>
__device__ __forceinline__ void fetch(T* xs, const T* __restrict__ x,
                                      const T* __restrict__ w, long r,
                                      long t0, long n, int ks) {
  const int tid = threadIdx.x;
  constexpr int kStep = kThreads + kThreads / kR;
  if (t0 + 1 >= ks && t0 + kOut + 1 <= n) {
    const T* src = x + r * n + (t0 + 1 - ks) + tid;
    T* dst = xs + padded(tid);
#pragma unroll
    for (int i = 0; i < kOut / kThreads; ++i)
      rspt::cp_async_zfill<sizeof(T)>(dst + i * kStep, src + i * kThreads,
                                      true);
    for (int q = kOut + tid; q < kOut + ks; q += kThreads)
      rspt::cp_async_zfill<sizeof(T)>(xs + padded(q), src - tid + q, true);
    return;
  }
  for (int q = tid; q < kOut + ks; q += kThreads) {
    const long j = t0 + 1 + q;
    const T* src = j < ks ? w + r * ks + j : x + r * n + (j - ks);
    rspt::cp_async_zfill<sizeof(T)>(xs + padded(q), j - ks < n ? src : x,
                                    j - ks < n);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ k, T* __restrict__ y, long n, int ks,
               int fresh, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* taps = reinterpret_cast<T*>(smem);
  T* buf0 = taps + kMaxTaps;  // [2][kXs]
  const int tid = threadIdx.x;
  const long nc = (n + kOut - 1) / kOut;  // tiles a row
  for (int i = tid; i < ks; i += kThreads)
    rspt::cp_async_zfill<sizeof(T)>(taps + i, k + i, true);
  // this CTA's tiles: (r, c), then gridDim.x tiles on, row by row
  long r = blockIdx.x / nc, c = blockIdx.x - r * nc;
  auto next = [&](long& rr, long& cc) {
    cc += gridDim.x;
    while (cc >= nc && rr < rows) {
      cc -= nc;
      ++rr;
    }
  };
  if (r < rows) fetch(buf0, x, w, r, c * kOut, n, ks);
  rspt::cp_async_commit();
  for (int b = 0; r < rows; b ^= 1) {
    T* xs = buf0 + b * kXs;
    long rn = r, cn = c;
    next(rn, cn);
    rspt::cp_async_wait<0>();
    // this tile's inputs in; every thread done with the other buffer
    __syncthreads();
    if (rn < rows) fetch(buf0 + (b ^ 1) * kXs, x, w, rn, cn * kOut, n, ks);
    rspt::cp_async_commit();
    // thread tid: outputs t0 + kR tid + q, q < kR; xs[padded(kR tid +
    // q)] = xb[q] for q < kR, and the window of taps i0 .. i0 + kR - 1
    // reads from xb + (kR + 1) * (i0 / kR)
    T* xb = xs + (kR + 1) * tid;
    T acc[kR], win[kR];
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      acc[q] = T(0);
      win[q] = xb[q];
    }
    int i0 = 0;
    for (; i0 + kR <= ks; i0 += kR) {
      // win[(u + q) % kR] = the input of tap i0 + u for output q
      const T* nx = xb + (kR + 1) * (i0 / kR + 1);
#pragma unroll
      for (int u = 0; u < kR; ++u) {
        const T kv = taps[i0 + u];
#pragma unroll
        for (int q = 0; q < kR; ++q)
          acc[q] = add_rn(acc[q], mul_rn(kv, win[(u + q) % kR]));
        win[u] = nx[u];
      }
    }
    {  // the last ks - i0 < kR taps (a uniform branch)
      const T* nx = xb + (kR + 1) * (i0 / kR + 1);
#pragma unroll
      for (int u = 0; u < kR - 1; ++u) {
        if (i0 + u < ks) {
          const T kv = taps[i0 + u];
#pragma unroll
          for (int q = 0; q < kR; ++q)
            acc[q] = add_rn(acc[q], mul_rn(kv, win[(u + q) % kR]));
          win[u] = nx[u];
        }
      }
    }
    __syncthreads();  // every window read: the sums go where the inputs were
#pragma unroll
    for (int q = 0; q < kR; ++q) xb[q] = acc[q];
    __syncthreads();
    const long t0 = c * kOut;
    T* yr = y + r * n + t0;
    if (t0 + kOut <= n && !(fresh && t0 < ks)) {
      constexpr int kStep = kThreads + kThreads / kR;
#pragma unroll
      for (int i = 0; i < kOut / kThreads; ++i)
        yr[tid + i * kThreads] = xs[padded(tid) + i * kStep];
    } else {
      for (int q = tid; q < kOut && t0 + q < n; q += kThreads)
        yr[q] = fresh && t0 + q < ks ? T(0) : xs[padded(q)];
    }
    r = rn;
    c = cn;
  }
}

// As many CTAs of fir_kernel<T> as the current device holds at once, into
// *ctas (asked once a device); the first error. Its shared memory is under
// the 48 KB that needs no opt-in.
template <typename T>
int resident_ctas(int* ctas) {
  static_assert(smem_bytes<T>() <= 48 * 1024, "fir_kernel needs an opt-in");
  static int known[64] = {};
  int dev, sms, per;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && known[dev]) {
    *ctas = known[dev];
    return 0;
  }
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, fir_kernel<T>, kThreads, smem_bytes<T>());
  if (err) return err;
  *ctas = sms * per;
  if (dev < 64) known[dev] = *ctas;
  return 0;
}

template <typename T>
int fir_launch(const void* x, const void* w, const void* k, void* y,
               int rows, long n, int ks, int fresh, cudaStream_t st) {
  const long tiles = rows * ((n + kOut - 1) / kOut);
  int ctas;
  const int err = resident_ctas<T>(&ctas);
  if (err) return err;
  fir_kernel<T><<<(int)(tiles < ctas ? tiles : ctas), kThreads,
                  smem_bytes<T>(), st>>>((const T*)x, (const T*)w,
                                         (const T*)k, (T*)y, n, ks, fresh,
                                         rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, n); w: (rows, ks), the oldest first (zeros when fresh);
// k: (ks,) taps; float (dbl = 0) or double (dbl = 1). 1 <= ks <= 256,
// 1 <= rows <= 65,535, n >= 1. Returns cudaGetLastError() after the launch.
extern "C" int rspt_fir_apply(const void* x, const void* w, const void* k,
                              void* y, int rows, long n, int ks, int fresh,
                              int dbl, void* stream) {
  return dbl ? fir_launch<double>(x, w, k, y, rows, n, ks, fresh,
                                  (cudaStream_t)stream)
             : fir_launch<float>(x, w, k, y, rows, n, ks, fresh,
                                 (cudaStream_t)stream);
}
