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
// Design: a CTA of 256 threads takes 256 outputs of one row, a thread an
// output. The taps (up to 256) and the CTA's 256 + ks inputs go to shared
// memory in coalesced loads (xp is read from w and x in place: no
// concatenated copy); each thread then sums its ks products from shared
// memory. Bound: bytes at small ks (x read once, y written once: 8 bytes a
// float sample), the ks multiplies and adds a sample at large ks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 256;

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
__global__ void __launch_bounds__(kThreads)
    fir_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ k, T* __restrict__ y, long n, int ks,
               int fresh) {
  __shared__ T taps[kMaxTaps];
  __shared__ T xs[kThreads + kMaxTaps];
  const long r = blockIdx.y;
  const long t0 = (long)blockIdx.x * kThreads;
  for (int i = threadIdx.x; i < ks; i += kThreads) taps[i] = k[i];
  // xs[q] = xp[t0 + 1 + q] for q < 256 + ks - 1 (0 past xp's end)
  for (int q = threadIdx.x; q < kThreads + ks - 1; q += kThreads) {
    const long j = t0 + 1 + q;
    T v = T(0);
    if (j < ks) v = w[r * ks + j];
    else if (j - ks < n) v = x[r * n + (j - ks)];
    xs[q] = v;
  }
  __syncthreads();
  const long t = t0 + threadIdx.x;
  if (t >= n) return;
  T acc = T(0);
  for (int i = 0; i < ks; ++i)
    acc = add_rn(acc, mul_rn(taps[i], xs[threadIdx.x + i]));
  y[r * n + t] = fresh && t < ks ? T(0) : acc;
}

}  // namespace

// x, y: (rows, n); w: (rows, ks), the oldest first (zeros when fresh);
// k: (ks,) taps; float (dbl = 0) or double (dbl = 1). 1 <= ks <= 256,
// 1 <= rows <= 65,535, n >= 1. Returns cudaGetLastError() after the launch.
extern "C" int rspt_fir_apply(const void* x, const void* w, const void* k,
                              void* y, int rows, long n, int ks, int fresh,
                              int dbl, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), rows);
  if (dbl)
    fir_kernel<double><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)x, (const double*)w, (const double*)k, (double*)y, n,
        ks, fresh);
  else
    fir_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (const float*)k, (float*)y, n, ks,
        fresh);
  return (int)cudaGetLastError();
}
