// fwht: int32 wraparound Walsh-Hadamard transform along rows of length
// n = 2^k, in place.
//
// Replaces K12, rspt_tpu/ops/pallas_kernels.py:fwht_pallas (_fwht_kernel,
// :33-83), and computes what jax_ops.fwht (:181-195) computes: every
// stage h = n/2 .. 1 maps (x[i], x[i+h]) to (x[i] + x[i+h], x[i] - x[i+h])
// for each i with bit h clear. The arithmetic is uint32, whose wraparound
// is the int32 two's-complement result (signed overflow is undefined in
// C++). The stages act on different index bits and are exact in Z/2^32,
// so they commute: any order gives the same words.
//
// Design: a segment of up to 2^15 words (128 KiB) sits in dynamic shared
// memory, one 1024-thread block per segment, and runs its stages there
// with a __syncthreads between them. A row longer than that first takes
// the strides too large for shared memory as passes over global memory:
// each thread loads the 2^M words that differ in M index bits (M <= 5)
// into registers, runs those M stages there and stores them back. The
// TPU's cyclic-roll formulation and 8-row padding are not needed.
// Bound: bytes, one read and one write of the rows (12 x 2^14 words on
// the Hadamard packer's 12-channel config: 1.57 MB); the adds are
// rows * n * log2(n) and negligible. The global passes add a read and a
// write of the rows each.
#include "common.cuh"

namespace {

constexpr int kSmemLog = 15;  // log2 of the longest segment in shared memory

template <int M>
__global__ void fwht_global_kernel(uint32_t* __restrict__ x,
                                   int64_t nthreads, int b0) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nthreads) return;
  const int64_t lo = t & ((int64_t(1) << b0) - 1);
  const int64_t hi = t >> b0;
  uint32_t* p = x + ((hi << (b0 + M)) | lo);
  const int64_t stride = int64_t(1) << b0;
  uint32_t v[1 << M];
#pragma unroll
  for (int j = 0; j < (1 << M); ++j) v[j] = p[j * stride];
#pragma unroll
  for (int h = 1; h < (1 << M); h <<= 1) {
#pragma unroll
    for (int j = 0; j < (1 << M); ++j) {
      if (!(j & h)) {
        const uint32_t u = v[j], w = v[j | h];
        v[j] = u + w;
        v[j | h] = u - w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < (1 << M); ++j) p[j * stride] = v[j];
}

__global__ void fwht_smem_kernel(uint32_t* __restrict__ x, int seg_log) {
  extern __shared__ uint32_t s[];
  const int seg = 1 << seg_log;
  const int half = seg >> 1;
  uint32_t* p = x + (int64_t)blockIdx.x * seg;
  for (int i = threadIdx.x; i < seg; i += blockDim.x) s[i] = p[i];
  __syncthreads();
  for (int h = half; h > 0; h >>= 1) {
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int i = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      const uint32_t u = s[i], w = s[i + h];
      s[i] = u + w;
      s[i + h] = u - w;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < seg; i += blockDim.x) p[i] = s[i];
}

int launch_global(uint32_t* x, int64_t total, int b0, int m,
                  cudaStream_t stream) {
  const int64_t nthreads = total >> m;
  const int threads = 256;
  const int64_t blocks = (nthreads + threads - 1) / threads;
  switch (m) {
    case 1: fwht_global_kernel<1><<<blocks, threads, 0, stream>>>(x, nthreads, b0); break;
    case 2: fwht_global_kernel<2><<<blocks, threads, 0, stream>>>(x, nthreads, b0); break;
    case 3: fwht_global_kernel<3><<<blocks, threads, 0, stream>>>(x, nthreads, b0); break;
    case 4: fwht_global_kernel<4><<<blocks, threads, 0, stream>>>(x, nthreads, b0); break;
    default: fwht_global_kernel<5><<<blocks, threads, 0, stream>>>(x, nthreads, b0); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernels rspt_fwht makes for rows of 2^log_n words: one
// global pass per 5 index bits above kSmemLog, then the shared-memory one.
extern "C" int rspt_fwht_launches(int log_n) {
  const int over = log_n > kSmemLog ? log_n - kSmemLog : 0;
  return 1 + (over + 4) / 5;
}

// x: rows * 2^log_n int32 words, transformed in place along each row
// (1 <= log_n <= 30). Returns the first non-zero cudaError of its launches.
extern "C" int rspt_fwht(void* x, int rows, int log_n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* p = (uint32_t*)x;
  const int64_t total = (int64_t)rows << log_n;
  for (int b0 = kSmemLog; b0 < log_n; b0 += 5) {
    const int m = log_n - b0 < 5 ? log_n - b0 : 5;
    const int err = launch_global(p, total, b0, m, st);
    if (err) return err;
  }
  const int seg_log = log_n < kSmemLog ? log_n : kSmemLog;
  const int seg = 1 << seg_log;
  const size_t smem = (size_t)seg * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        fwht_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  const int threads = seg / 2 < 1024 ? seg / 2 : 1024;
  fwht_smem_kernel<<<total >> seg_log, threads, smem, st>>>(p, seg_log);
  return (int)cudaGetLastError();
}
