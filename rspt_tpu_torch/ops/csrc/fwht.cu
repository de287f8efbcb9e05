// fwht: int32 wraparound Walsh-Hadamard transform along rows of length
// n = 2^k, out of place.
//
// Replaces K12, rspt_tpu/ops/pallas_kernels.py:fwht_pallas (_fwht_kernel,
// :33-83), and computes what jax_ops.fwht (:181-195) computes: every
// stage h = n/2 .. 1 maps (x[i], x[i+h]) to (x[i] + x[i+h], x[i] - x[i+h])
// for each i with bit h clear. The arithmetic is uint32, whose wraparound
// is the int32 two's-complement result (signed overflow is undefined in
// C++). The stages act on different index bits and are exact in Z/2^32,
// so they commute: any order gives the same words.
//
// Design: a CTA of kThreads threads holds kCta = 2,048 consecutive words,
// kItems = 8 a thread, loaded coalesced (word tid + kThreads * r of the
// CTA's span goes to register r): index bits 0-4 lie across a warp's
// lanes, the next kWarpLog across its warps, the top kItemsLog in each
// thread's registers. The register bits run first, then the lane bits by
// __shfl_xor_sync, then the warp bits after one exchange through shared
// memory in which every warp access touches 32 consecutive words (no
// bank conflict, no padding). A row of n > kCta words is a thread-block
// cluster of C = n / kCta CTAs (8 at n = 2^14: 96 CTAs for the Hadamard
// packer's 12 rows, where one 1,024-thread CTA a row ran 12); after its
// own bits each CTA leaves its words in shared memory, the cluster
// synchronises, and each thread reads through distributed shared memory
// the C words of one in-CTA position, runs the top log2(C) stages in
// registers and stores them, coalesced, to the output. A second cluster
// barrier keeps every CTA's shared memory alive until its readers are
// done. Rows of n <= kCta words share a CTA (a partial last CTA masks
// its loads and stores). Rows longer than kReach = 2^15 words (a cluster
// of 16) first take the bits above as passes over global memory: each
// thread runs the stages of up to 5 index bits on the 2^M words that
// differ in them, in registers; the first pass reads x, the rest and the
// cluster launch work on out. x is never written.
// kernel_ab.py on the H100, 12 x 2^14: 5.4x faster than one 1,024-thread
// CTA a row working in place on a copy; against C = 8 and 8 words a
// thread, C = 16 is 1.05x slower, 16 words a thread 1.09x, both 1.11x,
// C = 4 with 16 words 1.27x.
// Bound: bytes, one read of x and one write of out (12 x 2^14 words on
// the Hadamard packer's 12-channel config: 1.57 MB); the adds are
// rows * n * log2(n) and negligible. The global passes add a read and a
// write of the rows each.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCtaLog = 11;        // log2 of the words a CTA holds
constexpr int kItemsLog = 3;       // log2 of the words a thread holds
constexpr int kClusterLogMax = 4;  // clusters of up to 16 CTAs a row
constexpr int kReach = kCtaLog + kClusterLogMax;  // bits of one launch
constexpr int kCta = 1 << kCtaLog;
constexpr int kItems = 1 << kItemsLog;
constexpr int kThreads = kCta / kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpLog = kCtaLog - kItemsLog - 5;
constexpr int kGroups = kItems / kWarps;  // exchange groups a thread
static_assert(kWarps >= 1 && kGroups >= 1, "a thread needs whole groups");

__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b) {
  const uint32_t u = a, w = b;
  a = u + w;
  b = u - w;
}

// The stages h < lim over the N words of v (word j of v sits at index
// offset j times the stride of the bits they span).
template <int N>
__device__ __forceinline__ void wht_regs(uint32_t (&v)[N], int lim) {
#pragma unroll
  for (int h = 1; h < N; h <<= 1) {
    if (h < lim) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (!(j & h)) butterfly(v[j], v[j | h]);
    }
  }
}

// 2^(bits of a row at or above index bit `first`): the stage limit of a
// register group whose lowest bit is `first`, for rows of 2^lb words.
__device__ __forceinline__ int stage_lim(int lb, int first) {
  return lb > first ? 1 << (lb - first) : 1;
}

// x, out: rows of 2^lb words (lb <= kCtaLog, C == 1) or of C * kCta words
// (lb == kCtaLog), total words in all; out may be x.
template <int C>
__global__ void __launch_bounds__(kThreads)
fwht_kernel(const uint32_t* x, uint32_t* out, int64_t total, int lb) {
  __shared__ uint32_t s[kCta];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * kCta;
  uint32_t v[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + tid + r * kThreads;
    v[r] = i < total ? x[i] : 0u;
  }
  wht_regs(v, stage_lim(lb, 5 + kWarpLog));
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k >= lb) break;  // the same in every thread
    const bool upper = lane & (1 << k);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const uint32_t p = __shfl_xor_sync(rspt::kFull, v[r], 1 << k);
      v[r] = upper ? p - v[r] : v[r] + p;
    }
  }
  if (lb <= 5) {  // rows of at most 32 words: done within the warp
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int64_t i = base + tid + r * kThreads;
      if (i < total) out[i] = v[r];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kItems; ++r) s[tid + r * kThreads] = v[r];
  __syncthreads();
  // group k of this thread: the kWarps words at lane + 32 w + kThreads rr
  uint32_t u[kGroups][kWarps];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int at = lane + kThreads * (warp * kGroups + k);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) u[k][w] = s[at + 32 * w];
    wht_regs(u[k], stage_lim(lb, 5));
  }
  if constexpr (C == 1) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int at = lane + kThreads * (warp * kGroups + k);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int64_t i = base + at + 32 * w;
        if (i < total) out[i] = u[k][w];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int at = lane + kThreads * (warp * kGroups + k);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s[at + 32 * w] = u[k][w];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    const int64_t row = base - (int64_t)rank * kCta;  // the cluster's row
    for (int p = tid; p < kCta / C; p += kThreads) {
      const int j = rank * (kCta / C) + p;
      uint32_t c[C];
#pragma unroll
      for (int q = 0; q < C; ++q) c[q] = *cluster.map_shared_rank(s + j, q);
      wht_regs(c, C);
#pragma unroll
      for (int q = 0; q < C; ++q) out[row + (int64_t)q * kCta + j] = c[q];
    }
    cluster.sync();  // no CTA leaves while another reads its words
  }
}

template <int M>
__global__ void fwht_global_kernel(const uint32_t* x, uint32_t* out,
                                   int64_t nthreads, int b0) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nthreads) return;
  const int64_t lo = t & ((int64_t(1) << b0) - 1);
  const int64_t hi = t >> b0;
  const int64_t at = (hi << (b0 + M)) | lo;
  const int64_t stride = int64_t(1) << b0;
  uint32_t v[1 << M];
#pragma unroll
  for (int j = 0; j < (1 << M); ++j) v[j] = x[at + j * stride];
  wht_regs(v, 1 << M);
#pragma unroll
  for (int j = 0; j < (1 << M); ++j) out[at + j * stride] = v[j];
}

int launch_global(const uint32_t* x, uint32_t* out, int64_t total, int b0,
                  int m, cudaStream_t stream) {
  const int64_t nthreads = total >> m;
  const int threads = 256;
  const int64_t blocks = (nthreads + threads - 1) / threads;
  switch (m) {
    case 1: fwht_global_kernel<1><<<blocks, threads, 0, stream>>>(x, out, nthreads, b0); break;
    case 2: fwht_global_kernel<2><<<blocks, threads, 0, stream>>>(x, out, nthreads, b0); break;
    case 3: fwht_global_kernel<3><<<blocks, threads, 0, stream>>>(x, out, nthreads, b0); break;
    case 4: fwht_global_kernel<4><<<blocks, threads, 0, stream>>>(x, out, nthreads, b0); break;
    default: fwht_global_kernel<5><<<blocks, threads, 0, stream>>>(x, out, nthreads, b0); break;
  }
  return (int)cudaGetLastError();
}

template <int C>
int launch_rows(const uint32_t* x, uint32_t* out, int64_t total, int lb,
                cudaStream_t stream) {
  const unsigned ctas = (unsigned)((total + kCta - 1) / kCta);
  if constexpr (C == 1) {
    fwht_kernel<1><<<ctas, kThreads, 0, stream>>>(x, out, total, lb);
  } else {
    if (C > 8) {
      const cudaError_t err = cudaFuncSetAttribute(
          fwht_kernel<C>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, fwht_kernel<C>, x, out, total, lb);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// log2 of the CTAs of one row's cluster for rows of 2^log_n words.
int cluster_log(int log_n) {
  const int seg = log_n < kReach ? log_n : kReach;
  return seg > kCtaLog ? seg - kCtaLog : 0;
}

}  // namespace

// Launches rspt_fwht makes for rows of 2^log_n words: one global pass per
// 5 index bits above kReach, then the cluster launch.
extern "C" int rspt_fwht_launches(int log_n) {
  const int over = log_n > kReach ? log_n - kReach : 0;
  return 1 + (over + 4) / 5;
}

// CTAs in the cluster of one row (1: rows of at most 2,048 words share
// a CTA) for rows of 2^log_n words.
extern "C" int rspt_fwht_cluster(int log_n) { return 1 << cluster_log(log_n); }

// x: rows * 2^log_n int32 words (1 <= log_n <= 30), read only; out: as
// many words, the transform of each row. Returns the first non-zero
// cudaError of its launches.
extern "C" int rspt_fwht(const void* x, void* out, int rows, int log_n,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)x;
  uint32_t* dst = (uint32_t*)out;
  const int64_t total = (int64_t)rows << log_n;
  for (int b0 = kReach; b0 < log_n; b0 += 5) {
    const int m = log_n - b0 < 5 ? log_n - b0 : 5;
    const int err = launch_global(src, dst, total, b0, m, st);
    if (err) return err;
    src = dst;
  }
  const int lb = log_n < kCtaLog ? log_n : kCtaLog;
  switch (cluster_log(log_n)) {
    case 0: return launch_rows<1>(src, dst, total, lb, st);
    case 1: return launch_rows<2>(src, dst, total, lb, st);
    case 2: return launch_rows<4>(src, dst, total, lb, st);
    case 3: return launch_rows<8>(src, dst, total, lb, st);
    default: return launch_rows<16>(src, dst, total, lb, st);
  }
}
