// Shared device helpers for the rspt_tpu_torch kernels (sm_90a).
//
// Block-wide exclusive scans built from warp shuffles plus one shared
// slot per warp. blockDim.x must be a multiple of 32 (every kernel here
// launches 256, 512 or 1024 threads) and every thread of the block must
// call the scan (it synchronises).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rspt {

constexpr unsigned kFull = 0xffffffffu;

struct OpSum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct OpMax {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct OpMin {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// Inclusive scan across the 32 lanes of a warp, in lane order
// (reverse=false) or in reverse lane order (reverse=true).
template <typename Op>
__device__ __forceinline__ int warp_scan_incl(int x, Op op, bool reverse) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    int y = reverse ? __shfl_down_sync(kFull, x, o)
                    : __shfl_up_sync(kFull, x, o);
    bool take = reverse ? (lane + o < 32) : (lane >= o);
    x = take ? op(x, y) : x;
  }
  return x;
}

// Exclusive scan of one int per thread over the whole block: the op over
// the values of all threads before this one (reverse=false) or after it
// (reverse=true); `ident` for the first. scratch: 32 ints of shared
// memory. If `total` is not null, the op over all threads is stored there.
template <typename Op>
__device__ int block_scan_excl(int v, int ident, Op op, bool reverse,
                               int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int incl = warp_scan_incl(v, op, reverse);
  int ex = reverse ? __shfl_down_sync(kFull, incl, 1)
                   : __shfl_up_sync(kFull, incl, 1);
  if (reverse ? lane == 31 : lane == 0) ex = ident;
  __syncthreads();  // scratch may still be read by a previous scan
  if (reverse ? lane == 0 : lane == 31) scratch[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? scratch[lane] : ident;
    int s = warp_scan_incl(t, op, reverse);
    int e = reverse ? __shfl_down_sync(kFull, s, 1)
                    : __shfl_up_sync(kFull, s, 1);
    if (reverse ? lane == 31 : lane == 0) e = ident;
    int all = __shfl_sync(kFull, s, reverse ? 0 : 31);
    if (lane < nw) scratch[lane] = e;
    if (lane == 0 && total) *total = all;
  }
  __syncthreads();
  return op(scratch[wid], ex);
}

}  // namespace rspt
