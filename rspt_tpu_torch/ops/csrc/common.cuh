// Shared device helpers for the rspt_tpu_torch kernels (sm_90a).
//
// Block-wide exclusive scans built from warp shuffles plus one shared
// slot per warp. blockDim.x must be a multiple of 32 (every kernel here
// launches 256, 512 or 1024 threads) and every thread of the block must
// call the scan (it synchronises). Then what the two tiled Huffman bit
// packs (pack_flat.cu, pack_blocks.cu) share: the store of a tile's words
// and the decoupled look-back that carries a block's bits across tiles.
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

// ---------------------------------------------------------------------
// cp.async of single elements (iir.cu, peaks.cu)
// ---------------------------------------------------------------------

// One element of kBytes (4 or 8) from gmem into smem; with ok false the
// element is zero-filled (gmem must still be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(gmem), "n"(kBytes), "r"(ok ? kBytes : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// ---------------------------------------------------------------------
// Huffman bit packs in tiles (pack_flat.cu, pack_blocks.cu)
// ---------------------------------------------------------------------

// Store a tile's nw words at word w0 of out (none at or past nwords):
// interior words with plain coalesced stores, the first and last (which a
// neighbouring tile, block or description may share) with a global
// atomicOr. The shared words hold the tile's bits from bit s0 of word 0,
// or from bit 0 (then shifted up by s0 = 1..31 on the way out; word nw - 1
// of them is 0). Every thread of the CTA calls it.
__device__ __forceinline__ void store_tile(const uint32_t* words, int nw,
                                           uint32_t* out, int64_t w0,
                                           int64_t nwords, int s0 = 0) {
  for (int k = threadIdx.x; k < nw; k += blockDim.x) {
    const int64_t gw = w0 + k;
    if (gw >= nwords) break;
    uint32_t v = words[k];
    if (s0) v = v << s0 | (k ? words[k - 1] >> (32 - s0) : 0u);
    if (k == 0 || k == nw - 1) {
      if (v) atomicOr(out + gw, v);
    } else {
      out[gw] = v;
    }
  }
}

// Status words of a single-pass decoupled look-back over tiles: 0 until a
// tile publishes, then flag | bits.
constexpr unsigned long long kAggregate = 1ull << 62;  // a tile's own bits
constexpr unsigned long long kInclusive = 1ull << 63;  // bits through it
constexpr unsigned long long kValue = kAggregate - 1;

// One thread: publish tile g's bit count `total`, tile t of its block
// (the first tile's count is its inclusive prefix).
__device__ __forceinline__ void publish(unsigned long long* status, int g,
                                        int t, int total) {
  atomicExch(status + g, (t ? kAggregate : kInclusive) | (unsigned)total);
}

// Warp 0, after tile g's publish: the bits of its block's earlier tiles
// (t of them, in status slots g - t .. g - 1); publishes tile g's
// inclusive prefix. Every tile publishes its own count before it waits,
// and tiles are numbered by an atomic ticket in launch order, so it waits
// only on tiles held by running CTAs: no deadlock, whatever order the
// CTAs run in.
__device__ inline long long look_back(unsigned long long* status, int g,
                                      int t, int total) {
  const int lane = threadIdx.x & 31;
  if (t == 0) return 0;
  const int first = g - t;
  long long prefix = 0;
  for (int k = g - 1;; k -= 32) {
    const int idx = k - lane;
    unsigned long long v = kInclusive;  // before the block: never summed
    if (idx >= first) {
      while ((v = *(volatile unsigned long long*)(status + idx)) == 0) {
      }
    }
    const unsigned inc = __ballot_sync(kFull, (v & kInclusive) != 0);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    long long add = lane <= stop ? (long long)(v & kValue) : 0;
    for (int o = 16; o; o >>= 1) add += __shfl_xor_sync(kFull, add, o);
    prefix += add;
    if (inc) break;
  }
  if (lane == 0) {
    atomicExch(status + g,
               kInclusive | (unsigned long long)(prefix + total));
  }
  return prefix;
}

}  // namespace rspt
