// compact_tokens: order-preserving compaction of each row's valid token
// words to a host-given flat base.
//
// Replaces K3, rspt_tpu/ops/pallas_kernels.py:compact_tokens_pallas
// (_compact_tokens_kernel, _compact_tile_place, :1058-1264). Valid means
// bit 27 set, or word != 0 under nonzero_valid (the decode use). Row b's
// valid words land in order at out[bases[b] ...]. A row whose base is
// >= t_total (the TPU layout's trash span for non-HUFF blocks) writes
// nothing, and no write goes past t_total.
//
// Design: one 1024-thread block per row walks it in tiles of 8192 words,
// 8 consecutive words per thread; a block exclusive sum of the per-thread
// valid counts gives each thread its output offset, and the running row
// count carries from tile to tile in a register. The TPU kernel's MXU
// rank dots, butterfly routing and one-hot placement become this scan
// plus plain stores.
// Bound: bytes - the row words read once, the valid words written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
compact_tokens_kernel(const int32_t* __restrict__ tokw,
                      const int32_t* __restrict__ bases,
                      int32_t* __restrict__ out, int ntok, int t_total,
                      int nonzero_valid) {
  __shared__ int scratch[32];
  __shared__ int tile_total;
  const int b = blockIdx.x;
  const int base = bases[b];
  if (base < 0 || base >= t_total) return;  // whole block: no syncs skipped
  const int32_t* row = tokw + (int64_t)b * ntok;
  int carry = base;
  for (int t0 = 0; t0 < ntok; t0 += kTile) {
    int32_t w[kItems];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = t0 + threadIdx.x * kItems + k;
      w[k] = pos < ntok ? row[pos] : 0;
      const bool valid = nonzero_valid ? w[k] != 0 : ((w[k] >> 27) & 1);
      if (!valid) w[k] = 0;
      cnt += valid;
    }
    int dst = carry + rspt::block_scan_excl(cnt, 0, rspt::OpSum(), false,
                                            scratch, &tile_total);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool valid = nonzero_valid ? w[k] != 0 : ((w[k] >> 27) & 1);
      if (valid) {
        if (dst < t_total) out[dst] = w[k];
        ++dst;
      }
    }
    carry += tile_total;
  }
}

}  // namespace

// tokw: (nb, ntok) int32; bases: nb int32; out: t_total int32, zeroed by
// the caller. Returns cudaGetLastError().
extern "C" int rspt_compact_tokens(const void* tokw, const void* bases,
                                   void* out, int nb, int ntok, int t_total,
                                   int nonzero_valid, void* stream) {
  compact_tokens_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokw, (const int32_t*)bases, (int32_t*)out, ntok,
      t_total, nonzero_valid);
  return (int)cudaGetLastError();
}
