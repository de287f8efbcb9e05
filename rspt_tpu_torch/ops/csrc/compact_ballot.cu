// compact_tokens_ballot: order-preserving compaction of each row's valid
// token words (bit 27 set) to a host-given flat base, by warp ballots.
//
// Replaces X2, tools/exp_compact.py:compact_bf (:136-157; body _bf_kernel
// :59-134), the A/B variant of K3 compact_tokens_pallas that moves each
// 128-token row's valid words left by a 7-step log-shift butterfly
// instead of the MXU rank dots. It computes what K3 and compact_tokens
// (compact.cu) compute: row b's valid words land in order at
// out[bases[b] ...]; a row whose base is < 0 or >= t_total writes nothing,
// and no write goes past t_total.
//
// Design: one 1,024-thread block per row walks it in tiles of 8,192 words.
// Warp w owns words [256 w, 256 w + 256) of a tile and reads them in 8
// rounds of 32 consecutive words (coalesced 128-byte loads); each round's
// __ballot_sync of the valid bit gives every lane its rank among the
// round's valid words, __popc(mask & lanes below). The warps' valid counts
// go through one rspt::block_scan_excl a tile, and the running row count
// carries from tile to tile in a register, as in compact.cu. The TPU's
// butterfly exists because it has no cheap lane gather or scatter; a warp
// ballot is the GPU's direct form of the same rank.
// Bound: bytes - the row words read once, the valid words written once
// (the same bytes as compact_tokens).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;
constexpr int kWarpSpan = 32 * kRounds;  // words a warp owns in a tile

__global__ void __launch_bounds__(kThreads)
compact_tokens_ballot_kernel(const int32_t* __restrict__ tokw,
                             const int32_t* __restrict__ bases,
                             int32_t* __restrict__ out, int ntok,
                             int t_total) {
  __shared__ int scratch[32];
  __shared__ int tile_total;
  const int b = blockIdx.x;
  const int base = bases[b];
  if (base < 0 || base >= t_total) return;  // whole block: no syncs skipped
  const int32_t* row = tokw + (int64_t)b * ntok;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int carry = base;
  for (int t0 = 0; t0 < ntok; t0 += kTile) {
    int32_t w[kRounds];
    unsigned m[kRounds];
    int cnt = 0;  // the same in every lane of the warp
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int pos = t0 + warp * kWarpSpan + r * 32 + lane;
      w[r] = pos < ntok ? row[pos] : 0;
      m[r] = __ballot_sync(rspt::kFull, (w[r] >> 27) & 1);
      cnt += __popc(m[r]);
    }
    // lane 0 carries its warp's count: the exclusive scan at lane 0 is the
    // count of the warps before this one
    int dst = rspt::block_scan_excl(lane == 0 ? cnt : 0, 0, rspt::OpSum(),
                                    false, scratch, &tile_total);
    dst = carry + __shfl_sync(rspt::kFull, dst, 0);
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if ((m[r] >> lane) & 1) {
        const int d = dst + __popc(m[r] & below);
        if (d < t_total) out[d] = w[r];
      }
      dst += __popc(m[r]);
    }
    carry += tile_total;
  }
}

}  // namespace

// tokw: (nb, ntok) int32; bases: nb int32; out: t_total int32, zeroed by
// the caller. Returns cudaGetLastError().
extern "C" int rspt_compact_tokens_ballot(const void* tokw, const void* bases,
                                          void* out, int nb, int ntok,
                                          int t_total, void* stream) {
  compact_tokens_ballot_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokw, (const int32_t*)bases, (int32_t*)out, ntok,
      t_total);
  return (int)cudaGetLastError();
}
