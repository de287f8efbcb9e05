// compact_tokens: order-preserving compaction of each row's valid token
// words to a host-given flat base.
//
// Replaces two TPU kernels that compute the same function:
//   K3  rspt_tpu/ops/pallas_kernels.py:compact_tokens_pallas (:1237 ->
//       pallas_call :1250; _compact_tokens_kernel, _compact_tile_place
//       :1058-1236), MXU rank dots, butterfly routing and one-hot
//       placement, with an SMEM carry from tile to tile of a row;
//   X2  tools/exp_compact.py:compact_bf (:136 -> pallas_call :143; body
//       _bf_kernel :59-134), the A/B variant that moves each 128-token
//       row's valid words left by a 7-step log-shift butterfly.
// Valid means bit 27 set, or word != 0 under nonzero_valid (the decode
// use). Row b's valid words land in order at out[bases[b] ...]. A row
// whose base is < 0 or >= t_total (the TPU layout's trash span for
// non-HUFF blocks) writes nothing, and no write goes past t_total.
//
// Design. The work unit is one tile of kTile = 4,096 words of one row, a
// 512-thread block each: 16 tiles a 64 KiB row, so the main path's 14
// HUFF rows give 224 working blocks (one 1,024-thread block a row used 14
// of the 132 SMs, and walked its 8 tiles in series). All 21 rows' 336
// blocks are resident at once (4 a SM), so every tile's 16 KiB is
// requested in the first wave. (kernel_ab.py on the H100: tiles of 2,048
// words as fast, of 8,192 (112 working blocks) 1.18x slower; 256 or 1,024
// threads a 4,096-word tile 1.06x / 1.12x slower.) Warp w owns words
// [256 w, 256 w + 256) of its tile and reads them in 8 rounds of 32
// consecutive words (coalesced 128-byte loads, all 8 in flight); each
// round's __ballot_sync of the valid bit gives every lane its rank among
// the round's valid words, __popc(mask & lanes below). The warps' counts
// are scanned by warp 0.
// The row's carry crosses tiles by a single-pass decoupled look-back:
// a block takes its (row, tile) from an atomic ticket, never from
// blockIdx, so it waits only on tiles that already hold an earlier
// ticket and are running (the grid cannot deadlock). It publishes its
// tile's valid count + 1 (0: not yet) as soon as warp 0 has it, before
// any wait, then sums the counts of its row's earlier tiles (at most 15,
// one warp load) and writes its words. The result does not depend on the
// ticket order. A row that writes nothing publishes and leaves before
// loading. The wrapper zeroes the ticket and status words.
// Bound: bytes - the row words read once, the valid words written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kWarpSpan = 32 * kRounds;     // words a warp owns in a tile
constexpr int kTile = kWarps * kWarpSpan;   // 4,096

__global__ void __launch_bounds__(kThreads)
compact_tokens_kernel(const int32_t* __restrict__ tokw,
                      const int32_t* __restrict__ bases,
                      int32_t* __restrict__ out, int* state, int ntok,
                      int tiles, int t_total, int nonzero_valid) {
  __shared__ int s_ticket;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_dst;
  if (threadIdx.x == 0) s_ticket = atomicAdd(state, 1);
  __syncthreads();
  const int b = s_ticket / tiles;
  const int tile = s_ticket - b * tiles;
  int* status = state + 1 + (int64_t)b * tiles;
  const int base = bases[b];
  if (base < 0 || base >= t_total) {  // the same for the whole block
    if (threadIdx.x == 0) atomicExch(status + tile, 1);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int t0 = tile * kTile + warp * kWarpSpan;
  const int32_t* row = tokw + (int64_t)b * ntok;
  int32_t w[kRounds];
  unsigned m[kRounds];
  int cnt = 0;  // the same in every lane of the warp
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int pos = t0 + r * 32 + lane;
    w[r] = pos < ntok ? row[pos] : 0;
    const bool valid = nonzero_valid ? w[r] != 0 : ((w[r] >> 27) & 1);
    m[r] = __ballot_sync(rspt::kFull, valid);
    cnt += __popc(m[r]);
  }
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_warp[lane] : 0;
    const int incl = rspt::warp_scan_incl(v, rspt::OpSum(), false);
    if (lane == 31) atomicExch(status + tile, incl + 1);  // publish
    int sum = 0;  // look back over the row's earlier tiles
    for (int k = lane; k < tile; k += 32) {
      int c;
      while ((c = *(volatile int*)(status + k)) == 0) {
      }
      sum += c - 1;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(rspt::kFull, sum, o);
    if (lane < kWarps) s_warp[lane] = incl - v;
    if (lane == 0) s_dst = (long long)base + sum;
  }
  __syncthreads();
  long long dst = s_dst + s_warp[warp];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if ((m[r] >> lane) & 1) {
      const long long d = dst + __popc(m[r] & below);
      if (d < t_total) out[d] = w[r];
    }
    dst += __popc(m[r]);
  }
}

}  // namespace

// The tiles of a row of ntok words; the wrapper sizes `state` from it.
extern "C" int rspt_compact_tiles(int ntok) {
  return (ntok + kTile - 1) / kTile;
}

// tokw: (nb, ntok) int32; bases: nb int32; out: t_total int32, zeroed by
// the caller; state: 1 + nb * rspt_compact_tiles(ntok) int32, zeroed by
// the caller (the ticket, then each tile's valid count + 1 once known).
// Returns cudaGetLastError().
extern "C" int rspt_compact_tokens(const void* tokw, const void* bases,
                                   void* out, void* state, int nb, int ntok,
                                   int t_total, int nonzero_valid,
                                   void* stream) {
  const int tiles = rspt_compact_tiles(ntok);
  compact_tokens_kernel<<<nb * tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokw, (const int32_t*)bases, (int32_t*)out,
      (int*)state, ntok, tiles, t_total, nonzero_valid);
  return (int)cudaGetLastError();
}
