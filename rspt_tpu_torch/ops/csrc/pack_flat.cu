// pack_flat: Huffman code lookup + block-local exclusive bit scan +
// placement of every token's bits into the flat payload words; in its
// lanes mode also the decoder's segment entry lanes (decode hints).
//
// Replaces K4, rspt_tpu/ops/pallas_kernels.py:
// token_group_windows_rows_pallas (_windows_core, :393-504, :818-867),
// the cumsum glue of rspt_tpu/hzr/jax_coder.py:648-670, and K5,
// super_place_flat_pallas (_super_place_body, :599-778). The lanes mode
// (pack_flat_lanes_kernel) also replaces K10,
// token_group_windows_grouped_off_pallas (:381-390, :870-904), and K11,
// sidecar_entries_pallas (:1440-1591).
//
// Block b's tokens are tokc[tok_base[b] .. + ntok[b]) (compacted, in
// stream order; ntok[b] = 0 for FILL/COPY/dead blocks). With
// e = lut[b][sym] = code | cbits << 24:
//   nbits = cbits + ebits (0 for an invalid word)
//   value = code | extra << cbits                (<= 37 bits)
//   bit   = bit0[b] + sum of nbits of the block's earlier tokens
// and value lands LSB-first at absolute bit `bit` of `out`, which is
// zeroed by the caller. bit0[b] = 8 * payload offset + description bits,
// so the host OR-merges the tree descriptions afterwards.
//
// Entry lanes: with meta[b] = (W, lane_base, dbits), W = segw * 32 the
// decoder's segment width in bits, a token whose span [x, x + nbits)
// (x = bit - bit0[b], body-relative) crosses a segment boundary,
// floor(x / W) < s = floor((x + nbits) / W), and that is not the block's
// last token writes dbits + x + nbits, the start of the first token at
// or after the boundary s * W, to entries[lane_base + s]. nbits <= 37 < W,
// so each segment gets at most one store: no races. Lanes without a
// store keep what the caller put there; lane_base < 0 skips a block. The
// TPU splits this into K10 (per-token offsets out of the windows kernel)
// and K11 (an MXU placement of the flagged starts) because of its
// windows and one-hot placement; here every token already has its bit.
//
// Design: one 1024-thread block per HUFF block walks its tokens in tiles
// of 8192 (the TPU group size), 8 consecutive tokens per thread; a block
// exclusive sum of the per-thread bit counts, plus a running carry, gives
// each token its bit. Each token ORs into at most 3 words with atomicOr:
// the fields' bits are disjoint, so OR is order-free and the output is
// deterministic. The TPU's 2-row windows, super merges, MXU prefix dots
// and the cross-group scan glue all exist to avoid scatters, which a GPU
// has. The per-block LUT sits in shared memory.
// Bound: bytes - the compacted tokens read once, the payload written once
// (the lanes mode adds the per-block meta read and one int32 per entry
// lane written).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kNSym = 261;

__device__ __forceinline__ void or_word(uint32_t* out, int64_t w,
                                        uint32_t v, int nwords) {
  if (v && w < nwords) atomicOr(out + w, v);
}

template <bool kLanes>
__device__ __forceinline__ void pack_block(
    const int32_t* __restrict__ tokc, const int32_t* __restrict__ tok_base,
    const int32_t* __restrict__ ntok, const int64_t* __restrict__ bit0,
    const int32_t* __restrict__ lut, uint32_t* __restrict__ out,
    const int32_t* __restrict__ meta, int32_t* __restrict__ entries,
    int ntokc, int nwords, int nlanes, int32_t* slut, int* scratch,
    int* tile_total) {
  const int b = blockIdx.x;
  const int n = ntok[b];
  if (n <= 0) return;  // whole block: no syncs skipped
  for (int k = threadIdx.x; k < kNSym; k += kThreads)
    slut[k] = lut[(int64_t)b * kNSym + k];
  __syncthreads();

  const int base = tok_base[b];
  const int32_t* toks = tokc + base;
  const int avail = base < 0 ? 0 : ntokc - base;  // tokens readable here
  const int64_t b0 = bit0[b];
  int W = 1, lane_base = -1, dbits = 0;
  if (kLanes) {
    W = meta[3 * b];
    lane_base = meta[3 * b + 1];
    dbits = meta[3 * b + 2];
  }
  int64_t carry = b0;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    int32_t w[kItems], e[kItems];
    int nb[kItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int pos = t0 + threadIdx.x * kItems + k;
      w[k] = pos < n && pos < avail ? toks[pos] : 0;
      const int sym = w[k] & 511;
      const bool live = ((w[k] >> 27) & 1) && sym < kNSym;
      e[k] = live ? slut[sym] : 0;
      nb[k] = live ? (int)((uint32_t)e[k] >> 24) + ((w[k] >> 9) & 15) : 0;
      sum += nb[k];
    }
    int64_t bit = carry + rspt::block_scan_excl(sum, 0, rspt::OpSum(), false,
                                                scratch, tile_total);
    // the next segment boundary after this thread's first token: one
    // division per thread and tile, then a compare per token (a token
    // crosses at most one boundary, nbits < W)
    int seg = 0, next_b = 0;
    if (kLanes) {
      seg = (int)(bit - b0) / W + 1;
      next_b = seg * W;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (nb[k]) {
        const uint32_t cb = (uint32_t)e[k] >> 24;
        const uint64_t val = (uint64_t)((uint32_t)e[k] & 0xFFFFFFu) |
                             ((uint64_t)((w[k] >> 13) & 16383) << cb);
        const int s = (int)(bit & 31);
        const int64_t wi = bit >> 5;
        const uint64_t lo = val << s;
        or_word(out, wi, (uint32_t)lo, nwords);
        or_word(out, wi + 1, (uint32_t)(lo >> 32), nwords);
        if (s) or_word(out, wi + 2, (uint32_t)(val >> (64 - s)), nwords);
        if (kLanes && lane_base >= 0) {
          // body-relative end, < 2^19: a payload is < 64 KiB
          const int end = (int)(bit - b0) + nb[k];
          if (end >= next_b) {
            const int pos = t0 + threadIdx.x * kItems + k;
            const int64_t lane = (int64_t)lane_base + seg;
            if (pos + 1 < n && lane < nlanes) entries[lane] = dbits + end;
            ++seg;
            next_b += W;
          }
        }
        bit += nb[k];
      }
    }
    carry += *tile_total;
  }
}

__global__ void __launch_bounds__(kThreads)
pack_flat_kernel(const int32_t* __restrict__ tokc,
                 const int32_t* __restrict__ tok_base,
                 const int32_t* __restrict__ ntok,
                 const int64_t* __restrict__ bit0,
                 const int32_t* __restrict__ lut,
                 uint32_t* __restrict__ out, int ntokc, int nwords) {
  __shared__ int32_t slut[kNSym];
  __shared__ int scratch[32];
  __shared__ int tile_total;
  pack_block<false>(tokc, tok_base, ntok, bit0, lut, out, nullptr, nullptr,
                    ntokc, nwords, 0, slut, scratch, &tile_total);
}

__global__ void __launch_bounds__(kThreads)
pack_flat_lanes_kernel(const int32_t* __restrict__ tokc,
                       const int32_t* __restrict__ tok_base,
                       const int32_t* __restrict__ ntok,
                       const int64_t* __restrict__ bit0,
                       const int32_t* __restrict__ lut,
                       uint32_t* __restrict__ out,
                       const int32_t* __restrict__ meta,
                       int32_t* __restrict__ entries, int ntokc, int nwords,
                       int nlanes) {
  __shared__ int32_t slut[kNSym];
  __shared__ int scratch[32];
  __shared__ int tile_total;
  pack_block<true>(tokc, tok_base, ntok, bit0, lut, out, meta, entries,
                   ntokc, nwords, nlanes, slut, scratch, &tile_total);
}

}  // namespace

// tokc: ntokc compacted token words; tok_base, ntok: nb int32; bit0: nb
// int64; lut: (nb, 261) int32; out: nwords payload words, zeroed by the
// caller (a zero contribution is never written, and nothing at or past
// nwords). Returns cudaGetLastError().
extern "C" int rspt_pack_flat(const void* tokc, const void* tok_base,
                              const void* ntok, const void* bit0,
                              const void* lut, void* out, int nb, int ntokc,
                              int nwords, void* stream) {
  pack_flat_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)tok_base, (const int32_t*)ntok,
      (const int64_t*)bit0, (const int32_t*)lut, (uint32_t*)out, ntokc,
      nwords);
  return (int)cudaGetLastError();
}

// rspt_pack_flat's arguments plus meta: (nb, 3) int32 (W, lane_base,
// dbits) and entries: nlanes int32 the caller filled with its init plane
// (nothing is written at or past nlanes). Returns cudaGetLastError().
extern "C" int rspt_pack_flat_lanes(const void* tokc, const void* tok_base,
                                    const void* ntok, const void* bit0,
                                    const void* lut, void* out,
                                    const void* meta, void* entries, int nb,
                                    int ntokc, int nwords, int nlanes,
                                    void* stream) {
  pack_flat_lanes_kernel<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)tok_base, (const int32_t*)ntok,
      (const int64_t*)bit0, (const int32_t*)lut, (uint32_t*)out,
      (const int32_t*)meta, (int32_t*)entries, ntokc, nwords, nlanes);
  return (int)cudaGetLastError();
}
