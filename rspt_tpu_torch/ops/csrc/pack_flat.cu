// pack_flat: Huffman code lookup + block-local exclusive bit scan +
// placement of every token's bits into the flat payload words.
//
// Replaces K4, rspt_tpu/ops/pallas_kernels.py:
// token_group_windows_rows_pallas (_windows_core, :393-504, :818-867),
// the cumsum glue of rspt_tpu/hzr/jax_coder.py:648-670, and K5,
// super_place_flat_pallas (_super_place_body, :599-778); in function also
// K15, token_windows_place_flat_pallas.
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
// Design: one 1024-thread block per HUFF block walks its tokens in tiles
// of 8192 (the TPU group size), 8 consecutive tokens per thread; a block
// exclusive sum of the per-thread bit counts, plus a running carry, gives
// each token its bit. Each token ORs into at most 3 words with atomicOr:
// the fields' bits are disjoint, so OR is order-free and the output is
// deterministic. The TPU's 2-row windows, super merges, MXU prefix dots
// and the cross-group scan glue all exist to avoid scatters, which a GPU
// has. The per-block LUT sits in shared memory.
// Bound: bytes - the compacted tokens read once, the payload written once.
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
  const int b = blockIdx.x;
  const int n = ntok[b];
  if (n <= 0) return;  // whole block: no syncs skipped
  for (int k = threadIdx.x; k < kNSym; k += kThreads)
    slut[k] = lut[(int64_t)b * kNSym + k];
  __syncthreads();

  const int base = tok_base[b];
  const int32_t* toks = tokc + base;
  const int avail = base < 0 ? 0 : ntokc - base;  // tokens readable here
  int64_t carry = bit0[b];
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
                                                scratch, &tile_total);
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
        bit += nb[k];
      }
    }
    carry += tile_total;
  }
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
