// pack_blocks: the per-block positional hzr pack. Row b of the token
// arrays holds block b's tokens at their byte positions (a slot with
// no token is invalid); each valid token is Huffman-coded with block
// b's LUT and its bits are placed LSB-first, in slot order, from bit
// desc_bits[b] of row b of the output.
//
// Replaces K13a, rspt_tpu/ops/pallas_kernels.py:
// token_group_windows_pallas (_token_windows_kernel / _windows_core,
// :345-366, :393-504, :506-554; four int32 field arrays), and K13b,
// token_group_windows_tokw_pallas (_tokw_windows_kernel, :369-378,
// :557-596; packed token words), together with what
// rspt_tpu/hzr/jax_coder.py:_pack_tokens_pallas_v2 (:244-306) does after
// them: the XLA scan of the group bit totals and the encode use of K8b,
// super_place_pallas (:599-746). The TPU's 2-row chunk windows, 32-chunk
// supers, MXU byte-quarter prefix dots and its D_CLAMP / ACC_ROWS clamps
// exist because a TPU has no cheap scatter and a sequential grid; none
// of them is carried over.
//
// With e = lut[b][sym] = code | cbits << 24 and a token word
// sym | ebits << 9 | extra << 13 | valid << 27 (the K13a form reads the
// four fields from their own arrays, masked to the same widths):
//   nbits = cbits + ebits   (0 for an invalid slot or sym >= 261)
//   value = code | extra << cbits             (<= 37 bits)
//   bit   = desc_bits[b] + sum of nbits of the earlier slots of row b
// out row b is nwords words; bits at or past word nwords are dropped
// (a block whose payload overflows falls back to COPY and its row is
// never read), but total_bits[b] = desc_bits[b] + sum of nbits is exact
// for every block: the host decides COPY from it.
//
// Design: one 1024-thread block per hzr block walks its n slots in tiles
// of 8192, 8 consecutive slots a thread, read with 16-byte loads; a block
// exclusive sum of the per-thread bit counts plus a running carry gives
// every token its bit. The whole output row (66,052 B at n = 65,536)
// sits in shared memory: tokens OR into it with shared atomicOr (the
// fields' bits are disjoint, so the result is order-free), and the row
// is written out once, zeros included, so the caller needs no memset.
// The LUT sits in shared memory too.
// Bound: bytes - the token arrays read once (4 x 4 B a slot for K13a,
// 4 B for K13b), the LUTs and description bit counts read once, the rows
// and bit totals written once. One block per hzr block keeps nb SMs busy.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kNSym = 261;

__device__ __forceinline__ void load8(const int32_t* __restrict__ p,
                                      int32_t v[kItems]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 c = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// Block b's tokens as packed words: the K13b form reads them as they
// are, the K13a form builds them from its four field arrays.
template <bool kTokw>
__device__ __forceinline__ void load_tokens(
    const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
    const int32_t* __restrict__ f2, const int32_t* __restrict__ f3,
    int64_t at, int32_t w[kItems]) {
  load8(f0 + at, w);
  if (!kTokw) {
    int32_t extra[kItems], ebits[kItems], valid[kItems];
    load8(f1 + at, extra);
    load8(f2 + at, ebits);
    load8(f3 + at, valid);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      w[k] = (w[k] & 511) | ((ebits[k] & 15) << 9) |
             ((extra[k] & 16383) << 13) | ((valid[k] != 0) << 27);
  }
}

template <bool kTokw>
__device__ __forceinline__ void pack_row(
    const int32_t* __restrict__ f0, const int32_t* __restrict__ f1,
    const int32_t* __restrict__ f2, const int32_t* __restrict__ f3,
    const int32_t* __restrict__ lut, const int32_t* __restrict__ desc_bits,
    uint32_t* __restrict__ out, int32_t* __restrict__ total_bits, int n,
    int nwords) {
  extern __shared__ uint32_t srow[];
  __shared__ int32_t slut[kNSym];
  __shared__ int scratch[32];
  __shared__ int tile_total;
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < kNSym; k += kThreads)
    slut[k] = lut[(int64_t)b * kNSym + k];
  for (int k = threadIdx.x; k < nwords; k += kThreads) srow[k] = 0;
  __syncthreads();

  const int64_t row = (int64_t)b * n;
  int64_t carry = desc_bits[b];
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int p0 = t0 + threadIdx.x * kItems;
    int32_t w[kItems], e[kItems];
    int nb[kItems];
    int sum = 0;
    if (p0 < n) {  // n is a multiple of kItems: all 8 slots or none
      load_tokens<kTokw>(f0, f1, f2, f3, row + p0, w);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) w[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
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
        const uint32_t c[3] = {(uint32_t)lo, (uint32_t)(lo >> 32),
                               s ? (uint32_t)(val >> (64 - s)) : 0u};
#pragma unroll
        for (int j = 0; j < 3; ++j)
          if (c[j] && wi + j < nwords) atomicOr(srow + wi + j, c[j]);
        bit += nb[k];
      }
    }
    carry += tile_total;
  }
  __syncthreads();
  uint32_t* dst = out + (int64_t)b * nwords;
  for (int k = threadIdx.x; k < nwords; k += kThreads) dst[k] = srow[k];
  if (threadIdx.x == 0) total_bits[b] = (int32_t)carry;
}

__global__ void __launch_bounds__(kThreads)
pack_blocks_kernel(const int32_t* __restrict__ syms,
                   const int32_t* __restrict__ extras,
                   const int32_t* __restrict__ ebits,
                   const int32_t* __restrict__ tvalid,
                   const int32_t* __restrict__ lut,
                   const int32_t* __restrict__ desc_bits,
                   uint32_t* __restrict__ out,
                   int32_t* __restrict__ total_bits, int n, int nwords) {
  pack_row<false>(syms, extras, ebits, tvalid, lut, desc_bits, out,
                  total_bits, n, nwords);
}

__global__ void __launch_bounds__(kThreads)
pack_blocks_tokw_kernel(const int32_t* __restrict__ tokw,
                        const int32_t* __restrict__ lut,
                        const int32_t* __restrict__ desc_bits,
                        uint32_t* __restrict__ out,
                        int32_t* __restrict__ total_bits, int n, int nwords) {
  pack_row<true>(tokw, nullptr, nullptr, nullptr, lut, desc_bits, out,
                 total_bits, n, nwords);
}

template <typename Kernel>
int smem_limit(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// syms, extras, ebits, tvalid: (nb, n) int32, n a multiple of 8 up to
// 65,536; lut: (nb, 261) int32; desc_bits: nb int32; out: (nb, nwords)
// words, every one written; total_bits: nb int32. Returns the first
// non-zero cudaError.
extern "C" int rspt_pack_blocks(const void* syms, const void* extras,
                                const void* ebits, const void* tvalid,
                                const void* lut, const void* desc_bits,
                                void* out, void* total_bits, int nb, int n,
                                int nwords, void* stream) {
  const size_t smem = (size_t)nwords * sizeof(uint32_t);
  const int err = smem_limit(pack_blocks_kernel, smem);
  if (err) return err;
  pack_blocks_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)syms, (const int32_t*)extras, (const int32_t*)ebits,
      (const int32_t*)tvalid, (const int32_t*)lut, (const int32_t*)desc_bits,
      (uint32_t*)out, (int32_t*)total_bits, n, nwords);
  return (int)cudaGetLastError();
}

// rspt_pack_blocks over packed token words tokw: (nb, n) int32.
extern "C" int rspt_pack_blocks_tokw(const void* tokw, const void* lut,
                                     const void* desc_bits, void* out,
                                     void* total_bits, int nb, int n,
                                     int nwords, void* stream) {
  const size_t smem = (size_t)nwords * sizeof(uint32_t);
  const int err = smem_limit(pack_blocks_tokw_kernel, smem);
  if (err) return err;
  pack_blocks_tokw_kernel<<<nb, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tokw, (const int32_t*)lut, (const int32_t*)desc_bits,
      (uint32_t*)out, (int32_t*)total_bits, n, nwords);
  return (int)cudaGetLastError();
}
