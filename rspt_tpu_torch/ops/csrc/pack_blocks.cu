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
//   value = code | extra << cbits             (<= 38 bits)
//   bit   = desc_bits[b] + sum of nbits of the earlier slots of row b
// out row b is nwords words; bits at or past word nwords are dropped
// (a block whose payload overflows falls back to COPY and its row is
// never read), but total_bits[b] = desc_bits[b] + sum of nbits is exact
// for every block: the host decides COPY from it.
//
// Design (pack_flat.cu's tiles, on slots instead of compacted tokens): the
// work unit is a tile of kTile = 2,048 slots of one block (256 threads),
// one CTA a tile: 832 working CTAs on the stream encoder's 26 blocks, 672
// on the main pass 1's 21, where one 1,024-thread CTA a block walked 8
// tiles in series on 21-26 SMs. Every block has the same n slots, so
// block b's tiles are CTAs b * tiles .. + tiles - 1 and a CTA's tile in
// its block is the ticket it draws from the block's atomic counter (the
// last tile is partial when n is not a multiple of 2,048). Warps read
// the tile in rounds of 32 consecutive words (the K13a form its four
// arrays in the same rounds) into shared memory in slot order; each
// thread then takes 8 consecutive slots, looks up their LUT words once,
// and a block scan of the threads' bit counts gives each its first bit.
// The tile publishes its bit count at once; warp 0 then carries the
// block's bits across its tiles by the decoupled look-back of common.cuh
// (shared with pack_flat.cu) while every thread ORs its tokens, in order,
// into the tile's words in shared memory from bit 0 (a word at a time,
// as each is completed; only the prefix's bit offset is unknown, and the
// store shifts the words by it). The block's last tile writes
// total_bits[b] from its inclusive prefix. The words go out coalesced,
// the first and last with a global atomicOr (a neighbouring tile or the
// description may share them); nothing is written at or past nwords. The
// wrapper zeroes the rows, the tickets and the status words in one
// memset. A tile's words fit the shared buffer for every LUT with cbits
// <= 23 (host_tables' limit) and any 4-bit ebits; a tile past it stops
// the launch (__trap) rather than write outside the buffer.
// kernel_ab.py on the H100, against this design (K13a / K13b): one
// ticket counter for all tiles 1.03x / 1.05x slower; tiles of 4,096
// slots 1.04x / 1.02x (512 threads) and 1.49x / 1.03x (256 threads);
// registers for 2-4 resident CTAs an SM instead of 8 in the K13a form
// 1.22x (a second wave of CTAs); the first design (a token a thread in
// 32-slot rounds, a shared atomicOr a field, the look-back before the
// word build) 1.43x / 1.26x.
// Bound: bytes - the token arrays read once (4 x 4 B a slot for K13a,
// 4 B for K13b), the LUTs and description bit counts read once, the rows
// and bit totals written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinCtasFields = 8;            // resident CTAs an SM: K13a
constexpr int kMinCtasTokw = 2;              // K13b
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kWarpSpan = 32 * kRounds;      // slots a warp owns
constexpr int kTile = kWarps * kWarpSpan;    // 2,048 slots
constexpr int kNSym = 261;
constexpr int kMaxBits = 38;                 // cbits <= 23, ebits <= 15
constexpr int kWords = kTile * kMaxBits / 32 + 2;  // a tile's words

struct Args {
  const int32_t* f[4];    // syms, extras, ebits, tvalid; tokw in f[0]
  const int32_t* lut;
  const int32_t* desc_bits;
  uint32_t* out;
  int32_t* total_bits;
  int* ticket;                    // a tile ticket counter a block
  unsigned long long* status;     // a word a tile, blocks in order
  int n, nwords, tiles;           // slots, words and tiles a block
};

constexpr int kItems = kTile / kThreads;  // consecutive slots a thread packs

struct Smem {
  alignas(16) int32_t tok[kTile];  // the tile's token words, in slot order
  uint32_t words[kWords];
  int32_t lut[kNSym];
  int scan[32];
  long long prefix;               // the block's bits before the tile
  int total;                      // the tile's bits
  int ticket;
};

// Slot `at` as a token word: the K13b form reads it as it is, the K13a
// form builds it from its four field arrays.
template <bool kTokw>
__device__ __forceinline__ int32_t load_token(const Args& a, int64_t at) {
  const int32_t w = __ldg(a.f[0] + at);
  if (kTokw) return w;
  return (w & 511) | ((__ldg(a.f[2] + at) & 15) << 9) |
         ((__ldg(a.f[1] + at) & 16383) << 13) |
         ((__ldg(a.f[3] + at) != 0) << 27);
}

// A token's bits under its LUT word e (0 for a slot without bits).
__device__ __forceinline__ int slot_bits(int32_t w, uint32_t e) {
  return (int)(e >> 24) + ((w >> 9) & 15);
}

// OR the bits of a thread's consecutive tokens v (e: their LUT words, 0
// for a slot without a token), from bit pos of the tile's bits, into the
// tile's shared words, each word as it is completed (a thread's first
// and last words may hold its neighbours' bits).
__device__ __forceinline__ void pack_run(uint32_t* words, int pos,
                                         const int32_t (&v)[kItems],
                                         const uint32_t (&e)[kItems]) {
  int wi = pos >> 5;
  int used = pos & 31;    // bits of word wi below the next token
  uint32_t cur = 0;       // those bits
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int nb = slot_bits(v[k], e[k]);
    if (!nb) continue;
    const uint64_t val = (uint64_t)(e[k] & 0xFFFFFFu) |
                         ((uint64_t)((v[k] >> 13) & 16383) << (e[k] >> 24));
    // the token's bits in word wi and the two after it
    const uint32_t lo = (uint32_t)val, hi = (uint32_t)(val >> 32);
    uint32_t t0 = cur | lo << used;
    uint32_t t1 = __funnelshift_l(lo, hi, used);
    const uint32_t t2 = __funnelshift_l(hi, 0u, used);
    const int end = used + nb;  // < 70
    if (end >= 32) {
      atomicOr(words + wi++, t0);
      t0 = t1;
      t1 = t2;
      if (end >= 64) {
        atomicOr(words + wi++, t0);
        t0 = t1;
      }
    }
    cur = t0;
    used = end & 31;
  }
  if (used) atomicOr(words + wi, cur);
}

template <bool kTokw>
__device__ __forceinline__ void pack_tile(const Args& a, Smem& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // block b's tiles are CTAs b * tiles .. + tiles - 1; their order is
  // the order of the tickets they draw from the block's counter
  const int b = blockIdx.x / a.tiles;
  if (tid == 0) s.ticket = atomicAdd(a.ticket + 2 * b, 1);
  for (int k = tid; k < kWords; k += kThreads) s.words[k] = 0;
  __syncthreads();
  const int t = s.ticket;
  const int g = b * a.tiles + t;   // the tile's status word
  const int rem = a.n - t * kTile;  // >= 8 slots from here
  const int64_t at = (int64_t)b * a.n + (int64_t)t * kTile;
  const int i0 = warp * kWarpSpan + lane;       // tile-relative slot
  int32_t w[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = i0 + r * 32;
    w[r] = i < rem ? load_token<kTokw>(a, at + i) : 0;
  }
  for (int k = tid; k < kNSym; k += kThreads)
    s.lut[k] = a.lut[(int64_t)b * kNSym + k];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) s.tok[i0 + r * 32] = w[r];
  __syncthreads();
  // this thread's kItems consecutive slots (a slot without bits as 0),
  // their LUT words, bits and first bit
  int32_t v[kItems];
  uint32_t e[kItems];
#pragma unroll
  for (int k = 0; k < kItems; k += 4) {
    const int4 q = *reinterpret_cast<const int4*>(s.tok + tid * kItems + k);
    v[k] = q.x;
    v[k + 1] = q.y;
    v[k + 2] = q.z;
    v[k + 3] = q.w;
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int sym = v[k] & 511;
    const bool live = ((v[k] >> 27) & 1) && sym < kNSym;
    e[k] = live ? (uint32_t)s.lut[sym] : 0u;
    v[k] = live ? v[k] : 0;
    sum += slot_bits(v[k], e[k]);
  }
  const int off = rspt::block_scan_excl(sum, 0, rspt::OpSum(), false, s.scan,
                                        &s.total);
  // the tile's count goes out at once; warp 0 looks back while the
  // others build the tile's words from bit 0 (the prefix only shifts them)
  if (s.total > kWords * 32 - 32) __trap();  // outside the contract
  if (warp == 0) {
    if (lane == 0) rspt::publish(a.status, g, t, s.total);
    const long long prefix = rspt::look_back(a.status, g, t, s.total);
    if (lane == 0) {
      s.prefix = prefix;
      if (t == a.tiles - 1)
        a.total_bits[b] = (int32_t)(a.desc_bits[b] + prefix + s.total);
    }
  }
  pack_run(s.words, off, v, e);
  __syncthreads();
  const int64_t tile_bit = a.desc_bits[b] + s.prefix;
  const int s0 = (int)(tile_bit & 31);
  rspt::store_tile(s.words, (int)(((long long)s0 + s.total + 31) >> 5),
                   a.out + (int64_t)b * a.nwords, tile_bit >> 5, a.nwords,
                   s0);
}

__global__ void __launch_bounds__(kThreads, kMinCtasFields)
pack_blocks_kernel(Args a) {
  __shared__ Smem s;
  pack_tile<false>(a, s);
}

__global__ void __launch_bounds__(kThreads, kMinCtasTokw)
pack_blocks_tokw_kernel(Args a) {
  __shared__ Smem s;
  pack_tile<true>(a, s);
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

Args make_args(const void* lut, const void* desc_bits, void* out,
               void* total_bits, void* state, int nb, int n, int nwords) {
  Args a{};
  a.lut = (const int32_t*)lut;
  a.desc_bits = (const int32_t*)desc_bits;
  a.out = (uint32_t*)out;
  a.total_bits = (int32_t*)total_bits;
  a.ticket = (int*)state;  // one 64-bit word a block
  a.status = (unsigned long long*)state + nb;
  a.n = n;
  a.nwords = nwords;
  a.tiles = tiles_of(n);
  return a;
}

}  // namespace

// int32 words of the state buffer rspt_pack_blocks takes: a 64-bit word
// a block for its tile ticket, then a 64-bit status word a tile.
extern "C" int rspt_pack_blocks_state(int nb, int n) {
  return 2 * nb * (1 + tiles_of(n));
}

// Slots a tile (a CTA's work unit).
extern "C" int rspt_pack_blocks_tile() { return kTile; }

// syms, extras, ebits, tvalid: (nb, n) int32, n a multiple of 8 up to
// 65,536; lut: (nb, 261) int32; desc_bits: nb int32; out: (nb, nwords)
// words, zeroed by the caller (a zero contribution is never written);
// total_bits: nb int32, every one written; state:
// rspt_pack_blocks_state(nb, n) int32, 8-byte aligned, zeroed by the
// caller. Returns cudaGetLastError().
extern "C" int rspt_pack_blocks(const void* syms, const void* extras,
                                const void* ebits, const void* tvalid,
                                const void* lut, const void* desc_bits,
                                void* out, void* total_bits, void* state,
                                int nb, int n, int nwords, void* stream) {
  Args a = make_args(lut, desc_bits, out, total_bits, state, nb, n, nwords);
  a.f[0] = (const int32_t*)syms;
  a.f[1] = (const int32_t*)extras;
  a.f[2] = (const int32_t*)ebits;
  a.f[3] = (const int32_t*)tvalid;
  pack_blocks_kernel<<<nb * a.tiles, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// rspt_pack_blocks over packed token words tokw: (nb, n) int32.
extern "C" int rspt_pack_blocks_tokw(const void* tokw, const void* lut,
                                     const void* desc_bits, void* out,
                                     void* total_bits, void* state, int nb,
                                     int n, int nwords, void* stream) {
  Args a = make_args(lut, desc_bits, out, total_bits, state, nb, n, nwords);
  a.f[0] = (const int32_t*)tokw;
  pack_blocks_tokw_kernel<<<nb * a.tiles, kThreads, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
