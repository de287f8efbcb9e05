// The TPU's windows form of the flat pack, as three kernels over one body:
//   group_windows          K14, rspt_tpu/ops/pallas_kernels.py:
//                          token_group_windows_grouped_pallas (:781-815;
//                          _tokw_windows_kernel :369-378 over
//                          _windows_core :393-504)
//   place_windows_aligned  X1, tools/exp_place.py:place_aligned (:156-180;
//                          _flat_kernel_aligned :77-154), which is K5,
//                          super_place_flat_pallas (:749-778,
//                          _super_place_body :632-710), with each span
//                          read and written from an 8-row aligned row
//   windows_place_flat     K15, token_windows_place_flat_pallas
//                          (:1021-1055; _tokw_winplace_kernel :907-1018):
//                          K14, the cross-group bit carry and K5 in one
//
// What they compute, as the TPU does. A group is 8,192 compacted tokens of
// one block (token word sym | ebits << 9 | extra << 13 | valid << 27) with
// that block's LUT lut3[g] (384 words code | cbits << 24; sym >= 256 reads
// entry 256 + (sym & 127)); a chunk is 128 tokens, a super 32 chunks.
//   value = code | extra << cbits, nbits = cbits + ebits (0 if not valid)
//   excl  = group-local exclusive bit offset of the token
//   cbase[c] = excl[first token of c] >> 5, clive[c] = any nbits > 0,
//   gtot[g] = the group's bits
//   window c, 256 words: value << (excl & 31) as three words added at
//   loc = min(excl >> 5 - cbase[c], 254) and the next two (index >= 256
//   dropped)
// Placement of a live super (any clive) with d[c] = clip(cbase[c] -
// cbase[first chunk], 0, D_CLAMP), rc = d >> 7, t = d & 127: window word x
// of chunk c is added at word (rc * 128 + t + x) mod N of an accumulator of
// N = R * 128 words (R = 48 for K5/K15, 56 for X1; rc >= R drops it); the
// accumulator, read as one cyclic bit string, is shifted left by sb bits
// and rotated by off words, and word j lands at output word base + j:
// base = (b >> 7) * 128 (X1: the row rounded down to a multiple of 8), off
// = b - base. b and sb come from the group's base bit gb = wog * 8 + dbg +
// the exclusive scan of gtot restarted at the block's first group:
// b = clip((gb >> 5) + cbase[first chunk], 0, (nrows - R) * 128), sb =
// gb & 31 (X1 takes d, b and sb from windows_glue). On real input no clamp
// and no wrap fires: they are replicated so that each kernel agrees with
// its plain version on every input whose supers share at most edge words
// (X1 on every input), and with the TPU kernel where, besides, no two
// chunks overlap in an accumulator (the TPU ORs its byte sums).
//
// Design, K14 (group_windows). A chunk's window depends only on its own
// tokens and on the group-local bit of its first token, so the work unit
// is a tile of 2,048 tokens (16 chunks) of one group, a 256-thread CTA,
// and a group's 4 tiles form a thread-block cluster: 332 CTAs on the main
// pass 1's 83 groups (several a SM), where one 1,024-thread CTA a group
// left 49 of 132 SMs idle and wrote its 64 KiB in a last serial phase. A
// thread takes 8 consecutive tokens (16-byte loads, 16 threads a chunk)
// and codes them from the LUT in shared memory; one barrier gives each
// warp the scan totals of the others. Each tile then pushes its bits into
// the shared memory of the group's higher tiles (distributed shared
// memory) and arrives on their mbarriers; a tile waits only for its lower
// ones (tile 0 never), and CTAs of a cluster run together: no ticket,
// state, memset or spin on global memory, one device operation a call.
// The one cluster barrier, arrived at the start and waited on before the
// first push, only orders the mbarriers' init. A chunk's base word and
// liveness come from its half warp by shuffle and ballot. The 16 windows
// (16 KiB) sit in shared memory and tokens add their words into them with
// shared atomics: the TPU built them with MXU prefix dots, binary
// searches and rolls only because it cannot scatter (its sums are of
// disjoint bits; the atomics add as it does mod 2^32, so out-of-field
// values, cbits up to 63 and the clamped corner agree, and no input needs
// another path). The tile writes its windows out once, zeros included, a
// warp a 512-byte window half; cbase and clive by the tile that holds the
// chunk, gtot by the group's last tile. kernel_ab.py on the H100, config
// 2, against this design: one cluster barrier and remote reads instead of
// the pushes 1.04x slower, each tile recounting its group's earlier
// tokens (no cluster) 1.24x, tiles of 4,096 tokens 1.17x, of 1,024 1.02x,
// a thread's words summed in registers first 0.98x (within the noise),
// windows 264 or 272 words apart the same;
// the cluster's launch alone costs 0.35 µs, the pushes and the wait 0.6.
//
// Design, K15 (windows_place_flat). The windows and the accumulator are
// the TPU's way to place bits without a scatter; on the card each token's
// value is placed at its own bit. The work unit is a tile of 4,096 tokens,
// one super (32 chunks) of one group, a 512-thread CTA: 2 tiles a group,
// 166 CTAs on the main pass 1's 83 groups, where one 1,024-thread CTA a
// group walked its 2 supers in series through ~20 barriers. A CTA takes
// its tile from an atomic ticket, codes its tokens (16-byte loads, the LUT
// in shared memory), scans their bit counts, publishes the tile's bits + 1
// (0: not yet) and sums the published bits of the tiles before it: those
// of its block's earlier groups (gfirst[g] .. g - 1; at most 14 tiles on
// real input, one warp load) give the carry, the group's earlier tile
// gives the super's group-local bit. Tickets are drawn in order and every
// tile publishes before it waits, so a tile waits only on running CTAs
// (no deadlock), and the result does not depend on the ticket order.
// With gb = wog * 8 + dbg + carry (int32 arithmetic) and sbase the
// super's first word, the accumulator path puts every token's value at
// absolute bit gb + its group-local bit as long as no clamp, wrap or
// carry fires; that holds when every valid token has cbits <= 23 (at most
// 38 bits a token: a chunk spans <= 152 window words, a super's chunk
// offsets stay <= 4,713 of D_CLAMP 5,119, nothing wraps the 6,144-word
// accumulator), code < 2^cbits and extra < 2^ebits (disjoint fields, so
// sums are ORs) and 0 <= (gb >> 5) + sbase <= (nrows - 48) * 128 (no base
// clamp). While warp 0 looks back, every thread tests its tokens against
// those fields (without branches) and ORs their words into shared memory
// from the tile's bit 0. A live super (any token with bits) that passes
// every check is then placed directly: its words shifted up by its first
// bit & 31 on the way out, the interior ones stored with plain coalesced
// stores and the first and last, which a neighbouring super may share,
// added with atomicAdd into the zeroed output. A live super that fails
// one takes the exact slow path, place_slow: the accumulator code of the
// one-CTA-a-group design for one super, its 32 windows in shared memory
// (32 KiB), the 48-row accumulator built by shared atomics (24 KiB),
// shifted and rotated in registers, its first and last nonzero words
// found by two block reductions and written as write_span does (edge
// words by atomicAdd, the words between by plain stores, 16-byte vectors
// where aligned); state[1] counts those supers. It reuses the direct
// path's shared memory, so the common case pays only its reservation (56
// KiB a CTA). kernel_ab.py on the H100, config 2: the field test before
// the scan instead of beside the look-back 1.05x slower, with a branch a
// token 1.02-1.05x, the slow path inlined 1.02x.
//
// Design, X1 (place_windows_aligned). One 256-thread CTA a live super
// (several fit an SM). Each accumulator word is a sum of the window words
// that cover it, mod 2^32, the plain version's sum in any order: chunk c's
// window word x covers word (st_c + x) mod N (st_c = rc * 128 + t, N = 56
// * 128; rc >= 56 or < 0 drops the chunk), so thread tid owns the words k
// = tid (mod 256) and takes from each chunk the one word x = (tid - st_c)
// mod 256 whose target is in its column: a gather with no atomics and no
// barrier between chunks, its column in shared memory, each window word
// read once by coalesced loads (a warp reads 32 neighbouring words; a
// thread's 32 loads all in flight before its adds). It is exact on every
// input: non-monotone offsets, dropped chunks, the cyclic wrap and sbits 0
// or 31 need no other path. The shift by sb takes each word and its
// predecessor, the rotation by off = b - base indexes the store, and
// every nonzero word is added into the zeroed output with atomicAdd, so
// even supers whose spans overlap sum as the plain version does.
// kernel_ab.py on the H100, config 2: a block reduction for the span's
// first and last word with plain stores between them 1.2x slower.
// Bound: bytes. K14: the tokens read once, the LUTs, the windows (2 x 512 B
// a chunk), cbase, clive and gtot written once. X1: the windows and glue
// arrays read once, the output words written once. K15: the tokens, LUTs
// and group arrays read once, the output words written once.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kItems = 8;                     // tokens a thread
constexpr int kGroupTok = 8192;               // tokens a group
constexpr int kChunks = 64;                   // 128-token chunks a group
constexpr int kWin = 256;                     // words a chunk window
constexpr int kSupChunks = 32;                // chunks a super
constexpr int kLut = 3 * 128;
constexpr int kDClamp = 40 * 128 - 1;
constexpr int kAccRows = 48;                  // K5 / K15 accumulator rows
constexpr int kAlignedRows = 56;              // X1 accumulator rows
constexpr size_t kAccBytes = sizeof(uint32_t) * kAccRows * 128;
// K14: a tile of a group a CTA
constexpr int kGwThreads = 256;
constexpr int kGwTile = kGwThreads * kItems;          // 2,048 tokens
constexpr int kGwTiles = kGroupTok / kGwTile;         // 4 a group
constexpr int kGwChunks = kGwTile / 128;              // 16 windows
static_assert(kGroupTok % kGwTile == 0 && kGwThreads % 32 == 0 &&
              kGwTiles <= 8, "whole tiles of whole warps, a portable cluster");
// K15: a tile is one super
constexpr int kFlatThreads = 512;
constexpr int kTileTok = kFlatThreads * kItems;         // 4,096 tokens
constexpr int kTilesPerGroup = kGroupTok / kTileTok;    // 2
constexpr int kFastBits = 23 + 15;   // a token's bits on the direct path
// a tile's words on the direct path, rounded to 16-byte quads
constexpr int kTileWords = (kTileTok * kFastBits / 32 + 2 + 3) / 4 * 4;
constexpr size_t kSupWinBytes = sizeof(uint32_t) * kSupChunks * kWin;
constexpr size_t kFlatSmem = kSupWinBytes + kAccBytes;  // 56 KiB
static_assert(sizeof(uint32_t) * kTileWords <= kSupWinBytes,
              "the direct path's words share the slow path's windows");
// X1
constexpr int kX1Threads = 256;
constexpr int kX1Words = kAlignedRows * 128;          // 7,168
constexpr int kX1Per = kX1Words / kX1Threads;         // 28 a thread
static_assert(kX1Words % kWin == 0 && kWin == kX1Threads,
              "a thread's column takes one word of every window");

// The small shared state of one block.
struct Scratch {
  int32_t lut[kLut];
  int cbase[kChunks];
  int clive[kChunks];
  int st[kSupChunks];   // t = d & 127 of each chunk of the super placed
  int src[kSupChunks];  // rc = d >> 7
  int scan[32];
  int total, lo, hi, g, carry, pre;
};

// The thread's 8 tokens of a group, their LUT words, and the group-local
// exclusive bit of the first.
struct Tokens {
  int32_t w[kItems];
  uint32_t e[kItems];
  int bit;
  int sum;
};

__device__ __forceinline__ bool is_valid(int32_t w) { return (w >> 27) & 1; }

// A token's LUT word (0 for an invalid token) and its bits.
__device__ __forceinline__ uint32_t lut_word(const int32_t* lut, int32_t w) {
  const int sym = w & 511;
  return is_valid(w) ? (uint32_t)lut[sym < 256 ? sym : 256 + (sym & 127)]
                     : 0u;
}

__device__ __forceinline__ int token_bits(int32_t w, uint32_t e) {
  return is_valid(w) ? (int)(e >> 24) + ((w >> 9) & 15) : 0;
}

// Adds the words of valid token w (LUT word e) into its chunk's window
// win, whose word 0 is group word cbase: its value from group-local bit
// `bit`, as three words at min(bit >> 5 - cbase, 254) and the next two
// (index 256 dropped).
__device__ __forceinline__ void add_token(uint32_t* win, int32_t w,
                                          uint32_t e, int bit, int cbase) {
  const uint32_t cb = e >> 24;
  const uint64_t val = (uint64_t)(e & 0xFFFFFFu) |
                       ((uint64_t)((w >> 13) & 16383) << cb);
  const int s = bit & 31;
  const int loc = min((bit >> 5) - cbase, kWin - 2);
  const uint64_t lo = val << s;
  const uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);
  const uint32_t c2 = s ? (uint32_t)(val >> (64 - s)) : 0u;
  if (c0) atomicAdd(win + loc, c0);
  if (c1) atomicAdd(win + loc + 1, c1);
  if (c2 && loc + 2 < kWin) atomicAdd(win + loc + 2, c2);
}

// Records each chunk's cbase and clive and adds every token's words into
// its chunk's window.
__device__ __forceinline__ void fill_windows(uint32_t* swin, Scratch& sh,
                                             const Tokens& t) {
  const int chunk = threadIdx.x >> 4;  // 16 threads a chunk
  if ((threadIdx.x & 15) == 0) sh.cbase[chunk] = t.bit >> 5;
  if (t.sum > 0) sh.clive[chunk] = 1;
  __syncthreads();
  uint32_t* win = swin + chunk * kWin;
  const int cbase = sh.cbase[chunk];
  int bit = t.bit;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int32_t w = t.w[k];
    if (!is_valid(w)) continue;
    add_token(win, w, t.e[k], bit, cbase);
    bit += token_bits(w, t.e[k]);
  }
  __syncthreads();
}

// Writes span words (first, last) of a placed super at out word base + j:
// the edge words by atomicAdd, the words between by plain stores. base is
// a multiple of 128 words, so word j is 16-byte aligned where j % 4 == 0.
__device__ __forceinline__ void write_span(const uint32_t* acc, int first,
                                           int last,
                                           uint32_t* __restrict__ out,
                                           int64_t base, int64_t limit) {
  const int tid = threadIdx.x;
  const auto inside = [&](int64_t w) { return w >= 0 && w < limit; };
  if (tid == 0 && inside(base + first)) atomicAdd(out + base + first, acc[first]);
  if (tid == 32 && last != first && inside(base + last))
    atomicAdd(out + base + last, acc[last]);
  const int v0 = (first + 4) >> 2;  // first quad wholly after `first`
  const int v1 = max(last >> 2, v0);  // quads [v0, v1) end before `last`
  for (int j = first + 1 + tid; j < min(4 * v0, last); j += kFlatThreads)
    if (inside(base + j)) out[base + j] = acc[j];
  for (int q = v0 + tid; q < v1; q += kFlatThreads)
    if (inside(base + 4 * q))
      *reinterpret_cast<uint4*>(out + base + 4 * q) =
          reinterpret_cast<const uint4*>(acc)[q];
  for (int j = max(4 * v1, first + 1) + tid; j < last; j += kFlatThreads)
    if (inside(base + j)) out[base + j] = acc[j];
}

// K15's slow path: places one live super through the 48-row accumulator
// acc (shared, 16-byte aligned) from its 32 windows win (shared; chunk
// c's word x at win[c * kWin + x]). Chunk c's t and rc are sh.st[c] and
// sh.src[c], which the caller wrote before calling (the first barrier
// here publishes them).
__device__ __forceinline__ void place_super(const uint32_t* win, int sb,
                                            int b, uint32_t* acc,
                                            uint32_t* __restrict__ out,
                                            int nrows, Scratch& sh) {
  constexpr int kN = kAccRows * 128;
  constexpr int kPer = (kN + kFlatThreads - 1) / kFlatThreads;
  const int tid = threadIdx.x;
  for (int q = tid; q < kN / 4; q += kFlatThreads)
    reinterpret_cast<uint4*>(acc)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < kSupChunks * kWin; i += kFlatThreads) {
    const int c = i >> 8, x = i & (kWin - 1);
    const uint32_t v = win[i];
    const int rc = sh.src[c];
    if (v && rc >= 0 && rc < kAccRows) {
      int k = rc * 128 + sh.st[c] + x;  // < 2 * kN
      if (k >= kN) k -= kN;
      atomicAdd(acc + k, v);
    }
  }
  __syncthreads();
  const int64_t base = (int64_t)(b >> 7) * 128;
  const int off = (int)(b - base);  // < 128
  uint32_t v[kPer];
  int lo = kN, hi = -1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = tid + q * kFlatThreads;
    v[q] = 0;
    if (k < kN) {
      const uint32_t a = acc[k], p = acc[k ? k - 1 : kN - 1];
      v[q] = sb ? (a << sb) | (p >> (32 - sb)) : a;
      if (v[q]) {
        const int j = k + off >= kN ? k + off - kN : k + off;
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = tid + q * kFlatThreads;
    if (k < kN) acc[k + off >= kN ? k + off - kN : k + off] = v[q];
  }
  // both scans synchronise, so the rotated span is visible after them
  rspt::block_scan_excl(lo, kN, rspt::OpMin(), false, sh.scan, &sh.lo);
  rspt::block_scan_excl(hi, -1, rspt::OpMax(), false, sh.scan, &sh.hi);
  if (sh.lo <= sh.hi)
    write_span(acc, sh.lo, sh.hi, out, base, (int64_t)nrows * 128);
}

// K14's signals between the tiles of a cluster (sm_90): an mbarrier in
// each tile's shared memory counts the group's lower tiles that have
// pushed their bits into it.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One thread: an mbarrier expecting n >= 1 arrivals, visible to the
// cluster once the cluster barrier that follows has completed.
__device__ __forceinline__ void init_arrivals(uint64_t* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(n) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Stores v into CTA `rank`'s copy of *slot, then arrives on its copy of
// *bar (release at cluster scope: the store is seen before the arrival).
__device__ __forceinline__ void push_bits(int* slot, uint64_t* bar, int rank,
                                          int v) {
  unsigned s, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(s) : "r"(smem_u32(slot)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(s), "r"(v)
               : "memory");
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(b) : "memory");
}

// Waits until *bar's first phase has completed (acquire at cluster scope).
__device__ __forceinline__ void wait_arrivals(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
}

__global__ void __cluster_dims__(kGwTiles, 1, 1) __launch_bounds__(kGwThreads)
group_windows_kernel(const int32_t* __restrict__ tokc,
                     const int32_t* __restrict__ lut3,
                     int32_t* __restrict__ w0, int32_t* __restrict__ w1,
                     int32_t* __restrict__ cbase, int32_t* __restrict__ clive,
                     int32_t* __restrict__ gtot) {
  __shared__ __align__(16) uint32_t swin[kGwChunks * kWin];  // 16 KiB
  __shared__ int32_t lut[kLut];
  __shared__ int wsum[kGwThreads / 32];
  __shared__ int lower[kGwTiles];  // the group's lower tiles' bits
  __shared__ __align__(8) uint64_t pushed;  // their pushes
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = blockIdx.x / kGwTiles, j = (int)cluster.block_rank();
  if (tid == 0) init_arrivals(&pushed, max(j, 1));
  cluster_arrive_relaxed();
  // the thread's 8 consecutive tokens (16 threads a 128-token chunk)
  const int4* p = reinterpret_cast<const int4*>(
                      tokc + (int64_t)g * kGroupTok + j * kGwTile) + 2 * tid;
  const int4 a = __ldg(p), c = __ldg(p + 1);
  for (int k = tid; k < kLut; k += kGwThreads)
    lut[k] = lut3[(int64_t)g * kLut + k];
  for (int q = tid; q < kGwChunks * kWin / 4; q += kGwThreads)
    reinterpret_cast<uint4*>(swin)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int32_t w[kItems] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  uint32_t e[kItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    e[k] = lut_word(lut, w[k]);
    sum += token_bits(w[k], e[k]);
  }
  const int incl = rspt::warp_scan_incl(sum, rspt::OpSum(), false);
  if (lane == 31) wsum[wid] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kGwThreads / 32; ++k) {
    before += k < wid ? wsum[k] : 0;
    total += wsum[k];
  }
  // the tile's group-local bit: each tile pushes its bits into the
  // shared memory of the group's higher tiles (lane r to rank r, once
  // every tile's barrier is initialised) and waits for its lower ones'
  cluster_wait();
  if (tid > j && tid < kGwTiles) push_bits(&lower[j], &pushed, tid, total);
  if (j > 0) wait_arrivals(&pushed);
  int prefix = 0;
  for (int r = 0; r < j; ++r) prefix += lower[r];
  // the group-local bit of the thread's first token; the chunk's base
  // word and liveness from its 16 threads (a half warp)
  int bit = prefix + before + incl - sum;
  const int half = lane & 16;
  const int base = __shfl_sync(rspt::kFull, bit >> 5, half);
  const unsigned live = __ballot_sync(rspt::kFull, sum > 0) >> half & 0xFFFFu;
  uint32_t* win = swin + (tid >> 4) * kWin;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (!is_valid(w[k])) continue;
    add_token(win, w[k], e[k], bit, base);
    bit += token_bits(w[k], e[k]);
  }
  const int64_t row0 = (int64_t)g * kChunks + j * kGwChunks;
  if ((tid & 15) == 0) {
    cbase[row0 + (tid >> 4)] = base;
    clive[row0 + (tid >> 4)] = live != 0;
  }
  if (j == kGwTiles - 1 && tid == 0) gtot[g] = prefix + total;
  __syncthreads();
  for (int q = tid; q < kGwChunks * kWin / 4; q += kGwThreads) {
    const int ch = q >> 6, x = (q & 63) * 4;  // 64 quads a window
    int32_t* dst = (x < 128 ? w0 : w1) + (row0 + ch) * 128 + (x & 127);
    *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>(swin)[q];
  }
}

__global__ void __launch_bounds__(kX1Threads)
place_windows_aligned_kernel(const uint32_t* __restrict__ w0,
                             const uint32_t* __restrict__ w1,
                             const int32_t* __restrict__ drow,
                             const int32_t* __restrict__ dlane,
                             const int32_t* __restrict__ wbase,
                             const int32_t* __restrict__ sbits,
                             const int32_t* __restrict__ slive,
                             uint32_t* __restrict__ out, int nrows) {
  __shared__ uint32_t acc[kX1Words];   // column tid: words tid + 256 j
  __shared__ int st[kSupChunks];       // chunk c's first word, or -1
  const int s = blockIdx.x;
  if (!slive[s]) return;  // whole block: no barrier skipped
  const int tid = threadIdx.x;
  const int64_t c0 = (int64_t)s * kSupChunks;
  if (tid < kSupChunks) {
    const int rc = dlane[c0 + tid] >> 7;
    st[tid] = rc >= 0 && rc < kAlignedRows
                  ? rc * 128 + (drow[c0 + tid] & 127) : -1;
  }
#pragma unroll
  for (int j = 0; j < kX1Per; ++j) acc[tid + j * kX1Threads] = 0;
  __syncthreads();
  // the window word of each chunk whose target lies in this column (a
  // warp reads 32 neighbouring words of a window), all loads in flight
  // before the adds
  uint32_t v[kSupChunks];
#pragma unroll
  for (int c = 0; c < kSupChunks; ++c) {
    const int x = (tid - st[c]) & (kWin - 1);
    v[c] = st[c] < 0 ? 0u : __ldg((x < 128 ? w0 : w1) + (c0 + c) * 128 +
                                  (x & 127));
  }
#pragma unroll
  for (int c = 0; c < kSupChunks; ++c) {
    if (!v[c]) continue;
    int k = st[c] + ((tid - st[c]) & (kWin - 1));  // = tid (mod 256)
    if (k >= kX1Words) k -= kX1Words;
    acc[k] += v[c];
  }
  __syncthreads();
  const int sb = sbits[s] & 31;
  const int b = wbase[s];
  const int64_t base = (int64_t)((b >> 7) & ~7) * 128;
  const int off = (int)(b - base);  // < 1,024
  uint32_t u[kX1Per];  // every shifted word read before the first add
#pragma unroll
  for (int j = 0; j < kX1Per; ++j) {
    const int k = tid + j * kX1Threads;
    const uint32_t a = acc[k], p = acc[k ? k - 1 : kX1Words - 1];
    u[j] = sb ? (a << sb) | (p >> (32 - sb)) : a;
  }
  const int64_t limit = (int64_t)nrows * 128;
#pragma unroll
  for (int j = 0; j < kX1Per; ++j) {
    if (!u[j]) continue;
    const int k = tid + j * kX1Threads;
    const int64_t gw = base + (k + off >= kX1Words ? k + off - kX1Words
                                                   : k + off);
    if (gw >= 0 && gw < limit) atomicAdd(out + gw, u[j]);
  }
}

// K15's slow path for one live super (every thread of the CTA): its 32
// windows in smem (t.bit: the thread's first token's group-local bit),
// then place_super through the 48-row accumulator after them. Out of
// line: the kernel then keeps 40 registers a thread, not 55.
__device__ __noinline__ void place_slow(Tokens t, int sbase, int gb, int b,
                                        uint32_t* smem,
                                        uint32_t* __restrict__ out,
                                        int nrows, Scratch& sh) {
  const int tid = threadIdx.x;
  for (int q = tid; q < kSupChunks * kWin / 4; q += kFlatThreads)
    reinterpret_cast<uint4*>(smem)[q] = make_uint4(0, 0, 0, 0);
  fill_windows(smem, sh, t);  // its first barrier orders the zeroing
  if (tid < kSupChunks) {
    const int d = min(max(sh.cbase[tid] - sbase, 0), kDClamp);
    sh.st[tid] = d & 127;
    sh.src[tid] = d >> 7;
  }
  place_super(smem, gb & 31, min(max(b, 0), (nrows - kAccRows) * 128),
              smem + kSupChunks * kWin, out, nrows, sh);
}

__global__ void __launch_bounds__(kFlatThreads)
windows_place_flat_kernel(const int32_t* __restrict__ tokc,
                          const int32_t* __restrict__ lut3,
                          const int32_t* __restrict__ dbg,
                          const int32_t* __restrict__ wog,
                          const int32_t* __restrict__ gfirst,
                          uint32_t* __restrict__ out, int* state, int nrows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* words = smem;  // the direct path's words, from tile bit 0
  __shared__ Scratch sh;
  const int tid = threadIdx.x;
  if (tid == 0) sh.g = atomicAdd(state, 1);
  for (int q = tid; q < kTileWords / 4; q += kFlatThreads)
    reinterpret_cast<uint4*>(words)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int i = sh.g;  // this CTA's tile: super i of the launch
  const int g = i / kTilesPerGroup;
  Tokens t;
  {
    const int4* p = reinterpret_cast<const int4*>(tokc + (int64_t)i * kTileTok)
                    + 2 * tid;
    const int4 a = __ldg(p), c = __ldg(p + 1);
    t.w[0] = a.x; t.w[1] = a.y; t.w[2] = a.z; t.w[3] = a.w;
    t.w[4] = c.x; t.w[5] = c.y; t.w[6] = c.z; t.w[7] = c.w;
  }
  for (int k = tid; k < kLut; k += kFlatThreads)
    sh.lut[k] = lut3[(int64_t)g * kLut + k];
  __syncthreads();
  // code the tokens
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int32_t w = t.w[k];
    const int sym = w & 511;
    const bool live = is_valid(w);
    t.e[k] = live ? (uint32_t)sh.lut[sym < 256 ? sym : 256 + (sym & 127)] : 0u;
    sum += live ? (int)(t.e[k] >> 24) + ((w >> 9) & 15) : 0;
  }
  t.sum = sum;
  const int bit = rspt::block_scan_excl(sum, 0, rspt::OpSum(), false,
                                        sh.scan, &sh.total);
  const int total = sh.total;
  // publish the tile's bits (+ 1: 0 means not yet) before any wait
  if (tid == 0) atomicExch(state + 2 + i, total + 1);
  if (tid < 32) {  // look back over the tiles before this one
    const int gt0 = kTilesPerGroup * g;  // the group's first tile
    const int k0 = min(kTilesPerGroup * max(gfirst[g], 0), gt0);
    unsigned carry = 0;
    int pre = 0;
    for (int k = k0 + tid; k < i; k += 32) {
      int v;
      while ((v = *(volatile int*)(state + 2 + k)) == 0) {
      }
      if (k < gt0) {
        carry += (unsigned)(v - 1);
      } else {
        pre += v - 1;
      }
    }
    for (int o = 16; o; o >>= 1) {
      carry += __shfl_xor_sync(rspt::kFull, carry, o);
      pre += __shfl_xor_sync(rspt::kFull, pre, o);
    }
    if (tid == 0) {
      sh.carry = (int)carry;
      sh.pre = pre;
    }
  }
  // while warp 0 looks back: bad, a valid token outside the direct
  // path's domain, and the super's words from tile bit 0 (a super with a
  // bad token discards them: no word past the buffer is touched)
  bool bad = false;
  int x = bit;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int32_t w = t.w[k];
    const uint32_t e = t.e[k];
    const int cb = (int)(e >> 24), eb = (w >> 9) & 15;
    const int nb = is_valid(w) ? cb + eb : 0;
    // without branches: a branch a token costs more than the test
    bad |= is_valid(w) &
           ((cb > 23) | (((e & 0xFFFFFFu) >> min(cb, 24)) != 0) |
            ((((w >> 13) & 16383) >> eb) != 0));
    if (!nb) continue;
    const uint64_t val = (uint64_t)(t.e[k] & 0xFFFFFFu) |
                         ((uint64_t)((w >> 13) & 16383) << min(cb, 24));
    const int s = x & 31, wi = x >> 5;
    const uint64_t lo = val << s;
    if (wi + 2 < kTileWords) {
      if ((uint32_t)lo) atomicOr(words + wi, (uint32_t)lo);
      if ((uint32_t)(lo >> 32)) atomicOr(words + wi + 1, (uint32_t)(lo >> 32));
      if (s && (uint32_t)(val >> (64 - s)))
        atomicOr(words + wi + 2, (uint32_t)(val >> (64 - s)));
    }
    x += nb;
  }
  const bool in_field = !__syncthreads_or(bad);
  if (total == 0) return;  // a dead super places nothing (every thread)
  const int pre = sh.pre;  // the group's bits before this super
  // the group's base bit in int32 arithmetic, as on the TPU
  const int gb = (int)((uint32_t)wog[g] * 8u + (uint32_t)dbg[g] +
                       (uint32_t)sh.carry);
  const int sbase = pre >> 5;
  const int b = (gb >> 5) + sbase;
  if (!in_field || b < 0 || b > (nrows - kAccRows) * 128) {
    if (tid == 0) atomicAdd(state + 1, 1);
    t.bit = pre + bit;  // group-local
    place_slow(t, sbase, gb, b, smem, out, nrows, sh);
    return;
  }
  // the direct path: the super's first bit p0 = gb + pre (>= 32 b >= 0);
  // its words shifted up by p0 & 31 on the way out
  const int64_t p0 = (int64_t)gb + pre;
  const int s0 = (int)(p0 & 31);
  const int nw = (s0 + total + 31) >> 5;
  const int64_t w0 = p0 >> 5;
  for (int k = tid; k < nw; k += kFlatThreads) {
    uint32_t v = words[k];
    if (s0) v = v << s0 | (k ? words[k - 1] >> (32 - s0) : 0u);
    if (k == 0 || k == nw - 1) {
      if (v) atomicAdd(out + w0 + k, v);
    } else {
      out[w0 + k] = v;
    }
  }
}

template <typename Kernel>
int smem_limit(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// tokc: ng * 8,192 int32 token words (16-byte aligned); lut3: (ng, 384)
// int32; w0, w1: (ng * 64, 128) int32; cbase, clive: ng * 64 int32; gtot:
// ng int32; every output word is written. Returns the first cudaError.
extern "C" int rspt_group_windows(const void* tokc, const void* lut3, void* w0,
                                  void* w1, void* cbase, void* clive,
                                  void* gtot, int ng, void* stream) {
  group_windows_kernel<<<kGwTiles * ng, kGwThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)lut3, (int32_t*)w0, (int32_t*)w1,
      (int32_t*)cbase, (int32_t*)clive, (int32_t*)gtot);
  return (int)cudaGetLastError();
}

// Tokens of a group_windows tile (a CTA).
extern "C" int rspt_group_windows_tile() { return kGwTile; }

// w0, w1: (nsup * 32, 128) int32; drow: nsup * 32 int32; dlane: (nsup,
// 32) int32; wbase, sbits, slive: nsup int32; out: (nrows, 128) int32,
// zeroed by the caller, nrows >= 56. Returns cudaGetLastError().
extern "C" int rspt_place_windows_aligned(const void* w0, const void* w1,
                                          const void* drow, const void* dlane,
                                          const void* wbase, const void* sbits,
                                          const void* slive, void* out,
                                          int nsup, int nrows, void* stream) {
  place_windows_aligned_kernel<<<nsup, kX1Threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)w0, (const uint32_t*)w1, (const int32_t*)drow,
      (const int32_t*)dlane, (const int32_t*)wbase, (const int32_t*)sbits,
      (const int32_t*)slive, (uint32_t*)out, nrows);
  return (int)cudaGetLastError();
}

// int32 words of the state rspt_windows_place_flat takes for ng groups:
// the tile ticket, the count of supers placed by the slow path, then one
// word a tile (its bits + 1 once known).
extern "C" int rspt_windows_place_flat_state(int ng) {
  return 2 + kTilesPerGroup * ng;
}

// tokc: >= ng * 8,192 int32 token words (16-byte aligned); lut3: (ng, 384)
// int32; dbg, wog, gfirst: ng int32; out: (nrows, 128) int32 zeroed by the
// caller, nrows >= 48; state: rspt_windows_place_flat_state(ng) int32
// zeroed by the caller (state[1] gets the slow path's supers). Returns the
// first cudaError.
extern "C" int rspt_windows_place_flat(const void* tokc, const void* lut3,
                                       const void* dbg, const void* wog,
                                       const void* gfirst, void* out,
                                       void* state, int ng, int nrows,
                                       void* stream) {
  const int err = smem_limit(windows_place_flat_kernel, kFlatSmem);
  if (err) return err;
  windows_place_flat_kernel<<<kTilesPerGroup * ng, kFlatThreads, kFlatSmem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)lut3, (const int32_t*)dbg,
      (const int32_t*)wog, (const int32_t*)gfirst, (uint32_t*)out,
      (int*)state, nrows);
  return (int)cudaGetLastError();
}
