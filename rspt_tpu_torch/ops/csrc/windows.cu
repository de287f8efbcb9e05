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
// and no wrap fires: they are replicated so that kernel, plain version and
// TPU kernel agree on every input whose supers share at most edge words.
//
// Design. One 1,024-thread block per group, 8 consecutive tokens a thread
// (16-byte loads), the LUT in shared memory; rspt::block_scan_excl gives
// each token its group-local bit. The 64 windows (64 KiB) sit in dynamic
// shared memory and tokens add their words into them with shared atomics:
// the TPU built them with MXU prefix dots, binary searches and rolls only
// because it cannot scatter (its sums are of disjoint bits; the atomics
// add as it does, so even the clamped corner agrees). K14 writes them out
// once, zeros included. A super's placement builds its accumulator in
// shared memory the same way (28 KiB for X1), shifts and rotates it in
// registers, finds its first and last nonzero words by two block
// reductions, and writes the words strictly between them, which only this
// super owns, with plain stores (16-byte vectors where aligned; no slack
// zero word is ever stored), and the two edge words, which a neighbouring
// super may share, with atomicAdd into the zeroed output. X1 is one block
// per super. K15's TPU grid ran in order and carried the scan in SMEM; here
// blocks run in any order, so each takes its group from an atomic ticket
// (a block then only waits for groups that have started), publishes its
// bit total as soon as the scan has it, and looks back over the totals of
// its block's earlier groups (at most 7) before placing.
// Bound: bytes. K14: the tokens read once, the LUTs, the windows (2 x 512 B
// a chunk), cbase, clive and gtot written once. X1: the windows and glue
// arrays read once, the output words written once. K15: the tokens, LUTs
// and group arrays read once, the output words written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kGroupTok = kThreads * kItems;  // 8,192 tokens a group
constexpr int kChunks = 64;                   // 128-token chunks a group
constexpr int kWin = 256;                     // words a chunk window
constexpr int kSupChunks = 32;                // chunks a super
constexpr int kSupers = kChunks / kSupChunks;
constexpr int kLut = 3 * 128;
constexpr int kDClamp = 40 * 128 - 1;
constexpr int kAccRows = 48;                  // K5 / K15 accumulator rows
constexpr int kAlignedRows = 56;              // X1 accumulator rows
constexpr size_t kWinBytes = sizeof(uint32_t) * kChunks * kWin;  // 64 KiB
constexpr size_t kAccBytes = sizeof(uint32_t) * kAccRows * 128;

// The small shared state of one block.
struct Scratch {
  int32_t lut[kLut];
  int cbase[kChunks];
  int clive[kChunks];
  int st[kSupChunks];   // t = d & 127 of each chunk of the super placed
  int src[kSupChunks];  // rc = d >> 7
  int scan[32];
  int total, lo, hi, g, carry;
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

// Loads the group's LUT, zeroes its windows and liveness flags.
__device__ __forceinline__ void start_group(const int32_t* __restrict__ lut,
                                            uint32_t* swin, Scratch& sh) {
  for (int k = threadIdx.x; k < kLut; k += kThreads) sh.lut[k] = lut[k];
  for (int q = threadIdx.x; q < kChunks * kWin / 4; q += kThreads)
    reinterpret_cast<uint4*>(swin)[q] = make_uint4(0, 0, 0, 0);
  if (threadIdx.x < kChunks) sh.clive[threadIdx.x] = 0;
  __syncthreads();
}

// Codes the thread's tokens and scans their bit counts; sh.total gets the
// group's bits.
__device__ __forceinline__ void code_tokens(const int32_t* __restrict__ toks,
                                            Scratch& sh, Tokens& t) {
  const int4* p = reinterpret_cast<const int4*>(toks) + 2 * threadIdx.x;
  const int4 a = __ldg(p), c = __ldg(p + 1);
  t.w[0] = a.x; t.w[1] = a.y; t.w[2] = a.z; t.w[3] = a.w;
  t.w[4] = c.x; t.w[5] = c.y; t.w[6] = c.z; t.w[7] = c.w;
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int sym = t.w[k] & 511;
    const bool live = is_valid(t.w[k]);
    t.e[k] = live ? (uint32_t)sh.lut[sym < 256 ? sym : 256 + (sym & 127)] : 0u;
    sum += live ? (int)(t.e[k] >> 24) + ((t.w[k] >> 9) & 15) : 0;
  }
  t.sum = sum;
  t.bit = rspt::block_scan_excl(sum, 0, rspt::OpSum(), false, sh.scan,
                                &sh.total);
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
    const uint32_t cb = t.e[k] >> 24;
    const uint64_t val = (uint64_t)(t.e[k] & 0xFFFFFFu) |
                         ((uint64_t)((w >> 13) & 16383) << cb);
    const int s = bit & 31;
    const int loc = min((bit >> 5) - cbase, kWin - 2);
    const uint64_t lo = val << s;
    const uint32_t c0 = (uint32_t)lo, c1 = (uint32_t)(lo >> 32);
    const uint32_t c2 = s ? (uint32_t)(val >> (64 - s)) : 0u;
    if (c0) atomicAdd(win + loc, c0);
    if (c1) atomicAdd(win + loc + 1, c1);
    if (c2 && loc + 2 < kWin) atomicAdd(win + loc + 2, c2);
    bit += (int)cb + ((w >> 9) & 15);
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
  for (int j = first + 1 + tid; j < min(4 * v0, last); j += kThreads)
    if (inside(base + j)) out[base + j] = acc[j];
  for (int q = v0 + tid; q < v1; q += kThreads)
    if (inside(base + 4 * q))
      *reinterpret_cast<uint4*>(out + base + 4 * q) =
          reinterpret_cast<const uint4*>(acc)[q];
  for (int j = max(4 * v1, first + 1) + tid; j < last; j += kThreads)
    if (inside(base + j)) out[base + j] = acc[j];
}

// Places one live super through a kRows-row accumulator acc (shared, 16-byte
// aligned). Chunk c's window word x is (x < 128 ? p0 : p1)[c * stride +
// (x & 127)]; its t and rc are sh.st[c] and sh.src[c], which the caller
// wrote before calling (the first barrier here publishes them).
template <int kRows, bool kAligned>
__device__ __forceinline__ void place_super(const uint32_t* p0,
                                            const uint32_t* p1, int stride,
                                            int sb, int b, uint32_t* acc,
                                            uint32_t* __restrict__ out,
                                            int nrows, Scratch& sh) {
  constexpr int kN = kRows * 128;
  constexpr int kPer = (kN + kThreads - 1) / kThreads;
  const int tid = threadIdx.x;
  for (int q = tid; q < kN / 4; q += kThreads)
    reinterpret_cast<uint4*>(acc)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < kSupChunks * kWin; i += kThreads) {
    const int c = i >> 8, x = i & (kWin - 1);
    const uint32_t v = (x < 128 ? p0 : p1)[c * stride + (x & 127)];
    const int rc = sh.src[c];
    if (v && rc >= 0 && rc < kRows) {
      int k = rc * 128 + sh.st[c] + x;  // < 2 * kN
      if (k >= kN) k -= kN;
      atomicAdd(acc + k, v);
    }
  }
  __syncthreads();
  int row0 = b >> 7;
  if (kAligned) row0 &= ~7;
  const int64_t base = (int64_t)row0 * 128;
  const int off = (int)(b - base);  // < 1,024 <= kN
  uint32_t v[kPer];
  int lo = kN, hi = -1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = tid + q * kThreads;
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
    const int k = tid + q * kThreads;
    if (k < kN) acc[k + off >= kN ? k + off - kN : k + off] = v[q];
  }
  // both scans synchronise, so the rotated span is visible after them
  rspt::block_scan_excl(lo, kN, rspt::OpMin(), false, sh.scan, &sh.lo);
  rspt::block_scan_excl(hi, -1, rspt::OpMax(), false, sh.scan, &sh.hi);
  if (sh.lo <= sh.hi)
    write_span(acc, sh.lo, sh.hi, out, base, (int64_t)nrows * 128);
  __syncthreads();  // acc and sh are reused by the caller's next super
}

__global__ void __launch_bounds__(kThreads)
group_windows_kernel(const int32_t* __restrict__ tokc,
                     const int32_t* __restrict__ lut3,
                     int32_t* __restrict__ w0, int32_t* __restrict__ w1,
                     int32_t* __restrict__ cbase, int32_t* __restrict__ clive,
                     int32_t* __restrict__ gtot) {
  extern __shared__ __align__(16) uint32_t swin[];
  __shared__ Scratch sh;
  const int g = blockIdx.x;
  start_group(lut3 + (int64_t)g * kLut, swin, sh);
  Tokens t;
  code_tokens(tokc + (int64_t)g * kGroupTok, sh, t);
  fill_windows(swin, sh, t);
  const int64_t row0 = (int64_t)g * kChunks;
  for (int q = threadIdx.x; q < kChunks * kWin / 4; q += kThreads) {
    const int c = q >> 6, x = (q & 63) * 4;  // 64 quads a window
    int32_t* dst = (x < 128 ? w0 : w1) + (row0 + c) * 128 + (x & 127);
    *reinterpret_cast<uint4*>(dst) = reinterpret_cast<const uint4*>(swin)[q];
  }
  if (threadIdx.x < kChunks) {
    cbase[row0 + threadIdx.x] = sh.cbase[threadIdx.x];
    clive[row0 + threadIdx.x] = sh.clive[threadIdx.x];
  }
  if (threadIdx.x == 0) gtot[g] = sh.total;
}

__global__ void __launch_bounds__(kThreads)
place_windows_aligned_kernel(const uint32_t* __restrict__ w0,
                             const uint32_t* __restrict__ w1,
                             const int32_t* __restrict__ drow,
                             const int32_t* __restrict__ dlane,
                             const int32_t* __restrict__ wbase,
                             const int32_t* __restrict__ sbits,
                             const int32_t* __restrict__ slive,
                             uint32_t* __restrict__ out, int nrows) {
  __shared__ __align__(16) uint32_t acc[kAlignedRows * 128];
  __shared__ Scratch sh;
  const int s = blockIdx.x;
  if (!slive[s]) return;  // whole block: no barrier skipped
  const int64_t c0 = (int64_t)s * kSupChunks;
  if (threadIdx.x < kSupChunks) {
    sh.st[threadIdx.x] = drow[c0 + threadIdx.x] & 127;
    sh.src[threadIdx.x] = dlane[c0 + threadIdx.x] >> 7;
  }
  place_super<kAlignedRows, true>(w0 + c0 * 128, w1 + c0 * 128, 128,
                                  sbits[s] & 31, wbase[s], acc, out, nrows,
                                  sh);
}

__global__ void __launch_bounds__(kThreads)
windows_place_flat_kernel(const int32_t* __restrict__ tokc,
                          const int32_t* __restrict__ lut3,
                          const int32_t* __restrict__ dbg,
                          const int32_t* __restrict__ wog,
                          const int32_t* __restrict__ gfirst,
                          uint32_t* __restrict__ out, int* state, int nrows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* swin = smem;
  uint32_t* acc = smem + kChunks * kWin;
  __shared__ Scratch sh;
  if (threadIdx.x == 0) sh.g = atomicAdd(state, 1);
  __syncthreads();
  const int g = sh.g;
  start_group(lut3 + (int64_t)g * kLut, swin, sh);
  Tokens t;
  code_tokens(tokc + (int64_t)g * kGroupTok, sh, t);
  // publish the group's bits (+ 1: 0 means not yet) before anything else
  if (threadIdx.x == 0) atomicExch(state + 1 + g, sh.total + 1);
  fill_windows(swin, sh, t);
  if (threadIdx.x < 32) {  // look back over the block's earlier groups
    int sum = 0;
    for (int k = max(gfirst[g], 0) + threadIdx.x; k < g; k += 32) {
      int v;
      while ((v = *(volatile int*)(state + 1 + k)) == 0) {
      }
      sum += v - 1;
    }
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(rspt::kFull, sum, o);
    if (threadIdx.x == 0) sh.carry = sum;
  }
  __syncthreads();
  // the group's base bit in int32 arithmetic, as on the TPU
  const int gb = (int)((uint32_t)wog[g] * 8u + (uint32_t)dbg[g] +
                       (uint32_t)sh.carry);
  for (int s = 0; s < kSupers; ++s) {
    int live = 0;
    for (int j = 0; j < kSupChunks; ++j) live |= sh.clive[s * kSupChunks + j];
    if (!live) continue;  // the same for every thread
    const int sbase = sh.cbase[s * kSupChunks];
    if (threadIdx.x < kSupChunks) {
      const int d = min(max(sh.cbase[s * kSupChunks + threadIdx.x] - sbase, 0),
                        kDClamp);
      sh.st[threadIdx.x] = d & 127;
      sh.src[threadIdx.x] = d >> 7;
    }
    const int b = min(max((gb >> 5) + sbase, 0), (nrows - kAccRows) * 128);
    const uint32_t* win = swin + s * kSupChunks * kWin;
    place_super<kAccRows, false>(win, win + 128, kWin, gb & 31, b, acc, out,
                                 nrows, sh);
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
  const int err = smem_limit(group_windows_kernel, kWinBytes);
  if (err) return err;
  group_windows_kernel<<<ng, kThreads, kWinBytes, (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)lut3, (int32_t*)w0, (int32_t*)w1,
      (int32_t*)cbase, (int32_t*)clive, (int32_t*)gtot);
  return (int)cudaGetLastError();
}

// w0, w1: (nsup * 32, 128) int32; drow: nsup * 32 int32; dlane: (nsup,
// 32) int32; wbase, sbits, slive: nsup int32; out: (nrows, 128) int32,
// zeroed by the caller, nrows >= 56. Returns cudaGetLastError().
extern "C" int rspt_place_windows_aligned(const void* w0, const void* w1,
                                          const void* drow, const void* dlane,
                                          const void* wbase, const void* sbits,
                                          const void* slive, void* out,
                                          int nsup, int nrows, void* stream) {
  place_windows_aligned_kernel<<<nsup, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)w0, (const uint32_t*)w1, (const int32_t*)drow,
      (const int32_t*)dlane, (const int32_t*)wbase, (const int32_t*)sbits,
      (const int32_t*)slive, (uint32_t*)out, nrows);
  return (int)cudaGetLastError();
}

// tokc: >= ng * 8,192 int32 token words (16-byte aligned); lut3: (ng, 384)
// int32; dbg, wog, gfirst: ng int32; out: (nrows, 128) int32 zeroed by the
// caller, nrows >= 48; state: ng + 1 int32 zeroed by the caller (the group
// ticket, then each group's bits + 1). Returns the first cudaError.
extern "C" int rspt_windows_place_flat(const void* tokc, const void* lut3,
                                       const void* dbg, const void* wog,
                                       const void* gfirst, void* out,
                                       void* state, int ng, int nrows,
                                       void* stream) {
  const size_t smem = kWinBytes + kAccBytes;
  const int err = smem_limit(windows_place_flat_kernel, smem);
  if (err) return err;
  windows_place_flat_kernel<<<ng, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tokc, (const int32_t*)lut3, (const int32_t*)dbg,
      (const int32_t*)wog, (const int32_t*)gfirst, (uint32_t*)out,
      (int*)state, nrows);
  return (int)cudaGetLastError();
}
