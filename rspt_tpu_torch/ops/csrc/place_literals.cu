// place_literals: write every literal byte of hzr_decode's emissions at
// its output position.
//
// Replaces the decode placement chain of rspt_tpu/hzr/pallas_decoder.py
// (_place_emissions / _place_words / _pack_fields / _pack_fields_merge,
// :708-1162) and the TPU kernels it runs, rspt_tpu/ops/pallas_kernels.py:
// K7 place_compact_pallas (:1405), K3 compact_tokens_pallas in its
// nonzero_valid form (:1237), K8a chunk_windows2_pallas (:226), K8b
// super_place_pallas (:714), K9a chunk_windows1_pallas (:160) and K9b
// merge_place_pallas (:300), with the tier-2 re-pack and the bucketed
// scatter ladder. All of them exist because scatters serialize on a TPU;
// their output is "byte sym at position pos" for every live literal,
// which a GPU writes directly.
//
// For lane l of tile t and step s < steps[t]: e = emis[t][s][l];
// sym = e & 0x1FF; if lane_live[l] and sym != 0, pos = out_base[l] +
// (e >> 9) and pos < out_limit[l] (the guard that drops symbols decoded
// from a block's padding bits), out[pos] = sym & 0xFF. The caller zeroes
// `out` or hands in the host-resolved bytes, zero over every device block.
//
// Design. A block is (tile, group of 128 lanes, a run of kChunk = 16 step
// rows); block y of a lane group takes chunks y, y + kSplit, ... below the
// tile's step count (kSplit = 16), so the main path's 87-141 steps a tile
// give 576 working blocks of 10 x 8 x 16, each one chunk, and a deeper
// tile loops (blocks past the step count leave at once). Each chunk's 16
// x 128 sub-tile of emis (8 KiB: 512 B of each 4 KiB step row) comes into
// shared memory by cp.async in 16-byte pieces, double-buffered, the next
// chunk in flight while this one is walked. Then kSub = 2 threads a lane
// each walk a contiguous run of kRows = 8 of the chunk's steps of their
// lane's column, read into registers first. hzr_decode's contract (outc
// rises with the step, and lane_out_base gives each lane a run of its
// own) makes a lane's positions rise strictly with the step, so the
// thread packs its literals into aligned 32-bit words in a register and
// stores each word once: the words strictly between its first and last
// word lie inside its own lane's run and step range, and take plain
// stores (zero-run bytes in them are zero, which the output is over every
// device block); the first and last word, which the lane's neighbouring
// step run or a neighbouring lane may share, take atomicOr. OR never
// disturbs a byte that belongs to someone else: `out` is zero over device
// blocks and holds host bytes only outside them. A word that reaches past
// either end of `out` takes byte stores instead (for every writer, so
// the two kinds never meet on one word). The walk is predicated and in
// 32-bit arithmetic: lanes of a warp flush words at different rows, and
// a branchy walk ran every path for the whole warp. What kernel_ab.py
// showed on the H100: the loads alone (no walk) take about half the
// kernel, the stores (atomics included) about a quarter of the rest; one
// thread a lane over 32 steps was 1.1x slower, a branchy walk 1.35x.
// Bound: bytes - the emission rows below each tile's step count read
// once, the lane metadata read once, each literal byte written once.
#include "common.cuh"

namespace {

constexpr int kTileLanes = 1024;
constexpr int kLanes = 128;                 // lanes a block
constexpr int kGroups = kTileLanes / kLanes;
constexpr int kChunk = 16;                  // step rows a chunk
constexpr int kSplit = 16;                  // chunks in flight per lane group
constexpr int kSub = 2;                     // threads a lane
constexpr int kThreads = kLanes * kSub;
constexpr int kRows = kChunk / kSub;        // step rows a thread walks

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [s0, s0 + rows) of the lane group's emissions into buf in pieces
// of kWidth words. `src` points at step 0, lane 0 of the group; a step
// row is kTileLanes words.
template <int kWidth>
__device__ void stage_pieces(int32_t (*buf)[kLanes], const int32_t* src,
                             int s0, int rows) {
  constexpr int kPer = kLanes / kWidth;  // pieces a row
  for (int p = threadIdx.x; p < rows * kPer; p += kThreads) {
    const int r = p / kPer, c = p % kPer * kWidth;
    cp_async<4 * kWidth>(&buf[r][c],
                         src + (int64_t)(s0 + r) * kTileLanes + c);
  }
}

// 16-byte pieces when emis is 16-byte aligned, else single words.
__device__ void stage(int32_t (*buf)[kLanes], const int32_t* src, int s0,
                      int rows, bool vec) {
  if (vec) {
    stage_pieces<4>(buf, src, s0, rows);
  } else {
    stage_pieces<1>(buf, src, s0, rows);
  }
}

// An edge word: atomicOr when the word lies inside out ([w_lo, w_hi)),
// else (one of out's two end words) the bytes of `mask` one by one.
__device__ __forceinline__ void store_edge(uint8_t* out, uint32_t* words,
                                           uint32_t w, uint32_t bits,
                                           unsigned mask, uint32_t w_lo,
                                           uint32_t w_hi, int off) {
  if (w >= w_lo && w < w_hi) {
    atomicOr(words + w, bits);
    return;
  }
  for (int j = 0; j < 4; ++j)
    if ((mask >> j) & 1) out[4 * (int64_t)w - off + j] = bits >> (8 * j);
}

constexpr uint32_t kNoWord = 0xFFFFFFFFu;  // above every word index

__global__ void __launch_bounds__(kThreads)
place_literals_kernel(const int32_t* __restrict__ emis,
                      const int32_t* __restrict__ steps,
                      const int32_t* __restrict__ out_base,
                      const int32_t* __restrict__ out_limit,
                      const uint8_t* __restrict__ lane_live,
                      uint8_t* out, int S, int total) {
  __shared__ __align__(16) int32_t buf[2][kChunk][kLanes];
  const int t = blockIdx.x / kGroups;
  const int g = blockIdx.x % kGroups;
  const int n = min(steps[t], S);
  int s0 = blockIdx.y * kChunk;
  if (s0 >= n) return;  // the same for the whole block
  const int lane = threadIdx.x % kLanes;
  const int r0 = threadIdx.x / kLanes * kRows;  // this thread's first row
  const int gl = t * kTileLanes + g * kLanes + lane;
  const bool live = lane_live[gl];
  const int64_t base = out_base[gl];
  const int64_t lim = min(out_limit[gl], total);
  // A literal at d = emis >> 9 (|d| < 2^22) lands iff lo <= d < hi, i.e.
  // 0 <= base + d < lim: exact in 32 bits once lo and hi are clamped to
  // +-2^23. Its byte is a0 + d (mod 2^32) of out's words, which start at
  // out's 4-byte aligned address: byte i of out is byte off + i of them.
  const int64_t kClamp = 1 << 23;
  const int lo = (int)min(max(-base, -kClamp), kClamp);
  const int hi = (int)min(max(lim - base, -kClamp), kClamp);
  const int off = (int)((uintptr_t)out & 3);
  const uint32_t a0 = (uint32_t)off + (uint32_t)base;
  const uint32_t w_lo = off ? 1 : 0;                          // words
  const uint32_t w_hi = ((uint32_t)off + (uint32_t)total) >> 2;  // inside out
  uint32_t* words = (uint32_t*)((uintptr_t)out - off);
  const int32_t* src = emis + ((int64_t)t * S * kTileLanes + g * kLanes);
  const bool vec = ((uintptr_t)emis & 15) == 0;
  stage(buf[0], src, s0, min(kChunk, n - s0), vec);
  cp_async_commit();
  for (int k = 0; s0 < n; ++k, s0 += kSplit * kChunk) {
    const int next = s0 + kSplit * kChunk;
    if (next < n) stage(buf[(k + 1) & 1], src, next, min(kChunk, n - next),
                        vec);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (live) {
      const int32_t(*rows)[kLanes] = buf[k & 1];
      const int nrows = min(kChunk, n - s0);
      int32_t col[kRows];    // 0 (no symbol) past the step count
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        col[i] = r0 + i < nrows ? rows[r0 + i][lane] : 0;
      // The walk is predicated, not branched: every lane of a warp runs
      // every row, and a lane that flushes a word stores it in place.
      uint32_t cur = kNoWord;  // the word being packed
      uint32_t bits = 0;
      unsigned mask = 0;       // its bytes that hold literals
      bool first = true;       // no word of this run stored yet
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int32_t v = col[i];
        const int d = v >> 9;
        const bool lit = (v & 0x1FF) != 0 && d >= lo && d < hi;
        const uint32_t a = a0 + (uint32_t)d;
        const uint32_t w = a >> 2;
        const bool start = lit && w != cur;
        const bool flush = start && cur != kNoWord;
        if (flush && !first) words[cur] = bits;  // strictly inside the run
        if (flush && first)
          store_edge(out, words, cur, bits, mask, w_lo, w_hi, off);
        first = first && !flush;
        cur = start ? w : cur;
        bits = start ? 0u : bits;
        mask = start ? 0u : mask;
        const uint32_t j = a & 3;
        bits |= lit ? (uint32_t)(v & 0xFF) << (8 * j) : 0u;
        mask |= lit ? 1u << j : 0u;
      }
      if (cur != kNoWord)
        store_edge(out, words, cur, bits, mask, w_lo, w_hi, off);
    }
    __syncthreads();  // buf[k & 1] is restaged two chunks on
  }
}

}  // namespace

// emis (nt, S, 8, 128) int32; steps (nt,) int32; out_base, out_limit
// (nt * 1024,) int32; lane_live (nt * 1024,) bool; out: total bytes,
// initialised by the caller. Returns cudaGetLastError().
extern "C" int rspt_place_literals(const void* emis, const void* steps,
                                   const void* out_base,
                                   const void* out_limit,
                                   const void* lane_live, void* out, int nt,
                                   int S, int total, void* stream) {
  place_literals_kernel<<<dim3(nt * kGroups, kSplit), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)emis, (const int32_t*)steps, (const int32_t*)out_base,
      (const int32_t*)out_limit, (const uint8_t*)lane_live, (uint8_t*)out, S,
      total);
  return (int)cudaGetLastError();
}
