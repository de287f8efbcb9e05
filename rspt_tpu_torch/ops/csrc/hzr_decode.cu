// hzr_decode: lockstep speculative hzr decode of every segment lane, with
// the alignment fixpoint inside the kernel.
//
// Replaces K6, rspt_tpu/hzr/pallas_decoder.py: _run_kernel (:643-701)
// and _decode_kernel (:291-640).
//
// Each lane is one segment of a HUFF block: it starts at `entry` (a bit
// offset into the block's payload), decodes symbols until its position
// passes `segend` or `pbits`, and records for every step s the emission
// outc << 9 | byte (byte 0 unless the symbol was a literal), outc being
// the bytes it has decoded before that step. A lane's entry is only right
// once the previous lane's exit is known, so the tile repeats emitting
// sweeps with entry(s+1) = exit of the previous lane in sweep s (lanes
// with `first` keep their own) until no entry changes, at most
// SEG_PER_BLOCK + 2 times; a cap exit re-emits from the last entries.
// Trusted tiles (decode hints, ntc[t][4]) run one sweep.
//
// Design: a thread-block cluster per tile of 8 x 128 lanes, a CTA per
// kRowsPerCta rows, a thread per lane: the 10 tiles of a 14-block decode
// run on 80 SMs, 4 warps an SM. Each CTA first copies its rows' tables
// into shared memory with cp.async: the lane windows as [word][lane] (a
// warp's loads hit 32 banks whatever each lane's word), the 8-bit root LUT
// and the nibble levels (kLevelsShared; else those stay in global memory
// behind __ldg). A step reads the 64 window bits at its position (three
// loads, two funnel shifts) instead of shifting a bit cache, so the serial
// chain of a step is short: those loads, the root LUT, up to four chained
// levels, on shared-memory latency. The fixpoint crosses the cluster
// through distributed shared memory: a warp's last lane stores its exit
// into the next warp's slot, the CTA's last lane into the next rank's;
// every thread tracks its right neighbour's entry, so whether an entry
// changed is known before the barrier; each CTA's change flag, max step
// count, literal sum and max count go to every rank; one cluster barrier a
// sweep. Those slots alternate by sweep parity: a rank stores into slots
// that no rank can still be reading (they were read before the previous
// barrier). Lane 0 of rank 0 takes rank 7's last exit, as the plain
// version's roll does (it is pinned or padding in every tile lane_rows
// builds). Every CTA, padding rows too, joins every barrier; the sweep
// count is uniform over the cluster. A lane that stopped before the tile's
// step count writes outc << 9 up to it once, after the last sweep: earlier
// sweeps' rows below it are overwritten, and rows at or past the step
// count are scratch. kSkipSame keeps a lane's last sweep when its entry
// did not change (the sweep is a function of the entry).
//
// Bound: latency. A lane of ~90-140 steps runs that many dependent
// iterations a sweep, and the fixpoint runs 2-3 sweeps; the byte bound
// (payload and LUTs read once, the emission rows written once) is far
// below that chain.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRowsPerCta = 1;                 // rows of 128 lanes a CTA
constexpr int kCluster = 8 / kRowsPerCta;      // CTAs a tile
constexpr int kThreads = 128 * kRowsPerCta;
constexpr int kWarps = kThreads / 32;
constexpr bool kLevelsShared = true;
constexpr bool kSkipSame = true;
constexpr int kTileLanes = 1024;              // 8 rows x 128 lanes
constexpr int kSegPerBlock = 1024;
constexpr int32_t kDeep = 1 << 30;
// RLE extra bits and base lengths by clamp(sym - 255, 0, 5): 0 0 2 4 8 14
// and 0 2 3 7 23 279, packed 4 and 9 bits a value
constexpr uint32_t kEbitsPack = 2u << 8 | 4u << 12 | 8u << 16 | 14u << 20;
constexpr uint64_t kBasePack =
    2ull << 9 | 3ull << 18 | 7ull << 27 | 23ull << 36 | 279ull << 45;

struct Params {
  const int32_t* ntc;
  const int32_t* win;
  const int32_t* l1lo;
  const int32_t* l1hi;
  const int32_t* lv[4];
  const int32_t* entry;
  const int32_t* segend;
  const int32_t* pbits;
  const int32_t* first;
  const int32_t* wbase;
  int32_t* emis;
  int32_t* counts;
  int32_t* entry_out;
  int32_t* stats;
  int cap[4];
  int nrows;
  int wseg;
  int S;
};

struct SweepOut {
  int exit, steps, outc, lits;
};

// A lane's row tables: its window column (stride 128 words), the root
// LUT (256 entries) and the four nibble levels.
struct Tables {
  const int32_t* win;
  const int32_t* l1;
  const int32_t* lv[4];
  int row;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// nchunk 128-word chunks, src chunk j at src + j * stride, into dst
// contiguously; every thread of the CTA issues its share.
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* src,
                                      int nchunk, int64_t stride) {
  for (int i = threadIdx.x; i < nchunk * 32; i += kThreads) {
    const int j = i >> 5, c = (i & 31) * 4;
    cp_async16(dst + j * 128 + c, src + j * stride + c);
  }
}

__device__ __forceinline__ void emit(int32_t* erow, int s, int32_t v) {
  erow[(int64_t)s * kTileLanes] = v;
}

// The lane's window word k (zero outside the window, as the TPU's
// masked reduction gives).
__device__ __forceinline__ uint32_t fetch(const Params& p, const Tables& tb,
                                          int k) {
  return (unsigned)k < (unsigned)p.wseg ? (uint32_t)tb.win[k * 128] : 0u;
}

// The 64 window bits from bit `pos` on (the lane's window starts at word
// wbase): three independent shared-memory loads and two funnel shifts.
__device__ __forceinline__ uint64_t bits_at(const Params& p, const Tables& tb,
                                            int pos, int wbase) {
  const int k = (pos >> 5) - wbase;
  const uint32_t w0 = fetch(p, tb, k), w1 = fetch(p, tb, k + 1),
                 w2 = fetch(p, tb, k + 2);
  const uint32_t sh = (uint32_t)pos & 31u;
  return (uint64_t)__funnelshift_r(w1, w2, sh) << 32 |
         __funnelshift_r(w0, w1, sh);
}

__device__ __forceinline__ int32_t level(const Params& p, const Tables& tb,
                                         int k, int i) {
  if ((i >> 7) >= p.cap[k]) return 0;
  if (kLevelsShared) return tb.lv[k][i];
  return __ldg(p.lv[k] + ((int64_t)(i >> 7) * p.nrows + tb.row) * 128 +
               (i & 127));
}

// One lane's decode from `entry`. Each step reads the window bits at its
// position afresh (a step consumes <= 38 bits: <= 24 of code, <= 14
// extra), so the chain from one step to the next is the position: loads,
// the LUT, the levels of a long code, the extra bits.
__device__ SweepOut sweep(const Params& p, const Tables& tb, int entry,
                          int seg_end, int pbits, int wbase, int32_t* erow) {
  int pos = entry;
  bool active = entry < seg_end && entry < pbits;
  int outc = 0, lits = 0, step = 0;
  while (active && step < p.S) {
    const uint64_t b = bits_at(p, tb, pos, wbase);
    const uint32_t c0 = (uint32_t)b;
    int32_t ent = tb.l1[c0 & 255u];
    // chained 4-bit levels: a deep entry's low 16 bits name the slot
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(ent & kDeep)) break;
      ent = level(p, tb, k,
                  (ent & 0xFFFF) * 16 + (int)((c0 >> (8 + 4 * k)) & 15u));
    }
    const int sym = ent & 0x1FF;
    const uint32_t cb = (uint32_t)(ent >> 16) & 0xFFu;
    const int ridx = min(max(sym - 255, 0), 5);
    const int ebv = (int)(kEbitsPack >> (4 * ridx)) & 15;
    const uint32_t extra = (uint32_t)(b >> cb) & ((1u << ebv) - 1u);
    const bool is_rle = sym >= 256;
    const bool is_lit = !is_rle && sym > 0;
    emit(erow, step,
         (int32_t)(((uint32_t)outc << 9) | (uint32_t)(is_lit ? sym : 0)));
    pos += (int)cb + ebv;
    outc += is_rle ? (int)((kBasePack >> (9 * ridx)) & 511u) + (int)extra
                   : 1;
    lits += is_lit;
    ++step;
    active = pos < seg_end && pos < pbits;
  }
  return {pos, step, outc, lits};
}

// The tile's (any entry changed, max step count, literal sum, max count)
// of one sweep: warp reductions, one slot a warp, then threads 0..kCluster-1
// store the CTA's totals into slot `rank` of every rank, and the cluster
// barrier publishes them (and any exits stored before the call). Every
// thread of every CTA calls it.
__device__ int4 tile_totals(cg::cluster_group& cluster, int rank, bool nch,
                            const SweepOut& o, int4* s_warp,
                            int4 (*s_part)[kCluster], int par) {
  const int a = __any_sync(rspt::kFull, nch);
  const int m = __reduce_max_sync(rspt::kFull, o.steps);
  const int l = __reduce_add_sync(rspt::kFull, o.lits);
  const int c = __reduce_max_sync(rspt::kFull, o.outc);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = make_int4(a, m, l, c);
  __syncthreads();
  if (threadIdx.x < kCluster) {
    int4 v = s_warp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const int4 u = s_warp[w];
      v = make_int4(v.x | u.x, max(v.y, u.y), v.z + u.z, max(v.w, u.w));
    }
    int4* dst = cluster.map_shared_rank(&s_part[par][rank], threadIdx.x);
    *dst = v;
  }
  cluster.sync();
  int4 v = s_part[par][0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) {
    const int4 u = s_part[par][r];
    v = make_int4(v.x | u.x, max(v.y, u.y), v.z + u.z, max(v.w, u.w));
  }
  return v;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    hzr_decode_kernel(Params p) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int4 s_part[2][kCluster];
  __shared__ int s_edge[2][kWarps];
  __shared__ int4 s_warp[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane32 = tid & 31;
  const int lr = tid >> 7;
  const int q = rank * kThreads + tid;            // lane of the tile
  const int gl = t * kTileLanes + q;
  const int row0 = t * 8 + rank * kRowsPerCta;

  // the rows' tables into shared memory: windows [row][word][lane], root
  // LUTs [row][256], then level k as [row][cap_k * 128]
  int32_t* win_s = smem;
  int32_t* l1_s = win_s + kRowsPerCta * p.wseg * 128;
  int32_t* lv_s = l1_s + kRowsPerCta * 256;
  const int64_t rstride = (int64_t)p.nrows * 128;
  for (int r = 0; r < kRowsPerCta; ++r) {
    stage(win_s + r * p.wseg * 128, p.win + (int64_t)(row0 + r) * 128,
          p.wseg, rstride);
    stage(l1_s + r * 256, p.l1lo + (int64_t)(row0 + r) * 128, 1, 0);
    stage(l1_s + r * 256 + 128, p.l1hi + (int64_t)(row0 + r) * 128, 1, 0);
  }
  Tables tb;
  tb.win = win_s + lr * p.wseg * 128 + (tid & 127);
  tb.l1 = l1_s + lr * 256;
  tb.row = row0 + lr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    tb.lv[k] = lv_s + lr * p.cap[k] * 128;
    if (kLevelsShared) {
      for (int r = 0; r < kRowsPerCta; ++r)
        stage(lv_s + r * p.cap[k] * 128, p.lv[k] + (int64_t)(row0 + r) * 128,
              p.cap[k], rstride);
      lv_s += kRowsPerCta * p.cap[k] * 128;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int entry0 = p.entry[gl];
  const int seg_end = p.segend[gl];
  const int pbits = p.pbits[gl];
  const int wbase = p.wbase[gl];
  const bool pinned = p.first[gl] != 0;
  // the right neighbour (lane 1023's is lane 0): its entry is tracked
  // here, so this thread reports whether it changes
  const int gr = t * kTileLanes + ((q + 1) & (kTileLanes - 1));
  const bool npinned = p.first[gr] != 0;
  const int nentry0 = p.entry[gr];
  const bool trust = p.ntc[t * 5 + 4] != 0;
  int32_t* erow = p.emis + (int64_t)t * p.S * kTileLanes + q;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // tables visible to the CTA, and every CTA of the cluster running
  // before any store into another rank's shared memory
  cluster.sync();

  int entry = entry0, nentry = nentry0, done = entry0;
  int it = 0, par = 0;
  bool changed = !trust;
  SweepOut o = {entry0, 0, 0, 0};
  int4 tot = make_int4(0, 0, 0, 0);
  while (changed && it < kSegPerBlock + 2) {
    if (!kSkipSame || it == 0 || entry != done)
      o = sweep(p, tb, entry, seg_end, pbits, wbase, erow);
    done = entry;
    const int ne_right = npinned ? nentry0 : o.exit;
    const bool nch = ne_right != nentry;
    nentry = ne_right;
    const int left = __shfl_up_sync(rspt::kFull, o.exit, 1);
    if (lane32 == 31) {
      if (warp + 1 < kWarps) {
        s_edge[par][warp + 1] = o.exit;
      } else {
        *cluster.map_shared_rank(&s_edge[par][0], (rank + 1) % kCluster) =
            o.exit;
      }
    }
    tot = tile_totals(cluster, rank, nch, o, s_warp, s_part, par);
    const int ne = pinned ? entry0 : (lane32 ? left : s_edge[par][warp]);
    changed = tot.x != 0;
    entry = ne;
    ++it;
    par ^= 1;
  }
  if (trust || changed) {
    if (!kSkipSame || it == 0 || entry != done)
      o = sweep(p, tb, entry, seg_end, pbits, wbase, erow);
    tot = tile_totals(cluster, rank, false, o, s_warp, s_part, par);
  }
  // no store into another rank follows the last barrier: every CTA may exit
  const int32_t pad = (int32_t)((uint32_t)o.outc << 9);
  for (int s = o.steps; s < tot.y; ++s) emit(erow, s, pad);
  p.counts[gl] = o.outc;
  p.entry_out[gl] = entry;
  if (q == 0) {
    int32_t* st = p.stats + t * 5;
    st[0] = tot.y;
    st[1] = it;
    st[2] = tot.z;
    st[3] = 0;
    st[4] = tot.w;
  }
}

}  // namespace

// CTAs a tile (one cluster a tile).
extern "C" int rspt_hzr_decode_cluster() { return kCluster; }

// Inputs as hzr_decode's wrapper documents them (int32, nrows = 8 * nt;
// win, l1lo, l1hi and lv1..lv4 16-byte aligned); emis (nt, S, 8, 128),
// counts and entry_out (nrows, 128), stats (nt, 5). A lane stops after
// S steps (no legal segment needs MAX_STEPS = 1088). Returns the error
// of the shared-memory opt-in or of the launch (cudaGetLastError()).
extern "C" int rspt_hzr_decode(
    const void* ntc, const void* win, const void* l1lo, const void* l1hi,
    const void* lv1, const void* lv2, const void* lv3, const void* lv4,
    const void* entry, const void* segend, const void* pbits,
    const void* first, const void* wbase, void* emis, void* counts,
    void* entry_out, void* stats, int nt, int wseg, int cap1, int cap2,
    int cap3, int cap4, int S, void* stream) {
  Params p;
  p.ntc = (const int32_t*)ntc;
  p.win = (const int32_t*)win;
  p.l1lo = (const int32_t*)l1lo;
  p.l1hi = (const int32_t*)l1hi;
  p.lv[0] = (const int32_t*)lv1;
  p.lv[1] = (const int32_t*)lv2;
  p.lv[2] = (const int32_t*)lv3;
  p.lv[3] = (const int32_t*)lv4;
  p.entry = (const int32_t*)entry;
  p.segend = (const int32_t*)segend;
  p.pbits = (const int32_t*)pbits;
  p.first = (const int32_t*)first;
  p.wbase = (const int32_t*)wbase;
  p.emis = (int32_t*)emis;
  p.counts = (int32_t*)counts;
  p.entry_out = (int32_t*)entry_out;
  p.stats = (int32_t*)stats;
  p.cap[0] = cap1;
  p.cap[1] = cap2;
  p.cap[2] = cap3;
  p.cap[3] = cap4;
  p.nrows = nt * 8;
  p.wseg = wseg;
  p.S = S;
  const int words = wseg * 128 + 256 +
                    (kLevelsShared ? (cap1 + cap2 + cap3 + cap4) * 128 : 0);
  const size_t smem = (size_t)4 * kRowsPerCta * words;
  cudaError_t err = cudaFuncSetAttribute(
      hzr_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hzr_decode_kernel<<<nt * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}
