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
// Design: one 1024-thread block per tile of 8 x 128 lanes (lane_rows
// never lets a block straddle a tile, so the fixpoint stays in one block).
// Each thread loops over its own steps; warps diverge where lanes end at
// different steps. The 96-bit bit cache is three uint32 registers,
// refilled one word at a time straight from the lane's window
// win[w][row][lane] (neighbouring lanes read neighbouring words). The
// code lookup reads the row's 8-bit root LUT and at most four chained
// 4-bit levels with __ldg (they sit in L1/L2 after the first sweep). The
// exits go through shared memory; __syncthreads_or says whether an entry
// changed. The TPU's masked window reduction, 128-wide LUT gather
// sweeps, 4x unrolled steps, emission ring and DMA flushes were
// workarounds for a machine without per-lane loads; none is kept.
//
// After a sweep the tile's step count is the most steps of any lane; a
// lane that stopped earlier writes outc << 9 up to it, as the TPU kernel's
// inactive steps do. Rows at or past the step count are left unwritten.
//
// Bound: the decode is a serial chain of dependent loads and shifts per
// lane (latency, not bytes): a lane of ~150 steps runs ~150 dependent
// iterations of refill + LUT load(s) + shift, and each sweep of the
// fixpoint repeats them. With 10 tiles on 132 SMs the card is mostly
// idle. The byte bound (payload read once, literals written once) is far
// below what that chain takes.
#include "common.cuh"

namespace {

constexpr int kLanes = 1024;          // 8 rows x 128 lanes
constexpr int kSegPerBlock = 1024;
constexpr int32_t kDeep = 1 << 30;
__constant__ int kEbits[6] = {0, 0, 2, 4, 8, 14};
__constant__ int kBase[6] = {0, 2, 3, 7, 23, 279};

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

// The lane's window word wptr (zero outside the window, as the TPU's
// masked reduction gives).
__device__ __forceinline__ uint32_t fetch(const Params& p, int wptr, int gl) {
  if (wptr < 0 || wptr >= p.wseg) return 0u;
  return (uint32_t)__ldg(p.win + (int64_t)wptr * p.nrows * 128 + gl);
}

__device__ SweepOut sweep(const Params& p, int gl, int entry, int seg_end,
                          int pbits, int wbase, int32_t* erow) {
  const int row = gl >> 7;
  int pos = entry;
  bool active = entry < seg_end && entry < pbits;
  int wptr = (entry >> 5) - wbase;
  uint32_t c0 = fetch(p, wptr, gl) >> (entry & 31);
  uint32_t c1 = 0, c2 = 0;
  int navail = active ? 32 - (entry & 31) : 0;
  ++wptr;
  int outc = 0, lits = 0, step = 0;
  while (active && step < p.S) {
    // refill to >= 40 bits (a step consumes <= 38): 2 -> 34 -> 66
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (navail < 40) {
        const uint32_t w = fetch(p, wptr, gl);
        const int nv = navail;
        if (nv < 32) {
          c0 |= w << nv;
          if (nv > 0) c1 |= w >> (32 - nv);
        } else {
          c1 |= w << (nv - 32);
          if (nv > 32) c2 |= w >> (64 - nv);
        }
        navail += 32;
        ++wptr;
      }
    }
    const uint32_t idx8 = c0 & 255u;
    int32_t ent = idx8 < 128 ? __ldg(p.l1lo + row * 128 + idx8)
                             : __ldg(p.l1hi + row * 128 + idx8 - 128);
    // chained 4-bit levels: a deep entry's low 16 bits name the slot
    // (unrolled, so p.lv[k] stays a static parameter access)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(ent & kDeep)) break;
      const int i = (ent & 0xFFFF) * 16 + (int)((c0 >> (8 + 4 * k)) & 15u);
      ent = (i >> 7) < p.cap[k]
                ? __ldg(p.lv[k] + ((int64_t)(i >> 7) * p.nrows + row) * 128 +
                        (i & 127))
                : 0;
    }
    const int sym = ent & 0x1FF;
    const uint32_t cb = (uint32_t)(ent >> 16) & 0xFFu;
    const int ridx = min(max(sym - 255, 0), 5);
    const int ebv = kEbits[ridx];
    const uint32_t tail = (c0 >> cb) | (cb > 0 ? c1 << (32 - cb) : 0u);
    const uint32_t extra = ebv > 0 ? tail & ((1u << ebv) - 1u) : 0u;
    const bool is_rle = sym >= 256;
    const bool is_lit = !is_rle && sym > 0;
    erow[(int64_t)step * kLanes] =
        (int32_t)(((uint32_t)outc << 9) | (uint32_t)(is_lit ? sym : 0));
    const int consume = (int)cb + ebv;       // <= 38
    uint32_t d0 = c0, d1 = c1, d2 = c2;
    if (consume >= 32) {
      d0 = c1;
      d1 = c2;
      d2 = 0;
    }
    const uint32_t cs = (uint32_t)consume & 31u;
    if (cs) {
      c0 = (d0 >> cs) | (d1 << (32 - cs));
      c1 = (d1 >> cs) | (d2 << (32 - cs));
      c2 = d2 >> cs;
    } else {
      c0 = d0;
      c1 = d1;
      c2 = d2;
    }
    navail -= consume;
    pos += consume;
    outc += is_rle ? kBase[ridx] + (int)extra : 1;
    lits += is_lit;
    ++step;
    active = pos < seg_end && pos < pbits;
  }
  return {pos, step, outc, lits};
}

// Tile-wide max step count, literal sum and max count of one sweep; pads
// each lane's emissions up to the tile's step count. Every thread calls.
__device__ int finish_sweep(const SweepOut& o, int32_t* erow, int* red,
                            int* tlits, int* tmax) {
  if (threadIdx.x == 0) red[0] = red[1] = red[2] = 0;
  __syncthreads();
  const int m = __reduce_max_sync(rspt::kFull, o.steps);
  const int l = __reduce_add_sync(rspt::kFull, o.lits);
  const int c = __reduce_max_sync(rspt::kFull, o.outc);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(red, m);
    atomicAdd(red + 1, l);
    atomicMax(red + 2, c);
  }
  __syncthreads();
  const int tsteps = red[0];
  *tlits = red[1];
  *tmax = red[2];
  const int32_t pad = (int32_t)((uint32_t)o.outc << 9);
  for (int s = o.steps; s < tsteps; ++s) erow[(int64_t)s * kLanes] = pad;
  return tsteps;
}

__global__ void __launch_bounds__(kLanes) hzr_decode_kernel(Params p) {
  __shared__ int s_exit[kLanes];
  __shared__ int red[3];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int gl = t * kLanes + tid;
  const int entry0 = p.entry[gl];
  const int seg_end = p.segend[gl];
  const int pbits = p.pbits[gl];
  const int wbase = p.wbase[gl];
  const bool pinned = p.first[gl] != 0;
  const bool trust = p.ntc[t * 5 + 4] != 0;
  int32_t* erow = p.emis + (int64_t)t * p.S * kLanes + tid;

  int entry = entry0;
  int it = 0;
  bool changed = !trust;
  SweepOut o = {entry0, 0, 0, 0};
  int tsteps = 0, tlits = 0, tmax = 0;
  while (changed && it < kSegPerBlock + 2) {
    o = sweep(p, gl, entry, seg_end, pbits, wbase, erow);
    tsteps = finish_sweep(o, erow, red, &tlits, &tmax);
    s_exit[tid] = o.exit;
    __syncthreads();
    const int ne = pinned ? entry0 : s_exit[(tid + kLanes - 1) & (kLanes - 1)];
    changed = __syncthreads_or(ne != entry) != 0;
    entry = ne;
    ++it;
  }
  if (trust || changed) {
    o = sweep(p, gl, entry, seg_end, pbits, wbase, erow);
    tsteps = finish_sweep(o, erow, red, &tlits, &tmax);
  }
  p.counts[gl] = o.outc;
  p.entry_out[gl] = entry;
  if (tid == 0) {
    int32_t* st = p.stats + t * 5;
    st[0] = tsteps;
    st[1] = it;
    st[2] = tlits;
    st[3] = 0;
    st[4] = tmax;
  }
}

}  // namespace

// Inputs as hzr_decode's wrapper documents them (int32, nrows = 8 * nt);
// emis (nt, S, 8, 128), counts and entry_out (nrows, 128), stats (nt, 5).
// A lane stops after S steps (no legal segment needs MAX_STEPS = 1088).
// Returns cudaGetLastError().
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
  hzr_decode_kernel<<<nt, kLanes, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
