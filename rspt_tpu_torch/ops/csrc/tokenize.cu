// tokenize_planes: byte-plane extract + zero-run RLE tokenize + 261-bin
// histogram of every (64 KiB slab, plane), one CUDA block per tile of
// kTile positions of a slab, all planes at once.
//
// Replaces K2, rspt_tpu/ops/pallas_kernels.py:tokenize_planes_pallas
// (_make_tokenize_kernel, _tok_fscan_max, _tok_rscan_min, :1673-1867),
// and the XLA histogram rspt_tpu/hzr/jax_coder.py:hist_from_tokw
// (:708-734). Run semantics are hzr_encode.c:133-173: greedy zero runs,
// cut into chunks of at most 16,662 starting at run_start + k*16,662.
//
// Per position i of the slab (limit = valid bytes of this slab):
//   word = sym | ebits << 9 | extra << 13 | valid << 27
// literal: sym = byte; chunk start of a zero run: the RLE symbol of
// L = min(run_end - i + 1, 16662); everything else 0. bwords holds the
// plane bytes 4 per word (little-endian), zero past plane_len.
//
// Design: a block per (tile, slab), 32 tiles a slab: 201 working blocks of
// 512 threads for a 410,388-position plane (21 blocks before; in
// kernel_ab.py 2,048 positions read 1-2% faster than 4,096 and 1.5x than
// 8,192, four positions a thread 1.2x faster than eight). A thread owns
// kPer consecutive positions: it reads their int32 words once (int4 loads)
// for every plane and stores its token words as int4 and its plane bytes
// as one word, neighbouring threads on neighbouring addresses. A token
// needs the last non-zero before it (the chunk phase) and the first
// non-zero after it (the run end) anywhere in the slab (positions at or
// past the limit count as non-zero): inside the tile from one block scan
// of all planes at once (warp shuffles, one slot a warp), across tiles
// from a summary pass (kSummary: first and last non-zero of every tile and
// plane, one read of the signal; the token pass reads at most 31 of its
// slab) or, without it, from scanning the neighbouring tiles until a
// non-zero turns up (bounded by the slab's ends). Nothing waits on another
// block. The histograms live in shared memory (runs of equal symbols
// merged before each atomicAdd) and go to the zeroed global rows with one
// atomicAdd per non-zero bin; the summary pass zeroes them (else a memset
// does).
// A batch of payloads of one plane length (the serving path's 2-D form of
// tokenize_planes_pallas, :1813-1867) is the same two launches with the
// payload as the grid's z axis: payload b reads its own signal and writes
// its rows at (b * nr_planes + p) * nb_per + j, payload-major then
// plane-major, as the TPU kernel's swapaxes (:1862-1866) orders them;
// its summary rows and histograms are its own.
// Bound: bytes - the int32 signal read once, the token words, plane
// bytes and histograms written once.
#include "common.cuh"

namespace {

constexpr int kB = 65536;       // positions per slab (MAX_BLOCK_SIZE)
constexpr int kTile = 2048;     // positions per block
constexpr int kPer = 4;         // consecutive positions per thread (4 or 8)
constexpr int kThreads = kTile / kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = kB / kTile;
constexpr bool kSummary = true;
constexpr int kMZR = 16662;     // MAX_ZERO_RUN
constexpr int kNSym = 261;
constexpr int kPlanes = 4;

__device__ __forceinline__ int32_t run_word(int L) {
  int sym, extra, ebits;
  if (L == 1) {
    sym = 0; extra = 0; ebits = 0;
  } else if (L == 2) {
    sym = 256; extra = 0; ebits = 0;
  } else if (L <= 6) {
    sym = 257; extra = L - 3; ebits = 2;
  } else if (L <= 22) {
    sym = 258; extra = L - 7; ebits = 4;
  } else if (L <= 278) {
    sym = 259; extra = L - 23; ebits = 8;
  } else {
    sym = 260; extra = L - 279; ebits = 14;
  }
  return sym | (ebits << 9) | (extra << 13) | (1 << 27);
}

struct Slab {
  int j;        // slab within the plane
  int limit;    // valid positions of the slab
};

__device__ __forceinline__ Slab slab_of(int j, int plane_len) {
  const int64_t left = (int64_t)plane_len - (int64_t)j * kB;
  return {j, left < kB ? (int)left : kB};
}

// Payload blockIdx.z's first row, and the offset of its summary rows.
__device__ __forceinline__ int64_t payload_row(int nr_planes, int nb_per) {
  return (int64_t)blockIdx.z * nr_planes * nb_per;
}

__device__ __forceinline__ int64_t payload_sum(int nb_per) {
  return (int64_t)blockIdx.z * nb_per * kTiles * kPlanes * 2;
}

// The int32 words of slab positions [i0, i0 + kPer), 0 past the limit.
__device__ __forceinline__ void load_words(const int32_t* __restrict__ enc,
                                           const Slab& s, int i0,
                                           int32_t (&v)[kPer]) {
  const int32_t* src = enc + (int64_t)s.j * kB + i0;
  if (i0 + kPer <= s.limit && ((uintptr_t)src & 15) == 0) {
#pragma unroll
    for (int g = 0; g < kPer / 4; ++g) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src) + g);
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) v[q] = i0 + q < s.limit ? __ldg(src + q) : 0;
  }
}

// Last and first "non-zero" position (a non-zero byte, or at or past the
// limit) of plane p among the thread's kPer positions; -1 / kB if none.
__device__ __forceinline__ void nz_bounds(const int32_t (&v)[kPer], int p,
                                          int i0, int limit, int& last,
                                          int& first) {
  last = -1;
  first = kB;
#pragma unroll
  for (int q = kPer - 1; q >= 0; --q) {
    if (((v[q] >> (8 * p)) & 255) != 0 || i0 + q >= limit) {
      first = i0 + q;
      if (last < 0) last = i0 + q;
    }
  }
}

// Summary pass: (first, last) non-zero position of every (slab, tile,
// plane) as sum[((j * kTiles + tile) * kPlanes + p) * 2 + {0, 1}] (kB /
// -1 if none), and the histogram rows zeroed.
__global__ void __launch_bounds__(kThreads)
tokenize_summary_kernel(const int32_t* __restrict__ enc,
                        int32_t* __restrict__ sum, int32_t* __restrict__ hist,
                        int plane_len, int nr_planes, int nb_per) {
  __shared__ int s_first[kPlanes], s_last[kPlanes];
  enc += (int64_t)blockIdx.z * plane_len;
  sum += payload_sum(nb_per);
  hist += payload_row(nr_planes, nb_per) * kNSym;
  const int tile = blockIdx.x;
  const Slab s = slab_of(blockIdx.y, plane_len);
  const int i0 = tile * kTile + threadIdx.x * kPer;
  if (tile == 0) {
    for (int k = threadIdx.x; k < nr_planes * kNSym; k += kThreads)
      hist[((int64_t)(k / kNSym) * nb_per + s.j) * kNSym + k % kNSym] = 0;
  }
  if (threadIdx.x < kPlanes) {
    s_first[threadIdx.x] = kB;
    s_last[threadIdx.x] = -1;
  }
  int32_t v[kPer];
  load_words(enc, s, i0, v);
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (p >= nr_planes) break;
    int last, first;
    nz_bounds(v, p, i0, s.limit, last, first);
    last = __reduce_max_sync(rspt::kFull, last);
    first = __reduce_min_sync(rspt::kFull, first);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(&s_last[p], last);
      atomicMin(&s_first[p], first);
    }
  }
  __syncthreads();
  if (threadIdx.x < nr_planes) {
    int32_t* o = sum + ((int64_t)(s.j * kTiles + tile) * kPlanes +
                        threadIdx.x) * 2;
    o[0] = s_first[threadIdx.x];
    o[1] = s_last[threadIdx.x];
  }
}

// Without the summary pass: the last non-zero before the tile (dir < 0)
// or the first after it (dir > 0) of every plane, scanning whole tiles
// outward; -1 / kB if none. Every thread calls; the result goes to out.
__device__ void scan_outward(const int32_t* __restrict__ enc, const Slab& s,
                             int tile, int dir, int nr_planes, int* out,
                             int (*s_w)[kPlanes]) {
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kPlanes) out[threadIdx.x] = dir < 0 ? -1 : kB;
  __syncthreads();
  for (int t2 = tile + dir; t2 >= 0 && t2 * kTile < s.limit; t2 += dir) {
    const int i0 = t2 * kTile + threadIdx.x * kPer;
    int32_t v[kPer];
    load_words(enc, s, i0, v);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      int last, first;
      nz_bounds(v, p, i0, s.limit, last, first);
      const int x = dir < 0 ? __reduce_max_sync(rspt::kFull, last)
                            : __reduce_min_sync(rspt::kFull, first);
      if ((threadIdx.x & 31) == 0) s_w[warp][p] = x;
    }
    __syncthreads();
    if (threadIdx.x < nr_planes) {
      int x = out[threadIdx.x];
      const bool open = dir < 0 ? x < 0 : x == kB;
      for (int w = 0; open && w < kWarps; ++w)
        x = dir < 0 ? max(x, s_w[w][threadIdx.x]) : min(x, s_w[w][threadIdx.x]);
      out[threadIdx.x] = x;
    }
    __syncthreads();
    bool all = true;
    for (int p = 0; p < nr_planes; ++p)
      all = all && (dir < 0 ? out[p] >= 0 : out[p] < kB);
    if (all) break;
  }
}

__global__ void __launch_bounds__(kThreads)
tokenize_planes_kernel(const int32_t* __restrict__ enc,
                       const int32_t* __restrict__ sum,
                       int32_t* __restrict__ tokw,
                       int32_t* __restrict__ bwords,
                       int32_t* __restrict__ hist, int plane_len,
                       int nr_planes, int nb_per) {
  const int64_t row0 = payload_row(nr_planes, nb_per);
  enc += (int64_t)blockIdx.z * plane_len;
  sum += payload_sum(nb_per);
  tokw += row0 * kB;
  bwords += row0 * (kB / 4);
  hist += row0 * kNSym;
  __shared__ int h[kPlanes][kNSym];
  __shared__ int s_wl[kWarps][kPlanes], s_wf[kWarps][kPlanes];
  __shared__ int s_out[2][kPlanes];     // last before / first after the tile
  const int tile = blockIdx.x;
  const Slab s = slab_of(blockIdx.y, plane_len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = tile * kTile + tid * kPer;

  if (tile * kTile >= s.limit) {        // past the signal: zero words
    for (int p = 0; p < nr_planes; ++p) {
      const int64_t row = (int64_t)p * nb_per + s.j;
#pragma unroll
      for (int g = 0; g < kPer / 4; ++g) {
        reinterpret_cast<int4*>(tokw + row * kB + i0)[g] = make_int4(0, 0, 0, 0);
        bwords[row * (kB / 4) + i0 / 4 + g] = 0;
      }
    }
    return;
  }
  // the tile's outside bounds: warp 0 lane l holds tile l's summary
  int sl[kPlanes], sf[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    sl[p] = -1;
    sf[p] = kB;
  }
  if (kSummary && warp == 0) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p < nr_planes && lane < kTiles && lane != tile) {
        const int32_t* o = sum + ((int64_t)(s.j * kTiles + lane) * kPlanes +
                                  p) * 2;
        if (lane < tile) sl[p] = o[1];
        else sf[p] = o[0];
      }
    }
  }
  for (int k = tid; k < kPlanes * kNSym; k += kThreads) (&h[0][0])[k] = 0;
  int32_t v[kPer];
  load_words(enc, s, i0, v);
  if (!kSummary) {
    scan_outward(enc, s, tile, -1, nr_planes, s_out[0], s_wl);
    scan_outward(enc, s, tile, 1, nr_planes, s_out[1], s_wl);
  }

  // block scans, every plane at once: the last non-zero before each
  // thread's positions (forward max) and the first after them (reverse min)
  int pl[kPlanes], nf[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (p >= nr_planes) break;
    int last, first;
    nz_bounds(v, p, i0, s.limit, last, first);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(rspt::kFull, last, o);
      const int b = __shfl_down_sync(rspt::kFull, first, o);
      if (lane >= o) last = max(last, a);
      if (lane + o < 32) first = min(first, b);
    }
    pl[p] = __shfl_up_sync(rspt::kFull, last, 1);
    nf[p] = __shfl_down_sync(rspt::kFull, first, 1);
    if (lane == 0) pl[p] = -1;
    if (lane == 31) nf[p] = kB;
    if (lane == 31) s_wl[warp][p] = last;
    if (lane == 0) s_wf[warp][p] = first;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p >= nr_planes) break;
      int before = kSummary ? __reduce_max_sync(rspt::kFull, sl[p])
                            : s_out[0][p];
      int after = kSummary ? __reduce_min_sync(rspt::kFull, sf[p])
                           : s_out[1][p];
      int last = lane < kWarps ? s_wl[lane][p] : -1;
      int first = lane < kWarps ? s_wf[lane][p] : kB;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int a = __shfl_up_sync(rspt::kFull, last, o);
        const int b = __shfl_down_sync(rspt::kFull, first, o);
        if (lane >= o) last = max(last, a);
        if (lane + o < 32) first = min(first, b);
      }
      const int ex_l = __shfl_up_sync(rspt::kFull, last, 1);
      const int ex_f = __shfl_down_sync(rspt::kFull, first, 1);
      if (lane < kWarps) {
        s_wl[lane][p] = lane == 0 ? before : max(before, ex_l);
        s_wf[lane][p] = lane == kWarps - 1 ? after : min(after, ex_f);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (p >= nr_planes) break;
    const int64_t row = (int64_t)p * nb_per + s.j;
    int prev = max(s_wl[warp][p], pl[p]);
    const int next_after = min(s_wf[warp][p], nf[p]);
    int32_t w[kPer];
    int hsym = -1, hcnt = 0;
    uint32_t bw[kPer / 4] = {};
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = i0 + q;
      const int by = (v[q] >> (8 * p)) & 255;
      bw[q / 4] |= (uint32_t)by << (8 * (q & 3));
      const bool inb = i < s.limit;
      int sym = -1;
      w[q] = 0;
      if (by != 0 || !inb) {
        prev = i;
        if (inb) {
          w[q] = by | (1 << 27);
          sym = by;
        }
      } else if ((i - (prev + 1)) % kMZR == 0) {   // chunk start of a run
        int nxt = next_after;
#pragma unroll
        for (int r = kPer - 1; r > q; --r)
          if (((v[r] >> (8 * p)) & 255) != 0 || i0 + r >= s.limit) nxt = i0 + r;
        const int run_end = min(nxt, s.limit) - 1;
        w[q] = run_word(min(run_end - i + 1, kMZR));
        sym = w[q] & 511;
      }
      if (sym >= 0) {
        if (sym != hsym) {
          if (hcnt) atomicAdd(&h[p][hsym], hcnt);
          hsym = sym;
          hcnt = 0;
        }
        ++hcnt;
      }
    }
    if (hcnt) atomicAdd(&h[p][hsym], hcnt);
    int4* out4 = reinterpret_cast<int4*>(tokw + row * kB + i0);
#pragma unroll
    for (int g = 0; g < kPer / 4; ++g)
      out4[g] = make_int4(w[4 * g], w[4 * g + 1], w[4 * g + 2], w[4 * g + 3]);
#pragma unroll
    for (int g = 0; g < kPer / 4; ++g)
      bwords[row * (kB / 4) + i0 / 4 + g] = (int32_t)bw[g];
  }
  __syncthreads();
  for (int k = tid; k < nr_planes * kNSym; k += kThreads) {
    const int c = (&h[0][0])[k];
    if (c)
      atomicAdd(&hist[((int64_t)(k / kNSym) * nb_per + s.j) * kNSym +
                      k % kNSym], c);
  }
}

}  // namespace

// Tiles (blocks) a 64 KiB slab; the wrapper's summary scratch holds
// batch * nb_per * tiles * 8 int32.
extern "C" int rspt_tokenize_tiles() { return kTiles; }

// enc: batch x plane_len int32; sum: the summary scratch; tokw:
// (batch*nr_planes*nb_per, 65536) int32; bwords: (batch*nr_planes*nb_per,
// 16384) int32; hist: (batch*nr_planes*nb_per, 261) int32 (zeroed here).
// Rows are payload-major, then plane-major. Returns the first launch
// error (cudaGetLastError()).
extern "C" int rspt_tokenize_planes_batch(const void* enc, void* sum,
                                          void* tokw, void* bwords,
                                          void* hist, int plane_len,
                                          int nr_planes, int nb_per,
                                          int batch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(kTiles, nb_per, batch);
  if (kSummary) {
    tokenize_summary_kernel<<<grid, kThreads, 0, st>>>(
        (const int32_t*)enc, (int32_t*)sum, (int32_t*)hist, plane_len,
        nr_planes, nb_per);
  } else {
    cudaMemsetAsync(hist, 0,
                    (size_t)4 * batch * nr_planes * nb_per * kNSym, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tokenize_planes_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)enc, (int32_t*)sum, (int32_t*)tokw, (int32_t*)bwords,
      (int32_t*)hist, plane_len, nr_planes, nb_per);
  return (int)cudaGetLastError();
}

// One payload (rspt_tokenize_planes_batch with batch 1): rows plane-major.
extern "C" int rspt_tokenize_planes(const void* enc, void* sum, void* tokw,
                                    void* bwords, void* hist, int plane_len,
                                    int nr_planes, int nb_per, void* stream) {
  return rspt_tokenize_planes_batch(enc, sum, tokw, bwords, hist, plane_len,
                                    nr_planes, nb_per, 1, stream);
}
