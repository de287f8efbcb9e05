// tokenize_planes: byte-plane extract + zero-run RLE tokenize + 261-bin
// histogram, one CUDA block per (64 KiB slab, plane).
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
// Design: the slab's plane bytes go to shared memory once (coalesced
// reads of the int32 signal). Each of 1024 threads owns 64 consecutive
// positions; the run boundaries that cross thread segments come from two
// block scans (exclusive max of the last "non-zero" position before the
// segment, exclusive suffix min of the first one after it) - the block
// form of the TPU kernel's row/lane doubling scans. The walk inside a
// segment is serial. The histogram lives in shared memory; each thread
// merges runs of equal symbols before its atomicAdd, so a slab of one
// repeated byte does not serialise on one counter.
// Bound: bytes - per block, 256 KB of int32 signal read, 256 KB of token
// words and 64 KB of plane bytes written.
#include "common.cuh"

namespace {

constexpr int kB = 65536;       // positions per slab (MAX_BLOCK_SIZE)
constexpr int kThreads = 1024;
constexpr int kPer = kB / kThreads;  // 64 positions per thread
constexpr int kMZR = 16662;     // MAX_ZERO_RUN
constexpr int kNSym = 261;

__device__ __forceinline__ bool is_zero(const unsigned char* bytes, int i,
                                        int limit) {
  return bytes[i] == 0 && i < limit;
}

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

__device__ __forceinline__ void hist_flush(int* h, int sym, int cnt) {
  if (cnt) atomicAdd(&h[sym], cnt);
}

struct TokState {
  int prev;   // last non-zero position before the current one
  int nxt;    // cached first non-zero at or after it (stale if < it)
  int hsym;   // symbol of the pending histogram run
  int hcnt;   // its count
};

// Token word of segment position k (absolute i = s0 + k); advances st.
__device__ __forceinline__ int32_t token_at(const unsigned char* bytes,
                                            int s0, int k, int limit,
                                            int next_after, int* h,
                                            TokState& st) {
  const int i = s0 + k;
  const int by = bytes[i];
  const bool inb = i < limit;
  int32_t word = 0;
  int sym = -1;
  if (!(by == 0 && inb)) {
    st.prev = i;
    if (inb) {
      word = by | (1 << 27);
      sym = by;
    }
  } else if ((i - (st.prev + 1)) % kMZR == 0) {   // chunk start of a run
    if (st.nxt < i) {
      st.nxt = next_after;
      for (int m = k + 1; m < kPer; ++m) {
        if (!is_zero(bytes, s0 + m, limit)) {
          st.nxt = s0 + m;
          break;
        }
      }
    }
    const int run_end = min(st.nxt, limit) - 1;
    word = run_word(min(run_end - i + 1, kMZR));
    sym = word & 511;
  }
  if (sym >= 0) {
    if (sym != st.hsym) {
      hist_flush(h, st.hsym, st.hcnt);
      st.hsym = sym;
      st.hcnt = 0;
    }
    ++st.hcnt;
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
tokenize_planes_kernel(const int32_t* __restrict__ enc,
                       int32_t* __restrict__ tokw,
                       int32_t* __restrict__ bwords,
                       int32_t* __restrict__ hist, int plane_len,
                       int nb_per) {
  extern __shared__ unsigned char bytes[];   // kB plane bytes
  __shared__ int h[kNSym];
  __shared__ int scratch[32];

  const int j = blockIdx.x;                  // slab within the plane
  const int p = blockIdx.y;                  // plane
  const int64_t row = (int64_t)p * nb_per + j;
  const int tid = threadIdx.x;
  const int64_t slab0 = (int64_t)j * kB;
  const int64_t left = (int64_t)plane_len - slab0;
  const int limit = left < kB ? (int)left : kB;

  for (int k = tid; k < kNSym; k += kThreads) h[k] = 0;

  // plane bytes: shared copy + packed words (4 coalesced reads a word)
  int32_t* bw_row = bwords + row * (kB / 4);
  for (int w = tid; w < kB / 4; w += kThreads) {
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pos = 4 * w + q;
      uint32_t v = pos < limit ? (uint32_t)enc[slab0 + pos] : 0u;
      uint32_t by = (v >> (8 * p)) & 255u;
      bytes[pos] = (unsigned char)by;
      word |= by << (8 * q);
    }
    bw_row[w] = (int32_t)word;
  }
  __syncthreads();

  // segment summaries: last / first position that is not an in-block
  // zero ("non-zero"; positions >= limit count as non-zero)
  const int s0 = tid * kPer;
  int last_nz = -1, first_nz = kB;
  for (int k = 0; k < kPer; ++k) {
    const int i = s0 + k;
    if (!is_zero(bytes, i, limit)) {
      last_nz = i;
      if (first_nz == kB) first_nz = i;
    }
  }
  int prev = rspt::block_scan_excl(last_nz, -1, rspt::OpMax(), false,
                                   scratch, nullptr);
  const int next_after = rspt::block_scan_excl(first_nz, kB, rspt::OpMin(),
                                               true, scratch, nullptr);

  int4* out4 = reinterpret_cast<int4*>(tokw + row * kB + s0);
  TokState st{prev, -1, 0, 0};
  for (int g = 0; g < kPer / 4; ++g) {
    int32_t w4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w4[q] = token_at(bytes, s0, 4 * g + q, limit, next_after, h, st);
    out4[g] = make_int4(w4[0], w4[1], w4[2], w4[3]);
  }
  hist_flush(h, st.hsym, st.hcnt);
  __syncthreads();
  for (int k = tid; k < kNSym; k += kThreads) hist[row * kNSym + k] = h[k];
}

}  // namespace

// enc: plane_len int32; tokw: (nr_planes*nb_per, 65536) int32; bwords:
// (nr_planes*nb_per, 16384) int32; hist: (nr_planes*nb_per, 261) int32.
// Rows are plane-major. Returns cudaGetLastError().
extern "C" int rspt_tokenize_planes(const void* enc, void* tokw, void* bwords,
                                    void* hist, int plane_len, int nr_planes,
                                    int nb_per, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tokenize_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kB);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nb_per, nr_planes);
  tokenize_planes_kernel<<<grid, kThreads, kB, (cudaStream_t)stream>>>(
      (const int32_t*)enc, (int32_t*)tokw, (int32_t*)bwords, (int32_t*)hist,
      plane_len, nb_per);
  return (int)cudaGetLastError();
}
