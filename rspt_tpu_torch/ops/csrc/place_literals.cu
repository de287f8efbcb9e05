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
// from a block's padding bits), out[pos] = sym & 0xFF. Positions of live
// literals are unique, so plain byte stores are race-free and the output
// is deterministic; zero runs need no writes (the caller zeroes `out` or
// hands in the host-resolved bytes, zero over every device block).
//
// Design: a (tiles, kSplit) grid of 1024-thread blocks; block (t, y)
// handles steps y, y + kSplit, ... below the tile's step count, one
// thread per lane, so each step row is one coalesced 4 KiB read. The
// lane's base, limit and liveness load once.
// Bound: bytes - the emission rows below each tile's step count read
// once, the output written once; the byte stores are scattered (each
// lane writes its own run of positions).
#include "common.cuh"

namespace {

constexpr int kLanes = 1024;
constexpr int kSplit = 16;

__global__ void __launch_bounds__(kLanes)
place_literals_kernel(const int32_t* __restrict__ emis,
                      const int32_t* __restrict__ steps,
                      const int32_t* __restrict__ out_base,
                      const int32_t* __restrict__ out_limit,
                      const uint8_t* __restrict__ lane_live,
                      uint8_t* __restrict__ out, int S, int total) {
  const int t = blockIdx.x;
  const int gl = t * kLanes + threadIdx.x;
  if (!lane_live[gl]) return;
  const int n = min(steps[t], S);
  const int base = out_base[gl];
  const int lim = min(out_limit[gl], total);
  const int32_t* e = emis + (int64_t)t * S * kLanes + threadIdx.x;
  for (int s = blockIdx.y; s < n; s += kSplit) {
    const int32_t v = e[(int64_t)s * kLanes];
    const int sym = v & 0x1FF;
    if (sym) {
      const int pos = base + (v >> 9);
      if (pos >= 0 && pos < lim) out[pos] = (uint8_t)sym;
    }
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
  place_literals_kernel<<<dim3(nt, kSplit), kLanes, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)emis, (const int32_t*)steps, (const int32_t*)out_base,
      (const int32_t*)out_limit, (const uint8_t*)lane_live, (uint8_t*)out, S,
      total);
  return (int)cudaGetLastError();
}
