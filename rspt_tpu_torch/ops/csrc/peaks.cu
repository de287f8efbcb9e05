// peaks: S4 peak_gate, the amplitude-gated state machine of the peak
// detectors (peak_detector.h:95-122). Replaces rspt_tpu/analysis/
// jax_peaks.py detect_batch.gate (:58-84) and _gate_scan.gate (:98-126),
// a lax.scan over time; no pallas_call.
//
// Per row (one channel), in float32 and in time order, with the state
// (prev_amp, prev_sig, searching, count) from (0, 0, false, 0):
//   confirm   = searching && s > thr * 1.5 && prev_sig > s
//   accept    = confirm && (prev_amp == 0 || prev_sig > prev_amp * 0.5)
//   attenuate = confirm && !accept
//   rising    = !confirm && prev_sig < s
//   prev_amp  = accept ? prev_sig : attenuate ? prev_amp * atten : prev_amp
//   count     = accept ? 1 : rising ? 0 : count;  count += count > 0
//   searching = accept ? false : rising ? true : searching
//   fire      = count == nr_slope (then count = 0)
//   out       = fire ? (marker == -1 ? s : marker) : 0;  prev_sig = s
// with atten = 1 / (1 + attenuation / sr) from the wrapper. The products
// are __fmul_rn (the comparisons read them rounded, as the plain version
// in ops/cuda_kernels.py does); a NaN compares false everywhere, as there.
//
// Design: one thread a row, serial in T: the state machine is one
// dependent chain, as the reference's loop. sig and thr are read 8
// samples ahead into registers. Bound: T times the chain's latency a step
// (a few dependent compares and selects), not bytes: with 12 rows the card
// is mostly idle.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;

__global__ void __launch_bounds__(kThreads)
    peak_gate_kernel(const float* __restrict__ sig,
                     const float* __restrict__ thr, float* __restrict__ out,
                     int rows, long n, int nr_slope, float atten,
                     float marker) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float* sr = sig + (size_t)r * n;
  const float* tr = thr + (size_t)r * n;
  float* orow = out + (size_t)r * n;
  float prev_amp = 0.0f, prev_sig = 0.0f;
  bool searching = false;
  int count = 0;
  for (long t = 0; t < n; t += kChunk) {
    float sb[kChunk], tb[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      sb[j] = t + j < n ? sr[t + j] : 0.0f;
      tb[j] = t + j < n ? tr[t + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float s = sb[j];
      const bool confirm =
          searching && (s > __fmul_rn(tb[j], 1.5f)) && (prev_sig > s);
      const bool accept =
          confirm && ((prev_amp == 0.0f) ||
                      (prev_sig > __fmul_rn(prev_amp, 0.5f)));
      const bool attenuate = confirm && !accept;
      const bool rising = !confirm && (prev_sig < s);
      prev_amp = accept ? prev_sig
                        : (attenuate ? __fmul_rn(prev_amp, atten) : prev_amp);
      count = accept ? 1 : (rising ? 0 : count);
      searching = accept ? false : (rising ? true : searching);
      if (count > 0) count += 1;
      const bool fire = count == nr_slope;
      if (fire) count = 0;
      sb[j] = fire ? (marker == -1.0f ? s : marker) : 0.0f;
      prev_sig = s;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (t + j < n) orow[t + j] = sb[j];
  }
}

}  // namespace

// sig, thr, out: (rows, n) float32. rows, n >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int rspt_peak_gate(const void* sig, const void* thr, void* out,
                              int rows, long n, int nr_slope, float atten,
                              float marker, void* stream) {
  peak_gate_kernel<<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const float*)sig, (const float*)thr, (float*)out, rows, n, nr_slope,
      atten, marker);
  return (int)cudaGetLastError();
}
