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
// Design: exact chunk-parallel speculation, then a repair walk. An accept
// sets prev_amp = prev_sig, count = 1 and searching = false whatever the
// state was, and prev_sig is always the previous sample: two runs of the
// gate that accept at the same sample are equal from then on, and a run
// started from a guessed state a little before a chunk is almost always
// the serial run by the chunk's start. Each row is cut into chunks of
// `chunk` samples (kChunk unless the caller says otherwise).
//   1. speculate: a thread a (row, chunk k); a CTA is one warp of kLanes
//      consecutive chunks of one row. Chunk k's thread starts `warm`
//      samples before it (kWarm; clamped at the row's start, where its
//      state is the true zero state) from (0, sig[kC - warm - 1] or 0,
//      false, 0), runs the warm-up without writing, records the state it
//      guesses at kC, then runs its chunk: out, a checkpoint of the state
//      every kCkpt samples, its end state. sig and thr reach the steps
//      through shared memory: a stage holds a strip of kSlab samples of
//      each of the CTA's chunks, copied by cp.async (a coalesced
//      warp-wide copy a strip) kStages - 1 stages ahead; the outputs go
//      back through shared memory, a coalesced store a strip.
//   2. repair: a warp a row walks its chunks in order. Chunk k stands if
//      the bits of its guessed start equal the exact end of chunk k - 1
//      (while the speculative ends are exact, ballots over kWindow chunks
//      at a time leave one bit a chunk, and the walk skips to the next
//      clear bit). Otherwise lane 0 re-runs chunk k from the exact state,
//      rewriting out, until its state equals the speculative checkpoint
//      (or end state) there bit for bit: from there the speculative
//      outputs and end stand. A re-run that never merges runs to the
//      chunk's end, and its end state is the exact start of chunk k + 1.
//      The re-run stages kSeg samples at a time in shared memory.
// States compare by their bits: 0.0 == -0.0 and NaN != NaN as floats;
// as bits both are conservative (a re-run), never wrong. So the result is
// the serial result by construction, whatever the data; a row that never
// merges degrades to a serial walk. The repair counts, a row, the chunks
// and the samples it re-ran.
// Bound: the work's bytes (12 B a sample); the design's own, (warm +
// chunk) dependent steps a thread and (chunk + warm) / chunk reads of
// each input sample.
#include "common.cuh"

namespace {

constexpr int kChunk = 1024;     // samples a chunk (the default)
constexpr int kWarm = 512;       // warm-up samples before a chunk (default)
constexpr int kCkpt = 64;        // samples between checkpoints
constexpr int kLanes = 32;       // chunks a CTA of the speculation: a warp
constexpr int kSlab = 32;        // samples of each strip a stage
constexpr int kStages = 4;       // stages in the ring
constexpr int kPad = kSlab + 1;  // strip stride: no bank conflicts
constexpr int kSeg = 256;        // samples a re-run stages at once
constexpr int kWindow = 1024;    // chunks whose guesses the repair tests
                                 // at once

struct Gate {
  int nr_slope;
  float atten, marker;
};

struct Args {
  const float* sig;
  const float* thr;
  float* out;
  uint4* guess;     // (rows, nk): the state guessed at each chunk's start
  uint4* ends;      // (rows, nk): the speculative end states
  uint4* ckpt;      // (rows, nk, nck): the states every kCkpt samples
  long long* reruns;  // (rows, 2): chunks and samples re-run
  long n;
  int chunk, warm, nk, nck, ctas;  // ctas: speculation CTAs a row
  Gate g;
};

struct State {
  float amp, sig;
  int count, searching;
};

__device__ __forceinline__ uint4 bits_of(const State& s) {
  return make_uint4(__float_as_uint(s.amp), __float_as_uint(s.sig),
                    (unsigned)s.count, (unsigned)s.searching);
}

__device__ __forceinline__ State state_of(uint4 b) {
  return State{__uint_as_float(b.x), __uint_as_float(b.y), (int)b.z,
               (int)b.w};
}

// The samples of a chunk of `chunk` with `rest` samples left in the row.
__device__ __forceinline__ int length(int chunk, long rest) {
  return rest < chunk ? (int)rest : chunk;
}

__device__ __forceinline__ bool same(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// One step at sample s with threshold t; returns the output. Every
// condition is evaluated (& and |, no short circuit): straight-line code,
// no branch a step.
__device__ __forceinline__ float step(State& st, float s, float t,
                                      const Gate& g) {
  const bool confirm =
      (st.searching != 0) & (s > __fmul_rn(t, 1.5f)) & (st.sig > s);
  const bool accept =
      confirm & ((st.amp == 0.0f) | (st.sig > __fmul_rn(st.amp, 0.5f)));
  const bool rising = !confirm & (st.sig < s);
  st.amp = accept ? st.sig : (confirm ? __fmul_rn(st.amp, g.atten) : st.amp);
  int count = accept ? 1 : (rising ? 0 : st.count);
  st.searching = accept ? 0 : (rising ? 1 : st.searching);
  count += count > 0;
  const bool fire = count == g.nr_slope;
  st.count = fire ? 0 : count;
  st.sig = s;
  return fire ? (g.marker == -1.0f ? s : g.marker) : 0.0f;
}

__global__ void __launch_bounds__(kLanes) gate_speculate(Args a) {
  __shared__ float s_in[kStages][2][kLanes][kPad];
  __shared__ float s_out[kLanes][kPad];
  const int lane = threadIdx.x;
  const int r = blockIdx.x / a.ctas;
  const int k0 = (blockIdx.x - r * a.ctas) * kLanes;
  const int nc = min(kLanes, a.nk - k0);  // chunks of this CTA
  const size_t row = (size_t)r * a.n;
  const float* sr = a.sig + row;
  const float* tr = a.thr + row;
  const long c0 = (long)(k0 + lane) * a.chunk;  // the chunk's first sample
  const int len = lane < nc ? length(a.chunk, a.n - c0) : 0;
  // active steps: from the row's first sample (before it the state stays
  // the zero state) to the chunk's end
  const int lead = a.warm > c0 ? a.warm - (int)c0 : 0;
  const int last = len ? a.warm + len : 0;
  const long p0 = c0 - a.warm;  // the sample of step 0
  const size_t slot = (size_t)r * a.nk + k0 + lane;
  State st{0.0f, len && p0 >= 1 ? sr[p0 - 1] : 0.0f, 0, 0};
  // steps of the CTA: lane 0's chunk is its longest
  const int span = a.warm + length(a.chunk, a.n - (long)k0 * a.chunk);
  const int nslab = (span + kSlab - 1) / kSlab;
  if (a.nk == 1 && lane == 0) {  // no repair launch: nothing re-run
    a.reruns[2 * r] = 0;
    a.reruns[2 * r + 1] = 0;
  }

  auto fetch = [&](int sl) {  // stage sl: column `lane` of every strip
    const long off = (long)sl * kSlab + lane - a.warm;
    float(*buf)[kLanes][kPad] = s_in[sl % kStages];
    for (int j = 0; j < nc; ++j) {
      const long q = (long)(k0 + j) * a.chunk + off;
      const bool ok = q >= 0 && q < a.n;
      rspt::cp_async_zfill<4>(&buf[0][j][lane], sr + (ok ? q : 0), ok);
      rspt::cp_async_zfill<4>(&buf[1][j][lane], tr + (ok ? q : 0), ok);
    }
  };

  for (int sl = 0; sl < kStages - 1; ++sl) {
    if (sl < nslab) fetch(sl);
    rspt::cp_async_commit();
  }
  for (int sl = 0; sl < nslab; ++sl) {
    if (sl + kStages - 1 < nslab) fetch(sl + kStages - 1);
    rspt::cp_async_commit();
    rspt::cp_async_wait<kStages - 1>();
    __syncthreads();
    const float(*in)[kLanes][kPad] = s_in[sl % kStages];
    // straight-line steps: each computed, kept where the lane is active
    // (columns [on, off)), the rare state stores predicated
    const int on = lead - sl * kSlab, off = last - sl * kSlab;
    const int o0 = sl * kSlab - a.warm;  // the chunk offset of column 0
#pragma unroll 8
    for (int c = 0; c < kSlab; ++c) {
      const int o = o0 + c;
      if (o == 0 && len) a.guess[slot] = bits_of(st);
      State nx = st;
      const float y = step(nx, in[0][lane][c], in[1][lane][c], a.g);
      const bool act = c >= on && c < off;
      st.amp = act ? nx.amp : st.amp;
      st.sig = act ? nx.sig : st.sig;
      st.count = act ? nx.count : st.count;
      st.searching = act ? nx.searching : st.searching;
      s_out[lane][c] = act ? y : 0.0f;
      const bool end = act && o + 1 == len;
      if (end) a.ends[slot] = bits_of(st);
      if (act && !end && o >= 0 && ((o + 1) & (kCkpt - 1)) == 0)
        a.ckpt[slot * a.nck + ((unsigned)(o + 1) / kCkpt - 1)] = bits_of(st);
    }
    __syncthreads();
    const int o = sl * kSlab + lane - a.warm;
    for (int j = 0; j < nc; ++j) {
      const long cj = (long)(k0 + j) * a.chunk;
      if (o >= 0 && o < a.chunk && cj + o < a.n)
        a.out[row + cj + o] = s_out[j][lane];
    }
  }
}

__global__ void __launch_bounds__(32) gate_repair(Args a) {
  __shared__ float s_sig[kSeg], s_thr[kSeg], s_out[kSeg];
  __shared__ uint4 s_ck[kSeg / kCkpt];
  __shared__ unsigned s_match[kWindow / 32];
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const size_t row = (size_t)r * a.n;
  const uint4* guess = a.guess + (size_t)r * a.nk;
  const uint4* ends = a.ends + (size_t)r * a.nk;
  long long chunks = 0, samples = 0;
  bool spec = true;  // chunk k - 1's exact end is ends[k - 1]
  uint4 exact = make_uint4(0u, 0u, 0u, 0u);  // else it is this
  for (int w0 = 1; w0 < a.nk; w0 += kWindow) {
    const int wend = min(w0 + kWindow, a.nk);
    // bit j of word g: chunk w0 + 32 g + j's guess equals the speculative
    // end of the chunk before it
#pragma unroll 4
    for (int g = 0; g < kWindow / 32; ++g) {
      const int kk = w0 + g * 32 + lane;
      const unsigned m = __ballot_sync(
          rspt::kFull, kk < wend && same(guess[kk], ends[kk - 1]));
      if (lane == 0) s_match[g] = m;
    }
    __syncwarp();
    for (int k = w0; k < wend; ++k) {
      if (spec) {  // skip to the next chunk whose guess missed
        const int off = k - w0;
        const unsigned rest = ~s_match[off >> 5] >> (off & 31);
        if (!rest) {
          k = w0 + (off | 31);
          continue;
        }
        k += __ffs(rest) - 1;
        if (k >= wend) break;
        exact = ends[k - 1];
      } else if (same(exact, guess[k])) {
        spec = true;
        continue;
      }
      // re-run chunk k from `exact`, until it merges
      const long c0 = (long)k * a.chunk;
      const int len = length(a.chunk, a.n - c0);
      const uint4* ck = a.ckpt + ((size_t)r * a.nk + k) * a.nck;
      State st = state_of(exact);
      bool merged = false;
      for (int o0 = 0; o0 < len && !merged; o0 += kSeg) {
        const int m = min(kSeg, len - o0);
        for (int i = lane; i < m; i += 32) {
          s_sig[i] = a.sig[row + c0 + o0 + i];
          s_thr[i] = a.thr[row + c0 + o0 + i];
        }
        const int c = o0 / kCkpt + lane;
        if (lane < kSeg / kCkpt && c < a.nck) s_ck[lane] = ck[c];
        __syncwarp();
        int stop = m;
        if (lane == 0) {
          for (int i = 0; i < m; ++i) {
            s_out[i] = step(st, s_sig[i], s_thr[i], a.g);
            const int o = o0 + i + 1;  // samples re-run
            if (o == len) {
              merged = same(bits_of(st), ends[k]);
            } else if ((o & (kCkpt - 1)) == 0 &&
                       same(bits_of(st), s_ck[(o - o0) / kCkpt - 1])) {
              merged = true;
              stop = i + 1;
              break;
            }
          }
        }
        stop = __shfl_sync(rspt::kFull, stop, 0);
        merged = __shfl_sync(rspt::kFull, merged, 0);
        __syncwarp();
        for (int i = lane; i < stop; i += 32)
          a.out[row + c0 + o0 + i] = s_out[i];
        __syncwarp();
        samples += stop;
      }
      uint4 b = bits_of(st);
      b.x = __shfl_sync(rspt::kFull, b.x, 0);
      b.y = __shfl_sync(rspt::kFull, b.y, 0);
      b.z = __shfl_sync(rspt::kFull, b.z, 0);
      b.w = __shfl_sync(rspt::kFull, b.w, 0);
      exact = b;
      spec = merged;
      chunks += 1;
    }
    __syncwarp();
  }
  if (lane == 0) {
    a.reruns[2 * r] = chunks;
    a.reruns[2 * r + 1] = samples;
  }
}

}  // namespace

// The default schedule: out[0] = samples a chunk, out[1] = warm-up
// samples, out[2] = samples between checkpoints. Returns 0.
extern "C" int rspt_peak_gate_schedule(int* out) {
  out[0] = kChunk;
  out[1] = kWarm;
  out[2] = kCkpt;
  return 0;
}

// sig, thr, out: (rows, n) float32, rows, n >= 1; chunk in 1 .. n and
// warm >= 0 with chunk + warm < 2^31; nk = ceil(n / chunk) chunks a row,
// rows * nk < 2^31; nck = (chunk - 1) / kCkpt checkpoints a chunk. state:
// rows * nk * (2 + nck) 16-byte words of scratch (the guesses, the ends,
// the checkpoints); reruns: (rows, 2) int64, written. Two launches (one if
// nk == 1); returns the first cudaGetLastError().
extern "C" int rspt_peak_gate(const void* sig, const void* thr, void* out,
                              void* state, void* reruns, int rows, long n,
                              int chunk, int warm, int nr_slope, float atten,
                              float marker, void* stream) {
  Args a;
  a.sig = (const float*)sig;
  a.thr = (const float*)thr;
  a.out = (float*)out;
  a.n = n;
  a.chunk = chunk;
  a.warm = warm;
  a.nk = (int)((n + chunk - 1) / chunk);
  a.nck = (chunk - 1) / kCkpt;
  a.ctas = (a.nk + kLanes - 1) / kLanes;
  a.guess = (uint4*)state;
  a.ends = a.guess + (size_t)rows * a.nk;
  a.ckpt = a.ends + (size_t)rows * a.nk;
  a.reruns = (long long*)reruns;
  a.g = Gate{nr_slope, atten, marker};
  cudaStream_t st = (cudaStream_t)stream;
  gate_speculate<<<rows * a.ctas, kLanes, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err || a.nk == 1) return err;
  gate_repair<<<rows, 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
