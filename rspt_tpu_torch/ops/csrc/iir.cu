// iir: the batched IIR filter of the batch signal ops, both of
// rspt_tpu/filters/jax_filters.py's modes. No pallas_call: the JAX package
// runs them on XLA primitives.
//
//   S1 iir_scan   replaces _iir_apply mode="scan" (jax_filters.py:96-108,
//                 the lax.scan step) with _feedforward (:47-65)
//   S2 iir_assoc  replaces _iir_apply mode="assoc" (:109-126, the
//                 lax.associative_scan of the companion affine maps)
//
// The filter of each row (one channel) is
//   u[t] = the sum over i = 0 .. p-1, from 0 and in that order, of
//          d[i] * x[t - i]       (x[t - i] for t - i < 0 is the history
//                                 xz[i - t - 1], xz[0] the newest)
//   y[t] = u[t] - n[1] * y[t - 1] - n[2] * y[t - 2] - ... - n[p-1] *
//          y[t - p + 1], the subtractions in that order (the reference's
//          filter_opt order, iir_filter.cpp:26-44; y before t = 0 is
//          the history yz, yz[0] the newest).
// Every product, sum and difference is rounded as a float or double of
// the input's type: the intrinsics __fmul_rn / __fadd_rn / __fsub_rn and
// __dmul_rn / __dadd_rn / __dsub_rn are never contracted into an FMA,
// whatever the build's -fmad setting, so the plain PyTorch versions
// (ops/cuda_kernels.py) give the same bits.
//
// S1: a CTA a row, serial in T (the recurrence's own shape, as the
// reference's loop; split in time it could not keep the serial bits: the
// detectors' narrow low-pass keeps ulp-level differences alive). The
// chain is y[t - 1] -> y[t]: one multiply and M subtractions (the order
// p - 1 = M is a template argument, 1 .. 7), about 4 + 4M cycles a step
// in f32. Everything else leaves that chain alone. The CTA walks the row
// in slabs of kSlab samples; in the step for slab i:
//   - lane 0 of warp 0 runs the feedback of slab i alone: u from shared
//     memory into registers kUnroll samples ahead, y into a shared slab;
//   - warps 1-3 compute the feedforward u of slab i + 1 (x from a ring of
//     kRing slabs in shared memory, xz before t = 0), store y of slab
//     i - 1 coalesced, and copy x's slab i + kAhead + 1 in by cp.async
//     (the ring holds slabs i .. i + kAhead + 1);
// and one barrier ends the step. Splitting u off the chain changes no
// bit: u[t] does not depend on y. Bound: T times the chain's latency,
// not bytes (12 rows use 12 SMs).
//
// S2: the same recurrence over tiles of L samples, in three launches.
//   1. local: a thread a (row, tile) runs the tile's recurrence serially
//      from a zero state (its feedforward reads the real history) and
//      writes y_loc and the tile's end state e_k (its last M y_loc, the
//      newest first);
//   2. carry: a thread a row walks the tiles: s_0 = yz, s_{k+1}[i] =
//      (the sum over c, from 0 in order, of A^L[i][c] * s_k[c]) + e_k[i];
//   3. fix-up: a thread an output: y[kL + j] = y_loc[kL + j] + (the sum
//      over c, from 0 in order, of P[j][c] * s_k[c]), P[j] = row 0 of
//      A^(j+1).
// A is the companion matrix of the feedback (row 0 = -n[1:], the
// subdiagonal 1). The wrapper builds A^L and P from f64 powers, stored in
// the input's type. The carry pass is a serial chain of T / L steps a row
// (a second serial pass over the tiles, not a look-back: the plain
// version's order); the local and fix-up passes spread over the card.
#include "common.cuh"

namespace {

constexpr int kMaxP = 8;        // coefficients (order 7)
constexpr int kChunk = 8;       // samples read ahead a thread (S2)
constexpr int kThreads = 128;
constexpr int kSlab = 512;      // samples a slab (S1)
constexpr int kRing = 6;        // x slabs in shared memory (S1)
constexpr int kAhead = kRing - 2;  // slabs S1 copies ahead
constexpr int kUnroll = 16;     // u read ahead by S1's chain lane
constexpr int kWorkers = kThreads - 32;  // S1's warps 1-3

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

template <typename T>
struct Coefs {
  T n[kMaxP];   // feedback, n[0] unused
  T d[kMaxP];   // feedforward
};

// One step: xh[0 .. M] = x[t], x[t-1], ..., s[0 .. M-1] = y[t-1], ...;
// returns y[t] and shifts it into s.
template <typename T, int M>
__device__ __forceinline__ T step(const T (&xh)[M + 1], T (&s)[M],
                                  const Coefs<T>& c) {
  T u = T(0);
#pragma unroll
  for (int i = 0; i <= M; ++i) u = add_rn(u, mul_rn(c.d[i], xh[i]));
  T y = u;
#pragma unroll
  for (int i = 0; i < M; ++i) y = sub_rn(y, mul_rn(c.n[i + 1], s[i]));
#pragma unroll
  for (int i = M - 1; i > 0; --i) s[i] = s[i - 1];
  s[0] = y;
  return y;
}

// The recurrence over x[t0 .. t1) of one row, y written to y[t0 .. t1).
// xh[0 .. M-1] hold x[t0-1], x[t0-2], ... on entry; s the y history.
template <typename T, int M>
__device__ __forceinline__ void run(const T* __restrict__ x,
                                    T* __restrict__ y, long t0, long t1,
                                    T (&xh)[M + 1], T (&s)[M],
                                    const Coefs<T>& c) {
  for (long t = t0; t < t1; t += kChunk) {
    T buf[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) buf[j] = t + j < t1 ? x[t + j] : T(0);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (t + j < t1) {
#pragma unroll
        for (int i = M; i > 0; --i) xh[i] = xh[i - 1];
        xh[0] = buf[j];
        buf[j] = step<T, M>(xh, s, c);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (t + j < t1) y[t + j] = buf[j];
  }
}

// x[t0 - 1 - i] for i = 0 .. M-1 into xh[i]: from x where t0 - 1 - i >= 0,
// else from the history xz (M values, the newest first).
template <typename T, int M>
__device__ __forceinline__ void load_history(const T* __restrict__ x,
                                             const T* __restrict__ xz,
                                             long t0, T (&xh)[M + 1]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const long tau = t0 - 1 - i;
    xh[i] = tau >= 0 ? x[tau] : xz[-tau - 1];
  }
  xh[M] = T(0);
}

// S1's feedback over a slab (lane 0): y[j] = u[j] - n[1] s[0] - ... -
// n[M] s[M-1] for j < m (every j when not kPartial), the history s
// shifted; u read from shared memory kUnroll values ahead.
template <typename T, int M, bool kPartial>
__device__ __forceinline__ void chain_block(const T (&ub)[kUnroll],
                                            T* __restrict__ y, int j0, int m,
                                            T (&s)[M], const Coefs<T>& c) {
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (!kPartial || j0 + q < m) {
      T v = ub[q];
#pragma unroll
      for (int k = 0; k < M; ++k) v = sub_rn(v, mul_rn(c.n[k + 1], s[k]));
#pragma unroll
      for (int k = M - 1; k > 0; --k) s[k] = s[k - 1];
      s[0] = v;
      y[j0 + q] = v;
    }
  }
}

template <typename T, int M, bool kPartial>
__device__ __forceinline__ void chain_slab(const T* __restrict__ u,
                                           T* __restrict__ y, int m,
                                           T (&s)[M], const Coefs<T>& c) {
  // two register blocks in turns: one is read from u while the other's
  // steps run
  T a[kUnroll], b[kUnroll];
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) a[q] = u[q];
  for (int j0 = 0; j0 < m; j0 += 2 * kUnroll) {
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) b[q] = u[j0 + kUnroll + q];
    chain_block<T, M, kPartial>(a, y, j0, m, s, c);
    if (j0 + 2 * kUnroll < kSlab) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) a[q] = u[j0 + 2 * kUnroll + q];
    }
    chain_block<T, M, kPartial>(b, y, j0 + kUnroll, m, s, c);
  }
}

// S1: a CTA a row (see the top).
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    iir_scan_kernel(const T* __restrict__ x, const T* __restrict__ xz,
                    const T* __restrict__ yz, T* __restrict__ y, long n,
                    Coefs<T> c) {
  __shared__ T s_x[kRing][kSlab];
  __shared__ T s_u[2][kSlab];
  __shared__ T s_y[2][kSlab];
  const int tid = threadIdx.x;
  const int w = tid - 32;  // worker index (warps 1-3)
  const T* xr = x + (size_t)blockIdx.x * n;
  const T* xzr = xz + (size_t)blockIdx.x * M;
  T* yr = y + (size_t)blockIdx.x * n;
  const long ns = (n + kSlab - 1) / kSlab;

  auto fetch = [&](long s) {  // workers: x's slab s into the ring
    if (s < ns) {
      T* dst = s_x[s % kRing];
      for (int i = w; i < kSlab; i += kWorkers) {
        const long t = s * kSlab + i;
        rspt::cp_async_zfill<sizeof(T)>(dst + i, xr + (t < n ? t : 0), t < n);
      }
    }
    rspt::cp_async_commit();
  };
  auto x_at = [&](long t) -> T {  // x[t] from the ring, or the history
    return t >= 0 ? s_x[(t / kSlab) % kRing][t % kSlab] : xzr[-t - 1];
  };

  if (tid >= 32) {
    for (int k = 0; k < kAhead; ++k) fetch(k);
    rspt::cp_async_wait<kAhead - 1>();  // slab 0 is in
  }
  __syncthreads();
  T s[M];  // lane 0's y history, the newest first
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = yz[(size_t)blockIdx.x * M + i];
  for (long i = -1; i <= ns; ++i) {
    if (tid == 0 && i >= 0 && i < ns) {  // the chain, slab i
      if (n - i * kSlab >= kSlab) {
        chain_slab<T, M, false>(s_u[i & 1], s_y[i & 1], kSlab, s, c);
      } else {
        chain_slab<T, M, true>(s_u[i & 1], s_y[i & 1], (int)(n - i * kSlab),
                               s, c);
      }
    } else if (tid >= 32) {
      if (i + 1 < ns) {  // the feedforward, slab i + 1
        T* u = s_u[(i + 1) & 1];
        for (int j = w; j < kSlab; j += kWorkers) {
          const long t = (i + 1) * kSlab + j;
          T acc = T(0);
#pragma unroll
          for (int k = 0; k <= M; ++k)
            acc = add_rn(acc, mul_rn(c.d[k], x_at(t - k)));
          u[j] = acc;
        }
      }
      if (i >= 1) {  // the stores, slab i - 1
        const T* yo = s_y[(i - 1) & 1];
        const long t0 = (i - 1) * kSlab;
        for (int j = w; j < kSlab && t0 + j < n; j += kWorkers)
          yr[t0 + j] = yo[j];
      }
      fetch(i + kAhead + 1);
      rspt::cp_async_wait<kAhead - 1>();  // slab i + 2 is in
    }
    __syncthreads();
  }
}

// S2, pass 1: a thread a (row, tile).
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    iir_local_kernel(const T* __restrict__ x, const T* __restrict__ xz,
                     T* __restrict__ y, T* __restrict__ ends, int rows,
                     long n, int L, int nt, Coefs<T> c) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long)rows * nt) return;
  const long r = idx / nt, k = idx - r * nt;
  const long t0 = k * L, t1 = t0 + L < n ? t0 + L : n;
  T xh[M + 1], s[M];
  load_history<T, M>(x + r * n, xz + r * M, t0, xh);
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = T(0);
  run<T, M>(x + r * n, y + r * n, t0, t1, xh, s, c);
#pragma unroll
  for (int i = 0; i < M; ++i) ends[idx * M + i] = s[i];
}

// S2, pass 2: a thread a row, serial over its tiles.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    iir_carry_kernel(const T* __restrict__ yz, const T* __restrict__ ends,
                     const T* __restrict__ al, T* __restrict__ starts,
                     int rows, int nt) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  T a[M][M], s[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    s[i] = yz[(size_t)r * M + i];
#pragma unroll
    for (int j = 0; j < M; ++j) a[i][j] = al[i * M + j];
  }
  const size_t base = (size_t)r * nt * M;
  for (int k = 0; k < nt; ++k) {
#pragma unroll
    for (int i = 0; i < M; ++i) starts[base + (size_t)k * M + i] = s[i];
    if (k + 1 == nt) break;
    T nxt[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc = add_rn(acc, mul_rn(a[i][j], s[j]));
      nxt[i] = add_rn(acc, ends[base + (size_t)k * M + i]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = nxt[i];
  }
}

// S2, pass 3: a thread an output (grid-stride).
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
    iir_fixup_kernel(T* __restrict__ y, const T* __restrict__ starts,
                     const T* __restrict__ pw, int rows, long n, int L,
                     int nt) {
  const long total = (long)rows * n;
  for (long idx = (long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long)gridDim.x * kThreads) {
    const long r = idx / n, t = idx - r * n;
    const long k = t / L, j = t - k * L;
    const T* s = starts + ((size_t)r * nt + k) * M;
    T f = T(0);
#pragma unroll
    for (int c = 0; c < M; ++c) f = add_rn(f, mul_rn(pw[j * M + c], s[c]));
    y[idx] = add_rn(y[idx], f);
  }
}

template <typename T>
Coefs<T> coefs_of(const double* nh, const double* dh, int p) {
  Coefs<T> c{};
  for (int i = 0; i < p; ++i) {
    c.n[i] = (T)nh[i];
    c.d[i] = (T)dh[i];
  }
  return c;
}

int blocks_of(long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

template <typename T, int M>
int scan_launch(const void* x, const void* xz, const void* yz, void* y,
                const double* nh, const double* dh, int rows, long n,
                cudaStream_t st) {
  iir_scan_kernel<T, M><<<rows, kThreads, 0, st>>>(
      (const T*)x, (const T*)xz, (const T*)yz, (T*)y, n,
      coefs_of<T>(nh, dh, M + 1));
  return (int)cudaGetLastError();
}

template <typename T, int M>
int assoc_launch(const void* x, const void* xz, const void* yz, void* y,
                 void* ends, void* starts, const void* al, const void* pw,
                 const double* nh, const double* dh, int rows, long n, int L,
                 cudaStream_t st) {
  const int nt = (int)((n + L - 1) / L);
  iir_local_kernel<T, M><<<blocks_of((long)rows * nt), kThreads, 0, st>>>(
      (const T*)x, (const T*)xz, (T*)y, (T*)ends, rows, n, L, nt,
      coefs_of<T>(nh, dh, M + 1));
  int err = (int)cudaGetLastError();
  if (err) return err;
  iir_carry_kernel<T, M><<<blocks_of(rows), kThreads, 0, st>>>(
      (const T*)yz, (const T*)ends, (const T*)al, (T*)starts, rows, nt);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long fix = blocks_of((long)rows * n);
  iir_fixup_kernel<T, M><<<(int)(fix < 132L * 16 ? fix : 132L * 16),
                           kThreads, 0, st>>>(
      (T*)y, (const T*)starts, (const T*)pw, rows, n, L, nt);
  return (int)cudaGetLastError();
}

// The instantiation for M = p - 1 in 1 .. 7 and the type.
#define RSPT_IIR_DISPATCH(FN, ...)                                   \
  switch (p - 1) {                                                   \
    case 1: return dbl ? FN<double, 1>(__VA_ARGS__)                  \
                       : FN<float, 1>(__VA_ARGS__);                  \
    case 2: return dbl ? FN<double, 2>(__VA_ARGS__)                  \
                       : FN<float, 2>(__VA_ARGS__);                  \
    case 3: return dbl ? FN<double, 3>(__VA_ARGS__)                  \
                       : FN<float, 3>(__VA_ARGS__);                  \
    case 4: return dbl ? FN<double, 4>(__VA_ARGS__)                  \
                       : FN<float, 4>(__VA_ARGS__);                  \
    case 5: return dbl ? FN<double, 5>(__VA_ARGS__)                  \
                       : FN<float, 5>(__VA_ARGS__);                  \
    case 6: return dbl ? FN<double, 6>(__VA_ARGS__)                  \
                       : FN<float, 6>(__VA_ARGS__);                  \
    case 7: return dbl ? FN<double, 7>(__VA_ARGS__)                  \
                       : FN<float, 7>(__VA_ARGS__);                  \
    default: return (int)cudaErrorInvalidValue;                      \
  }

}  // namespace

// S1. x, y: (rows, n) float (dbl = 0) or double (dbl = 1); xz, yz: (rows,
// p - 1) of the same type, the newest first; nh, dh: p host doubles (the
// feedback n, n[0] unused, and the feedforward d), rounded to the type.
// 2 <= p <= 8, rows, n >= 1. Returns cudaGetLastError() after the launch.
extern "C" int rspt_iir_scan(const void* x, const void* xz, const void* yz,
                             void* y, const void* nh, const void* dh, int p,
                             int rows, long n, int dbl, void* stream) {
  RSPT_IIR_DISPATCH(scan_launch, x, xz, yz, y, (const double*)nh,
                    (const double*)dh, rows, n, (cudaStream_t)stream)
}

// S2. As rspt_iir_scan, plus L >= 1 (samples a tile), the scratch ends and
// starts ((rows, ceil(n / L), p - 1) each), al (A^L, (p - 1) x (p - 1))
// and pw ((L, p - 1): row 0 of A^(j+1) for j = 0 .. L-1), in the type.
// Three launches; returns the first error.
extern "C" int rspt_iir_assoc(const void* x, const void* xz, const void* yz,
                              void* y, void* ends, void* starts,
                              const void* al, const void* pw, const void* nh,
                              const void* dh, int p, int rows, long n, int L,
                              int dbl, void* stream) {
  RSPT_IIR_DISPATCH(assoc_launch, x, xz, yz, y, ends, starts, al, pw,
                    (const double*)nh, (const double*)dh, rows, n, L,
                    (cudaStream_t)stream)
}
