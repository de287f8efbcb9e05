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
// S2: the same recurrence over tiles of L samples, in three launches,
// every sum in the plain version's order:
//   1. tiles: tile k's recurrence from a zero state (its feedforward reads
//      the real history), leaving e_k, its last M outputs y_loc, the
//      newest first;
//   2. carry: s_0 = yz, s_{k+1}[i] = (the sum over c, from 0 in order, of
//      A^L[i][c] * s_k[c]) + e_k[i], starts[k] = s_k;
//   3. tiles again: each tile's recurrence recomputed from zero, and
//      y[kL + j] = y_loc[kL + j] + (the sum over c, from 0 in order, of
//      P[j][c] * s_k[c]), P[j] = row 0 of A^(j+1).
// A is the companion matrix of the feedback (row 0 = -n[1:], the
// subdiagonal 1). The wrapper builds A^L and P from f64 powers, stored in
// the input's type.
// Passes 1 and 3: a warp takes 32 consecutive tiles of a row, a lane a
// tile. Each tile's next kC samples (one 128-byte line) come into shared
// memory by cp.async, the warp's 32 lines in coalesced copies (16 bytes
// each where x, y, n and L allow it), kBuf - 1 chunks ahead; a tile's row
// is padded by one 16-byte granule and read 16 bytes at a time, so the 8
// lanes of a quarter warp read 8 different granules of the banks. Pass 3
// writes y over the chunk and the warp stores it back coalesced. Recomputing y_loc in pass 3 (x
// read twice, y written once: 12 B a float sample) moves fewer bytes than
// storing it in pass 1 and reading it back (16 B, and a fix-up launch);
// the arithmetic is the same, and so are the bits.
// Pass 2 is a serial chain of nt steps a row (a second serial pass over
// the tiles, not a look-back: the plain version's order), a CTA a row:
// lane 0 walks it out of shared memory with A^L in registers, while the
// other warps copy the ends in a slab ahead and store the starts a slab
// behind. Bound: nt steps of a multiply and M + 1 dependent adds, and
// about M * M + M + 2 instructions a step on that lane.
#include "common.cuh"

namespace {

constexpr int kMaxP = 8;        // coefficients (order 7)
constexpr int kThreads = 128;
constexpr int kSlab = 512;      // samples a slab (S1)
constexpr int kRing = 6;        // x slabs in shared memory (S1)
constexpr int kAhead = kRing - 2;  // slabs S1 copies ahead
constexpr int kUnroll = 16;     // u read ahead by S1's chain lane
constexpr int kWorkers = kThreads - 32;  // S1's warps 1-3
constexpr int kTileWarps = 4;   // warps a CTA of S2's passes 1 and 3
constexpr int kBuf = 3;         // chunks of a warp in shared memory (S2)
constexpr int kCarrySlab = 128;  // tiles a slab of S2's carry

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

// ---- S2 ----

// M values between registers and shared memory in the widest vectors
// that M * sizeof(T) bytes allow (the addresses are multiples of them).
template <typename T, int M>
__host__ __device__ constexpr int vec_bytes() {
  return (M * sizeof(T)) % 16 == 0 ? 16 : (M * sizeof(T)) % 8 == 0 ? 8 : 4;
}
template <int kBytes> struct Vec { using type = float; };
template <> struct Vec<8> { using type = float2; };
template <> struct Vec<16> { using type = float4; };
template <typename T, typename V>
union Pack {
  V v;
  T t[sizeof(V) / sizeof(T)];
};

template <typename T, int M>
__device__ __forceinline__ void get_m(T (&v)[M], const T* p) {
  using V = typename Vec<vec_bytes<T, M>()>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
#pragma unroll
  for (int i = 0; i < M / kPer; ++i) {
    Pack<T, V> u;
    u.v = reinterpret_cast<const V*>(p)[i];
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[i * kPer + j] = u.t[j];
  }
}

template <typename T, int M>
__device__ __forceinline__ void put_m(T* p, const T (&v)[M]) {
  using V = typename Vec<vec_bytes<T, M>()>::type;
  constexpr int kPer = sizeof(V) / sizeof(T);
#pragma unroll
  for (int i = 0; i < M / kPer; ++i) {
    Pack<T, V> u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) u.t[j] = v[i * kPer + j];
    reinterpret_cast<V*>(p)[i] = u.v;
  }
}

template <typename T>
struct Tile {
  static constexpr int kC = 128 / (int)sizeof(T);  // samples a chunk: a line
  static constexpr int kV = 16 / (int)sizeof(T);   // samples a granule
  static constexpr int kRow = kC + kV;  // a tile's row and a granule of pad
  static constexpr int kX = 32 * kRow;  // a chunk of 32 tiles
};

template <typename T>
struct TileArgs {
  const T* x;
  const T* xz;
  const T* yz;
  const T* al;
  const T* pw;
  T* y;
  T* ends;
  T* starts;
  long n;
  int L, nt, groups;  // groups: tile-pass CTAs a row
};

enum Pass { kEnds, kFinal };

template <typename T, int M>
constexpr int tile_smem() {
  return kTileWarps * kBuf * (Tile<T>::kX + Tile<T>::kC * M) * (int)sizeof(T);
}
template <typename T, int M>
constexpr int carry_smem() {
  return 4 * kCarrySlab * M * (int)sizeof(T);
}

// Steps of one lane's tile over a chunk in its row of shared memory (the
// first m samples when kPartial), read (and written back) a 16-byte
// granule at a time: rows 144 bytes apart put the 8 lanes of a quarter
// warp on 8 different granules of the banks. y_loc = u - n[1] s[0] - ... -
// n[M] s[M-1], u the feedforward (the sum over i, from 0 in order, of d[i]
// xh[i]); kEnds leaves y_loc in the state only, kFinal writes y_loc + (the
// sum over q, from 0 in order, of P[j][q] * st[q]) over x (p: P's rows of
// the chunk). xh[0 .. M-1]: the last M
// inputs, the newest first; s: the last M outputs.
template <typename T, int M, int kPass, bool kPartial>
__device__ __forceinline__ void chunk_steps(T* row, const T* p, int m,
                                            T (&xh)[M + 1], T (&s)[M],
                                            const T (&st)[M],
                                            const Coefs<T>& c) {
  constexpr int kC = Tile<T>::kC, kV = Tile<T>::kV;
#pragma unroll
  for (int j0 = 0; j0 < kC; j0 += kV) {
    T g[kV];
    get_m<T, kV>(g, row + j0);
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int j = j0 + v;
      if (!kPartial || j < m) {
#pragma unroll
        for (int i = M; i > 0; --i) xh[i] = xh[i - 1];
        xh[0] = g[v];
        T y = T(0);
#pragma unroll
        for (int i = 0; i <= M; ++i) y = add_rn(y, mul_rn(c.d[i], xh[i]));
#pragma unroll
        for (int i = 0; i < M; ++i) y = sub_rn(y, mul_rn(c.n[i + 1], s[i]));
#pragma unroll
        for (int i = M - 1; i > 0; --i) s[i] = s[i - 1];
        s[0] = y;
        if (kPass == kFinal) {
          T pr[M];
          get_m<T, M>(pr, p + j * M);
          T f = T(0);
#pragma unroll
          for (int q = 0; q < M; ++q) f = add_rn(f, mul_rn(pr[q], st[q]));
          g[v] = add_rn(y, f);
        }
      }
    }
    if (kPass == kFinal) put_m<T, kV>(row + j0, g);
  }
}

// kCarrySlab tiles of the carry (m when kPartial) on one lane: starts[q]
// = s, then s = A^L s + e[q]; A^L in registers, e and starts in shared
// memory. The step after a row's last tile is computed and dropped.
template <typename T, int M, bool kPartial>
__device__ __forceinline__ void carry_slab(const T (&A)[M][M], T (&s)[M],
                                           const T* __restrict__ e,
                                           T* __restrict__ o, int m) {
#pragma unroll 8
  for (int q = 0; q < (kPartial ? m : kCarrySlab); ++q) {
    put_m<T, M>(o + q * M, s);
    T en[M], nxt[M];
    get_m<T, M>(en, e + q * M);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < M; ++j) acc = add_rn(acc, mul_rn(A[i][j], s[j]));
      nxt[i] = add_rn(acc, en[i]);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) s[i] = nxt[i];
  }
}

// S2, pass 2: a CTA a row (r); lane 0 walks the chain; warps 1-3 copy the
// ends of slab i + 1 in and store the starts of slab i - 1 while it walks
// slab i, and one barrier ends the step. smem: carry_smem<T, M>() bytes.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) iir_carry_kernel(TileArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kS = kCarrySlab * M;
  const int r = blockIdx.x;
  T* se = reinterpret_cast<T*>(smem);  // [2][kS]: ends of slabs i, i + 1
  T* ss = se + 2 * kS;                 // [2][kS]: starts of slabs i, i - 1
  const int nt = a.nt;
  const int ns = (nt + kCarrySlab - 1) / kCarrySlab;
  const T* er = a.ends + (size_t)r * nt * M;
  T* sr = a.starts + (size_t)r * nt * M;
  const int tid = threadIdx.x, w = tid - 32, nw = kThreads - 32;
  auto count = [&](int i) {  // the values of slab i
    return (nt - i * kCarrySlab < kCarrySlab ? nt - i * kCarrySlab
                                             : kCarrySlab) * M;
  };
  auto load = [&](int i) {
    if (i < ns) {
      T* d = se + (i & 1) * kS;
      const T* src = er + (size_t)i * kS;
      for (int q = w; q < count(i); q += nw) d[q] = src[q];
    }
  };
  if (tid >= 32) load(0);
  __syncthreads();
  T A[M][M], s[M];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s[i] = a.yz[(size_t)r * M + i];
#pragma unroll
      for (int j = 0; j < M; ++j) A[i][j] = a.al[i * M + j];
    }
  }
  for (int i = 0; i <= ns; ++i) {
    if (tid == 0) {
      if (i < ns) {
        T* e = se + (i & 1) * kS;
        T* o = ss + (i & 1) * kS;
        if (count(i) == kS)
          carry_slab<T, M, false>(A, s, e, o, kCarrySlab);
        else
          carry_slab<T, M, true>(A, s, e, o, count(i) / M);
      }
    } else if (tid >= 32) {
      load(i + 1);
      if (i >= 1) {
        const T* src = ss + ((i - 1) & 1) * kS;
        T* d = sr + (size_t)(i - 1) * kS;
        for (int q = w; q < count(i - 1); q += nw) d[q] = src[q];
      }
    }
    __syncthreads();
  }
}

// S2, passes 1 and 3: a warp takes 32 consecutive tiles of a row, a lane
// a tile (see the top). CTA b is row b / groups; smem: tile_smem<T, M>()
// bytes. kVec: 16-byte copies in and out (x, y and pw 16-byte aligned, n
// and L multiples of a granule), else a value at a time.
template <typename T, int M, int kPass, bool kVec>
__device__ __forceinline__ void tiles_pass(const TileArgs<T>& a,
                                           const Coefs<T>& c) {
  constexpr int kC = Tile<T>::kC, kV = Tile<T>::kV, kRow = Tile<T>::kRow;
  constexpr int kX = Tile<T>::kX;
  constexpr int kE = kVec ? kV : 1;    // values a copy
  constexpr int kLanes = kC / kE;      // lanes a tile's chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* sx = reinterpret_cast<T*>(smem) + warp * kBuf * (kX + kC * M);
  T* sp = sx + kBuf * kX;  // P's rows of each chunk (kFinal)
  const int r = blockIdx.x / a.groups;
  const long n = a.n;
  const int L = a.L, nt = a.nt;
  const int k0 = ((blockIdx.x - r * a.groups) * kTileWarps + warp) * 32;
  const int k = k0 + lane;
  const bool live = k < nt;
  const T* xr = a.x + (size_t)r * n;
  const long t0 = (long)k * L;
  const int len = live ? (int)(n - t0 < L ? n - t0 : L) : 0;
  const int nch = k0 < nt ? (L + kC - 1) / kC : 0;
  // a lane copies values jl .. jl + kE - 1 of tiles lane / kLanes, + 32 /
  // kLanes, ... of a chunk: each tile's chunk in coalesced lines
  const int jl = lane % kLanes * kE;

  auto fetch = [&](int ch) {  // chunk ch of the warp's tiles (and P's rows)
    if (ch < nch) {
      T* dst = sx + (ch % kBuf) * kX + jl;
      const long base = (long)k0 * L + (long)ch * kC + jl;
      const bool in = ch * kC + jl < L;
      for (int q = lane / kLanes; q < 32; q += 32 / kLanes) {
        const long t = base + (long)q * L;
        const bool ok = in && t < n;
        rspt::cp_async_zfill<kE * sizeof(T)>(dst + q * kRow,
                                             xr + (ok ? t : 0), ok);
      }
      if (kPass == kFinal) {
        T* pd = sp + (ch % kBuf) * kC * M;
        const long p0 = (long)ch * kC * M;
        for (int i = lane * kE; i < kC * M; i += 32 * kE) {
          const bool ok = p0 + i < (long)L * M;
          rspt::cp_async_zfill<kE * sizeof(T)>(pd + i,
                                               a.pw + (ok ? p0 + i : 0), ok);
        }
      }
    }
    rspt::cp_async_commit();
  };

  T xh[M + 1], s[M], st[M];
#pragma unroll
  for (int i = 0; i < M; ++i) s[i] = xh[i] = st[i] = T(0);
  xh[M] = T(0);
  if (live) {
    load_history<T, M>(xr, a.xz + (size_t)r * M, t0, xh);
    if (kPass == kFinal) {
#pragma unroll
      for (int i = 0; i < M; ++i) st[i] = a.starts[((size_t)r * nt + k) * M + i];
    }
  }
  for (int b = 0; b < kBuf - 1; ++b) fetch(b);
  for (int ch = 0; ch < nch; ++ch) {
    fetch(ch + kBuf - 1);  // into the buffer freed at the end of ch - 1
    rspt::cp_async_wait<kBuf - 1>();
    __syncwarp();
    T* buf = sx + (ch % kBuf) * kX;
    const T* p = sp + (ch % kBuf) * kC * M;
    if (__all_sync(rspt::kFull, !live || (ch + 1) * kC <= len))
      chunk_steps<T, M, kPass, false>(buf + lane * kRow, p, kC, xh, s, st, c);
    else
      chunk_steps<T, M, kPass, true>(buf + lane * kRow, p, len - ch * kC, xh,
                                     s, st, c);
    __syncwarp();
    if (kPass == kFinal) {  // the chunk's outputs back, coalesced
      T* yr = a.y + (size_t)r * n;
      const T* src = buf + jl;
      const long base = (long)k0 * L + (long)ch * kC + jl;
      const bool in = ch * kC + jl < L;
      for (int q = lane / kLanes; q < 32; q += 32 / kLanes) {
        const long t = base + (long)q * L;
        if (in && t < n) {
          if (kVec)
            *reinterpret_cast<uint4*>(yr + t) =
                *reinterpret_cast<const uint4*>(src + q * kRow);
          else
            yr[t] = src[q * kRow];
        }
      }
      __syncwarp();
    }
  }
  if (kPass == kEnds && live) {
#pragma unroll
    for (int i = 0; i < M; ++i) a.ends[((size_t)r * nt + k) * M + i] = s[i];
  }
}

// S2's passes 1 (ends) and 3 (final) by name.
template <typename T, int M, bool kVec>
__global__ void __launch_bounds__(32 * kTileWarps)
    iir_ends_kernel(TileArgs<T> a, Coefs<T> c) {
  tiles_pass<T, M, kEnds, kVec>(a, c);
}
template <typename T, int M, bool kVec>
__global__ void __launch_bounds__(32 * kTileWarps)
    iir_final_kernel(TileArgs<T> a, Coefs<T> c) {
  tiles_pass<T, M, kFinal, kVec>(a, c);
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

template <typename T, int M>
int scan_launch(const void* x, const void* xz, const void* yz, void* y,
                const double* nh, const double* dh, int rows, long n,
                cudaStream_t st) {
  iir_scan_kernel<T, M><<<rows, kThreads, 0, st>>>(
      (const T*)x, (const T*)xz, (const T*)yz, (T*)y, n,
      coefs_of<T>(nh, dh, M + 1));
  return (int)cudaGetLastError();
}

// S2's three launches. Passes 1 and 3 use more than 48 KB of shared memory
// and are opted in to it once a device (a bit a device in opted).
template <typename T, int M, bool kVec>
int assoc_passes(const TileArgs<T>& a, const Coefs<T>& c, int rows,
                 cudaStream_t st) {
  static_assert(carry_smem<T, M>() <= 48 * 1024, "carry needs an opt-in");
  static unsigned long long opted = 0;
  const int tiles = 32 * kTileWarps;
  const int blocks = rows * a.groups;
  constexpr int kSmem = tile_smem<T, M>();
  int dev;
  int err = (int)cudaGetDevice(&dev);
  if (!err && (dev >= 64 || !(opted >> dev & 1))) {
    err = (int)cudaFuncSetAttribute(iir_ends_kernel<T, M, kVec>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmem);
    if (!err)
      err = (int)cudaFuncSetAttribute(
          iir_final_kernel<T, M, kVec>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (!err && dev < 64) opted |= 1ull << dev;
  }
  if (err) return err;
  iir_ends_kernel<T, M, kVec><<<blocks, tiles, kSmem, st>>>(a, c);
  err = (int)cudaGetLastError();
  if (err) return err;
  iir_carry_kernel<T, M><<<rows, kThreads, carry_smem<T, M>(), st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  iir_final_kernel<T, M, kVec><<<blocks, tiles, kSmem, st>>>(a, c);
  return (int)cudaGetLastError();
}

template <typename T, int M>
int assoc_launch(const void* x, const void* xz, const void* yz, void* y,
                 void* ends, void* starts, const void* al, const void* pw,
                 const double* nh, const double* dh, int rows, long n, int L,
                 cudaStream_t st) {
  const int nt = (int)((n + L - 1) / L);
  const int tiles = 32 * kTileWarps;
  const TileArgs<T> a{(const T*)x, (const T*)xz, (const T*)yz, (const T*)al,
                      (const T*)pw, (T*)y, (T*)ends, (T*)starts, n, L, nt,
                      (nt + tiles - 1) / tiles};
  const Coefs<T> c = coefs_of<T>(nh, dh, M + 1);
  constexpr int kV = Tile<T>::kV;
  const bool vec = n % kV == 0 && L % kV == 0 &&
                   (((uintptr_t)x | (uintptr_t)y | (uintptr_t)pw) & 15) == 0;
  return vec ? assoc_passes<T, M, true>(a, c, rows, st)
             : assoc_passes<T, M, false>(a, c, rows, st);
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
// rows * ceil(n / L) < 2^31. Three launches; returns the first error.
extern "C" int rspt_iir_assoc(const void* x, const void* xz, const void* yz,
                              void* y, void* ends, void* starts,
                              const void* al, const void* pw, const void* nh,
                              const void* dh, int p, int rows, long n, int L,
                              int dbl, void* stream) {
  RSPT_IIR_DISPATCH(assoc_launch, x, xz, yz, y, ends, starts, al, pw,
                    (const double*)nh, (const double*)dh, rows, n, L,
                    (cudaStream_t)stream)
}
