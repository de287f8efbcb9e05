// xdelta_swizzle: layout swizzle + delta -> offset(-128) -> xor, plus the
// verify-and-grow flag, in one pass.
//
// Replaces K1, rspt_tpu/ops/pallas_kernels.py:xdelta_preprocess_pallas
// (:1594-1653), and fuses in the jax_ops.native_to_i32 transpose
// (jax_ops.py:43-69) and the flag of packers/tpu.py:169-174.
//
//   v[i] = interleaved word (i % ns) * ch + i / ns   (swizzle=1)
//   d[i] = v[i] - v[i-1] - 128,  x[i] = d[i] ^ d[i-1]   (int32 wrap,
//   v[-1] = d[-1] = 0)
//   ok  &= sign-extending the low 8 * nr_planes bits of every x leaves
//          its low 8 * bps bits unchanged (nr_planes < bps)
//
// The flag follows the reference, which decompresses and compares the
// native bps-byte samples (signal_packer_xdelta_hzr.cpp:59-71): their low
// 8 * bps bits depend only on the low 8 * bps bits of the xdelta values,
// so at nr_planes >= bps the planes always fit. At bps 4 the rule is
// "x fits nr_planes signed bytes".
//
// The TPU kernel carries the previous value and delta from tile to tile;
// here each thread looks back two elements, so blocks need no carries.
// Bound: bytes, one read and one write of n int32 (2 x 1.64 MB on the
// 12 x 34199 main path). The swizzled read is strided by `ch` words
// across a warp; L2 absorbs it at this size.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t load_v(const int32_t* __restrict__ in,
                                           int j, int ns, int ch,
                                           int swizzle) {
  if (swizzle) {
    int c = j / ns;
    int s = j - c * ns;
    return (uint32_t)in[(int64_t)s * ch + c];
  }
  return (uint32_t)in[j];
}

__global__ void xdelta_swizzle_kernel(const int32_t* __restrict__ in,
                                      int32_t* __restrict__ out,
                                      int32_t* __restrict__ ok, int n,
                                      int ns, int ch, int swizzle,
                                      int nr_planes, int bps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int fits = 1;
  if (i < n) {
    uint32_t v0 = load_v(in, i, ns, ch, swizzle);
    uint32_t v1 = i >= 1 ? load_v(in, i - 1, ns, ch, swizzle) : 0u;
    uint32_t v2 = i >= 2 ? load_v(in, i - 2, ns, ch, swizzle) : 0u;
    uint32_t d0 = v0 - v1 - 128u;
    uint32_t d1 = i >= 1 ? v1 - v2 - 128u : 0u;
    uint32_t x = d0 ^ d1;
    out[i] = (int32_t)x;
    if (nr_planes < bps) {
      const int sh = 32 - 8 * nr_planes;
      const uint32_t keep = bps >= 4 ? 0xffffffffu : (1u << (8 * bps)) - 1u;
      const uint32_t merged = (uint32_t)((int32_t)(x << sh) >> sh);
      fits = ((merged ^ x) & keep) == 0;
    }
  }
  if (!__syncthreads_and(fits) && threadIdx.x == 0) atomicAnd(ok, 0);
}

}  // namespace

// in: n int32 (interleaved when swizzle, else channel-major); out: n
// int32; ok: one int32 the caller set to 1; bps: bytes per native sample
// (1..4). Returns cudaGetLastError().
extern "C" int rspt_xdelta_swizzle(const void* in, void* out, void* ok,
                                   int n, int ns, int ch, int swizzle,
                                   int nr_planes, int bps, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  xdelta_swizzle_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (int32_t*)ok, n, ns, ch, swizzle,
      nr_planes, bps);
  return (int)cudaGetLastError();
}
