// Staleness-compensated buffered aggregation (paper eq. 4) for Hopper:
//
//     out[n] = params[n] + sum_m weights[m] * updates[m, n]
//
// Replaces the Pallas TPU kernel `weighted_aggregate` (body `_agg_kernel`)
// in src/repro/kernels/agg/kernel.py. Same arithmetic: updates and params
// are read in their own type (float32 or bfloat16), the weighted sum over
// the M buffered updates is accumulated in float32, params are added in
// float32, and the result is written in the params' type.
//
// Bound: memory. A launch must read M*N updates, N params and M weights and
// write N outputs, (M*b_upd + 2*b_par)*N + 4*M bytes, against 2*M*N flops.
// At the paper's size (DenseNet-161 with a 62-class head, N ~ 26.6M, and
// M = 191 satellites) that is ~20.5 GB in float32, ~6.1 ms at the H100's
// 3.35 TB/s. At the quickstart's leaves (N <= 2,976, M <= 40) a launch
// moves a few hundred KB and launch latency sets its time.
//
// Design: the TPU kernel streams an (M, 16384) panel through VMEM per grid
// step; here nothing needs staging. Each thread owns 4 consecutive output
// elements (one 16-byte float32 or 8-byte bfloat16 load per row), walks
// the M rows with the running sums in registers, and writes its outputs
// once. Neighbouring threads read neighbouring addresses in every row, so
// each row's loads coalesce; thousands of independent threads per SM keep
// enough loads in flight to stream device memory. No shared memory, no
// cross-block reduction, no atomics: the sum order is fixed (m = 0..M-1),
// so results are deterministic run to run. When N is not a multiple of 4
// or a pointer is not aligned for the wide loads, the wrapper selects the
// one-element-per-thread instantiation of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load1(const float* p, float v[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void load1(const __nv_bfloat16* p, float v[1]) {
  v[0] = __bfloat162float(p[0]);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned int*>(&lo);
  x.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

__device__ __forceinline__ void store1(float* p, const float v[1]) {
  p[0] = v[0];
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, const float v[1]) {
  p[0] = __float2bfloat16_rn(v[0]);
}

template <int E, typename T>
__device__ __forceinline__ void load(const T* p, float v[E]) {
  if constexpr (E == 4) {
    load4(p, v);
  } else {
    load1(p, v);
  }
}

template <int E, typename T>
__device__ __forceinline__ void store(T* p, const float v[E]) {
  if constexpr (E == 4) {
    store4(p, v);
  } else {
    store1(p, v);
  }
}

constexpr int kThreads = 256;

// E output elements per thread; P is the params/output type, U the
// updates' type. For E == 4 the caller guarantees n % 4 == 0 and aligned
// pointers, so no thread straddles the end of a row.
template <typename P, typename U, int E>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const P* __restrict__ params, const U* __restrict__ updates,
           const float* __restrict__ weights, P* __restrict__ out,
           int64_t m, int64_t n) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * E;
  if (i >= n) return;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const U* col = updates + i;
#pragma unroll 4
  for (int64_t k = 0; k < m; ++k) {
    float u[E];
    load<E>(col + k * n, u);
    const float w = __ldg(weights + k);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(w, u[e], acc[e]);
  }
  float p[E];
  load<E>(params + i, p);
#pragma unroll
  for (int e = 0; e < E; ++e) p[e] += acc[e];
  store<E>(out + i, p);
}

template <typename P, typename U>
void launch(const void* params, const void* updates, const float* weights,
            void* out, int64_t m, int64_t n, int wide, cudaStream_t stream) {
  const int e = wide ? 4 : 1;
  const int64_t threads_needed = (n + e - 1) / e;
  const unsigned blocks =
      static_cast<unsigned>((threads_needed + kThreads - 1) / kThreads);
  if (wide) {
    agg_kernel<P, U, 4><<<blocks, kThreads, 0, stream>>>(
        static_cast<const P*>(params), static_cast<const U*>(updates),
        weights, static_cast<P*>(out), m, n);
  } else {
    agg_kernel<P, U, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const P*>(params), static_cast<const U*>(updates),
        weights, static_cast<P*>(out), m, n);
  }
}

}  // namespace

// C interface, loaded with ctypes. params/out: (n,) in the params' type
// (params_bf16 selects bfloat16, else float32); updates: (m, n) row-major
// in their own type (updates_bf16); weights: (m,) float32. `wide` selects
// the 4-element path (n % 4 == 0, 16-byte-aligned float32 or 8-byte-aligned
// bfloat16 pointers). Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int agg_launch(const void* params, const void* updates,
                          const void* weights, void* out, int64_t m,
                          int64_t n, int params_bf16, int updates_bf16,
                          int wide, void* stream) {
  if (n <= 0) return 0;
  const float* w = static_cast<const float*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params_bf16) {
    if (updates_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(params, updates, w, out, m, n,
                                           wide, s);
    } else {
      launch<__nv_bfloat16, float>(params, updates, w, out, m, n, wide, s);
    }
  } else {
    if (updates_bf16) {
      launch<float, __nv_bfloat16>(params, updates, w, out, m, n, wide, s);
    } else {
      launch<float, float>(params, updates, w, out, m, n, wide, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
