// Staleness-compensated buffered aggregation (paper eq. 4) for Hopper, one
// launch per aggregation over a flat model:
//
//     out[n] = params[n] + sum_{m=0..M-1} weights[m] * updates[rows[m], n]
//
// Replaces the Pallas TPU kernel `weighted_aggregate` (body `_agg_kernel`)
// in src/repro/kernels/agg/kernel.py. Same arithmetic: updates and params
// are read in their own type (float32 or bfloat16), the weighted sum over
// the M buffered updates is accumulated in float32, params are added in
// float32, and the result is written in the params' type. `updates` is an
// (R, N) buffer with a row stride `ld` >= N; `rows` (int32, M entries, each
// in [0, R)) names the row of each of the M updates, so the caller's
// update buffer is read in the weights' order where it lies (NULL: row m).
//
// Sum order. Every output element is one float32 fma chain over
// m = 0..M-1 from 0, then params + sum: both designs below, and every
// column of either, compute it so, and so agree to the bit with each
// other (and with the first version of this kernel on the same rows).
// No atomics, no cross-block reduction: results repeat run to run.
//
// Bound: memory. A launch must read M*N updates, N params, M weights and M
// row indices and write N outputs, (M*b_upd + 2*b_par)*N + 8*M bytes,
// against 2*M*N flops. At the paper's size (DenseNet-161 with a 62-class
// head, N = 26,608,958, and M = 191 satellites) that is ~20.5 GB with
// float32 updates, ~6.1 ms at the H100's 3.35 TB/s (~10.4 GB, 3.1 ms,
// with bfloat16 updates). At the quickstart's and the transformer's flat
// models (N = 4,622 and 20,768, M ~ 20) a launch moves well under 1 MB
// and its latency sets its time.
//
// Two designs, picked by the wrapper (kernel.py::design_for) from N:
//
// (i) "register", small N: a thread owns 4 consecutive columns (one 16-byte
//     float32 or 8-byte bfloat16 load a row; the last thread of a row that
//     ends mid-group sums its 1-3 columns one by one), walks the M rows
//     with the running sums in registers and writes its outputs once.
//     Where the rows or pointers are not aligned for the wide loads it
//     takes the one-column-a-thread instantiation.
//
// (ii) "ring", large N: the TPU kernel streams an (M, 16384) panel through
//     VMEM a grid step. Here a block owns a column tile of T bytes a row;
//     its last warp is a producer whose first thread issues one 1-D TMA
//     bulk copy (`cp.async.bulk`) of row rows[m]'s tile into a ring of S
//     stages of dynamic shared memory, each with an `mbarrier` counting
//     the bytes still to arrive (full) and one counting the consumer warps
//     that have read it (empty). The consumer threads own 16 bytes of the
//     tile in each of 4 chunks (16 float32 or 32 bfloat16 columns), read
//     them from shared memory 16 bytes at a time, fma them into registers
//     and free the stage (after a generic-to-async proxy fence, so the
//     next bulk copy cannot overwrite what is still being read); the
//     epilogue adds params and writes the output once. What this does about bursts: the register design's warp reads
//     512 B (float32) or 256 B (bfloat16) of a row before it jumps N*4
//     bytes to the next row, so each load opens another DRAM page; a bulk
//     copy reads T contiguous bytes of a row (by default 16 KB, with S = 2
//     stages a block), and S of them are in flight a block. The columns a bulk copy cannot take -
//     those before the first 16-byte boundary of the rows and the tail of
//     N modulo the tile - are summed in the same launch by the first
//     blocks, one column a thread, in the same order. The ring needs the
//     row stride to be a multiple of 16 bytes (every row then starts at
//     the same offset from a 16-byte boundary).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 consecutive elements: one 16-byte float32 or 8-byte bfloat16 access
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void unpack_bf16x2(unsigned int bits, float* v) {
  const float2 f = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&bits));
  v[0] = f.x;
  v[1] = f.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  unpack_bf16x2(x.x, v);
  unpack_bf16x2(x.y, v + 2);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ unsigned int pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

__device__ __forceinline__ int64_t row_of(const int* rows, int64_t k) {
  return rows ? static_cast<int64_t>(__ldg(rows + k)) : k;
}

// Columns c .. c+cnt-1 (cnt <= 4) summed one by one, with scalar loads:
// the tails of both designs and the ring's edge columns.
template <typename P, typename U>
__device__ __forceinline__ void sum_columns(
    const P* __restrict__ params, const U* __restrict__ updates,
    const float* __restrict__ weights, const int* __restrict__ rows,
    P* __restrict__ out, int64_t m, int64_t ld, int64_t c, int cnt) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int64_t k = 0; k < m; ++k) {
    const U* row = updates + row_of(rows, k) * ld + c;
    const float w = __ldg(weights + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < cnt) acc[e] = fmaf(w, to_float(row[e]), acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < cnt) out[c + e] = from_float<P>(to_float(params[c + e]) + acc[e]);
}

// ---------------------------------------------------------------- (i)

constexpr int kThreads = 256;

// E = 4: the caller guarantees ld % 4 == 0 and pointers aligned for the
// 4-element accesses; E = 1: no alignment needed.
template <typename P, typename U, int E>
__global__ void __launch_bounds__(kThreads)
agg_register_kernel(const P* __restrict__ params,
                    const U* __restrict__ updates,
                    const float* __restrict__ weights,
                    const int* __restrict__ rows, P* __restrict__ out,
                    int64_t m, int64_t n, int64_t ld) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * E;
  if (i >= n) return;
  if (E == 1 || i + E > n) {
    sum_columns(params, updates, weights, rows, out, m, ld, i,
                static_cast<int>(n - i < E ? n - i : E));
    return;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const U* col = updates + i;
#pragma unroll 4
  for (int64_t k = 0; k < m; ++k) {
    float u[4];
    load4(col + row_of(rows, k) * ld, u);
    const float w = __ldg(weights + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, u[e], acc[e]);
  }
  float p[4];
  load4(params + i, p);
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] += acc[e];
  store4(out + i, p);
}

// ---------------------------------------------------------------- (ii)

constexpr int kChunks = 4;          // 16-byte chunks a consumer thread owns
constexpr int kMaxRingThreads = 512 + 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 1-D TMA copy of `bytes` (a multiple of 16, both addresses on 16
// bytes) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes of shared memory as V = 16 / sizeof(U) floats
__device__ __forceinline__ void unpack16(const float*, uint4 x, float v[4]) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16*, uint4 x,
                                         float v[8]) {
  unpack_bf16x2(x.x, v);
  unpack_bf16x2(x.y, v + 2);
  unpack_bf16x2(x.z, v + 4);
  unpack_bf16x2(x.w, v + 6);
}

// V consecutive params (V = 4 or 8) in one or two aligned accesses
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) load4(p + j, v + j);
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    load4(p, v);
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    unpack16(p, x, v);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < V; j += 4) store4(p + j, v + j);
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    store4(p, v);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                   pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

// blockDim.x = consumer threads (a multiple of 32) + one producer warp.
// Blocks [0, edge_blocks) sum the edge columns, one a thread; block
// edge_blocks + t the column tile t, columns lead + t*tile_cols onwards.
// `vec_epi`: params + lead and out + lead are aligned for the vector
// epilogue.
template <typename P, typename U>
__global__ void __launch_bounds__(kMaxRingThreads)
agg_ring_kernel(const P* __restrict__ params, const U* __restrict__ updates,
                const float* __restrict__ weights,
                const int* __restrict__ rows, P* __restrict__ out, int64_t m,
                int64_t n, int64_t ld, int64_t lead, int64_t tiles,
                int stages, int edge_blocks, int vec_epi) {
  constexpr int V = 16 / sizeof(U);
  const int consumers = blockDim.x - 32;
  const int64_t tile_cols = static_cast<int64_t>(consumers) * kChunks * V;
  if (static_cast<int>(blockIdx.x) < edge_blocks) {
    const int64_t e =
        static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t c = e < lead ? e : lead + tiles * tile_cols + (e - lead);
    if (c < n) sum_columns(params, updates, weights, rows, out, m, ld, c, 1);
    return;
  }
  const int64_t c0 = lead + (blockIdx.x - edge_blocks) * tile_cols;
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_cols * sizeof(U));
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * tile_bytes);
  uint64_t* empty = full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= consumers) {   // the producer warp
    if (static_cast<int>(threadIdx.x) == consumers) {
      const U* col = updates + c0;
      for (int64_t k = 0; k < m; ++k) {
        const int s = static_cast<int>(k % stages);
        const uint32_t fill = static_cast<uint32_t>(k / stages);
        if (fill) mbar_wait(empty + s, (fill - 1) & 1);
        mbar_expect_tx(full + s, tile_bytes);
        bulk_load(ring + s * tile_bytes, col + row_of(rows, k) * ld,
                  tile_bytes, full + s);
      }
    }
    return;
  }

  float acc[kChunks * V];
#pragma unroll
  for (int j = 0; j < kChunks * V; ++j) acc[j] = 0.f;
  for (int64_t k = 0; k < m; ++k) {
    const int s = static_cast<int>(k % stages);
    mbar_wait(full + s, static_cast<uint32_t>(k / stages) & 1);
    const float w = __ldg(weights + k);
    const uint4* tile = reinterpret_cast<const uint4*>(ring + s * tile_bytes);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      float u[V];
      unpack16(updates, tile[j * consumers + threadIdx.x], u);
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[j * V + e] = fmaf(w, u[e], acc[j * V + e]);
    }
    // the stage was read through the generic proxy and the next bulk
    // copy writes it through the async proxy: without this fence the copy
    // may land before the reads (seen with bfloat16 updates at 8 KB and
    // 16 KB tiles: a few hundred wrong columns in the tile's last chunk)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + s);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int64_t c = c0 + static_cast<int64_t>(j * consumers + threadIdx.x) * V;
    float* a = acc + j * V;
    if (vec_epi) {
      float p[V];
      load_vec<V>(params + c, p);
#pragma unroll
      for (int e = 0; e < V; ++e) p[e] += a[e];
      store_vec<V>(out + c, p);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        out[c + e] = from_float<P>(to_float(params[c + e]) + a[e]);
    }
  }
}

constexpr int kRingMaxSmem = 232448;   // 227 KB a block

template <typename P, typename U>
int launch(const void* params_v, const void* updates_v, const float* w,
           const int* rows, void* out_v, int64_t m, int64_t n, int64_t ld,
           int design, int stages, int tile_bytes, cudaStream_t stream) {
  const P* params = static_cast<const P*>(params_v);
  const U* updates = static_cast<const U*>(updates_v);
  P* out = static_cast<P*>(out_v);
  const uintptr_t up = reinterpret_cast<uintptr_t>(updates);
  if (design == 0) {
    // the 4-wide path loads 4 elements of a row at once: rows and pointers
    // aligned to 4 elements
    const bool wide = ld % 4 == 0 && up % (4 * sizeof(U)) == 0 &&
                      reinterpret_cast<uintptr_t>(params) % (4 * sizeof(P)) == 0 &&
                      reinterpret_cast<uintptr_t>(out) % (4 * sizeof(P)) == 0;
    const int e = wide ? 4 : 1;
    const unsigned blocks =
        static_cast<unsigned>(((n + e - 1) / e + kThreads - 1) / kThreads);
    if (wide) {
      agg_register_kernel<P, U, 4><<<blocks, kThreads, 0, stream>>>(
          params, updates, w, rows, out, m, n, ld);
    } else {
      agg_register_kernel<P, U, 1><<<blocks, kThreads, 0, stream>>>(
          params, updates, w, rows, out, m, n, ld);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // the ring: rows on a common offset from 16 bytes, whole 16-byte chunks
  // for every consumer thread, and the ring within shared memory
  constexpr int V = 16 / sizeof(U);
  if (design != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = static_cast<int64_t>(stages) * tile_bytes + 16 * stages;
  if ((ld * static_cast<int64_t>(sizeof(U))) % 16 || up % sizeof(U) ||
      stages < 1 || tile_bytes <= 0 || tile_bytes % (kChunks * 16 * 32) ||
      tile_bytes / (kChunks * 16) + 32 > kMaxRingThreads ||
      smem > kRingMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int consumers = tile_bytes / (kChunks * 16);
  const int threads = consumers + 32;
  const int64_t tile_cols = static_cast<int64_t>(consumers) * kChunks * V;
  int64_t lead = static_cast<int64_t>((16 - up % 16) % 16 / sizeof(U));
  if (lead > n) lead = n;
  const int64_t tiles = (n - lead) / tile_cols;
  const int64_t edge_cols = n - tiles * tile_cols;
  const int edge_blocks = static_cast<int>((edge_cols + threads - 1) / threads);
  const uintptr_t align = (V * sizeof(P)) < 16 ? V * sizeof(P) : 16;
  const int vec_epi =
      reinterpret_cast<uintptr_t>(params + lead) % align == 0 &&
      reinterpret_cast<uintptr_t>(out + lead) % align == 0;
  if (smem > 48 * 1024) {   // above 48 KB only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        agg_ring_kernel<P, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>(edge_blocks + tiles);
  agg_ring_kernel<P, U><<<blocks, threads, smem, stream>>>(
      params, updates, w, rows, out, m, n, ld, lead, tiles, stages,
      edge_blocks, vec_epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. params/out: (n,) in the params' type
// (params_bf16 selects bfloat16, else float32); updates: rows of n
// elements `ld` apart in their own type (updates_bf16); weights: (m,)
// float32; rows: (m,) int32 row indices, or NULL for rows 0..m-1.
// design 0 is the register design (i), 1 the ring (ii) with `stages`
// stages of `tile_bytes` a row (a multiple of 2048, at most 32768; the
// ring needs ld * sizeof(update) % 16 == 0). Launches once on `stream`
// without synchronising and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for a ring the call cannot take).
extern "C" int agg_launch(const void* params, const void* updates,
                          const void* weights, const void* rows, void* out,
                          int64_t m, int64_t n, int64_t ld, int params_bf16,
                          int updates_bf16, int design, int stages,
                          int tile_bytes, void* stream) {
  if (n <= 0) return 0;
  const float* w = static_cast<const float*>(weights);
  const int* r = static_cast<const int*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (params_bf16) {
    return updates_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(
                     params, updates, w, r, out, m, n, ld, design, stages,
                     tile_bytes, s)
               : launch<__nv_bfloat16, float>(params, updates, w, r, out, m,
                                              n, ld, design, stages,
                                              tile_bytes, s);
  }
  return updates_bf16
             ? launch<float, __nv_bfloat16>(params, updates, w, r, out, m, n,
                                            ld, design, stages, tile_bytes, s)
             : launch<float, float>(params, updates, w, r, out, m, n, ld,
                                    design, stages, tile_bytes, s);
}
