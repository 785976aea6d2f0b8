// RMSNorm over the last dimension for Hopper, forward and backward:
//
//     y[g, r, :] = x[g, r, :] * rstd[g, r] * scale[g, :],
//     rstd[g, r] = rsqrt(mean(x[g, r, :]^2) + eps)
//
// Replaces the Pallas TPU kernel `rmsnorm` (body `_rmsnorm_kernel`) in
// src/repro/kernels/rmsnorm/kernel.py. Same arithmetic: x is read in its
// own type (float32 or bfloat16), the sum of squares is taken in float32,
// the scale is applied in float32, and y is cast once to x's type. The
// TPU kernel takes one (D,) scale; here x is viewed as (G, R, D) with one
// scale row per group g, which is what the reference gets from `vmap`
// over a (D,) scale when the batched client update trains G satellites.
// G = 1 is the unbatched call. The TPU kernel has no backward (its
// off-TPU path differentiates the jnp oracle); the backward here is
//
//     xh = x * rstd, gy = dy * scale,
//     dx = rstd * (gy - xh * mean(gy * xh)),
//     dscale[g, :] = sum over the rows r of group g of dy * xh.
//
// Bound: memory. The forward reads x and the scale and writes y and rstd,
// (2*b_x*D + 4)*rows + b_s*G*D bytes, against ~4*D*rows float32
// operations; the backward reads x, dy, the scale and rstd and writes dx
// and dscale. At the transformer payload's width (D = 32) a call moves a
// few hundred KB and launch latency sets its time; at a zoo width (D =
// 4096, 16k rows, bfloat16) 268 MB, ~0.08 ms at 3.35 TB/s.
//
// Design: the TPU kernel streams (256, D) row panels through VMEM. Here a
// row needs no staging: one warp owns a row, its lanes read neighbouring
// elements (coalesced), the row's sum of squares is a warp shuffle
// reduction, and the row is read a second time (from L1/L2) to write y.
// The backward's dx works the same way. dscale is a column sum across the
// rows of a group: a first kernel sums 256-row chunks of each 32-column
// strip into a float32 workspace (8 row lanes per column, reduced through
// shared memory in a fixed order), a second sums the chunks in order. No
// atomics, so results repeat run to run. The backward reads x and dy
// twice (once for dx, once for dscale): at most 2x the byte bound, the
// price of keeping both passes simple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;      // columns of one dscale block
constexpr int kRowLanes = 8;    // row lanes of one dscale block

// One warp per row; `rows` = G * rows_per_group rows of d elements.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, float* __restrict__ rstd, int64_t rows,
                   int64_t rows_per_group, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  const S* sr = scale + (row / rows_per_group) * d;
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f(xr[j]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  T* yr = y + row * d;
  for (int j = lane; j < d; j += 32) {
    yr[j] = from_f<T>((to_f(xr[j]) * r) * to_f(sr[j]));
  }
  if (lane == 0) rstd[row] = r;
}

// dx: one warp per row.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dx_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, int64_t rows, int64_t rows_per_group,
                  int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  const T* dyr = dy + row * d;
  const S* sr = scale + (row / rows_per_group) * d;
  const float r = rstd[row];
  float dot = 0.f;  // sum over the row of (dy * scale) * xh
  for (int j = lane; j < d; j += 32) {
    dot = fmaf(to_f(dyr[j]) * to_f(sr[j]), to_f(xr[j]) * r, dot);
  }
  const float c = warp_sum(dot) / static_cast<float>(d);
  T* dxr = dx + row * d;
  for (int j = lane; j < d; j += 32) {
    const float gy = to_f(dyr[j]) * to_f(sr[j]);
    const float xh = to_f(xr[j]) * r;
    dxr[j] = from_f<T>(r * (gy - xh * c));
  }
}

// dscale, first pass: block (kStrip, kRowLanes) sums rows
// [chunk * chunk_rows, +chunk_rows) of group blockIdx.z over the columns
// [blockIdx.x * kStrip, +kStrip) into partial[g, chunk, column].
template <typename T>
__global__ void __launch_bounds__(kStrip * kRowLanes)
rmsnorm_dscale_partial_kernel(const T* __restrict__ x,
                              const float* __restrict__ rstd,
                              const T* __restrict__ dy,
                              float* __restrict__ partial,
                              int64_t rows_per_group, int d, int chunk_rows) {
  __shared__ float red[kRowLanes][kStrip];
  const int col = blockIdx.x * kStrip + threadIdx.x;
  const int chunk = blockIdx.y;
  const int64_t g = blockIdx.z;
  const int64_t r0 = static_cast<int64_t>(chunk) * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < rows_per_group ? r0 + chunk_rows
                                                     : rows_per_group;
  float acc = 0.f;
  if (col < d) {
    for (int64_t r = r0 + threadIdx.y; r < r1; r += kRowLanes) {
      const int64_t row = g * rows_per_group + r;
      acc = fmaf(to_f(dy[row * d + col]), to_f(x[row * d + col]) * rstd[row],
                 acc);
    }
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kRowLanes; ++i) s += red[i][threadIdx.x];
    partial[(g * gridDim.y + chunk) * d + col] = s;
  }
}

// dscale, second pass: dscale[g, col] = sum over chunks, in order.
template <typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_sum_kernel(const float* __restrict__ partial,
                          S* __restrict__ dscale, int64_t groups, int d,
                          int chunks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= groups * d) return;
  const int64_t g = i / d;
  const int col = static_cast<int>(i % d);
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(g * chunks + c) * d + col];
  dscale[i] = from_f<S>(s);
}

unsigned row_blocks(int64_t rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

template <typename T, typename S>
void fwd(const void* x, const void* scale, void* y, float* rstd,
         int64_t groups, int64_t rows_per_group, int d, float eps,
         cudaStream_t stream) {
  const int64_t rows = groups * rows_per_group;
  rmsnorm_fwd_kernel<T, S><<<row_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rstd, rows, rows_per_group, d, eps);
}

template <typename T, typename S>
void bwd(const void* x, const void* scale, const float* rstd, const void* dy,
         void* dx, void* dscale, float* workspace, int64_t groups,
         int64_t rows_per_group, int d, int chunk_rows,
         cudaStream_t stream) {
  const int64_t rows = groups * rows_per_group;
  rmsnorm_dx_kernel<T, S><<<row_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), rows, rows_per_group,
      d);
  const int chunks =
      static_cast<int>((rows_per_group + chunk_rows - 1) / chunk_rows);
  const dim3 grid((d + kStrip - 1) / kStrip, chunks,
                  static_cast<unsigned>(groups));
  rmsnorm_dscale_partial_kernel<T><<<grid, dim3(kStrip, kRowLanes), 0,
                                     stream>>>(
      static_cast<const T*>(x), rstd, static_cast<const T*>(dy), workspace,
      rows_per_group, d, chunk_rows);
  const int64_t n = groups * d;
  rmsnorm_dscale_sum_kernel<S><<<static_cast<unsigned>(
                                     (n + kThreads - 1) / kThreads),
                                 kThreads, 0, stream>>>(
      workspace, static_cast<S*>(dscale), groups, d, chunks);
}

}  // namespace

// C interface, loaded with ctypes. x, y: (groups, rows_per_group, d)
// row-major in x's type (x_bf16 selects bfloat16, else float32); scale:
// (groups, d) in its own type (scale_bf16); rstd: (groups *
// rows_per_group,) float32. Launches on `stream` without synchronising
// and returns cudaGetLastError() (0 on success).
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  void* rstd, int64_t groups,
                                  int64_t rows_per_group, int64_t d,
                                  float eps, int x_bf16, int scale_bf16,
                                  void* stream) {
  if (groups * rows_per_group <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  const int di = static_cast<int>(d);
  if (x_bf16) {
    if (scale_bf16) {
      fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, y, r, groups,
                                        rows_per_group, di, eps, s);
    } else {
      fwd<__nv_bfloat16, float>(x, scale, y, r, groups, rows_per_group, di,
                                eps, s);
    }
  } else {
    if (scale_bf16) {
      fwd<float, __nv_bfloat16>(x, scale, y, r, groups, rows_per_group, di,
                                eps, s);
    } else {
      fwd<float, float>(x, scale, y, r, groups, rows_per_group, di, eps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// dy, dx: like x; dscale: like scale; workspace: (groups, chunks, d)
// float32 with chunks = ceil(rows_per_group / chunk_rows), at most 65535,
// as is groups.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* rstd, const void* dy, void* dx,
                                  void* dscale, void* workspace,
                                  int64_t groups, int64_t rows_per_group,
                                  int64_t d, int chunk_rows, int x_bf16,
                                  int scale_bf16, void* stream) {
  if (groups * rows_per_group <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rstd);
  float* w = static_cast<float*>(workspace);
  const int di = static_cast<int>(d);
  if (x_bf16) {
    if (scale_bf16) {
      bwd<__nv_bfloat16, __nv_bfloat16>(x, scale, r, dy, dx, dscale, w,
                                        groups, rows_per_group, di,
                                        chunk_rows, s);
    } else {
      bwd<__nv_bfloat16, float>(x, scale, r, dy, dx, dscale, w, groups,
                                rows_per_group, di, chunk_rows, s);
    }
  } else {
    if (scale_bf16) {
      bwd<float, __nv_bfloat16>(x, scale, r, dy, dx, dscale, w, groups,
                                rows_per_group, di, chunk_rows, s);
    } else {
      bwd<float, float>(x, scale, r, dy, dx, dscale, w, groups,
                        rows_per_group, di, chunk_rows, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
