// RMSNorm over the last dimension for Hopper, forward and backward:
//
//     y[g, r, :] = x[g, r, :] * rstd[g, r] * scale[g, :],
//     rstd[g, r] = rsqrt(mean(x[g, r, :]^2) + eps)
//
// Replaces the Pallas TPU kernel `rmsnorm` (body `_rmsnorm_kernel`) in
// src/repro/kernels/rmsnorm/kernel.py:28. Same arithmetic: x is read in
// its own type (float32 or bfloat16), the sum of squares is taken in
// float32, the scale is applied in float32, and y is cast once to x's
// type. The TPU kernel takes one (D,) scale; here x is viewed as (G, R, D)
// with one scale row per group g, which is what the reference gets from
// `vmap` over a (D,) scale when the batched client update trains G
// satellites. G = 1 is the unbatched call. The TPU kernel has no backward
// (its off-TPU path differentiates the jnp oracle); the backward here is
//
//     xh = x * rstd, gy = dy * scale,
//     dx = rstd * (gy - xh * mean(gy * xh)),
//     dscale[g, :] = sum over the rows r of group g of dy * xh.
//
// Bound: memory. The forward must read x and the scale and write y and
// rstd, (2*b_x*D + 4)*rows + b_s*G*D bytes, against ~4*D*rows float32
// operations; the backward must read x, dy, the scale and rstd and write
// dx and dscale, (3*b_x*D + 4)*rows + 2*b_s*G*D bytes. At the H100 SXM's
// data-sheet 3.35 TB/s (at 700 W): at the transformer payload's width
// (D = 32, 20 x 256 rows, float32) a call moves at most ~2 MB, well under
// a microsecond, so the host's launch of it sets its time; at a zoo width
// (D = 4096, 16384 rows, bfloat16) the forward moves 268 MB (0.080 ms)
// and the backward 403 MB (0.120 ms).
//
// Design. Every row is read from device memory once, in 16-byte vector
// loads (4 float32 or 8 bfloat16; a 1-wide instantiation of the same
// kernels takes rows whose width or pointers do not allow them), and held
// in registers until its output is written: `tpr` threads share a row
// (a power of two, at most the block's 256), each holding NL loads of
// it. The wrapper picks the fewest loads a thread (at most 2) and so the
// most threads a row, since registers, not loads in flight, limited the
// wide rows: on an NVIDIA H100 80GB HBM3 at 700 W, a warp per 4096-wide
// bf16 row with 16 loads a thread took 172 registers and ran at 41% of
// the byte bound, 8 warps with 2 loads at 81% (`chip_smoke.py`'s layout
// line). A row narrower than 32 loads takes fewer lanes: 8 lanes a row
// and 4 rows a warp at D = 32 float32, 512 bytes in flight per warp. The
// row's sum is a shuffle tree over its lanes, then over its warps through
// shared memory when a row spans several warps.
//   Forward: sum of squares from the registers, then y from the same
// registers with 16-byte stores; the scale is read vectorised (from L1).
//   Backward, one launch: a block owns tiles of consecutive rows of one
// group (the tiling depends on the shape alone). For each row it computes
// dx from x and dy in registers and adds dy * xh into float32 column sums
// of its own columns, in row order; at the end of a tile the row slots'
// sums are added in slot order through shared memory. Where a group is
// one tile (the transformer path: 256 rows, 8 steps of 32 rows), that sum
// is dscale and the launch is a plain one. Otherwise each tile writes a
// float32 partial, the kernel is a cooperative launch of at most the
// resident blocks, and after a grid-wide barrier every block sums
// 32-column slices of the partials in tile order (a warp sums a fixed
// range of tiles, the block adds its warps in order), so the final sum is
// spread over the card. No floating-point atomics: two calls give
// bit-equal dx and dscale. What still bounds the wide backward (60% of
// its byte bound on that card) is that a block has one row in flight and
// waits for it at the row's barrier: staging the next row in shared
// memory (cp.async or TMA) while the current one is reduced is the next
// step.
//   Rows wider than the registers hold (more than 256 threads x 8 16-byte
// loads, or x 16 1-wide loads: 8192 float32 or 16384 bfloat16 elements,
// 4096 on the 1-wide path) take row-looping instantiations of the same
// kernels (the wrapper's nl = 0): a block owns a row and walks it in
// chunks of 256 accesses. The forward reads the row twice, once for the
// sum of squares and once to write y (the second read mostly from L2); the
// backward twice, once for sum(dy * scale * xh) and once to write dx, with
// rstd from the forward. Its dscale column sums go through a float32
// partial row per tile in device memory, each column owned by one thread
// (no atomics), then through the same tile partials and fixed order as
// above. Simple, not tuned: its time is recorded in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// N consecutive elements moved as one access: 16 bytes for a wide load
// (a float32 scale beside bfloat16 x is 32 bytes, two 16-byte accesses).
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

// Sum over the `tpr` threads of a row, tpr a power of two. Rows narrower
// than a warp reduce by shuffles inside their lane group; wider rows add
// their warps' sums in warp order through red[parity] (one barrier per
// call: a caller alternates parity between calls).
__device__ __forceinline__ float row_sum(float v, int tpr,
                                         float (*red)[kWarps], int parity) {
  const int width = tpr < 32 ? tpr : 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < width) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  if (tpr <= 32) return v;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[parity][warp] = v;
  __syncthreads();
  const int wpr = tpr >> 5;
  const int w0 = warp & ~(wpr - 1);
  v = red[parity][w0];
  for (int i = 1; i < wpr; ++i) v += red[parity][w0 + i];
  return v;
}

struct FwdArgs {
  const void* x;
  const void* scale;
  void* y;
  float* rstd;
  int64_t rows, rows_per_group;
  int d, tpr_log2;
  float eps;
};

// One row per `tpr` threads; the grid covers the rows once.
template <typename T, typename S, int VEC, int NL>
__global__ void __launch_bounds__(kThreads) rmsnorm_fwd_kernel(FwdArgs a) {
  __shared__ float red[2][kWarps];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const S* __restrict__ scale = static_cast<const S*>(a.scale);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int tpr = 1 << a.tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int rpb = kThreads >> a.tpr_log2;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * rpb +
                      (threadIdx.x >> a.tpr_log2);
  const bool valid = row < a.rows;  // no early exit: row_sum may sync
  const int chunks = a.d / VEC;
  const T* xr = x + row * a.d;

  Pack<T, VEC> xv[NL];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c = lane + i * tpr;
    if (valid && c < chunks) {
      xv[i] = *reinterpret_cast<const Pack<T, VEC>*>(xr + c * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = to_f(xv[i].v[k]);
        ss = fmaf(v, v, ss);
      }
    }
  }
  ss = row_sum(ss, tpr, red, 0);
  if (!valid) return;
  const float r = rsqrtf(ss / static_cast<float>(a.d) + a.eps);
  const S* sr = scale + (row / a.rows_per_group) * a.d;
  T* yr = y + row * a.d;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int c = lane + i * tpr;
    if (c < chunks) {
      const Pack<S, VEC> sv =
          *reinterpret_cast<const Pack<S, VEC>*>(sr + c * VEC);
      Pack<T, VEC> out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        out.v[k] = from_f<T>((to_f(xv[i].v[k]) * r) * to_f(sv.v[k]));
      }
      *reinterpret_cast<Pack<T, VEC>*>(yr + c * VEC) = out;
    }
  }
  if (lane == 0) a.rstd[row] = r;
}

// A row wider than the registers hold: one block a row, read twice.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_loop_kernel(FwdArgs a) {
  __shared__ float red[2][kWarps];
  const int64_t row = blockIdx.x;
  const int chunks = a.d / VEC;
  const T* __restrict__ xr = static_cast<const T*>(a.x) + row * a.d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(xr +
                                                                  c * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_f(xv.v[k]);
      ss = fmaf(v, v, ss);
    }
  }
  ss = row_sum(ss, kThreads, red, 0);
  const float r = rsqrtf(ss / static_cast<float>(a.d) + a.eps);
  const S* __restrict__ sr =
      static_cast<const S*>(a.scale) + (row / a.rows_per_group) * a.d;
  T* __restrict__ yr = static_cast<T*>(a.y) + row * a.d;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const Pack<T, VEC> xv = *reinterpret_cast<const Pack<T, VEC>*>(xr +
                                                                  c * VEC);
    const Pack<S, VEC> sv = *reinterpret_cast<const Pack<S, VEC>*>(sr +
                                                                  c * VEC);
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      out.v[k] = from_f<T>((to_f(xv.v[k]) * r) * to_f(sv.v[k]));
    }
    *reinterpret_cast<Pack<T, VEC>*>(yr + c * VEC) = out;
  }
  if (threadIdx.x == 0) a.rstd[row] = r;
}

struct BwdArgs {
  const void* x;
  const void* scale;
  const float* rstd;
  const void* dy;
  void* dx;
  void* dscale;
  float* partial;  // (groups * tiles_per_group, d); unused at one tile
  int64_t groups, rows_per_group, tile_rows, tiles_per_group;
  int d, tpr_log2;
};

// dscale over the partials, after the grid-wide barrier: a block takes
// 32-column slices of the G*D outputs, warp w sums tiles [t0, t1) of its
// slice in order, and warp 0 adds the warps' sums in order.
template <typename S>
__device__ void dscale_from_partials(const BwdArgs& a) {
  __shared__ float fin[kWarps][32];
  const int warp = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int64_t tpg = a.tiles_per_group;
  const int64_t t0 = tpg * warp / kWarps, t1 = tpg * (warp + 1) / kWarps;
  const int64_t n = a.groups * a.d;
  S* dscale = static_cast<S*>(a.dscale);
  for (int64_t s = blockIdx.x; s * 32 < n; s += gridDim.x) {
    const int64_t q = s * 32 + l32;
    float v = 0.f;
    if (q < n) {
      const int64_t g = q / a.d;
      // written in this launch by other blocks: read through L2 only
      const float* p = a.partial + g * tpg * a.d + (q - g * a.d);
#pragma unroll 8
      for (int64_t t = t0; t < t1; ++t) v += __ldcg(p + t * a.d);
    }
    fin[warp][l32] = v;
    __syncthreads();
    if (warp == 0 && q < n) {
      float acc = fin[0][l32];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc += fin[w][l32];
      dscale[q] = from_f<S>(acc);
    }
    __syncthreads();
  }
}

// One launch: tiles of rows, dx per row, dscale by fixed-order sums.
template <typename T, typename S, int VEC, int NL>
__global__ void __launch_bounds__(kThreads) rmsnorm_bwd_kernel(BwdArgs a) {
  extern __shared__ float slot_sums[];  // (rpb, d) when rpb > 1
  __shared__ float red[2][kWarps];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dy = static_cast<const T*>(a.dy);
  const S* __restrict__ scale = static_cast<const S*>(a.scale);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int tpr = 1 << a.tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int slot = threadIdx.x >> a.tpr_log2;
  const int rpb = kThreads >> a.tpr_log2;
  const int chunks = a.d / VEC;
  const float inv_d = 1.f / static_cast<float>(a.d);
  const int64_t tiles = a.groups * a.tiles_per_group;
  int parity = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g = tile / a.tiles_per_group;
    const int64_t r0 = (tile - g * a.tiles_per_group) * a.tile_rows;
    const int64_t r1 = r0 + a.tile_rows < a.rows_per_group
                           ? r0 + a.tile_rows
                           : a.rows_per_group;
    const S* sr = scale + g * a.d;
    Pack<S, VEC> sv[NL];
    float acc[NL][VEC];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int c = lane + i * tpr;
      if (c < chunks) {
        sv[i] = *reinterpret_cast<const Pack<S, VEC>*>(sr + c * VEC);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[i][k] = 0.f;
    }
    for (int64_t base = r0; base < r1; base += rpb) {
      const int64_t r = base + slot;
      const bool valid = r < r1;
      const int64_t row = g * a.rows_per_group + r;
      const float rs = valid ? a.rstd[row] : 0.f;
      Pack<T, VEC> xv[NL], gv[NL];
      float dot = 0.f;  // sum over the row of (dy * scale) * xh
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c = lane + i * tpr;
        if (valid && c < chunks) {
          xv[i] = *reinterpret_cast<const Pack<T, VEC>*>(x + row * a.d +
                                                         c * VEC);
          gv[i] = *reinterpret_cast<const Pack<T, VEC>*>(dy + row * a.d +
                                                         c * VEC);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            dot = fmaf(to_f(gv[i].v[k]) * to_f(sv[i].v[k]),
                       to_f(xv[i].v[k]) * rs, dot);
          }
        }
      }
      const float cm = row_sum(dot, tpr, red, parity) * inv_d;
      parity ^= 1;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c = lane + i * tpr;
        if (valid && c < chunks) {
          Pack<T, VEC> out;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float dyv = to_f(gv[i].v[k]);
            const float xh = to_f(xv[i].v[k]) * rs;
            const float gy = dyv * to_f(sv[i].v[k]);
            out.v[k] = from_f<T>(rs * (gy - xh * cm));
            acc[i][k] = fmaf(dyv, xh, acc[i][k]);
          }
          *reinterpret_cast<Pack<T, VEC>*>(dx + row * a.d + c * VEC) = out;
        }
      }
    }
    // the tile's column sums: dscale itself when the group is one tile
    const bool whole = a.tiles_per_group == 1;
    float* part = a.partial + tile * a.d;
    S* ds = static_cast<S*>(a.dscale) + g * a.d;
    if (rpb == 1) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c = lane + i * tpr;
        if (c < chunks) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if (whole) {
              ds[c * VEC + k] = from_f<S>(acc[i][k]);
            } else {
              part[c * VEC + k] = acc[i][k];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int c = lane + i * tpr;
        if (c < chunks) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            slot_sums[slot * a.d + c * VEC + k] = acc[i][k];
          }
        }
      }
      __syncthreads();
      for (int j = threadIdx.x; j < a.d; j += kThreads) {
        float s = slot_sums[j];
        for (int sl = 1; sl < rpb; ++sl) s += slot_sums[sl * a.d + j];
        if (whole) {
          ds[j] = from_f<S>(s);
        } else {
          part[j] = s;
        }
      }
      __syncthreads();
    }
  }
  if (a.tiles_per_group == 1) return;
  cg::this_grid().sync();
  dscale_from_partials<S>(a);
}

// A row wider than the registers hold: one block a row at a time over its
// tiles, reading the row twice; the tile's column sums of dy * xh in
// `partial`, each column added by the one thread that owns it, in row
// order.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_bwd_loop_kernel(BwdArgs a) {
  __shared__ float red[2][kWarps];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dy = static_cast<const T*>(a.dy);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int chunks = a.d / VEC;
  const float inv_d = 1.f / static_cast<float>(a.d);
  const int64_t tiles = a.groups * a.tiles_per_group;
  int parity = 0;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t g = tile / a.tiles_per_group;
    const int64_t r0 = (tile - g * a.tiles_per_group) * a.tile_rows;
    const int64_t r1 = r0 + a.tile_rows < a.rows_per_group
                           ? r0 + a.tile_rows
                           : a.rows_per_group;
    const S* __restrict__ sr = static_cast<const S*>(a.scale) + g * a.d;
    float* part = a.partial + tile * a.d;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t row = g * a.rows_per_group + r;
      const float rs = a.rstd[row];
      const T* xr = x + row * a.d;
      const T* dyr = dy + row * a.d;
      float dot = 0.f;  // sum over the row of (dy * scale) * xh
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const Pack<T, VEC> xv =
            *reinterpret_cast<const Pack<T, VEC>*>(xr + c * VEC);
        const Pack<T, VEC> gv =
            *reinterpret_cast<const Pack<T, VEC>*>(dyr + c * VEC);
        const Pack<S, VEC> sv =
            *reinterpret_cast<const Pack<S, VEC>*>(sr + c * VEC);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          dot = fmaf(to_f(gv.v[k]) * to_f(sv.v[k]), to_f(xv.v[k]) * rs, dot);
        }
      }
      const float cm = row_sum(dot, kThreads, red, parity) * inv_d;
      parity ^= 1;
      for (int c = threadIdx.x; c < chunks; c += kThreads) {
        const Pack<T, VEC> xv =
            *reinterpret_cast<const Pack<T, VEC>*>(xr + c * VEC);
        const Pack<T, VEC> gv =
            *reinterpret_cast<const Pack<T, VEC>*>(dyr + c * VEC);
        const Pack<S, VEC> sv =
            *reinterpret_cast<const Pack<S, VEC>*>(sr + c * VEC);
        Pack<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float dyv = to_f(gv.v[k]);
          const float xh = to_f(xv.v[k]) * rs;
          out.v[k] = from_f<T>(rs * (dyv * to_f(sv.v[k]) - xh * cm));
          float* ps = part + c * VEC + k;
          *ps = r == r0 ? dyv * xh : fmaf(dyv, xh, *ps);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + row * a.d + c * VEC) = out;
      }
    }
    if (a.tiles_per_group == 1) {  // the tile's sums are dscale
      S* ds = static_cast<S*>(a.dscale) + g * a.d;
      for (int j = threadIdx.x; j < chunks; j += kThreads) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          ds[j * VEC + k] = from_f<S>(part[j * VEC + k]);
        }
      }
    }
  }
  if (a.tiles_per_group == 1) return;
  cg::this_grid().sync();
  dscale_from_partials<S>(a);
}

unsigned blocks_for(int64_t rows, int tpr_log2) {
  const int64_t rpb = kThreads >> tpr_log2;
  return static_cast<unsigned>((rows + rpb - 1) / rpb);
}

template <typename T, typename S, int VEC, int NL>
int fwd(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (NL == 0) {
    rmsnorm_fwd_loop_kernel<T, S, VEC>
        <<<blocks_for(a.rows, a.tpr_log2), kThreads, 0, stream>>>(a);
  } else {
    rmsnorm_fwd_kernel<T, S, VEC, NL>
        <<<blocks_for(a.rows, a.tpr_log2), kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// The current device, or -1.
int device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  return dev;
}

int sm_count(int dev) {
  static int count[kMaxDevices];  // a constant of each device
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  return count[dev];
}

// The backward's kernel: row-looping at nl = 0, register-held otherwise.
template <typename T, typename S, int VEC, int NL>
auto bwd_kernel() {
  if constexpr (NL == 0) {
    return rmsnorm_bwd_loop_kernel<T, S, VEC>;
  } else {
    return rmsnorm_bwd_kernel<T, S, VEC, NL>;
  }
}

template <typename T, typename S, int VEC, int NL>
int bwd(BwdArgs a, cudaStream_t stream) {
  auto kernel = bwd_kernel<T, S, VEC, NL>();
  const int rpb = kThreads >> a.tpr_log2;
  const size_t smem =
      rpb > 1 ? static_cast<size_t>(rpb) * a.d * sizeof(float) : 0;
  const int64_t tiles = a.groups * a.tiles_per_group;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.tiles_per_group == 1) {  // no cross-block sum: a plain launch
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // resident blocks of this instantiation at this shared memory size: a
  // constant of the device, kept per device (the query costs host time)
  static struct {
    size_t smem;
    int per_sm;
  } occupancy[kMaxDevices];
  const int dev = device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSuccess;
  if (occupancy[dev].per_sm == 0 || occupancy[dev].smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy[dev].per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occupancy[dev].smem = smem;
  }
  const int64_t resident =
      static_cast<int64_t>(occupancy[dev].per_sm) * sm_count(dev);
  if (resident <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const unsigned grid =
      static_cast<unsigned>(tiles < resident ? tiles : resident);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  return static_cast<int>(err);
}

// Dispatch on the loads per thread, the vector width and the types; 0
// loads selects the row-looping kernels. The backward's wide path stops at
// 8 loads a thread (its column sums take registers too); the wrapper never
// asks for more.
#define RMS_CASE(FN, VEC, NL) \
  case NL:                    \
    return FN<T, S, VEC, NL>(a, stream);

template <typename T, typename S>
int dispatch_fwd(int vec, int nl, const FwdArgs& a, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) {
    switch (nl) {
      RMS_CASE(fwd, kWide, 0)
      RMS_CASE(fwd, kWide, 1)
      RMS_CASE(fwd, kWide, 2)
      RMS_CASE(fwd, kWide, 4)
      RMS_CASE(fwd, kWide, 8)
      RMS_CASE(fwd, kWide, 16)
    }
  } else if (vec == 1) {
    switch (nl) {
      RMS_CASE(fwd, 1, 0)
      RMS_CASE(fwd, 1, 1)
      RMS_CASE(fwd, 1, 2)
      RMS_CASE(fwd, 1, 4)
      RMS_CASE(fwd, 1, 8)
      RMS_CASE(fwd, 1, 16)
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename S>
int dispatch_bwd(int vec, int nl, const BwdArgs& a, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) {
    switch (nl) {
      RMS_CASE(bwd, kWide, 0)
      RMS_CASE(bwd, kWide, 1)
      RMS_CASE(bwd, kWide, 2)
      RMS_CASE(bwd, kWide, 4)
      RMS_CASE(bwd, kWide, 8)
    }
  } else if (vec == 1) {
    switch (nl) {
      RMS_CASE(bwd, 1, 0)
      RMS_CASE(bwd, 1, 1)
      RMS_CASE(bwd, 1, 2)
      RMS_CASE(bwd, 1, 4)
      RMS_CASE(bwd, 1, 8)
      RMS_CASE(bwd, 1, 16)
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef RMS_CASE

}  // namespace

// C interface, loaded with ctypes. x, y: (groups, rows_per_group, d)
// row-major in x's type, scale: (groups, d) in its own type; `dtypes` is
// 1 for bfloat16 x plus 2 for a bfloat16 scale (else float32); rstd:
// (groups * rows_per_group,) float32. `vec` is the elements per access:
// 16 bytes' worth (x, y and scale 16-byte aligned and d * sizeof(x) a
// multiple of 16) or 1. A row is shared by 2^tpr_log2 <= 256 threads of
// nl loads each (1, 2, 4, 8 or 16), which must cover d / vec; nl = 0 with
// tpr_log2 = 8 selects the row-looping kernels, which take any d. Launches on
// `stream` without synchronising; returns the CUDA error (0 on success).
extern "C" int rmsnorm_fwd_launch(const void* x, const void* scale, void* y,
                                  void* rstd, int64_t groups,
                                  int64_t rows_per_group, int64_t d,
                                  float eps, int dtypes, int vec,
                                  int tpr_log2, int nl, void* stream) {
  const FwdArgs a{x,      scale, y, static_cast<float*>(rstd),
                  groups * rows_per_group, rows_per_group,
                  static_cast<int>(d), tpr_log2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.rows <= 0 || d <= 0) return 0;
  switch (dtypes) {
    case 0: return dispatch_fwd<float, float>(vec, nl, a, s);
    case 1: return dispatch_fwd<__nv_bfloat16, float>(vec, nl, a, s);
    case 2: return dispatch_fwd<float, __nv_bfloat16>(vec, nl, a, s);
    case 3: return dispatch_fwd<__nv_bfloat16, __nv_bfloat16>(vec, nl, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dy, dx: like x (16-byte aligned too on the wide path); dscale: like
// scale. Rows of a group are cut into tiles of tile_rows (a multiple of
// the rows a block holds at once); with more than one tile per group, or
// at nl = 0, partial is a float32 workspace of (groups * tiles, d); with
// more than one tile per group the launch is cooperative. One launch in
// every case.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* scale,
                                  const void* rstd, const void* dy, void* dx,
                                  void* dscale, void* partial,
                                  int64_t groups, int64_t rows_per_group,
                                  int64_t d, int64_t tile_rows, int dtypes,
                                  int vec, int tpr_log2, int nl,
                                  void* stream) {
  if (groups * rows_per_group <= 0 || d <= 0 || tile_rows <= 0) return 0;
  const BwdArgs a{x, scale, static_cast<const float*>(rstd), dy, dx, dscale,
                  static_cast<float*>(partial), groups, rows_per_group,
                  tile_rows, (rows_per_group + tile_rows - 1) / tile_rows,
                  static_cast<int>(d), tpr_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0: return dispatch_bwd<float, float>(vec, nl, a, s);
    case 1: return dispatch_bwd<__nv_bfloat16, float>(vec, nl, a, s);
    case 2: return dispatch_bwd<float, __nv_bfloat16>(vec, nl, a, s);
    case 3: return dispatch_bwd<__nv_bfloat16, __nv_bfloat16>(vec, nl, a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
