// Warp-level tensor-core tiles for Hopper, shared by the attention kernels
// on the tensor cores (flash_fwd_tc.cu, flash_bwd_tc.cu and the hd-256
// flash_fwd_tc256.cu, flash_bwd_tc256.cu): bf16 tiles copied
// global -> shared with cp.async, read into mma.sync.m16n8k16 fragments
// with ldmatrix (.trans for the operand stored k-major), float32 sums.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): a lane is
// (quad_row = lane / 4, quad_lane = lane % 4). An m16n8 accumulator holds
// rows quad_row and quad_row + 8, columns 2 quad_lane and 2 quad_lane + 1;
// an A operand's register e holds row quad_row + 8 (e % 2), columns
// 8 (e / 2) + 2 quad_lane and the next. So two neighbouring accumulators
// (n-blocks 2 kk and 2 kk + 1), packed to bf16, are the A operand of
// k-step kk of the next product: a score tile never leaves registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;   // bf16 elements of padding a shared row (16 bytes)

// Elements a shared row of a tile HD wide: padded so that the 8 rows an
// ldmatrix reads fall on distinct banks.
template <int HD>
__host__ __device__ constexpr int stride() {
  return HD + kPad;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronous; a source size of 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

// The A fragment of rows [row0, row0 + 16) and columns [col0, col0 + 16)
// of a row-major shared tile (row stride `ld` elements).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* sm,
                                       int ld, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(r, sm + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B fragments of two n-blocks (r[0..1]: columns n0..n0+7, r[2..3]: the next
// 8) at k-step [k0, k0 + 16), for B = T^T where the shared tile T holds
// B's columns as its rows (T[n][k], row-major: K in Q K^T).
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* sm,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4(r, sm + (n0 + mr + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8);
}

// The same for B stored k-major (T[k][n], row-major: V in P V), through
// ldmatrix.trans.
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const bf16* sm,
                                             int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4_trans(r,
                    sm + (k0 + mr + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8);
}

// d += a * b on one m16n8k16 tile: bf16 inputs, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p0, p1 as the sum of a high and a low bf16 part, each pair in one
// register: hi = bf16(p), lo = bf16(p - hi), so hi + lo is p to within
// 2^-17 of p (p - hi is exact in float32 and at most 2^-8 of p).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - __low2float(h), p1 - __high2float(h));
}

// The A fragments of k-step kk of a product whose A is a score tile held
// as m16n8 accumulators (n-blocks 2 kk and 2 kk + 1): one bf16 part, or
// with SPLIT a high part `hi` and a low part `lo`.
template <bool SPLIT>
__device__ __forceinline__ void score_a(const float (*t)[4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* c = t[2 * kk + (e >> 1)] + 2 * (e & 1);
    if (SPLIT) {
      split_bf16(c[0], c[1], hi[e], lo[e]);
    } else {
      hi[e] = pack_bf16(c[0], c[1]);
    }
  }
}

// Rows [r0, r0 + ROWS) of a (rows, HD) bf16 matrix into shared memory (row
// stride stride<HD>()), by THREADS threads; rows at or past `limit` are
// zero-filled.
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int r0,
                                          int limit) {
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a row
  static_assert(ROWS * kChunks % THREADS == 0, "whole passes");
#pragma unroll
  for (int p = 0; p < ROWS * kChunks / THREADS; ++p) {
    const int c = p * THREADS + threadIdx.x;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool in = r0 + r < limit;
    cp_async16(sm + r * stride<HD>() + col,
               g + static_cast<int64_t>(in ? r0 + r : 0) * HD + col,
               in ? 16 : 0);
  }
}

// Rows [r0, r0 + ROWS) of a (rows, HD) bf16 matrix whose row r starts at
// g + r * ld, into shared memory (row stride stride<HD>()), by THREADS
// threads, a thread the same 16 bytes of every THREADS / (HD / 8)-th row;
// rows at or past `limit` are zero-filled. The loop is not unrolled:
// unrolled, its addresses took registers that the hd-256 kernels'
// accumulators need (ptxas spilled).
template <int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int64_t ld,
                                          int r0, int limit) {
  constexpr int kChunks = HD / 8;          // 16-byte pieces of a row
  constexpr int kStep = THREADS / kChunks; // rows a pass
  static_assert(THREADS % kChunks == 0 && ROWS % kStep == 0, "whole passes");
  const int col = (threadIdx.x % kChunks) * 8;
#pragma unroll 1
  for (int r = threadIdx.x / kChunks; r < ROWS; r += kStep) {
    const bool in = r0 + r < limit;
    cp_async16(sm + r * stride<HD>() + col,
               g + (in ? static_cast<int64_t>(r0 + r) * ld : 0) + col,
               in ? 16 : 0);
  }
}

// Raise a kernel's dynamic shared-memory limit once per device (the query
// costs host time); 0 or the CUDA error.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes, bool (&raised)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return 0;
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  return 0;
}

}  // namespace tc
