// Flash attention backward with GQA on Hopper's tensor cores, bfloat16 at
// (padded) head dim 256: the gradients of
//
//     o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kv, j] * scale)
//                  * v[b, kv, j],         kv = h / (H / K),
//
// for a cotangent do, from the forward's o and log-sum-exp (either forward
// route writes them alike). FlashAttention-2's backward, as in
// flash_bwd_tc.cu:
//     delta_i = sum_d do_i * o_i,          p_ij = exp(s_ij * scale - lse_i),
//     dv_j = sum_i p_ij do_i,              ds_ij = p_ij (do_i . v_j - delta_i),
//     dk_j = sum_i ds_ij q_i * scale,      dq_i = sum_j ds_ij k_j * scale,
// over the visible pairs (top-left causal, optional window i - j < window);
// ref.py::attention_bwd_ref states the function.
//
// Replaces, for bfloat16 inputs at padded head dim 256 that do not take the
// short-sequence kernels, the gradient of the Pallas TPU kernel
// `flash_attention` in src/repro/kernels/flash_attention/kernel.py:91,
// which has no backward of its own (off the TPU the reference
// differentiates its jnp oracle); those calls took flash_attention.cu's
// float32 CUDA-core backward before.
//
// Bound: operations. A visible (query, key) pair costs 10*hd operations in
// the backward's five products; at recurrentgemma-9b's local layers (B 1,
// H 16, K 1, S 4096, causal, window 2048) that is 258 GFLOP, 0.261 ms at
// the H100 SXM's dense bf16 rate of 989 TFLOP/s, against 0.013 ms to move
// q, k, v, o, do, lse, dq, dk and dv once. This design does 7 products a
// pair (dk/dv and dq both recompute S and dP), 10 with P and dS each split
// in two bf16 parts.
//
// Design: flash_bwd_tc.cu's three kernels (delta; dk/dv a block of keys;
// dq a block of queries), resized for a row of 256. There a warp keeps the
// float32 sums of 16 rows across all of hd in registers; at 256 that is
// 2 x 128 registers a thread for dK and dV alone, past the 255 a thread
// has. Here two warps share 16 rows and split hd: each keeps the sums of
// its 128 columns (dK and dV: 128 registers; dQ: 64), and each computes
// S and dP over its 128 dims only, a partial contraction; the two
// partials meet in shared memory (a named barrier for the pair) and each
// warp adds them, so both hold the same S and dP bits (float addition
// commutes). A block is 8 warps: 4 row groups x 2 halves of hd.
//  - delta: a warp a row, 16 bytes a lane, float32 sums, fixed order.
//  - dk/dv: a block owns 64 keys of one (b, kv head) and one group of its
//    G query heads, K and V resident in shared memory; it walks the
//    group's heads and, for each, the 32-query tiles that see its keys,
//    Q and dO (and lse, delta) in two cp.async stages. Per tile a warp
//    computes its partial S^T = K Q^T and dP^T = V dO^T (K, V as A
//    operands, Q, dO as B through ldmatrix), exchanges, then P^T and
//    dS^T = P^T (dP^T - delta) per column and dV += P^T dO, dK += dS^T Q
//    over its 128 columns (dO, Q through ldmatrix.trans).
//  - Filling the card: recurrentgemma-9b has one kv head, so its 4,096
//    keys are 64 blocks, under half the card's 132 SMs. The wrapper then
//    splits the G heads into `groups` (`kernel.py::bwd_groups`): each
//    group's block writes its float32 partial dK and dV to a workspace
//    and flash_bwd_tc256_merge_kernel adds the groups in a fixed order
//    (g = 0, 1, ...), so two calls give the same bits. With one group the
//    block writes dK * scale and dV directly.
//  - dq: a block owns 64 query rows of one (b, h), Q and dO resident; it
//    walks the 32-key tiles the rows see (K, V in two stages): partial
//    S = Q K^T and dP = dO V^T, exchange, dS = P (dP - delta) per row,
//    dQ += dS K over the warp's 128 columns (K through ldmatrix.trans).
//  - Tiles that no row sees are skipped (causal diagonal, window edge) in
//    both kernels; only a tile that straddles a boundary (or Sq, Sk) gets
//    the element mask, which sets p = dS = 0 by selection (a query row
//    that sees no key has lse = -inf and exp2(s - lse) = inf there).
//  - q, k, v, o, do and dq, dk, dv are read and written through their
//    batch, sequence and head strides (rows on 16 bytes), so the (B, S, H,
//    hd) layout takes no copy; hd 240 is zero-padded by the wrapper.
//  - Rounding: P and dS are rounded to bf16 as the operands of dV, dK and
//    dQ, in one part or, with SPLIT, a high and a low part (p to 2^-17).
//  - Sums over query tiles, heads and key tiles run in a fixed order and
//    no atomics are used: two calls give the same bits.
//  - Registers: the load loops do not unroll (`load_rows`), as in the
//    hd-256 forward; shared memory 164.5 KB a block, one block an SM.
//
// What a later step adds: wgmma from shared memory with TMA copies
// (FlashAttention-3's backward), the only path to the full rate.

#include <math.h>
#include <string.h>

#include "tc_tiles.cuh"

namespace {

using namespace tc;

constexpr int kHD = 256;                 // the (padded) head dim
constexpr int kHalf = kHD / 2;           // columns a warp owns
constexpr int kStride = stride<kHD>();   // elements a shared row
constexpr int kWarps = 8;                // 4 row groups x 2 halves of hd
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;                // keys of a dk/dv block, queries of dq
constexpr int kBQ = 32;                  // queries a dk/dv tile
constexpr int kBK = 32;                  // keys a dq tile
constexpr int kScore = 4 * 4;            // registers of a 16 x 32 score tile
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const float* lse;   // (B, H, Sq)
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* delta;       // (B, H, Sq) workspace
  float* part;        // (2, groups, B, K, Sk, 256) workspace, groups > 1
  int B, H, K, Sq, Sk, causal, window, groups, parts;
  float scale;
  // batch, sequence, head strides, in elements
  int64_t sq[3], sk[3], sv[3], so[3], sdo[3], sdq[3], sdk[3], sdv[3];
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return i < p.Sq && j < p.Sk && (!p.causal || j <= i) &&
         (p.window <= 0 || i - j < p.window);
}

// The two warps of row group `group` (64 threads) meet.
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(64) : "memory");
}

// s and d (this warp's partial 16 x 32 score tiles) become the sums over
// both halves of hd: written to this warp's slot of `xch`, then the other
// half's slot added. Both warps add the same two floats, so both hold the
// same bits.
__device__ __forceinline__ void exchange(float (*s)[4], float (*d)[4],
                                         float* xch, int warp, int lane) {
  float* mine = xch + warp * 2 * kScore * 32;
  const float* other = xch + (warp ^ 4) * 2 * kScore * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(j * 4 + e) * 32 + lane] = s[j][e];
      mine[(kScore + j * 4 + e) * 32 + lane] = d[j][e];
    }
  }
  pair_sync(warp & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] += other[(j * 4 + e) * 32 + lane];
      d[j][e] += other[(kScore + j * 4 + e) * 32 + lane];
    }
  }
}

// acc (16 rows x this warp's 128 columns, from col0) += A (16 x 16,
// k-step kk of the score tile t) times rows [16 kk, 16 kk + 16) of the
// shared tile b (k-major, row stride kStride).
template <bool SPLIT>
__device__ __forceinline__ void score_times(float (*acc)[4],
                                            const float (*t)[4], int kk,
                                            const bf16* b, int col0) {
  uint32_t hi[4], lo[4];
  score_a<SPLIT>(t, kk, hi, lo);
#pragma unroll
  for (int nn = 0; nn < kHalf / 16; ++nn) {   // 16 columns: two n-blocks
    uint32_t bf[4];
    load_b_trans(bf, b, kStride, col0 + nn * 16, kk * 16);
    mma_bf16(acc[2 * nn], hi, bf[0], bf[1]);
    mma_bf16(acc[2 * nn + 1], hi, bf[2], bf[3]);
    if (SPLIT) {
      mma_bf16(acc[2 * nn], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * nn + 1], lo, bf[2], bf[3]);
    }
  }
}

// ------------------------------------------------------------------ delta

// One warp a (b, h, i) row, 8 rows a block: delta = sum_d do * o.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_tc256_delta_kernel(const Params p) {
  static_assert(HD == 32 * 8, "a warp a row, 16 bytes a lane");
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;   // a row's lanes leave together
  const int64_t i = r % p.Sq, h = r / p.Sq % p.H, b = r / p.Sq / p.H;
  const uint4 a = *reinterpret_cast<const uint4*>(
      p.o + b * p.so[0] + i * p.so[1] + h * p.so[2] + lane * 8);
  const uint4 c = *reinterpret_cast<const uint4*>(
      p.dout + b * p.sdo[0] + i * p.sdo[1] + h * p.sdo[2] + lane * 8);
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&c);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 fa = __bfloat1622float2(pa[t]);
    const float2 fc = __bfloat1622float2(pc[t]);
    acc = fmaf(fa.x, fc.x, acc);
    acc = fmaf(fa.y, fc.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) p.delta[r] = acc;
}

// ------------------------------------------------------------------ dk, dv

struct DkdvLayout {
  static constexpr int kKV = kRows * kStride;   // elements of K or V
  static constexpr int kQ = kBQ * kStride;      // elements of a Q or dO stage
  // K, V, two stages of Q and of dO; two stages of lse and of delta; the
  // warps' exchange slots
  static constexpr size_t kBytes = (2 * kKV + 4 * kQ) * sizeof(bf16) +
                                   4 * kBQ * sizeof(float) +
                                   kWarps * 2 * kScore * 32 * sizeof(float);
};

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc256_dkdv_kernel(const Params p) {
  using L = DkdvLayout;
  constexpr int kOut = kHalf / 8;   // n-blocks of this warp's dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kKV;
  bf16* qs = vs + L::kKV;           // two stages
  bf16* dos = qs + 2 * L::kQ;       // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * L::kQ);   // two stages
  float* delta_s = lse_s + 2 * kBQ;                            // two stages
  float* xch = delta_s + 2 * kBQ;

  // block -> (kv head, b, head group, key tile): kv head fastest, the key
  // tile slowest, first tiles (under causal masking the most queries)
  // first
  int idx = blockIdx.x;
  const int kvh = idx % p.K;
  idx /= p.K;
  const int b = idx % p.B;
  idx /= p.B;
  const int grp = idx % p.groups;
  const int k0 = idx / p.groups * kRows;
  const int G = p.H / p.K;
  const int g0 = static_cast<int>(static_cast<int64_t>(G) * grp / p.groups);
  const int ng = static_cast<int>(static_cast<int64_t>(G) * (grp + 1) /
                                  p.groups) - g0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 16, col0 = (warp >> 2) * kHalf;
  const int quad_row = lane >> 2, quad_lane = lane & 3;

  // queries that see some key of the block, in tiles of kBQ from the first
  const int k_last = min(p.Sk - 1, k0 + kRows - 1);
  const int blo = p.causal ? k0 : 0;
  const int bhi = p.window > 0 ? min(p.Sq - 1, k_last + p.window - 1)
                               : p.Sq - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBQ + 1 : 0;
  const int total = ng * ntiles;    // (head, tile) steps

  auto load_step = [&](int step, int st) {
    const int q0 = blo + (step % ntiles) * kBQ;
    const int h = kvh * G + g0 + step / ntiles;
    load_rows<kHD, kBQ, kThreads>(qs + st * L::kQ,
                                  p.q + b * p.sq[0] + h * p.sq[2], p.sq[1],
                                  q0, p.Sq);
    load_rows<kHD, kBQ, kThreads>(dos + st * L::kQ,
                                  p.dout + b * p.sdo[0] + h * p.sdo[2],
                                  p.sdo[1], q0, p.Sq);
    if (threadIdx.x < kBQ) {
      const int i = q0 + threadIdx.x;
      const bool in = i < p.Sq;
      const int64_t e = (static_cast<int64_t>(b) * p.H + h) * p.Sq +
                        (in ? i : 0);
      cp_async4(lse_s + st * kBQ + threadIdx.x, p.lse + e, in ? 4 : 0);
      cp_async4(delta_s + st * kBQ + threadIdx.x, p.delta + e, in ? 4 : 0);
    }
  };

  load_rows<kHD, kRows, kThreads>(ks, p.k + b * p.sk[0] + kvh * p.sk[2],
                                  p.sk[1], k0, p.Sk);
  load_rows<kHD, kRows, kThreads>(vs, p.v + b * p.sv[0] + kvh * p.sv[2],
                                  p.sv[1], k0, p.Sk);
  if (total > 0) load_step(0, 0);
  cp_async_commit();

  float dkacc[kOut][4], dvacc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;
  }
  const float sl2 = p.scale * kLog2e;

  for (int step = 0; step < total; ++step) {
    const int st = step & 1;
    cp_async_wait<0>();   // this step's tiles (and K, V) have landed ...
    __syncthreads();      // ... for every thread; the last step is done
    if (step + 1 < total) load_step(step + 1, st ^ 1);
    cp_async_commit();
    const int q0 = blo + (step % ntiles) * kBQ;
    const bf16* qt = qs + st * L::kQ;
    const bf16* dt = dos + st * L::kQ;
    const float* lt = lse_s + st * kBQ;
    const float* delt = delta_s + st * kBQ;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries, over this
    // warp's 128 dims; then over all 256
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHalf / 16; ++kk) {
      const int c = col0 + kk * 16;
      uint32_t ka[4], va[4];
      load_a(ka, ks, kStride, row0, c);
      load_a(va, vs, kStride, row0, c);
#pragma unroll
      for (int jj = 0; jj < kBQ / 16; ++jj) {   // 16 queries: two n-blocks
        uint32_t bf[4];
        load_b(bf, qt, kStride, jj * 16, c);
        mma_bf16(sc[2 * jj], ka, bf[0], bf[1]);
        mma_bf16(sc[2 * jj + 1], ka, bf[2], bf[3]);
        load_b(bf, dt, kStride, jj * 16, c);
        mma_bf16(dp[2 * jj], va, bf[0], bf[1]);
        mma_bf16(dp[2 * jj + 1], va, bf[2], bf[3]);
      }
    }
    exchange(sc, dp, xch, warp, lane);

    // P^T into sc and dS^T into dp, per column; the element mask only
    // where the tile straddles a boundary
    const int q_last = q0 + kBQ - 1;
    const bool full = q_last < p.Sq && k0 + kRows - 1 < p.Sk &&
                      (!p.causal || q0 >= k0 + kRows - 1) &&
                      (p.window <= 0 || q_last - k0 < p.window);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * quad_lane + (e & 1);
        const float pv = exp2f(sc[j][e] * sl2 - lt[c] * kLog2e);
        const float ds = pv * (dp[j][e] - delt[c]);
        const int key = k0 + row0 + quad_row + 8 * (e >> 1);
        const bool keep = full || visible(p, q0 + c, key);
        sc[j][e] = keep ? pv : 0.f;
        dp[j][e] = keep ? ds : 0.f;
      }
    }
    // dV += P^T dO and dK += dS^T Q over this warp's columns, a k-step of
    // 16 queries at a time
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      score_times<SPLIT>(dvacc, sc, kk, dt, col0);
      score_times<SPLIT>(dkacc, dp, kk, qt, col0);
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + quad_row + 8 * r;
    if (key >= p.Sk) continue;
    if (p.groups == 1) {
      bf16* dkr = p.dk + b * p.sdk[0] + key * p.sdk[1] + kvh * p.sdk[2] +
                  col0 + 2 * quad_lane;
      bf16* dvr = p.dv + b * p.sdv[0] + key * p.sdv[1] + kvh * p.sdv[2] +
                  col0 + 2 * quad_lane;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + n * 8) = pack_bf16(
            dkacc[n][2 * r] * p.scale, dkacc[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + n * 8) =
            pack_bf16(dvacc[n][2 * r], dvacc[n][2 * r + 1]);
      }
    } else {
      // float32 partials (unscaled), merged by flash_bwd_tc256_merge_kernel
      const int64_t slab = static_cast<int64_t>(p.groups) * p.B * p.K *
                           p.Sk * kHD;
      const int64_t row =
          (((static_cast<int64_t>(grp) * p.B + b) * p.K + kvh) * p.Sk +
           key) * kHD + col0 + 2 * quad_lane;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        *reinterpret_cast<float2*>(p.part + row + n * 8) =
            make_float2(dkacc[n][2 * r], dkacc[n][2 * r + 1]);
        *reinterpret_cast<float2*>(p.part + slab + row + n * 8) =
            make_float2(dvacc[n][2 * r], dvacc[n][2 * r + 1]);
      }
    }
  }
}

// One warp a (b, kv head, key) row, 8 dims a lane, 8 rows a block: the
// head groups' partial dK and dV added in order (g = 0, 1, ...), dK times
// scale, both written in bf16 through their strides.
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_tc256_merge_kernel(const Params p) {
  static_assert(HD == 32 * 8, "a warp a row, 8 dims a lane");
  const int64_t rows = static_cast<int64_t>(p.B) * p.K * p.Sk;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t j = r % p.Sk, kvh = r / p.Sk % p.K, b = r / p.Sk / p.K;
  const int64_t slab = static_cast<int64_t>(p.groups) * rows * HD;
#pragma unroll
  for (int which = 0; which < 2; ++which) {   // dK, then dV
    const float* src = p.part + which * slab + r * HD + lane * 8;
    float acc[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[t] = 0.f;
    for (int g = 0; g < p.groups; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(src + g * rows * HD);
      const float4 y =
          *reinterpret_cast<const float4*>(src + g * rows * HD + 4);
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
      acc[4] += y.x;
      acc[5] += y.y;
      acc[6] += y.z;
      acc[7] += y.w;
    }
    const float mul = which == 0 ? p.scale : 1.f;
    uint4 out;
    out.x = pack_bf16(acc[0] * mul, acc[1] * mul);
    out.y = pack_bf16(acc[2] * mul, acc[3] * mul);
    out.z = pack_bf16(acc[4] * mul, acc[5] * mul);
    out.w = pack_bf16(acc[6] * mul, acc[7] * mul);
    bf16* dst = which == 0
        ? p.dk + b * p.sdk[0] + j * p.sdk[1] + kvh * p.sdk[2] + lane * 8
        : p.dv + b * p.sdv[0] + j * p.sdv[1] + kvh * p.sdv[2] + lane * 8;
    *reinterpret_cast<uint4*>(dst) = out;
  }
}

// --------------------------------------------------------------------- dq

struct DqLayout {
  static constexpr int kQ = kRows * kStride;    // elements of Q or dO
  static constexpr int kTile = kBK * kStride;   // elements of a K or V stage
  // Q, dO, two stages of K and of V; the warps' exchange slots
  static constexpr size_t kBytes = (2 * kQ + 4 * kTile) * sizeof(bf16) +
                                   kWarps * 2 * kScore * 32 * sizeof(float);
};

template <bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tc256_dq_kernel(const Params p) {
  using L = DqLayout;
  constexpr int kOut = kHalf / 8;   // n-blocks of this warp's dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::kQ;
  bf16* ks = dos + L::kQ;           // two stages
  bf16* vs = ks + 2 * L::kTile;     // two stages
  float* xch = reinterpret_cast<float*>(vs + 2 * L::kTile);

  // block -> (h, b, query tile): h fastest (the heads of a kv head are
  // neighbours, their K and V tiles meet in L2), the longest tiles first
  // under causal masking
  const int tiles = (p.Sq + kRows - 1) / kRows;
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int b = idx % p.B;
  idx /= p.B;
  const int q0 = (p.causal ? tiles - 1 - idx : idx) * kRows;
  const int kvh = h / (p.H / p.K);
  const bf16* kb = p.k + b * p.sk[0] + kvh * p.sk[2];
  const bf16* vb = p.v + b * p.sv[0] + kvh * p.sv[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 16, col0 = (warp >> 2) * kHalf;
  const int quad_row = lane >> 2, quad_lane = lane & 3;
  const float sl2 = p.scale * kLog2e;

  // this lane's two rows: keys [lo, hi] they see, lse log2(e) and delta
  int lo[2], hi[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row0 + quad_row + 8 * r;
    const int64_t e = (static_cast<int64_t>(b) * p.H + h) * p.Sq + i;
    lo[r] = p.window > 0 ? max(0, i - p.window + 1) : 0;
    hi[r] = p.causal ? min(p.Sk - 1, i) : p.Sk - 1;
    l2[r] = i < p.Sq ? p.lse[e] * kLog2e : 0.f;
    dl[r] = i < p.Sq ? p.delta[e] : 0.f;
  }
  // keys some row of the block sees, and keys every row of it sees
  const int q_last = min(p.Sq - 1, q0 + kRows - 1);
  const int blo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int bhi = p.causal ? min(p.Sk - 1, q_last) : p.Sk - 1;
  const int all_lo = p.window > 0 ? max(0, q_last - p.window + 1) : 0;
  const int all_hi = p.causal ? min(p.Sk - 1, q0) : p.Sk - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBK + 1 : 0;

  load_rows<kHD, kRows, kThreads>(qs, p.q + b * p.sq[0] + h * p.sq[2],
                                  p.sq[1], q0, p.Sq);
  load_rows<kHD, kRows, kThreads>(dos, p.dout + b * p.sdo[0] + h * p.sdo[2],
                                  p.sdo[1], q0, p.Sq);
  if (ntiles > 0) {
    load_rows<kHD, kBK, kThreads>(ks, kb, p.sk[1], blo, p.Sk);
    load_rows<kHD, kBK, kThreads>(vs, vb, p.sv[1], blo, p.Sk);
  }
  cp_async_commit();

  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = blo + t * kBK;
    const int st = t & 1;
    cp_async_wait<0>();     // this tile (and Q, dO) have landed ...
    __syncthreads();        // ... for every thread; the last tile is done
    if (t + 1 < ntiles) {   // prefetch the next tile into the other stage
      load_rows<kHD, kBK, kThreads>(ks + (st ^ 1) * L::kTile, kb, p.sk[1],
                                    k0 + kBK, p.Sk);
      load_rows<kHD, kBK, kThreads>(vs + (st ^ 1) * L::kTile, vb, p.sv[1],
                                    k0 + kBK, p.Sk);
    }
    cp_async_commit();
    const bf16* kt = ks + st * L::kTile;
    const bf16* vt = vs + st * L::kTile;

    // S = Q K^T and dP = dO V^T, 16 rows x 32 keys, over this warp's 128
    // dims; then over all 256
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kHalf / 16; ++kk) {
      const int c = col0 + kk * 16;
      uint32_t qa[4], da[4];
      load_a(qa, qs, kStride, row0, c);
      load_a(da, dos, kStride, row0, c);
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) {   // 16 keys: two n-blocks
        uint32_t bf[4];
        load_b(bf, kt, kStride, jj * 16, c);
        mma_bf16(sc[2 * jj], qa, bf[0], bf[1]);
        mma_bf16(sc[2 * jj + 1], qa, bf[2], bf[3]);
        load_b(bf, vt, kStride, jj * 16, c);
        mma_bf16(dp[2 * jj], da, bf[0], bf[1]);
        mma_bf16(dp[2 * jj + 1], da, bf[2], bf[3]);
      }
    }
    exchange(sc, dp, xch, warp, lane);

    // dS = P (dP - delta) into dp, per row; the element mask only where
    // the tile straddles a boundary
    const bool full = k0 >= all_lo && k0 + kBK - 1 <= all_hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + 2 * quad_lane + (e & 1);
        const float pv = exp2f(sc[j][e] * sl2 - l2[r]);
        const float ds = pv * (dp[j][e] - dl[r]);
        dp[j][e] = full || (key >= lo[r] && key <= hi[r]) ? ds : 0.f;
      }
    }
    // dQ += dS K over this warp's columns, a k-step of 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      score_times<SPLIT>(acc, dp, kk, kt, col0);
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + row0 + quad_row + 8 * r;
    if (i >= p.Sq) continue;
    bf16* row = p.dq + b * p.sdq[0] + i * p.sdq[1] + h * p.sdq[2] + col0 +
                2 * quad_lane;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(
          acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}

// ----------------------------------------------------------------- launch

template <bool SPLIT>
int launch(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int64_t kv_rows = static_cast<int64_t>(p.B) * p.K * p.Sk;
  const int64_t kblocks =
      static_cast<int64_t>(p.groups) * p.B * p.K * ((p.Sk + kRows - 1) / kRows);
  const int64_t qblocks =
      static_cast<int64_t>(p.B) * p.H * ((p.Sq + kRows - 1) / kRows);
  if ((rows + 7) / 8 > 0x7fffffff || (kv_rows + 7) / 8 > 0x7fffffff ||
      kblocks > 0x7fffffff || qblocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_tc256_delta_kernel<kHD>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  auto dkdv = flash_bwd_tc256_dkdv_kernel<SPLIT>;
  static bool raised_dkdv[kMaxDevices];
  if (const int err = allow_shared(dkdv, DkdvLayout::kBytes, raised_dkdv)) {
    return err;
  }
  dkdv<<<static_cast<unsigned>(kblocks), kThreads, DkdvLayout::kBytes,
         stream>>>(p);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  if (p.groups > 1) {
    flash_bwd_tc256_merge_kernel<kHD>
        <<<static_cast<unsigned>((kv_rows + 7) / 8), 256, 0, stream>>>(p);
    if (const cudaError_t err = cudaGetLastError()) {
      return static_cast<int>(err);
    }
  }

  auto dqk = flash_bwd_tc256_dq_kernel<SPLIT>;
  static bool raised_dq[kMaxDevices];
  if (const int err = allow_shared(dqk, DqLayout::kBytes, raised_dq)) {
    return err;
  }
  dqk<<<static_cast<unsigned>(qblocks), kThreads, DqLayout::kBytes,
        stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's one argument block (`TC256_BWD_ARGS` in kernel.py),
// 8-byte fields.
struct Tc256BwdArgs {
  uint64_t ptr[11];  // q, k, v, o, lse, do, dq, dk, dv, delta, part
  int64_t B, H, K, Sq, Sk, hd, causal, window, groups, parts;   // hd: width
  uint64_t stream;
  double scale;      // rounded to float32 here
  int64_t st[8][3];  // batch, sequence and head strides, in elements, of
                     // q, k, v, o, do, dq, dk, dv
};
static_assert(sizeof(Tc256BwdArgs) == 47 * 8, "the wrapper's TC256_BWD_ARGS");

}  // namespace

// C interface, loaded with ctypes; takes one `Tc256BwdArgs` block. q, o,
// do, dq: (B, Sq, H, 256) and k, v, dk, dv: (B, Sk, K, 256) bf16, each
// through its batch, sequence and head strides (rows on 16 bytes, unit
// stride along hd); lse: (B, H, Sq) float32, contiguous; delta: a (B, H,
// Sq) float32 workspace; with groups > 1 (at most H / K), part: a (2,
// groups, B, K, Sk, 256) float32 workspace. `scale` is the true head dim's
// hd^-0.5 (the wrapper zero-pads hd). `parts` is the number of bf16 parts
// P and dS are rounded to as operands: 1, or 2 (high and low). Launches
// three kernels on `stream` (four with groups > 1) without synchronising;
// returns the first CUDA error (0 on success).
extern "C" int flash_bwd_tc256_launch(const void* packed) {
  Tc256BwdArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  if (a.hd != kHD || a.K <= 0 || a.H % a.K || a.groups < 1 ||
      a.groups > a.H / a.K || (a.groups > 1 && a.ptr[10] == 0) ||
      (a.parts != 1 && a.parts != 2) || a.B > 0x7fffffff ||
      a.H > 0x7fffffff || a.Sq > 0x7fffffff || a.Sk > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint64_t align = a.ptr[0] | a.ptr[1] | a.ptr[2] | a.ptr[3] | a.ptr[5] |
                   a.ptr[6] | a.ptr[7] | a.ptr[8] | a.ptr[10];
  for (int t = 0; t < 8; ++t) {
    for (int d = 0; d < 3; ++d) align |= static_cast<uint64_t>(a.st[t][d]) * 2;
  }
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  Params p;
  p.q = reinterpret_cast<const bf16*>(a.ptr[0]);
  p.k = reinterpret_cast<const bf16*>(a.ptr[1]);
  p.v = reinterpret_cast<const bf16*>(a.ptr[2]);
  p.o = reinterpret_cast<const bf16*>(a.ptr[3]);
  p.lse = reinterpret_cast<const float*>(a.ptr[4]);
  p.dout = reinterpret_cast<const bf16*>(a.ptr[5]);
  p.dq = reinterpret_cast<bf16*>(a.ptr[6]);
  p.dk = reinterpret_cast<bf16*>(a.ptr[7]);
  p.dv = reinterpret_cast<bf16*>(a.ptr[8]);
  p.delta = reinterpret_cast<float*>(a.ptr[9]);
  p.part = reinterpret_cast<float*>(a.ptr[10]);
  p.B = static_cast<int>(a.B);
  p.H = static_cast<int>(a.H);
  p.K = static_cast<int>(a.K);
  p.Sq = static_cast<int>(a.Sq);
  p.Sk = static_cast<int>(a.Sk);
  p.causal = static_cast<int>(a.causal);
  p.window = static_cast<int>(a.window);
  p.groups = static_cast<int>(a.groups);
  p.parts = static_cast<int>(a.parts);
  p.scale = static_cast<float>(a.scale);
  int64_t* dst[8] = {p.sq, p.sk, p.sv, p.so, p.sdo, p.sdq, p.sdk, p.sdv};
  for (int t = 0; t < 8; ++t) {
    for (int d = 0; d < 3; ++d) dst[t][d] = a.st[t][d];
  }
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a.stream);
  return p.parts == 2 ? launch<true>(p, stream) : launch<false>(p, stream);
}
