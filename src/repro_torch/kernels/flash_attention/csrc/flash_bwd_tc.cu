// Flash attention backward with GQA on Hopper's tensor cores, bfloat16:
// the gradients of
//
//     o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kv, j] * scale)
//                  * v[b, kv, j],         kv = h / (H / K),
//
// for a cotangent do, from the forward's o and log-sum-exp (either forward
// route writes them alike). FlashAttention-2's backward:
//     delta_i = sum_d do_i * o_i,          p_ij = exp(s_ij * scale - lse_i),
//     dv_j = sum_i p_ij do_i,              ds_ij = p_ij (do_i . v_j - delta_i),
//     dk_j = sum_i ds_ij q_i * scale,      dq_i = sum_j ds_ij k_j * scale,
// over the visible pairs (top-left causal, optional window i - j < window);
// ref.py::attention_bwd_ref states the function.
//
// Replaces, for bfloat16 inputs at (padded) head dims 64 and 128, the
// gradient of the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:91, which has no backward of
// its own (off the TPU the reference differentiates its jnp oracle).
// flash_attention.cu's backward (CUDA cores, float32) takes every other
// case and computes the same function.
//
// Bound: operations. A visible (query, key) pair costs 10*hd operations
// in the five products of the backward (2.5x the forward's 4*hd); at
// qwen3-8b's head layout (B 1, H 32, K 8, S 2048, hd 128, causal) that is
// 86 GFLOP, 0.087 ms at the H100 SXM's dense bf16 rate of 989 TFLOP/s,
// against 0.025 ms to move q, k, v, o, do, lse, dq, dk and dv once. This
// design does 7 products a pair (dk/dv and dq both recompute S and dP),
// 9 with P and dS each split in two parts.
//
// Design: three kernels on the stream, no atomics (the sums over query
// tiles, the G heads of a kv head and key tiles run in a fixed order, so
// two calls give the same bits).
//  - delta: delta_i = sum do * o, bf16 read in 16-byte loads, float32 sums
//    (HD / 8 lanes a row). A pre-pass: dk/dv needs delta of every query.
//  - dk/dv: a block is 4 warps and owns 64 keys (16 a warp) of one
//    (b, kv head), K and V resident in shared memory. It walks the query
//    tiles of its G heads in a fixed order (head g, then tile), from the
//    first query that sees its keys. Per tile, a warp computes
//      S^T = K Q^T and dP^T = V dO^T (K, V rows as A operands through
//        ldmatrix; Q, dO rows as B operands through ldmatrix, as K is in
//        the forward),
//      P^T = exp2(S^T scale log2(e) - lse log2(e)) and
//        dS^T = P^T (dP^T - delta), per column (query), with the tile's lse
//        and delta staged in shared memory,
//      dV += P^T dO and dK += dS^T Q (the m16n8 accumulators packed to bf16
//        are the A operands, as P is in the forward; dO and Q are B
//        operands through ldmatrix.trans, as V is in the forward),
//    and writes dK scale and dV once at the end. K's and V's fragments are
//    read again from shared memory each tile: a thread's dK and dV sums
//    alone are 2 * hd / 2 float32 registers (128 at hd 128), and holding
//    the fragments would add hd / 2. At hd 128 a query tile is 32 queries
//    (S^T and dP^T 16 registers each), at hd 64 it is 64.
//  - dq: a block owns 64 query rows (16 a warp) of one (b, h), Q and dO
//    resident; it walks the key tiles (64 keys) its rows see. Per tile:
//    S = Q K^T and dP = dO V^T (Q, dO as A fragments read from shared
//    memory each tile; K, V through ldmatrix), dS = P (dP - delta) per
//    row, dQ += dS K (K through ldmatrix.trans). Writes dQ scale once.
//  - Q, dO (dk/dv) and K, V (dq) tiles stream through shared memory with
//    cp.async, two stages; rows are padded by 16 bytes (tc_tiles.cuh).
//    Rows past Sq or Sk are zero-filled and not stored.
//  - Masks: only a tile that straddles a boundary (causal diagonal, window
//    edge, Sq or Sk) gets the element mask, which sets p = dS = 0 by
//    selection: a query row that sees no key has lse = -inf, and its
//    exp2(s - lse) is inf, so nothing is multiplied by the mask.
//  - Rounding: P and dS are rounded to bf16 as the operands of dV, dK and
//    dQ, which the plain float32 backward does not do. With SPLIT each is
//    the sum of a high and a low bf16 part (two products, p to 2^-17);
//    without, one part (p to 2^-9). The wrapper picks one; PERF.md has the
//    errors and times of both.

#include <math.h>

#include "tc_tiles.cuh"

namespace {

using namespace tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // keys of a dk/dv block, queries of dq
constexpr int kBK = 64;             // keys of a dq kv tile
constexpr float kLog2e = 1.4426950408889634f;

struct Dims {
  int B, H, K, Sq, Sk;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool visible(const Dims& s, int i, int j) {
  return i < s.Sq && j < s.Sk && (!s.causal || j <= i) &&
         (s.window <= 0 || i - j < s.window);
}

// ------------------------------------------------------------------ delta

template <int HD>
__global__ void flash_bwd_tc_delta_kernel(const bf16* __restrict__ o,
                                          const bf16* __restrict__ dout,
                                          float* __restrict__ delta,
                                          int64_t rows) {
  constexpr int kLanes = HD / 8;   // lanes a row, 8 elements each
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kLanes) +
                    threadIdx.x / kLanes;
  const int part = threadIdx.x % kLanes;
  if (r >= rows) return;   // a row's lanes leave together
  const uint4 a = *reinterpret_cast<const uint4*>(o + r * HD + part * 8);
  const uint4 b = *reinterpret_cast<const uint4*>(dout + r * HD + part * 8);
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 fa = __bfloat1622float2(pa[t]);
    const float2 fb = __bfloat1622float2(pb[t]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  const unsigned mask = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(mask, acc, off);
  }
  if (part == 0) delta[r] = acc;
}

// ------------------------------------------------------------------ dk, dv

template <int HD>
struct DkdvLayout {
  static constexpr int kBQ = HD == 128 ? 32 : 64;   // queries a tile
  static constexpr int kLd = stride<HD>();
  static constexpr int kKV = kRows * kLd;   // elements of the K or V tile
  static constexpr int kQ = kBQ * kLd;      // elements of a Q or dO stage
  // K, V, two stages of Q and of dO; two stages of lse and of delta
  static constexpr size_t kBytes =
      (2 * kKV + 4 * kQ) * sizeof(bf16) + 4 * kBQ * sizeof(float);
};

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

// acc (16 x HD a warp) += A (16 x 16, k-step kk of the score tile t) times
// rows [16 kk, 16 kk + 16) of the shared tile b (k-major, row stride ld).
template <int HD, bool SPLIT>
__device__ __forceinline__ void score_times(float (*acc)[4],
                                            const float (*t)[4], int kk,
                                            const bf16* b, int ld) {
  uint32_t hi[4], lo[4];
  score_a<SPLIT>(t, kk, hi, lo);
#pragma unroll
  for (int nn = 0; nn < HD / 16; ++nn) {   // 16 dims: two n-blocks
    uint32_t bf[4];
    load_b_trans(bf, b, ld, nn * 16, kk * 16);
    mma_bf16(acc[2 * nn], hi, bf[0], bf[1]);
    mma_bf16(acc[2 * nn + 1], hi, bf[2], bf[3]);
    if (SPLIT) {
      mma_bf16(acc[2 * nn], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * nn + 1], lo, bf[2], bf[3]);
    }
  }
}

template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_tc_dkdv_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Dims s) {
  using L = DkdvLayout<HD>;
  constexpr int kBQ = L::kBQ, kLd = L::kLd;
  constexpr int kNQ = kBQ / 8;     // n-blocks of queries in S^T
  constexpr int kOut = HD / 8;     // n-blocks of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::kKV;
  bf16* qs = vs + L::kKV;          // two stages
  bf16* dos = qs + 2 * L::kQ;      // two stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * L::kQ);   // two stages
  float* delta_s = lse_s + 2 * kBQ;                            // two stages

  // block -> (b, kv head, key tile): kv head fastest, then b, then the key
  // tile, first tiles (under causal masking the most queries) first
  int idx = blockIdx.x;
  const int kvh = idx % s.K;
  idx /= s.K;
  const int b = idx % s.B;
  idx /= s.B;
  const int k0 = idx * kRows;
  const int G = s.H / s.K;
  const int64_t bkv = static_cast<int64_t>(b) * s.K + kvh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_lane = lane & 3;

  // queries that see some key of the block, in tiles of kBQ from the first
  const int k_last = min(s.Sk - 1, k0 + kRows - 1);
  const int blo = s.causal ? k0 : 0;
  const int bhi = s.window > 0 ? min(s.Sq - 1, k_last + s.window - 1)
                               : s.Sq - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBQ + 1 : 0;
  const int total = G * ntiles;    // (head, tile) steps

  auto load_step = [&](int step, int st) {
    const int q0 = blo + (step % ntiles) * kBQ;
    const int64_t bh = static_cast<int64_t>(b) * s.H +
                       static_cast<int64_t>(kvh) * G + step / ntiles;
    load_tile<HD, kBQ, kThreads>(qs + st * L::kQ, q + bh * s.Sq * HD, q0,
                                 s.Sq);
    load_tile<HD, kBQ, kThreads>(dos + st * L::kQ, dout + bh * s.Sq * HD,
                                 q0, s.Sq);
    if (threadIdx.x < kBQ) {
      const int i = q0 + threadIdx.x;
      const bool in = i < s.Sq;
      const int64_t e = bh * s.Sq + (in ? i : 0);
      cp_async4(lse_s + st * kBQ + threadIdx.x, lse + e, in ? 4 : 0);
      cp_async4(delta_s + st * kBQ + threadIdx.x, delta + e, in ? 4 : 0);
    }
  };

  load_tile<HD, kRows, kThreads>(ks, k + bkv * s.Sk * HD, k0, s.Sk);
  load_tile<HD, kRows, kThreads>(vs, v + bkv * s.Sk * HD, k0, s.Sk);
  if (total > 0) load_step(0, 0);
  cp_async_commit();

  float dkacc[kOut][4], dvacc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[n][e] = dvacc[n][e] = 0.f;
  }
  const float sl2 = s.scale * kLog2e;

  for (int step = 0; step < total; ++step) {
    const int st = step & 1;
    if (step + 1 < total) load_step(step + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();     // this step's tiles (and K, V) have landed
    __syncthreads();
    const int q0 = blo + (step % ntiles) * kBQ;
    const bf16* qt = qs + st * L::kQ;
    const bf16* dt = dos + st * L::kQ;
    const float* lt = lse_s + st * kBQ;
    const float* delt = delta_s + st * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kBQ queries a warp
    float sc[kNQ][4], dp[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, kLd, warp * 16, kk * 16);
      load_a(va, vs, kLd, warp * 16, kk * 16);
#pragma unroll
      for (int jj = 0; jj < kBQ / 16; ++jj) {   // 16 queries: two n-blocks
        uint32_t bf[4];
        load_b(bf, qt, kLd, jj * 16, kk * 16);
        mma_bf16(sc[2 * jj], ka, bf[0], bf[1]);
        mma_bf16(sc[2 * jj + 1], ka, bf[2], bf[3]);
        load_b(bf, dt, kLd, jj * 16, kk * 16);
        mma_bf16(dp[2 * jj], va, bf[0], bf[1]);
        mma_bf16(dp[2 * jj + 1], va, bf[2], bf[3]);
      }
    }
    // P^T into sc and dS^T into dp, per column; the element mask only
    // where the tile straddles a boundary
    const int q_last = q0 + kBQ - 1;
    const bool full = q_last < s.Sq && k0 + kRows - 1 < s.Sk &&
                      (!s.causal || q0 >= k0 + kRows - 1) &&
                      (s.window <= 0 || q_last - k0 < s.window);
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * quad_lane + (e & 1);
        const float p = exp2f(sc[j][e] * sl2 - lt[c] * kLog2e);
        const float ds = p * (dp[j][e] - delt[c]);
        const int key = k0 + warp * 16 + quad_row + 8 * (e >> 1);
        const bool keep = full || visible(s, q0 + c, key);
        sc[j][e] = keep ? p : 0.f;
        dp[j][e] = keep ? ds : 0.f;
      }
    }
    // dV += P^T dO and dK += dS^T Q, a k-step of 16 queries at a time
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      score_times<HD, SPLIT>(dvacc, sc, kk, dt, kLd);
      score_times<HD, SPLIT>(dkacc, dp, kk, qt, kLd);
    }
    __syncthreads();   // every warp is done with this stage before refill
  }
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + quad_row + 8 * r;
    if (key >= s.Sk) continue;
    const int64_t row = (bkv * s.Sk + key) * HD + 2 * quad_lane;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<uint32_t*>(dk + row + n * 8) = pack_bf16(
          dkacc[n][2 * r] * s.scale, dkacc[n][2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dv + row + n * 8) =
          pack_bf16(dvacc[n][2 * r], dvacc[n][2 * r + 1]);
    }
  }
}

// --------------------------------------------------------------------- dq

template <int HD>
struct DqLayout {
  static constexpr int kLd = stride<HD>();
  static constexpr int kQ = kRows * kLd;    // elements of the Q or dO tile
  static constexpr int kTile = kBK * kLd;   // elements of a K or V stage
  // Q, dO, two stages of K and of V
  static constexpr size_t kBytes = (2 * kQ + 4 * kTile) * sizeof(bf16);
};

template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_tc_dq_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, Dims s) {
  using L = DqLayout<HD>;
  constexpr int kLd = L::kLd;
  constexpr int kOut = HD / 8;     // n-blocks of dQ
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::kQ;
  bf16* ks = dos + L::kQ;          // two stages
  bf16* vs = ks + 2 * L::kTile;    // two stages

  // block -> (query tile, b, h), as in the forward: h fastest, then b, then
  // the query tile, longest tiles first under causal masking
  const int tiles = (s.Sq + kRows - 1) / kRows;
  int idx = blockIdx.x;
  const int h = idx % s.H;
  idx /= s.H;
  const int b = idx % s.B;
  idx /= s.B;
  const int q0 = (s.causal ? tiles - 1 - idx : idx) * kRows;
  const int kvh = h / (s.H / s.K);
  const int64_t bh = static_cast<int64_t>(b) * s.H + h;
  const int64_t bkv = static_cast<int64_t>(b) * s.K + kvh;
  const bf16* kb = k + bkv * s.Sk * HD;
  const bf16* vb = v + bkv * s.Sk * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_lane = lane & 3;
  const float sl2 = s.scale * kLog2e;

  // this lane's two rows: keys [lo, hi] they see, lse log2(e) and delta
  int lo[2], hi[2];
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + quad_row + 8 * r;
    lo[r] = s.window > 0 ? max(0, i - s.window + 1) : 0;
    hi[r] = s.causal ? min(s.Sk - 1, i) : s.Sk - 1;
    l2[r] = i < s.Sq ? lse[bh * s.Sq + i] * kLog2e : 0.f;
    dl[r] = i < s.Sq ? delta[bh * s.Sq + i] : 0.f;
  }
  // keys some row of the block sees, and keys every row of it sees
  const int q_last = min(s.Sq - 1, q0 + kRows - 1);
  const int blo = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int bhi = s.causal ? min(s.Sk - 1, q_last) : s.Sk - 1;
  const int all_lo = s.window > 0 ? max(0, q_last - s.window + 1) : 0;
  const int all_hi = s.causal ? min(s.Sk - 1, q0) : s.Sk - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBK + 1 : 0;

  load_tile<HD, kRows, kThreads>(qs, q + bh * s.Sq * HD, q0, s.Sq);
  load_tile<HD, kRows, kThreads>(dos, dout + bh * s.Sq * HD, q0, s.Sq);
  if (ntiles > 0) {
    load_tile<HD, kBK, kThreads>(ks, kb, blo, s.Sk);
    load_tile<HD, kBK, kThreads>(vs, vb, blo, s.Sk);
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
    if (t + 1 < ntiles) {   // prefetch the next tile into the other stage
      load_tile<HD, kBK, kThreads>(ks + (st ^ 1) * L::kTile, kb, k0 + kBK,
                                   s.Sk);
      load_tile<HD, kBK, kThreads>(vs + (st ^ 1) * L::kTile, vb, k0 + kBK,
                                   s.Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();     // this tile (and Q, dO) have landed
    __syncthreads();
    const bf16* kt = ks + st * L::kTile;
    const bf16* vt = vs + st * L::kTile;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, kLd, warp * 16, kk * 16);
      load_a(da, dos, kLd, warp * 16, kk * 16);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {   // 16 keys: two n-blocks
        uint32_t bf[4];
        load_b(bf, kt, kLd, jj * 16, kk * 16);
        mma_bf16(sc[2 * jj], qa, bf[0], bf[1]);
        mma_bf16(sc[2 * jj + 1], qa, bf[2], bf[3]);
        load_b(bf, vt, kLd, jj * 16, kk * 16);
        mma_bf16(dp[2 * jj], da, bf[0], bf[1]);
        mma_bf16(dp[2 * jj + 1], da, bf[2], bf[3]);
      }
    }
    // dS = P (dP - delta) into dp, per row; the element mask only where the
    // tile straddles a boundary
    const bool full = k0 >= all_lo && k0 + kBK - 1 <= all_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + 2 * quad_lane + (e & 1);
        const float p = exp2f(sc[j][e] * sl2 - l2[r]);
        const float ds = p * (dp[j][e] - dl[r]);
        dp[j][e] = full || (key >= lo[r] && key <= hi[r]) ? ds : 0.f;
      }
    }
    // dQ += dS K, a k-step of 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      score_times<HD, SPLIT>(acc, dp, kk, kt, kLd);
    }
    __syncthreads();   // every warp is done with this stage before refill
  }
  cp_async_wait<0>();  // nothing in flight at exit

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + quad_row + 8 * r;
    if (i >= s.Sq) continue;
    bf16* row = dq + (bh * s.Sq + i) * HD + 2 * quad_lane;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(acc[n][2 * r] * s.scale, acc[n][2 * r + 1] * s.scale);
    }
  }
}

// ----------------------------------------------------------------- launch

template <int HD, bool SPLIT>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const float* lse, const bf16* dout, bf16* dq, bf16* dk, bf16* dv,
           float* delta, const Dims& s, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(s.B) * s.H * s.Sq;
  constexpr int kPerBlock = 256 / (HD / 8);   // rows of a delta block
  flash_bwd_tc_delta_kernel<HD>
      <<<static_cast<unsigned>((rows + kPerBlock - 1) / kPerBlock), 256, 0,
         stream>>>(o, dout, delta, rows);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  auto dkdv = flash_bwd_tc_dkdv_kernel<HD, SPLIT>;
  static bool raised_dkdv[kMaxDevices];
  if (const int err =
          allow_shared(dkdv, DkdvLayout<HD>::kBytes, raised_dkdv)) {
    return err;
  }
  const int64_t kblocks =
      static_cast<int64_t>(s.B) * s.K * ((s.Sk + kRows - 1) / kRows);
  dkdv<<<static_cast<unsigned>(kblocks), kThreads, DkdvLayout<HD>::kBytes,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, s);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  auto dqk = flash_bwd_tc_dq_kernel<HD, SPLIT>;
  static bool raised_dq[kMaxDevices];
  if (const int err = allow_shared(dqk, DqLayout<HD>::kBytes, raised_dq)) {
    return err;
  }
  const int64_t qblocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + kRows - 1) / kRows);
  dqk<<<static_cast<unsigned>(qblocks), kThreads, DqLayout<HD>::kBytes,
        stream>>>(q, k, v, dout, lse, delta, dq, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes; flash_attention.cu's flash_bwd_launch
// with one more argument, last. q, o, dout, dq: (B, H, Sq, hd); k, v, dk, dv:
// (B, K, Sk, hd), row-major bfloat16 (is_bf16 must be 1), q, k, v, o and
// dout 16-byte aligned; lse, delta (a workspace): (B, H, Sq) float32.
// `scale` is the scores' scale (the true head dim's hd^-0.5: the wrapper
// zero-pads hd). hd must be 64 or 128, H a multiple of K. `parts` is the
// number of bf16 parts P and dS are rounded to as operands: 1, or 2 (high
// and low). Launches three kernels on `stream` without synchronising;
// returns the first CUDA error (0 on success).
extern "C" int flash_bwd_tc_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int H, int K, int Sq, int Sk,
                                   int hd, int causal, int window,
                                   float scale, int is_bf16, void* stream,
                                   int parts) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  if (!is_bf16 || K <= 0 || H % K || (parts != 1 && parts != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows are read 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout)) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Dims s;
  s.B = B;
  s.H = H;
  s.K = K;
  s.Sq = Sq;
  s.Sk = Sk;
  s.causal = causal;
  s.window = window;
  s.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* db = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  float* d = static_cast<float*>(delta);
  const bool split = parts == 2;
  switch (hd) {
    case 64:
      return split ? launch<64, true>(qb, kb, vb, ob, l, db, dqb, dkb, dvb, d,
                                      s, st)
                   : launch<64, false>(qb, kb, vb, ob, l, db, dqb, dkb, dvb,
                                       d, s, st);
    case 128:
      return split ? launch<128, true>(qb, kb, vb, ob, l, db, dqb, dkb, dvb,
                                       d, s, st)
                   : launch<128, false>(qb, kb, vb, ob, l, db, dqb, dkb, dvb,
                                        d, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
