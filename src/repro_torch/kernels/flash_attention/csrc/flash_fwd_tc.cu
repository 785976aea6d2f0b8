// Flash attention forward with GQA on Hopper's tensor cores, bfloat16:
//
//     o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kv, j] * scale)
//                  * v[b, kv, j]
//
// over the keys j that query i may attend to, with kv = h / (H / K), and
// lse[b, h, i] = log sum_j exp(q . k * scale) in float32 for the backward.
//
// Replaces, for bfloat16 inputs at (padded) head dims 64 and 128, the
// Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:91 (body `_flash_kernel`
// at :30). Same function as flash_attention.cu's forward, which takes every
// other case: causal masking top-left on absolute positions (key j <= query
// i, so Sq != Sk is allowed), an optional sliding window (i - j < window),
// online softmax in float32, kv tiles that no query of the block sees
// skipped; a query row that sees no key gets o = 0 and lse = -inf (as the
// TPU kernel, where its kv blocks are all skipped; ROADMAP C3). Its o and
// lse feed either backward (flash_bwd_tc.cu, flash_attention.cu) unchanged.
// The tile helpers (cp.async, ldmatrix, mma.sync) are in tc_tiles.cuh.
//
// Bound: operations. A visible (query, key) pair costs 4*hd operations
// (q.k and p*v); at qwen3-8b's head layout (B 1, H 32, K 8, S 2048, hd 128,
// causal) that is 34.4 GFLOP, 0.0348 ms at the H100 SXM's dense bf16 rate
// of 989 TFLOP/s, against 0.0126 ms to move q, k, v, o and lse once.
//
// Design: FlashAttention-2 on warp-level tensor-core instructions.
//  - A block is 4 warps and owns 64 query rows (16 a warp) of one (b, h);
//    the grid is B * H * ceil(Sq / 64) blocks, numbered so that the heads
//    sharing a kv head are neighbours (their K and V tiles meet in L2) and,
//    under causal masking, the longest query tiles start first.
//  - Q is copied once with cp.async into shared memory and read with
//    ldmatrix into A fragments that stay in registers for the whole kv
//    loop (hd/16 fragments of 4 registers a thread).
//  - K and V go through shared memory in tiles of 64 keys x hd with
//    cp.async, two stages: the next tile's copies are in flight while the
//    current tile's two products run. Rows are padded by 16 bytes, so the
//    8 rows an ldmatrix reads fall on distinct banks. Keys past Sk are
//    zero-filled (a cp.async of source size 0) and scored -inf; query rows
//    past Sq are zero-filled and not stored.
//  - S = Q K^T with mma.sync.m16n8k16 (bf16 inputs, float32 sums): the
//    products of bf16 values are exact in float32, so S differs from a
//    float32 product of the same inputs only in the order of its sums.
//  - The online softmax runs on the accumulator fragments in float32: a
//    row's 64 scores of a tile sit in the 4 lanes of a quad, its max is a
//    quad shuffle, exponentials are exp2f with scale * log2(e) folded in.
//    The row sum l is kept per lane from the unrounded p and summed over
//    the quad once, at the end.
//  - O += P V: P goes to the tensor cores as bf16 A operands built in
//    registers (an m16n8 accumulator's layout is the m16n8k16 A layout);
//    V's B fragments come from ldmatrix.trans. Rounding P to one bf16 is
//    the one rounding the plain float32 version does not make: each weight
//    p in (0, 1] would move by up to 2^-9 of itself, and o by up to
//    2^-9 * max |v|. On its own that kept o within the 1e-2 bf16
//    tolerance, but it flipped o's final rounding often enough that the
//    backward, which reads o (delta = sum do * o) and sums over the G
//    heads of a kv head, left that tolerance against the plain backward
//    fed the plain forward's o (0.0117 at GQA 4/2, hd 64, S 128, causal,
//    on an H100). So P is split into a high and a low bf16 part,
//    p = hi + lo to 2^-17 of p, and P V is two products: the P V half of
//    the work doubles (PERF.md has the time of both versions).
//  - Masks: only a tile that straddles a boundary (causal diagonal, window
//    edge, or Sk) gets the element mask; the others are scored as they are.
//
// What a later step adds: wgmma (a warpgroup's 64-row product from shared
// memory, asynchronous, the only path to the full tensor-core rate) fed by
// TMA copies tracked by mbarriers, with a producer warp and consumer
// warpgroups, so that the softmax of one tile overlaps the products of the
// next (FlashAttention-3's design).

#include <math.h>

#include "tc_tiles.cuh"

namespace {

using namespace tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows a block
constexpr int kBK = 64;           // keys a kv tile

struct Dims {
  int B, H, K, Sq, Sk;
  int causal, window;
  float scale;
};

template <int HD>
struct Layout {
  static constexpr int kStride = stride<HD>();   // elements a shared row
  static constexpr int kQ = kBQ * kStride;       // elements of the Q tile
  static constexpr int kTile = kBK * kStride;    // elements of a K or V tile
  // Q, two K stages, two V stages
  static constexpr size_t kBytes = (kQ + 4 * kTile) * sizeof(bf16);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, Dims s) {
  using L = Layout<HD>;
  constexpr int kSteps = HD / 16;   // k-steps of Q K^T
  constexpr int kOut = HD / 8;      // n-blocks of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + L::kQ;            // two stages
  bf16* vs = ks + 2 * L::kTile;     // two stages

  // block -> (query tile, b, h): h fastest, then b, then the query tile,
  // longest tiles first under causal masking
  const int tiles = (s.Sq + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int h = idx % s.H;
  idx /= s.H;
  const int b = idx % s.B;
  idx /= s.B;
  const int q0 = (s.causal ? tiles - 1 - idx : idx) * kBQ;
  const int kvh = h / (s.H / s.K);
  const int64_t bh = static_cast<int64_t>(b) * s.H + h;
  const int64_t bkv = static_cast<int64_t>(b) * s.K + kvh;
  const bf16* qb = q + bh * s.Sq * HD;
  const bf16* kb = k + bkv * s.Sk * HD;
  const bf16* vb = v + bkv * s.Sk * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_lane = lane & 3;

  // keys [lo, hi] of this lane's two rows (empty when lo > hi)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + quad_row + 8 * r;
    lo[r] = s.window > 0 ? max(0, i - s.window + 1) : 0;
    hi[r] = s.causal ? min(s.Sk - 1, i) : s.Sk - 1;
  }
  // keys some row of the block sees, and keys every row of it sees
  const int q_last = min(s.Sq - 1, q0 + kBQ - 1);
  const int blo = s.window > 0 ? max(0, q0 - s.window + 1) : 0;
  const int bhi = s.causal ? min(s.Sk - 1, q_last) : s.Sk - 1;
  const int all_lo = s.window > 0 ? max(0, q_last - s.window + 1) : 0;
  const int all_hi = s.causal ? min(s.Sk - 1, q0) : s.Sk - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBK + 1 : 0;

  load_tile<HD, kBQ, kThreads>(qs, qb, q0, s.Sq);
  if (ntiles > 0) {
    load_tile<HD, kBK, kThreads>(ks, kb, blo, s.Sk);
    load_tile<HD, kBK, kThreads>(vs, vb, blo, s.Sk);
  }
  cp_async_commit();

  uint32_t qf[kSteps][4];
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};               // this lane's part of the row sum
  const float sl2 = s.scale * 1.4426950408889634f;   // scale * log2(e)

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
    cp_async_wait<1>();     // this tile (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        load_a(qf[kk], qs, L::kStride, warp * 16, kk * 16);
      }
    }
    const bf16* kt = ks + st * L::kTile;
    const bf16* vt = vs + st * L::kTile;

    // S = Q K^T: 8 n-blocks of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {   // 16 keys: two n-blocks
        uint32_t bf[4];
        load_b(bf, kt, L::kStride, jj * 16, kk * 16);
        mma_bf16(sc[2 * jj], qf[kk], bf[0], bf[1]);
        mma_bf16(sc[2 * jj + 1], qf[kk], bf[2], bf[3]);
      }
    }
    // element mask, only where the tile straddles a boundary
    if (!(k0 >= all_lo && k0 + kBK - 1 <= all_hi)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + quad_lane * 2 + (e & 1);
          const int r = e >> 1;
          if (key < lo[r] || key > hi[r]) sc[j][e] = -INFINITY;
        }
      }
    }
    // online softmax: the rows' new max, and the rescale of what is summed
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet keeps p = 0 and no NaN
      base[r] = mx == -INFINITY ? 0.f : mx * sl2;
      const float alpha = exp2f(m[r] * sl2 - base[r]);  // 0 on the first tile
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    // O += P V, a k-step of 16 keys at a time: P as the A fragments of its
    // high and low bf16 parts
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A register e: n-block 2 kk + e / 2, row r = e % 2
        const int j = 2 * kk + (e >> 1), r = e & 1;
        const float p0 = exp2f(sc[j][2 * r] * sl2 - base[r]);
        const float p1 = exp2f(sc[j][2 * r + 1] * sl2 - base[r]);
        l[r] += p0 + p1;
        split_bf16(p0, p1, ph[e], pl[e]);
      }
#pragma unroll
      for (int nn = 0; nn < kOut / 2; ++nn) {   // 16 dims: two n-blocks
        uint32_t bf[4];
        load_b_trans(bf, vt, L::kStride, nn * 16, kk * 16);
        mma_bf16(acc[2 * nn], ph, bf[0], bf[1]);
        mma_bf16(acc[2 * nn], pl, bf[0], bf[1]);
        mma_bf16(acc[2 * nn + 1], ph, bf[2], bf[3]);
        mma_bf16(acc[2 * nn + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }
  cp_async_wait<0>();  // nothing in flight at exit (no tiles: Q's copies)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int i = q0 + warp * 16 + quad_row + 8 * r;
    if (i >= s.Sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* orow = o + (bh * s.Sq + i) * HD + quad_lane * 2;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (quad_lane == 0) {
      lse[bh * s.Sq + i] = sum > 0.f ? m[r] * s.scale + logf(sum) : -INFINITY;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Dims& s, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<HD>;
  constexpr size_t smem = Layout<HD>::kBytes;
  static bool raised[kMaxDevices];
  if (const int err = allow_shared(kernel, smem, raised)) return err;
  const int64_t blocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + kBQ - 1) / kBQ);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes; the same as flash_attention.cu's
// flash_fwd_launch. q, o: (B, H, Sq, hd); k, v: (B, K, Sk, hd), row-major
// bfloat16 (is_bf16 must be 1), 16-byte aligned; lse: (B, H, Sq) float32.
// `scale` is the scores' scale (the true head dim's hd^-0.5: the wrapper
// zero-pads hd). hd must be 64 or 128, H a multiple of K. Launches on
// `stream` without synchronising; returns the CUDA error (0 on success).
extern "C" int flash_fwd_tc_launch(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int K, int Sq, int Sk, int hd,
                                   int causal, int window, float scale,
                                   int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (!is_bf16 || K <= 0 || H % K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // rows are copied 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16) {
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
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, l, s, st);
    case 128: return launch<128>(q, k, v, o, l, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
