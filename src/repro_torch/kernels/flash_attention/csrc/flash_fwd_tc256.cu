// Flash attention forward with GQA on Hopper's tensor cores, bfloat16 at
// (padded) head dim 256, optionally split over keys (FlashDecoding), and
// the combine of the splits' partial results:
//
//     o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kv, j] * scale)
//                  * v[b, kv, j]
//
// over the keys j that query i may attend to, with kv = h / (H / K), and
// lse[b, h, i] = log sum_j exp(q . k * scale) in float32 for the backward.
//
// Replaces, for bfloat16 inputs at padded head dim 256 that do not take the
// short-sequence kernels, the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py:91 (body `_flash_kernel` at
// :30); those calls took flash_attention.cu's float32 CUDA-core forward
// before. Same function as flash_fwd_tc.cu: causal masking top-left on
// absolute positions (key j <= query i), an optional sliding window
// (i - j < window), online softmax in float32, kv tiles that no query of
// the block sees skipped; a query row that sees no key gets o = 0 and
// lse = -inf (ROADMAP C3). Its o and lse feed flash_attention.cu's
// backward unchanged.
//
// Bound. recurrentgemma-9b's local layers (B 1, H 16, K 1, S 4096, causal,
// window 2048): 4*hd operations a visible (query, key) pair, 103 GFLOP,
// 0.104 ms at the H100 SXM's dense bf16 rate of 989 TFLOP/s (operations).
// Its decode call (B 8, the 16 query heads of the kv head as 16 rows, 2048
// keys): 16.8 MB of k and v, 5.0 us at 3.35 TB/s (bytes). The combine:
// bytes (the float32 partial results read once).
//
// Design: flash_fwd_tc.cu's FlashAttention-2 on mma.sync.m16n8k16, resized
// for a row of 256 (its design at 256 would hold Q's 64 fragment registers
// and a 128-register O accumulator a thread, past the 255 a thread has):
//  - A warp owns 16 query rows and keeps their 16 x 256 float32 O
//    accumulator in registers (128 a thread); Q stays in shared memory and
//    each k-step of S = Q K^T reads its A fragment there with ldmatrix, so
//    no Q fragment lives across the kv loop.
//  - K and V go through shared memory in tiles of 32 keys x 256 (16.5 KB
//    each with rows padded by 16 bytes for ldmatrix), STAGES deep with
//    cp.async: 64 query rows (4 warps) and 2 stages make 99 KB, two
//    blocks an SM; 16 rows (1 warp) and 3 stages 107 KB.
//  - Rows are read through batch, sequence and head strides, so the
//    (B, S, H, hd) layout and a KV cache's prefix are read in place (a
//    head dim below 256, gemma3-12b's 240, is zero-padded by the wrapper:
//    masking it in the kernel spilled registers).
//  - 255 registers a thread: the tile loads do not unroll (their unrolled
//    addresses spilled the accumulator), and the unsplit o goes out
//    through the warp's own Q rows in shared memory, 16-byte stores.
//  - P goes to the tensor cores as a high and a low bf16 part (hi + lo is
//    p to 2^-17), as in flash_fwd_tc.cu: the CUDA-core backward reads this
//    o (delta = sum do * o), and one part moved o's rounding enough to take
//    that backward out of the bf16 tolerance at hd 64.
//  - Split over keys: each (b, h, query tile) unit's kv tiles, in order,
//    are cut into `splits` contiguous ranges, tiles [t * n / splits,
//    (t + 1) * n / splits) for split t of n tiles; a block is one (unit,
//    split). With one split the block writes o (bf16) and lse; with more
//    it writes its range's o normalised by its own sum (float32) and that
//    sum's lse to a workspace, and flash_combine_kernel merges a unit's
//    splits in a fixed order: lse = log sum_t exp(lse_t), o = sum_t
//    exp(lse_t - lse) o_t; a split with lse_t = -inf adds nothing, and a
//    row with no key in any split gets o = 0, lse = -inf. The decode calls
//    (16 rows a unit, 8 units at B 8) take 1-warp blocks and as many
//    splits as fill the card (the wrapper's `decode_splits`).
//
// What a later step adds: wgmma from shared memory with TMA copies and a
// producer warp (FlashAttention-3), the only path to the full rate.

#include <math.h>
#include <string.h>

#include "tc_tiles.cuh"

namespace {

using namespace tc;

constexpr int kHD = 256;                  // the (padded) head dim
constexpr int kBK = 32;                   // keys a kv tile
constexpr int kStride = stride<kHD>();    // elements a shared row
constexpr int kTile = kBK * kStride;      // elements of a K or V tile
constexpr int kDecodeRows = 16;           // query rows a unit at most that
                                          // take 1-warp blocks
constexpr int kMaxSplits = 256;           // splits the combine takes

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;       // (B, H, Sq)
  float* o_part;    // (splits, B, H, Sq, 256), splits > 1 only
  float* lse_part;  // (splits, B, H, Sq), splits > 1 only
  int B, H, K, Sq, Sk, causal, window, splits;
  float scale;
  int64_t sq[3], sk[3], sv[3], so[3];   // batch, sequence, head strides
};

template <int WARPS, int STAGES>
constexpr size_t shared_bytes() {
  return (16 * WARPS + 2 * STAGES * kBK) * kStride * sizeof(bf16);
}

template <int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS)
    flash_fwd_tc256_kernel(const Params p) {
  constexpr int kThreads = 32 * WARPS;
  constexpr int kBQ = 16 * WARPS;      // query rows a block
  constexpr int kN = kBK / 8;          // n-blocks of 8 keys in S
  constexpr int kOut = kHD / 8;        // n-blocks of 8 dims in O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * kStride;       // STAGES stages
  bf16* vs = ks + STAGES * kTile;      // STAGES stages

  // block -> (h, b, split, query tile): h fastest (the heads of a kv head
  // are neighbours, their K and V tiles meet in L2), the longest query
  // tiles first under causal masking
  const int qtiles = (p.Sq + kBQ - 1) / kBQ;
  int idx = blockIdx.x;
  const int h = idx % p.H;
  idx /= p.H;
  const int b = idx % p.B;
  idx /= p.B;
  const int split = idx % p.splits;
  idx /= p.splits;
  const int q0 = (p.causal ? qtiles - 1 - idx : idx) * kBQ;
  const int kvh = h / (p.H / p.K);
  const bf16* qb = p.q + b * p.sq[0] + h * p.sq[2];
  const bf16* kb = p.k + b * p.sk[0] + kvh * p.sk[2];
  const bf16* vb = p.v + b * p.sv[0] + kvh * p.sv[2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int quad_row = lane >> 2, quad_lane = lane & 3;

  // keys [lo, hi] of this lane's two rows (empty when lo > hi)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + warp * 16 + quad_row + 8 * r;
    lo[r] = p.window > 0 ? max(0, i - p.window + 1) : 0;
    hi[r] = p.causal ? min(p.Sk - 1, i) : p.Sk - 1;
  }
  // keys some row of the block sees, and keys every row of it sees
  const int q_last = min(p.Sq - 1, q0 + kBQ - 1);
  const int blo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int bhi = p.causal ? min(p.Sk - 1, q_last) : p.Sk - 1;
  const int all_lo = p.window > 0 ? max(0, q_last - p.window + 1) : 0;
  const int all_hi = p.causal ? min(p.Sk - 1, q0) : p.Sk - 1;
  const int ntiles = bhi >= blo ? (bhi - blo) / kBK + 1 : 0;
  // this split's tiles [t0, t0 + n) of the unit's ntiles
  const int t0 = static_cast<int>(static_cast<int64_t>(ntiles) * split /
                                  p.splits);
  const int n = static_cast<int>(static_cast<int64_t>(ntiles) *
                                 (split + 1) / p.splits) - t0;

  // prologue: Q and the first STAGES - 1 tiles, one commit group a tile
  load_rows<kHD, kBQ, kThreads>(qs, qb, p.sq[1], q0, p.Sq);
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) {
      const int k0 = blo + (t0 + s) * kBK;
      load_rows<kHD, kBK, kThreads>(ks + s * kTile, kb, p.sk[1], k0, p.Sk);
      load_rows<kHD, kBK, kThreads>(vs + s * kTile, vb, p.sv[1], k0, p.Sk);
    }
    cp_async_commit();
  }

  float acc[kOut][4];
#pragma unroll
  for (int d = 0; d < kOut; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};   // running max of raw scores
  float l[2] = {0.f, 0.f};               // this lane's part of the row sum
  const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)

  for (int t = 0; t < n; ++t) {
    cp_async_wait<STAGES - 2>();   // tile t (and Q) have landed
    __syncthreads();               // ... for every thread; tile t - 1 done
    {
      const int nt = t + STAGES - 1;   // refill the stage tile t - 1 used
      if (nt < n) {
        const int k0 = blo + (t0 + nt) * kBK;
        load_rows<kHD, kBK, kThreads>(ks + (nt % STAGES) * kTile, kb, p.sk[1],
                                 k0, p.Sk);
        load_rows<kHD, kBK, kThreads>(vs + (nt % STAGES) * kTile, vb, p.sv[1],
                                 k0, p.Sk);
      }
      cp_async_commit();
    }
    const int k0 = blo + (t0 + t) * kBK;
    const bf16* kt = ks + (t % STAGES) * kTile;
    const bf16* vt = vs + (t % STAGES) * kTile;

    // S = Q K^T: kN n-blocks of 8 keys; Q's A fragment read a k-step at a
    // time
    float sc[kN][4];
#pragma unroll
    for (int j = 0; j < kN; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHD / 16; ++kk) {
      uint32_t qa[4];
      load_a(qa, qs, kStride, warp * 16, kk * 16);
#pragma unroll
      for (int jj = 0; jj < kN / 2; ++jj) {   // 16 keys: two n-blocks
        uint32_t bfr[4];
        load_b(bfr, kt, kStride, jj * 16, kk * 16);
        mma_bf16(sc[2 * jj], qa, bfr[0], bfr[1]);
        mma_bf16(sc[2 * jj + 1], qa, bfr[2], bfr[3]);
      }
    }
    // element mask, only where the tile straddles a boundary
    if (!(k0 >= all_lo && k0 + kBK - 1 <= all_hi)) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
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
      for (int j = 0; j < kN; ++j) {
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
      for (int d = 0; d < kOut; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }
    // O += P V, a k-step of 16 keys at a time: P as the A fragments of its
    // high and low bf16 parts
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
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
        uint32_t bfr[4];
        load_b_trans(bfr, vt, kStride, nn * 16, kk * 16);
        mma_bf16(acc[2 * nn], ph, bfr[0], bfr[1]);
        mma_bf16(acc[2 * nn], pl, bfr[0], bfr[1]);
        mma_bf16(acc[2 * nn + 1], ph, bfr[2], bfr[3]);
        mma_bf16(acc[2 * nn + 1], pl, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight at exit
  __syncthreads();     // ... of any thread (with no tile, Q's copies)

  float inv[2], row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = sum > 0.f ? 1.f / sum : 0.f;
    row_lse[r] = sum > 0.f ? m[r] * p.scale + logf(sum) : -INFINITY;
  }
  const int i0 = q0 + warp * 16;   // this warp's first query row
  if (p.splits == 1) {
    // o through this warp's 16 rows of the Q tile, which no warp reads any
    // more: 16-byte stores a lane
    bf16* ow = qs + warp * 16 * kStride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int d = 0; d < kOut; ++d) {
        *reinterpret_cast<uint32_t*>(ow + (quad_row + 8 * r) * kStride +
                                     d * 8 + quad_lane * 2) =
            pack_bf16(acc[d][2 * r] * inv[r], acc[d][2 * r + 1] * inv[r]);
      }
    }
    __syncwarp();
    const int col = lane * 8;
#pragma unroll 1
    for (int rr = 0; rr < 16 && i0 + rr < p.Sq; ++rr) {
      *reinterpret_cast<uint4*>(p.o + b * p.so[0] + (i0 + rr) * p.so[1] +
                                h * p.so[2] + col) =
          *reinterpret_cast<const uint4*>(ow + rr * kStride + col);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + quad_row + 8 * r;
      if (quad_lane == 0 && i < p.Sq) {
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + i] = row_lse[r];
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + quad_row + 8 * r;
      if (i >= p.Sq) continue;
      const int64_t row =
          ((static_cast<int64_t>(split) * p.B + b) * p.H + h) * p.Sq + i;
      float* prow = p.o_part + row * kHD + quad_lane * 2;
#pragma unroll
      for (int d = 0; d < kOut; ++d) {
        *reinterpret_cast<float2*>(prow + d * 8) =
            make_float2(acc[d][2 * r] * inv[r], acc[d][2 * r + 1] * inv[r]);
      }
      if (quad_lane == 0) p.lse_part[row] = row_lse[r];
    }
  }
}

// One block a (b, h, i) row, HD threads: the row's splits merged into o
// (bf16, through its strides) and lse, in a fixed
// order. The splits' lse go through shared memory once, then their
// weights exp(lse_t - lse); a split with lse_t = -inf weighs 0 and its
// partial o is 0, so it adds nothing. Four groups of HD / 4 threads, 4
// dims a thread: group g sums splits g, g + 4, ... in order, then group 0
// adds the others' sums, group 1's first. A thread has at most a quarter
// of the splits' loads to wait for (all of them in flight at 32 splits).
template <int HD>
__global__ void __launch_bounds__(HD)
    flash_combine_kernel(const Params p) {
  constexpr int kLanes = HD / 4;   // threads a group
  constexpr int kGroups = 4;
  __shared__ float w[kMaxSplits];
  __shared__ float4 sums[kGroups - 1][kLanes];
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int64_t row = blockIdx.x;    // (b * H + h) * Sq + i
  const int i = static_cast<int>(row % p.Sq);
  const int h = static_cast<int>(row / p.Sq % p.H);
  const int b = static_cast<int>(row / p.Sq / p.H);
  for (int s = threadIdx.x; s < p.splits; s += blockDim.x) {
    w[s] = p.lse_part[s * rows + row];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < p.splits; ++s) mx = fmaxf(mx, w[s]);
  float row_lse = -INFINITY;
  if (mx != -INFINITY) {
    float sum = 0.f;
    for (int s = 0; s < p.splits; ++s) sum += expf(w[s] - mx);
    row_lse = mx + logf(sum);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < p.splits; s += blockDim.x) {
    w[s] = mx == -INFINITY ? 0.f : expf(w[s] - row_lse);
  }
  __syncthreads();
  const int group = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int d = lane * 4;
  const float* part = p.o_part + row * HD + d;
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = group; s < p.splits; s += kGroups) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * rows * HD);
    out.x += w[s] * x.x;
    out.y += w[s] * x.y;
    out.z += w[s] * x.z;
    out.w += w[s] * x.w;
  }
  if (group > 0) sums[group - 1][lane] = out;
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int g = 0; g < kGroups - 1; ++g) {
      out.x += sums[g][lane].x;
      out.y += sums[g][lane].y;
      out.z += sums[g][lane].z;
      out.w += sums[g][lane].w;
    }
    uint2 packed;
    packed.x = pack_bf16(out.x, out.y);
    packed.y = pack_bf16(out.z, out.w);
    *reinterpret_cast<uint2*>(p.o + b * p.so[0] + i * p.so[1] +
                              h * p.so[2] + d) = packed;
  }
  if (threadIdx.x == 0) p.lse[row] = row_lse;
}

template <int WARPS, int STAGES>
int launch_fwd(const Params& p, cudaStream_t stream) {
  auto kernel = flash_fwd_tc256_kernel<WARPS, STAGES>;
  constexpr size_t smem = shared_bytes<WARPS, STAGES>();
  static bool raised[kMaxDevices];
  if (const int err = allow_shared(kernel, smem, raised)) return err;
  const int64_t blocks = static_cast<int64_t>(p.B) * p.H * p.splits *
                         ((p.Sq + 16 * WARPS - 1) / (16 * WARPS));
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), 32 * WARPS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's one argument block (`TC256_ARGS` in kernel.py), 8-byte
// fields.
struct Tc256Args {
  uint64_t ptr[7];   // q, k, v, o, lse, o_part, lse_part
  int64_t B, H, K, Sq, Sk, hd, causal, window, splits;   // hd: row width
  uint64_t stream;
  double scale;      // rounded to float32 here
  int64_t st[4][3];  // batch, sequence and head strides, in elements, of
                     // q, k, v, o
};
static_assert(sizeof(Tc256Args) == 30 * 8, "the wrapper's TC256_ARGS");

// The block as kernel parameters, or a CUDA error: sizes checked, rows on
// 16 bytes.
int unpack(const void* packed, Params& p, cudaStream_t& stream) {
  Tc256Args a;
  memcpy(&a, packed, sizeof a);
  if (a.hd != kHD || a.K <= 0 || a.H % a.K || a.splits < 1 ||
      a.B > 0x7fffffff || a.H > 0x7fffffff || a.Sq > 0x7fffffff ||
      a.Sk > 0x7fffffff || a.splits > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint64_t align = a.ptr[0] | a.ptr[1] | a.ptr[2] | a.ptr[3];
  for (int t = 0; t < 4; ++t) {
    for (int d = 0; d < 3; ++d) align |= static_cast<uint64_t>(a.st[t][d]) * 2;
  }
  if (align % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  p.q = reinterpret_cast<const bf16*>(a.ptr[0]);
  p.k = reinterpret_cast<const bf16*>(a.ptr[1]);
  p.v = reinterpret_cast<const bf16*>(a.ptr[2]);
  p.o = reinterpret_cast<bf16*>(a.ptr[3]);
  p.lse = reinterpret_cast<float*>(a.ptr[4]);
  p.o_part = reinterpret_cast<float*>(a.ptr[5]);
  p.lse_part = reinterpret_cast<float*>(a.ptr[6]);
  p.B = static_cast<int>(a.B);
  p.H = static_cast<int>(a.H);
  p.K = static_cast<int>(a.K);
  p.Sq = static_cast<int>(a.Sq);
  p.Sk = static_cast<int>(a.Sk);
  p.causal = static_cast<int>(a.causal);
  p.window = static_cast<int>(a.window);
  p.splits = static_cast<int>(a.splits);
  p.scale = static_cast<float>(a.scale);
  int64_t* dst[4] = {p.sq, p.sk, p.sv, p.so};
  for (int t = 0; t < 4; ++t) {
    for (int d = 0; d < 3; ++d) dst[t][d] = a.st[t][d];
  }
  stream = reinterpret_cast<cudaStream_t>(a.stream);
  return 0;
}

}  // namespace

// C interface, loaded with ctypes; each takes one `Tc256Args` block.
// q, o: (B, Sq, H, 256) and k, v: (B, Sk, K, 256) bf16, each through its
// batch, sequence and head strides (rows on 16 bytes, unit stride along
// hd);
// lse: (B, H, Sq) float32, contiguous; with splits > 1 (at most 256 for
// the combine), o_part (splits, B, H, Sq, 256) and lse_part (splits, B,
// H, Sq) float32, contiguous workspaces. `scale` is the true head dim's hd^-0.5 (the
// wrapper zero-pads hd). Launch on `stream` without synchronising; return
// the CUDA error (0 on success).
//
// The forward: with splits == 1 it writes o and lse; with more it writes
// the splits' partial results, which flash_combine_launch (with the same
// block) merges into o and lse. A call with at most 16 query rows takes
// 1-warp blocks (16 rows), any other 4-warp blocks (64 rows).
extern "C" int flash_fwd_tc256_launch(const void* packed) {
  Params p;
  cudaStream_t stream;
  if (const int err = unpack(packed, p, stream)) return err;
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0) return 0;
  if (p.Sq <= kDecodeRows) return launch_fwd<1, 3>(p, stream);
  return launch_fwd<4, 2>(p, stream);
}

extern "C" int flash_combine_launch(const void* packed) {
  Params p;
  cudaStream_t stream;
  if (const int err = unpack(packed, p, stream)) return err;
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  if (rows <= 0) return 0;
  if (p.splits < 2 || p.splits > kMaxSplits || rows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_combine_kernel<kHD>
      <<<static_cast<unsigned>(rows), kHD, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
