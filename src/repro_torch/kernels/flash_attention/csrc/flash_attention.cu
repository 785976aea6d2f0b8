// Flash attention with GQA for Hopper, forward and backward:
//
//     o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, kv, j] * hd^-0.5) v[b, kv, j]
//
// over the keys j that query i may attend to, with kv = h / (H / K).
//
// Replaces the Pallas TPU kernel `flash_attention` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention/kernel.py. Same function: GQA,
// causal masking top-left on absolute positions (key j <= query i, from
// position 0 on both sides, so Sq != Sk is allowed), an optional sliding
// window (i - j < window), online softmax in float32, kv tiles that no
// query of the block can see skipped. Inputs are float32 or bfloat16 and
// read in their own type; every sum is float32; outputs are written in
// the inputs' type. A query row that sees no key at all (possible with a
// window and Sq > Sk) gets output 0 and gradient 0, as in the TPU kernel
// where its kv blocks are all skipped; the reference's jnp oracle gives
// the mean of v there instead (ROADMAP C3). The forward also writes each
// row's log-sum-exp (float32) for the backward.
//
// The TPU kernel has no backward (its off-TPU path differentiates the
// oracle). The backward here is FlashAttention-2's, with the softmax
// recomputed from the saved log-sum-exp:
//     delta_i = sum_d do_i * o_i,          p_ij = exp(s_ij - lse_i),
//     dv_j += p_ij do_i,                   ds_ij = p_ij (do_i . v_j - delta_i),
//     dk_j += ds_ij q_i * hd^-0.5,         dq_i += ds_ij k_j * hd^-0.5.
// One kernel computes delta, one dk and dv per (b, kv head, key tile) -
// looping over the query rows of the G query heads that share the kv head
// - and one dq per (b, h, query tile), looping over the keys. No atomics:
// the sums over the G heads and over key tiles run in a fixed order, so
// results repeat run to run.
//
// Bound: the forward does 4*hd operations per visible (query, key) pair
// (half the pairs under causal masking) and moves q, k, v, o and the
// log-sum-exp once; the backward ~2.5x the operations and q, k, v, o, do,
// lse, dq, dk, dv. At long sequences operations bound it: at qwen3-8b's
// head layout (H=32, K=8, hd=128, S=2048, causal) the forward is 34
// GFLOP, 0.035 ms at the dense bf16 tensor-core peak. This kernel runs on
// the CUDA cores in float32 (the transformer payload's S = 8, hd = 8 are
// below any tensor-core tile, and float32 on the tensor cores would be
// TF32), so its floor is the float32 rate, ~15x slower; bfloat16 forwards
// at hd 64 and 128 take flash_fwd_tc.cu instead. At the payload's shapes
// a call moves ~1 MB and launch latency sets its time.
//
// Design: the TPU kernel keeps (m, l, acc) in VMEM scratch across a
// sequential kv grid axis. Here one block owns a tile of query rows of one
// (b, h); a group of TPR neighbouring lanes owns one row, each lane holding
// hd/TPR of its dims (strided, so the group's shared-memory reads hit
// distinct banks), with the row's running max, sum and accumulator in
// registers in float32. K and V tiles are staged through shared memory
// (converted to float32 once) and read by every row of the block; a dot
// product is the group's partial sums reduced with shuffles. Keys are
// taken 16 at a time: their scores, one rescale of the accumulator, then
// their exponentials. The backward kernels use the same row groups, with
// the key rows (dk, dv) or query rows (dq) owned by the groups and the
// other side staged in shared memory. Head dims 8, 16, 32, 64, 128 and 256
// are instantiated; the wrapper zero-pads any other hd up to 256 to the
// next of them and passes the true hd's scale. Wider head dims are padded
// to a multiple of 256 and take the row-looping kernels of the section
// "wide head dims", up to 28,928 (the widest whose dk and dv rows fit one
// block's shared memory). In bfloat16 at hd 64 and 128 the wrapper sends
// both directions to the tensor cores instead (flash_fwd_tc.cu,
// flash_bwd_tc.cu); and a call whose (b, kv head) problem is small (the
// transformer payload's, S = 8) takes the kernels of the section "short
// sequences", both directions, reading any strides. Each backward reads
// either forward's o and lse alike.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

struct Dims {
  int B, H, K, Sq, Sk;
  int causal, window;
  float scale;
};

// A row is owned by TPR neighbouring lanes with DPT = hd / TPR dims each
// (at most 16); a block takes ROWS rows (256 threads at most) and stages
// STAGE rows of the other operand (32 KB of float32 for two operands).
template <int HD>
struct Tile {
  static constexpr int TPR = HD >= 16 ? HD / 16 : 1;   // lanes per row
  static constexpr int DPT = HD / TPR;                  // dims per lane
  static constexpr int ROWS = 256 / TPR < 64 ? 256 / TPR : 64;  // rows a block
  static constexpr int STAGE = 4096 / HD < 64 ? 4096 / HD : 64;  // staged rows
};

constexpr int kChunk = 16;   // keys scored per rescale in the forward

// Keys [lo, hi] that query position i sees (empty when lo > hi).
__device__ __forceinline__ void key_range(const Dims& s, int i, int& lo,
                                          int& hi) {
  hi = s.causal ? min(s.Sk - 1, i) : s.Sk - 1;
  lo = s.window > 0 ? max(0, i - s.window + 1) : 0;
}

// Queries [lo, hi] that see key position j.
__device__ __forceinline__ void query_range(const Dims& s, int j, int& lo,
                                            int& hi) {
  lo = s.causal ? j : 0;
  hi = s.window > 0 ? min(s.Sq - 1, j + s.window - 1) : s.Sq - 1;
}

template <int TPR>
__device__ __forceinline__ unsigned group_mask() {
  if (TPR == 32) return 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  return ((1u << TPR) - 1u) << (lane & ~static_cast<unsigned>(TPR - 1));
}

template <int TPR>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Stage rows [r0, r0 + n) of a (rows, HD) matrix into sm as float32.
template <typename T, int HD>
__device__ __forceinline__ void stage(float (*sm)[HD], const T* src, int r0,
                                      int n) {
  const T* p = src + static_cast<int64_t>(r0) * HD;
  for (int idx = threadIdx.x; idx < n * HD; idx += blockDim.x) {
    sm[idx / HD][idx % HD] = to_f(p[idx]);
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int HD>
__global__ void flash_fwd_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v, T* __restrict__ o,
                                 float* __restrict__ lse, Dims s, int bq) {
  constexpr int TPR = Tile<HD>::TPR, DPT = Tile<HD>::DPT;
  constexpr int BK = Tile<HD>::STAGE;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  const int tiles = (s.Sq + bq - 1) / bq;
  const int qt = blockIdx.x % tiles;
  const int64_t bh = blockIdx.x / tiles;
  const int h = static_cast<int>(bh % s.H);
  const int64_t b = bh / s.H;
  const int kvh = h / (s.H / s.K);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int i = qt * bq + row;
  const bool active = i < s.Sq;
  const unsigned mask = group_mask<TPR>();

  const T* kb = k + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * HD;
  const T* vb = v + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * HD;
  const int64_t qrow = (bh * s.Sq + i) * HD;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qr[t] = active ? to_f(q[qrow + part + TPR * t]) : 0.f;
    acc[t] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int lo, hi;
  key_range(s, i, lo, hi);
  if (!active) hi = lo - 1;

  // keys any row of this block sees: from the first row's lower bound to
  // the last row's upper bound (both bounds grow with the row)
  int blo, bhi, unused;
  key_range(s, qt * bq, blo, unused);
  key_range(s, min(s.Sq - 1, qt * bq + bq - 1), unused, bhi);

  for (int k0 = blo; k0 <= bhi; k0 += BK) {
    const int n = min(BK, bhi - k0 + 1);
    __syncthreads();
    stage<T, HD>(ks, kb, k0, n);
    stage<T, HD>(vs, vb, k0, n);
    __syncthreads();
    const int j_lo = max(lo, k0) - k0;
    const int j_hi = min(hi, k0 + n - 1) - k0;
    for (int j0 = j_lo; j0 <= j_hi; j0 += kChunk) {
      float sc[kChunk];
      float mc = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float dot = 0.f;
        if (j <= j_hi) {
#pragma unroll
          for (int t = 0; t < DPT; ++t) {
            dot = fmaf(qr[t], ks[j][part + TPR * t], dot);
          }
        }
        dot = group_sum<TPR>(dot, mask);
        sc[c] = j <= j_hi ? dot * s.scale : -INFINITY;
        mc = fmaxf(mc, sc[c]);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);   // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int t = 0; t < DPT; ++t) acc[t] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        if (j <= j_hi) {
          const float p = expf(sc[c] - m_new);
          l += p;
#pragma unroll
          for (int t = 0; t < DPT; ++t) {
            acc[t] = fmaf(p, vs[j][part + TPR * t], acc[t]);
          }
        }
      }
      m = m_new;
    }
  }
  if (!active) return;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    o[qrow + part + TPR * t] = from_f<T>(l > 0.f ? acc[t] / l : 0.f);
  }
  if (part == 0) lse[bh * s.Sq + i] = l > 0.f ? m + logf(l) : -INFINITY;
}

// --------------------------------------------------------------- backward

// delta[b, h, i] = sum_d do * o.
template <typename T, int HD>
__global__ void flash_delta_kernel(const T* __restrict__ o,
                                   const T* __restrict__ dout,
                                   float* __restrict__ delta, int64_t rows) {
  constexpr int TPR = Tile<HD>::TPR, DPT = Tile<HD>::DPT;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / TPR) +
      threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  if (r >= rows) return;   // a row's lanes leave together
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    const int64_t e = r * HD + part + TPR * t;
    acc = fmaf(to_f(dout[e]), to_f(o[e]), acc);
  }
  acc = group_sum<TPR>(acc, group_mask<TPR>());
  if (part == 0) delta[r] = acc;
}

// dk, dv for one key tile of one (b, kv head).
template <typename T, int HD>
__global__ void flash_dkdv_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  T* __restrict__ dk, T* __restrict__ dv,
                                  Dims s, int bk) {
  constexpr int TPR = Tile<HD>::TPR, DPT = Tile<HD>::DPT;
  constexpr int BQ = Tile<HD>::STAGE;
  __shared__ float qs[BQ][HD];
  __shared__ float dos[BQ][HD];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];
  const int tiles = (s.Sk + bk - 1) / bk;
  const int kt = blockIdx.x % tiles;
  const int64_t bkv = blockIdx.x / tiles;
  const int kvh = static_cast<int>(bkv % s.K);
  const int64_t b = bkv / s.K;
  const int G = s.H / s.K;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int j = kt * bk + row;
  const bool active = j < s.Sk;
  const unsigned mask = group_mask<TPR>();
  const int64_t krow = (bkv * s.Sk + j) * HD;

  float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    kr[t] = active ? to_f(k[krow + part + TPR * t]) : 0.f;
    vr[t] = active ? to_f(v[krow + part + TPR * t]) : 0.f;
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }
  int lo, hi;
  query_range(s, j, lo, hi);
  if (!active) hi = lo - 1;
  int blo, bhi, unused;
  query_range(s, kt * bk, blo, unused);
  query_range(s, min(s.Sk - 1, kt * bk + bk - 1), unused, bhi);

  for (int g = 0; g < G; ++g) {
    const int64_t bh = b * s.H + static_cast<int64_t>(kvh) * G + g;
    const T* qb = q + bh * static_cast<int64_t>(s.Sq) * HD;
    const T* db = dout + bh * static_cast<int64_t>(s.Sq) * HD;
    for (int q0 = blo; q0 <= bhi; q0 += BQ) {
      const int n = min(BQ, bhi - q0 + 1);
      __syncthreads();
      stage<T, HD>(qs, qb, q0, n);
      stage<T, HD>(dos, db, q0, n);
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        lse_s[t] = lse[bh * s.Sq + q0 + t];
        delta_s[t] = delta[bh * s.Sq + q0 + t];
      }
      __syncthreads();
      const int i_lo = max(lo, q0) - q0;
      const int i_hi = min(hi, q0 + n - 1) - q0;
      for (int i = i_lo; i <= i_hi; ++i) {
        float sdot = 0.f, pdot = 0.f;
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          sdot = fmaf(qs[i][part + TPR * t], kr[t], sdot);
          pdot = fmaf(dos[i][part + TPR * t], vr[t], pdot);
        }
        sdot = group_sum<TPR>(sdot, mask);
        pdot = group_sum<TPR>(pdot, mask);
        const float p = expf(sdot * s.scale - lse_s[i]);
        const float dsc = p * (pdot - delta_s[i]);
#pragma unroll
        for (int t = 0; t < DPT; ++t) {
          dvr[t] = fmaf(p, dos[i][part + TPR * t], dvr[t]);
          dkr[t] = fmaf(dsc, qs[i][part + TPR * t], dkr[t]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    dk[krow + part + TPR * t] = from_f<T>(dkr[t] * s.scale);
    dv[krow + part + TPR * t] = from_f<T>(dvr[t]);
  }
}

// dq for one query tile of one (b, h).
template <typename T, int HD>
__global__ void flash_dq_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dq, Dims s, int bq) {
  constexpr int TPR = Tile<HD>::TPR, DPT = Tile<HD>::DPT;
  constexpr int BK = Tile<HD>::STAGE;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];
  const int tiles = (s.Sq + bq - 1) / bq;
  const int qt = blockIdx.x % tiles;
  const int64_t bh = blockIdx.x / tiles;
  const int h = static_cast<int>(bh % s.H);
  const int64_t b = bh / s.H;
  const int kvh = h / (s.H / s.K);
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int i = qt * bq + row;
  const bool active = i < s.Sq;
  const unsigned mask = group_mask<TPR>();
  const T* kb = k + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * HD;
  const T* vb = v + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * HD;
  const int64_t qrow = (bh * s.Sq + i) * HD;

  float qr[DPT], dor[DPT], dqr[DPT];
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    qr[t] = active ? to_f(q[qrow + part + TPR * t]) : 0.f;
    dor[t] = active ? to_f(dout[qrow + part + TPR * t]) : 0.f;
    dqr[t] = 0.f;
  }
  const float lse_i = active ? lse[bh * s.Sq + i] : 0.f;
  const float delta_i = active ? delta[bh * s.Sq + i] : 0.f;
  int lo, hi;
  key_range(s, i, lo, hi);
  if (!active) hi = lo - 1;
  int blo, bhi, unused;
  key_range(s, qt * bq, blo, unused);
  key_range(s, min(s.Sq - 1, qt * bq + bq - 1), unused, bhi);

  for (int k0 = blo; k0 <= bhi; k0 += BK) {
    const int n = min(BK, bhi - k0 + 1);
    __syncthreads();
    stage<T, HD>(ks, kb, k0, n);
    stage<T, HD>(vs, vb, k0, n);
    __syncthreads();
    const int j_lo = max(lo, k0) - k0;
    const int j_hi = min(hi, k0 + n - 1) - k0;
    for (int j = j_lo; j <= j_hi; ++j) {
      float sdot = 0.f, pdot = 0.f;
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        sdot = fmaf(qr[t], ks[j][part + TPR * t], sdot);
        pdot = fmaf(dor[t], vs[j][part + TPR * t], pdot);
      }
      sdot = group_sum<TPR>(sdot, mask);
      pdot = group_sum<TPR>(pdot, mask);
      const float p = expf(sdot * s.scale - lse_i);
      const float dsc = p * (pdot - delta_i);
#pragma unroll
      for (int t = 0; t < DPT; ++t) {
        dqr[t] = fmaf(dsc, ks[j][part + TPR * t], dqr[t]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int t = 0; t < DPT; ++t) {
    dq[qrow + part + TPR * t] = from_f<T>(dqr[t] * s.scale);
  }
}

// ------------------------------------------- wide head dims (above 256)
//
// Padded widths W above 256 (multiples of kWideChunk) take these kernels:
// one warp owns a row and walks its dims in chunks of 256 (8 a lane, lane
// d on dims d, d + 32, ...), and the row's float32 vectors that the
// register-held kernels above keep in registers (q and o's accumulator;
// dk and dv; dq) sit in dynamic shared memory, sized at launch, with the
// rows a block takes chosen so that they fit. A lane touches only its own
// dims there, so no barrier is needed; a dot product is one warp shuffle
// reduction. The other operand's rows are read from global memory (L1 and
// L2 serve the block's other rows). Simple and right, not fast: no
// configuration in the repository has a head dim above 256.

constexpr int kWideChunk = 256;      // dims a warp walks at a time
constexpr int kWideRows = 8;         // rows (warps) a block at most
constexpr int kMaxShared = 232448;   // bytes of shared memory a block can use

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows a block of a wide kernel takes, for `bytes` of shared memory a row.
int wide_rows(int64_t bytes) {
  const int64_t r = kMaxShared / bytes;
  return static_cast<int>(r < kWideRows ? r : kWideRows);
}

// Raise a kernel's dynamic shared-memory limit where it needs more than
// the default 48 KB; 0 or the CUDA error.
template <typename Kernel>
int allow_shared(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Forward: a warp a query row; its q (float32) and o's accumulator in
// shared memory, 2 W floats a row.
template <typename T>
__global__ void flash_fwd_wide_kernel(const T* __restrict__ q,
                                      const T* __restrict__ k,
                                      const T* __restrict__ v,
                                      T* __restrict__ o,
                                      float* __restrict__ lse, Dims s,
                                      int W, int rows) {
  extern __shared__ float wide_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qs = wide_sm + static_cast<int64_t>(warp) * 2 * W;
  float* acc = qs + W;
  const int tiles = (s.Sq + rows - 1) / rows;
  const int i = (blockIdx.x % tiles) * rows + warp;
  const int64_t bh = blockIdx.x / tiles;
  if (i >= s.Sq) return;   // the whole warp; no block barrier follows
  const int h = static_cast<int>(bh % s.H);
  const int64_t b = bh / s.H;
  const int kvh = h / (s.H / s.K);
  const T* kb = k + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * W;
  const T* vb = v + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * W;
  const int64_t qrow = (bh * s.Sq + i) * W;
#pragma unroll 8
  for (int d = lane; d < W; d += 32) {
    qs[d] = to_f(q[qrow + d]);
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int lo, hi;
  key_range(s, i, lo, hi);
  for (int j0 = lo; j0 <= hi; j0 += kChunk) {
    float p[kChunk];
    float mc = -INFINITY;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float dot = 0.f;
      if (j0 + c <= hi) {
        const T* kr = kb + static_cast<int64_t>(j0 + c) * W;
#pragma unroll 8
        for (int d = lane; d < W; d += 32) dot = fmaf(qs[d], to_f(kr[d]), dot);
      }
      dot = warp_sum(dot);
      p[c] = j0 + c <= hi ? dot * s.scale : -INFINITY;
      mc = fmaxf(mc, p[c]);
    }
    const float m_new = fmaxf(m, mc);
    const float alpha = expf(m - m_new);   // 0 on the first chunk
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      p[c] = j0 + c <= hi ? expf(p[c] - m_new) : 0.f;
      l += p[c];
    }
    const int n = min(kChunk, hi - j0 + 1);
#pragma unroll 8
    for (int d = lane; d < W; d += 32) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {   // unrolled: p stays in registers
        if (c < n) {
          a = fmaf(p[c], to_f(vb[static_cast<int64_t>(j0 + c) * W + d]), a);
        }
      }
      acc[d] = a;
    }
    m = m_new;
  }
#pragma unroll 8
  for (int d = lane; d < W; d += 32) {
    o[qrow + d] = from_f<T>(l > 0.f ? acc[d] / l : 0.f);
  }
  if (lane == 0) lse[bh * s.Sq + i] = l > 0.f ? m + logf(l) : -INFINITY;
}

// delta[r] = sum_d do * o, a warp a row.
template <typename T>
__global__ void flash_delta_wide_kernel(const T* __restrict__ o,
                                        const T* __restrict__ dout,
                                        float* __restrict__ delta,
                                        int64_t rows, int W) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  if (r >= rows) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll 8
  for (int d = lane; d < W; d += 32) {
    acc = fmaf(to_f(dout[r * W + d]), to_f(o[r * W + d]), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[r] = acc;
}

// dk, dv: a warp a key row of one (b, kv head), walking the query rows of
// the G heads that see it in a fixed order; dk and dv in shared memory,
// 2 W floats a row.
template <typename T>
__global__ void flash_dkdv_wide_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       T* __restrict__ dk,
                                       T* __restrict__ dv, Dims s, int W,
                                       int rows) {
  extern __shared__ float wide_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dks = wide_sm + static_cast<int64_t>(warp) * 2 * W;
  float* dvs = dks + W;
  const int tiles = (s.Sk + rows - 1) / rows;
  const int j = (blockIdx.x % tiles) * rows + warp;
  const int64_t bkv = blockIdx.x / tiles;
  if (j >= s.Sk) return;   // the whole warp; no block barrier follows
  const int kvh = static_cast<int>(bkv % s.K);
  const int64_t b = bkv / s.K;
  const int G = s.H / s.K;
  const int64_t krow = (bkv * s.Sk + j) * W;
#pragma unroll 8
  for (int d = lane; d < W; d += 32) dks[d] = dvs[d] = 0.f;
  int lo, hi;
  query_range(s, j, lo, hi);
  for (int g = 0; g < G; ++g) {
    const int64_t bh = b * s.H + static_cast<int64_t>(kvh) * G + g;
    for (int i = lo; i <= hi; ++i) {
      const int64_t qrow = (bh * s.Sq + i) * W;
      float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
      for (int d = lane; d < W; d += 32) {
        sdot = fmaf(to_f(q[qrow + d]), to_f(k[krow + d]), sdot);
        pdot = fmaf(to_f(dout[qrow + d]), to_f(v[krow + d]), pdot);
      }
      sdot = warp_sum(sdot);
      pdot = warp_sum(pdot);
      const float p = expf(sdot * s.scale - lse[bh * s.Sq + i]);
      const float dsc = p * (pdot - delta[bh * s.Sq + i]);
#pragma unroll 8
      for (int d = lane; d < W; d += 32) {
        dvs[d] = fmaf(p, to_f(dout[qrow + d]), dvs[d]);
        dks[d] = fmaf(dsc, to_f(q[qrow + d]), dks[d]);
      }
    }
  }
#pragma unroll 8
  for (int d = lane; d < W; d += 32) {
    dk[krow + d] = from_f<T>(dks[d] * s.scale);
    dv[krow + d] = from_f<T>(dvs[d]);
  }
}

// dq: a warp a query row, walking the keys it sees; dq in shared memory,
// W floats a row.
template <typename T>
__global__ void flash_dq_wide_kernel(const T* __restrict__ q,
                                     const T* __restrict__ k,
                                     const T* __restrict__ v,
                                     const T* __restrict__ dout,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     T* __restrict__ dq, Dims s, int W,
                                     int rows) {
  extern __shared__ float wide_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* dqs = wide_sm + static_cast<int64_t>(warp) * W;
  const int tiles = (s.Sq + rows - 1) / rows;
  const int i = (blockIdx.x % tiles) * rows + warp;
  const int64_t bh = blockIdx.x / tiles;
  if (i >= s.Sq) return;   // the whole warp; no block barrier follows
  const int h = static_cast<int>(bh % s.H);
  const int64_t b = bh / s.H;
  const int kvh = h / (s.H / s.K);
  const T* kb = k + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * W;
  const T* vb = v + (b * s.K + kvh) * static_cast<int64_t>(s.Sk) * W;
  const int64_t qrow = (bh * s.Sq + i) * W;
#pragma unroll 8
  for (int d = lane; d < W; d += 32) dqs[d] = 0.f;
  const float lse_i = lse[bh * s.Sq + i];
  const float delta_i = delta[bh * s.Sq + i];
  int lo, hi;
  key_range(s, i, lo, hi);
  for (int j = lo; j <= hi; ++j) {
    const int64_t krow = static_cast<int64_t>(j) * W;
    float sdot = 0.f, pdot = 0.f;
#pragma unroll 8
    for (int d = lane; d < W; d += 32) {
      sdot = fmaf(to_f(q[qrow + d]), to_f(kb[krow + d]), sdot);
      pdot = fmaf(to_f(dout[qrow + d]), to_f(vb[krow + d]), pdot);
    }
    sdot = warp_sum(sdot);
    pdot = warp_sum(pdot);
    const float p = expf(sdot * s.scale - lse_i);
    const float dsc = p * (pdot - delta_i);
#pragma unroll 8
    for (int d = lane; d < W; d += 32) {
      dqs[d] = fmaf(dsc, to_f(kb[krow + d]), dqs[d]);
    }
  }
#pragma unroll 8
  for (int d = lane; d < W; d += 32) dq[qrow + d] = from_f<T>(dqs[d] * s.scale);
}

// Whether a padded width takes the wide kernels: a multiple of kWideChunk
// above 256 whose largest row (dk and dv, 2 W floats) fits one block.
bool wide_width(int W) {
  return W > 256 && W % kWideChunk == 0 &&
         8 * static_cast<int64_t>(W) <= kMaxShared;
}

template <typename T>
int fwd_wide(int W, const void* q, const void* k, const void* v, void* o,
             float* lse, const Dims& s, cudaStream_t stream) {
  const int64_t row_bytes = 8 * static_cast<int64_t>(W);
  const int rows = wide_rows(row_bytes);
  auto kernel = flash_fwd_wide_kernel<T>;
  if (const int err = allow_shared(kernel, rows * row_bytes)) return err;
  const int64_t blocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + rows - 1) / rows);
  kernel<<<static_cast<unsigned>(blocks), 32 * rows, rows * row_bytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse, s, W,
                     rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_wide(int W, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dout, void* dq,
             void* dk, void* dv, float* delta, const Dims& s,
             cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dt = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(s.B) * s.H * s.Sq;
  flash_delta_wide_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                               stream>>>(static_cast<const T*>(o), dt, delta,
                                         rows, W);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  const int64_t kv_bytes = 8 * static_cast<int64_t>(W);   // dk and dv
  const int kr = wide_rows(kv_bytes);
  auto dkdv = flash_dkdv_wide_kernel<T>;
  if (const int err = allow_shared(dkdv, kr * kv_bytes)) return err;
  const int64_t kblocks =
      static_cast<int64_t>(s.B) * s.K * ((s.Sk + kr - 1) / kr);
  dkdv<<<static_cast<unsigned>(kblocks), 32 * kr, kr * kv_bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      s, W, kr);
  if (const cudaError_t err = cudaGetLastError()) return static_cast<int>(err);

  const int64_t q_bytes = 4 * static_cast<int64_t>(W);    // dq
  const int qr = wide_rows(q_bytes);
  auto dqk = flash_dq_wide_kernel<T>;
  if (const int err = allow_shared(dqk, qr * q_bytes)) return err;
  const int64_t qblocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + qr - 1) / qr);
  dqk<<<static_cast<unsigned>(qblocks), 32 * qr, qr * q_bytes, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), s, W, qr);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- short sequences
//
// These kernels, like those above, replace the Pallas TPU kernel
// `flash_attention` (src/repro/kernels/flash_attention/kernel.py:91), for
// short sequences. The transformer payload's calls are tiny: at (B, H, K,
// S, hd) = (640, 4, 2, 8, 8), causal, float32, a whole (b, kv head)
// problem - a "unit" - is G * Sq = 16 query rows by Sk = 8 keys, and a
// call moves ~2 MB (bound: the bytes of q, k, v, o and lse once forward,
// 0.61 us; of q, k, v, o, do, lse, dq, dk and dv backward, 1.20 us). What
// the kernels above spend there is launch latency, blocks of 8 threads (a
// quarter of a warp), K and V staged again for each of the G query heads,
// three backward launches around a delta buffer in global memory, and, in
// the wrapper, copies into and out of the (B, H, S, hd) layout. So every
// call whose unit's backward working set - in float32, q, o and do of the
// G heads, k, v, lse, delta, P and dS - fits kShortBudget (the wrapper's
// `short_fits` computes the same sum) takes these kernels, both
// directions:
//   - a warp owns a unit, a block 4 or 8 units (128 or 256 threads), 8
//     only where that still leaves two blocks an SM (the path's 1,280 units
//     make 320 blocks);
//   - the unit's K and V, and the rows of its G query heads (q; in the
//     backward also o and do), are copied once into shared memory with
//     16-byte cp.async, in their own type, and serve all G heads;
//   - forward: a group of lanes owns a score row - as few lanes as still
//     give every lane a row, so that the rows of a unit mostly take one
//     pass, each lane its keys in turn - its max and sum are shuffle
//     reductions, and P goes to shared memory; then a lane owns (row,
//     4 dims) of P V;
//   - backward, one launch: delta = rowsum(do o), P = exp(S scale - lse)
//     and dS = P (dP - delta) into shared memory, then dV = P^T dO,
//     dK = dS^T Q scale and dQ = dS K scale, each output element summed in
//     a fixed order (dK and dV by the lanes the warp has to spare, their
//     parts added by shuffles in a fixed pattern): no atomics, no
//     workspace, and two calls give the same bits;
//   - every tensor comes with its batch, sequence and head strides (the
//     last dim contiguous, each row on 16 bytes), so the transformer's
//     (B, S, H, hd) projections are read in place and o, dq, dk, dv are
//     written in the layout the wrapper allocated.
// All arithmetic is float32 on the CUDA cores: the path is float32, which
// on the tensor cores would be TF32 and change the numbers against the
// reference, and an 8 x 8 problem is below an mma tile. Masking, GQA,
// Sq != Sk, the window and dead rows (o = 0, lse = -inf, zero gradients)
// are those of the kernels above.

constexpr int kShortBudget = 49152;  // bytes of a unit's float32 working set
constexpr int kShortUnits = 8;       // units (warps) a block at most
// The H100 SXM's SMs. It only tunes how many units a block takes (8 or 4,
// see short_units), never what a kernel computes, so another card's count
// changes the speed alone.
constexpr int kSMs = 132;
static_assert(kShortUnits / 2 * kShortBudget <= kMaxShared,
              "four units within the budget fit one block");

struct Bsh {   // element strides of a (batch, sequence, head, hd) view
  int64_t b, s, h;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&a);
  t.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// A row of HD elements dotted with another, both in shared memory.
template <typename T, int HD>
__device__ __forceinline__ float dot_short(const T* a, const T* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    float x[4], y[4];
    load4(a + c, x);
    load4(b + c, y);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc = fmaf(x[t], y[t], acc);
  }
  return acc;
}

// Copy groups * per rows of HD elements into sm (HD a row, row g * per + i)
// from src + g * sg + i * si, 16 bytes a lane at a time (the warp's copies;
// cp_async_wait_all and __syncwarp make them visible).
template <typename T, int HD>
__device__ __forceinline__ void stage_short(T* sm, const T* src, int groups,
                                            int per, int64_t sg, int64_t si,
                                            int lane) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // elements a copy
  constexpr int C = HD / E;                              // copies a row
  const int total = groups * per * C;
  for (int idx = lane; idx < total; idx += 32) {
    const int c = idx % C, row = idx / C;
    cp_async16(sm + row * HD + c * E,
               src + (row / per) * sg + (row % per) * si + c * E);
  }
}

__device__ __forceinline__ float lanes_max(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float lanes_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Shared memory of one unit, in bytes (16-byte aligned): the T-typed rows
// (their sizes multiples of 16 bytes), then the float32 arrays.
template <typename T, int HD>
int64_t short_unit_bytes(const Dims& s, int t_rows, int f32_rows) {
  const int64_t R = static_cast<int64_t>(s.H / s.K) * s.Sq;
  const int64_t PS = s.Sk | 1;   // P's row stride, odd: rows on other banks
  const int64_t bytes = (t_rows * R + 2 * s.Sk) * HD * sizeof(T) +
                        (f32_rows * R * PS + 2 * R) * 4;
  return (bytes + 15) / 16 * 16;
}

// Units a block: 8 where that still gives two blocks an SM, else 4; fewer
// if their shared memory does not fit a block.
int short_units(int64_t units, int64_t bytes) {
  int u = units >= 2 * kSMs * kShortUnits ? kShortUnits : kShortUnits / 2;
  while (u > 1 && u * bytes > kMaxShared) --u;
  return u;
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kShortUnits)
    flash_fwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, Dims s, Bsh sq, Bsh sk,
                           Bsh sv, Bsh so, int unit_bytes) {
  extern __shared__ __align__(16) unsigned char short_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t unit =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (unit >= static_cast<int64_t>(s.B) * s.K) return;   // the whole warp
  const int kvh = static_cast<int>(unit % s.K);
  const int64_t b = unit / s.K;
  const int G = s.H / s.K, R = G * s.Sq, PS = s.Sk | 1, h0 = kvh * G;
  T* qs = reinterpret_cast<T*>(short_sm +
                               static_cast<int64_t>(warp) * unit_bytes);
  T* ks = qs + R * HD;
  T* vs = ks + s.Sk * HD;
  float* ps = reinterpret_cast<float*>(vs + s.Sk * HD);
  float* ls = ps + R * PS;   // each row's sum of exponentials
  stage_short<T, HD>(qs, q + b * sq.b + h0 * sq.h, G, s.Sq, sq.h, sq.s, lane);
  stage_short<T, HD>(ks, k + b * sk.b + kvh * sk.h, 1, s.Sk, 0, sk.s, lane);
  stage_short<T, HD>(vs, v + b * sv.b + kvh * sv.h, 1, s.Sk, 0, sv.s, lane);
  cp_async_wait_all();
  __syncwarp();

  // scores and softmax: `width` lanes a row, as few as still give every
  // lane a row (so one pass at the path's 16 rows, 2 lanes a row, 4 keys
  // a lane), 32 / width rows a pass
  int width = 1;
  while (2 * width * R <= 32 && width < s.Sk) width <<= 1;
  const int sub = lane % width;
  float* lse_u = lse + (b * s.H + h0) * s.Sq;   // the unit's R rows
  for (int r0 = 0; r0 < R; r0 += 32 / width) {
    const int r = r0 + lane / width;
    const bool live = r < R;
    int lo, hi;
    key_range(s, live ? r % s.Sq : 0, lo, hi);
    if (!live) hi = lo - 1;
    float m = -INFINITY;
    // unrolled 4 keys deep up to hd 64; from hd 128 on, where a key's dot
    // product is itself 32 or more unrolled loads, a key at a time (deeper,
    // the float32 kernels spill)
#pragma unroll (HD >= 128 ? 1 : 4)
    for (int j = sub; j < s.Sk; j += width) {
      if (j >= lo && j <= hi) {
        const float sc = dot_short<T, HD>(qs + r * HD, ks + j * HD) * s.scale;
        ps[r * PS + j] = sc;
        m = fmaxf(m, sc);
      }
    }
    m = lanes_max(m, width);
    float l = 0.f;
#pragma unroll (HD >= 128 ? 1 : 4)
    for (int j = sub; j < s.Sk; j += width) {
      if (j >= lo && j <= hi) {   // m is finite here
        const float p = expf(ps[r * PS + j] - m);
        ps[r * PS + j] = p;
        l += p;
      }
    }
    l = lanes_sum(l, width);
    if (live && sub == 0) {
      ls[r] = l;
      lse_u[r] = l > 0.f ? m + logf(l) : -INFINITY;
    }
  }
  __syncwarp();

  // o = P V / l: a lane (row, 4 dims), keys in order
  constexpr int C4 = HD / 4;
  for (int idx = lane; idx < R * C4; idx += 32) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int g = r / s.Sq, i = r % s.Sq;
    int lo, hi;
    key_range(s, i, lo, hi);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = lo; j <= hi; ++j) {
      const float p = ps[r * PS + j];
      float x[4];
      load4(vs + j * HD + c, x);
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] = fmaf(p, x[t], acc[t]);
    }
    const float l = ls[r];
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[t] = l > 0.f ? acc[t] / l : 0.f;
    store4(o + b * so.b + i * so.s + (h0 + g) * so.h + c, acc);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * kShortUnits)
    flash_bwd_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ o,
                           const float* __restrict__ lse,
                           const T* __restrict__ dout, T* __restrict__ dq,
                           T* __restrict__ dk, T* __restrict__ dv, Dims s,
                           Bsh sq, Bsh sk, Bsh sv, Bsh so, Bsh sdo, Bsh sdq,
                           Bsh sdk, Bsh sdv, int unit_bytes) {
  extern __shared__ __align__(16) unsigned char short_sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t unit =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (unit >= static_cast<int64_t>(s.B) * s.K) return;   // the whole warp
  const int kvh = static_cast<int>(unit % s.K);
  const int64_t b = unit / s.K;
  const int G = s.H / s.K, R = G * s.Sq, PS = s.Sk | 1, h0 = kvh * G;
  T* qs = reinterpret_cast<T*>(short_sm +
                               static_cast<int64_t>(warp) * unit_bytes);
  T* os = qs + R * HD;
  T* dos = os + R * HD;
  T* ks = dos + R * HD;
  T* vs = ks + s.Sk * HD;
  float* ps = reinterpret_cast<float*>(vs + s.Sk * HD);
  float* dss = ps + R * PS;
  float* lse_s = dss + R * PS;
  float* delta_s = lse_s + R;
  stage_short<T, HD>(qs, q + b * sq.b + h0 * sq.h, G, s.Sq, sq.h, sq.s, lane);
  stage_short<T, HD>(os, o + b * so.b + h0 * so.h, G, s.Sq, so.h, so.s, lane);
  stage_short<T, HD>(dos, dout + b * sdo.b + h0 * sdo.h, G, s.Sq, sdo.h,
                     sdo.s, lane);
  stage_short<T, HD>(ks, k + b * sk.b + kvh * sk.h, 1, s.Sk, 0, sk.s, lane);
  stage_short<T, HD>(vs, v + b * sv.b + kvh * sv.h, 1, s.Sk, 0, sv.s, lane);
  const float* lse_u = lse + (b * s.H + h0) * s.Sq;   // the unit's R rows
  for (int r = lane; r < R; r += 32) lse_s[r] = lse_u[r];
  cp_async_wait_all();
  __syncwarp();
  for (int r = lane; r < R; r += 32) {
    delta_s[r] = dot_short<T, HD>(dos + r * HD, os + r * HD);
  }
  __syncwarp();

  // P and dS, a lane an entry; zero where masked or the row is dead
  for (int idx = lane; idx < R * s.Sk; idx += 32) {
    const int r = idx / s.Sk, j = idx % s.Sk;
    int lo, hi;
    key_range(s, r % s.Sq, lo, hi);
    const float l = lse_s[r];
    float p = 0.f, ds = 0.f;
    if (j >= lo && j <= hi && l != -INFINITY) {
      p = expf(dot_short<T, HD>(qs + r * HD, ks + j * HD) * s.scale - l);
      ds = p * (dot_short<T, HD>(dos + r * HD, vs + j * HD) - delta_s[r]);
    }
    ps[r * PS + j] = p;
    dss[r * PS + j] = ds;
  }
  __syncwarp();

  // dV = P^T dO and dK = dS^T Q scale: `split` lanes an element (key j,
  // 4 dims), as many as the warp has to spare, each summing the query rows
  // that see key j of every split-th of the G heads (heads in turn, each in
  // query order); the parts are added by shuffles in a fixed pattern
  constexpr int C4 = HD / 4;
  const int items = s.Sk * C4;
  int split = 1;
  while (2 * split * items <= 32) split <<= 1;
  const int part = lane % split;
  for (int base = 0; base < items * split; base += 32) {   // warp-uniform
    const int idx = (base + lane) / split;
    const int j = idx / C4, c = (idx % C4) * 4;
    int lo = 0, hi = -1;
    if (idx < items) query_range(s, j, lo, hi);
    float ak[4] = {0.f, 0.f, 0.f, 0.f}, av[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = part; g < G; g += split) {
      for (int r = g * s.Sq + lo; r <= g * s.Sq + hi; ++r) {
        const float p = ps[r * PS + j], ds = dss[r * PS + j];
        float x[4], y[4];
        load4(dos + r * HD + c, x);
        load4(qs + r * HD + c, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          av[e] = fmaf(p, x[e], av[e]);
          ak[e] = fmaf(ds, y[e], ak[e]);
        }
      }
    }
    for (int o = split / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        av[e] += __shfl_xor_sync(0xffffffffu, av[e], o);
        ak[e] += __shfl_xor_sync(0xffffffffu, ak[e], o);
      }
    }
    if (idx < items && part == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[e] *= s.scale;
      store4(dk + b * sdk.b + j * sdk.s + kvh * sdk.h + c, ak);
      store4(dv + b * sdv.b + j * sdv.s + kvh * sdv.h + c, av);
    }
  }

  // dQ = dS K scale: a lane (row, 4 dims), keys in order
  for (int idx = lane; idx < R * C4; idx += 32) {
    const int r = idx / C4, c = (idx % C4) * 4;
    const int g = r / s.Sq, i = r % s.Sq;
    int lo, hi;
    key_range(s, i, lo, hi);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = lo; j <= hi; ++j) {
      const float ds = dss[r * PS + j];
      float x[4];
      load4(ks + j * HD + c, x);
#pragma unroll
      for (int t = 0; t < 4; ++t) a[t] = fmaf(ds, x[t], a[t]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) a[t] *= s.scale;
    store4(dq + b * sdq.b + i * sdq.s + (h0 + g) * sdq.h + c, a);
  }
}

template <typename T, int HD>
int fwd_short(const void* q, const void* k, const void* v, void* o,
              float* lse, const Dims& s, const Bsh (&st)[4],
              cudaStream_t stream) {
  const int64_t bytes = short_unit_bytes<T, HD>(s, 1, 1);
  const int64_t units = static_cast<int64_t>(s.B) * s.K;
  const int u = short_units(units, bytes);
  if (u * bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_short_kernel<T, HD>;
  if (const int err = allow_shared(kernel, u * bytes)) return err;
  kernel<<<static_cast<unsigned>((units + u - 1) / u), 32 * u, u * bytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse, s,
                     st[0], st[1], st[2], st[3], static_cast<int>(bytes));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int bwd_short(const void* q, const void* k, const void* v, const void* o,
              const float* lse, const void* dout, void* dq, void* dk,
              void* dv, const Dims& s, const Bsh (&st)[8],
              cudaStream_t stream) {
  const int64_t bytes = short_unit_bytes<T, HD>(s, 3, 2);
  const int64_t units = static_cast<int64_t>(s.B) * s.K;
  const int u = short_units(units, bytes);
  if (u * bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_short_kernel<T, HD>;
  if (const int err = allow_shared(kernel, u * bytes)) return err;
  kernel<<<static_cast<unsigned>((units + u - 1) / u), 32 * u, u * bytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(o), lse,
                     static_cast<const T*>(dout), static_cast<T*>(dq),
                     static_cast<T*>(dk), static_cast<T*>(dv), s, st[0],
                     st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                     static_cast<int>(bytes));
  return static_cast<int>(cudaGetLastError());
}

// Whether a pointer and its view's strides put every row on 16 bytes (the
// stride of a dim of size 1, which no row steps along, aside).
bool rows_aligned(const void* p, const Bsh& t, int64_t esize, int nb,
                  int ns, int nh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (nb == 1 || t.b * esize % 16 == 0) &&
         (ns == 1 || t.s * esize % 16 == 0) &&
         (nh == 1 || t.h * esize % 16 == 0);
}

template <typename T>
int fwd_short_hd(int hd, const void* q, const void* k, const void* v,
                 void* o, float* lse, const Dims& s, const Bsh (&st)[4],
                 cudaStream_t stream) {
  const void* ptrs[4] = {q, k, v, o};
  for (int t = 0; t < 4; ++t) {
    const bool kv = t == 1 || t == 2;
    if (!rows_aligned(ptrs[t], st[t], sizeof(T), s.B, kv ? s.Sk : s.Sq,
                      kv ? s.K : s.H)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  switch (hd) {
    case 8: return fwd_short<T, 8>(q, k, v, o, lse, s, st, stream);
    case 16: return fwd_short<T, 16>(q, k, v, o, lse, s, st, stream);
    case 32: return fwd_short<T, 32>(q, k, v, o, lse, s, st, stream);
    case 64: return fwd_short<T, 64>(q, k, v, o, lse, s, st, stream);
    case 128: return fwd_short<T, 128>(q, k, v, o, lse, s, st, stream);
    case 256: return fwd_short<T, 256>(q, k, v, o, lse, s, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd_short_hd(int hd, const void* q, const void* k, const void* v,
                 const void* o, const float* lse, const void* dout, void* dq,
                 void* dk, void* dv, const Dims& s, const Bsh (&st)[8],
                 cudaStream_t stream) {
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  for (int t = 0; t < 8; ++t) {
    const bool kv = t == 1 || t == 2 || t == 6 || t == 7;
    if (!rows_aligned(ptrs[t], st[t], sizeof(T), s.B, kv ? s.Sk : s.Sq,
                      kv ? s.K : s.H)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  switch (hd) {
    case 8:
      return bwd_short<T, 8>(q, k, v, o, lse, dout, dq, dk, dv, s, st, stream);
    case 16:
      return bwd_short<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, s, st,
                              stream);
    case 32:
      return bwd_short<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, s, st,
                              stream);
    case 64:
      return bwd_short<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, s, st,
                              stream);
    case 128:
      return bwd_short<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, s, st,
                               stream);
    case 256:
      return bwd_short<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, s, st,
                               stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------- launch

// Rows a block takes: at most Tile::ROWS, fewer for short sequences (the
// block's threads are rows * TPR).
template <int HD>
int block_rows(int seq) {
  const int r = ((seq + 7) / 8) * 8;
  return r < Tile<HD>::ROWS ? r : Tile<HD>::ROWS;
}

template <typename T, int HD>
void fwd(const void* q, const void* k, const void* v, void* o, float* lse,
         const Dims& s, cudaStream_t stream) {
  const int bq = block_rows<HD>(s.Sq);
  const int64_t blocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + bq - 1) / bq);
  flash_fwd_kernel<T, HD><<<static_cast<unsigned>(blocks),
                            bq * Tile<HD>::TPR, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s, bq);
}

template <typename T, int HD>
void bwd(const void* q, const void* k, const void* v, const void* o,
         const float* lse, const void* dout, void* dq, void* dk, void* dv,
         float* delta, const Dims& s, cudaStream_t stream) {
  constexpr int TPR = Tile<HD>::TPR;
  const int64_t rows = static_cast<int64_t>(s.B) * s.H * s.Sq;
  const int per = 256 / TPR;
  flash_delta_kernel<T, HD><<<static_cast<unsigned>((rows + per - 1) / per),
                              per * TPR, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  const int bk = block_rows<HD>(s.Sk);
  const int64_t kblocks =
      static_cast<int64_t>(s.B) * s.K * ((s.Sk + bk - 1) / bk);
  flash_dkdv_kernel<T, HD><<<static_cast<unsigned>(kblocks), bk * TPR, 0,
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), s, bk);
  const int bq = block_rows<HD>(s.Sq);
  const int64_t qblocks =
      static_cast<int64_t>(s.B) * s.H * ((s.Sq + bq - 1) / bq);
  flash_dq_kernel<T, HD><<<static_cast<unsigned>(qblocks), bq * TPR, 0,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), s, bq);
}

template <typename T>
int fwd_hd(int hd, const void* q, const void* k, const void* v, void* o,
           float* lse, const Dims& s, cudaStream_t stream) {
  switch (hd) {
    case 8: fwd<T, 8>(q, k, v, o, lse, s, stream); break;
    case 16: fwd<T, 16>(q, k, v, o, lse, s, stream); break;
    case 32: fwd<T, 32>(q, k, v, o, lse, s, stream); break;
    case 64: fwd<T, 64>(q, k, v, o, lse, s, stream); break;
    case 128: fwd<T, 128>(q, k, v, o, lse, s, stream); break;
    case 256: fwd<T, 256>(q, k, v, o, lse, s, stream); break;
    default:
      return wide_width(hd) ? fwd_wide<T>(hd, q, k, v, o, lse, s, stream)
                            : static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_hd(int hd, const void* q, const void* k, const void* v,
           const void* o, const float* lse, const void* dout, void* dq,
           void* dk, void* dv, float* delta, const Dims& s,
           cudaStream_t stream) {
  switch (hd) {
    case 8: bwd<T, 8>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    case 16: bwd<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    case 32: bwd<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    case 64: bwd<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    case 128:
      bwd<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    case 256:
      bwd<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, s, stream);
      break;
    default:
      return wide_width(hd) ? bwd_wide<T>(hd, q, k, v, o, lse, dout, dq, dk,
                                          dv, delta, s, stream)
                            : static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

Dims make_dims(int B, int H, int K, int Sq, int Sk, int causal, int window,
               float scale) {
  Dims s;
  s.B = B;
  s.H = H;
  s.K = K;
  s.Sq = Sq;
  s.Sk = Sk;
  s.causal = causal;
  s.window = window;
  s.scale = scale;
  return s;
}

}  // namespace

// C interface, loaded with ctypes. q, o: (B, H, Sq, hd); k, v: (B, K, Sk,
// hd), all row-major in one type (bf16 selects bfloat16, else float32);
// lse: (B, H, Sq) float32. `scale` is the scores' scale, the true head
// dim's hd^-0.5 rounded to float32 (the wrapper zero-pads hd). hd must be
// 8, 16, 32, 64, 128 or 256, or a multiple of 256 up to 28,928; H a
// multiple of K. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int K,
                                int Sq, int Sk, int hd, int causal,
                                int window, float scale, int bf16,
                                void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const Dims s = make_dims(B, H, K, Sq, Sk, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return bf16 ? fwd_hd<__nv_bfloat16>(hd, q, k, v, o, l, s, st)
              : fwd_hd<float>(hd, q, k, v, o, l, s, st);
}

// Gradients for the cotangent dout (like o): dq like q, dk and dv like k;
// delta: (B, H, Sq) float32 workspace.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* lse,
                                const void* dout, void* dq, void* dk,
                                void* dv, void* delta, int B, int H, int K,
                                int Sq, int Sk, int hd, int causal,
                                int window, float scale, int bf16,
                                void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const Dims s = make_dims(B, H, K, Sq, Sk, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  return bf16 ? bwd_hd<__nv_bfloat16>(hd, q, k, v, o, l, dout, dq, dk, dv,
                                      d, s, st)
              : bwd_hd<float>(hd, q, k, v, o, l, dout, dq, dk, dv, d, s, st);
}

// The short-sequence kernels' one argument (see the section "short
// sequences"), as the wrapper packs it (`kernel.py::SHORT_ARGS`): 8-byte
// fields, unused ones 0. A block of fields costs the ctypes call a
// fraction of what as many separate arguments would.
struct ShortArgs {
  uint64_t ptr[9];   // q, k, v, o, lse, dout, dq, dk, dv (forward: 5)
  int64_t B, H, K, Sq, Sk, hd, causal, window, bf16;
  uint64_t stream;
  double scale;      // rounded to float32 here, as flash_fwd_launch's
  int64_t st[8][3];  // batch, sequence and head strides, in elements, of
                     // q, k, v, o, dout, dq, dk, dv (forward: 4)
};
static_assert(sizeof(ShortArgs) == 44 * 8, "the wrapper's SHORT_ARGS");

// The short-sequence kernels (one warp a (b, kv head) unit): each tensor
// viewed as (batch, sequence, head, hd) through its strides - q, o, dout
// and dq (B, Sq, H, hd), k, v, dk and dv (B, Sk, K, hd) - in any order of
// their first three dims, hd contiguous and every row on 16 bytes (else
// cudaErrorMisalignedAddress). hd is 8, 16, 32, 64, 128 or 256, and the
// unit's shared memory must fit a block (the wrapper sends only units
// within kShortBudget); lse (B, H, Sq) float32, contiguous; the rest as
// in flash_fwd_launch. The forward reads q, k, v and writes o and lse.
extern "C" int flash_fwd_short_launch(const void* packed) {
  ShortArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  const Dims s = make_dims(
      static_cast<int>(a.B), static_cast<int>(a.H), static_cast<int>(a.K),
      static_cast<int>(a.Sq), static_cast<int>(a.Sk),
      static_cast<int>(a.causal), static_cast<int>(a.window),
      static_cast<float>(a.scale));
  Bsh st[4];
  for (int t = 0; t < 4; ++t) st[t] = {a.st[t][0], a.st[t][1], a.st[t][2]};
  void* p[5];
  for (int t = 0; t < 5; ++t) p[t] = reinterpret_cast<void*>(a.ptr[t]);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(a.stream);
  float* l = static_cast<float*>(p[4]);
  const int hd = static_cast<int>(a.hd);
  return a.bf16
             ? fwd_short_hd<__nv_bfloat16>(hd, p[0], p[1], p[2], p[3], l, s,
                                           st, cs)
             : fwd_short_hd<float>(hd, p[0], p[1], p[2], p[3], l, s, st, cs);
}

// The one-launch backward of the short-sequence kernels: reads q, k, v, o,
// lse and dout, writes dq in its own strides (q's layout as the wrapper
// allocates it) and dk and dv in theirs; no delta workspace.
extern "C" int flash_bwd_short_launch(const void* packed) {
  ShortArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0) return 0;
  const Dims s = make_dims(
      static_cast<int>(a.B), static_cast<int>(a.H), static_cast<int>(a.K),
      static_cast<int>(a.Sq), static_cast<int>(a.Sk),
      static_cast<int>(a.causal), static_cast<int>(a.window),
      static_cast<float>(a.scale));
  Bsh st[8];
  for (int t = 0; t < 8; ++t) st[t] = {a.st[t][0], a.st[t][1], a.st[t][2]};
  void* p[9];
  for (int t = 0; t < 9; ++t) p[t] = reinterpret_cast<void*>(a.ptr[t]);
  cudaStream_t cs = reinterpret_cast<cudaStream_t>(a.stream);
  const float* l = static_cast<const float*>(p[4]);
  const int hd = static_cast<int>(a.hd);
  return a.bf16 ? bwd_short_hd<__nv_bfloat16>(hd, p[0], p[1], p[2], p[3], l,
                                              p[5], p[6], p[7], p[8], s, st,
                                              cs)
                : bwd_short_hd<float>(hd, p[0], p[1], p[2], p[3], l, p[5],
                                      p[6], p[7], p[8], s, st, cs);
}
