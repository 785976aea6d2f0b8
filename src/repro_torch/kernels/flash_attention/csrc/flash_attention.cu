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
// the CUDA cores (no tensor cores: the transformer payload's S = 8,
// hd = 8 are below any tensor-core tile), so its floor there is the
// float32 rate, ~15x slower. At the payload's shapes a call moves ~1 MB
// and launch latency sets its time.
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
// other side staged in shared memory. head dims 8, 16, 32, 64 and 128 are
// instantiated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
    default: return static_cast<int>(cudaErrorInvalidValue);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
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
// lse: (B, H, Sq) float32. `scale` is hd^-0.5 rounded to float32.
// hd must be 8, 16, 32, 64 or 128, H a multiple of K. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
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
