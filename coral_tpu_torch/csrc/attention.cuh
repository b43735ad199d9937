// The short-T attention's shared pieces: tile shapes by head dim, tile loads,
// the WMMA score product, and the two backward kernels, which
// `attention.cu` (the v3 backward) and `attention_rows.cu` (the backwards of
// the other variants) instantiate; `flash_attention.cu` builds its kernels on
// the same tiles, loads, score product and row stores.
//
// Layout: q, k, v are (B, T, H*d) with strides (stride_b, stride_t, 1), the
// same for all three; head h is the lane slice h*d .. h*d+d-1 of each row,
// read through the row strides, so no (B, H, T, d) copy is made. Every kernel
// is a template over the head dim d, built for the repository's three: 64
// (XLS-R-300M), 80 (XLS-R-1B) and 120 (XLS-R-2B). The tiles in shared memory
// hold d padded with zero columns to DP, the next multiple of WMMA's k = 16
// (120 -> 128): exact for q k^T, and products with V then compute DP - d
// columns that are never written, so a head writes nothing past its d columns
// (the next head starts there). q, k, v get their bias added (where the
// kernel has one) and rounded to bf16 on load, and q is then scaled and
// rounded again, in the JAX kernels' order (80**-0.5 and 120**-0.5 are not
// exact in bf16, so the order shows). Padded keys carry the caller's finite
// -1e30 bias; keys past T in the last tile get -inf and contribute exactly 0.
#pragma once

#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;        // queries per block
constexpr int kBKV = 64;       // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kLdP = kBKV + 8;  // bf16 row pitch of the P and dS tiles (64 wide)
constexpr int kMaxSmem = 232448;

// The shapes that follow from head dim D.
template <int D>
struct Head {
  static_assert(D % 8 == 0, "a head is whole 16-byte chunks");
  static constexpr int kDP = (D + 15) / 16 * 16;  // padded to WMMA's k
  static constexpr int kLdH = kDP + 8;            // bf16 pitch of the Q, K, V, dO tiles
  static constexpr int kLdS = (kDP > kBKV ? kDP : kBKV) + 4;  // fp32 pitch of staged S, P@V
  static constexpr int kNF = kDP / 16;            // 16-wide fragments across the head
  static constexpr int kHalf = kDP / 2;           // columns of each of a row's two lanes
  static constexpr int kChunks = kDP / 8;         // 8-value chunks of a tile row
  static constexpr int kFwdSmem = 3 * kBQ * kLdH * 2 + kBQ * kLdP * 2 + kBQ * kLdS * 4 + kBKV * 4;
  // Query rows' stats (lse or m, l, delta), key bias; the column sums.
  static constexpr int kStats = 4 * 64 * 4 + 4 * kDP * 4;
  static constexpr int kDkdvSmem = 4 * kBQ * kLdH * 2 + 2 * kBQ * kLdP * 2 + kBQ * kLdS * 4 + kStats;
  static constexpr int kDqSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdP * 2 + kBQ * kLdS * 4 + kStats;
  static constexpr int kRowsSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdS * 4 + kBKV * 4;
  static_assert(kFwdSmem <= kMaxSmem && kDkdvSmem <= kMaxSmem && kDqSmem <= kMaxSmem &&
                    kRowsSmem <= kMaxSmem,
                "each kernel's tiles must fit a block's shared memory");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Loads a 64 x DP tile of rows r0.. of one head, adds the bias (kBias) and
// rounds to bf16, then (scale != 0) multiplies by scale and rounds again; rows
// at or past T and the padding columns d .. DP-1 are zero.
template <int D, bool kBias>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, const bf16* bvec,
                                          int r0, int T, long long stride_t, float scale) {
  using H = Head<D>;
  for (int i = threadIdx.x; i < 64 * H::kChunks; i += kThreads) {
    const int r = i / H::kChunks;
    const int c = (i % H::kChunks) * 8;
    float f[8];
    if (r0 + r < T && c < D) {
      coral_load8(src + (long long)(r0 + r) * stride_t + c, f);
      if constexpr (kBias) {
        float bb[8];
        coral_load8(bvec + c, bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = coral_round_bf16(f[e] + bb[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (scale != 0.0f) f[e] = coral_round_bf16(f[e] * scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    }
    coral_store8(dst + r * H::kLdH + c, f);
  }
}

// Rows r0 .. r0+63 of one head without a bias; rows at or past T and the
// padding columns are zero.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int T,
                                          long long stride_t) {
  using H = Head<D>;
  for (int i = threadIdx.x; i < 64 * H::kChunks; i += kThreads) {
    const int r = i / H::kChunks;
    const int c = (i % H::kChunks) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T && c < D)
      u = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * H::kLdH + c) = u;
  }
}

// The key bias of keys k0 .. k0+63 (-inf past T), by the block's first 64 threads.
__device__ __forceinline__ void load_key_bias(float* kb, const float* key_bias_row, int k0,
                                              int T) {
  if (threadIdx.x < kBKV) {
    const int key = k0 + threadIdx.x;
    kb[threadIdx.x] = key < T ? key_bias_row[key] : -INFINITY;
  }
}

// One warp's 16 x 64 fp32 product A_w B^T, staged into Sw (pitch kLdS): A_w
// is the warp's 16 rows of a tile, B a 64-row tile, both DP wide (pitch
// kLdH). Sw is complete for every lane of the warp on return.
template <int D>
__device__ __forceinline__ void product_abt(float* Sw, const bf16* Aw, const bf16* B) {
  using H = Head<D>;
  FragC s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < H::kDP; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, Aw + kk, H::kLdH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc bt;
      wmma::load_matrix_sync(bt, B + (j * 16) * H::kLdH + kk, H::kLdH);
      wmma::mma_sync(s[j], a, bt, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], H::kLdS, wmma::mem_row_major);
  __syncwarp();
}

// --- Backward ------------------------------------------------------------------
//
// Two kernels, neither with atomics, so the gradients are deterministic. The
// key-major kernel (one block per 64-key tile, head, batch row) walks the
// query tiles and accumulates dk and dv in registers, in the TPU kernels'
// transposed space (S^T = K Q^T). The query-major kernel walks the key tiles
// and accumulates dq; it rebuilds p and dp instead of summing dq across key
// blocks. Bound on the H100: the tensor cores (five T x T x d products per
// head, two more for dq's pass) and the exponentials; the (T, T) score tile
// the TPU kernels hold in VMEM does not fit an SM at T = 499 or 1499.
//
// p and delta come from per-query-row stats, by two template flags:
// - kML false: p = exp(s + key_bias - lse) from the saved lse, clamped at
//   -1e25 by the forward, so a fully masked row gets p = 0 (no gradient);
//   kML true: p = exp(s + key_bias - m) / l from the row max m and sum l of
//   the pre-pass (`attention_rows.cu`), with no clamp, as the TPU kernels
//   that recompute the softmax: a fully masked row has every s at -1e30
//   exactly, so s - m = 0 and p = 1/T, nonzero gradients ("uniform garbage",
//   as the JAX package calls them). m and l are kept apart and m is
//   subtracted first: exp(s - (m + log l)) cancels to p = 1 there.
// - kDeltaO true: delta = rowsum(do * o) per query tile from the saved o;
//   false: delta = sum_j p_ij dp_ij in fp32, written by the pre-pass.
// Queries past T get lse (or m) = +inf and so p = 0; keys past T get -inf.
//
// Each block writes the column sums of its 64 rows of bf16-rounded dq (or dk,
// dv) as one partial when the kernels take the q/k/v biases (kBias); the sum
// over tiles and batch rows runs outside, as the JAX package sums its
// per-batch-row partials outside. The padding columns of dq, dk, dv are
// neither written nor summed. dq, dk and dv are written through their own row
// stride, so for q, k, v sliced from one packed (B, T, 3 H*D) projection they
// land in the lane thirds of one packed gradient, the projection's dy, with no
// copy.

// The stats of query rows q0 .. q0+63 (dOs already in shared memory): a_s the
// lse (or m with kML), l_s the l (kML), delta_s either rowsum(do * o) from
// the saved o (kDeltaO) or the pre-pass's delta. Rows past T get a_s = +inf,
// l_s = 1 and delta_s = 0. Two threads a row.
template <int D, bool kML, bool kDeltaO>
__device__ __forceinline__ void load_query_stats(float* a_s, float* l_s, float* delta_s,
                                                 const float* a_row, const float* l_row,
                                                 const float* delta_row, const bf16* dOs,
                                                 const bf16* o_head, int q0, int T,
                                                 long long stride_o) {
  using H = Head<D>;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const bool valid = q0 + r < T;
  float s = 0.f;
  if constexpr (kDeltaO) {
    if (valid) {
#pragma unroll
      for (int j = 0; j < H::kHalf; j += 8) {
        const int c = half * H::kHalf + j;
        if (c >= D) break;
        float a[8], d[8];
        coral_load8(o_head + (long long)(q0 + r) * stride_o + c, a);
        coral_load8(dOs + r * H::kLdH + c, d);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += d[e] * a[e];
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
  } else if (valid) {
    s = delta_row[q0 + r];
  }
  if (half == 0) {
    a_s[r] = valid ? a_row[q0 + r] : INFINITY;
    if constexpr (kML) l_s[r] = valid ? l_row[q0 + r] : 1.f;
    delta_s[r] = s;
  }
}

// p from a score with its key bias, as kML says.
template <bool kML>
__device__ __forceinline__ float prob(float s_kb, float a, float l) {
  if constexpr (kML) return expf(s_kb - a) / l;
  return expf(s_kb - a);
}

// A warp's 16 x DP fp32 accumulators times `mul`, rounded to bf16, go to rows
// r0 + 16 warp .. of dst, columns 0 .. d-1 (rows at or past T are skipped);
// with kSum the column sums of the rounded values over the block's 64 rows go
// to part[0 .. d-1]. Called by every thread of the block.
template <int D, bool kSum>
__device__ __forceinline__ void store_rows(FragC (&acc)[Head<D>::kNF], float mul, float* Sw,
                                           float* red, bf16* dst, long long stride, int r0, int T,
                                           float* part) {
  using H = Head<D>;
  constexpr int kHalf = H::kHalf;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
#pragma unroll
  for (int j = 0; j < H::kNF; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc[j], H::kLdS, wmma::mem_row_major);
  __syncwarp();
  const int t = r0 + warp * 16 + row;
  float out[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j)
    out[j] = t < T ? coral_round_bf16(Sw[row * H::kLdS + half * kHalf + j] * mul) : 0.f;
  if (t < T) {
#pragma unroll
    for (int j = 0; j < kHalf; j += 8)
      if (half * kHalf + j < D)
        coral_store8(dst + (long long)t * stride + half * kHalf + j, out + j);
  }
  __syncwarp();
  if constexpr (kSum) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j) Sw[row * H::kLdS + half * kHalf + j] = out[j];
    __syncwarp();
    for (int c = lane; c < D; c += 32) {
      float cs = 0.f;
      for (int r = 0; r < 16; ++r) cs += Sw[r * H::kLdS + c];
      red[warp * H::kDP + c] = cs;
    }
    __syncthreads();
    if (threadIdx.x < D)
      part[threadIdx.x] = ((red[threadIdx.x] + red[H::kDP + threadIdx.x]) +
                           red[2 * H::kDP + threadIdx.x]) + red[3 * H::kDP + threadIdx.x];
    __syncthreads();
  }
}

// The per-query-row inputs of the backward kernels: stat_a the lse (B, H, T)
// or, with kML, m, stat_l l (kML), delta (B, H, T) fp32 (without kDeltaO).
struct RowStats {
  const float* a;
  const float* l;
  const float* delta;
};

// q, k, v, bq, bk, bv, key_bias as the forward; dout, o: (B, T, H*D) bf16
// contiguous (o read with kDeltaO); dk, dv: (B, T, H*D) bf16 with row stride
// stride_d (batch stride T stride_d); db_part (kBias): (B, nT, 3, H*D) fp32
// with nT = ceil(T / 64).
template <int D, bool kBias, bool kML, bool kDeltaO>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ bq,
                              const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                              const float* __restrict__ key_bias, const bf16* __restrict__ dout,
                              RowStats stats, const bf16* __restrict__ o,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              float* __restrict__ db_part, int T, int H, long long stride_b,
                              long long stride_t, long long stride_d, float scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS, kNF = Hd::kNF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBQ * kLdH;
  bf16* Qs = Vs + kBQ * kLdH;
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ps = dOs + kBQ * kLdH;
  bf16* dSs = Ps + kBQ * kLdP;
  float* Ss = reinterpret_cast<float*>(dSs + kBQ * kLdP);
  float* a_s = Ss + kBQ * kLdS;
  float* l_s = a_s + 64;
  float* delta_s = l_s + 64;
  float* kb = delta_s + 64;
  float* red = kb + 64;

  const int k0 = blockIdx.x * kBKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * stride_b + h * D;
  const long long ohead = (long long)b * T * HD + h * D;
  const long long dhead = (long long)b * T * stride_d + h * D;
  const long long srow = ((long long)b * H + h) * T;

  load_tile<D, kBias>(Ks, k + head, bk + h * D, k0, T, stride_t, 0.0f);
  load_tile<D, kBias>(Vs, v + head, bv + h * D, k0, T, stride_t, 0.0f);
  load_key_bias(kb, key_bias + (long long)b * T, k0, T);

  FragC dk_acc[kNF], dv_acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  bf16* dSw = dSs + warp * 16 * kLdP;
  const bf16* Kw = Ks + warp * 16 * kLdH;
  const bf16* Vw = Vs + warp * 16 * kLdH;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // the previous query tile is no longer read
    load_tile<D, kBias>(Qs, q + head, bq + h * D, q0, T, stride_t, scale);
    load_rows<D>(dOs, dout + ohead, q0, T, HD);
    __syncthreads();
    load_query_stats<D, kML, kDeltaO>(a_s, l_s, delta_s, stats.a + srow, stats.l + srow,
                                      stats.delta + srow, dOs, o + ohead, q0, T, HD);
    __syncthreads();

    // S^T = K_w Q^T for this warp's 16 keys.
    product_abt<D>(Sw, Kw, Qs);
    float p[32];
    const float kbr = kb[warp * 16 + row];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = prob<kML>(Sw[row * kLdS + c] + kbr, a_s[c], kML ? l_s[c] : 1.f);
      Pw[row * kLdP + c] = __float2bfloat16(p[j]);
    }
    __syncwarp();

    // dP^T = V_w dO^T.
    product_abt<D>(Sw, Vw, dOs);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdP + c] = __float2bfloat16(p[j] * (Sw[row * kLdS + c] - delta_s[c]));
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q.
#pragma unroll
    for (int kk = 0; kk < kBQ; kk += 16) {
      FragA ap, as;
      wmma::load_matrix_sync(ap, Pw + kk, kLdP);
      wmma::load_matrix_sync(as, dSw + kk, kLdP);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        FragBr bo, bqf;
        wmma::load_matrix_sync(bo, dOs + kk * kLdH + j * 16, kLdH);
        wmma::mma_sync(dv_acc[j], ap, bo, dv_acc[j]);
        wmma::load_matrix_sync(bqf, Qs + kk * kLdH + j * 16, kLdH);
        wmma::mma_sync(dk_acc[j], as, bqf, dk_acc[j]);
      }
    }
    __syncwarp();
  }

  float* part = kBias ? db_part + ((long long)b * gridDim.x + blockIdx.x) * 3 * HD + h * D
                      : nullptr;
  store_rows<D, kBias>(dk_acc, 1.0f, Sw, red, dk + dhead, stride_d, k0, T, kBias ? part + HD : part);
  store_rows<D, kBias>(dv_acc, 1.0f, Sw, red, dv + dhead, stride_d, k0, T,
                       kBias ? part + 2 * HD : part);
}

// As attention_bwd_dkdv_kernel, for dq (and the first third of db_part).
template <int D, bool kBias, bool kML, bool kDeltaO>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ bq,
                            const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                            const float* __restrict__ key_bias, const bf16* __restrict__ dout,
                            RowStats stats, const bf16* __restrict__ o,
                            bf16* __restrict__ dq, float* __restrict__ db_part, int T, int H,
                            long long stride_b, long long stride_t, long long stride_d,
                            float scale, float sm_scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS, kNF = Hd::kNF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ks = dOs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* dSs = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(dSs + kBQ * kLdP);
  float* a_s = Ss + kBQ * kLdS;
  float* l_s = a_s + 64;
  float* delta_s = l_s + 64;
  float* kb = delta_s + 64;
  float* red = kb + 64;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * stride_b + h * D;
  const long long ohead = (long long)b * T * HD + h * D;
  const long long dhead = (long long)b * T * stride_d + h * D;
  const long long srow = ((long long)b * H + h) * T;

  load_tile<D, kBias>(Qs, q + head, bq + h * D, q0, T, stride_t, scale);
  load_rows<D>(dOs, dout + ohead, q0, T, HD);
  __syncthreads();
  load_query_stats<D, kML, kDeltaO>(a_s, l_s, delta_s, stats.a + srow, stats.l + srow,
                                    stats.delta + srow, dOs, o + ohead, q0, T, HD);

  FragC dq_acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* dSw = dSs + warp * 16 * kLdP;
  const bf16* Qw = Qs + warp * 16 * kLdH;
  const bf16* dOw = dOs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D, kBias>(Ks, k + head, bk + h * D, k0, T, stride_t, 0.0f);
    load_tile<D, kBias>(Vs, v + head, bv + h * D, k0, T, stride_t, 0.0f);
    load_key_bias(kb, key_bias + (long long)b * T, k0, T);
    __syncthreads();
    const float a_r = a_s[warp * 16 + row];
    const float l_r = kML ? l_s[warp * 16 + row] : 1.f;
    const float delta_r = delta_s[warp * 16 + row];

    // S = Q_w K^T.
    product_abt<D>(Sw, Qw, Ks);
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = prob<kML>(Sw[row * kLdS + c] + kb[c], a_r, l_r);
    }
    __syncwarp();

    // dP = dO_w V^T.
    product_abt<D>(Sw, dOw, Vs);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdP + c] = __float2bfloat16(p[j] * (Sw[row * kLdS + c] - delta_r));
    }
    __syncwarp();

    // dQ += dS K.
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, dSw + kk, kLdP);
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        FragBr bkf;
        wmma::load_matrix_sync(bkf, Ks + kk * kLdH + j * 16, kLdH);
        wmma::mma_sync(dq_acc[j], a, bkf, dq_acc[j]);
      }
    }
    __syncwarp();
  }

  float* part = kBias ? db_part + ((long long)b * gridDim.x + blockIdx.x) * 3 * HD + h * D
                      : nullptr;
  store_rows<D, kBias>(dq_acc, sm_scale, Sw, red, dq + dhead, stride_d, q0, T, part);
}

// Launches the dkdv and dq kernels on `s`; returns the cudaError_t.
template <int D, bool kBias, bool kML, bool kDeltaO>
int launch_bwd(const bf16* qp, const bf16* kp, const bf16* vp, const bf16* bqp, const bf16* bkp,
               const bf16* bvp, const float* kbp, const bf16* dop, RowStats stats,
               const bf16* op, bf16* dq, bf16* dk, bf16* dv, float* dbp, int B, int T, int H,
               long long stride_b, long long stride_t, long long stride_d, float scale,
               float sm_scale, cudaStream_t s) {
  using Hd = Head<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, kBias, kML, kDeltaO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Hd::kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D, kBias, kML, kDeltaO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Hd::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  attention_bwd_dkdv_kernel<D, kBias, kML, kDeltaO><<<grid, kThreads, Hd::kDkdvSmem, s>>>(
      qp, kp, vp, bqp, bkp, bvp, kbp, dop, stats, op, dk, dv, dbp, T, H, stride_b, stride_t,
      stride_d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<D, kBias, kML, kDeltaO><<<grid, kThreads, Hd::kDqSmem, s>>>(
      qp, kp, vp, bqp, bkp, bvp, kbp, dop, stats, op, dq, dbp, T, H, stride_b, stride_t,
      stride_d, scale, sm_scale);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, D>{}) for a built head dim D (64, 80,
// 120); returns -1 for any other.
template <typename Fn>
int with_head_dim(int D, Fn&& f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 120: return f(std::integral_constant<int, 120>{});
    default: return -1;
  }
}

}  // namespace
