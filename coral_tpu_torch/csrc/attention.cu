// Bidirectional attention forward on the flat (B, T, H*d) layout, with the
// q/k/v projection biases added in the kernel; writes o and the per-head lse.
//
// Replaces: coral_tpu/ops/attention_pallas.py `_fwd_pallas_stats_v2_qb` /
// `_fwd_kernel_stats_v2_qb` (the v3-stats forward with in-kernel q/k/v biases,
// the wav2vec2 serving default).
//
// Bound on the H100: the tensor cores and the fp32 softmax between the two
// products (T^2 * d * 4 flops and T^2 exponentials per head); q/k/v/o are
// only 4 * T * d * 2 bytes per head. The TPU kernel keeps the whole (T, T)
// score tile on chip, which does not fit a Hopper SM at T = 1499.
//
// Design: one block per (64-query tile, head, batch row), four warps of 16
// query rows each. The block walks 64-key tiles with an online softmax in fp32,
// so nothing of size T x T exists anywhere. Head h is the lane slice
// h*d .. h*d+d-1 of each row, read through the row strides; no (B, H, T, d)
// copy is made. Every kernel is a template over the head dim d, built for the
// repository's three: 64 (XLS-R-300M), 80 (XLS-R-1B) and 120 (XLS-R-2B). The
// tiles in shared memory hold d padded with zero columns to DP, the next
// multiple of WMMA's k = 16 (120 -> 128): exact for q k^T, and P @ V then
// computes DP - d columns that are never written, so a head writes nothing
// past its d columns (the next head starts there). On load q, k, v get their
// bias added and rounded to bf16, and q is then scaled and rounded again, in
// the JAX kernel's order (80**-0.5 and 120**-0.5 are not exact in bf16, so
// the order shows). Padded keys carry the caller's finite -1e30 bias, so a row
// whose keys are all padded comes out as the uniform average (not NaN), as in
// the JAX kernel; keys past T in the last tile get -inf and contribute exactly
// 0. Scores and P @ V go through bf16 WMMA fragments; the fragments are staged
// in shared memory where two lanes share each query row for the softmax and
// the rescaled running output (DP / 2 columns a lane).
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

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
  static constexpr int kStats = 3 * 64 * 4 + 4 * kDP * 4;  // lse, delta, key bias; colsums
  static constexpr int kDkdvSmem = 4 * kBQ * kLdH * 2 + 2 * kBQ * kLdP * 2 + kBQ * kLdS * 4 + kStats;
  static constexpr int kDqSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdP * 2 + kBQ * kLdS * 4 + kStats;
  static_assert(kFwdSmem <= kMaxSmem && kDkdvSmem <= kMaxSmem && kDqSmem <= kMaxSmem,
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

// q, k, v: (B, T, H*D) bf16 with strides (stride_b, stride_t, 1), the same for
// all three; bq, bk, bv: (H*D,) bf16 (kBias, else not read); key_bias: (B, T)
// fp32 (0 or -1e30); o: (B, T, H*D) bf16 contiguous; lse: (B, H, T) fp32.
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ bq,
                         const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                         const float* __restrict__ key_bias, bf16* __restrict__ o,
                         float* __restrict__ lse, int T, int H, long long stride_b,
                         long long stride_t, float scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS, kHalf = Hd::kHalf;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Ps = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kLdP);
  float* kbias = Ss + kBQ * kLdS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;   // this lane's query row within the warp's 16
  const int half = lane & 1;   // and which half of the keys (and of the head) it handles
  const long long head = (long long)b * stride_b + h * D;

  load_tile<D, kBias>(Qs, q + head, bq + h * D, q0, T, stride_t, scale);

  float m = -INFINITY;  // running max of this row's scores
  float l = 0.0f;       // running sum of exp(score - m)
  float acc[kHalf];     // running sum of p * v for this lane's kHalf columns
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.0f;

  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  const bf16* Qw = Qs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile<D, kBias>(Ks, k + head, bk + h * D, k0, T, stride_t, 0.0f);
    load_tile<D, kBias>(Vs, v + head, bv + h * D, k0, T, stride_t, 0.0f);
    if (threadIdx.x < kBKV) {
      const int key = k0 + threadIdx.x;
      kbias[threadIdx.x] = key < T ? key_bias[(long long)b * T + key] : -INFINITY;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < Hd::kDP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Qw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc bt;
        wmma::load_matrix_sync(bt, Ks + (j * 16) * kLdH + kk, kLdH);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Sw + j * 16, s[j], kLdS, wmma::mem_row_major);
    __syncwarp();

    // Online softmax over this tile; two lanes per row, 32 keys each.
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sv[j] = Sw[row * kLdS + half * 32 + j] + kbias[half * 32 + j];
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: every tile holds a key < T
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
      Pw[row * kLdP + half * 32 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // P @ V for this warp's 16 rows, staged over S.
    FragC pv[Hd::kNF];
#pragma unroll
    for (int j = 0; j < Hd::kNF; ++j) wmma::fill_fragment(pv[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Pw + kk, kLdP);
#pragma unroll
      for (int j = 0; j < Hd::kNF; ++j) {
        FragBr bvf;
        wmma::load_matrix_sync(bvf, Vs + kk * kLdH + j * 16, kLdH);
        wmma::mma_sync(pv[j], a, bvf, pv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < Hd::kNF; ++j)
      wmma::store_matrix_sync(Sw + j * 16, pv[j], kLdS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] = acc[j] * alpha + Sw[row * kLdS + half * kHalf + j];
    __syncwarp();
  }

  const int t = q0 + warp * 16 + row;
  if (t < T) {
    float out[kHalf];
#pragma unroll
    for (int j = 0; j < kHalf; ++j) out[j] = acc[j] / l;
    bf16* orow = o + ((long long)b * T + t) * ((long long)H * D) + h * D + half * kHalf;
#pragma unroll
    for (int j = 0; j < kHalf; j += 8)
      if (half * kHalf + j < D) coral_store8(orow + j, out + j);
    // A fully padded row has m = -1e30; the clamp keeps the backward's
    // exp(s - lse) at 0 for it, as in the JAX kernel.
    if (half == 0) lse[((long long)b * H + h) * T + t] = fmaxf(m + logf(l), -1e25f);
  }
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/attention_pallas.py `_bwd_pallas_stats_ctx_qb` /
// `_bwd_kernel_stats_ctx_qb` (the v3 backward with in-kernel q/k/v biases):
// dq, dk, dv and the fp32 row sums of their bf16-rounded values (the bias
// gradients), from the forward's lse and o.
//
// Bound on the H100: the tensor cores (five T x T x d products per head, two
// more for dq's pass) and the exponentials; the (T, T) score tile the TPU
// kernel holds in VMEM does not fit an SM at T = 499 or 1499.
//
// Design: two kernels, neither with atomics, so the gradients are
// deterministic. The key-major kernel (one block per 64-key tile, head, batch
// row) walks the query tiles and accumulates dk and dv in registers, in the
// TPU kernel's transposed space (S^T = K Q^T). The query-major kernel walks
// the key tiles and accumulates dq; it rebuilds p and dp instead of summing
// dq across key blocks. Both rebuild p = exp(s + key_bias - lse) from the
// saved lse, exactly the TPU kernel's formula: a fully masked row has lse
// clamped at -1e25 and so p = 0 there, not the forward's uniform average.
// delta = rowsum(do * o) is computed per query tile from the saved o. Keys
// past T get -inf and queries past T get lse = +inf, so both have p = 0.
// Each block writes the column sums of its 64 rows of bf16-rounded dq (or dk,
// dv) as one partial; the sum over tiles and batch rows runs outside, as the
// JAX package sums its per-batch-row partials outside. The head dim is padded
// as in the forward; the padding columns of dq, dk, dv are neither written nor
// summed.
//
// Without biases (kBias = false) the kernels replace `_bwd_pallas_stats_ctx`
// / `_bwd_kernel_stats_ctx` (:348, :698): the same dq, dk, dv, no bias loads
// and no column sums. dq, dk and dv are written through their own row stride,
// so for q, k, v sliced from one packed (B, T, 3 H*D) projection they land in
// the lane thirds of one packed gradient, the projection's dy, with no copy.

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

// lse and delta = rowsum(do * o) of query rows q0 .. q0+63 (dOs already in
// shared memory); rows past T get lse = +inf and delta = 0. Two threads a row.
template <int D>
__device__ __forceinline__ void load_query_stats(float* lse_s, float* delta_s,
                                                 const float* lse_row, const bf16* dOs,
                                                 const bf16* o_head, int q0, int T,
                                                 long long stride_o) {
  using H = Head<D>;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float s = 0.f;
  if (q0 + r < T) {
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
  if (half == 0) {
    lse_s[r] = q0 + r < T ? lse_row[q0 + r] : INFINITY;
    delta_s[r] = s;
  }
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

// q, k, v, bq, bk, bv, key_bias as the forward; dout, o: (B, T, H*D) bf16
// contiguous; lse: (B, H, T) fp32; dk, dv: (B, T, H*D) bf16 with row stride
// stride_d (batch stride T stride_d); db_part (kBias): (B, nT, 3, H*D) fp32
// with nT = ceil(T / 64).
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ bq,
                              const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                              const float* __restrict__ key_bias, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const bf16* __restrict__ o,
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
  float* lse_s = Ss + kBQ * kLdS;
  float* delta_s = lse_s + 64;
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

  load_tile<D, kBias>(Ks, k + head, bk + h * D, k0, T, stride_t, 0.0f);
  load_tile<D, kBias>(Vs, v + head, bv + h * D, k0, T, stride_t, 0.0f);
  if (threadIdx.x < kBKV) {
    const int key = k0 + threadIdx.x;
    kb[threadIdx.x] = key < T ? key_bias[(long long)b * T + key] : -INFINITY;
  }

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
    load_query_stats<D>(lse_s, delta_s, lse + ((long long)b * H + h) * T, dOs, o + ohead, q0,
                        T, HD);
    __syncthreads();

    // S^T = K_w Q^T for this warp's 16 keys.
    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < Hd::kDP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Kw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc bt;
        wmma::load_matrix_sync(bt, Qs + (j * 16) * kLdH + kk, kLdH);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], kLdS, wmma::mem_row_major);
    __syncwarp();
    float p[32];
    const float kbr = kb[warp * 16 + row];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = expf(Sw[row * kLdS + c] + kbr - lse_s[c]);
      Pw[row * kLdP + c] = __float2bfloat16(p[j]);
    }
    __syncwarp();

    // dP^T = V_w dO^T.
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < Hd::kDP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Vw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc bt;
        wmma::load_matrix_sync(bt, dOs + (j * 16) * kLdH + kk, kLdH);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], kLdS, wmma::mem_row_major);
    __syncwarp();
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
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ bq,
                            const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                            const float* __restrict__ key_bias, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const bf16* __restrict__ o,
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
  float* lse_s = Ss + kBQ * kLdS;
  float* delta_s = lse_s + 64;
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

  load_tile<D, kBias>(Qs, q + head, bq + h * D, q0, T, stride_t, scale);
  load_rows<D>(dOs, dout + ohead, q0, T, HD);
  __syncthreads();
  load_query_stats<D>(lse_s, delta_s, lse + ((long long)b * H + h) * T, dOs, o + ohead, q0, T,
                      HD);

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
    if (threadIdx.x < kBKV) {
      const int key = k0 + threadIdx.x;
      kb[threadIdx.x] = key < T ? key_bias[(long long)b * T + key] : -INFINITY;
    }
    __syncthreads();
    const float lse_r = lse_s[warp * 16 + row];
    const float delta_r = delta_s[warp * 16 + row];

    // S = Q_w K^T.
    FragC s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < Hd::kDP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Qw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc bt;
        wmma::load_matrix_sync(bt, Ks + (j * 16) * kLdH + kk, kLdH);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], kLdS, wmma::mem_row_major);
    __syncwarp();
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = expf(Sw[row * kLdS + c] + kb[c] - lse_r);
    }
    __syncwarp();

    // dP = dO_w V^T.
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(s[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < Hd::kDP; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, dOw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBc bt;
        wmma::load_matrix_sync(bt, Vs + (j * 16) * kLdH + kk, kLdH);
        wmma::mma_sync(s[j], a, bt, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, s[j], kLdS, wmma::mem_row_major);
    __syncwarp();
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

template <int D, bool kBias>
int launch_bwd(const bf16* qp, const bf16* kp, const bf16* vp, const bf16* bqp, const bf16* bkp,
               const bf16* bvp, const float* kbp, const bf16* dop, const float* lp,
               const bf16* op, bf16* dq, bf16* dk, bf16* dv, float* dbp, int B, int T, int H,
               long long stride_b, long long stride_t, long long stride_d, float scale,
               float sm_scale, cudaStream_t s) {
  using Hd = Head<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Hd::kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<D, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Hd::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  attention_bwd_dkdv_kernel<D, kBias><<<grid, kThreads, Hd::kDkdvSmem, s>>>(
      qp, kp, vp, bqp, bkp, bvp, kbp, dop, lp, op, dk, dv, dbp, T, H, stride_b, stride_t,
      stride_d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<D, kBias><<<grid, kThreads, Hd::kDqSmem, s>>>(
      qp, kp, vp, bqp, bkp, bvp, kbp, dop, lp, op, dq, dbp, T, H, stride_b, stride_t, stride_d,
      scale, sm_scale);
  return (int)cudaGetLastError();
}

template <int D, bool kBias>
int launch_fwd(const bf16* qp, const bf16* kp, const bf16* vp, const bf16* bqp, const bf16* bkp,
               const bf16* bvp, const float* kbp, bf16* op, float* lp, int B, int T, int H,
               long long stride_b, long long stride_t, float scale, cudaStream_t s) {
  using Hd = Head<D>;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<D, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Hd::kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  attention_fwd_kernel<D, kBias><<<grid, kThreads, Hd::kFwdSmem, s>>>(
      qp, kp, vp, bqp, bkp, bvp, kbp, op, lp, T, H, stride_b, stride_t, scale);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, D>{}, std::integral_constant<bool, kBias>{})
// for a built head dim D (64, 80, 120); returns -1 for any other.
template <typename Fn>
int with_head(int D, bool bias, Fn&& f) {
  auto on = [&](auto d) {
    return bias ? f(d, std::integral_constant<bool, true>{})
                : f(d, std::integral_constant<bool, false>{});
  };
  switch (D) {
    case 64: return on(std::integral_constant<int, 64>{});
    case 80: return on(std::integral_constant<int, 80>{});
    case 120: return on(std::integral_constant<int, 120>{});
    default: return -1;
  }
}

}  // namespace

// Launches both backward kernels on `stream` at head dim D (64, 80 or 120),
// with the q/k/v biases when bq is not null (then bk, bv and db_part are
// read and written too), else without (the three and db_part are not read).
// dq, dk, dv: (B, T, H*D) bf16 each with row stride stride_d. scale is the
// bf16-rounded score scale applied to q (+ bq) (as the forward); sm_scale
// the fp32 one dq is multiplied by (as the JAX kernel). Returns the
// cudaError_t of the launches, or -1 for a head dim they were not built for.
extern "C" int coral_attention_bwd(const void* q, const void* k, const void* v, const void* bq,
                                   const void* bk, const void* bv, const void* key_bias,
                                   const void* dout, const void* lse, const void* o, void* dq,
                                   void* dk, void* dv, void* db_part, int B, int T, int H, int D,
                                   long long stride_b, long long stride_t, long long stride_d,
                                   float scale, float sm_scale, void* stream) {
  if (D != 64 && D != 80 && D != 120) return -1;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *bqp = static_cast<const bf16*>(bq),
             *bkp = static_cast<const bf16*>(bk), *bvp = static_cast<const bf16*>(bv),
             *dop = static_cast<const bf16*>(dout), *op = static_cast<const bf16*>(o);
  const float* kbp = static_cast<const float*>(key_bias);
  const float* lp = static_cast<const float*>(lse);
  float* dbp = static_cast<float*>(db_part);
  bf16 *dqp = static_cast<bf16*>(dq), *dkp = static_cast<bf16*>(dk),
       *dvp = static_cast<bf16*>(dv);
  return with_head(D, bqp != nullptr, [&](auto d, auto bias) {
    return launch_bwd<decltype(d)::value, decltype(bias)::value>(
        qp, kp, vp, bqp, bkp, bvp, kbp, dop, lp, op, dqp, dkp, dvp, dbp, B, T, H, stride_b,
        stride_t, stride_d, scale, sm_scale, s);
  });
}

// The forward at head dim D (64, 80 or 120), with the q/k/v biases when bq is
// not null, else without. Returns the cudaError_t of the launch, or -1 for a
// head dim it was not built for.
extern "C" int coral_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bq, const void* bk, const void* bv,
                                   const void* key_bias, void* o, void* lse, int B, int T,
                                   int H, int D, long long stride_b, long long stride_t,
                                   float scale, void* stream) {
  if (D != 64 && D != 80 && D != 120) return -1;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *bqp = static_cast<const bf16*>(bq),
             *bkp = static_cast<const bf16*>(bk), *bvp = static_cast<const bf16*>(bv);
  const float* kbp = static_cast<const float*>(key_bias);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  return with_head(D, bqp != nullptr, [&](auto d, auto bias) {
    return launch_fwd<decltype(d)::value, decltype(bias)::value>(
        qp, kp, vp, bqp, bkp, bvp, kbp, op, lp, B, T, H, stride_b, stride_t, scale, s);
  });
}
