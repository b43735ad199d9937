// Bidirectional attention forward on the flat (B, T, H*64) layout, with the
// q/k/v projection biases added in the kernel; writes o and the per-head lse.
//
// Replaces: coral_tpu/ops/attention_pallas.py `_fwd_pallas_stats_v2_qb` /
// `_fwd_kernel_stats_v2_qb` (the v3-stats forward with in-kernel q/k/v biases,
// the wav2vec2 serving default).
//
// Bound on the H100: the tensor cores and the fp32 softmax between the two
// products (T^2 * 64 * 4 flops and T^2 exponentials per head); q/k/v/o are
// only 4 * T * 64 * 2 bytes per head. The TPU kernel keeps the whole (T, T)
// score tile on chip, which does not fit a Hopper SM at T = 1499.
//
// Design: one block per (64-query tile, head, batch row), four warps of 16
// query rows each. The block walks 64-key tiles with an online softmax in fp32,
// so nothing of size T x T exists anywhere. Head h is the lane slice
// h*64 .. h*64+63 of each row, read through the row strides; no (B, H, T, d)
// copy is made. On load q, k, v get their bias added and rounded to bf16, and
// q is then scaled and rounded again, in the JAX kernel's order. Padded keys
// carry the caller's finite -1e30 bias, so a row whose keys are all padded
// comes out as the uniform average (not NaN), as in the JAX kernel; keys past
// T in the last tile get -inf and contribute exactly 0. Scores and P @ V go
// through bf16 WMMA fragments; the fragments are staged in shared memory where
// two lanes share each query row for the softmax and the rescaled running
// output.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // queries per block
constexpr int kBKV = 64;      // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kLdH = kD + 8;   // bf16 row pitch of the Q, K, V and P tiles
constexpr int kLdS = kBKV + 4;  // fp32 row pitch of the staged S and P @ V
constexpr int kSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdS * 4 + kBKV * 4;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Loads a 64 x 64 tile of rows r0.. of one head, adds the bias and rounds to
// bf16, then (scale != 0) multiplies by scale and rounds again; rows at or past
// T are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, const bf16* bvec,
                                          int r0, int T, long long stride_t, float scale) {
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    float f[8];
    if (r0 + r < T) {
      float bb[8];
      coral_load8(src + (long long)(r0 + r) * stride_t + c, f);
      coral_load8(bvec + c, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[e] = coral_round_bf16(f[e] + bb[e]);
        if (scale != 0.0f) f[e] = coral_round_bf16(f[e] * scale);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.0f;
    }
    coral_store8(dst + r * kLdH + c, f);
  }
}

// q, k, v: (B, T, H*64) bf16 with strides (stride_b, stride_t, 1), the same for
// all three; bq, bk, bv: (H*64,) bf16; key_bias: (B, T) fp32 (0 or -1e30);
// o: (B, T, H*64) bf16 contiguous; lse: (B, H, T) fp32.
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ bq,
                         const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                         const float* __restrict__ key_bias, bf16* __restrict__ o,
                         float* __restrict__ lse, int T, int H, long long stride_b,
                         long long stride_t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Ps = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kLdH);
  float* kbias = Ss + kBQ * kLdS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;   // this lane's query row within the warp's 16
  const int half = lane & 1;   // and which 32 of the 64 columns it handles
  const long long head = (long long)b * stride_b + h * kD;

  load_tile(Qs, q + head, bq + h * kD, q0, T, stride_t, scale);

  float m = -INFINITY;  // running max of this row's scores
  float l = 0.0f;       // running sum of exp(score - m)
  float acc[32];        // running sum of p * v for this lane's 32 columns
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdH;
  const bf16* Qw = Qs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile(Ks, k + head, bk + h * kD, k0, T, stride_t, 0.0f);
    load_tile(Vs, v + head, bv + h * kD, k0, T, stride_t, 0.0f);
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
    for (int kk = 0; kk < kD; kk += 16) {
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

    // Online softmax over this tile; two lanes per row.
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
      Pw[row * kLdH + half * 32 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // P @ V for this warp's 16 rows, staged over S.
    FragC pv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(pv[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kBKV; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Pw + kk, kLdH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBr bvf;
        wmma::load_matrix_sync(bvf, Vs + kk * kLdH + j * 16, kLdH);
        wmma::mma_sync(pv[j], a, bvf, pv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Sw + j * 16, pv[j], kLdS, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = acc[j] * alpha + Sw[row * kLdS + half * 32 + j];
    __syncwarp();
  }

  const int t = q0 + warp * 16 + row;
  if (t < T) {
    float out[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) out[j] = acc[j] / l;
    bf16* orow = o + ((long long)b * T + t) * ((long long)H * kD) + h * kD + half * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 8) coral_store8(orow + j, out + j);
    // A fully padded row has m = -1e30; the clamp keeps the backward's
    // exp(s - lse) at 0 for it, as in the JAX kernel.
    if (half == 0) lse[((long long)b * H + h) * T + t] = fmaxf(m + logf(l), -1e25f);
  }
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int coral_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bq, const void* bk, const void* bv,
                                   const void* key_bias, void* o, void* lse, int B, int T,
                                   int H, long long stride_b, long long stride_t,
                                   float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  attention_fwd_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bq), static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
      static_cast<const float*>(key_bias), static_cast<bf16*>(o), static_cast<float*>(lse), T,
      H, stride_b, stride_t, scale);
  return (int)cudaGetLastError();
}
