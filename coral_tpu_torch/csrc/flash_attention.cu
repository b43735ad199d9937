// Unmasked, non-causal self-attention forward over the flat (B, T, H*64)
// layout: o = softmax(q k^T * scale) v per head, for the Whisper encoder.
//
// Replaces: coral_tpu/ops/flash_attention.py `_flash` / `_fwd_cp` (JAX's stock
// TPU flash kernel, `flash_attention` with segment ids over T padded to the
// 512/768 grid), behind `flash_self_attention`; output o only (the row stats
// (l, m) of `_flash_res` belong to the training slice).
//
// Bound on the H100: the tensor cores and the fp32 softmax between the two
// products: 4 * T^2 * 64 flops and T^2 exponentials per head, against
// 4 * T * 64 * 2 bytes of q, k, v and o. At the encoder's T = 1500 that is
// about 750 flops per byte, far above the card's 295.
//
// Design: one block per (64-query tile, head, batch row), four warps of 16
// query rows each; the block walks 64-key tiles with an online softmax in
// fp32, so nothing of size T x T exists anywhere. Head h is the lane slice
// h*64 .. h*64+63 of each row, read through the row strides: no (B, H, T, d)
// copy is made. T need not be a multiple of the tile: keys at or past T get
// -inf in the last tile and contribute exactly 0 (the TPU wrapper pads T to
// its block grid and masks the padding with segment ids instead). As in the
// stock TPU kernel, scores are the bf16 product accumulated in fp32, then
// multiplied by the scale; the unnormalised probabilities are rounded to bf16
// for the product with V, and the sum is divided by the fp32 row sum at the
// end. Scores and P @ V go through bf16 WMMA fragments staged in shared memory,
// where two lanes share each query row for the softmax and the running output.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // queries per block
constexpr int kBKV = 64;        // keys per tile
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kLdH = kD + 8;    // bf16 row pitch of the Q, K, V and P tiles
constexpr int kLdS = kBKV + 4;  // fp32 row pitch of the staged S and P @ V
constexpr int kSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdS * 4;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Rows r0 .. r0+63 of one head into a 64 x 64 tile; rows at or past T are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int T,
                                          long long stride_t) {
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) u = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * kLdH + c) = u;
  }
}

// q, k, v: (B, T, H*64) bf16 with strides (stride_b, stride_t, 1), the same for
// all three; o: (B, T, H*64) bf16 contiguous.
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int T, int H,
                     long long stride_b, long long stride_t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Ps = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kLdH);

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;  // this lane's query row within the warp's 16
  const int half = lane & 1;  // and which 32 of the 64 columns it handles
  const long long head = (long long)b * stride_b + h * kD;

  load_rows(Qs, q + head, q0, T, stride_t);

  float m = -INFINITY;  // running max of this row's scaled scores
  float l = 0.0f;       // running sum of exp(score - m)
  float acc[32];        // running sum of bf16(p) * v for this lane's 32 columns
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdH;
  const bf16* Qw = Qs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_rows(Ks, k + head, k0, T, stride_t);
    load_rows(Vs, v + head, k0, T, stride_t);
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

    // Online softmax over this tile; two lanes per row. Keys past T: -inf.
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + half * 32 + j;
      sv[j] = key < T ? Sw[row * kLdS + half * 32 + j] * scale : -INFINITY;
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
  }
}

}  // namespace

// Returns the cudaError_t of the launch, or -1 for a shape it was not built for.
extern "C" int coral_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int T, int H, long long stride_b,
                                         long long stride_t, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return -1;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_fwd_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), T, H, stride_b, stride_t, scale);
  return (int)cudaGetLastError();
}
