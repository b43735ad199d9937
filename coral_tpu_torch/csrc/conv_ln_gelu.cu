// Feature-encoder block forward: gelu(layer_norm(conv1d(x, w, stride=2) + bias)).
//
// Replaces: coral_tpu/ops/conv_ln_gelu_pallas.py `_fwd_pallas` / `_fwd_kernel`
// (FE convs 1-6 of XLS-R: k = 3, 3, 3, 3, 2, 2; 512 -> 512 channels). Only y is
// written: the TPU kernel's xhat and rstd outputs are training residuals.
//
// Bound on the H100: the tensor cores, at about 1.6 GFLOP per output row block
// against 64 KB of input, plus the weight (1.5 MB at k = 3) that every block
// streams from L2. The input rows are read once from device memory.
//
// Design: output row t reads input rows 2t .. 2t+k-1, which are k*C contiguous
// values, so the conv is a GEMM whose A row t is a strided view of x (row
// stride 2C) and whose reduction runs over k*C. The TPU's deinterleave fold
// and halo view are not needed: rows are read straight from device memory, and
// any T_in works. One block owns 64 output rows across all 512 output
// channels, because the LayerNorm needs whole rows: 16 warps, each a 32 x 64
// tile of bf16 WMMA fragments with fp32 accumulators. The accumulators are
// staged through shared memory (132 KB, reusing the operand tiles), where one
// warp per row adds the bias and runs the fp32 LayerNorm and the polynomial
// GELU before one bf16 store.
#include <mma.h>

#include "common.cuh"
#include "gelu_poly.cuh"

using namespace nvcuda;

namespace {

constexpr int kC = 512;        // input and output channels
constexpr int kBM = 64;        // output rows per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 512;  // 16 warps: 2 row groups x 8 column groups
constexpr int kLdA = kBK + 8;  // bf16 row pitch of the A and B tiles
constexpr int kLdB = kBK + 8;
constexpr int kLdC = kC + 4;  // fp32 row pitch of the staged accumulators
constexpr int kSmemMain = (kBM * kLdA + kC * kLdB) * 2;
constexpr int kSmemEpi = kBM * kLdC * 4;
constexpr int kSmem = kSmemMain > kSmemEpi ? kSmemMain : kSmemEpi;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// x: (B, T_in, C) bf16; w: (C_out, K, C_in) bf16, i.e. each output channel's
// K*C_in reduction values contiguous; bias, gamma, beta: (C,) fp32;
// y: (B, T_out, C) bf16.
template <int K>
__global__ void __launch_bounds__(kThreads)
    conv_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ y, int T_in,
                        int T_out, float eps) {
  constexpr int kRed = K * kC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const bf16* xb = x + (long long)b * T_in * kC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 3;  // 0..1: rows wr*32 .. +31
  const int wc = warp & 7;   // 0..7: columns wc*64 .. +63

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < kRed; k0 += kBK) {
    if (tid < kBM * (kBK / 8)) {  // A: 64 rows x 32 values, 16 bytes a thread
      const int r = tid >> 2;
      const int c = (tid & 3) * 8;
      const int t = t0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T_out)
        v = *reinterpret_cast<const uint4*>(xb + (long long)(2 * t) * kC + k0 + c);
      *reinterpret_cast<uint4*>(As + r * kLdA + c) = v;
    }
    for (int i = tid; i < kC * (kBK / 8); i += kThreads) {  // B: 512 x 32
      const int n = i >> 2;
      const int c = (i & 3) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kLdB + c) =
          *reinterpret_cast<const uint4*>(w + (long long)n * kRed + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wc * 64 + j * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The loop ended on a barrier, so the operand tiles may now be overwritten.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLdC + wc * 64 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: warp w normalises rows 4w .. 4w+3; lane owns columns
  // lane*8 .. +7 and 256 + lane*8 .. +7.
#pragma unroll 1
  for (int rr = 0; rr < kBM / 16; ++rr) {
    const int r = warp * (kBM / 16) + rr;
    const int t = t0 + r;
    if (t >= T_out) break;  // uniform over the warp
    const float* cr = Cs + r * kLdC;
    float v[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 256 + lane * 8;
      float bb[8];
      coral_load4(bias + col, bb);
      coral_load4(bias + col + 4, bb + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[h * 8 + e] = cr[col + e] + bb[e];
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += v[j];
    const float mean = coral_warp_sum(s) / kC;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] -= mean;
      q += v[j] * v[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / kC + eps);
    bf16* yr = y + ((long long)b * T_out + t) * kC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 256 + lane * 8;
      float g[8], be[8], out[8];
      coral_load4(gamma + col, g);
      coral_load4(gamma + col + 4, g + 4);
      coral_load4(beta + col, be);
      coral_load4(beta + col + 4, be + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = coral_gelu((v[h * 8 + e] * rstd) * g[e] + be[e]);
      coral_store8(yr + col, out);
    }
  }
}

template <int K>
int launch(const void* x, const void* w, const void* bias, const void* gamma,
           const void* beta, void* y, int B, int T_in, int T_out, float eps,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_ln_gelu_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T_out + kBM - 1) / kBM), (unsigned)B);
  conv_ln_gelu_kernel<K><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), T_in, T_out, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch, or -1 for a shape it was not built for.
extern "C" int coral_conv_ln_gelu(const void* x, const void* w, const void* bias,
                                  const void* gamma, const void* beta, void* y, int B,
                                  int T_in, int T_out, int C, int K, float eps,
                                  void* stream) {
  if (C != kC) return -1;
  if (B <= 0 || T_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2) return launch<2>(x, w, bias, gamma, beta, y, B, T_in, T_out, eps, s);
  if (K == 3) return launch<3>(x, w, bias, gamma, beta, y, B, T_in, T_out, eps, s);
  return -1;
}
