// FFN up-projection block forward: g = gelu(bf16(layer_norm(x)) @ W1^T + b1).
//
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_ln` / `_fwd_kernel_ln`
// (the forward of `ffn_ln_block` at dropout rate 0, the pre-LN FFN of every
// wav2vec2 encoder layer). fc2 stays outside the kernel, as in the JAX
// package (`_fc2`).
//
// Bound on the H100: the tensor cores. At XLS-R-300M widths the product is
// 2 * 1024 * 4096 flops per row against 2 KB of input and 8 KB of output,
// hundreds of flops per byte.
//
// Design: one block per (64 rows, 256 of the F columns). The prologue computes
// the fp32 LayerNorm of its 64 rows over D = 1024 (two-pass, as `_ln_rows`),
// rounds it to bf16 as `_ln_matmul` does, and keeps the whole 64 x 1024 panel
// in shared memory (132 KB) for the K loop, so the normalised tensor never
// reaches device memory. The K loop streams 256 x 32 tiles of W1 (stored
// (F, D), K contiguous per column) into bf16 WMMA fragments with fp32
// accumulators, eight warps of 32 x 64 each. The epilogue stages the
// accumulators through shared memory (over the dead A panel), adds b1, applies
// the polynomial GELU and stores g in bf16, 16 bytes a lane.
#include <mma.h>

#include "common.cuh"
#include "gelu_poly.cuh"

using namespace nvcuda;

namespace {

constexpr int kD = 1024;       // model width: LayerNorm and reduction length
constexpr int kBM = 64;        // rows per block
constexpr int kBN = 256;       // F columns per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int kLdA = kD + 8;   // bf16 row pitch of the normalised panel
constexpr int kLdB = kBK + 8;  // bf16 row pitch of the W1 tile
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the staged accumulators
constexpr int kSmem = (kBM * kLdA + kBN * kLdB) * 2;
static_assert(kBM * kLdC * 4 <= kBM * kLdA * 2, "staging must fit over the A panel");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// x: (M, D) bf16; w1: (F, D) bf16; b1: (F,) fp32; gamma, beta: (D,) fp32;
// g: (M, F) bf16.
__global__ void __launch_bounds__(kThreads)
    ffn_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ g, long long M, int F,
                  float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;  // 0..1: rows wr*32 .. +31
  const int wc = warp & 3;   // 0..3: columns wc*64 .. +63

  // Prologue: warp w normalises rows 8w .. 8w+7; lane owns four 8-value
  // chunks at (i*32 + lane)*8.
  constexpr int kChunks = kD / (32 * 8);
#pragma unroll 1
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int r = warp * (kBM / 8) + rr;
    const long long row = m0 + r;
    bf16* arow = As + r * kLdA;
    if (row >= M) {
      const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kChunks; ++i) coral_store8(arow + (i * 32 + lane) * 8, zero);
      continue;
    }
    const bf16* xr = x + row * kD;
    float v[kChunks * 8];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) coral_load8(xr + (i * 32 + lane) * 8, v + i * 8);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks * 8; ++j) s += v[j];
    const float mean = coral_warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks * 8; ++j) {
      v[j] -= mean;
      q += v[j] * v[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / kD + eps);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = (i * 32 + lane) * 8;
      float ga[8], be[8], out[8];
      coral_load4(gamma + col, ga);
      coral_load4(gamma + col + 4, ga + 4);
      coral_load4(beta + col, be);
      coral_load4(beta + col + 4, be + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = (v[i * 8 + e] * rstd) * ga[e] + be[e];
      coral_store8(arow + col, out);  // rounds to bf16, the product's operand
    }
  }
  __syncthreads();

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < kD; k0 += kBK) {
    for (int i = tid; i < kBN * (kBK / 8); i += kThreads) {
      const int n = i >> 2;
      const int c = (i & 3) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kLdB + c) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(n0 + n) * kD + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + k0 + kk, kLdA);
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

  // The loop ended on a barrier, so the A panel may now be overwritten.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLdC + wc * 64 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: warp w writes rows 8w .. 8w+7; lane owns columns lane*8 .. +7.
  const int col = lane * 8;
  float bias[8];
  coral_load4(b1 + n0 + col, bias);
  coral_load4(b1 + n0 + col + 4, bias + 4);
#pragma unroll 1
  for (int rr = 0; rr < kBM / 8; ++rr) {
    const int r = warp * (kBM / 8) + rr;
    const long long row = m0 + r;
    if (row >= M) break;  // uniform over the warp
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = coral_gelu(Cs[r * kLdC + col + e] + bias[e]);
    coral_store8(g + row * F + n0 + col, out);
  }
}

}  // namespace

// Returns the cudaError_t of the launch, or -1 for a shape it was not built for.
extern "C" int coral_ffn_ln_fwd(const void* x, const void* w1, const void* b1,
                                const void* gamma, const void* beta, void* g, long long M,
                                int D, int F, float eps, void* stream) {
  if (D != kD || F % kBN != 0) return -1;
  if (M <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)(F / kBN));
  ffn_ln_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(g), M, F, eps);
  return (int)cudaGetLastError();
}
