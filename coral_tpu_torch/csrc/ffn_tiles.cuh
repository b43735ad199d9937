// The WMMA tiles of the packed QKV projection's forward (csrc/ln_dense.cu:
// ln_panel, panel_times_w1, stage), the last FFN kernel on them (ROADMAP
// R4b), and of the H100 probes (csrc/probe_gelu_cost.cu,
// csrc/probe_lane_reduce.cu), which time this tile as it is. Every other FFN
// kernel runs on csrc/ffn_gemm.cuh's Hopper mainloop: K5, N1-N5 and dl = dh
// W1 of every backward, N6's dW (its A^T B tile) and N7 (a thread-block
// cluster of the mainloop's blocks, csrc/ffn_ln_fc2.cu).
//
// The panel: BM rows of the bf16 LayerNorm (two-pass fp32 as `_ln_rows`,
// rounded as `_ln_matmul`; csrc/ffn_gemm.cuh's row statistics and chunk pass
// are this arithmetic, so both give the same bits) in shared memory at pitch
// D + 8, BM = 64 where it fits (D = 384 to 1280) and 32 at 1920. The K loop
// streams 256 x 32 tiles of W (stored (F, D)) into bf16 WMMA fragments with
// fp32 accumulators, eight warps of BM/2 x 64 each; `stage` writes them to
// shared memory for an epilogue.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "gelu_poly.cuh"
#include "philox.cuh"

namespace {

using namespace nvcuda;

constexpr int kBN = 256;       // F columns per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int kLdB = kBK + 8;  // bf16 row pitch of the W tile
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the staged accumulators
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

// The panel (BM rows at pitch D + 8) and a W1 tile.
__host__ __device__ constexpr int panel_smem(int D, int BM) {
  return (BM * (D + 8) + kBN * kLdB) * 2;
}
// The panel's rows at width D: 64 where that panel fits, else 32.
__host__ __device__ constexpr int panel_rows(int D) {
  return panel_smem(D, 64) <= kMaxSmem ? 64 : 32;
}
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }
// A panel kernel's shared memory: the panel stage, and the staged
// accumulators written over it once the K loop is done.
__host__ __device__ constexpr int fwd_smem(int D) {
  return max_int(panel_smem(D, panel_rows(D)), panel_rows(D) * kLdC * 4);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The fp32 LayerNorm of rows m0 .. m0+BM-1 of x, rounded to bf16 into As (rows
// past M are zero). Warp w
// normalises rows w*BM/8 .. +BM/8-1; a lane owns D / (32 V) V-value vectors at
// (i*32+lane)*V. The panel's row pitch is D + 8.
template <int D, int BM>
__device__ __forceinline__ void ln_panel(bf16* As, const bf16* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, long long m0,
                                         long long M, float eps) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int V = coral_row_vec<bf16>(D);
  constexpr int kChunks = D / (32 * V);
  constexpr int kLdA = D + 8;
  static_assert(kChunks * 32 * V == D, "a lane owns whole vectors of the row");
#pragma unroll 1
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const long long row = m0 + r;
    bf16* arow = As + r * kLdA;
    if (row >= M) {
      float zero[V];
#pragma unroll
      for (int e = 0; e < V; ++e) zero[e] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) coral_storev<V>(arow + (i * 32 + lane) * V, zero);
      continue;
    }
    const bf16* xr = x + row * D;
    float v[kChunks * V];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) coral_loadv<V>(xr + (i * 32 + lane) * V, v + i * V);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks * V; ++j) s += v[j];
    const float mean = coral_warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks * V; ++j) {
      v[j] -= mean;
      q += v[j] * v[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = (i * 32 + lane) * V;
      float ga[V], be[V], out[V];
      coral_loadv<V>(gamma + col, ga);
      coral_loadv<V>(beta + col, be);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = (v[i * V + e] * rstd) * ga[e] + be[e];
      coral_storev<V>(arow + col, out);  // rounds to bf16, the product's operand
    }
  }
}

// Rows m0 .. m0+BM-1 of x copied into As as they are (rows past M are zero),
// 16 bytes a thread at a time: the panel of the probes' products without the
// LayerNorm.
template <int D, int BM>
__device__ __forceinline__ void x_panel(bf16* As, const bf16* __restrict__ x, long long m0,
                                        long long M) {
  constexpr int kLdA = D + 8;
  constexpr int kVecs = D / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < BM * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) u = *reinterpret_cast<const uint4*>(x + (m0 + r) * D + c);
    *reinterpret_cast<uint4*>(As + r * kLdA + c) = u;
  }
}

// acc (this warp's BM/2 x 64) = As (BM x D) @ W1[n0 .. n0+255, :]^T over the
// whole D, streaming 256 x 32 tiles of W1 through Bs. With kColTail, rows of W1
// at or past F (a last column tile of 128, F a multiple of 128 but not of 256)
// load as zero. Ends on a barrier.
template <int D, int BM, bool kColTail = false>
__device__ __forceinline__ void panel_times_w1(FragC (&acc)[BM / 32][4], const bf16* As,
                                               bf16* Bs, const bf16* __restrict__ w1, int n0,
                                               int F = 0) {
  constexpr int kLdA = D + 8;
  constexpr int kFR = BM / 32;  // 16-row fragments of a warp
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2;  // 0..1: rows wr*BM/2 .. +BM/2-1
  const int wc = warp & 3;   // 0..3: columns wc*64 .. +63
#pragma unroll
  for (int i = 0; i < kFR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
      const int n = i >> 2;
      const int c = (i & 3) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (!kColTail || n0 + n < F)
        u = *reinterpret_cast<const uint4*>(w1 + (long long)(n0 + n) * D + k0 + c);
      *reinterpret_cast<uint4*>(Bs + n * kLdB + c) = u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[kFR];
      FragB bf[4];
#pragma unroll
      for (int i = 0; i < kFR; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * (BM / 2) + i * 16) * kLdA + k0 + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wc * 64 + j * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int i = 0; i < kFR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int BM>
__device__ __forceinline__ void stage(float* Cs, FragC (&acc)[BM / 32][4]) {
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2;
  const int wc = warp & 3;
#pragma unroll
  for (int i = 0; i < BM / 32; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wr * (BM / 2) + i * 16) * kLdC + wc * 64 + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
}

// Launches kKernel with `smem` bytes of dynamic shared memory, set once per
// kernel and process (off every later call's path); the cudaError_t.
template <auto kKernel, typename... Args>
cudaError_t launch_with_smem(dim3 grid, int smem, cudaStream_t s, Args... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kKernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace
