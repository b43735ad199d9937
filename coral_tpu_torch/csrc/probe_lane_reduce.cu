// Probe: a LayerNorm's row reductions by lane sums against a tensor-core
// product with a ones tile, behind a matrix product.
//
// Replaces: tools/probe_lane_reduce.py `run` (its `pallas_call` :69) ->
// `_kernel` (:51): acc = x @ w for x (STEPS * 256, 1024) bf16 and w (1024,
// 1024) bf16 with fp32 sums, then nred in {1, 2, 4} row normalisations acc =
// (acc - mu) rsqrt(var + 1e-5), mu and var the row means of acc and of (acc -
// mu)^2, and one bf16 store. The means are taken by one of two routes:
//   vpu: per-lane partial sums and warp shuffles, the LayerNorm idiom of
//        csrc/ln_gelu.cu (the TPU kernel's jnp.mean over the lanes);
//   mxu: the product of the rows, rounded to bf16, with a (1024, 128) bf16
//        ones tile on the tensor cores, keeping column 0 (the TPU kernel's
//        ones-matmul, whose fp32 operand the MXU rounds to bf16 at default
//        precision).
//
// Bound on the H100: the tensor cores, 2 * 1024 flops per output element for
// the product (and with mxu 2 * 128 more per element and reduction) against 2
// bytes in and 2 out; the vpu route adds about 5 fp32 operations per element
// and normalisation.
//
// Design: a normalisation needs whole rows, so one block owns 32 rows of all
// 1024 output columns: csrc/ffn_tiles.cuh's panel product (32 rows of x in
// shared memory, 256 x 32 tiles of w stored (F, D), eight warps of 16 x 64
// WMMA fragments) runs four times over the same panel, once per 256 columns,
// and stages each into a 32 x 1024 fp32 tile in shared memory (128 KB). 64
// rows would need 256 KB for that tile, over a block's 227 KB; the panel (66
// KB), the weight tile (20 KB) and the rows (129 KB) take 213 KB. After the
// products the dead panel holds the mxu route's bf16 operand and the weight
// tile its (32, 128) fp32 product.
#include "ffn_tiles.cuh"

namespace {

constexpr int kLrD = 1024;           // x's width and the product's
constexpr int kLrRows = 32;          // rows a block
constexpr int kLdR = kLrD + 4;       // fp32 pitch of the staged rows
constexpr int kLdA = kLrD + 8;       // bf16 pitch of the panel
constexpr int kOnesN = 128;          // the ones tile's columns
constexpr int kLdSum = kOnesN + 4;   // fp32 pitch of the ones product
constexpr int kPanelBytes = kLrRows * kLdA * 2;
constexpr int kTileBytes = kBN * kLdB * 2;
constexpr int kLrSmem = kPanelBytes + kTileBytes + kLrRows * kLdR * 4;
static_assert(kLrSmem <= kMaxSmem, "the rows, panel and tile must fit a block");
static_assert(kLrRows * kLdSum * 4 <= kTileBytes, "the ones product must fit the tile");

// The row means of R (or, with kSquare, of the squares of R's entries) by the
// ones product: A = bf16(R or R^2) into As, then sums = A @ ones, column 0 of
// each row divided by 1024, into mean[r]. Called by every thread; ends on a
// barrier.
template <bool kSquare>
__device__ __forceinline__ void ones_means(float* mean, const float* R, bf16* As, float* sums,
                                           const bf16* __restrict__ ones) {
  for (int i = threadIdx.x; i < kLrRows * (kLrD / 8); i += kThreads) {
    const int r = i / (kLrD / 8);
    const int c = (i % (kLrD / 8)) * 8;
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = R[r * kLdR + c + e];
      f[e] = kSquare ? v * v : v;
    }
    coral_store8(As + r * kLdA + c, f);
  }
  __syncthreads();
  // 2 x 8 output tiles of 16 x 16; warp w: row tile w / 4, column tiles
  // 2 (w % 4) and 2 (w % 4) + 1.
  const int warp = threadIdx.x >> 5;
  const int ri = warp >> 2;
  const int cj = (warp & 3) * 2;
  FragC s[2];
  wmma::fill_fragment(s[0], 0.0f);
  wmma::fill_fragment(s[1], 0.0f);
#pragma unroll 4
  for (int kk = 0; kk < kLrD; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, As + ri * 16 * kLdA + kk, kLdA);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBr b;
      wmma::load_matrix_sync(b, ones + (long long)kk * kOnesN + (cj + j) * 16, kOnesN);
      wmma::mma_sync(s[j], a, b, s[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sums + ri * 16 * kLdSum + (cj + j) * 16, s[j], kLdSum,
                            wmma::mem_row_major);
  __syncthreads();
  if (threadIdx.x < kLrRows) mean[threadIdx.x] = sums[threadIdx.x * kLdSum] * (1.0f / kLrD);
  __syncthreads();
}

// x: (M, 1024) bf16; w: (1024, 1024) bf16 stored (F, D); ones: (1024, 128)
// bf16 (kMxu); out: (M, 1024) bf16.
template <bool kMxu>
__global__ void __launch_bounds__(kThreads)
    lane_reduce_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const bf16* __restrict__ ones, bf16* __restrict__ out, long long M,
                       int nred) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + kPanelBytes);
  float* R = reinterpret_cast<float*>(smem + kPanelBytes + kTileBytes);
  __shared__ float mean_s[kLrRows], var_s[kLrRows];

  const long long m0 = (long long)blockIdx.x * kLrRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 2;  // rows wr*16 .. +15
  const int wc = warp & 3;   // columns wc*64 .. +63 of each 256

  x_panel<kLrD, kLrRows>(As, x, m0, M);
  __syncthreads();
  for (int n0 = 0; n0 < kLrD; n0 += kBN) {
    FragC acc[1][4];
    panel_times_w1<kLrD, kLrRows>(acc, As, Bs, w, n0);  // ends on a barrier
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(R + wr * 16 * kLdR + n0 + wc * 64 + j * 16, acc[0][j], kLdR,
                              wmma::mem_row_major);
  }
  __syncthreads();

  for (int it = 0; it < nred; ++it) {
    if constexpr (kMxu) {
      float* sums = reinterpret_cast<float*>(Bs);
      ones_means<false>(mean_s, R, As, sums, ones);
      for (int i = threadIdx.x; i < kLrRows * kLrD; i += kThreads) {
        const int r = i / kLrD;
        R[r * kLdR + i % kLrD] -= mean_s[r];
      }
      __syncthreads();
      ones_means<true>(var_s, R, As, sums, ones);
      for (int i = threadIdx.x; i < kLrRows * kLrD; i += kThreads) {
        const int r = i / kLrD;
        R[r * kLdR + i % kLrD] *= rsqrtf(var_s[r] + 1e-5f);
      }
      __syncthreads();
    } else {
      // Warp w normalises rows 4w .. 4w+3; lane owns 4-value vectors at
      // (i*32 + lane)*4, i < 8.
#pragma unroll 1
      for (int rr = 0; rr < kLrRows / 8; ++rr) {
        float* row = R + (warp * (kLrRows / 8) + rr) * kLdR;
        float v[32];
#pragma unroll
        for (int i = 0; i < 8; ++i) coral_load4(row + (i * 32 + lane) * 4, v + 4 * i);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) s += v[j];
        const float mu = coral_warp_sum(s) / kLrD;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          v[j] -= mu;
          q += v[j] * v[j];
        }
        const float r = rsqrtf(coral_warp_sum(q) / kLrD + 1e-5f);
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] *= r;
#pragma unroll
        for (int i = 0; i < 8; ++i) coral_store4(row + (i * 32 + lane) * 4, v + 4 * i);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // One bf16 store: warp w writes rows 4w .. 4w+3, 4 values a lane at a time.
#pragma unroll 1
  for (int rr = 0; rr < kLrRows / 8; ++rr) {
    const int r = warp * (kLrRows / 8) + rr;
    if (m0 + r >= M) break;  // uniform over the warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float f[4];
      coral_load4(R + r * kLdR + (i * 32 + lane) * 4, f);
      coral_store4(out + (m0 + r) * kLrD + (i * 32 + lane) * 4, f);
    }
  }
}

template <bool kMxu>
int launch_lane_reduce(const bf16* x, const bf16* w, const bf16* ones, bf16* out, long long M,
                       int nred, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(lane_reduce_kernel<kMxu>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kLrSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kLrRows - 1) / kLrRows));
  lane_reduce_kernel<kMxu><<<grid, kThreads, kLrSmem, s>>>(x, w, ones, out, M, nred);
  return (int)cudaGetLastError();
}

}  // namespace

// One case of the probe: x (M, D) bf16, w (D, D) bf16 stored (F, D) (the
// nn.Linear layout), ones (D, 128) bf16 (read with mxu != 0), out (M, D) bf16;
// nred normalisations by the mxu or the vpu route. Built for D = 1024.
// Returns the cudaError_t of the launch, or -1 for a case it was not built for.
extern "C" int coral_probe_lane_reduce(const void* x, const void* w, const void* ones, void* out,
                                       long long M, int D, int mxu, int nred, void* stream) {
  if (D != kLrD || M <= 0 || nred < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* op = static_cast<const bf16*>(ones);
  bf16* yp = static_cast<bf16*>(out);
  return mxu ? launch_lane_reduce<true>(xp, wp, op, yp, M, nred, s)
             : launch_lane_reduce<false>(xp, wp, op, yp, M, nred, s);
}
