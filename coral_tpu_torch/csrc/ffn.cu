// The pre-LN FFN block: the forward's up-projection kernel (with activation
// dropout) and the backward's two kernels.
//
// Forward: g = dropout(gelu(bf16(layer_norm(x)) @ W1^T + b1)).
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_ln` / `_fwd_kernel_ln`
// (rate 0) and `_fwd_kernel_ln_drop` (rate > 0), the forward of
// `ffn_ln_block`, the pre-LN FFN of every wav2vec2 encoder layer. fc2 stays
// outside the kernel, as in the JAX package (`_fc2`).
//
// Bound on the H100: the tensor cores. At XLS-R-300M widths the product is
// 2 * 1024 * 4096 flops per row against 2 KB of input and 8 KB of output,
// hundreds of flops per byte (Whisper large-v3 and XLS-R-1B: D = 1280,
// F = 5120).
//
// Design: one block per (BM rows, 256 of the F columns), BM = 64 wherever the
// panel below fits (D = 384 to 1280) and 32 at D = 1920 (XLS-R-2B), where a
// 64-row panel (247 KB) is over a block's 227 KB. The prologue computes the
// fp32 LayerNorm of its BM rows over the width D (two-pass, as `_ln_rows`),
// rounds it to bf16 as `_ln_matmul` does, and keeps the whole BM x D panel in
// shared memory (132 KB at D = 1024, 165 KB at 1280, 123 KB at 1920 with 32
// rows) for the K loop, so the normalised tensor never reaches device memory.
// A lane owns whole lane vectors of the row: 8 values where D is a multiple of
// 256, else 4 (384 = 3 x 128, 1920 = 15 x 128). The K loop streams 256 x 32
// tiles of W1 (stored (F, D), K contiguous per column) into bf16 WMMA
// fragments with fp32 accumulators, eight warps of BM/2 x 64 each. The
// epilogue stages the accumulators through shared memory (over the dead panel
// and W1 tile), adds b1, applies the polynomial GELU and the dropout mask
// (csrc/philox.cuh: a pure function of seed[b], row t and column, not of the
// tiling) and stores g in bf16, 16 bytes a lane. Every width any config of
// the repository uses is built: 384, 512, 768 (Whisper tiny, base, small),
// 1024 (XLS-R-300M, Whisper medium), 1280 (Whisper large, XLS-R-1B), 1920.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "gelu_poly.cuh"
#include "philox.cuh"

using namespace nvcuda;

namespace {

constexpr int kBN = 256;       // F columns per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int kLdB = kBK + 8;  // bf16 row pitch of the W1 tile (and the dy chunk)
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the staged accumulators
constexpr int kLdW = kBN + 8;  // bf16 row pitch of the W2 tile
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

// The normalised panel (BM rows at pitch D + 8) and a W1 tile.
__host__ __device__ constexpr int panel_smem(int D, int BM) {
  return (BM * (D + 8) + kBN * kLdB) * 2;
}
// Rows per block at width D: 64 where that panel fits, else 32.
__host__ __device__ constexpr int row_tile(int D) {
  return panel_smem(D, 64) <= kMaxSmem ? 64 : 32;
}
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }
// The forward's shared memory: the panel stage, and the staged accumulators
// written over it once the K loop is done (larger than the panel at D = 384).
__host__ __device__ constexpr int fwd_smem(int D) {
  return max_int(panel_smem(D, row_tile(D)), row_tile(D) * kLdC * 4);
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The fp32 LayerNorm of rows m0 .. m0+BM-1 of x, rounded to bf16 into As (rows
// past M are zero); with ln_out, the rows are written there too. Warp w
// normalises rows w*BM/8 .. +BM/8-1; a lane owns D / (32 V) V-value vectors at
// (i*32+lane)*V. The panel's row pitch is D + 8.
template <int D, int BM>
__device__ __forceinline__ void ln_panel(bf16* As, const bf16* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, long long m0,
                                         long long M, float eps, bf16* ln_out) {
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
      if (ln_out != nullptr) {
        if constexpr (V == 8)
          *reinterpret_cast<uint4*>(ln_out + row * D + col) =
              *reinterpret_cast<const uint4*>(arow + col);
        else
          *reinterpret_cast<uint2*>(ln_out + row * D + col) =
              *reinterpret_cast<const uint2*>(arow + col);
      }
    }
  }
}

// acc (this warp's BM/2 x 64) = As (BM x D) @ W1[n0 .. n0+255, :]^T over the
// whole D, streaming 256 x 32 tiles of W1 through Bs. Ends on a barrier.
template <int D, int BM>
__device__ __forceinline__ void ln_times_w1(FragC (&acc)[BM / 32][4], const bf16* As, bf16* Bs,
                                            const bf16* __restrict__ w1, int n0) {
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
      *reinterpret_cast<uint4*>(Bs + n * kLdB + c) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(n0 + n) * D + k0 + c);
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

// x: (M, D) bf16; w1: (F, D) bf16; b1: (F,) fp32; gamma, beta: (D,) fp32;
// seeds: (M / T,) int32 (kDrop); g: (M, F) bf16.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    ffn_ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const int* __restrict__ seeds,
                  bf16* __restrict__ g, long long M, int F, int T, uint32_t threshold,
                  float scale, float eps) {
  constexpr int BM = row_tile(D);
  static_assert(fwd_smem(D) <= kMaxSmem, "the forward's stage must fit a block's shared memory");
  static_assert(BM * kLdC * 4 <= fwd_smem(D), "the staging must fit the forward's stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * (D + 8);
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  ln_panel<D, BM>(As, x, gamma, beta, m0, M, eps, nullptr);
  __syncthreads();
  FragC acc[BM / 32][4];
  ln_times_w1<D, BM>(acc, As, Bs, w1, n0);
  stage<BM>(Cs, acc);  // the K loop ended on a barrier: the panel and tile are dead
  __syncthreads();

  // Epilogue: warp w writes rows w*BM/8 .. ; lane owns columns lane*8 .. +7.
  const int col = lane * 8;
  float bias[8];
  coral_load4(b1 + n0 + col, bias);
  coral_load4(b1 + n0 + col + 4, bias + 4);
#pragma unroll 1
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const long long row = m0 + r;
    if (row >= M) break;  // uniform over the warp
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = coral_gelu(Cs[r * kLdC + col + e] + bias[e]);
    if (kDrop) {
      bool keep[8];
      coral_keep8((uint32_t)seeds[row / T], (uint32_t)(row % T), n0 + col, threshold, keep);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = keep[e] ? out[e] * scale : 0.f;
    }
    coral_store8(g + row * F + n0 + col, out);
  }
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/ffn_pallas.py `_bwd_pallas_ln_g_dg` /
// `_bwd_kernel_ln_g_dg` (rate 0) and `_bwd_kernel_ln_g_dg_drop` (rate > 0), the
// backward of `ffn_ln_block` with dg computed in the kernel.
//
// Bound on the H100: the tensor cores: three products of 2 * D * F flops per
// row (h recomputed, dg = dy W2^T, dl = dh W1), against 4 KB of x and dy in
// and 16 KB of g and dh out (at D = 1024; 5 KB and 20 KB at 1280).
//
// The TPU kernel holds a (TM, F) block and its (TM, D) LayerNorm backward in
// VMEM at once: dl = dh W1 must be complete over all D columns of a row
// before any dx is written. A 64-row tile of dl alone is 256 KB of fp32 (320
// KB at D = 1280), more than an SM's 227 KB, so the work is split into three
// hand-written kernels, each a template over D:
//  (i)  ffn_bwd_kernel, one block per (BM rows, 256 F columns): the LayerNorm
//       panel as the forward (written once as ln_out, the dW1 operand),
//       h = ln W1^T + b1 over the whole D, then dg = dy W2^T over the whole D
//       with dy and W2 streamed in 32-wide chunks; the epilogue regenerates the
//       forward's dropout mask from the same seeds, writes g (the dW2 operand)
//       and dh = dg * mask / keep * gelu'(h) in bf16, and the column sums of
//       the fp32 dh over its BM rows (the db1 partial);
//  (ii) dl_kernel: dl = dh @ W1 in fp32, 128 x 128 tiles;
//  (iii) the LayerNorm backward of csrc/ln_gelu.cu on (x, dl) (apply_gelu=0,
//       fp32 dy), launched by the wrapper, for dx and the dgamma/dbeta
//       partials.
// dW1 = ln_out^T dh, dW2 = dy^T g, db2 and the sums of the partials stay
// outside, as in `_ffn_ln_block_dg_bwd`.
// Shared memory: the forward's stage, then, after the h product, the regions
// below over it; each instantiation takes the larger of the two (the regions
// are the larger at D = 384 and 512, where the panel is small).
// The regions at row tile BM: the dy chunk after the staged h, the W2 tile,
// the staged dg after the loop, the column-sum partials.
template <int BM>
__host__ __device__ constexpr int off_y() { return BM * kLdC * 4; }
template <int BM>
__host__ __device__ constexpr int off_w() { return off_y<BM>() + BM * kLdB * 2; }
template <int BM>
__host__ __device__ constexpr int off_g() { return off_y<BM>(); }
template <int BM>
__host__ __device__ constexpr int off_red() { return off_g<BM>() + BM * kLdC * 4; }
template <int BM>
__host__ __device__ constexpr int regions_end() { return off_red<BM>() + 4 * kBN * 4; }
__host__ __device__ constexpr int bwd_smem(int D) {
  return max_int(fwd_smem(D), row_tile(D) == 64 ? regions_end<64>() : regions_end<32>());
}

// dy: (M, D) bf16; w2: (D, F) bf16; g, dh: (M, F) bf16; ln_out: (M, D) bf16;
// db1_part: (ceil(M / BM), F) fp32.
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    ffn_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ dy,
                   const bf16* __restrict__ w2, const int* __restrict__ seeds,
                   bf16* __restrict__ g, bf16* __restrict__ dh, bf16* __restrict__ ln_out,
                   float* __restrict__ db1_part, long long M, int F, int T, uint32_t threshold,
                   float scale, float eps) {
  constexpr int BM = row_tile(D);
  constexpr int kFR = BM / 32;
  static_assert(bwd_smem(D) <= kMaxSmem, "the backward's stage must fit a block's shared memory");
  static_assert(off_w<BM>() + kBK * kLdW * 2 <= bwd_smem(D) && regions_end<BM>() <= bwd_smem(D),
                "the dg operands and the staging must fit this width's stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * (D + 8);
  float* Hs = reinterpret_cast<float*>(smem);
  bf16* Ys = reinterpret_cast<bf16*>(smem + off_y<BM>());
  bf16* Ws = reinterpret_cast<bf16*>(smem + off_w<BM>());
  float* Gs = reinterpret_cast<float*>(smem + off_g<BM>());
  float* red = reinterpret_cast<float*>(smem + off_red<BM>());

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 2;
  const int wc = warp & 3;

  ln_panel<D, BM>(As, x, gamma, beta, m0, M, eps, blockIdx.y == 0 ? ln_out : nullptr);
  __syncthreads();
  FragC acc[kFR][4];
  ln_times_w1<D, BM>(acc, As, Bs, w1, n0);
  stage<BM>(Hs, acc);  // h - b1, over the dead panel

  // dg = dy W2^T: BM x 32 chunks of dy and 32 x 256 tiles of W2 (stored
  // (D, F), F contiguous).
#pragma unroll
  for (int i = 0; i < kFR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) u = *reinterpret_cast<const uint4*>(dy + (m0 + r) * D + k0 + c);
      *reinterpret_cast<uint4*>(Ys + r * kLdB + c) = u;
    }
    for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
      const int kr = i >> 5;
      const int c = (i & 31) * 8;
      *reinterpret_cast<uint4*>(Ws + kr * kLdW + c) =
          *reinterpret_cast<const uint4*>(w2 + (long long)(k0 + kr) * F + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[kFR];
      FragBr bf[4];
#pragma unroll
      for (int i = 0; i < kFR; ++i)
        wmma::load_matrix_sync(a[i], Ys + (wr * (BM / 2) + i * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Ws + kk * kLdW + wc * 64 + j * 16, kLdW);
#pragma unroll
      for (int i = 0; i < kFR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  stage<BM>(Gs, acc);
  __syncthreads();

  // Epilogue: thread owns columns 4*cg .. +3 of rows rg*BM/4 .. +BM/4-1.
  const int cg = threadIdx.x & 63;
  const int rg = threadIdx.x >> 6;
  const int c0 = cg * 4;
  float bias[4], colsum[4] = {0.f, 0.f, 0.f, 0.f};
  coral_load4(b1 + n0 + c0, bias);
  for (int rr = 0; rr < BM / 4; ++rr) {
    const int r = rg * (BM / 4) + rr;
    const long long row = m0 + r;
    if (row >= M) break;
    bool keep[4] = {true, true, true, true};
    if (kDrop) {
      const uint4 bits = coral_philox((uint32_t)(n0 + c0) >> 2, (uint32_t)(row % T),
                                      (uint32_t)seeds[row / T]);
      keep[0] = bits.x >= threshold;
      keep[1] = bits.y >= threshold;
      keep[2] = bits.z >= threshold;
      keep[3] = bits.w >= threshold;
    }
    float gv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = Hs[r * kLdC + c0 + e] + bias[e];
      const float dgv = Gs[r * kLdC + c0 + e];
      if (kDrop) {
        gv[e] = keep[e] ? coral_gelu(h) * scale : 0.f;
        dv[e] = keep[e] ? dgv * scale * coral_dgelu(h) : 0.f;
      } else {
        gv[e] = coral_gelu(h);
        dv[e] = dgv * coral_dgelu(h);
      }
      colsum[e] += dv[e];
    }
    __nv_bfloat162* gp = reinterpret_cast<__nv_bfloat162*>(g + row * F + n0 + c0);
    __nv_bfloat162* dp = reinterpret_cast<__nv_bfloat162*>(dh + row * F + n0 + c0);
    gp[0] = __floats2bfloat162_rn(gv[0], gv[1]);
    gp[1] = __floats2bfloat162_rn(gv[2], gv[3]);
    dp[0] = __floats2bfloat162_rn(dv[0], dv[1]);
    dp[1] = __floats2bfloat162_rn(dv[2], dv[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[rg * kBN + c0 + e] = colsum[e];
  __syncthreads();
  {
    const int c = threadIdx.x;  // kThreads == kBN
    db1_part[(long long)blockIdx.x * F + n0 + c] =
        ((red[c] + red[kBN + c]) + red[2 * kBN + c]) + red[3 * kBN + c];
  }
}

// dl = dh @ W1: dh (M, F) bf16, W1 (F, D) bf16 row-major, dl (M, D) fp32.
// 128 x 128 tiles, eight warps of 32 x 64, 32-deep chunks.
constexpr int kGM = 128;
constexpr int kGN = 128;
constexpr int kLdGA = kBK + 8;
constexpr int kLdGB = kGN + 8;

template <int D>
__global__ void __launch_bounds__(kThreads)
    dl_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ w1, float* __restrict__ dl,
              long long M, int F) {
  static_assert(D % kGN == 0, "D must be a multiple of the tile");
  __shared__ __align__(128) bf16 As[kGM * kLdGA];
  __shared__ __align__(128) bf16 Bs[kBK * kLdGB];
  const long long m0 = (long long)blockIdx.y * kGM;
  const int n0 = blockIdx.x * kGN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp >> 1;  // 0..3: rows wr*32 .. +31
  const int wc = warp & 1;   // 0..1: columns wc*64 .. +63
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < F; k0 += kBK) {
    for (int i = threadIdx.x; i < kGM * (kBK / 8); i += kThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) u = *reinterpret_cast<const uint4*>(dh + (m0 + r) * F + k0 + c);
      *reinterpret_cast<uint4*>(As + r * kLdGA + c) = u;
    }
    for (int i = threadIdx.x; i < kBK * (kGN / 8); i += kThreads) {
      const int kr = i >> 4;
      const int c = (i & 15) * 8;
      *reinterpret_cast<uint4*>(Bs + kr * kLdGB + c) =
          *reinterpret_cast<const uint4*>(w1 + (long long)(k0 + kr) * D + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragBr bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdGA + kk, kLdGA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * kLdGB + wc * 64 + j * 16, kLdGB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Each warp stages one 16 x 16 fragment at a time through its own 1 KB of
  // the dead A tile and writes the rows below M.
  float* St = reinterpret_cast<float*>(As) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(St, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1;
      const int c = (lane & 1) * 8;
      const long long row = m0 + wr * 32 + i * 16 + r;
      if (row < M) {
        float* out = dl + row * D + n0 + wc * 64 + j * 16 + c;
        coral_store4(out, St + r * 16 + c);
        coral_store4(out + 4, St + r * 16 + c + 4);
      }
      __syncwarp();
    }
  }
}
static_assert(kGM * kLdGA * 2 >= 8 * 256 * 4, "the output staging must fit the A tile");

// Launches the forward at width D, with dropout when seeds are given.
template <int D>
cudaError_t launch_ffn_ln(const bf16* xp, const bf16* wp, const float* bp, const float* gp,
                          const float* tp, const int* sp, bf16* out, long long M, int F, int T,
                          unsigned int threshold, float scale, float eps, cudaStream_t s) {
  constexpr int BM = row_tile(D);
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / kBN));
  constexpr int smem = fwd_smem(D);
  cudaError_t err;
  if (sp != nullptr) {
    err = cudaFuncSetAttribute(ffn_ln_kernel<D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ffn_ln_kernel<D, true><<<grid, kThreads, smem, s>>>(xp, wp, bp, gp, tp, sp, out, M, F, T,
                                                        threshold, scale, eps);
  } else {
    err = cudaFuncSetAttribute(ffn_ln_kernel<D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ffn_ln_kernel<D, false><<<grid, kThreads, smem, s>>>(xp, wp, bp, gp, tp, sp, out, M, F, 1,
                                                         0u, 1.0f, eps);
  }
  return cudaGetLastError();
}

// Launches backward kernels (i) and (ii) at width D.
template <int D>
cudaError_t launch_ffn_bwd(const bf16* xp, const bf16* w1p, const float* bp, const float* gp,
                           const float* tp, const bf16* dyp, const bf16* w2p, const int* sp,
                           bf16* gout, bf16* dhp, bf16* lnp, float* part, float* dlp, long long M,
                           int F, int T, unsigned int threshold, float scale, float eps,
                           cudaStream_t s) {
  constexpr int BM = row_tile(D);
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / kBN));
  constexpr int smem = bwd_smem(D);
  cudaError_t err;
  if (sp != nullptr) {
    err = cudaFuncSetAttribute(ffn_bwd_kernel<D, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ffn_bwd_kernel<D, true><<<grid, kThreads, smem, s>>>(
        xp, w1p, bp, gp, tp, dyp, w2p, sp, gout, dhp, lnp, part, M, F, T, threshold, scale, eps);
  } else {
    err = cudaFuncSetAttribute(ffn_bwd_kernel<D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ffn_bwd_kernel<D, false><<<grid, kThreads, smem, s>>>(
        xp, w1p, bp, gp, tp, dyp, w2p, sp, gout, dhp, lnp, part, M, F, 1, 0u, 1.0f, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dl((unsigned)(D / kGN), (unsigned)((M + kGM - 1) / kGM));
  dl_kernel<D><<<grid_dl, kThreads, 0, s>>>(dhp, w1p, dlp, M, F);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, D>{}) for a built width D; returns -1
// for any other.
template <typename Fn>
int with_width(int D, Fn&& f) {
  switch (D) {
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 768: return f(std::integral_constant<int, 768>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 1280: return f(std::integral_constant<int, 1280>{});
    case 1920: return f(std::integral_constant<int, 1920>{});
    default: return -1;
  }
}

}  // namespace

// The rows per block of the kernels at width D (the db1 partial's row tile),
// or -1 for a width they were not built for.
extern "C" int coral_ffn_row_tile(int D) {
  return with_width(D, [](auto d) { return row_tile(decltype(d)::value); });
}

// Forward. seeds: (M / T,) int32, or null for rate 0 (threshold and scale are
// then not read). D is a built width (coral_ffn_row_tile). Returns the
// cudaError_t of the launch, or -1 for a shape it was not built for.
extern "C" int coral_ffn_ln_fwd(const void* x, const void* w1, const void* b1,
                                const void* gamma, const void* beta, const void* seeds,
                                void* g, long long M, int D, int F, int T,
                                unsigned int threshold, float scale, float eps, void* stream) {
  if (F % kBN != 0 || (seeds != nullptr && T <= 0) || coral_ffn_row_tile(D) < 0) return -1;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w1);
  const float *bp = static_cast<const float*>(b1), *gp = static_cast<const float*>(gamma),
              *tp = static_cast<const float*>(beta);
  const int* sp = static_cast<const int*>(seeds);
  bf16* out = static_cast<bf16*>(g);
  return with_width(D, [&](auto d) {
    return (int)launch_ffn_ln<decltype(d)::value>(xp, wp, bp, gp, tp, sp, out, M, F, T,
                                                  threshold, scale, eps, s);
  });
}

// Backward kernels (i) and (ii) at a built width D; seeds as the forward.
// db1_part has ceil(M / coral_ffn_row_tile(D)) rows of F. Returns the
// cudaError_t of the launches, or -1 for a shape they were not built for.
extern "C" int coral_ffn_bwd(const void* x, const void* w1, const void* b1, const void* gamma,
                             const void* beta, const void* dy, const void* w2, const void* seeds,
                             void* g, void* dh, void* ln_out, void* db1_part, void* dl,
                             long long M, int D, int F, int T, unsigned int threshold,
                             float scale, float eps, void* stream) {
  if (coral_ffn_row_tile(D) < 0 || F % kBN != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *w1p = static_cast<const bf16*>(w1),
             *dyp = static_cast<const bf16*>(dy), *w2p = static_cast<const bf16*>(w2);
  const float *bp = static_cast<const float*>(b1), *gp = static_cast<const float*>(gamma),
              *tp = static_cast<const float*>(beta);
  const int* sp = static_cast<const int*>(seeds);
  bf16 *gout = static_cast<bf16*>(g), *dhp = static_cast<bf16*>(dh),
       *lnp = static_cast<bf16*>(ln_out);
  float *part = static_cast<float*>(db1_part), *dlp = static_cast<float*>(dl);
  return with_width(D, [&](auto d) {
    return (int)launch_ffn_bwd<decltype(d)::value>(xp, w1p, bp, gp, tp, dyp, w2p, sp, gout, dhp,
                                                   lnp, part, dlp, M, F, T, threshold, scale,
                                                   eps, s);
  });
}
