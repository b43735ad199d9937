// The FFN up-projection's kernel templates, shared by csrc/ffn.cu (the
// LayerNorm-folded block, K5), csrc/ffn_fc1.cu (fc1 without the LayerNorm)
// and csrc/ffn_ln_fc1.cu (the LayerNorm-folded fc1's backward). Each source
// instantiates its own variants, so their nvcc processes run side by side.
//
// Design: one block per (BM rows, 256 of the F columns), BM = 64 wherever the
// panel below fits (D = 384 to 1280) and 32 at D = 1920 (XLS-R-2B), where a
// 64-row panel (247 KB) is over a block's 227 KB. The prologue fills a BM x D
// bf16 panel in shared memory (132 KB at D = 1024, 165 KB at 1280, 123 KB at
// 1920 with 32 rows) for the K loop: with the LayerNorm (kLn) the fp32
// LayerNorm of its rows (two-pass, as `_ln_rows`) rounded to bf16 as
// `_ln_matmul` does, so the normalised tensor never reaches device memory;
// without it the rows of x as they are. A lane owns whole lane vectors of the
// row: 8 values where D is a multiple of 256, else 4 (384 = 3 x 128, 1920 =
// 15 x 128). The K loop streams 256 x 32 tiles of W1 (stored (F, D), K
// contiguous per column) into bf16 WMMA fragments with fp32 accumulators,
// eight warps of BM/2 x 64 each. The epilogue stages the accumulators through
// shared memory (over the dead panel and W1 tile), adds b1, applies the
// polynomial GELU and the dropout mask (csrc/philox.cuh: a pure function of
// seed[b], row t and column, not of the tiling). Every width any config of
// the repository uses is built: 384, 512, 768 (Whisper tiny, base, small),
// 1024 (XLS-R-300M, Whisper medium), 1280 (Whisper large, XLS-R-1B), 1920.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "gelu_poly.cuh"
#include "philox.cuh"

namespace {

using namespace nvcuda;

constexpr int kBN = 256;       // F columns per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int kLdB = kBK + 8;  // bf16 row pitch of the W1 tile (and the dy chunk)
constexpr int kLdC = kBN + 4;  // fp32 row pitch of the staged accumulators
constexpr int kLdW = kBN + 8;  // bf16 row pitch of the W2 tile
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100

// The panel (BM rows at pitch D + 8) and a W1 tile.
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

// Rows m0 .. m0+BM-1 of x copied into As as they are (rows past M are zero),
// 16 bytes a thread at a time: the panel of the kernels without the LayerNorm.
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

// --- Forward -------------------------------------------------------------------
//
// g = dropout(gelu(A @ W1^T + b1)), A = bf16(layer_norm(x)) (kLn) or x.
// x: (M, D) bf16; w1: (F, D) bf16; b1: (F,) fp32; gamma, beta: (D,) fp32
// (kLn); seeds: (M / T,) int32 (kDrop); g: (M, F) bf16, 16 bytes a lane.
template <int D, bool kDrop, bool kLn>
__global__ void __launch_bounds__(kThreads)
    ffn_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
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

  if constexpr (kLn) ln_panel<D, BM>(As, x, gamma, beta, m0, M, eps, nullptr);
  else x_panel<D, BM>(As, x, m0, M);
  __syncthreads();
  FragC acc[BM / 32][4];
  panel_times_w1<D, BM>(acc, As, Bs, w1, n0);
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
// ffn_bwd_kernel, one block per (BM rows, 256 F columns): the panel as the
// forward's (with kLn written once as ln_out, the dW1 operand),
// h = A W1^T + b1 over the whole D; dg either formed in the kernel as
// dy W2^T over the whole D with dy and W2 streamed in 32-wide chunks (kDgIn),
// or read as bf16 rows of dg from device memory; the epilogue regenerates the
// forward's dropout mask from the same seeds, writes dh = dg * mask / keep *
// gelu'(h) in bf16, g (kEmitG, the dW2 operand), and the column sums of the
// fp32 dh over its BM rows (the db1 partial; rows past M add nothing).
// dl_kernel then forms dh @ W1: the layer's dx without the LayerNorm, else the
// dl that csrc/ln_gelu.cu's LayerNorm backward turns into dx, dgamma, dbeta.
//
// Shared memory: the forward's stage, then, after the h product, the regions
// below over it; each instantiation takes the larger of the two (the regions
// are the larger at D = 384 and 512, where the panel is small).
// The regions at row tile BM: the staged h, then with kDgIn the dy chunk, the
// W2 tile and the staged dg after the loop; the column-sum partials.
template <int BM>
__host__ __device__ constexpr int off_y() { return BM * kLdC * 4; }
template <int BM>
__host__ __device__ constexpr int off_w() { return off_y<BM>() + BM * kLdB * 2; }
template <int BM>
__host__ __device__ constexpr int off_g() { return off_y<BM>(); }
template <int BM, bool kDgIn>
__host__ __device__ constexpr int off_red() {
  return kDgIn ? off_g<BM>() + BM * kLdC * 4 : off_y<BM>();
}
template <int BM, bool kDgIn>
__host__ __device__ constexpr int regions_end() { return off_red<BM, kDgIn>() + 4 * kBN * 4; }
template <int D, bool kDgIn>
__host__ __device__ constexpr int bwd_smem() {
  return max_int(fwd_smem(D), regions_end<row_tile(D), kDgIn>());
}

// dy: (M, D) bf16 with kDgIn, else dg: (M, F) bf16; w2: (D, F) bf16 (kDgIn);
// g, dh: (M, F) bf16; ln_out: (M, D) bf16 (kLn); db1_part: (ceil(M / BM), F)
// fp32.
template <int D, bool kDrop, bool kLn, bool kDgIn, bool kEmitG>
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
  static_assert(bwd_smem<D, kDgIn>() <= kMaxSmem,
                "the backward's stage must fit a block's shared memory");
  static_assert(!kDgIn || off_w<BM>() + kBK * kLdW * 2 <= bwd_smem<D, kDgIn>(),
                "the dg operands must fit this width's stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * (D + 8);
  float* Hs = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + off_red<BM, kDgIn>());

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;

  if constexpr (kLn)
    ln_panel<D, BM>(As, x, gamma, beta, m0, M, eps, blockIdx.y == 0 ? ln_out : nullptr);
  else
    x_panel<D, BM>(As, x, m0, M);
  __syncthreads();
  FragC acc[kFR][4];
  panel_times_w1<D, BM>(acc, As, Bs, w1, n0);
  stage<BM>(Hs, acc);  // h - b1, over the dead panel

  float* Gs = nullptr;
  if constexpr (kDgIn) {
    // dg = dy W2^T: BM x 32 chunks of dy and 32 x 256 tiles of W2 (stored
    // (D, F), F contiguous).
    bf16* Ys = reinterpret_cast<bf16*>(smem + off_y<BM>());
    bf16* Ws = reinterpret_cast<bf16*>(smem + off_w<BM>());
    Gs = reinterpret_cast<float*>(smem + off_g<BM>());
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 2;
    const int wc = warp & 3;
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
  }
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
    float dgv[4];
    if constexpr (kDgIn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dgv[e] = Gs[r * kLdC + c0 + e];
    } else {
      coral_load4(dy + row * F + n0 + c0, dgv);
    }
    float gv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = Hs[r * kLdC + c0 + e] + bias[e];
      if (kDrop) {
        gv[e] = keep[e] ? coral_gelu(h) * scale : 0.f;
        dv[e] = keep[e] ? dgv[e] * scale * coral_dgelu(h) : 0.f;
      } else {
        gv[e] = coral_gelu(h);
        dv[e] = dgv[e] * coral_dgelu(h);
      }
      colsum[e] += dv[e];
    }
    if constexpr (kEmitG) coral_store4(g + row * F + n0 + c0, gv);
    coral_store4(dh + row * F + n0 + c0, dv);
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

// out = dh @ W1: dh (M, F) bf16, W1 (F, D) bf16 row-major, out (M, D) fp32
// (dl, the LayerNorm backward's input) or bf16 (dx, rounded once).
// 128 x 128 tiles, eight warps of 32 x 64, 32-deep chunks.
constexpr int kGM = 128;
constexpr int kGN = 128;
constexpr int kLdGA = kBK + 8;
constexpr int kLdGB = kGN + 8;
static_assert(kGM * kLdGA * 2 >= 8 * 256 * 4, "the output staging must fit the A tile");

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads)
    dl_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ w1, OutT* __restrict__ dl,
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
        OutT* out = dl + row * D + n0 + wc * 64 + j * 16 + c;
        if constexpr (std::is_same<OutT, bf16>::value) {
          coral_store8(out, St + r * 16 + c);
        } else {
          coral_store4(out, St + r * 16 + c);
          coral_store4(out + 4, St + r * 16 + c + 4);
        }
      }
      __syncwarp();
    }
  }
}

// Sets the dynamic shared memory of `kernel` and launches it; returns the
// cudaError_t of the two.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int smem, cudaStream_t s, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// Launches the forward at width D, with dropout when seeds are given.
template <int D, bool kLn>
cudaError_t launch_ffn_fwd(const bf16* xp, const bf16* wp, const float* bp, const float* gp,
                           const float* tp, const int* sp, bf16* out, long long M, int F, int T,
                           unsigned int threshold, float scale, float eps, cudaStream_t s) {
  constexpr int BM = row_tile(D);
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / kBN));
  if (sp != nullptr)
    return launch_with_smem(ffn_fwd_kernel<D, true, kLn>, grid, fwd_smem(D), s, xp, wp, bp, gp,
                            tp, sp, out, M, F, T, (uint32_t)threshold, scale, eps);
  return launch_with_smem(ffn_fwd_kernel<D, false, kLn>, grid, fwd_smem(D), s, xp, wp, bp, gp,
                          tp, sp, out, M, F, 1, 0u, 1.0f, eps);
}

// Launches the backward kernel at width D (with dropout when seeds are given),
// then out = dh @ W1.
template <int D, bool kLn, bool kDgIn, bool kEmitG, typename OutT>
cudaError_t launch_ffn_bwd(const bf16* xp, const bf16* w1p, const float* bp, const float* gp,
                           const float* tp, const bf16* dyp, const bf16* w2p, const int* sp,
                           bf16* gout, bf16* dhp, bf16* lnp, float* part, OutT* outp,
                           long long M, int F, int T, unsigned int threshold, float scale,
                           float eps, cudaStream_t s) {
  constexpr int BM = row_tile(D);
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)(F / kBN));
  constexpr int smem = bwd_smem<D, kDgIn>();
  cudaError_t err;
  if (sp != nullptr)
    err = launch_with_smem(ffn_bwd_kernel<D, true, kLn, kDgIn, kEmitG>, grid, smem, s, xp, w1p,
                           bp, gp, tp, dyp, w2p, sp, gout, dhp, lnp, part, M, F, T,
                           (uint32_t)threshold, scale, eps);
  else
    err = launch_with_smem(ffn_bwd_kernel<D, false, kLn, kDgIn, kEmitG>, grid, smem, s, xp, w1p,
                           bp, gp, tp, dyp, w2p, sp, gout, dhp, lnp, part, M, F, 1, 0u, 1.0f,
                           eps);
  if (err != cudaSuccess) return err;
  const dim3 grid_dl((unsigned)(D / kGN), (unsigned)((M + kGM - 1) / kGM));
  dl_kernel<D, OutT><<<grid_dl, kThreads, 0, s>>>(dhp, w1p, outp, M, F);
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

// The rows per block of the kernels at width D, or -1 for an unbuilt width.
inline int built_row_tile(int D) {
  return with_width(D, [](auto d) { return row_tile(decltype(d)::value); });
}

}  // namespace
