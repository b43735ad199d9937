// The LayerNorm-folded block's forward with fc2 in the kernel (N7), the route
// of `fused_ffn_block_fc2: true`: y = dropout(gelu(bf16(layer_norm(x)) W1^T
// + b1)) W2^T + b2, g never in device memory. Its backward is N5
// (csrc/ffn_ln_g.cu).
//
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_ln_fc2` :924 ->
// `_fwd_kernel_ln_fc2` :451 (rate 0) and `_fwd_kernel_ln_fc2_drop` :467
// (rate > 0). g is rounded to bf16 before fc2, and the fc2 sum is fp32 plus
// b2, rounded once to bf16: the rounding of the composed `_fc2` :1677, bit
// for bit in exact arithmetic.
//
// Bound on the H100: the tensor cores: two products of 2 * D * F flops per
// row (fc1, fc2) against 2 KB of x in and 2 KB of y out at D = 1024 (2.5 KB
// each at 1280), and the weights once.
//
// Design: fc2 contracts over the whole of F, so a block must see every F
// column of its rows. The TPU kernel holds all of F and D in VMEM; here a
// block owns 16 rows and loops over F in 256-column tiles, deterministically
// (no atomics: each y is summed by one warp in one order). Per tile, each of
// the eight warps forms a 16 x 32 slice of h against the LayerNorm panel
// (16 x D bf16 in shared memory, computed once, as K5's), applies b1, the
// polynomial GELU and the dropout mask (csrc/philox.cuh: the Philox bits of
// (seed[b], row, column) that K5's forward writes and N5's backward
// regenerates), and writes its slice of the bf16 g tile to shared memory;
// then each warp adds g_tile W2[:, tile]^T into its own D / 8 columns of y,
// held in WMMA accumulators in registers across the whole F loop (D / 128
// fragments of 16 x 16: 15 at D = 1920). At 16 rows no weight element is
// used by two warps of a block, so the W1 and W2 tiles are read straight from
// device memory (L2) into fragments, not staged; each block reads all of W1
// and W2 once. The epilogue stages each y fragment through shared memory,
// adds b2 and writes bf16 rows below M.
#include "ffn_gemm.cuh"  // with_width, built_width
#include "ffn_tiles.cuh"

namespace {

constexpr int kFcBM = 16;         // rows per block
constexpr int kLdG = kBN + 8;     // bf16 row pitch of the g tile

// The LayerNorm panel, the staged h slices (16 x kLdC fp32) and the g tile.
__host__ __device__ constexpr int fc2_panel_bytes(int D) { return kFcBM * (D + 8) * 2; }
__host__ __device__ constexpr int fc2_smem(int D) {
  return fc2_panel_bytes(D) + kFcBM * kLdC * 4 + kFcBM * kLdG * 2;
}

// x: (M, D) bf16; w1: (F, D) bf16; b1: (F,) fp32; gamma, beta, b2: (D,) fp32;
// w2: (D, F) bf16; seeds: (M / T,) int32 (kDrop); y: (M, D) bf16. w1 and w2
// 32-byte aligned (WMMA loads from device memory).
template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads)
    ffn_ln_fc2_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const bf16* __restrict__ w2,
                      const float* __restrict__ b2, const int* __restrict__ seeds,
                      bf16* __restrict__ y, long long M, int F, int T, uint32_t threshold,
                      float scale, float eps) {
  constexpr int kYF = D / 128;  // y fragments of a warp: columns warp * D / 8 ..
  static_assert(kYF * 128 == D, "a warp owns whole 16-column fragments of y");
  static_assert(fc2_smem(D) <= kMaxSmem, "the stage must fit a block's shared memory");
  static_assert(kThreads / 32 * 256 <= kFcBM * kLdC, "the y staging must fit the h stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + fc2_panel_bytes(D));
  bf16* Gs = reinterpret_cast<bf16*>(smem + fc2_panel_bytes(D) + kFcBM * kLdC * 4);

  const long long m0 = (long long)blockIdx.x * kFcBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ycol = warp * (D / 8);

  ln_panel<D, kFcBM>(As, x, gamma, beta, m0, M, eps);
  __syncthreads();
  FragC yacc[kYF];
#pragma unroll
  for (int j = 0; j < kYF; ++j) wmma::fill_fragment(yacc[j], 0.0f);

  for (int n0 = 0; n0 < F; n0 += kBN) {
    // h - b1 for this warp's columns n0 + warp*32 .. +31 of the 16 rows.
    const bf16* w1t = w1 + (long long)(n0 + warp * 32) * D;
    FragC acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll 4
    for (int k = 0; k < D; k += 16) {
      FragA a;
      FragB b0, b1f;
      wmma::load_matrix_sync(a, As + k, D + 8);
      wmma::load_matrix_sync(b0, w1t + k, D);
      wmma::load_matrix_sync(b1f, w1t + 16 * D + k, D);
      wmma::mma_sync(acc[0], a, b0, acc[0]);
      wmma::mma_sync(acc[1], a, b1f, acc[1]);
    }
    wmma::store_matrix_sync(Cs + warp * 32, acc[0], kLdC, wmma::mem_row_major);
    wmma::store_matrix_sync(Cs + warp * 32 + 16, acc[1], kLdC, wmma::mem_row_major);
    __syncwarp();
    {
      // Lane: row lane/2, 16 columns; rows past M are zeros (never stored).
      const int r = lane >> 1;
      const int c = warp * 32 + (lane & 1) * 16;
      const long long row = m0 + r;
      float out[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) out[e] = 0.f;
      if (row < M) {
#pragma unroll
        for (int e = 0; e < 16; ++e) out[e] = coral_gelu(Cs[r * kLdC + c + e] + b1[n0 + c + e]);
        if (kDrop) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bool keep[8];
            coral_keep8((uint32_t)seeds[row / T], (uint32_t)(row % T), n0 + c + 8 * h,
                        threshold, keep);
#pragma unroll
            for (int e = 0; e < 8; ++e) out[8 * h + e] = keep[e] ? out[8 * h + e] * scale : 0.f;
          }
        }
      }
      coral_store8(Gs + r * kLdG + c, out);  // rounds to bf16, fc2's operand
      coral_store8(Gs + r * kLdG + c + 8, out + 8);
    }
    __syncthreads();  // the g tile is whole
    // y[:, ycol ..] += g_tile W2[ycol .., n0 .. n0+255]^T
#pragma unroll 2
    for (int kk = 0; kk < kBN; kk += 16) {
      FragA a;
      wmma::load_matrix_sync(a, Gs + kk, kLdG);
#pragma unroll
      for (int j = 0; j < kYF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, w2 + (long long)(ycol + j * 16) * F + n0 + kk, F);
        wmma::mma_sync(yacc[j], a, b, yacc[j]);
      }
    }
    __syncthreads();  // every warp is done with the g tile and its h slice
  }

  // Epilogue: each warp stages one y fragment at a time through its own 1 KB
  // of the dead h stage, adds b2 and writes the rows below M.
  float* St = Cs + warp * 256;
  const int r = lane >> 1;
  const int c = (lane & 1) * 8;
  const long long row = m0 + r;
#pragma unroll
  for (int j = 0; j < kYF; ++j) {
    wmma::store_matrix_sync(St, yacc[j], 16, wmma::mem_row_major);
    __syncwarp();
    if (row < M) {
      const int col = ycol + j * 16 + c;
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = St[r * 16 + c + e] + b2[col + e];
      coral_store8(y + row * D + col, out);
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch_ffn_ln_fc2(const bf16* xp, const bf16* w1p, const float* bp,
                              const float* gp, const float* tp, const bf16* w2p,
                              const float* b2p, const int* sp, bf16* out, long long M, int F,
                              int T, unsigned int threshold, float scale, float eps,
                              cudaStream_t s) {
  const dim3 grid((unsigned)((M + kFcBM - 1) / kFcBM));
  if (sp != nullptr)
    return launch_with_smem<ffn_ln_fc2_kernel<D, true>>(grid, fc2_smem(D), s, xp, w1p, bp, gp,
                                                        tp, w2p, b2p, sp, out, M, F, T,
                                                        (uint32_t)threshold, scale, eps);
  return launch_with_smem<ffn_ln_fc2_kernel<D, false>>(grid, fc2_smem(D), s, xp, w1p, bp, gp, tp,
                                                       w2p, b2p, sp, out, M, F, 1, 0u, 1.0f, eps);
}

}  // namespace

// At a built width D (built_width); seeds: (M / T,) int32, or null for
// rate 0 (threshold and scale are then not read). Returns the cudaError_t of
// the launch, or -1 for a shape it was not built for.
extern "C" int coral_ffn_ln_fc2_fwd(const void* x, const void* w1, const void* b1,
                                    const void* gamma, const void* beta, const void* w2,
                                    const void* b2, const void* seeds, void* y, long long M,
                                    int D, int F, int T, unsigned int threshold, float scale,
                                    float eps, void* stream) {
  if (!built_width(D) || F % kBN != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    return (int)launch_ffn_ln_fc2<decltype(d)::value>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(w2), static_cast<const float*>(b2),
        static_cast<const int*>(seeds), static_cast<bf16*>(y), M, F, T, threshold, scale, eps,
        static_cast<cudaStream_t>(stream));
  });
}
