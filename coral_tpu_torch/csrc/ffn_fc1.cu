// The FFN's fc1 without a LayerNorm: the up-projection kernel (with
// activation dropout) and its backward, for the post-LN encoder and for the
// routes that normalise outside the FFN (`fused_ffn_ln: false`).
//
// Forward (N1): g = dropout(gelu(x @ W1^T + b1)).
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas` :565 -> `_fwd_kernel`
// (rate 0) and `_fwd_kernel_drop` (rate > 0), the forward of `ffn_fc1` and of
// `ffn_block`.
//
// Backward (N2, N3): h recomputed from x, dh = dg * mask / keep * gelu'(h),
// dx = dh @ W1, the db1 rows; N3 also writes g (the dW2 operand).
// Replaces: `_bwd_pallas` :598 -> `_bwd_kernel[_drop]` (N2, the backward of
// `ffn_fc1`) and `_bwd_pallas_g` :637 -> `_bwd_kernel_g[_drop]` (N3, the
// backward of `ffn_block`, whose dg = dy @ W2^T is formed outside).
//
// Bound on the H100: the tensor cores: one product of 2 * D * F flops per row
// forward (2 KB in, 8 KB out at D = 1024), two backward (h again and dx),
// against 2 KB of x and 8 KB of dg in and 8 or 16 KB of dh (and g) out.
//
// Design: csrc/ffn_gemm.cuh's mainloop without the LayerNorm (x's chunks go
// by TMA straight to the products): ffn_fwd_kernel<gemm::Fwd<0, false,
// kDrop>> and ffn_bwd_kernel<gemm::Bwd<0, false, kDrop, false, kEmitG>> (dg
// read in as a bf16 tile), the width a runtime value (one instantiation for
// every width). The TPU kernel folds dx = dh W1 into the same pass while dh
// is in VMEM; here, as in K5's backward, it is a second kernel (dl_kernel,
// bf16 out, rounded once from its fp32 sums), since a 128-row block of all D
// columns does not fit beside the F tile. Rows past M give dh = 0 and add
// nothing to the db1 partial (`_bwd_epilogue` masks them).
#include "ffn_gemm.cuh"

// Forward at a built width D; seeds: (M / T,) int32, or null for rate 0
// (threshold and scale are then not read). Returns the cudaError_t of the
// launch or the encoder's error, or -1 for a shape it was not built for.
extern "C" int coral_ffn_fc1_fwd(const void* x, const void* w1, const void* b1,
                                 const void* seeds, void* g, long long M, int D, int F, int T,
                                 unsigned int threshold, float scale, void* stream) {
  if (F % 256 != 0 || (seeds != nullptr && T <= 0) || !built_width(D)) return -1;
  if (M <= 0) return 0;
  return gemm::launch_fwd<0, false>(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                                    static_cast<const float*>(b1), nullptr, nullptr,
                                    static_cast<const int*>(seeds), static_cast<bf16*>(g), M, D,
                                    F, T, threshold, scale, 0.f,
                                    static_cast<cudaStream_t>(stream));
}

// Backward at a built width D: dg (M, F) bf16; g (M, F) bf16, or null for
// N2 (no g written); dh (M, F) bf16; db1_part (ceil(M / coral_ffn_row_tile(D)),
// F) fp32; dx (M, D) bf16; seeds as the forward. Returns the cudaError_t of
// the launches or the encoder's error, or -1 for a shape they were not built
// for.
extern "C" int coral_ffn_fc1_bwd(const void* x, const void* w1, const void* b1, const void* dg,
                                 const void* seeds, void* g, void* dh, void* db1_part, void* dx,
                                 long long M, int D, int F, int T, unsigned int threshold,
                                 float scale, void* stream) {
  if (!built_width(D) || F % 256 != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  const bf16 *xp = static_cast<const bf16*>(x), *w1p = static_cast<const bf16*>(w1),
             *dgp = static_cast<const bf16*>(dg);
  const float* bp = static_cast<const float*>(b1);
  const int* sp = static_cast<const int*>(seeds);
  bf16 *gout = static_cast<bf16*>(g), *dhp = static_cast<bf16*>(dh),
       *dxp = static_cast<bf16*>(dx);
  float* part = static_cast<float*>(db1_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gout != nullptr)
    return gemm::launch_bwd<0, false, false, true>(xp, w1p, bp, nullptr, nullptr, dgp, nullptr,
                                                   sp, gout, dhp, nullptr, part, dxp, M, D, F, T,
                                                   threshold, scale, 0.f, s);
  return gemm::launch_bwd<0, false, false, false>(xp, w1p, bp, nullptr, nullptr, dgp, nullptr,
                                                  sp, gout, dhp, nullptr, part, dxp, M, D, F, T,
                                                  threshold, scale, 0.f, s);
}
