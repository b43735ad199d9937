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
// Design: csrc/ffn_tiles.cuh (the panel, the K loop, the epilogue), with
// the LayerNorm folded into the panel (kLn).
#include "ffn_tiles.cuh"

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
//  (i)  ffn_bwd_kernel<kLn, kDgIn, kEmitG> (csrc/ffn_tiles.cuh): the
//       LayerNorm panel as the forward (written once as ln_out, the dW1
//       operand), h = ln W1^T + b1, dg = dy W2^T in the kernel, g (the dW2
//       operand), dh and the column sums of the fp32 dh over its BM rows (the
//       db1 partial);
//  (ii) dl_kernel: dl = dh @ W1 in fp32, 128 x 128 tiles;
//  (iii) the LayerNorm backward of csrc/ln_gelu.cu on (x, dl) (apply_gelu=0,
//       fp32 dy), launched by the wrapper, for dx and the dgamma/dbeta
//       partials.
// dW1 = ln_out^T dh, dW2 = dy^T g, db2 and the sums of the partials stay
// outside, as in `_ffn_ln_block_dg_bwd`.

// The rows per block of the kernels at width D (the db1 partial's row tile),
// or -1 for a width they were not built for.
extern "C" int coral_ffn_row_tile(int D) { return built_row_tile(D); }

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
    return (int)launch_ffn_fwd<decltype(d)::value, true>(xp, wp, bp, gp, tp, sp, out, M, F, T,
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
    return (int)launch_ffn_bwd<decltype(d)::value, true, true, true>(
        xp, w1p, bp, gp, tp, dyp, w2p, sp, gout, dhp, lnp, part, dlp, M, F, T, threshold, scale,
        eps, s);
  });
}
