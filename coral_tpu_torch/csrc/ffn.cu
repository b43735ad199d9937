// The pre-LN FFN block (K5): the forward's up-projection kernel (with
// activation dropout) and the backward's kernels, on csrc/ffn_gemm.cuh's
// Hopper mainloop.
//
// Forward: g = dropout(gelu(bf16(layer_norm(x)) @ W1^T + b1)).
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_ln` :824 -> :841 ->
// `_fwd_kernel_ln` :163 (rate 0) and `_fwd_kernel_ln_drop` :169 (rate > 0),
// the forward of `ffn_ln_block`, the pre-LN FFN of every wav2vec2 encoder
// layer and of Whisper's. fc2 stays outside the kernel, as in the JAX package
// (`_fc2`). Instantiation: ffn_fwd_kernel<gemm::Fwd<D, kLn, kDrop>> at every
// built width.
//
// Bound on the H100: the tensor cores. The product is 2 D F flops a row
// against 2 D bytes of x in and 2 F bytes of g out: at XLS-R-300M's D =
// 1024, F = 4096, 8.4 MFLOP against 10 KB (Whisper large-v3 and XLS-R-1B: D
// = 1280, F = 5120), hundreds of flops a byte, above the card's 295. The
// design keeps the tensor cores fed: TMA copies of x chunks and W1 tiles
// into a three-stage ring run ahead of two consumer warpgroups issuing
// wgmma; the LayerNorm is applied to each landed 64-column x chunk by the
// producer warpgroup (row statistics computed once per block), so it
// overlaps the products; 256 columns a tile and several tiles a block.
//
// Backward. Replaces: `_bwd_pallas_ln_g_dg` :714 -> :737 ->
// `_bwd_kernel_ln_g_dg` :366 (rate 0) and `_bwd_kernel_ln_g_dg_drop` :385
// (rate > 0), the backward of `ffn_ln_block` with dg computed in the kernel.
// Bound on the H100: the tensor cores: three products of 2 D F flops a row
// (h recomputed, dg = dy W2^T, dl = dh W1), against 4 KB of x and dy in and
// 16 KB of g and dh out (at D = 1024; 5 KB and 20 KB at 1280).
//
// The TPU kernel holds a (TM, F) block and its (TM, D) LayerNorm backward in
// VMEM at once: dl = dh W1 must be complete over all D columns of a row
// before any dx is written. A 128-row tile of dl alone is 512 KB of fp32 (640
// KB at D = 1280), more than an SM's 227 KB, so the work is three kernels:
//  (i)  ffn_bwd_kernel<gemm::Bwd<D, kLn, kDrop, kDgIn, kEmitG>>: the
//       LayerNorm applied to the streamed x chunks as the forward's (written
//       once as ln_out, the dW1 operand, by column tile 0's blocks), h = ln
//       W1^T + b1 and dg = dy W2^T as two accumulators of one pipeline (each
//       stage carries the x chunk, W1's tile, dy's chunk and W2's tile), then
//       g (the dW2 operand), dh and the column sums of the fp32 dh over its
//       128 rows (the db1 partial);
//  (ii) dl_kernel<gemm::Dl<float>>: dl = dh @ W1 in fp32, on the same
//       mainloop with W1 as the N-major operand;
//  (iii) the LayerNorm backward of csrc/ln_gelu.cu on (x, dl) (apply_gelu=0,
//       fp32 dy), launched by the wrapper, for dx and dgamma, dbeta.
// dW1 = ln_out^T dh, dW2 = dy^T g, db2 and the sums of the partials stay
// outside, as in `_ffn_ln_block_dg_bwd`.
#include "ffn_gemm.cuh"

// The rows per block of the kernels at width D (the db1 partial's row tile,
// the same at every width), or -1 for a width they were not built for.
extern "C" int coral_ffn_row_tile(int D) { return built_width(D) ? gemm::kRows : -1; }

// Forward. seeds: (M / T,) int32, or null for rate 0 (threshold and scale are
// then not read). D is a built width (coral_ffn_row_tile). Returns the
// cudaError_t of the launch or the tensor-map encoder's error, or -1 for a
// shape it was not built for.
extern "C" int coral_ffn_ln_fwd(const void* x, const void* w1, const void* b1,
                                const void* gamma, const void* beta, const void* seeds,
                                void* g, long long M, int D, int F, int T,
                                unsigned int threshold, float scale, float eps, void* stream) {
  if (F % 256 != 0 || (seeds != nullptr && T <= 0) || !built_width(D)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    return gemm::launch_fwd<decltype(d)::value, true>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const int*>(seeds), static_cast<bf16*>(g), M, D, F, T, threshold, scale,
        eps, static_cast<cudaStream_t>(stream));
  });
}

// Backward kernels (i) and (ii) at a built width D; seeds as the forward.
// db1_part has ceil(M / coral_ffn_row_tile(D)) rows of F. Returns the
// cudaError_t of the launches or the encoder's error, or -1 for a shape they
// were not built for.
extern "C" int coral_ffn_bwd(const void* x, const void* w1, const void* b1, const void* gamma,
                             const void* beta, const void* dy, const void* w2, const void* seeds,
                             void* g, void* dh, void* ln_out, void* db1_part, void* dl,
                             long long M, int D, int F, int T, unsigned int threshold,
                             float scale, float eps, void* stream) {
  if (!built_width(D) || F % 256 != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    return gemm::launch_bwd<decltype(d)::value, true, true, true>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(dy), static_cast<const bf16*>(w2),
        static_cast<const int*>(seeds), static_cast<bf16*>(g), static_cast<bf16*>(dh),
        static_cast<bf16*>(ln_out), static_cast<float*>(db1_part), static_cast<float*>(dl), M,
        D, F, T, threshold, scale, eps, static_cast<cudaStream_t>(stream));
  });
}
