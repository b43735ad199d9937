// The backward of the LayerNorm-folded fc1 without the block (N4), the route
// of `fused_ffn_block: false`; its forward is csrc/ffn.cu's.
//
// Replaces: coral_tpu/ops/ffn_pallas.py `_bwd_pallas_ln` :872 ->
// `_bwd_kernel_ln` (rate 0) and `_bwd_kernel_ln_drop` (rate > 0), the
// backward of `ffn_ln_fc1`: the LayerNorm and h recomputed from x, dh =
// dg * mask / keep * gelu'(h), ln_out (the dW1 operand), dx through the
// LayerNorm backward, the db1 and dgamma/dbeta rows.
//
// Bound on the H100: the tensor cores: two products of 2 * D * F flops per
// row (h again, dl = dh W1), against 2 KB of x and 8 KB of dg in and 8 KB of
// dh, 2 KB of ln_out and 2 KB of dx out (at D = 1024; 2.5, 10, 10, 2.5, 2.5 KB
// at 1280).
//
// Design: K5's backward (csrc/ffn.cu) with dg read from device memory (a
// bf16 tile by TMA for the epilogue) instead of formed from dy and W2, and no
// g: ffn_bwd_kernel<gemm::Bwd<D, kLn, kDrop, !kDgIn, !kEmitG>>
// (csrc/ffn_gemm.cuh), dl_kernel in fp32, then the LayerNorm backward of
// csrc/ln_gelu.cu on (x, dl), launched by the wrapper, for dx and the
// dgamma/dbeta partials. Rows past M give dh = 0 and add nothing to the
// partials.
#include "ffn_gemm.cuh"

// At a built width D: dg (M, F) bf16; dh (M, F) bf16; ln_out (M, D) bf16;
// db1_part (ceil(M / coral_ffn_row_tile(D)), F) fp32; dl (M, D) fp32; seeds:
// (M / T,) int32, or null for rate 0. Returns the cudaError_t of the launches
// or the encoder's error, or -1 for a shape they were not built for.
extern "C" int coral_ffn_ln_fc1_bwd(const void* x, const void* w1, const void* b1,
                                    const void* gamma, const void* beta, const void* dg,
                                    const void* seeds, void* dh, void* ln_out, void* db1_part,
                                    void* dl, long long M, int D, int F, int T,
                                    unsigned int threshold, float scale, float eps,
                                    void* stream) {
  if (!built_width(D) || F % 256 != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    return gemm::launch_bwd<decltype(d)::value, true, false, false>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(dg), nullptr, static_cast<const int*>(seeds), nullptr,
        static_cast<bf16*>(dh), static_cast<bf16*>(ln_out), static_cast<float*>(db1_part),
        static_cast<float*>(dl), M, D, F, T, threshold, scale, eps,
        static_cast<cudaStream_t>(stream));
  });
}
