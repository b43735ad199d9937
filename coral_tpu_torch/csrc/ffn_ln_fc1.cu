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
// Design: K5's backward (csrc/ffn.cu) with dg read from device memory instead
// of formed from dy and W2, and no g: ffn_bwd_kernel<kLn, !kDgIn, !kEmitG>
// (csrc/ffn_tiles.cuh), dl_kernel in fp32, then the LayerNorm backward of
// csrc/ln_gelu.cu on (x, dl), launched by the wrapper, for dx and the
// dgamma/dbeta partials. Rows past M give dh = 0 and add nothing to the
// partials.
#include "ffn_tiles.cuh"

// At a built width D: dg (M, F) bf16; dh (M, F) bf16; ln_out (M, D) bf16;
// db1_part (ceil(M / coral_ffn_row_tile(D)), F) fp32; dl (M, D) fp32; seeds:
// (M / T,) int32, or null for rate 0. Returns the cudaError_t of the launches,
// or -1 for a shape they were not built for.
extern "C" int coral_ffn_ln_fc1_bwd(const void* x, const void* w1, const void* b1,
                                    const void* gamma, const void* beta, const void* dg,
                                    const void* seeds, void* dh, void* ln_out, void* db1_part,
                                    void* dl, long long M, int D, int F, int T,
                                    unsigned int threshold, float scale, float eps,
                                    void* stream) {
  if (built_row_tile(D) < 0 || F % kBN != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *w1p = static_cast<const bf16*>(w1),
             *dgp = static_cast<const bf16*>(dg);
  const float *bp = static_cast<const float*>(b1), *gp = static_cast<const float*>(gamma),
              *tp = static_cast<const float*>(beta);
  const int* sp = static_cast<const int*>(seeds);
  bf16 *dhp = static_cast<bf16*>(dh), *lnp = static_cast<bf16*>(ln_out);
  float *part = static_cast<float*>(db1_part), *dlp = static_cast<float*>(dl);
  return with_width(D, [&](auto d) {
    return (int)launch_ffn_bwd<decltype(d)::value, true, false, false>(
        xp, w1p, bp, gp, tp, dgp, nullptr, sp, nullptr, dhp, lnp, part, dlp, M, F, T, threshold,
        scale, eps, s);
  });
}
