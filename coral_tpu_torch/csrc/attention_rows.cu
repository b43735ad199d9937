// The short-T attention's backwards of the routes other than v3 (K15): the
// backward mainloop's pair of `attention.cuh` with the policies that sweep
// the keys twice in the dq kernel. Shapes, layout and rounding as
// `attention.cuh` says.
//
// Replaces (coral_tpu/ops/attention_pallas.py):
// - `_bwd_pallas_stats` / `_bwd_kernel_stats` (:676, :174), the backward of
//   `attention_save_stats` true and "v2": p = exp(s + bias - lse) from the
//   clamped lse, delta = sum_j p_ij dp_ij (mode 0, bwd::Stats);
// - `_bwd_pallas` / `_bwd_kernel` (:581, :466), the backward of
//   `attention_save_stats: false`: p = e / l recomputed from q and k with its
//   own row max m and sum l, no clamp, delta = sum_j p_ij dp_ij (mode 1,
//   bwd::Recompute);
// - `_bwd_ctx_pallas` / `_bwd_kernel_ctx` (:597, :407), the backward of
//   `attention_o_residual: true`: p as mode 1, delta = rowsum(do * o) from the
//   saved o (mode 2, bwd::Ctx).
// The TPU kernels hold a head's whole (T, T) p in VMEM and form delta from it
// before ds; its transposed score space (:174) is Mosaic's output-block rule,
// not part of the function.
//
// Bound on the H100: as the v3 backward, the tensor cores and the
// exponentials; the dq kernel's first sweep adds one score product (modes 0
// and 1 also the dp product) and T^2 exponentials per head, counted against
// the bound, not into it.
//
// Design: the dkv kernel works on 128 keys at a time and needs every query
// row's p and delta before it starts, so the dq kernel, launched first,
// sweeps its rows' key tiles twice: the first sweep forms the row stats
// (mode 0: delta = sum_j p dp against the given lse; modes 1 and 2: the
// online m and l, and in mode 1 delta = (sum_j e_j dp_j) / l, the sum taken
// against the running max and rescaled with it) and writes them to (B, H, T)
// fp32 scratch; the second is the v3 backward's dq sweep with p from the lse
// (mode 0) or from m and 1 / l, and delta from the sweep or from o. m and l
// stay apart for the masked-row reason `attention.cuh` gives. The dkv kernel
// then stages them beside each query tile.
#include "attention.cuh"

namespace {

enum RowMode { kStatsDelta = 0, kRecompute = 1, kCtx = 2 };

}  // namespace

// Launches the backward's pair on `stream` at head dim D (64, 80 or 120),
// without q/k/v biases, the dq kernel first. mode 0: lse (B, H, T) given,
// delta scratch written; mode 1: m, l and delta scratch written; mode 2: m,
// l and delta scratch written, o (B, T, H*D) bf16 read. Scratch is (B, H, T)
// fp32 each, m in log2 units. dq, dk, dv: (B, T, H*D) bf16 each with row
// stride stride_d. scale and sm_scale as coral_attention_bwd. Returns the
// tensor-map encoder's error or the cudaError_t of the launches, -1 for a
// head dim they were not built for, cudaErrorInvalidValue for another mode.
extern "C" int coral_attention_bwd_rows(const void* q, const void* k, const void* v,
                                        const void* key_bias, const void* dout,
                                        const void* lse, const void* o, void* m, void* l,
                                        void* delta, void* dq, void* dk, void* dv, int B, int T,
                                        int H, int D, long long stride_b, long long stride_t,
                                        long long stride_d, float scale, float sm_scale,
                                        int mode, void* stream) {
  if (D != 64 && D != 80 && D != 120) return -1;
  if (mode < kStatsDelta || mode > kCtx) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bwd::Args args = bwd::short_t_args(dout, o, lse, nullptr, nullptr, nullptr, key_bias, m,
                                           l, delta, nullptr, T, H, stride_d, scale, sm_scale);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto go = [&](auto policy) {
      return bwd::launch_pair<kD, decltype(policy)>(q, k, v, args, dq, dk, dv, B, stride_b,
                                                    stride_t, s);
    };
    switch (mode) {
      case kStatsDelta: return go(bwd::Stats{});
      case kRecompute: return go(bwd::Recompute{});
      default: return go(bwd::Ctx{});
    }
  });
}
