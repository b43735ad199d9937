// Bidirectional short-T attention on the flat (B, T, H*d) layout: the
// forwards of every variant and the v3 backward. Shapes, layout and rounding
// as `attention.cuh` says.
//
// Replaces (coral_tpu/ops/attention_pallas.py):
// - `_fwd_pallas_stats_v2_qb` / `_fwd_kernel_stats_v2_qb` (the v3-stats
//   forward with in-kernel q/k/v biases, the wav2vec2 serving default), and
//   without biases `_fwd_pallas_stats_v2` / `_fwd_kernel_stats_v2` (:653,
//   :123): o and the per-head lse (`attention_fwd_kernel`, kLse);
// - `_fwd_pallas` / `_fwd_kernel` (:565, :48): o alone, the same math as the
//   v2 forward minus the lse store (kLse false), so its o is that kernel's bit
//   for bit;
// - `_fwd_pallas_stats` / `_fwd_kernel_stats` (:631, :74), v1: p = exp(s - m)
//   / l normalised in fp32 before its bf16 rounding, then o = bf16(p) v
//   (`attention_fwd_v1_kernel`, the mainloop's two-sweep policy);
// - `_bwd_pallas_stats_ctx_qb` / `_bwd_kernel_stats_ctx_qb` (:752, :276) and
//   without biases `_bwd_pallas_stats_ctx` / `_bwd_kernel_stats_ctx` (:698,
//   :348): the v3 backward from the saved lse and o (`coral_attention_bwd`).
//
// Bound on the H100: the tensor cores and the fp32 softmax between the
// products (T^2 * d * 4 flops and T^2 exponentials per head forward, five
// products backward); q/k/v/o are only 4 * T * d * 2 bytes per head. The TPU
// kernels keep the whole (T, T) score tile on chip, which does not fit a
// Hopper SM at T = 1499.
//
// Design: the forwards with and without biases and stats
// (`attention_fwd_kernel`) run on the Hopper mainloop of `attention.cuh`
// (namespace fwd: 128 query rows a block, TMA copies of 128-key tiles into a
// three-stage ring, both products on wgmma, the online softmax in registers);
// it rounds the unnormalised e = exp(s - m_running) to bf16 for P @ V and
// divides by l at the end, as the TPU kernels round e against the row max
// and divide after the product. A fully padded row (every key at -1e30)
// comes out as the uniform average (not NaN), as in the JAX kernels, with
// lse clamped at -1e25. v1 rounds the normalised p, which needs the final m
// and l before any product with V: on the same mainloop it walks the keys
// twice (policy fwd::V1), the first sweep copying K alone and building m and
// l as the forwards above do, the second forming p = e / l in registers,
// rounding it and accumulating P V on wgmma with no rescale. The backward is
// the backward mainloop's pair with policy bwd::K4<kBias>
// (`attention_bwd_dq_kernel`, then `attention_bwd_dkv_kernel`): p from the
// lse, delta = rowsum(o do) formed and written by the dq kernel, the biases
// added to the tiles in shared memory and their gradients' column sums
// written per 128-row block.
#include <chrono>

#include "attention.cuh"

namespace {

// The forward on the Hopper mainloop (`attention.cuh`, namespace fwd): q, k, v
// through the tensor maps; args.bq, bk, bv (kBias), key_bias, o and (kLse)
// the lse in args.stat_a.
template <int D, bool kBias, bool kLse>
__global__ void __launch_bounds__(fwd::Tile<D, fwd::consumers(D)>::kThreads, 1)
    attention_fwd_kernel(const __grid_constant__ fwd::Maps maps, const fwd::Args args) {
  fwd::mainloop<D, fwd::K4<kBias, kLse>>(maps, args);
}

// The v1 forward on the mainloop's two-sweep policy (fwd::V1): arguments as
// attention_fwd_kernel's without biases, the lse always written.
template <int D>
__global__ void __launch_bounds__(fwd::Tile<D, fwd::consumers(D)>::kThreads, 1)
    attention_fwd_v1_kernel(const __grid_constant__ fwd::Maps maps, const fwd::Args args) {
  fwd::mainloop<D, fwd::V1>(maps, args);
}

}  // namespace

// Launches the v3 backward's pair on `stream` at head dim D (64, 80 or 120),
// the dq kernel first, with the q/k/v biases when bq is not null (then bk,
// bv are read and db_part, (B, ceil(T / 128), 3, H*D) fp32, written), else
// without (the four are not touched). lse (B, H, T) fp32 and o (B, T, H*D)
// bf16 from the forward; delta: (B, H, T) fp32 scratch, rowsum(o do)
// written by the dq kernel for the dkv kernel. dq, dk, dv: (B, T, H*D) bf16
// each with row stride stride_d. scale is the bf16-rounded score scale
// applied to q (+ bq) (as the forward); sm_scale the fp32 one dq is
// multiplied by (as the JAX kernel). Returns the tensor-map encoder's error
// or the cudaError_t of the launches, or -1 for a head dim they were not
// built for.
extern "C" int coral_attention_bwd(const void* q, const void* k, const void* v, const void* bq,
                                   const void* bk, const void* bv, const void* key_bias,
                                   const void* dout, const void* lse, const void* o, void* delta,
                                   void* dq, void* dk, void* dv, void* db_part, int B, int T,
                                   int H, int D, long long stride_b, long long stride_t,
                                   long long stride_d, float scale, float sm_scale,
                                   void* stream) {
  if (D != 64 && D != 80 && D != 120) return -1;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (H > 65535 || B > 65535) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bwd::Args args = bwd::short_t_args(dout, o, lse, bq, bk, bv, key_bias, nullptr, nullptr,
                                           delta, db_part, T, H, stride_d, scale, sm_scale);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (bq != nullptr)
      return bwd::launch_pair<kD, bwd::K4<true>>(q, k, v, args, dq, dk, dv, B, stride_b,
                                                 stride_t, s);
    return bwd::launch_pair<kD, bwd::K4<false>>(q, k, v, args, dq, dk, dv, B, stride_b, stride_t,
                                                s);
  });
}

// The forward at head dim D (64, 80 or 120): with the q/k/v biases when bq is
// not null (then lse is written), else without; without biases lse null
// writes o alone, and v1 != 0 runs the v1 forward (o and lse). Returns the
// cudaError_t of the launch, cudaErrorInvalidValue for biases without lse or
// with v1, or -1 for a head dim it was not built for.
extern "C" int coral_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bq, const void* bk, const void* bv,
                                   const void* key_bias, void* o, void* lse, int B, int T,
                                   int H, int D, long long stride_b, long long stride_t,
                                   float scale, int v1, void* stream) {
  if (D != 64 && D != 80 && D != 120) return -1;
  if (bq != nullptr && (lse == nullptr || v1)) return (int)cudaErrorInvalidValue;
  if (v1 && lse == nullptr) return (int)cudaErrorInvalidValue;
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *bqp = static_cast<const bf16*>(bq),
             *bkp = static_cast<const bf16*>(bk), *bvp = static_cast<const bf16*>(bv);
  const float* kbp = static_cast<const float*>(key_bias);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const fwd::Args args{bqp, bkp, bvp, kbp, nullptr, op, lp, nullptr, T, T, H, scale};
    if (v1)
      return fwd::launch<kD, fwd::V1>(attention_fwd_v1_kernel<kD>, q, k, v, args, B, stride_b,
                                      stride_t, s);
    if (bqp != nullptr)
      return fwd::launch<kD, fwd::K4<true, true>>(attention_fwd_kernel<kD, true, true>, q, k, v,
                                                  args, B, stride_b, stride_t, s);
    if (lp != nullptr)
      return fwd::launch<kD, fwd::K4<false, true>>(attention_fwd_kernel<kD, false, true>, q, k,
                                                   v, args, B, stride_b, stride_t, s);
    return fwd::launch<kD, fwd::K4<false, false>>(attention_fwd_kernel<kD, false, false>, q, k, v,
                                                  args, B, stride_b, stride_t, s);
  });
}

// Host nanoseconds per forward launch spent encoding its tensor maps (q, k and
// v at head dim D): the mean over `reps` encodings. -1 for a head dim the
// kernels were not built for, or if the encoder fails.
extern "C" int coral_attention_fwd_map_ns(const void* q, const void* k, const void* v, int B,
                                          int T, int H, int D, long long stride_b,
                                          long long stride_t, int reps) {
  if ((D != 64 && D != 80 && D != 120) || reps <= 0) return -1;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    fwd::Maps maps;
    const auto start = std::chrono::steady_clock::now();
    for (int i = 0; i < reps; ++i)
      if (fwd::encode<kD>(&maps, q, k, v, B, T, H, stride_b, stride_t, 128) != 0) return -1;
    const auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                        std::chrono::steady_clock::now() - start)
                        .count();
    return (int)(ns / reps);
  });
}
