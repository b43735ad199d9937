// The short-T attention's backwards that need per-query-row stats before the
// key-major pass: a pre-pass kernel writes them, then `attention.cuh`'s dkdv
// and dq kernels read them. Shapes, layout and rounding as `attention.cuh`
// says.
//
// Replaces (coral_tpu/ops/attention_pallas.py):
// - `_bwd_pallas_stats` / `_bwd_kernel_stats` (:676, :174), the backward of
//   `attention_save_stats` true and "v2": p = exp(s + bias - lse) from the
//   clamped lse, delta = sum_j p_ij dp_ij (mode 0);
// - `_bwd_pallas` / `_bwd_kernel` (:581, :466), the backward of
//   `attention_save_stats: false`: p = e / l recomputed from q and k with its
//   own row max m and sum l, no clamp, delta = sum_j p_ij dp_ij (mode 1);
// - `_bwd_ctx_pallas` / `_bwd_kernel_ctx` (:597, :407), the backward of
//   `attention_o_residual: true`: p as mode 1, delta = rowsum(do * o) from the
//   saved o (mode 2).
// The TPU kernels hold a head's whole (T, T) p in VMEM and form delta from it
// before ds; its transposed score space (:174) is Mosaic's output-block rule,
// not part of the function.
//
// Bound on the H100: as the v3 backward, the tensor cores and the
// exponentials; the pre-pass adds one score product (modes 0 and 2 also the
// dp product) per head, counted against the bound, not into it.
//
// Design: the dkdv kernel works on one key tile at a time and needs every
// query row's p and delta before it starts, so a pre-pass kernel (one block
// per 64-query tile, head, batch row, walking the key tiles) writes them to
// (B, H, T) fp32 scratch: mode 0 delta from the given lse; modes 1 and 2 the
// online m and l, and in mode 1 delta = (sum_j e_j dp_j) / l, the sum taken
// against the running max and rescaled with it. m and l stay apart for the
// masked-row reason `attention.cuh` gives. Then the dkdv and dq kernels run
// with p from the lse (mode 0) or from m and l, and delta from the scratch or
// from o.
#include "attention.cuh"

namespace {

enum RowMode { kStatsDelta = 0, kRecompute = 1, kCtx = 2 };

// q, k, v, key_bias as the forward; dout: (B, T, H*D) bf16 contiguous (read
// in modes 0 and 1); lse (mode 0); m, l (modes 1, 2) and delta (modes 0, 1):
// (B, H, T) fp32.
template <int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    attention_row_stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ key_bias,
                               const bf16* __restrict__ dout, const float* __restrict__ lse,
                               float* __restrict__ m_out, float* __restrict__ l_out,
                               float* __restrict__ delta_out, int T, int H,
                               long long stride_b, long long stride_t, float scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS;
  constexpr bool kDelta = kMode != kCtx;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ks = dOs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(Vs + kBKV * kLdH);
  float* kb = Ss + kBQ * kLdS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * stride_b + h * D;
  const long long srow = ((long long)b * H + h) * T;
  const int t = q0 + warp * 16 + row;

  load_tile<D, false>(Qs, q + head, nullptr, q0, T, stride_t, scale);
  if (kDelta) load_rows<D>(dOs, dout + (long long)b * T * HD + h * D, q0, T, HD);
  float* Sw = Ss + warp * 16 * kLdS;
  const bf16* Qw = Qs + warp * 16 * kLdH;
  const bf16* dOw = dOs + warp * 16 * kLdH;
  // Mode 0: p against the given lse (+inf past T: p = 0).
  const float lse_r = kMode == kStatsDelta ? (t < T ? lse[srow + t] : INFINITY) : 0.f;

  float m = -INFINITY, l = 0.0f, u = 0.0f;  // u: sum_j p dp (mode 0), sum_j e dp (mode 1)
  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<D, false>(Ks, k + head, nullptr, k0, T, stride_t, 0.0f);
    if (kDelta) load_tile<D, false>(Vs, v + head, nullptr, k0, T, stride_t, 0.0f);
    load_key_bias(kb, key_bias + (long long)b * T, k0, T);
    __syncthreads();

    product_abt<D>(Sw, Qw, Ks);
    float sv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sv[j] = Sw[row * kLdS + half * 32 + j] + kb[half * 32 + j];
    __syncwarp();
    float dp[32];
    if constexpr (kDelta) {
      product_abt<D>(Sw, dOw, Vs);
#pragma unroll
      for (int j = 0; j < 32; ++j) dp[j] = Sw[row * kLdS + half * 32 + j];
      __syncwarp();
    }
    if constexpr (kMode == kStatsDelta) {
#pragma unroll
      for (int j = 0; j < 32; ++j) u += expf(sv[j] - lse_r) * dp[j];
    } else {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) mx = fmaxf(mx, sv[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);  // finite: every tile holds a key < T
      const float alpha = expf(m - m_new);
      float psum = 0.0f, usum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float e = expf(sv[j] - m_new);
        psum += e;
        if constexpr (kDelta) usum += e * dp[j];
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = l * alpha + psum;
      if constexpr (kDelta) {
        usum += __shfl_xor_sync(0xffffffffu, usum, 1);
        u = u * alpha + usum;
      }
      m = m_new;
    }
  }
  if constexpr (kMode == kStatsDelta) u += __shfl_xor_sync(0xffffffffu, u, 1);
  if (t < T && half == 0) {
    if constexpr (kMode == kStatsDelta) {
      delta_out[srow + t] = u;
    } else {
      m_out[srow + t] = m;
      l_out[srow + t] = l;
      if constexpr (kDelta) delta_out[srow + t] = u / l;
    }
  }
}

template <int D, int kMode>
int launch_rows(const bf16* qp, const bf16* kp, const bf16* vp, const float* kbp,
                const bf16* dop, const float* lp, const bf16* op, float* mp, float* l_p,
                float* deltap, bf16* dq, bf16* dk, bf16* dv, int B, int T, int H,
                long long stride_b, long long stride_t, long long stride_d, float scale,
                float sm_scale, cudaStream_t s) {
  constexpr int smem = Head<D>::kRowsSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_row_stats_kernel<D, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  attention_row_stats_kernel<D, kMode><<<grid, kThreads, smem, s>>>(
      qp, kp, vp, kbp, dop, lp, mp, l_p, deltap, T, H, stride_b, stride_t, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr bool kML = kMode != kStatsDelta;
  constexpr bool kDeltaO = kMode == kCtx;
  const RowStats stats{kML ? mp : lp, l_p, deltap};
  return launch_bwd<D, false, kML, kDeltaO>(qp, kp, vp, nullptr, nullptr, nullptr, kbp, dop,
                                            stats, op, dq, dk, dv, nullptr, B, T, H, stride_b,
                                            stride_t, stride_d, scale, sm_scale, s);
}

}  // namespace

// Launches the pre-pass and both backward kernels on `stream` at head dim D
// (64, 80 or 120), without q/k/v biases. mode 0: lse (B, H, T) given, delta
// scratch written; mode 1: m, l and delta scratch written; mode 2: m and l
// scratch written, o (B, T, H*D) bf16 read. Scratch is (B, H, T) fp32 each.
// dq, dk, dv: (B, T, H*D) bf16 each with row stride stride_d. scale and
// sm_scale as coral_attention_bwd. Returns the cudaError_t of the launches,
// -1 for a head dim they were not built for, cudaErrorInvalidValue for
// another mode.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout),
             *op = static_cast<const bf16*>(o);
  const float* kbp = static_cast<const float*>(key_bias);
  const float* lp = static_cast<const float*>(lse);
  float *mp = static_cast<float*>(m), *l_p = static_cast<float*>(l),
        *deltap = static_cast<float*>(delta);
  bf16 *dqp = static_cast<bf16*>(dq), *dkp = static_cast<bf16*>(dk),
       *dvp = static_cast<bf16*>(dv);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    switch (mode) {
      case kStatsDelta:
        return launch_rows<kD, kStatsDelta>(qp, kp, vp, kbp, dop, lp, op, mp, l_p, deltap, dqp,
                                            dkp, dvp, B, T, H, stride_b, stride_t, stride_d,
                                            scale, sm_scale, s);
      case kRecompute:
        return launch_rows<kD, kRecompute>(qp, kp, vp, kbp, dop, lp, op, mp, l_p, deltap, dqp,
                                           dkp, dvp, B, T, H, stride_b, stride_t, stride_d,
                                           scale, sm_scale, s);
      default:
        return launch_rows<kD, kCtx>(qp, kp, vp, kbp, dop, lp, op, mp, l_p, deltap, dqp, dkp,
                                     dvp, B, T, H, stride_b, stride_t, stride_d, scale,
                                     sm_scale, s);
    }
  });
}
