// The pre-attention LayerNorm folded into the packed QKV projection
// (`fused_qkv_ln`): y = bf16(layer_norm(x)) @ W^T + b, no activation, and its
// backward.
//
// Forward. Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_lnmm` :995 ->
// `_fwd_kernel_lnmm` :485, the forward of `ln_dense`.
// Bound on the H100: the tensor cores: 2 * D * F flops per row (F = 3 D)
// against 2 KB of x in and 6 KB of y out at D = 1024 (2.5 and 7.5 KB at 1280,
// 3.75 and 11.25 KB at 1920), hundreds of flops per byte. What costs beside
// the product: the LayerNorm (a few flops an element of x, once per column
// tile) and re-reading x per column tile and W per row tile from L2.
// Design: K5's forward without its GELU. ffn_fwd_kernel<gemm::Fwd<D, true,
// false, false>> runs csrc/ffn_gemm.cuh's Hopper mainloop (TMA copies into
// an mbarrier ring, the LayerNorm applied to each streamed x chunk in place,
// wgmma m64n128k16 with fp32 accumulators in registers, 384 threads, 128-row
// and 256-column tiles) with the bias-only epilogue: + b in fp32, rounded
// once to bf16, no GELU, no mask. One device kernel a call. F = 3 D gives
// 12, 15 and 23 column tiles at D 1024, 1280 and 1920, counts that powers
// of two do not divide usefully, so `tiles_per_block` may give this forward
// any count (a row's last block takes the rest): 3 tiles a block at 1024
// serving (0.80x the time at 1 tile; 2, 4 and 6 tiles 0.95-1.02x), 6 at
// 1920 (0.76x the time at 1), timed on an H100 from edited copies
// (tools/probe_ffn.py, PERF.md §6). F is not a multiple of the 256-column
// tile at 1920 (5760 = 22.5 x 256): the tile count is rounded up, the last
// tile's W rows past F are TMA's zeros, and its epilogue reads no b and
// stores nothing past F.
//
// Backward. Replaces: `_bwd_pallas_lnmm` :1013 -> `_bwd_kernel_lnmm` :493:
// the LayerNorm rebuilt from x and written once as ln_out (the outside dW =
// dy^T ln_out operand), the column sums of dy (db's row partials), dl = dy W
// and the LayerNorm backward -> dx, dgamma, dbeta.
// Bound on the H100: the tensor cores: one product of 2 * D * F flops per row
// (dl), against x and dy in and ln_out and dx out (2 + 6 + 2 + 2 KB a row at
// D = 1024).
// Design: there is no activation, so no product is recomputed (dh = dy). The
// TPU kernel keeps the (TM, D) LayerNorm backward of a row block in VMEM with
// dl complete over all D columns; on an SM a 64-row fp32 dl tile is 256 KB at
// D = 1024, over the 227 KB a block has, so the work is N4's composition
// (csrc/ffn_ln_fc1.cu) without its h product: (i) ln_dense_rows_kernel, one
// block per 64 rows: ln_out with the mainloop's LayerNorm arithmetic (its
// row statistics and chunk pass, so ln_out is the forward's product operand
// bit for bit, as a card test holds it), and the fp32 column sums of dy over
// its rows (db's partial, summed over blocks outside as the JAX package sums
// its per-batch-row partials); (ii) dl_kernel (csrc/ffn_gemm.cuh's Hopper
// mainloop) with dh := dy and K = F, dl in fp32; (iii) the LayerNorm
// backward of csrc/ln_gelu.cu on (x, dl), launched by the wrapper. Built at
// the packed projections of the repository's XLS-R configs: D 1024, 1280 and
// 1920.
//
// No model path includes csrc/ffn_tiles.cuh's WMMA panel product any more;
// only the two probes do (csrc/probe_gelu_cost.cu and
// csrc/probe_lane_reduce.cu, which time that tile as the JAX tools time
// theirs). The rows kernel below needs none of its helpers.
#include "ffn_gemm.cuh"

namespace {

constexpr int kRows = 64;         // rows per block of the rows kernel
constexpr int kRowThreads = 256;  // its 8 warps, 8 rows each

// Rows m0 .. m0+63: ln_out (M, D) bf16 = bf16(LN(x)) with the mainloop's
// arithmetic (gemm::row_stats, then gemm::normalise's (x - mean) rstd gamma +
// beta: the forward's product operand, bit for bit), and db_part
// (ceil(M / 64), F) fp32 = the column sums of dy (M, F) bf16 over the rows.
template <int D>
__global__ void __launch_bounds__(kRowThreads)
    ln_dense_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, const bf16* __restrict__ dy,
                         bf16* __restrict__ ln_out, float* __restrict__ db_part, long long M,
                         int F, float eps) {
  constexpr int V = coral_row_vec<bf16>(D);
  constexpr int kChunks = D / (32 * V);
  static_assert(kChunks * 32 * V == D, "a lane owns whole vectors of the row");
  const long long m0 = (long long)blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // The LayerNorm: warp w normalises rows w*8 .. w*8+7.
#pragma unroll 1
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const long long row = m0 + warp * (kRows / 8) + rr;
    if (row >= M) break;  // uniform over the warp
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
      coral_storev<V>(ln_out + row * D + col, out);
    }
  }

  // db's partial: a thread sums 8 columns at a time over the block's rows.
  const int rows = (int)(M - m0 < kRows ? M - m0 : kRows);
  for (int c = threadIdx.x * 8; c < F; c += kRowThreads * 8) {
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < rows; ++r) {
      float d[8];
      coral_load8(dy + (m0 + r) * F + c, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += d[e];
    }
    float* part = db_part + (long long)blockIdx.x * F + c;
    coral_store4(part, sum);
    coral_store4(part + 4, sum + 4);
  }
}

// Calls f(std::integral_constant<int, D>{}) for a width the packed projection
// is built for; returns -1 for any other.
template <typename Fn>
int with_qkv_width(int D, Fn&& f) {
  switch (D) {
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 1280: return f(std::integral_constant<int, 1280>{});
    case 1920: return f(std::integral_constant<int, 1920>{});
    default: return -1;
  }
}

}  // namespace

// The forward at a built width D (1024, 1280, 1920): x (M, D) bf16, w (F, D)
// bf16, b (F,) fp32, gamma, beta (D,) fp32, y (M, F) bf16; F a multiple of
// 128. Returns the cudaError_t of the launch or the encoder's error, or -1
// for a shape it was not built for.
extern "C" int coral_ln_dense_fwd(const void* x, const void* w, const void* b,
                                  const void* gamma, const void* beta, void* y, long long M,
                                  int D, int F, float eps, void* stream) {
  if (F <= 0 || F % 128 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_qkv_width(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (M <= 0) return 0;
    return gemm::launch_fwd<kD, true, false>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(b),
        static_cast<const float*>(gamma), static_cast<const float*>(beta), nullptr,
        static_cast<bf16*>(y), M, kD, F, 1, 0u, 1.f, eps, s);
  });
}

// Backward kernels (i) and (ii) at a built width D: dy (M, F) bf16; ln_out
// (M, D) bf16; db_part (ceil(M / 64), F) fp32; dl (M, D) fp32. The wrapper
// then runs the LayerNorm backward on (x, dl). Returns the cudaError_t of
// the launches or the encoder's error, or -1 for a shape they were not built
// for.
extern "C" int coral_ln_dense_bwd(const void* x, const void* w, const void* gamma,
                                  const void* beta, const void* dy, void* ln_out, void* db_part,
                                  void* dl, long long M, int D, int F, float eps, void* stream) {
  if (F <= 0 || F % 128 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w),
             *dyp = static_cast<const bf16*>(dy);
  const float *gp = static_cast<const float*>(gamma), *tp = static_cast<const float*>(beta);
  bf16* lnp = static_cast<bf16*>(ln_out);
  float *part = static_cast<float*>(db_part), *dlp = static_cast<float*>(dl);
  return with_qkv_width(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (M <= 0) return 0;
    ln_dense_rows_kernel<kD><<<(unsigned)((M + kRows - 1) / kRows), kRowThreads, 0, s>>>(
        xp, gp, tp, dyp, lnp, part, M, F, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return gemm::launch_dl<float>(dyp, wp, dlp, M, kD, F, s);
  });
}
