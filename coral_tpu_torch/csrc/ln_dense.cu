// The pre-attention LayerNorm folded into the packed QKV projection
// (`fused_qkv_ln`): y = bf16(layer_norm(x)) @ W^T + b, no activation, and its
// backward.
//
// Forward. Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_lnmm` :995 ->
// `_fwd_kernel_lnmm` :485, the forward of `ln_dense`.
// Bound on the H100: the tensor cores: 2 * D * F flops per row (F = 3 D)
// against 2 KB of x in and 6 KB of y out at D = 1024 (2.5 and 7.5 KB at 1280,
// 3.75 and 11.25 KB at 1920), hundreds of flops per byte.
// Design: K5's forward (csrc/ffn_tiles.cuh: the LayerNorm panel rounded to
// bf16 as `_ln_matmul`, the K loop over W (F, D), the staged accumulators)
// with an epilogue that adds b and rounds, no GELU. F = 3 D is a multiple of
// the 256-column tile at D 1024 and 1280 but not at 1920 (5760 = 22.5 x 256):
// the last column tile there loads zero rows of W past F and writes nothing
// past F.
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
// block per 64 rows: ln_out with the forward panel's arithmetic, and the
// fp32 column sums of dy over its rows (db's partial, summed over blocks
// outside as the JAX package sums its per-batch-row partials); (ii)
// dl_kernel (csrc/ffn_gemm.cuh's Hopper mainloop) with dh := dy and K = F, dl
// in fp32; (iii)
// the LayerNorm backward of csrc/ln_gelu.cu on (x, dl), launched by the
// wrapper. Built at the packed projections of the repository's XLS-R
// configs: D 1024, 1280 and 1920.
#include "ffn_gemm.cuh"
#include "ffn_tiles.cuh"

namespace {

constexpr int kRows = 64;  // rows per block of the rows kernel

// y (M, F) bf16 = bf16(LN(x)) @ w^T + b: x (M, D) bf16, w (F, D) bf16, b (F,)
// fp32, gamma, beta (D,) fp32; F a multiple of 128.
template <int D>
__global__ void __launch_bounds__(kThreads)
    ln_dense_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ y, long long M, int F,
                        float eps) {
  constexpr int BM = panel_rows(D);
  static_assert(fwd_smem(D) <= kMaxSmem, "the forward's stage must fit a block's shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * (D + 8);
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  ln_panel<D, BM>(As, x, gamma, beta, m0, M, eps);
  __syncthreads();
  FragC acc[BM / 32][4];
  panel_times_w1<D, BM, true>(acc, As, Bs, w, n0, F);
  stage<BM>(Cs, acc);  // the K loop ended on a barrier: the panel and tile are dead
  __syncthreads();

  // Epilogue: warp w writes rows w*BM/8 .. ; lane owns columns lane*8 .. +7.
  const int col = lane * 8;
  if (n0 + col >= F) return;  // the column tail; no barrier follows
  float bias[8];
  coral_load4(b + n0 + col, bias);
  coral_load4(b + n0 + col + 4, bias + 4);
#pragma unroll 1
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const long long row = m0 + r;
    if (row >= M) break;
    float out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = Cs[r * kLdC + col + e] + bias[e];
    coral_store8(y + row * F + n0 + col, out);
  }
}

// Rows m0 .. m0+63: ln_out (M, D) bf16 = bf16(LN(x)) with ln_panel's
// arithmetic (the forward's product operand, bit for bit), and db_part
// (ceil(M / 64), F) fp32 = the column sums of dy (M, F) bf16 over the rows.
template <int D>
__global__ void __launch_bounds__(kThreads)
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
  for (int c = threadIdx.x * 8; c < F; c += kThreads * 8) {
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
// 128. Returns the cudaError_t of the launch, or -1 for a shape it was not
// built for.
extern "C" int coral_ln_dense_fwd(const void* x, const void* w, const void* b,
                                  const void* gamma, const void* beta, void* y, long long M,
                                  int D, int F, float eps, void* stream) {
  if (F <= 0 || F % 128 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xp = static_cast<const bf16*>(x), *wp = static_cast<const bf16*>(w);
  const float *bp = static_cast<const float*>(b), *gp = static_cast<const float*>(gamma),
              *tp = static_cast<const float*>(beta);
  bf16* yp = static_cast<bf16*>(y);
  return with_qkv_width(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (M <= 0) return 0;
    constexpr int BM = panel_rows(kD);
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((F + kBN - 1) / kBN));
    return (int)launch_with_smem<ln_dense_fwd_kernel<kD>>(grid, fwd_smem(kD), s, xp, wp, bp, gp,
                                                          tp, yp, M, F, eps);
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
    ln_dense_rows_kernel<kD><<<(unsigned)((M + kRows - 1) / kRows), kThreads, 0, s>>>(
        xp, gp, tp, dyp, lnp, part, M, F, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return gemm::launch_dl<float>(dyp, wp, dlp, M, kD, F, s);
  });
}
