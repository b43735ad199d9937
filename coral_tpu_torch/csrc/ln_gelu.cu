// Row LayerNorm (+ polynomial GELU) forward: gelu(layer_norm(x) * gamma + beta).
//
// Replaces: coral_tpu/ops/ln_gelu_pallas.py `_fwd_pallas` / `_fwd_kernel`
// (`ln_gelu` with apply_gelu=True after FE conv 0, `ln_fused` with
// apply_gelu=False before each encoder attention).
//
// Bound on the H100: device memory. Each element is read once and written once
// (2 x 2 bytes in bf16) against ~20 flops, far below the card's ~295 flops per
// byte, so the kernel can at best stream at HBM rate.
//
// Design: one warp owns one row of C channels and keeps it in registers (C /
// 32 values a lane), so the two-pass fp32 statistics of the JAX `_norm`
// (mean, then the mean of squared deviations) cost no second read. Built for
// bf16 C = 512, 1024, 1280 and 1920 (XLS-R-300M, -1B and -2B's encoder LNs)
// and fp32 C = 512, 1024. Loads and stores are 16 bytes a lane where C is a
// multiple of 256 bf16 values, else 8 (1920 = 15 x 128: lane vectors of 4),
// neighbouring lanes on neighbouring addresses. Eight rows (warps) per
// 256-thread block; no shared memory.
#include <type_traits>

#include "common.cuh"
#include "gelu_poly.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T, int C, bool kGelu>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_gelu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, long long rows,
                   float eps) {
  constexpr int V = coral_row_vec<T>(C);
  constexpr int kPerLane = C / 32;
  constexpr int kChunks = kPerLane / V;
  static_assert(kChunks * V * 32 == C, "C must be a multiple of 32 lane vectors");

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) coral_loadv<V>(xr + (i * 32 + lane) * V, v + i * V);

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) s += v[j];
  const float mean = coral_warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] -= mean;
    q += v[j] * v[j];
  }
  const float rstd = rsqrtf(coral_warp_sum(q) / C + eps);

#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int col = (i * 32 + lane) * V;
    float g[V], b[V], out[V];
    coral_loadv<V>(gamma + col, g);
    coral_loadv<V>(beta + col, b);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float z = (v[i * V + e] * rstd) * g[e] + b[e];
      if (kGelu) z = coral_gelu(z);
      out[e] = z;
    }
    coral_storev<V>(yr + col, out);
  }
}

template <typename T, int C>
int launch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
           int apply_gelu, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  T* yp = static_cast<T*>(y);
  if (apply_gelu)
    ln_gelu_kernel<T, C, true><<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, gp, bp, yp, rows, eps);
  else
    ln_gelu_kernel<T, C, false><<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, gp, bp, yp, rows, eps);
  return (int)cudaGetLastError();
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/ln_gelu_pallas.py `_bwd_pallas` / `_bwd_kernel` (K1/K2
// bwd: dx and the dgamma/dbeta partials of `ln_gelu` and `ln_fused`). The FFN
// block's backward reuses it, with apply_gelu=0 and an fp32 dy, for the LN
// step of `_bwd_ln_epilogue` (ffn_pallas.py:212-225), which is the same math.
//
// Bound on the H100: device memory, as the forward (read x and dy, write dx).
//
// Design: one warp per row, the row in registers (C / 32 values a lane, in
// the forward's lane vectors); the fp32 statistics are recomputed from x, as
// the TPU kernel does. Built for bf16 x at C = 384, 512, 768, 1024, 1280 and
// 1920 (the encoder LNs' gradients with a bf16 dy, and the FFN backward's LN
// step at every Whisper and XLS-R width with an fp32 dy), and for fp32 x at
// 512, 1024 and 1280. The TPU kernel carries its dgamma/dbeta sums across a
// batch row's time tiles in VMEM scratch; here each warp walks rows
// blockIdx*8+warp, +gridDim*8, ... and keeps its sums in its own slice of
// shared memory (8 warps x 2 x C fp32: 120 KB at 1920, where registers would
// not hold them beside the row), laid out [value][lane] so that the 32 lanes
// touch 32 banks. The block adds its eight warps in a fixed order and writes
// one (2, C) partial. The sum over blocks runs outside (torch.sum), as the
// JAX package sums its per-batch-row partials outside the kernel. Rows and
// the order of every sum are fixed, so the result is deterministic.

template <int C>
__host__ __device__ constexpr int bwd_smem() { return kRowsPerBlock * 2 * C * 4; }

template <typename TX, typename TY, int C, bool kGelu>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const TY* __restrict__ dy,
                  TX* __restrict__ dx, float* __restrict__ part, long long rows, float eps) {
  // One lane-vector width for x and dy, so that a lane owns the same columns
  // of both: 8 where both types allow it, else 4.
  constexpr int V = coral_row_vec<TX>(C) < coral_row_vec<TY>(C) ? coral_row_vec<TX>(C)
                                                                 : coral_row_vec<TY>(C);
  constexpr int kPerLane = C / 32;
  constexpr int kChunks = kPerLane / V;
  static_assert(kChunks * V * 32 == C, "the lanes' vectors must cover all C columns");
  static_assert(bwd_smem<C>() <= 232448, "the warps' sums must fit a block's shared memory");
  extern __shared__ __align__(16) float red[];  // [warp][2][kPerLane][32]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc_gn = red + warp * 2 * C + lane;  // value j of this lane at [j * 32]
  float* acc_g = acc_gn + C;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc_gn[j * 32] = acc_g[j * 32] = 0.f;

  for (long long row = (long long)blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += (long long)gridDim.x * kRowsPerBlock) {
    float n[kPerLane], g[kPerLane];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      coral_loadv<V>(x + row * C + (i * 32 + lane) * V, n + i * V);
      coral_loadv<V>(dy + row * C + (i * 32 + lane) * V, g + i * V);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) s += n[j];
    const float mean = coral_warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      n[j] -= mean;
      q += n[j] * n[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / C + eps);
    float sdn = 0.f, sdnn = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = (i * 32 + lane) * V;
      float ga[V], be[V];
      coral_loadv<V>(gamma + col, ga);
      coral_loadv<V>(beta + col, be);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = i * V + e;
        n[j] *= rstd;
        if (kGelu) g[j] *= coral_dgelu(n[j] * ga[e] + be[e]);
        const float dn = g[j] * ga[e];
        sdn += dn;
        sdnn += dn * n[j];
        acc_gn[j * 32] += g[j] * n[j];
        acc_g[j * 32] += g[j];
      }
    }
    const float mdn = coral_warp_sum(sdn) / C;
    const float mdnn = coral_warp_sum(sdnn) / C;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = (i * 32 + lane) * V;
      float ga[V], out[V];
      coral_loadv<V>(gamma + col, ga);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = i * V + e;
        out[e] = (g[j] * ga[e] - mdn - n[j] * mdnn) * rstd;
      }
      coral_storev<V>(dx + row * C + col, out);
    }
  }

  __syncthreads();
  // Column col is value j = (col / (32 V)) V + col % V of lane (col / V) % 32.
  for (int col = threadIdx.x; col < C; col += blockDim.x) {
    const int off = ((col / (32 * V)) * V + col % V) * 32 + (col / V) % 32;
    float sgn = 0.f, sg = 0.f;
    for (int w = 0; w < kRowsPerBlock; ++w) {
      sgn += red[w * 2 * C + off];
      sg += red[w * 2 * C + C + off];
    }
    part[(long long)blockIdx.x * 2 * C + col] = sgn;
    part[(long long)blockIdx.x * 2 * C + C + col] = sg;
  }
}

template <typename TX, typename TY, int C>
int launch_bwd(const void* x, const void* gamma, const void* beta, const void* dy, void* dx,
               void* part, long long rows, int blocks, int apply_gelu, float eps,
               cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TY* dyp = static_cast<const TY*>(dy);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  TX* dxp = static_cast<TX*>(dx);
  float* pp = static_cast<float*>(part);
  constexpr int smem = bwd_smem<C>();
  cudaError_t err;
  if (apply_gelu) {
    err = cudaFuncSetAttribute(ln_bwd_kernel<TX, TY, C, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ln_bwd_kernel<TX, TY, C, true><<<blocks, kRowsPerBlock * 32, smem, stream>>>(
        xp, gp, bp, dyp, dxp, pp, rows, eps);
  } else {
    err = cudaFuncSetAttribute(ln_bwd_kernel<TX, TY, C, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ln_bwd_kernel<TX, TY, C, false><<<blocks, kRowsPerBlock * 32, smem, stream>>>(
        xp, gp, bp, dyp, dxp, pp, rows, eps);
  }
  return (int)cudaGetLastError();
}

// Blocks resident at once on an SM, at most: more would only add partials.
constexpr int kMaxBlocksPerSm = 4;

// The blocks of a launch: as many as are resident at once on the current
// card (its SM count times what each SM holds of this instantiation, at most
// kMaxBlocksPerSm), fewer for few rows; -1 if the runtime cannot say.
template <typename TX, typename TY, int C>
int bwd_blocks(long long rows, int apply_gelu) {
  constexpr int smem = bwd_smem<C>();
  const void* kernel = apply_gelu ? (const void*)ln_bwd_kernel<TX, TY, C, true>
                                  : (const void*)ln_bwd_kernel<TX, TY, C, false>;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowsPerBlock * 32, smem) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  const long long wanted = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long resident = (long long)(per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
  return (int)(wanted < 1 ? 1 : wanted < resident ? wanted : resident);
}

template <int C>
using Width = std::integral_constant<int, C>;

// Calls fn(TX{}, TY{}, Width<C>{}) for a built (x, dy, C) combination: every
// model width for a bf16 x (each LN gradient), 512-1280 for an fp32 x, a bf16
// dy only with a bf16 x; -1 otherwise.
template <typename Fn>
int with_bwd_instance(int x_bf16, int dy_bf16, int C, Fn fn) {
  auto widths = [&](auto tx, auto ty) {
    switch (C) {
      case 512: return fn(tx, ty, Width<512>{});
      case 1024: return fn(tx, ty, Width<1024>{});
      case 1280: return fn(tx, ty, Width<1280>{});
      default: break;
    }
    if constexpr (sizeof(tx) == 2) {
      switch (C) {
        case 384: return fn(tx, ty, Width<384>{});
        case 768: return fn(tx, ty, Width<768>{});
        case 1920: return fn(tx, ty, Width<1920>{});
        default: break;
      }
    }
    return -1;
  };
  if (x_bf16 && dy_bf16) return widths(bf16{}, bf16{});
  if (x_bf16) return widths(bf16{}, float{});
  if (!dy_bf16) return widths(float{}, float{});
  return -1;
}

}  // namespace

// x, dx: (rows, C) bf16 (x_bf16=1) or fp32; dy: (rows, C) bf16 (dy_bf16=1) or
// fp32; gamma, beta: (C,) fp32; part: (blocks, 2, C) fp32, the dgamma (row 0)
// and dbeta (row 1) partial of each block. Returns the cudaError_t of the
// launch, or -1 for a combination it was not built for.
extern "C" int coral_ln_bwd(const void* x, const void* gamma, const void* beta, const void* dy,
                            void* dx, void* part, long long rows, int C, int blocks,
                            int x_bf16, int dy_bf16, int apply_gelu, float eps, void* stream) {
  if (rows <= 0 || blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_bwd_instance(x_bf16, dy_bf16, C, [&](auto tx, auto ty, auto c) {
    return launch_bwd<decltype(tx), decltype(ty), decltype(c)::value>(
        x, gamma, beta, dy, dx, part, rows, blocks, apply_gelu, eps, s);
  });
}

// The blocks coral_ln_bwd should launch for these rows (bwd_blocks), so the
// caller can size part; -1 for a combination it was not built for.
extern "C" int coral_ln_bwd_blocks(long long rows, int C, int x_bf16, int dy_bf16,
                                   int apply_gelu) {
  return with_bwd_instance(x_bf16, dy_bf16, C, [&](auto tx, auto ty, auto c) {
    return bwd_blocks<decltype(tx), decltype(ty), decltype(c)::value>(rows, apply_gelu);
  });
}

// x, y: (rows, C) contiguous, bf16 (is_bf16=1) or fp32; gamma, beta: (C,) fp32.
// Returns the cudaError_t of the launch, or -1 for a C it was not built for.
extern "C" int coral_ln_gelu(const void* x, const void* gamma, const void* beta, void* y,
                             long long rows, int C, int is_bf16, int apply_gelu,
                             float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t, auto c) {
    return launch<decltype(t), decltype(c)::value>(x, gamma, beta, y, rows, apply_gelu, eps, s);
  };
  if (is_bf16) {
    switch (C) {
      case 512: return run(bf16{}, Width<512>{});
      case 1024: return run(bf16{}, Width<1024>{});
      case 1280: return run(bf16{}, Width<1280>{});
      case 1920: return run(bf16{}, Width<1920>{});
      default: return -1;
    }
  }
  switch (C) {
    case 512: return run(0.f, Width<512>{});
    case 1024: return run(0.f, Width<1024>{});
    default: return -1;
  }
}
