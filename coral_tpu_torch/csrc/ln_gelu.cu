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
// Design: one warp owns one row of C = 512 or 1024 channels and keeps it in
// registers (C / 32 values a lane), so the two-pass fp32 statistics of the JAX
// `_norm` (mean, then the mean of squared deviations) cost no second read.
// Loads and stores are 16 bytes a lane, neighbouring lanes on neighbouring
// addresses. Eight rows (warps) per 256-thread block; no shared memory.
#include "common.cuh"
#include "gelu_poly.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T>
struct Vec;
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float* f) { coral_load8(p, f); }
  static __device__ __forceinline__ void store(bf16* p, const float* f) { coral_store8(p, f); }
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) { coral_load4(p, f); }
  static __device__ __forceinline__ void store(float* p, const float* f) { coral_store4(p, f); }
};

template <typename T, int C, bool kGelu>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_gelu_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, long long rows,
                   float eps) {
  constexpr int V = Vec<T>::N;
  constexpr int kPerLane = C / 32;
  constexpr int kChunks = kPerLane / V;
  static_assert(kChunks * V * 32 == C, "C must be a multiple of 32 vectors");

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) Vec<T>::load(xr + (i * 32 + lane) * V, v + i * V);

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
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      coral_load4(gamma + col + e, g + e);
      coral_load4(beta + col + e, b + e);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float z = (v[i * V + e] * rstd) * g[e] + b[e];
      if (kGelu) z = coral_gelu(z);
      out[e] = z;
    }
    Vec<T>::store(yr + col, out);
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
// Design: one warp per row, the row in registers (C = 512, 1024, or 1280 for
// the LN step of the FFN backward at Whisper large-v3's width); the fp32
// statistics are recomputed from x, as the TPU kernel does. The TPU kernel carries its
// dgamma/dbeta sums across a batch row's time tiles in VMEM scratch; here each
// warp walks rows blockIdx*8+warp, +gridDim*8, ... and keeps its sums in
// registers, the block adds its eight warps in a fixed order, and each block
// writes one (2, C) partial. The sum over blocks runs outside (torch.sum), as
// the JAX package sums its per-batch-row partials outside the kernel. Rows and
// the order of every sum are fixed, so the result is deterministic.

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* p, float* f) { coral_load8(p, f); }
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* f) {
  coral_load4(p, f);
  coral_load4(p + 4, f + 4);
}
template <typename T>
__device__ __forceinline__ void store8(T* p, const float* f);
template <>
__device__ __forceinline__ void store8<bf16>(bf16* p, const float* f) { coral_store8(p, f); }
template <>
__device__ __forceinline__ void store8<float>(float* p, const float* f) {
  coral_store4(p, f);
  coral_store4(p + 4, f + 4);
}

template <typename TX, typename TY, int C, bool kGelu>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const TY* __restrict__ dy,
                  TX* __restrict__ dx, float* __restrict__ part, long long rows, float eps) {
  constexpr int kChunks = C / 256;  // 8 values a lane per chunk
  constexpr int kPerLane = kChunks * 8;
  __shared__ float red[2 * C];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_gn[kPerLane], acc_g[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc_gn[j] = acc_g[j] = 0.f;

  for (long long row = (long long)blockIdx.x * kRowsPerBlock + warp; row < rows;
       row += (long long)gridDim.x * kRowsPerBlock) {
    float n[kPerLane], g[kPerLane];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      load8(x + row * C + (i * 32 + lane) * 8, n + i * 8);
      load8(dy + row * C + (i * 32 + lane) * 8, g + i * 8);
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
      const int col = (i * 32 + lane) * 8;
      float ga[8], be[8];
      load8(gamma + col, ga);
      load8(beta + col, be);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = i * 8 + e;
        n[j] *= rstd;
        if (kGelu) g[j] *= coral_dgelu(n[j] * ga[e] + be[e]);
        const float dn = g[j] * ga[e];
        sdn += dn;
        sdnn += dn * n[j];
        acc_gn[j] += g[j] * n[j];
        acc_g[j] += g[j];
      }
    }
    const float mdn = coral_warp_sum(sdn) / C;
    const float mdnn = coral_warp_sum(sdnn) / C;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int col = (i * 32 + lane) * 8;
      float ga[8], out[8];
      load8(gamma + col, ga);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = i * 8 + e;
        out[e] = (g[j] * ga[e] - mdn - n[j] * mdnn) * rstd;
      }
      store8(dx + row * C + col, out);
    }
  }

  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) red[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = (i * 32 + lane) * 8 + e;
          red[col] += acc_gn[i * 8 + e];
          red[C + col] += acc_g[i * 8 + e];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) part[(long long)blockIdx.x * 2 * C + i] = red[i];
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
  if (apply_gelu)
    ln_bwd_kernel<TX, TY, C, true><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
        xp, gp, bp, dyp, dxp, pp, rows, eps);
  else
    ln_bwd_kernel<TX, TY, C, false><<<blocks, kRowsPerBlock * 32, 0, stream>>>(
        xp, gp, bp, dyp, dxp, pp, rows, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int dispatch_bwd(const void* x, const void* gamma, const void* beta, const void* dy, void* dx,
                 void* part, long long rows, int C, int blocks, int apply_gelu, float eps,
                 cudaStream_t s) {
  if (C == 512) return launch_bwd<TX, TY, 512>(x, gamma, beta, dy, dx, part, rows, blocks, apply_gelu, eps, s);
  if (C == 1024) return launch_bwd<TX, TY, 1024>(x, gamma, beta, dy, dx, part, rows, blocks, apply_gelu, eps, s);
  if (C == 1280) return launch_bwd<TX, TY, 1280>(x, gamma, beta, dy, dx, part, rows, blocks, apply_gelu, eps, s);
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
  if (x_bf16 && dy_bf16)
    return dispatch_bwd<bf16, bf16>(x, gamma, beta, dy, dx, part, rows, C, blocks, apply_gelu, eps, s);
  if (x_bf16)
    return dispatch_bwd<bf16, float>(x, gamma, beta, dy, dx, part, rows, C, blocks, apply_gelu, eps, s);
  if (!dy_bf16)
    return dispatch_bwd<float, float>(x, gamma, beta, dy, dx, part, rows, C, blocks, apply_gelu, eps, s);
  return -1;
}

// x, y: (rows, C) contiguous, bf16 (is_bf16=1) or fp32; gamma, beta: (C,) fp32.
// Returns the cudaError_t of the launch, or -1 for a C it was not built for.
extern "C" int coral_ln_gelu(const void* x, const void* gamma, const void* beta, void* y,
                             long long rows, int C, int is_bf16, int apply_gelu,
                             float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (C == 512) return launch<bf16, 512>(x, gamma, beta, y, rows, apply_gelu, eps, s);
    if (C == 1024) return launch<bf16, 1024>(x, gamma, beta, y, rows, apply_gelu, eps, s);
  } else {
    if (C == 512) return launch<float, 512>(x, gamma, beta, y, rows, apply_gelu, eps, s);
    if (C == 1024) return launch<float, 1024>(x, gamma, beta, y, rows, apply_gelu, eps, s);
  }
  return -1;
}
