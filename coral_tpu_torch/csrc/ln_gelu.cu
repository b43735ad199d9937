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

}  // namespace

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
