// Small helpers shared by the kernels: bf16 vectors of 8 and warp sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float coral_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 consecutive bf16 (16 bytes, 16-byte aligned) -> 8 floats.
__device__ __forceinline__ void coral_load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 floats -> 8 bf16 (round to nearest even), one 16-byte store.
__device__ __forceinline__ void coral_store8(bf16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// 4 consecutive floats (16-byte aligned).
__device__ __forceinline__ void coral_load4(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void coral_store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// x rounded to bf16 and back: what a bf16 op of the JAX reference keeps.
__device__ __forceinline__ float coral_round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
