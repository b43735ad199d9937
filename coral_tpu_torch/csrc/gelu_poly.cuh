// GELU through the clamped minimax Phi polynomial, shared by the fused kernels.
//
// Same tables and evaluation order as coral_tpu/ops/gelu_dropout_pallas.py
// (`_odd_poly`, `_phi`): Phi(x) - 0.5 is odd, so Phi(x) = 0.5 + xc * P(t) with
// xc = clamp(x, -B, B) and t = 2 xc^2 / B^2 - 1 in [-1, 1], P evaluated by
// Horner. This is not erf: it is the function the JAX kernels compute, so
// both packages agree. The table set is picked at build time by
// CORAL_GELU_POLY_F32 (ops/_build.py defines it when CORAL_GELU_POLY=f32).
#pragma once

__device__ __forceinline__ float coral_phi(float x) {
#if CORAL_GELU_POLY_F32
  constexpr int kN = 13;
  constexpr float kB = 5.0f;
  const float c[kN] = {
      6.087279384e-04f, -1.613265746e-03f, 1.722797782e-03f, -2.685573600e-03f,
      6.410511945e-03f, -1.116434054e-02f, 1.640217381e-02f, -2.326865223e-02f,
      3.144217246e-02f, -4.044260744e-02f, 5.152052231e-02f, -7.029628062e-02f,
      1.413637876e-01f};
#else
  constexpr int kN = 7;
  constexpr float kB = 4.0f;
  const float c[kN] = {
      5.972141034e-03f, -1.655117714e-02f, 2.409117135e-02f, -3.546221027e-02f,
      5.541011030e-02f, -8.442662317e-02f, 1.759702204e-01f};
#endif
  const float xc = fminf(fmaxf(x, -kB), kB);
  const float t = (2.0f / (kB * kB)) * (xc * xc) - 1.0f;
  float acc = c[0];
#pragma unroll
  for (int i = 1; i < kN; ++i) acc = acc * t + c[i];
  return 0.5f + xc * acc;
}

// gelu(x) = x * Phi(x), the forward the JAX kernels write (`_gelu_parts`).
__device__ __forceinline__ float coral_gelu(float x) { return x * coral_phi(x); }
