// GELU + dropout over (B, T, F) bf16 rows, forward and backward: the
// activation of the unfused FFN (`fused_ffn: false`) in training.
//
// Replaces: coral_tpu/ops/gelu_dropout_pallas.py `_call` (:194), which runs
// `_fwd_kernel` (:162), o = keep ? gelu(x) / (1 - rate) : 0, and `_bwd_kernel`
// (:173), dx = keep ? dy / (1 - rate) * gelu'(x) : 0, over 128-row tiles with
// the mask regenerated in the backward, never stored.
//
// Bound on the H100: device memory. Each element is read once (x; x and dy in
// the backward) and written once, 4 (6) bytes, against about 20 fp32 and
// integer operations (the polynomial and a quarter of a Philox call), far
// below the card's ~20 operations per byte of fp32.
//
// Design: one thread per 8 consecutive values of a row (one 16-byte load and
// store each), blocks along the row and a grid row per (b, t) row; the math
// in fp32 and one rounding to bf16 at the end, as the TPU kernel. GELU and
// gelu' are the polynomial tables of csrc/gelu_poly.cuh. The TPU draws its
// mask from its own per-tile PRNG stream; here the bits are Philox on
// (seed[b], t, f) (csrc/philox.cuh), the same bits as ops/philox.py, so the
// kernel, the backward and the plain version drop the same elements.
#include "common.cuh"
#include "gelu_poly.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 128;

// x, o (or x, dy, dx): (B * T, F) bf16 contiguous; seeds: (B,) int32, null
// for rate 0 (keep everything); kept values are scaled by `scale`.
template <bool kBackward>
__global__ void __launch_bounds__(kThreads)
    gelu_dropout_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                        bf16* __restrict__ out, const int* __restrict__ seeds, long long rows,
                        int T, int F, uint32_t threshold, float scale) {
  const int col = (blockIdx.x * kThreads + threadIdx.x) * 8;
  if (col >= F) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long at = r * F + col;
    bool keep[8] = {true, true, true, true, true, true, true, true};
    if (seeds != nullptr) {
      coral_keep8((uint32_t)seeds[r / T], (uint32_t)(r % T), col, threshold, keep);
    }
    float xv[8], res[8];
    coral_load8(x + at, xv);
    if constexpr (kBackward) {
      float d[8];
      coral_load8(dy + at, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) res[e] = keep[e] ? d[e] * scale * coral_dgelu(xv[e]) : 0.0f;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) res[e] = keep[e] ? coral_gelu(xv[e]) * scale : 0.0f;
    }
    coral_store8(out + at, res);
  }
}

}  // namespace

// The forward (dy null: out = o) or the backward (out = dx) over B * T rows of
// F values, F a multiple of 8. Returns the cudaError_t of the launch, or -1
// for a shape it was not built for.
extern "C" int coral_gelu_dropout(const void* x, const void* dy, void* out, const void* seeds,
                                  int B, int T, int F, unsigned threshold, float scale,
                                  void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || F % 8) return -1;
  if (seeds == nullptr && threshold != 0u) return -1;
  const long long rows = (long long)B * T;
  const dim3 grid((unsigned)((F / 8 + kThreads - 1) / kThreads),
                  (unsigned)(rows < 65535 ? rows : 65535));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const int* sp = static_cast<const int*>(seeds);
  if (dy == nullptr) {
    gelu_dropout_kernel<false><<<grid, kThreads, 0, s>>>(xp, nullptr, static_cast<bf16*>(out),
                                                         sp, rows, T, F, threshold, scale);
  } else {
    gelu_dropout_kernel<true><<<grid, kThreads, 0, s>>>(xp, static_cast<const bf16*>(dy),
                                                        static_cast<bf16*>(out), sp, rows, T, F,
                                                        threshold, scale);
  }
  return (int)cudaGetLastError();
}
