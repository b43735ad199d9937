// Probe: what a polynomial epilogue of 7 to 17 coefficients, or a dropout
// mask, costs inside the FFN's up-projection tile.
//
// Replaces: tools/probe_gelu_cost.py `run` (its `pallas_call` :54) ->
// `_kernel` (:37): out = bf16(epilogue(x @ w)) for x (STEPS * 256, 1024) bf16
// and w (1024, 4096) bf16 with fp32 sums; the epilogue optionally zeroes the
// elements whose 32 random bits are below 2**28 (15/16 kept, no 1 / keep
// rescale), then applies acc = acc * poly_n(acc) for each n of the case, where
// poly_n is the probe's synthetic polynomial (`_poly` :28: x clipped to +-5,
// t = 0.08 x^2 - 1, Horner from 1e-3 with coefficients 1e-3 (i + 2)), not the
// GELU tables of gelu_poly.cuh.
//
// Bound on the H100: the tensor cores, 2 * 1024 flops per output element
// against 2 bytes written (8 KB per 256 F columns of a 64-row block); the
// epilogue adds 4 (n - 1) + 6 fp32 operations per element and polynomial,
// and Philox's ~25 integer operations per element for the mask.
//
// Design: csrc/ffn_tiles.cuh's fc1 panel product (the x panel, 256 x 32 tiles
// of the weight stored (F, D), eight warps of 32 x 64 WMMA fragments) with
// the epilogue swapped, so that the difference to the case without an
// epilogue is the cost of the epilogue inside that WMMA tile. The
// mask's bits are csrc/philox.cuh's for (seed, row, column), the bits of
// coral_tpu_torch/ops/philox.py; the TPU probe draws its hardware PRNG per
// grid step. The polynomials are template parameters, unrolled as the TPU
// kernel's trace unrolls them.
#include "ffn_tiles.cuh"

namespace {

constexpr int kProbeD = 1024;  // x's width, the reduction
constexpr uint32_t kDropBelow = 1u << 28;

// tools/probe_gelu_cost.py `_poly(x, n)`.
template <int N>
__device__ __forceinline__ float probe_poly(float x) {
  const float xc = fminf(fmaxf(x, -5.0f), 5.0f);
  const float t = 0.08f * (xc * xc) - 1.0f;
  float acc = 1.0e-3f;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) acc = acc * t + (float)(1.0e-3 * (i + 2));
  return 0.5f + xc * acc;
}

// x: (M, 1024) bf16; w: (F, 1024) bf16; out: (M, F) bf16. kN1, kN2: the
// polynomials applied in turn (0: none); kPrng: the mask first.
template <int kN1, int kN2, bool kPrng>
__global__ void __launch_bounds__(kThreads)
    gelu_cost_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     bf16* __restrict__ out, long long M, int F, uint32_t seed) {
  constexpr int D = kProbeD;
  constexpr int BM = panel_rows(D);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * (D + 8);
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  x_panel<D, BM>(As, x, m0, M);
  __syncthreads();
  FragC acc[BM / 32][4];
  panel_times_w1<D, BM>(acc, As, Bs, w, n0);
  stage<BM>(Cs, acc);  // the K loop ended on a barrier: the panel and tile are dead
  __syncthreads();

  // Epilogue: warp w writes rows w*BM/8 .. ; lane owns columns lane*8 .. +7.
  const int col = lane * 8;
#pragma unroll 1
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const long long row = m0 + r;
    if (row >= M) break;  // uniform over the warp
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cs[r * kLdC + col + e];
    if constexpr (kPrng) {
      bool keep[8];
      coral_keep8(seed, (uint32_t)row, n0 + col, kDropBelow, keep);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = keep[e] ? v[e] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (kN1 > 0) v[e] = v[e] * probe_poly<kN1>(v[e]);
      if constexpr (kN2 > 0) v[e] = v[e] * probe_poly<kN2>(v[e]);
    }
    coral_store8(out + row * F + n0 + col, v);
  }
}

template <int kN1, int kN2, bool kPrng>
int launch_gelu_cost(const bf16* x, const bf16* w, bf16* out, long long M, int F, uint32_t seed,
                     cudaStream_t s) {
  constexpr int kSmem = fwd_smem(kProbeD);
  cudaError_t err = cudaFuncSetAttribute(gelu_cost_kernel<kN1, kN2, kPrng>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + panel_rows(kProbeD) - 1) / panel_rows(kProbeD)),
                  (unsigned)(F / kBN));
  gelu_cost_kernel<kN1, kN2, kPrng><<<grid, kThreads, kSmem, s>>>(x, w, out, M, F, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// One case of the probe: x (M, D) bf16, w (F, D) bf16 (the nn.Linear layout),
// out (M, F) bf16; polynomials n1 then n2 (0: none) and the mask (prng != 0,
// from seed). Built: D = 1024, F a multiple of 256, and the probe's cases
// (0, 0), (13, 0), (13, 17), (7, 9) without the mask and (0, 0) with it.
// Returns the cudaError_t of the launch, or -1 for a case it was not built for.
extern "C" int coral_probe_gelu_cost(const void* x, const void* w, void* out, long long M, int D,
                                     int F, int n1, int n2, int prng, unsigned int seed,
                                     void* stream) {
  if (D != kProbeD || F <= 0 || F % kBN || M <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  if (prng) {
    if (n1 == 0 && n2 == 0) return launch_gelu_cost<0, 0, true>(xp, wp, op, M, F, seed, s);
    return -1;
  }
  if (n1 == 0 && n2 == 0) return launch_gelu_cost<0, 0, false>(xp, wp, op, M, F, seed, s);
  if (n1 == 13 && n2 == 0) return launch_gelu_cost<13, 0, false>(xp, wp, op, M, F, seed, s);
  if (n1 == 13 && n2 == 17) return launch_gelu_cost<13, 17, false>(xp, wp, op, M, F, seed, s);
  if (n1 == 7 && n2 == 9) return launch_gelu_cost<7, 9, false>(xp, wp, op, M, F, seed, s);
  return -1;
}
