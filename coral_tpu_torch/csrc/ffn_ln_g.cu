// The LayerNorm-folded block's backward with dg read in (N5), the route of
// `fused_ffn_block_dg: false` and of `fused_ffn_block_fc2: true`, and the
// same with the weight gradients formed in the kernels (N6), the route of
// `fused_ffn_block_dw: true`. Their forward is csrc/ffn.cu's (K5) or, with
// fc2 in the kernel, csrc/ffn_ln_fc2.cu's (N7).
//
// N5 replaces: coral_tpu/ops/ffn_pallas.py `_bwd_pallas_ln_g` :682 ->
// `_bwd_kernel_ln_g` :249 (rate 0) and `_bwd_kernel_ln_g_drop` :263 (rate >
// 0), the backward of `_ffn_ln_block`: the LayerNorm and h recomputed from x,
// g (the dW2 operand), dh = dg * mask / keep * gelu'(h), ln_out (the dW1
// operand), dx through the LayerNorm backward, the db1 and dgamma/dbeta rows.
// N6 replaces: `_bwd_pallas_ln_dw` :794 -> `_bwd_kernel_ln_dw` :282, the
// backward of `_ffn_ln_block_dw`: the same, and dW1 = ln^T dh and dW2 = g^T
// dy summed over every row in the kernel (the TPU layouts; here dW1 is (F,
// D) and dW2 (D, F), PyTorch's).
//
// Bound on the H100: the tensor cores. N5: two products of 2 * D * F flops
// per row (h again, dl = dh W1) against 2 KB of x and 8 KB of dg in and 16
// KB of g and dh, 2 KB of ln_out and 2 KB of dx out (at D = 1024; 2.5, 10,
// 20, 2.5, 2.5 KB at 1280). N6: four such products (dW1 and dW2 too), with
// g, dh and ln_out kept out of its account: the TPU kernel never writes
// them.
//
// Design:
//  N5 is K5's backward with dg read from device memory (as N4) and g written
//  (as N3): ffn_bwd_kernel<gemm::Bwd<D, kLn, kDrop, !kDgIn, kEmitG>>
//  (csrc/ffn_gemm.cuh's Hopper mainloop), then dl_kernel in fp32, then the
//  LayerNorm backward of csrc/ln_gelu.cu on (x, dl), launched by the
//  wrapper, for dx and the dgamma/dbeta partials. Rows past M give dh = 0
//  and add nothing to the partials.
//  N6 cannot keep dW1 and dW2 in fast memory across the grid as the TPU
//  kernel does: in fp32 each is 16.8 MB at 1024 x 4096, against a block's
//  227 KB of shared memory. So it is N5's pass, which writes dh, g and
//  ln_out for M rows exactly, then dl_kernel, then ffn_dw_kernel on
//  csrc/ffn_gemm.cuh's A^T B tile (gemm::atb, as K3's dW): one block per
//  128 x 128 tile of dW1 = dh^T ln_out or dW2 = dy^T g and per range of
//  64-row chunks, the operands read through 2-D tensor maps in 64 x 64
//  boxes with the 128-byte swizzle (rows past M load as TMA's zeros, so the
//  ragged chunk adds nothing, as `:319-332` masks them), wgmma with both
//  transpose bits, fp32 accumulators. The R row ranges are fixed by the
//  shape alone (`ffn_dw_ranges` in ops/ffn.py): where the 2 (F / 128) (D /
//  128) tiles fill the card R = 1 and each block writes its tile of dW1 or
//  dW2; otherwise each writes an fp32 partial and ffn_dw_finish_kernel sums
//  the R partials in range order. No atomics: two calls give the same bits.
//  dg = dy W2^T and db2 stay outside, as in `_ffn_ln_block_dw_bwd`.
#include "ffn_gemm.cuh"

namespace {

// ffn_dw_kernel: grid ((F / 256) (D / 128), 2, R); block (tile, p, r)
// computes tile `tile` of product p over range r's 64-row chunks, into the
// product itself (R = 1) or its partial part[r][p] (F D fp32). Product 0:
// dW1 (F, D) = dh^T ln_out in 256 x 128 tiles; 1: dW2 (D, F) = dy^T g in 128
// x 256: the tile's wide side is F's, a multiple of 256 at every width.
using DwShape = gemm::atb::Shape<256, 128>;  // and <128, 256>: the same stage and ring
static_assert(gemm::atb::Shape<128, 256>::kSmem == DwShape::kSmem, "one shared-memory size");

struct DwMaps {
  CUtensorMap a[2], b[2];  // dh and dy; ln_out and g: (M, cols) in 64 x 64 boxes
};

struct DwArgs {
  float* out[2];  // dw1, dw2
  float* part;    // (R, 2, F D) fp32 where R > 1
  int D, F;
  int n_chunks;   // ceil(M / 64)
};

__global__ void __launch_bounds__(gemm::kThreads, 1)
    ffn_dw_kernel(const __grid_constant__ DwMaps maps, const DwArgs a) {
  const int p = blockIdx.y, r = blockIdx.z, R = gridDim.z;
  const int lo = (int)((long long)r * a.n_chunks / R);
  const int hi = (int)((long long)(r + 1) * a.n_chunks / R);
  const long long size = (long long)a.D * a.F;
  float* out = R == 1 ? a.out[p] : a.part + ((long long)r * 2 + p) * size;
  const CUtensorMap* A = &maps.a[p];
  const CUtensorMap* B = &maps.b[p];
  // The tile's boxes: kA of A's columns from m0, kB of B's from n0.
  auto boxes = [&](int kA, int kB, int m0, int n0) {
    return [=](int i, uint32_t st, uint32_t bar) {
      const int row = (lo + i) * gemm::kChunk;
      for (int c = 0; c < kA; ++c)
        hopper::tma_load_2d(st + c * gemm::atb::kBox, A, bar, m0 + 64 * c, row);
      for (int c = 0; c < kB; ++c)
        hopper::tma_load_2d(st + (kA + c) * gemm::atb::kBox, B, bar, n0 + 64 * c, row);
    };
  };
  if (p == 0) {
    const int qt = a.D / 128, m0 = (int)(blockIdx.x / qt) * 256, n0 = (int)(blockIdx.x % qt) * 128;
    gemm::atb::tile<256, 128>(boxes(4, 2, m0, n0), hi - lo, out, a.D, m0, n0);
  } else {
    const int qt = a.F / 256, m0 = (int)(blockIdx.x / qt) * 128, n0 = (int)(blockIdx.x % qt) * 256;
    gemm::atb::tile<128, 256>(boxes(2, 4, m0, n0), hi - lo, out, a.F, m0, n0);
  }
}

// The R partials (R, 2, size) summed in range order into dw1 and dw2, an
// element a thread.
__global__ void __launch_bounds__(256)
    ffn_dw_finish_kernel(const float* __restrict__ part, int R, long long size,
                         float* __restrict__ dw1, float* __restrict__ dw2) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= 2 * size) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += part[(long long)r * 2 * size + e];
  if (e < size)
    dw1[e] = s;
  else
    dw2[e - size] = s;
}

int launch_dw(const bf16* dh, const bf16* ln_out, const bf16* dy, const bf16* g, float* dw1,
              float* dw2, float* part, long long M, int D, int F, int R, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ffn_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DwShape::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  DwMaps maps;
  int err = hopper::encode_2d(&maps.a[0], dh, F, M, 64);
  if (err == 0) err = hopper::encode_2d(&maps.b[0], ln_out, D, M, 64);
  if (err == 0) err = hopper::encode_2d(&maps.a[1], dy, D, M, 64);
  if (err == 0) err = hopper::encode_2d(&maps.b[1], g, F, M, 64);
  if (err != 0) return err;
  DwArgs a;
  a.out[0] = dw1, a.out[1] = dw2, a.part = part;
  a.D = D, a.F = F;
  a.n_chunks = (int)((M + gemm::kChunk - 1) / gemm::kChunk);
  const dim3 grid((unsigned)((F / 256) * (D / 128)), 2u, (unsigned)R);
  ffn_dw_kernel<<<grid, gemm::kThreads, DwShape::kSmem, s>>>(maps, a);
  err = (int)cudaGetLastError();
  if (err != 0 || R == 1) return err;
  const long long size = (long long)F * D;
  ffn_dw_finish_kernel<<<(unsigned)((2 * size + 255) / 256), 256, 0, s>>>(part, R, size, dw1,
                                                                          dw2);
  return (int)cudaGetLastError();
}

bool bad_shape(int D, int F, const void* seeds, int T) {
  return !built_width(D) || F % 256 != 0 || (seeds != nullptr && T <= 0);
}

}  // namespace

// N5 at a built width D: dg (M, F) bf16; g, dh (M, F) bf16; ln_out (M, D)
// bf16; db1_part (ceil(M / coral_ffn_row_tile(D)), F) fp32; dl (M, D) fp32;
// seeds: (M / T,) int32, or null for rate 0. Returns the cudaError_t of the
// launches or the encoder's error, or -1 for a shape they were not built for.
extern "C" int coral_ffn_ln_g_bwd(const void* x, const void* w1, const void* b1,
                                  const void* gamma, const void* beta, const void* dg,
                                  const void* seeds, void* g, void* dh, void* ln_out,
                                  void* db1_part, void* dl, long long M, int D, int F, int T,
                                  unsigned int threshold, float scale, float eps, void* stream) {
  if (bad_shape(D, F, seeds, T)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    return gemm::launch_bwd<decltype(d)::value, true, false, true>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<const bf16*>(dg), nullptr, static_cast<const int*>(seeds),
        static_cast<bf16*>(g), static_cast<bf16*>(dh), static_cast<bf16*>(ln_out),
        static_cast<float*>(db1_part), static_cast<float*>(dl), M, D, F, T, threshold, scale,
        eps, static_cast<cudaStream_t>(stream));
  });
}

// N6 at a built width D: N5's arguments, and dy (M, D) bf16, dw1 (F, D) and
// dw2 (D, F) fp32; g, dh and ln_out are the dW kernel's operands (scratch to
// the caller); R >= 1 the row ranges of dW's reduction and dw_part (R, 2, F
// D) fp32 their partials (read only where R > 1). Returns the cudaError_t of
// the launches or the encoder's error, or -1 for a shape they were not built
// for.
extern "C" int coral_ffn_ln_dw_bwd(const void* x, const void* w1, const void* b1,
                                   const void* gamma, const void* beta, const void* dy,
                                   const void* dg, const void* seeds, void* g, void* dh,
                                   void* ln_out, void* db1_part, void* dl, void* dw1, void* dw2,
                                   void* dw_part, long long M, int D, int F, int T,
                                   unsigned int threshold, float scale, float eps, int R,
                                   void* stream) {
  if (R < 1 || (R > 1 && dw_part == nullptr)) return -1;
  const int err = coral_ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, seeds, g, dh, ln_out,
                                     db1_part, dl, M, D, F, T, threshold, scale, eps, stream);
  if (err != 0 || M <= 0) return err;
  return launch_dw(static_cast<const bf16*>(dh), static_cast<const bf16*>(ln_out),
                   static_cast<const bf16*>(dy), static_cast<const bf16*>(g),
                   static_cast<float*>(dw1), static_cast<float*>(dw2),
                   static_cast<float*>(dw_part), M, D, F, R, static_cast<cudaStream_t>(stream));
}
