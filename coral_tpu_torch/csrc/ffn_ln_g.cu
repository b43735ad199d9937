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
//  ln_out for M rows exactly (the ragged tile's rows past M are never
//  stored, and the dW kernel reads them as zeros, as `:319-332` masks them),
//  then dl_kernel, then dw_kernel: one block per 128 x 128 tile of dW1 or
//  dW2 that loops over all M rows in 32-row chunks, fp32 WMMA accumulators,
//  no atomics, so each sum is taken in one order, the same every run. dg =
//  dy W2^T and db2 stay outside, as in `_ffn_ln_block_dw_bwd`. The dW
//  kernel is still on csrc/ffn_tiles.cuh's WMMA tiles (ROADMAP R4b).
#include "ffn_gemm.cuh"
#include "ffn_tiles.cuh"

namespace {

constexpr int kWT = 128;          // a dW tile is kWT x kWT
constexpr int kLdWT = kWT + 8;    // bf16 row pitch of a staged 32-row chunk

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

// blockIdx.y 0: dW1 (F, D) = dh^T ln_out; 1: dW2 (D, F) = dy^T g. Each is
// out (P, Q) = A^T B with A (M, P) and B (M, Q) bf16, row-major; P and Q are
// multiples of kWT. blockIdx.x walks the (P / kWT) x (Q / kWT) tiles; eight
// warps of 32 x 64 (2 x 4 fragments), as dl_kernel.
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const bf16* __restrict__ dh, const bf16* __restrict__ ln_out,
              const bf16* __restrict__ dy, const bf16* __restrict__ g, float* __restrict__ dw1,
              float* __restrict__ dw2, long long M, int D, int F) {
  __shared__ __align__(128) bf16 As[kBK * kLdWT];
  __shared__ __align__(128) bf16 Bs[kBK * kLdWT];
  const bool first = blockIdx.y == 0;
  const bf16* A = first ? dh : dy;
  const bf16* B = first ? ln_out : g;
  float* out = first ? dw1 : dw2;
  const int P = first ? F : D;
  const int Q = first ? D : F;
  const int p0 = (int)(blockIdx.x / (Q / kWT)) * kWT;
  const int q0 = (int)(blockIdx.x % (Q / kWT)) * kWT;
  const int warp = threadIdx.x >> 5;
  const int wr = warp >> 1;  // 0..3: rows p0 + wr*32 .. +31
  const int wc = warp & 1;   // 0..1: columns q0 + wc*64 .. +63
  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (long long m0 = 0; m0 < M; m0 += kBK) {
    for (int i = threadIdx.x; i < kBK * (kWT / 8); i += kThreads) {
      const int r = i >> 4;
      const int c = (i & 15) * 8;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
      if (m0 + r < M) {
        a = *reinterpret_cast<const uint4*>(A + (m0 + r) * P + p0 + c);
        b = *reinterpret_cast<const uint4*>(B + (m0 + r) * Q + q0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * kLdWT + c) = a;
      *reinterpret_cast<uint4*>(Bs + r * kLdWT + c) = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragAc a[2];  // A^T: element (p, m) at As[m * kLdWT + p]
      FragBr b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * kLdWT + wr * 32 + i * 16, kLdWT);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdWT + wc * 64 + j * 16, kLdWT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (long long)(p0 + wr * 32 + i * 16) * Q + q0 + wc * 64 + j * 16,
                              acc[i][j], Q, wmma::mem_row_major);
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
// the caller). Returns the cudaError_t of the launches, or -1 for a shape
// they were not built for.
extern "C" int coral_ffn_ln_dw_bwd(const void* x, const void* w1, const void* b1,
                                   const void* gamma, const void* beta, const void* dy,
                                   const void* dg, const void* seeds, void* g, void* dh,
                                   void* ln_out, void* db1_part, void* dl, void* dw1, void* dw2,
                                   long long M, int D, int F, int T, unsigned int threshold,
                                   float scale, float eps, void* stream) {
  const int err = coral_ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, seeds, g, dh, ln_out,
                                     db1_part, dl, M, D, F, T, threshold, scale, eps, stream);
  if (err != 0 || M <= 0) return err;
  const dim3 grid((unsigned)((F / kWT) * (D / kWT)), 2u);
  dw_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dh), static_cast<const bf16*>(ln_out),
      static_cast<const bf16*>(dy), static_cast<const bf16*>(g), static_cast<float*>(dw1),
      static_cast<float*>(dw2), M, D, F);
  return (int)cudaGetLastError();
}
