// Feature-encoder block: gelu(layer_norm(conv1d(x, w, stride=2) + bias)), forward
// and backward.
//
// Forward. Replaces: coral_tpu/ops/conv_ln_gelu_pallas.py `_fwd_pallas` /
// `_fwd_kernel` (FE convs 1-6 of XLS-R: k = 3, 3, 3, 3, 2, 2; 512 -> 512
// channels). Serving writes y only; training also writes the TPU kernel's
// residuals, xhat (the pre-affine normalised rows, rounded to bf16) and rstd.
//
// Bound on the H100: the tensor cores, at about 1.6 GFLOP per output row block
// against 64 KB of input, plus the weight (1.5 MB at k = 3) that every block
// streams from L2. The input rows are read once from device memory.
//
// Design: output row t reads input rows 2t .. 2t+k-1, which are k*C contiguous
// values, so the conv is a GEMM whose A row t is a strided view of x (row
// stride 2C) and whose reduction runs over k*C. The TPU's deinterleave fold
// and halo view are not needed: rows are read straight from device memory, and
// any T_in works. One block owns 64 output rows across all 512 output
// channels, because the LayerNorm needs whole rows: 16 warps, each a 32 x 64
// tile of bf16 WMMA fragments with fp32 accumulators. The accumulators are
// staged through shared memory (132 KB, reusing the operand tiles), where one
// warp per row adds the bias and runs the fp32 LayerNorm and the polynomial
// GELU before one bf16 store.
#include <mma.h>

#include "common.cuh"
#include "gelu_poly.cuh"

using namespace nvcuda;

namespace {

constexpr int kC = 512;        // input and output channels
constexpr int kBM = 64;        // output rows per block
constexpr int kBK = 32;        // reduction chunk per shared-memory stage
constexpr int kThreads = 512;  // 16 warps: 2 row groups x 8 column groups
constexpr int kLdA = kBK + 8;  // bf16 row pitch of the A and B tiles
constexpr int kLdB = kBK + 8;
constexpr int kLdC = kC + 4;  // fp32 row pitch of the staged accumulators
constexpr int kSmemMain = (kBM * kLdA + kC * kLdB) * 2;
constexpr int kSmemEpi = kBM * kLdC * 4;
constexpr int kSmem = kSmemMain > kSmemEpi ? kSmemMain : kSmemEpi;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// x: (B, T_in, C) bf16; w: (C_out, K, C_in) bf16, i.e. each output channel's
// K*C_in reduction values contiguous; bias, gamma, beta: (C,) fp32;
// y: (B, T_out, C) bf16; xhat: (B, T_out, C) bf16 and rstd: (B, T_out) fp32, or
// both null (serving).
template <int K>
__global__ void __launch_bounds__(kThreads)
    conv_ln_gelu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ gamma,
                        const float* __restrict__ beta, bf16* __restrict__ y,
                        bf16* __restrict__ xhat, float* __restrict__ rstd_out, int T_in,
                        int T_out, float eps) {
  constexpr int kRed = K * kC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * kLdA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const bf16* xb = x + (long long)b * T_in * kC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 3;  // 0..1: rows wr*32 .. +31
  const int wc = warp & 7;   // 0..7: columns wc*64 .. +63

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < kRed; k0 += kBK) {
    if (tid < kBM * (kBK / 8)) {  // A: 64 rows x 32 values, 16 bytes a thread
      const int r = tid >> 2;
      const int c = (tid & 3) * 8;
      const int t = t0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < T_out)
        v = *reinterpret_cast<const uint4*>(xb + (long long)(2 * t) * kC + k0 + c);
      *reinterpret_cast<uint4*>(As + r * kLdA + c) = v;
    }
    for (int i = tid; i < kC * (kBK / 8); i += kThreads) {  // B: 512 x 32
      const int n = i >> 2;
      const int c = (i & 3) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kLdB + c) =
          *reinterpret_cast<const uint4*>(w + (long long)n * kRed + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA a[2];
      FragB bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wc * 64 + j * 16) * kLdB + kk, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The loop ended on a barrier, so the operand tiles may now be overwritten.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * kLdC + wc * 64 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: warp w normalises rows 4w .. 4w+3; lane owns columns
  // lane*8 .. +7 and 256 + lane*8 .. +7.
#pragma unroll 1
  for (int rr = 0; rr < kBM / 16; ++rr) {
    const int r = warp * (kBM / 16) + rr;
    const int t = t0 + r;
    if (t >= T_out) break;  // uniform over the warp
    const float* cr = Cs + r * kLdC;
    float v[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 256 + lane * 8;
      float bb[8];
      coral_load4(bias + col, bb);
      coral_load4(bias + col + 4, bb + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[h * 8 + e] = cr[col + e] + bb[e];
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += v[j];
    const float mean = coral_warp_sum(s) / kC;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      v[j] -= mean;
      q += v[j] * v[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / kC + eps);
    const long long row = (long long)b * T_out + t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 256 + lane * 8;
      float g[8], be[8], n[8], out[8];
      coral_load4(gamma + col, g);
      coral_load4(gamma + col + 4, g + 4);
      coral_load4(beta + col, be);
      coral_load4(beta + col + 4, be + 4);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        n[e] = v[h * 8 + e] * rstd;
        out[e] = coral_gelu(n[e] * g[e] + be[e]);
      }
      coral_store8(y + row * kC + col, out);
      if (xhat != nullptr) coral_store8(xhat + row * kC + col, n);
    }
    if (rstd_out != nullptr && lane == 0) rstd_out[row] = rstd;
  }
}

template <int K>
int launch(const void* x, const void* w, const void* bias, const void* gamma,
           const void* beta, void* y, void* xhat, void* rstd, int B, int T_in, int T_out,
           float eps, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_ln_gelu_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T_out + kBM - 1) / kBM), (unsigned)B);
  conv_ln_gelu_kernel<K><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), static_cast<bf16*>(xhat),
      static_cast<float*>(rstd), T_in, T_out, eps);
  return (int)cudaGetLastError();
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/conv_ln_gelu_pallas.py `_bwd_pallas` / `_bwd_kernel`
// (dGELU, dLN, conv dx and dW, dbias/dgamma/dbeta) and `_halo_fixup` /
// `_fixup_kernel` (the k = 3 dx row that crosses a TPU slab).
//
// Bound on the H100: the tensor cores. dx and dW are each k x 2 x 512 x 512
// flops per output row (about 200 GFLOP apiece for FE block 1 at 8 x 10 s),
// against 1 KB of da and 2-3 KB of x read per row.
//
// Design. The TPU kernel does all of it in one pass over row slabs and carries
// dW in VMEM from grid step to grid step; blocks here run in no order, so the
// work is split in three kernels around a materialised bf16 da, each of which
// owns its outputs:
// (i)   a row kernel, one warp per output row (the whole 512-wide row in
//       registers, as the forward's epilogue), forms dh = dy gelu'(h), the
//       LayerNorm backward da = (dn - mean(dn) - xhat mean(dn xhat)) rstd,
//       rounds da to bf16, and keeps fp32 dgamma/dbeta/dbias sums per warp; each
//       block adds its warps in a fixed order and writes one (3, C) partial.
// (ii)  dx: input row 2s is da[s] W0^T (+ da[s-1] W2^T for k = 3) and row 2s+1 is
//       da[s] W1^T. A block owns the 128 input rows 2s0 .. 2s0+127 for 128 input
//       channels and reads da rows s0-1 .. s0+63 itself, so the row that the TPU
//       adds with `_halo_fixup` is part of its own product: no fixup pass and no
//       atomics. da rows outside [0, T_out) load as zeros, which also writes
//       dx = 0 on every input row that no output reads (past 2(T_out-1)+k-1).
// (iii) dW_j = sum_t x[2t+j]^T da[t], a product whose reduction runs over all
//       B*T_out rows: split-K, each block reduces one chunk of one batch row for
//       one tap and a 128 x 128 tile and writes an fp32 partial; the partials
//       are summed outside in a fixed order, so dW is deterministic. Rows past
//       T_out load as zeros on both operands and add nothing.
// All products are bf16 WMMA with fp32 accumulators, as the forward.
//
// Probe modes. Replaces tools/probe_fe_bwd.py `_bwd_variant` (:138, its
// `pallas_call` :148) -> `_variant_kernel` (:50): the production backward
// with one phase taken out, so that each phase's cost is the difference to
// the full backward (and, here, also each launch's own time). The modes are
// template instantiations of the three launches above:
//   kFull     the production kernels (the same instantiation the backward
//             launches);
//   kNoVpu    the row kernel is a copy da = dy (no dGELU, LayerNorm backward
//             or dvec); dx and dW as in production;
//   kNoDvec   the row kernel without its three dvec partial sums;
//   kNoDw     the dW launch is skipped;
//   kNoDx     the dx launch is skipped; the row kernel writes da into rows
//             t < T_out of dx (the dW kernel reads it there), as the TPU
//             variant writes dx[:, :T_out] = da;
//   kNoInter  the dx kernel writes the even rows of each 256-pair slab to the
//             slab's first 256 rows and the odd rows to its last 256, the TPU
//             variant's two half writes at its 256-row tile, instead of
//             interleaving them;
//   mm_only   (`da = dy` without the row mask, then the products) is kNoVpu
//             here: the loaders already zero every row past T_out, so the
//             TPU variant's unmasked read has no counterpart.
// What a mode does not compute is not written: the caller zeroes dvec (kNoVpu,
// kNoDvec), dW (kNoDw) and dx (kNoDx, kNoInter) where it needs them.
enum BwdMode { kFull = 0, kNoVpu = 1, kNoDvec = 2, kNoDw = 3, kNoDx = 4, kNoInter = 5,
               kMmOnly = 6 };

constexpr int kRowWarps = 8;  // rows per block of the row kernel

// da rows go to row (r / T_out) da_rows + r % T_out of da: da_rows = T_out in
// every mode but kNoDx, where da is dx (da_rows = T_in).
template <int kMode>
__global__ void __launch_bounds__(kRowWarps * 32)
    conv_bwd_rows_kernel(const bf16* __restrict__ xhat, const float* __restrict__ rstd,
                         const bf16* __restrict__ dy, const float* __restrict__ gamma,
                         const float* __restrict__ beta, bf16* __restrict__ da,
                         float* __restrict__ part, long long rows, int T_out, int da_rows) {
  constexpr int kPerLane = kC / 32;  // 16: columns h*256 + lane*8 .. +7, h = 0, 1
  constexpr bool kCopy = kMode == kNoVpu;  // da = dy
  constexpr bool kDvec = kMode != kNoVpu && kMode != kNoDvec;
  __shared__ float red[3 * kC];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc_gn[kPerLane], acc_g[kPerLane], acc_da[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc_gn[j] = acc_g[j] = acc_da[j] = 0.f;
  float ga[kPerLane], be[kPerLane];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = h * 256 + lane * 8;
    coral_load4(gamma + col, ga + h * 8);
    coral_load4(gamma + col + 4, ga + h * 8 + 4);
    coral_load4(beta + col, be + h * 8);
    coral_load4(beta + col + 4, be + h * 8 + 4);
  }

  for (long long row = (long long)blockIdx.x * kRowWarps + warp; row < rows;
       row += (long long)gridDim.x * kRowWarps) {
    long long out_row = row;
    if constexpr (kMode == kNoDx) out_row = (row / T_out) * da_rows + row % T_out;
    if constexpr (kCopy) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 256 + lane * 8;
        *reinterpret_cast<uint4*>(da + out_row * kC + col) =
            *reinterpret_cast<const uint4*>(dy + row * kC + col);
      }
      continue;
    }
    float n[kPerLane], g[kPerLane];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 256 + lane * 8;
      coral_load8(xhat + row * kC + col, n + h * 8);
      coral_load8(dy + row * kC + col, g + h * 8);
    }
    const float r = rstd[row];
    float sdn = 0.f, sdnn = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      g[j] *= coral_dgelu(n[j] * ga[j] + be[j]);  // dh
      if constexpr (kDvec) {
        acc_gn[j] += g[j] * n[j];
        acc_g[j] += g[j];
      }
      const float dn = g[j] * ga[j];
      sdn += dn;
      sdnn += dn * n[j];
    }
    const float mdn = coral_warp_sum(sdn) / kC;
    const float mdnn = coral_warp_sum(sdnn) / kC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = h * 8 + e;
        out[e] = (g[j] * ga[j] - mdn - n[j] * mdnn) * r;
        if constexpr (kDvec) acc_da[j] += out[e];
      }
      coral_store8(da + out_row * kC + h * 256 + lane * 8, out);
    }
  }

  if constexpr (!kDvec) return;
  for (int i = threadIdx.x; i < 3 * kC; i += blockDim.x) red[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < kRowWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int col = (j >> 3) * 256 + lane * 8 + (j & 7);
        red[col] += acc_gn[j];
        red[kC + col] += acc_g[j];
        red[2 * kC + col] += acc_da[j];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * kC; i += blockDim.x)
    part[(long long)blockIdx.x * 3 * kC + i] = red[i];
}

constexpr int kDxBM = 64;        // row pairs (s) per block: input rows 2s, 2s+1
constexpr int kDxBN = 128;       // input channels per block
constexpr int kDxBK = 32;        // output channels per shared-memory stage
constexpr int kDxThreads = 256;  // 8 warps: 2 row groups x 4 column groups
// A da tile row of 48 bf16 is 96 bytes, so the tile shifted by one row (da[s-1]
// for tap 2) still starts on the 32 bytes WMMA asks of a fragment's pointer.
constexpr int kLdDa = kDxBK + 16;
constexpr int kLdWt = kDxBN + 8;

// kSplit (kNoInter): the rows of pair s of slab s / 256 go to row 512 (s /
// 256) + s % 256 (even) and that + 256 (odd), instead of 2s and 2s + 1.
constexpr int kSlabPairs = 256;

template <int K, bool kSplit = false>
__global__ void __launch_bounds__(kDxThreads)
    conv_bwd_dx_kernel(const bf16* __restrict__ da, const bf16* __restrict__ w,
                       bf16* __restrict__ dx, int T_in, int T_out) {
  __shared__ __align__(128) bf16 As[(kDxBM + 1) * kLdDa];  // da rows s0-1 .. s0+63
  __shared__ __align__(128) bf16 Bs[K * kDxBK * kLdWt];    // W_j rows k0 .. k0+31
  __shared__ __align__(128) float Cw[8 * 16 * 16];         // one 16 x 16 tile a warp

  const int b = blockIdx.z;
  const int s0 = blockIdx.x * kDxBM;
  const int n0 = blockIdx.y * kDxBN;
  const bf16* dab = da + (long long)b * T_out * kC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 2;  // row pairs wr*32 .. +31
  const int wc = warp & 3;   // input channels wc*32 .. +31

  FragC ev[2][2], od[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(ev[i][j], 0.0f);
      wmma::fill_fragment(od[i][j], 0.0f);
    }

  for (int k0 = 0; k0 < kC; k0 += kDxBK) {
    for (int i = tid; i < (kDxBM + 1) * (kDxBK / 8); i += kDxThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 8;
      const int s = s0 - 1 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s >= 0 && s < T_out) v = *reinterpret_cast<const uint4*>(dab + (long long)s * kC + k0 + c);
      *reinterpret_cast<uint4*>(As + r * kLdDa + c) = v;
    }
    for (int i = tid; i < K * kDxBK * (kDxBN / 8); i += kDxThreads) {
      const int j = i / (kDxBK * (kDxBN / 8));
      const int r = (i >> 4) % kDxBK;
      const int c = (i & 15) * 8;
      *reinterpret_cast<uint4*>(Bs + (j * kDxBK + r) * kLdWt + c) =
          *reinterpret_cast<const uint4*>(w + ((long long)(k0 + r) * K + j) * kC + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDxBK; kk += 16) {
      FragA a[2], a_prev[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], As + (1 + wr * 32 + i * 16) * kLdDa + kk, kLdDa);
        if (K == 3) wmma::load_matrix_sync(a_prev[i], As + (wr * 32 + i * 16) * kLdDa + kk, kLdDa);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = wc * 32 + jj * 16;
        FragBr w0, w1;
        wmma::load_matrix_sync(w0, Bs + (0 * kDxBK + kk) * kLdWt + col, kLdWt);
        wmma::load_matrix_sync(w1, Bs + (1 * kDxBK + kk) * kLdWt + col, kLdWt);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(ev[i][jj], a[i], w0, ev[i][jj]);
          wmma::mma_sync(od[i][jj], a[i], w1, od[i][jj]);
        }
        if (K == 3) {
          FragBr w2;
          wmma::load_matrix_sync(w2, Bs + (2 * kDxBK + kk) * kLdWt + col, kLdWt);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(ev[i][jj], a_prev[i], w2, ev[i][jj]);
        }
      }
    }
    __syncthreads();
  }

  // Each warp stages one 16 x 16 tile at a time and writes it as bf16 rows of 8
  // values, even tiles to rows 2s and odd tiles to rows 2s+1, rows < T_in only.
  float* cw = Cw + warp * 256;
  const int r = lane >> 1;
  const int c = (lane & 1) * 8;
#pragma unroll
  for (int par = 0; par < 2; ++par)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        wmma::store_matrix_sync(cw, par ? od[i][jj] : ev[i][jj], 16, wmma::mem_row_major);
        __syncwarp();
        const long long pair = s0 + wr * 32 + i * 16 + r;
        const long long row = kSplit ? 2LL * kSlabPairs * (pair / kSlabPairs) +
                                           par * kSlabPairs + pair % kSlabPairs
                                     : 2LL * pair + par;
        if (row < T_in)
          coral_store8(dx + ((long long)b * T_in + row) * kC + n0 + wc * 32 + jj * 16 + c,
                       cw + r * 16 + c);
        __syncwarp();
      }
}

constexpr int kWBM = 128;       // output channels per block
constexpr int kWBN = 128;       // input channels per block
constexpr int kWBK = 32;        // rows t per shared-memory stage
constexpr int kWThreads = 256;  // 8 warps: 4 row groups x 2 column groups
constexpr int kLdT = 128 + 8;

// grid (16 tiles, K taps, B * n_chunks): the partial of tap j over rows
// t in [c*chunk, (c+1)*chunk) of batch row b; da holds da_rows rows a batch
// row (T_out; T_in in kNoDx, where da is dx).
template <int K>
__global__ void __launch_bounds__(kWThreads)
    conv_bwd_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ da,
                       float* __restrict__ part, int T_in, int T_out, int chunk, int n_chunks,
                       int da_rows) {
  __shared__ __align__(128) bf16 As[kWBK * kLdT];  // da[t][c_out]: A = da^T, col-major
  __shared__ __align__(128) bf16 Bs[kWBK * kLdT];  // x[2t+j][c_in]

  const int m0 = (blockIdx.x >> 2) * kWBM;
  const int n0 = (blockIdx.x & 3) * kWBN;
  const int j = blockIdx.y;
  const int p = blockIdx.z;
  const int b = p / n_chunks;
  const int t_begin = (p % n_chunks) * chunk;
  const int t_end = min(T_out, t_begin + chunk);
  const bf16* dab = da + (long long)b * da_rows * kC;
  const bf16* xb = x + (long long)b * T_in * kC;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // output channels wr*32 .. +31
  const int wc = warp & 1;   // input channels wc*64 .. +63

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) wmma::fill_fragment(acc[i][jj], 0.0f);

  for (int t0 = t_begin; t0 < t_end; t0 += kWBK) {
    for (int i = tid; i < kWBK * 16; i += kWThreads) {
      const int r = i >> 4;
      const int c = (i & 15) * 8;
      const int t = t0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vx = va;
      if (t < t_end) {
        va = *reinterpret_cast<const uint4*>(dab + (long long)t * kC + m0 + c);
        vx = *reinterpret_cast<const uint4*>(xb + (long long)(2 * t + j) * kC + n0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * kLdT + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * kLdT + c) = vx;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWBK; kk += 16) {
      FragAc a[2];
      FragBr bx[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * kLdT + wr * 32 + i * 16, kLdT);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        wmma::load_matrix_sync(bx[jj], Bs + kk * kLdT + wc * 64 + jj * 16, kLdT);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wmma::mma_sync(acc[i][jj], a[i], bx[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  float* out = part + ((long long)p * K + j) * kC * kC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      wmma::store_matrix_sync(out + (long long)(m0 + wr * 32 + i * 16) * kC + n0 + wc * 64 + jj * 16,
                              acc[i][jj], kC, wmma::mem_row_major);
}

// The backward's three launches in mode kMode; with events (4 cudaEvent_t, the
// probe's), records events[0] before the row kernel and events[i] after
// launch i, a skipped launch included.
template <int K, int kMode>
int launch_bwd(const void* x, const void* w, const void* gamma, const void* beta,
               const void* xhat, const void* rstd, const void* dy, void* da, void* dx,
               void* dw_part, void* dvec_part, int B, int T_in, int T_out, int row_blocks,
               int chunk, int n_chunks, cudaStream_t stream, void* const* events = nullptr) {
  auto mark = [&](int i) {
    return events == nullptr ? cudaSuccess
                             : cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream);
  };
  // kNoDx: da lives in dx's rows t < T_out.
  bf16* da_buf = static_cast<bf16*>(kMode == kNoDx ? dx : da);
  const int da_rows = kMode == kNoDx ? T_in : T_out;
  cudaError_t err = mark(0);
  if (err != cudaSuccess) return (int)err;
  conv_bwd_rows_kernel<kMode><<<row_blocks, kRowWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(xhat), static_cast<const float*>(rstd),
      static_cast<const bf16*>(dy), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), da_buf, static_cast<float*>(dvec_part),
      (long long)B * T_out, T_out, da_rows);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(1);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kMode != kNoDx) {
    const int pairs = (T_in + 1) / 2;
    const dim3 dx_grid((unsigned)((pairs + kDxBM - 1) / kDxBM), kC / kDxBN, (unsigned)B);
    conv_bwd_dx_kernel<K, kMode == kNoInter><<<dx_grid, kDxThreads, 0, stream>>>(
        static_cast<const bf16*>(da), static_cast<const bf16*>(w), static_cast<bf16*>(dx), T_in,
        T_out);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = mark(2);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kMode != kNoDw) {
    const dim3 dw_grid((kC / kWBM) * (kC / kWBN), K, (unsigned)(B * n_chunks));
    conv_bwd_dw_kernel<K><<<dw_grid, kWThreads, 0, stream>>>(
        static_cast<const bf16*>(x), da_buf, static_cast<float*>(dw_part), T_in, T_out, chunk,
        n_chunks, da_rows);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = mark(3);
  return (int)err;
}

template <int K>
int launch_probe(int mode, const void* x, const void* w, const void* gamma, const void* beta,
                 const void* xhat, const void* rstd, const void* dy, void* da, void* dx,
                 void* dw_part, void* dvec_part, int B, int T_in, int T_out, int row_blocks,
                 int chunk, int n_chunks, cudaStream_t s, void* const* events) {
#define CORAL_PROBE(M)                                                                     \
  return launch_bwd<K, M>(x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, B, \
                          T_in, T_out, row_blocks, chunk, n_chunks, s, events)
  switch (mode) {
    case kFull: CORAL_PROBE(kFull);
    case kNoVpu:
    case kMmOnly: CORAL_PROBE(kNoVpu);
    case kNoDvec: CORAL_PROBE(kNoDvec);
    case kNoDw: CORAL_PROBE(kNoDw);
    case kNoDx: CORAL_PROBE(kNoDx);
    case kNoInter: CORAL_PROBE(kNoInter);
    default: return -1;
  }
#undef CORAL_PROBE
}
}  // namespace

// The forward; xhat and rstd null for the serving (y-only) launch. Returns the
// cudaError_t of the launch, or -1 for a shape it was not built for.
extern "C" int coral_conv_ln_gelu(const void* x, const void* w, const void* bias,
                                  const void* gamma, const void* beta, void* y, void* xhat,
                                  void* rstd, int B, int T_in, int T_out, int C, int K,
                                  float eps, void* stream) {
  if (C != kC) return -1;
  if (B <= 0 || T_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2) return launch<2>(x, w, bias, gamma, beta, y, xhat, rstd, B, T_in, T_out, eps, s);
  if (K == 3) return launch<3>(x, w, bias, gamma, beta, y, xhat, rstd, B, T_in, T_out, eps, s);
  return -1;
}

// The backward: three launches on one stream, (i) the row kernel (da, dvec
// partials), (ii) dx, (iii) the dW partials. x: (B, T_in, C) bf16; w: (C_out, K,
// C_in) bf16; gamma, beta: (C,) fp32; xhat, dy: (B, T_out, C) bf16; rstd: (B,
// T_out) fp32; da: (B, T_out, C) bf16 scratch; dx: (B, T_in, C) bf16; dw_part:
// (B * n_chunks, K, C_out, C_in) fp32; dvec_part: (row_blocks, 3, C) fp32.
// Returns the first launch's cudaError_t that is not 0, or -1 for a shape it
// was not built for.
extern "C" int coral_conv_ln_gelu_bwd(const void* x, const void* w, const void* gamma,
                                      const void* beta, const void* xhat, const void* rstd,
                                      const void* dy, void* da, void* dx, void* dw_part,
                                      void* dvec_part, int B, int T_in, int T_out, int C, int K,
                                      int row_blocks, int chunk, int n_chunks, void* stream) {
  if (C != kC || chunk <= 0 || chunk % kWBK) return -1;
  if (B <= 0 || T_out <= 0 || row_blocks <= 0 || n_chunks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2)
    return launch_bwd<2, kFull>(x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, B,
                                T_in, T_out, row_blocks, chunk, n_chunks, s);
  if (K == 3)
    return launch_bwd<3, kFull>(x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, B,
                                T_in, T_out, row_blocks, chunk, n_chunks, s);
  return -1;
}

// The backward in probe mode `mode` (BwdMode: 0 full, 1 no_vpu, 2 no_dvec, 3
// no_dw, 4 no_dx, 5 no_inter, 6 mm_only), arguments as coral_conv_ln_gelu_bwd;
// events null or 4 cudaEvent_t recorded around the launches. Returns the
// first cudaError_t that is not 0, or -1 for a mode or shape it was not built
// for.
extern "C" int coral_conv_ln_gelu_bwd_probe(int mode, const void* x, const void* w,
                                            const void* gamma, const void* beta,
                                            const void* xhat, const void* rstd, const void* dy,
                                            void* da, void* dx, void* dw_part, void* dvec_part,
                                            int B, int T_in, int T_out, int C, int K,
                                            int row_blocks, int chunk, int n_chunks,
                                            void* const* events, void* stream) {
  if (C != kC || chunk <= 0 || chunk % kWBK || mode < 0 || mode > kMmOnly) return -1;
  if (B <= 0 || T_out <= 0 || row_blocks <= 0 || n_chunks <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2)
    return launch_probe<2>(mode, x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part,
                           B, T_in, T_out, row_blocks, chunk, n_chunks, s, events);
  if (K == 3)
    return launch_probe<3>(mode, x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part,
                           B, T_in, T_out, row_blocks, chunk, n_chunks, s, events);
  return -1;
}
