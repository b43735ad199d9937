// Feature-encoder block: gelu(layer_norm(conv1d(x, w, stride=2) + bias)), forward
// and backward, on csrc/ffn_gemm.cuh's TMA ring and wgmma.
//
// Forward. Replaces: coral_tpu/ops/conv_ln_gelu_pallas.py `_fwd_pallas` /
// `_fwd_kernel` (:133; FE convs 1-6 of XLS-R: k = 3, 3, 3, 3, 2, 2; 512 -> 512
// channels). Serving writes y only; training also writes the TPU kernel's
// residuals, xhat (the pre-affine normalised rows, rounded to bf16) and rstd.
//
// Bound on the H100: the tensor cores, 2 k C^2 flops an output row against
// 2 k C bytes of input read and 2 C of output written; beside the products,
// the L2 traffic of the operand tiles each block streams.
//
// Design: an implicit GEMM. Output row t reads input rows 2t .. 2t+k-1, so
// the conv is a GEMM of M = T_out rows of a batch row, N = 512 output
// channels and K = k x 512, whose A operand for tap j is x from row j on with
// rows 2C apart: one TMA tensor map a tap (hopper::encode_heads' 4-D (64, 8,
// T_out, B) over x + j C, row stride 2 C, batch stride T_in C). A map has T_out
// rows, so TMA loads zeros past the last output row and never reads past a
// batch row, for any T_in, odd or even (a view of x as (T_in / 2, 2 C) pairs
// would read past the allocation at an odd T_in). The K loop runs 64-deep
// chunks (chunk c: tap c / 8, channels 64 (c % 8) ..) through the ring of
// ffn_gemm.cuh (gemm::Ring): a producer thread keeps TMA copies of the x chunk
// and of the (C_out, k C_in) K-major weight's tile in flight, two consumer
// warpgroups run wgmma m64n128k16 on them with fp32 accumulators in
// registers (setmaxnreg 40 / 232). The LayerNorm needs whole 512-wide rows
// and 128 x 512 fp32 accumulators exceed two warpgroups' registers, so a
// 2-block cluster takes 128 rows, each block 256 of the columns (each
// warpgroup 64 rows x 256 columns, 128 accumulators a thread), and the row
// sums cross the pair through distributed shared memory. The epilogue runs in
// registers: + bias, the two-pass fp32 mean and variance over all 512 columns
// (the pair's halves added in rank order, so both blocks agree), xhat, y =
// gelu(xhat gamma + beta) (csrc/gelu_poly.cuh), y (and xhat) stored as bf16
// pairs, rows past T_out never stored. A cluster walks row tiles in turn
// (one cluster a pair of SMs), so the producer copies the next tile's first
// chunks while the consumers run the epilogue. The other candidate, one
// block a tile of 64 rows x 512 (each warpgroup one column half of the same
// rows, the row sums crossing the warpgroups in shared memory; 72 KB from L2
// a chunk against the pair's 48), was 1.22x slower at FE block 1 serving and
// 1.05x in training (NVIDIA H100 80GB HBM3, 700 W; tools/probe_conv.py from
// an edited copy, PERF.md).
//
// Backward. Replaces: `_bwd_pallas` / `_bwd_kernel` (:174; dGELU, dLN, conv dx
// and dW, dbias/dgamma/dbeta) and `_halo_fixup` / `_fixup_kernel` (:374; the
// k = 3 dx row that crosses a TPU slab).
//
// Bound on the H100: the tensor cores. dx and dW are each k x 2 x 512 x 512
// flops per output row (about 200 GFLOP apiece for FE block 1 at 8 x 10 s),
// against 1 KB of da and 2-3 KB of x read per row.
//
// Design. The TPU kernel does all of it in one pass over row slabs and carries
// dW in VMEM from grid step to grid step; blocks here run in no order, so the
// work is split in four kernels around a materialised bf16 da, each of which
// owns its outputs:
// (i)   a row kernel, one warp per output row (the whole 512-wide row in
//       registers), forms dh = dy gelu'(h), the LayerNorm backward da = (dn -
//       mean(dn) - xhat mean(dn xhat)) rstd, rounds da to bf16, and keeps fp32
//       dgamma/dbeta/dbias sums per warp; each block adds its warps in a fixed
//       order and writes one (3, C) partial.
// (ii)  dx on the ring: input row 2s is da[s] W0 + da[s-1] W2 (k = 3) and row
//       2s+1 is da[s] W1. A tile is 128 row pairs x 128 input channels, K = 512
//       output channels in 64-deep chunks; each consumer warpgroup keeps two
//       accumulators (even and odd rows). A stage holds da's chunk for rows s0
//       .. s0+127 and, for k = 3, a second box of rows s0-1 .. s0+126 (a
//       one-row shift of a 128-byte-swizzled box is not the same box; TMA
//       loads zeros at row -1), and each tap's (c_out x c_in) tile, N-major
//       (the transpose bit), from the same K-major weight. So the row that the
//       TPU adds with `_halo_fixup` is part of the tile's own product: no
//       fixup pass and no atomics. da rows outside [0, T_out) load as zeros,
//       which also writes dx = 0 on every input row that no output reads
//       (past 2(T_out-1)+k-1); the tiles cover every input row. Blocks walk
//       tiles in turn, as the forward's clusters.
// (iii) dW_j = sum_t da[t]^T x[2t+j], a product whose reduction runs over all
//       B T_out rows: gemm::atb's A^T B over rows, A = da's chunk and B = tap
//       j's rows (the forward's tap maps, 64-row boxes), both M/N-major.
//       The row chunks (64 rows of one batch row) are split into R ranges, R
//       from the shape alone (the wrapper's `dw_ranges`), so that 16 k R
//       blocks fill the card; each block writes the fp32 partial of one tap's
//       128 x 128 tile over its range.
// (iv)  a finish kernel sums the R partials in range order into dW in the
//       Conv1d layout (C_out, C_in, k) and the row kernel's partials in block
//       order into dvec (3, C): no float atomics, so two calls give the same
//       bits.
//
// Probe modes. Replaces tools/probe_fe_bwd.py `_bwd_variant` (:138, its
// `pallas_call` :148) -> `_variant_kernel` (:50): the production backward
// with one phase taken out, so that each phase's cost is the difference to
// the full backward (and, here, also each launch's own time). The modes are
// template instantiations of the launches above:
//   kFull     the production kernels (the same instantiation the backward
//             launches);
//   kNoVpu    the row kernel is a copy da = dy (no dGELU, LayerNorm backward
//             or dvec); dx and dW as in production;
//   kNoDvec   the row kernel without its three dvec partial sums;
//   kNoDw     the dW launch is skipped;
//   kNoDx     the dx launch is skipped; the row kernel writes da into rows
//             t < T_out of dx (the dW kernel reads it there, batch rows T_in
//             apart), as the TPU variant writes dx[:, :T_out] = da;
//   kNoInter  the dx kernel writes the even rows of each 256-pair slab to the
//             slab's first 256 rows and the odd rows to its last 256, the TPU
//             variant's two half writes at its 256-row tile, instead of
//             interleaving them;
//   mm_only   (`da = dy` without the row mask, then the products) is kNoVpu
//             here: the loaders already zero every row past T_out, so the
//             TPU variant's unmasked read has no counterpart.
// What a mode does not compute is not written: the caller zeroes dvec (kNoVpu,
// kNoDvec), dW (kNoDw) and dx (kNoDx, kNoInter) where it needs them.
#include <algorithm>

#include "common.cuh"
#include "ffn_gemm.cuh"
#include "gelu_poly.cuh"
#include "hopper.cuh"

namespace {

constexpr int kC = 512;                   // input and output channels
constexpr int kChunk = 64;                // a stage's K depth: 128 bytes of bf16
constexpr int kBlocks = kC / kChunk;      // a row's 64-channel blocks: a tap's chunks
constexpr int kThreads = gemm::kThreads;  // the producer warpgroup and two consumers
constexpr int kConsumerWarps = 8;

// Tap j's A operand: x from row j on, rows 2 C apart, as the 4-D tensor (64,
// 8, T_out, B), a box 64 channels by box_rows rows of one batch row. 0, or
// the encoder's CUresult.
inline int tap_maps(CUtensorMap* maps, const void* x, int K, int B, int T_in, int T_out,
                    int box_rows) {
  for (int j = 0; j < K; ++j) {
    const int err = hopper::encode_heads(&maps[j], static_cast<const bf16*>(x) + j * kC, kChunk,
                                         kBlocks, T_out, B, 2LL * kC, (long long)T_in * kC,
                                         kChunk, box_rows);
    if (err != 0) return err;
  }
  return 0;
}

// da, (B, rows, C) bf16 with T_out rows of a batch row read (rows = T_out, or
// T_in where da lives in dx), as the 4-D tensor (64, 8, T_out, B).
inline int da_map(CUtensorMap* map, const void* da, int B, int rows, int T_out, int box_rows) {
  return hopper::encode_heads(map, da, kChunk, kBlocks, T_out, B, kC, (long long)rows * kC,
                              kChunk, box_rows);
}

// Kernel attributes once per kernel and process, off every later call's path.
template <auto kKernel, int kSmem>
cudaError_t smem_attribute() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  return attr;
}

// --- Forward -----------------------------------------------------------------------

// A 2-block cluster takes 128 output rows, each block 256 of the 512
// columns and each of its consumer warpgroups 64 rows x 256.
template <int K>
struct FwdShape {
  static constexpr int kRows = 128;
  static constexpr int kChunks = K * kBlocks;
  static constexpr int kA = kRows * 128;  // the chunk of x
  static constexpr int kB = 256 * 128;    // the weight's tile, K-major
  static constexpr int kStage = kA + kB;
  static constexpr int kStages = 4;
  static constexpr int kRed = kStages * kStage;  // two exchange buffers of 128 fp32
  static constexpr int kBars = kRed + 2 * 128 * 4;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert(kStage % 1024 == 0, "each tile 1024-aligned");
  static_assert(kSmem <= gemm::kMaxSmem, "the ring must fit a block");
};

struct FwdMaps {
  CUtensorMap tap[3], w;
};

struct FwdArgs {
  const float* bias;   // (C,) fp32
  const float* gamma;  // (C,) fp32
  const float* beta;   // (C,) fp32
  bf16* y;             // (B, T_out, C)
  bf16* xhat;          // the training launch: (B, T_out, C), else null
  float* rstd;         // the training launch: (B, T_out), else null
  int T_out;
  int tiles_b;         // row tiles of a batch row
  int n_tiles;         // B tiles_b
  int groups;          // clusters: cluster g takes tiles g, g + groups, ..
  float eps;
};

// The epilogue of a tile at (b, t0), from acc0 and acc1 (columns cb .. cb+127
// and cb+128 .. cb+255, cb = 256 rank, of the thread's rows lr and lr + 8 of
// the tile).
template <bool kTrain>
__device__ __forceinline__ void fwd_epilogue(const FwdArgs& a, const gemm::Lane& ln,
                                             float (&acc0)[64], float (&acc1)[64], float* red,
                                             int rank, int b, int t0) {
  const int lr = 64 * ln.wg + ln.row;
  const int cb = 256 * rank;
  // The row sums over all 512 columns of v[0] (row lr) and v[1] (row lr + 8),
  // each thread's values first, then the quad's (all four lanes get the same
  // bits), then the pair's two halves in rank order through buffer `buf` of
  // each block's shared memory: both blocks get the same bits.
  auto row_sums = [&](float (&v)[2], int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
    }
    float* r = red + 128 * buf;
    if (ln.quad == 0) r[lr] = v[0], r[lr + 8] = v[1];
    hopper::cluster_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = hopper::smem_u32(r + lr + 8 * h);
      v[h] = hopper::ld_cluster_f32(hopper::map_to_rank(at, 0)) +
             hopper::ld_cluster_f32(hopper::map_to_rank(at, 1));
    }
  };
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b0 = *reinterpret_cast<const float2*>(a.bias + cb + 8 * j + 2 * ln.quad);
    const float2 b1 = *reinterpret_cast<const float2*>(a.bias + cb + 128 + 8 * j + 2 * ln.quad);
    acc0[4 * j] += b0.x, acc0[4 * j + 1] += b0.y, acc0[4 * j + 2] += b0.x, acc0[4 * j + 3] += b0.y;
    acc1[4 * j] += b1.x, acc1[4 * j + 1] += b1.y, acc1[4 * j + 2] += b1.x, acc1[4 * j + 3] += b1.y;
    s[0] += (acc0[4 * j] + acc0[4 * j + 1]) + (acc1[4 * j] + acc1[4 * j + 1]);
    s[1] += (acc0[4 * j + 2] + acc0[4 * j + 3]) + (acc1[4 * j + 2] + acc1[4 * j + 3]);
  }
  row_sums(s, 0);
  const float mean[2] = {s[0] / kC, s[1] / kC};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int h = (e >> 1) & 1;
    acc0[e] -= mean[h];
    acc1[e] -= mean[h];
    q[h] += acc0[e] * acc0[e] + acc1[e] * acc1[e];
  }
  row_sums(q, 1);
  const bool own_rstd = kTrain && rank == 0 && ln.quad == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + lr + 8 * h;
    if (t >= a.T_out) continue;
    const float rstd = rsqrtf(q[h] / kC + a.eps);
    const long long row = (long long)b * a.T_out + t;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* acc = c == 0 ? acc0 : acc1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = cb + 128 * c + 8 * j + 2 * ln.quad;
        const float2 g = *reinterpret_cast<const float2*>(a.gamma + col);
        const float2 be = *reinterpret_cast<const float2*>(a.beta + col);
        const float n0 = acc[4 * j + 2 * h] * rstd, n1 = acc[4 * j + 2 * h + 1] * rstd;
        *reinterpret_cast<uint32_t*>(a.y + row * kC + col) =
            gemm::pack_bf16(coral_gelu(n0 * g.x + be.x), coral_gelu(n1 * g.y + be.y));
        if constexpr (kTrain)
          *reinterpret_cast<uint32_t*>(a.xhat + row * kC + col) = gemm::pack_bf16(n0, n1);
      }
    }
    if (own_rstd) a.rstd[row] = rstd;
  }
}

// One launch of the forward: grid (2, groups) in clusters of (2, 1, 1),
// kThreads threads, FwdShape::kSmem bytes of dynamic shared memory.
template <int K, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
    conv_ln_gelu_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  using S = FwdShape<K>;
  unsigned char* smem = gemm::aligned_smem();
  const uint32_t base = hopper::smem_u32(smem);
  float* red = reinterpret_cast<float*>(smem + S::kRed);
  const gemm::Ring<S::kStages> ring{base + S::kBars};
  const int rank = (int)hopper::cluster_rank();
  const int g = blockIdx.y;
  const int n_tiles = (a.n_tiles - g + a.groups - 1) / a.groups;
  const int n_iter = n_tiles * S::kChunks;
  auto tile_at = [&](int ti, int& b, int& t0) {
    const int id = g + ti * a.groups;
    b = id / a.tiles_b;
    t0 = (id - b * a.tiles_b) * S::kRows;
  };
  // Ring iteration i: chunk i % kChunks of the block's tile i / kChunks.
  auto load = [&](int i) {
    const int ti = i / S::kChunks, c = i - ti * S::kChunks;
    int b, t0;
    tile_at(ti, b, t0);
    const uint32_t st = base + (i % S::kStages) * S::kStage, bar = ring.full(i % S::kStages);
    hopper::mbar_arrive_expect_tx(bar, S::kStage);
    hopper::tma_load_4d(st, &maps.tap[c / kBlocks], bar, 0, c % kBlocks, t0, b);
    hopper::tma_load_2d(st + S::kA, &maps.w, bar, c * kChunk, 256 * rank);
  };
  if (threadIdx.x == 0) {
    ring.init(kConsumerWarps);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&maps.w);
    for (int i = 0; i < S::kStages && i < n_iter; ++i) load(i);
  }

  if (threadIdx.x < 128) {
    hopper::reg_dealloc<gemm::kProducerRegs>();
    // Every thread of the cluster joins the consumers' two cluster barriers
    // of each tile (and the last one): warp 0 between its copies, once the
    // next tile's first kStages copies are in flight (they need only the
    // stages that the tile's last chunks freed), the other warps at once.
    int synced = 0;
    if (threadIdx.x < 32) {
#pragma unroll 1
      for (int i = S::kStages; i < n_iter; ++i) {
        ring.wait_empty(i);
        if (threadIdx.x == 0) load(i);
        __syncwarp();
        if (i % S::kChunks == S::kStages - 1 && i >= S::kChunks) {
          hopper::cluster_sync();
          hopper::cluster_sync();
          ++synced;
        }
      }
    }
#pragma unroll 1
    for (; synced < n_tiles; ++synced) {
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    hopper::cluster_sync_relaxed();
    return;
  }

  hopper::reg_alloc<gemm::kConsumerRegs>();
  const gemm::Lane ln;
  const uint32_t a_rows = ln.wg * 64 * 128;  // the warpgroup's rows of x
#pragma unroll 1
  for (int ti = 0; ti < n_tiles; ++ti) {
    int b, t0;
    tile_at(ti, b, t0);
    float acc0[64], acc1[64];
    ring.template consume<S::kStage>(base, ti * S::kChunks, S::kChunks, ln.lane,
                            [&](uint32_t st, bool first) {
      hopper::fence_regs(acc0);
      hopper::fence_regs(acc1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int keep = !first || kk > 0;
        const uint64_t da = hopper::smem_desc(st + a_rows + 32 * kk, 1024, 128);
        const uint32_t wb = st + S::kA + 32 * kk;
        hopper::wgmma_m64n128k16_ss(acc0, da, hopper::smem_desc(wb, 1024, 128), keep);
        hopper::wgmma_m64n128k16_ss(acc1, da, hopper::smem_desc(wb + 128 * 128, 1024, 128),
                                    keep);
      }
    });
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
    fwd_epilogue<kTrain>(a, ln, acc0, acc1, red, rank, b, t0);
  }
  hopper::cluster_sync_relaxed();  // no block leaves while its pair reads
}

template <int K, bool kTrain>
int launch_fwd(const void* x, const void* w, const void* bias, const void* gamma,
               const void* beta, void* y, void* xhat, void* rstd, int B, int T_in, int T_out,
               float eps, cudaStream_t stream) {
  using S = FwdShape<K>;
  constexpr auto kKernel = conv_ln_gelu_kernel<K, kTrain>;
  FwdMaps maps;
  int err = tap_maps(maps.tap, x, K, B, T_in, T_out, S::kRows);
  if (err == 0) err = gemm::weight_map(&maps.w, w, K * kC, kC, 256);
  if (err != 0) return err;
  FwdArgs a;
  a.bias = static_cast<const float*>(bias);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.y = static_cast<bf16*>(y);
  a.xhat = static_cast<bf16*>(xhat);
  a.rstd = static_cast<float*>(rstd);
  a.T_out = T_out;
  a.tiles_b = (T_out + S::kRows - 1) / S::kRows;
  a.n_tiles = B * a.tiles_b;
  a.eps = eps;
  const cudaError_t attr = smem_attribute<kKernel, S::kSmem>();
  if (attr != cudaSuccess) return (int)attr;
  a.groups = std::min(a.n_tiles, std::max(1, gemm::sm_count() / 2));  // a cluster a pair of SMs
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 2;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, (unsigned)a.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kKernel, maps, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// --- Backward ------------------------------------------------------------------

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

// dx: a tile of 128 row pairs (input rows 2s, 2s+1 for s = s0 ..) x 128 input
// channels; a stage holds da's chunk (rows s0 ..), for k = 3 its box at s0 -
// 1, and the taps' 64 x 128 weight tiles.
template <int K>
struct DxShape {
  static constexpr int kPairs = 128;
  static constexpr int kA = kPairs * 128;         // da rows s0 .. s0+127
  static constexpr int kW = K == 3 ? 2 * kA : kA;  // the taps' tiles from here
  static constexpr int kTap = 64 * 128 * 2;       // W_j's (64 c_out x 128 c_in) tile
  static constexpr int kStage = kW + K * kTap;
  static constexpr int kStages = K == 3 ? 2 : 4;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert(kSmem <= gemm::kMaxSmem, "the ring must fit a block");
};

// kSplit (kNoInter): the rows of pair s of slab s / 256 go to row 512 (s /
// 256) + s % 256 (even) and that + 256 (odd), instead of 2s and 2s + 1.
constexpr int kSlabPairs = 256;

struct DxMaps {
  CUtensorMap da, w;
};

struct DxArgs {
  bf16* dx;  // (B, T_in, C)
  int T_in;
  int pair_tiles;  // tiles of 128 pairs a batch row
  int n_tiles;     // B pair_tiles 4
  int groups;      // blocks: block g takes tiles g, g + groups, ..
};

// One launch of dx: grid (groups), kThreads threads, DxShape::kSmem bytes.
template <int K, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    conv_bwd_dx_kernel(const __grid_constant__ DxMaps maps, const DxArgs a) {
  using S = DxShape<K>;
  const uint32_t base = hopper::smem_u32(gemm::aligned_smem());
  const gemm::Ring<S::kStages> ring{base + S::kBars};
  const int g = blockIdx.x;
  const int n_tiles = (a.n_tiles - g + a.groups - 1) / a.groups;
  const int n_iter = n_tiles * kBlocks;
  // Tile id: the column tile fastest, so neighbouring blocks share da's rows.
  auto tile_at = [&](int ti, int& b, int& s0, int& n0) {
    const int id = g + ti * a.groups, rest = id / (kC / 128);
    n0 = (id - rest * (kC / 128)) * 128;
    b = rest / a.pair_tiles;
    s0 = (rest - b * a.pair_tiles) * S::kPairs;
  };
  auto load = [&](int i) {
    const int ti = i / kBlocks, c = i - ti * kBlocks;
    int b, s0, n0;
    tile_at(ti, b, s0, n0);
    const uint32_t st = base + (i % S::kStages) * S::kStage, bar = ring.full(i % S::kStages);
    hopper::mbar_arrive_expect_tx(bar, S::kStage);
    hopper::tma_load_4d(st, &maps.da, bar, 0, c, s0, b);
    if constexpr (K == 3) hopper::tma_load_4d(st + S::kA, &maps.da, bar, 0, c, s0 - 1, b);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      hopper::tma_load_2d(st + S::kW + j * S::kTap, &maps.w, bar, j * kC + n0, c * kChunk);
      hopper::tma_load_2d(st + S::kW + j * S::kTap + S::kTap / 2, &maps.w, bar,
                          j * kC + n0 + 64, c * kChunk);
    }
  };
  if (threadIdx.x == 0) {
    ring.init(kConsumerWarps);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    hopper::reg_dealloc<gemm::kProducerRegs>();
    if (threadIdx.x != 0) return;
    hopper::prefetch_tensormap(&maps.w);
    for (int i = 0; i < S::kStages && i < n_iter; ++i) load(i);
    ring.produce(S::kStages, n_iter, load);
    return;
  }
  hopper::reg_alloc<gemm::kConsumerRegs>();
  const gemm::Lane ln;
  const uint32_t a_rows = ln.wg * 64 * 128;
#pragma unroll 1
  for (int ti = 0; ti < n_tiles; ++ti) {
    int b, s0, n0;
    tile_at(ti, b, s0, n0);
    float ev[64], od[64];
    ring.template consume<S::kStage>(base, ti * kBlocks, kBlocks, ln.lane, [&](uint32_t st, bool first) {
      hopper::fence_regs(ev);
      hopper::fence_regs(od);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int keep = !first || kk > 0;
        const uint64_t d0 = hopper::smem_desc(st + a_rows + 32 * kk, 1024, 128);
        auto tap = [&](int j) {
          return hopper::smem_desc(st + S::kW + j * S::kTap + 2048 * kk, 1024, 128, S::kTap / 2);
        };
        hopper::wgmma_m64n128k16_ss_tb(ev, d0, tap(0), keep);
        hopper::wgmma_m64n128k16_ss_tb(od, d0, tap(1), keep);
        if constexpr (K == 3)
          hopper::wgmma_m64n128k16_ss_tb(
              ev, hopper::smem_desc(st + S::kA + a_rows + 32 * kk, 1024, 128), tap(2), 1);
      }
    });
    hopper::fence_regs(ev);
    hopper::fence_regs(od);
    // Pair s: even row (ev) and odd row (od), rows below T_in only.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long s = s0 + 64 * ln.wg + ln.row + 8 * h;
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        const long long r = kSplit ? 2LL * kSlabPairs * (s / kSlabPairs) + par * kSlabPairs +
                                         s % kSlabPairs
                                   : 2 * s + par;
        if (r >= a.T_in) continue;
        const float* acc = par ? od : ev;
        bf16* out = a.dx + ((long long)b * a.T_in + r) * kC + n0 + 2 * ln.quad;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              gemm::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// dW's partials: grid (16 tiles, K taps, R ranges); block (tile, j, r) writes
// part[r][j] (C_out x C_in fp32), the tile's sum over the range's chunks.
struct DwMaps {
  CUtensorMap da, tap[3];
};

struct DwArgs {
  float* part;     // (R, K, C, C)
  int chunks_b;    // 64-row chunks of a batch row
  int n_chunks;    // B chunks_b
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
    conv_bwd_dw_kernel(const __grid_constant__ DwMaps maps, const DwArgs a) {
  const int m0 = (blockIdx.x / (kC / 128)) * 128, n0 = (blockIdx.x % (kC / 128)) * 128;
  const int j = blockIdx.y, r = blockIdx.z, R = gridDim.z;
  const int lo = (int)((long long)r * a.n_chunks / R);
  const int hi = (int)((long long)(r + 1) * a.n_chunks / R);
  const CUtensorMap* tap = &maps.tap[j];
  gemm::atb::tile(
      [&](int i, uint32_t st, uint32_t bar) {
        const int id = lo + i, b = id / a.chunks_b, t0 = (id - b * a.chunks_b) * kChunk;
        using gemm::atb::kBox;
        hopper::tma_load_4d(st, &maps.da, bar, 0, m0 / 64, t0, b);
        hopper::tma_load_4d(st + kBox, &maps.da, bar, 0, m0 / 64 + 1, t0, b);
        hopper::tma_load_4d(st + 2 * kBox, tap, bar, 0, n0 / 64, t0, b);
        hopper::tma_load_4d(st + 3 * kBox, tap, bar, 0, n0 / 64 + 1, t0, b);
      },
      hi - lo, a.part + ((long long)r * K + j) * kC * kC, kC, m0, n0);
}

// The finish: blocks [0, dw_blocks) sum dW's R partials (R, K, C, C) in range
// order into dw (C_out, C_in, K), a (c_out, c_in) a thread; the next 3 C / 32
// blocks sum the row kernel's n_parts (3, C) partials into dvec, 32 values a
// block: warp w adds partials w, w + 8, .. in order, then the 8 warps' sums in
// order.
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads)
    conv_bwd_finish_kernel(const float* __restrict__ part, int R, int K, float* __restrict__ dw,
                           int dw_blocks, const float* __restrict__ dvec_part, int n_parts,
                           float* __restrict__ dvec) {
  if ((int)blockIdx.x < dw_blocks) {
    const long long e = (long long)blockIdx.x * kFinishThreads + threadIdx.x;
    float s[3] = {0.f, 0.f, 0.f};
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j < K) s[j] += part[((long long)r * K + j) * kC * kC + e];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < K) dw[e * K + j] = s[j];
    return;
  }
  __shared__ float red[kFinishThreads / 32][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e = (blockIdx.x - dw_blocks) * 32 + lane;
  float s = 0.f;
  for (int p = warp; p < n_parts; p += kFinishThreads / 32) s += dvec_part[(long long)p * 3 * kC + e];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kFinishThreads / 32; ++w) t += red[w][lane];
    dvec[e] = t;
  }
}

struct BwdBuffers {
  const void *x, *w, *gamma, *beta, *xhat, *rstd, *dy;
  void *da, *dx, *dw_part, *dvec_part, *dw, *dvec;
};

// The backward's launches in mode kMode; with events (4 cudaEvent_t, the
// probe's), records events[0] before the row kernel and events[i] after the
// row kernel (1), dx (2), dW and the finish (3), a skipped launch included.
template <int K, int kMode>
int launch_bwd(const BwdBuffers& p, int B, int T_in, int T_out, int row_blocks, int R,
               cudaStream_t stream, void* const* events = nullptr) {
  constexpr bool kDw = kMode != kNoDw;
  constexpr bool kDvec = kMode != kNoVpu && kMode != kNoDvec;
  auto mark = [&](int i) {
    return events == nullptr ? cudaSuccess
                             : cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream);
  };
  // kNoDx: da lives in dx's rows t < T_out.
  void* da_buf = kMode == kNoDx ? p.dx : p.da;
  const int da_rows = kMode == kNoDx ? T_in : T_out;
  const int sms = gemm::sm_count();
  cudaError_t err = mark(0);
  if (err != cudaSuccess) return (int)err;
  conv_bwd_rows_kernel<kMode><<<row_blocks, kRowWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(p.xhat), static_cast<const float*>(p.rstd),
      static_cast<const bf16*>(p.dy), static_cast<const float*>(p.gamma),
      static_cast<const float*>(p.beta), static_cast<bf16*>(da_buf),
      static_cast<float*>(p.dvec_part), (long long)B * T_out, T_out, da_rows);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = mark(1);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kMode != kNoDx) {
    using S = DxShape<K>;
    constexpr auto kKernel = conv_bwd_dx_kernel<K, kMode == kNoInter>;
    DxMaps maps;
    int e = da_map(&maps.da, da_buf, B, da_rows, T_out, S::kPairs);
    if (e == 0) e = gemm::weight_map(&maps.w, p.w, K * kC, kC, 64);
    if (e != 0) return e;
    err = smem_attribute<kKernel, S::kSmem>();
    if (err != cudaSuccess) return (int)err;
    DxArgs a;
    a.dx = static_cast<bf16*>(p.dx);
    a.T_in = T_in;
    a.pair_tiles = ((T_in + 1) / 2 + S::kPairs - 1) / S::kPairs;
    a.n_tiles = B * a.pair_tiles * (kC / 128);
    a.groups = std::min(a.n_tiles, sms);
    kKernel<<<a.groups, kThreads, S::kSmem, stream>>>(maps, a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = mark(2);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kDw) {
    constexpr auto kKernel = conv_bwd_dw_kernel<K>;
    DwMaps maps;
    int e = da_map(&maps.da, da_buf, B, da_rows, T_out, 64);
    if (e == 0) e = tap_maps(maps.tap, p.x, K, B, T_in, T_out, 64);
    if (e != 0) return e;
    err = smem_attribute<kKernel, gemm::atb::kSmem>();
    if (err != cudaSuccess) return (int)err;
    DwArgs a;
    a.part = static_cast<float*>(p.dw_part);
    a.chunks_b = (T_out + kChunk - 1) / kChunk;
    a.n_chunks = B * a.chunks_b;
    kKernel<<<dim3((kC / 128) * (kC / 128), K, R), kThreads, gemm::atb::kSmem, stream>>>(maps,
                                                                                       a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && (kDw || kDvec)) {
    const int dw_blocks = kDw ? kC * kC / kFinishThreads : 0;
    const int blocks = dw_blocks + (kDvec ? 3 * kC / 32 : 0);
    conv_bwd_finish_kernel<<<blocks, kFinishThreads, 0, stream>>>(
        static_cast<const float*>(p.dw_part), R, K, static_cast<float*>(p.dw), dw_blocks,
        static_cast<const float*>(p.dvec_part), row_blocks, static_cast<float*>(p.dvec));
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = mark(3);
  return (int)err;
}

template <int K>
int launch_probe(int mode, const BwdBuffers& p, int B, int T_in, int T_out, int row_blocks,
                 int R, cudaStream_t s, void* const* events) {
  switch (mode) {
    case kFull: return launch_bwd<K, kFull>(p, B, T_in, T_out, row_blocks, R, s, events);
    case kNoVpu:
    case kMmOnly: return launch_bwd<K, kNoVpu>(p, B, T_in, T_out, row_blocks, R, s, events);
    case kNoDvec: return launch_bwd<K, kNoDvec>(p, B, T_in, T_out, row_blocks, R, s, events);
    case kNoDw: return launch_bwd<K, kNoDw>(p, B, T_in, T_out, row_blocks, R, s, events);
    case kNoDx: return launch_bwd<K, kNoDx>(p, B, T_in, T_out, row_blocks, R, s, events);
    case kNoInter: return launch_bwd<K, kNoInter>(p, B, T_in, T_out, row_blocks, R, s, events);
    default: return -1;
  }
}

// The dW row split the kernels were built for: R ranges of 64-row chunks, at
// least one chunk each.
inline bool valid_ranges(int B, int T_out, int R) {
  const long long chunks = (long long)B * ((T_out + kChunk - 1) / kChunk);
  return R >= 1 && R <= chunks && R <= 65535;
}

}  // namespace

// The forward; xhat and rstd null for the serving (y-only) launch. x: (B,
// T_in, C) bf16; w: (C_out, K, C_in) bf16, each output channel's K C_in
// reduction values contiguous; bias, gamma, beta: (C,) fp32; y: (B, T_out,
// C) bf16. Returns the cudaError_t of the launch, the encoder's CUresult, or
// -1 for a shape it was not built for.
extern "C" int coral_conv_ln_gelu(const void* x, const void* w, const void* bias,
                                  const void* gamma, const void* beta, void* y, void* xhat,
                                  void* rstd, int B, int T_in, int T_out, int C, int K,
                                  float eps, void* stream) {
  if (C != kC || (xhat == nullptr) != (rstd == nullptr)) return -1;
  if (B <= 0 || T_out <= 0) return 0;
  if (B > 65535 || T_out > (T_in - K) / 2 + 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool train = xhat != nullptr;
#define CORAL_FWD(KK, TRAIN) \
  return launch_fwd<KK, TRAIN>(x, w, bias, gamma, beta, y, xhat, rstd, B, T_in, T_out, eps, s)
  if (K == 2) {
    if (train) CORAL_FWD(2, true);
    CORAL_FWD(2, false);
  }
  if (K == 3) {
    if (train) CORAL_FWD(3, true);
    CORAL_FWD(3, false);
  }
#undef CORAL_FWD
  return -1;
}

// The backward, on one stream: (i) the row kernel (da, dvec partials), (ii)
// dx, (iii) dW's partials over R row ranges, (iv) the finish (dw, dvec). x:
// (B, T_in, C) bf16; w: (C_out, K, C_in) bf16; gamma, beta: (C,) fp32; xhat,
// dy: (B, T_out, C) bf16; rstd: (B, T_out) fp32; da: (B, T_out, C) bf16
// scratch; dx: (B, T_in, C) bf16; dw_part: (R, K, C_out, C_in) fp32 scratch;
// dvec_part: (row_blocks, 3, C) fp32 scratch; dw: (C_out, C_in, K) fp32; dvec:
// (3, C) fp32 (dgamma, dbeta, dbias). Returns the first launch's cudaError_t
// that is not 0, the encoder's CUresult, or -1 for a shape it was not built
// for.
extern "C" int coral_conv_ln_gelu_bwd(const void* x, const void* w, const void* gamma,
                                      const void* beta, const void* xhat, const void* rstd,
                                      const void* dy, void* da, void* dx, void* dw_part,
                                      void* dvec_part, void* dw, void* dvec, int B, int T_in,
                                      int T_out, int C, int K, int row_blocks, int R,
                                      void* stream) {
  if (C != kC) return -1;
  if (B <= 0 || T_out <= 0 || row_blocks <= 0) return 0;
  if (!valid_ranges(B, T_out, R)) return -1;
  const BwdBuffers p{x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, dw, dvec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2) return launch_bwd<2, kFull>(p, B, T_in, T_out, row_blocks, R, s);
  if (K == 3) return launch_bwd<3, kFull>(p, B, T_in, T_out, row_blocks, R, s);
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
                                            void* dw, void* dvec, int B, int T_in, int T_out,
                                            int C, int K, int row_blocks, int R,
                                            void* const* events, void* stream) {
  if (C != kC || mode < 0 || mode > kMmOnly) return -1;
  if (B <= 0 || T_out <= 0 || row_blocks <= 0 || !valid_ranges(B, T_out, R)) return -1;
  const BwdBuffers p{x, w, gamma, beta, xhat, rstd, dy, da, dx, dw_part, dvec_part, dw, dvec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2) return launch_probe<2>(mode, p, B, T_in, T_out, row_blocks, R, s, events);
  if (K == 3) return launch_probe<3>(mode, p, B, T_in, T_out, row_blocks, R, s, events);
  return -1;
}
