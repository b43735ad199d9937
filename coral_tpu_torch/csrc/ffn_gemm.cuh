// The FFN up-projection's Hopper mainloop (TMA copies into an mbarrier ring,
// wgmma, setmaxnreg) and its three kernels, each a thin kernel over it with a
// policy:
// - ffn_fwd_kernel<Fwd<D, kLn, kDrop>>: g = dropout(gelu(A W1^T + b1)), A =
//   bf16(layer_norm(x)) (kLn) or x. K5's forward (csrc/ffn.cu, kLn; replaces
//   coral_tpu/ops/ffn_pallas.py `_fwd_kernel_ln` :163 and
//   `_fwd_kernel_ln_drop` :169) and N1 (csrc/ffn_fc1.cu; `_fwd_kernel` :87,
//   `_fwd_kernel_drop` :92); with kGelu false, y = A W1^T + b1 rounded once,
//   the packed QKV projection's forward (csrc/ln_dense.cu, kLn;
//   `_fwd_kernel_lnmm` :485), whose F = 5760 at D 1920 ends in half a tile.
// - ffn_bwd_kernel<Bwd<D, kLn, kDrop, kDgIn, kEmitG>>: h = A W1^T + b1
//   recomputed, dg = dy W2^T beside it (kDgIn) or read in, dh = dg * mask /
//   keep * gelu'(h), g (kEmitG), ln_out (kLn), the db1 row partials. K5's
//   backward (csrc/ffn.cu: kLn, kDgIn, kEmitG; `_bwd_kernel_ln_g_dg` :366 /
//   `_drop` :385), N2 and N3 (csrc/ffn_fc1.cu: no LayerNorm, dg read in, N3
//   with g; `_bwd_kernel` :139, `_bwd_kernel_g` :418), N4 (csrc/ffn_ln_fc1.cu:
//   kLn, dg read in, no g; `_bwd_kernel_ln` :433), N5 and N6's first pass
//   (csrc/ffn_ln_g.cu: kLn, dg read in, g; `_bwd_kernel_ln_g` :263,
//   `_bwd_kernel_ln_dw` :282).
// - dl_kernel<Dl<OutT>>: out = dh W1 over K = F, in fp32 (dl, the LayerNorm
//   backward's input: K5, N4, N5, N6, and with dh := dy the packed QKV
//   projection's backward, csrc/ln_dense.cu) or bf16 (dx: N2, N3). The TPU
//   kernels fold it into their pass while dh is in VMEM; here all D columns
//   of a row's dl must be complete before its LayerNorm backward, and a
//   128-row fp32 dl tile is 640 KB at D = 1280, so it is a second kernel.
// Beside them, on the same ring and helpers: N7's cluster kernel
// (csrc/ffn_ln_fc2.cu: the row statistics' and chunk pass's arithmetic
// applied once a row, the forward's epilogue arithmetic, fc2 from the
// cluster's g tiles) and the A^T B tile at the end of this file (`atb`: K3's
// dW, N6's dW1 and dW2).
//
// Bound on the H100: the tensor cores. The forward makes 2 D F flops a row
// against 2 D bytes of x in and 2 F of g out (D = 1280, F = 5120: 13 MFLOP
// against 12.5 KB, about 1,000 flops a byte, over three times the card's 295);
// K5's backward three products of 2 D F (h again, dg, dl) against x, dy in
// and g, dh, ln_out out. What costs beside the products: the LayerNorm (a
// few flops an element of x, once per column tile), the GELU polynomials and
// the Philox mask (tens of integer operations a column), and the L2 traffic
// of re-reading x per column tile and W1 per row tile.
//
// Design: a block of 384 threads takes a 128-row tile of the output and
// `tiles` of its column tiles in turn (kN = 256 columns forward, 128
// backward and for dl; `tiles_per_block` picks how many from the grid's
// waves: 1, 2, 4 or 8 dividing the count, or for the bias-only forward any
// of 1 .. 8, a row's last block taking the rest), so the row statistics,
// the ring's fill and the barriers' set-up are paid once per block.
// Warpgroup 0 produces: its first warp's lane 0 keeps TMA copies in flight
// into a ring of kStages stages (3, 4 where a stage is 32 KB), each stage a
// 64-deep K chunk (one 128-byte swizzle row of bf16) of A (128 x 64) and B
// (the W1 tile, kN x 64 K-major; or 64 x 128 N-major for dl, and W2's for
// dg, with the transpose bit), with `full` and `empty` mbarriers; it runs
// ahead over the next tile's chunks while the consumers finish the current
// tile's epilogue. Warpgroups 1 and 2 consume, 64 rows each: wgmma
// m64n128k16 from shared memory, fp32 accumulators in registers (128 a
// thread: h's 256 columns forward; h and dg side by side in the backward), a
// chunk's products committed as one group and the previous chunk's stage
// released when it completes. setmaxnreg splits the registers 40 / 232.
//
// The LayerNorm (kLn) is applied to the streamed chunks, so shared memory
// does not grow with D and every width takes the same tile: before the
// split the block's 12 warps compute each row's mean and rstd in fp32,
// two-pass as `_ln_rows` (and csrc/ln_dense.cu's rows kernel, bit for
// bit: its ln_out is this forward's operand), into shared memory beside
// gamma and beta (staged there once: a global load of them in every pass
// was on its critical path); each consumer warpgroup then normalises its
// own 64 rows of each landed x chunk in place with the chunk's gamma and beta, rounds
// them to bf16 (the product's operand, as `_ln_matmul`), writes them to
// ln_out where the backward's column tile 0 runs (the dW1 operand, once),
// fences the async proxy and meets its warpgroup at a named barrier before
// the chunk's products. It does so for chunk k + 1 while chunk k's
// products run on the tensor cores, after releasing chunk k - 1's stage:
// released after the pass, the ring ran about one copy deep. Rows past M
// (TMA's zeros) stay zero. The alternatives, timed on an H100 from edited
// copies (coral_tpu_torch/tools/probe_ffn.py, PERF.md §6): three producer
// warps normalising whole chunks were slower; A normalised in registers and
// fed to wgmma RS gained nothing; a 2-block cluster multicasting the weight
// tiles was slower. Without the LayerNorm the same kernel runs at half its
// bound: the pass's arithmetic, not its synchronisation, is the difference.
//
// Epilogues in registers. Forward: + b1, the polynomial GELU
// (csrc/gelu_poly.cuh), the dropout mask and 1/keep scale, rounded to bf16
// once, staged per warpgroup through an XOR-swizzled 32 KB buffer and
// stored 16 bytes a thread, whole 512-byte rows of g per warp; rows past M
// are never written. Backward: dg from the second accumulator or from its
// bf16 tile (TMA, started during the tile's last chunk), the mask regenerated,
// dh = dg * keep * scale * gelu'(h) and g stored as bf16 pairs (rows below
// M), and the db1 partial: the column sums of the fp32 dh, a thread's two
// rows, then the warp's 16 rows by shuffles, then the 8 consumer warps in
// order through shared memory (rows past M add nothing; two calls give the
// same bits). dl: fp32 (or bf16) pairs from registers. The mask is
// csrc/philox.cuh's pure function of (seed[row / T], row % T, column): one
// Philox call gives 4 columns, and the two threads of a quad pair that
// share them each make one call (for row r and row r + 8) and swap half of
// the words, so the forward and every backward regenerate it bit for bit.
//
// Every product of h (forward, backward, N1-N5) is the same sequence of
// wgmma m64n128k16 over the same 64-deep chunks, so the backward's g is the
// forward's bit for bit.
//
// The weights' tensor maps are encoded once per (pointer, shape, box) and
// kept (weight_map); the activations' per call. cudaFuncSetAttribute runs
// once per instantiation and process.
#pragma once

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "gelu_poly.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

// Calls f(std::integral_constant<int, D>{}) for a width the FFN kernels are
// built for (every config of the repository: 384, 512, 768 for Whisper tiny,
// base and small, 1024 for XLS-R-300M and Whisper medium, 1280 for Whisper
// large and XLS-R-1B, 1920 for XLS-R-2B); returns -1 for any other.
template <typename Fn>
int with_width(int D, Fn&& f) {
  switch (D) {
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 768: return f(std::integral_constant<int, 768>{});
    case 1024: return f(std::integral_constant<int, 1024>{});
    case 1280: return f(std::integral_constant<int, 1280>{});
    case 1920: return f(std::integral_constant<int, 1920>{});
    default: return -1;
  }
}

inline bool built_width(int D) {
  return with_width(D, [](auto) { return 0; }) == 0;
}

namespace gemm {

constexpr int kRows = 128;       // a block's output rows, 64 a consumer warpgroup
constexpr int kChunk = 64;       // the K depth of a stage: 128 bytes of bf16
constexpr int kThreads = 384;    // the producer warpgroup and two consumers
constexpr int kATile = kRows * kChunk * 2;  // 16 KB: an A chunk (x, dy or dh)
constexpr int kNTile = 64 * 128 * 2;        // 16 KB: an N-major 64 x 128 weight tile
constexpr int kMaxSmem = 232448;            // a block's shared memory on the H100

// The forward: one product, 256 columns a tile (two m64n128 accumulators);
// the epilogue's GELU (kGelu), or + b alone (the packed QKV projection,
// csrc/ln_dense.cu).
template <int D_, bool kLn_, bool kDrop_, bool kGelu_ = true>
struct Fwd {
  static constexpr int D = D_, kN = 256, kStages = 3;
  static constexpr bool kFwd = true, kBwd = false, kDl = false, kLn = kLn_, kDrop = kDrop_,
                        kDgIn = false, kGelu = kGelu_;
  static_assert(kGelu_ || !kDrop_, "the bias-only epilogue has no dropout");
};

// The backward's first kernel: h and (kDgIn) dg side by side, 128 columns.
template <int D_, bool kLn_, bool kDrop_, bool kDgIn_, bool kEmitG_>
struct Bwd {
  static constexpr int D = D_, kN = 128, kStages = kDgIn_ ? 3 : 4;
  static constexpr bool kFwd = false, kBwd = true, kDl = false, kLn = kLn_, kDrop = kDrop_,
                        kDgIn = kDgIn_, kEmitG = kEmitG_;
};

// out = dh W1: 128 columns of D a tile, K = F.
template <typename OutT_>
struct Dl {
  static constexpr int D = 0, kN = 128, kStages = 4;
  static constexpr bool kFwd = false, kBwd = false, kDl = true, kLn = false, kDrop = false,
                        kDgIn = false;
  using OutT = OutT_;
};

// The ring's mbarriers, kS stages of them from shared address `bars`: stage s
// is `full` once its copies landed and `empty` once its consumers' warps are
// done with it; ring iteration i uses stage i % kS in phase i / kS. The FFN
// kernels' Layout places one after its buffers (Layout::ring), and the
// feature encoder's conv kernels (csrc/conv_ln_gelu.cu) run on the same ring.
template <int kS>
struct Ring {
  uint32_t bars;
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (kS + s); }
  // One thread: `full` counts the TMA's expect_tx, `empty` the consumer warps.
  __device__ __forceinline__ void init(int consumer_warps) const {
    for (int s = 0; s < kS; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), consumer_warps);
    }
  }
  __device__ __forceinline__ void wait_full(int i) const {
    hopper::mbar_wait(full(i % kS), (i / kS) & 1);
  }
  __device__ __forceinline__ void wait_empty(int i) const {
    hopper::mbar_wait(empty(i % kS), ((i / kS) & 1) ^ 1);
  }
  // A consumer warp's lane 0: iteration i's stage may be refilled.
  __device__ __forceinline__ void release(int i) const { hopper::mbar_arrive(empty(i % kS)); }
  // The producer's thread: iterations first .. n_iter - 1, each started by
  // load(i) once its stage is free (the prologue started the ones before).
  template <class Load>
  __device__ __forceinline__ void produce(int first, int n_iter, Load&& load) const {
#pragma unroll 1
    for (int i = first; i < n_iter; ++i) {
      wait_empty(i);
      load(i);
    }
  }
  // A consumer warpgroup's pass over iterations i0 .. i0 + n - 1 (n >= 1) of a
  // ring of kStage-byte stages from `base`: once a stage's copies landed,
  // products(stage address, first) issues its wgmma (first: the pass's first
  // chunk, which starts the accumulators), committed as one group; the
  // previous stage is released once its group is done, the last once all are.
  template <int kStage, class Products>
  __device__ __forceinline__ void consume(uint32_t base, int i0, int n, int lane,
                                          Products&& products) const {
#pragma unroll 1
    for (int c = 0; c < n; ++c) {
      const int i = i0 + c;
      wait_full(i);
      hopper::wgmma_fence();
      products(base + (i % kS) * kStage, c == 0);
      hopper::wgmma_commit();
      if (c > 0) {
        hopper::wgmma_wait<1>();
        if (lane == 0) release(i - 1);
      }
    }
    hopper::wgmma_wait<0>();
    if (lane == 0) release(i0 + n - 1);
  }
};

// The block's dynamic shared memory from its first 1024-byte boundary, the
// alignment the 128-byte swizzle patterns need.
__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// Shared memory: the ring (per stage A, B, and with kDgIn dy's chunk and
// W2's tile, each 1024-aligned), then the forward's staging (2 x 64 x 256
// bf16), the backward's dg tile (without kDgIn: 128 x 128 bf16 as two
// 64-column blocks) and column-sum buffer (8 warps x 128 fp32), the row
// statistics (kLn: 128 float2) and gamma and beta (kLn: 2 x D fp32), the
// mbarriers, and 1 KB to align the base.
template <class P>
struct Layout {
  static constexpr int kS = P::kStages;
  static constexpr int kA = 0;
  static constexpr int kB = kATile;
  static constexpr int kBBytes = P::kDl ? kNTile : P::kN * 128;
  static constexpr int kA2 = kB + kBBytes;
  static constexpr int kB2 = kA2 + kATile;
  static constexpr int kStage = P::kDgIn ? kB2 + kNTile : kA2;
  static constexpr int kStaging = kS * kStage;
  static constexpr int kDg = kStaging + (P::kFwd ? 2 * 64 * 256 * 2 : 0);
  static constexpr int kRed = kDg + (P::kBwd && !P::kDgIn ? kRows * 128 * 2 : 0);
  static constexpr int kStats = kRed + (P::kBwd ? 8 * 128 * 4 : 0);
  static constexpr int kGamma = kStats + (P::kLn ? kRows * 8 : 0);  // kLn: gamma, beta fp32
  static constexpr int kBars = kGamma + (P::kLn ? 2 * P::D * 4 : 0);
  // full and empty per stage, then dg_full and dg_empty.
  static constexpr int kSmem = kBars + 8 * (2 * kS + 2) + 1024;
  static_assert(kStage % 1024 == 0 && kStaging % 1024 == 0 && kDg % 1024 == 0,
                "each tile 1024-aligned");
  static_assert(kSmem <= kMaxSmem, "the ring and the epilogue's buffers must fit a block");
  static __device__ __forceinline__ Ring<kS> ring(uint32_t base) { return {base + kBars}; }
  static __device__ __forceinline__ uint32_t dg_full(uint32_t base) {
    return base + kBars + 8 * 2 * kS;
  }
  static __device__ __forceinline__ uint32_t dg_empty(uint32_t base) {
    return base + kBars + 8 * (2 * kS + 1);
  }
};

// setmaxnreg's split: the producer warpgroup's registers a thread and each
// consumer thread's (128 accumulators, the LayerNorm pass, the epilogue).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// A: (M, K) bf16, 64 x 128 boxes (x; dh for dl). B: W1 (F, D) K-major in
// kN-row boxes, or (dl) W1 as the N-major (K = F, N = D) tile in 64 x 64
// boxes. a2, b2 (kDgIn): dy (M, D) and W2 (D, F) as the N-major (K = D, N =
// F) tile. dg (backward without kDgIn): (M, F) in 64 x 128 boxes.
struct Maps {
  CUtensorMap a, b, a2, b2, dg;
};

struct Args {
  const bf16* x;       // kLn: the rows the statistics read, (M, D)
  const float* b1;     // (F,) fp32
  const float* gamma;  // kLn: (D,) fp32
  const float* beta;
  const int* seeds;    // kDrop: (M / T,) int32
  bf16* g;             // the forward's output; the backward's with kEmitG: (M, F)
  bf16* dh;            // the backward: (M, F)
  bf16* ln_out;        // the backward with kLn: (M, D)
  float* db1_part;     // the backward: (ceil(M / 128), F)
  void* out;           // dl: (M, D) of Dl's OutT
  long long M;
  int K;               // the contraction: D, or F for dl
  int N;               // the output's columns: F, or D for dl
  int T;
  uint32_t threshold;
  float scale, eps;
  int tiles;           // column tiles a block takes in turn (the last block of a row fewer)
  int col_tiles;       // the output's column tiles
};

// The row statistics of rows m0 .. m0+127 into stats (mean, rstd), by the
// block's 12 warps two rows at a time, with ln_panel's arithmetic: a lane's
// lane vectors summed in order, the warp's butterfly, then the centred
// squares the same way.
template <int D>
__device__ __forceinline__ void row_stats(float2* stats, const bf16* __restrict__ x, long long m0,
                                          long long M, float eps) {
  constexpr int V = coral_row_vec<bf16>(D);
  constexpr int kVecs = D / (32 * V);
  static_assert(kVecs * 32 * V == D, "a lane owns whole vectors of the row");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 2
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long row = m0 + r;
    if (row >= M) break;  // uniform over the warp
    const bf16* xr = x + row * D;
    float v[kVecs * V];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) coral_loadv<V>(xr + (i * 32 + lane) * V, v + i * V);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs * V; ++j) s += v[j];
    const float mean = coral_warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs * V; ++j) {
      v[j] -= mean;
      q += v[j] * v[j];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / D + eps);
    if (lane == 0) stats[r] = make_float2(mean, rstd);
  }
}

// The copies of ring iteration i (tile i / n_k, chunk i % n_k) into stage i %
// kStages, completing on its `full` barrier; the backward without kDgIn
// also copies the tile's dg during its last chunk, once the previous
// tile's epilogue released the buffer.
template <class P>
__device__ __forceinline__ void load_stage(const Maps& m, uint32_t base, int i, int n_k,
                                           int m0, int c0) {
  using L = Layout<P>;
  const int s = i % P::kStages, tile = i / n_k, k = i - tile * n_k;
  const int n0 = (c0 + tile) * P::kN, k0 = k * kChunk;
  const uint32_t st = base + s * L::kStage;
  const uint32_t bar = L::ring(base).full(s);
  hopper::mbar_arrive_expect_tx(bar, L::kStage);
  hopper::tma_load_2d(st + L::kA, &m.a, bar, k0, m0);
  if constexpr (P::kDl) {
    hopper::tma_load_2d(st + L::kB, &m.b, bar, n0, k0);
    hopper::tma_load_2d(st + L::kB + kNTile / 2, &m.b, bar, n0 + 64, k0);
  } else {
    hopper::tma_load_2d(st + L::kB, &m.b, bar, k0, n0);
  }
  if constexpr (P::kDgIn) {
    hopper::tma_load_2d(st + L::kA2, &m.a2, bar, k0, m0);
    hopper::tma_load_2d(st + L::kB2, &m.b2, bar, n0, k0);
    hopper::tma_load_2d(st + L::kB2 + kNTile / 2, &m.b2, bar, n0 + 64, k0);
  }
  if constexpr (P::kBwd && !P::kDgIn) {
    if (k == n_k - 1) {
      hopper::mbar_wait(L::dg_empty(base), (tile & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(L::dg_full(base), kRows * 128 * 2);
      hopper::tma_load_2d(base + L::kDg, &m.dg, L::dg_full(base), n0, m0);
      hopper::tma_load_2d(base + L::kDg + kRows * 128, &m.dg, L::dg_full(base), n0 + 64, m0);
    }
  }
}

// The warpgroup's 64 rows (from row r0 of the tile) of the landed x chunk at
// `slot` (128 rows of 128 swizzled bytes), in place: bf16(((x - mean) rstd)
// gamma + beta), ln_panel's arithmetic; rows past M zero. Thread t of the
// warpgroup takes the 16-byte chunk t % 8 of rows r0 + t / 8, + 16, + 32,
// + 48; with emit_ln the rows go to ln_out too. The caller waits for the
// copy first, then fences the async proxy and meets its warpgroup.
template <class P>
__device__ __forceinline__ void normalise(const Args& a, uint32_t slot, const float2* stats,
                                          int r0, int t, int k0, long long m0, bool emit_ln,
                                          const float (&ga)[8], const float (&be)[8]) {
  const int c = t % 8;
  uint4 raw[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + t / 8 + 16 * m;
    raw[m] = hopper::ld_shared_v4(slot + r * 128 + hopper::swizzle_chunk(128, r, c) * 16);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + t / 8 + 16 * m;
    const long long row = m0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row < a.M) {
      const float2 st = stats[r];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[m]);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 v = __bfloat1622float2(h[e]);
        v.x -= st.x;
        v.y -= st.x;
        o[e] = __floats2bfloat162_rn((v.x * st.y) * ga[2 * e] + be[2 * e],
                                     (v.y * st.y) * ga[2 * e + 1] + be[2 * e + 1]);
      }
      if (emit_ln) *reinterpret_cast<uint4*>(a.ln_out + row * P::D + k0 + 8 * c) = out;
    }
    hopper::st_shared_v4(slot + r * 128 + hopper::swizzle_chunk(128, r, c) * 16, out);
  }
}

// The producer warpgroup: lane 0 of warp 0 starts the copies from ring
// iteration kStages on (the prologue started the first); the other threads
// have nothing to do.
template <class P>
__device__ __forceinline__ void produce(const Maps& m, uint32_t base, int n_k, int m0, int c0,
                                        int tiles) {
  using L = Layout<P>;
  hopper::reg_dealloc<kProducerRegs>();
  if (threadIdx.x != 0) return;
  L::ring(base).produce(P::kStages, tiles * n_k,
                        [&](int i) { load_stage<P>(m, base, i, n_k, m0, c0); });
}

// The keep flags of columns 2 q and 2 q + 1 of an 8-column group whose
// Philox counter is p0 = column / 4, for this thread's rows r0 (k0) and r0 +
// 8 (k1): the thread makes one call, for row r0 if q is even, else r0 + 8
// (`mine`: its t and seed), and swaps half of the words with lane ^ 1.
__device__ __forceinline__ void keep_pairs(uint32_t p0, int quad, uint32_t t_mine,
                                           uint32_t seed_mine, uint32_t threshold, bool (&k0)[2],
                                           bool (&k1)[2]) {
  const bool odd = quad & 1;
  const uint4 w = coral_philox(p0 + (uint32_t)(quad >> 1), t_mine, seed_mine);
  const uint32_t send_a = odd ? w.x : w.z, send_b = odd ? w.y : w.w;
  const uint32_t own_a = odd ? w.z : w.x, own_b = odd ? w.w : w.y;
  const uint32_t recv_a = __shfl_xor_sync(0xffffffffu, send_a, 1);
  const uint32_t recv_b = __shfl_xor_sync(0xffffffffu, send_b, 1);
  k0[0] = (odd ? recv_a : own_a) >= threshold;
  k0[1] = (odd ? recv_b : own_b) >= threshold;
  k1[0] = (odd ? own_a : recv_a) >= threshold;
  k1[1] = (odd ? own_b : recv_b) >= threshold;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// A consumer thread's place: warpgroup wg (rows 64 wg ..), its rows `row`
// and row + 8 of them, columns 8 j + 2 quad + {0, 1} of each accumulator.
struct Lane {
  int wg, t, warp, lane, row, quad;
  __device__ Lane() {
    wg = threadIdx.x / 128 - 1;
    t = threadIdx.x % 128;
    warp = t / 32;
    lane = t % 32;
    row = 16 * warp + lane / 4;
    quad = lane % 4;
  }
};

// g of the 128 columns 128 H .. of the forward's tile at column n0 from acc
// (h - b1), into the warpgroup's staging buffer at stg (64 rows of 512
// bytes, 16-byte chunk c of row r at c ^ (r % 8): conflict-free both ways).
// Columns at or past N (the last tile's second half where N is an odd
// multiple of 128) are neither read from b1 nor staged.
template <class P, int H>
__device__ __forceinline__ void stage_half(const Args& a, const Lane& ln, uint32_t stg,
                                           const float (&acc)[64], int n0, uint32_t t_mine,
                                           uint32_t seed_mine) {
  if (n0 + 128 * H >= a.N) return;  // uniform over the block
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int jj = 16 * H + j;  // the 8-column group of the tile
    const float2 bb = *reinterpret_cast<const float2*>(a.b1 + n0 + 8 * jj + 2 * ln.quad);
    float v[4] = {acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y, acc[4 * j + 2] + bb.x,
                  acc[4 * j + 3] + bb.y};
    if constexpr (P::kGelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = coral_gelu(v[e]);
    }
    if constexpr (P::kDrop) {
      bool k0[2], k1[2];
      keep_pairs((uint32_t)(n0 + 8 * jj) >> 2, ln.quad, t_mine, seed_mine, a.threshold, k0, k1);
      v[0] = k0[0] ? v[0] * a.scale : 0.f;
      v[1] = k0[1] ? v[1] * a.scale : 0.f;
      v[2] = k1[0] ? v[2] * a.scale : 0.f;
      v[3] = k1[1] ? v[3] * a.scale : 0.f;
    }
    const uint32_t chunk = (uint32_t)(jj ^ (ln.row & 7)) * 16 + 4 * ln.quad;
    hopper::st_shared_b32(stg + ln.row * 512 + chunk, pack_bf16(v[0], v[1]));
    hopper::st_shared_b32(stg + (ln.row + 8) * 512 + chunk, pack_bf16(v[2], v[3]));
  }
}

// The forward's epilogue of the tile at column n0: g staged (stage_half),
// then stored 16 bytes a thread, a 512-byte row of g a warp, rows below M
// and columns below N.
template <class P>
__device__ __forceinline__ void epilogue_fwd(const Args& a, const Lane& ln, uint32_t stg,
                                             const float (&acc0)[64], const float (&acc1)[64],
                                             int n0, long long r0, uint32_t t_mine,
                                             uint32_t seed_mine) {
  hopper::named_barrier(1 + ln.wg, 128);  // the previous tile's stores have read stg
  stage_half<P, 0>(a, ln, stg, acc0, n0, t_mine, seed_mine);
  stage_half<P, 1>(a, ln, stg, acc1, n0, t_mine, seed_mine);
  hopper::named_barrier(1 + ln.wg, 128);
  const long long wrow0 = r0 - ln.row;  // the warpgroup's first row
  const bool in_cols = 8 * ln.lane < a.N - n0;
#pragma unroll 4
  for (int r = ln.warp; r < 64; r += 4) {
    if (wrow0 + r >= a.M) break;  // uniform over the warp
    const uint4 v = hopper::ld_shared_v4(stg + r * 512 + ((ln.lane ^ (r & 7)) * 16));
    if (in_cols) *reinterpret_cast<uint4*>(a.g + (wrow0 + r) * a.N + n0 + 8 * ln.lane) = v;
  }
}

// The backward's epilogue of the tile at column n0 (128 columns): h from
// hacc, dg from gacc (kDgIn) or the tile's dg in shared memory, then g, dh
// and the db1 partial.
template <class P, int kG>
__device__ __forceinline__ void epilogue_bwd(const Args& a, const Lane& ln, uint32_t base,
                                             float* red, const float (&hacc)[64],
                                             const float (&gacc)[kG], int n0, long long r0,
                                             uint32_t t_mine, uint32_t seed_mine) {
  using L = Layout<P>;
  const long long r1 = r0 + 8;
  const bool in0 = r0 < a.M, in1 = r1 < a.M;
  const int lrow = 64 * ln.wg + ln.row;  // the row in the block's tile
  float* mine = red + 128 * (4 * ln.wg + ln.warp);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * ln.quad;
    const float2 bb = *reinterpret_cast<const float2*>(a.b1 + n0 + col);
    const float h[4] = {hacc[4 * j] + bb.x, hacc[4 * j + 1] + bb.y, hacc[4 * j + 2] + bb.x,
                        hacc[4 * j + 3] + bb.y};
    float dg[4];
    if constexpr (P::kDgIn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[e] = gacc[4 * j + e];
    } else {
      // Element (r, col) of the 128B-swizzled tile: column block col / 64.
      const uint32_t blk = base + L::kDg + (col / 64) * (kRows * 128);
      const uint32_t off = (uint32_t)(((col % 64) / 8) ^ (lrow & 7)) * 16 + 4 * ln.quad;
      uint32_t w0, w1;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w0) : "r"(blk + lrow * 128 + off));
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w1) : "r"(blk + (lrow + 8) * 128 + off));
      const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w0));
      const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w1));
      dg[0] = f0.x, dg[1] = f0.y, dg[2] = f1.x, dg[3] = f1.y;
    }
    bool keep[4] = {true, true, true, true};
    if constexpr (P::kDrop) {
      bool k0[2], k1[2];
      keep_pairs((uint32_t)(n0 + 8 * j) >> 2, ln.quad, t_mine, seed_mine, a.threshold, k0, k1);
      keep[0] = k0[0], keep[1] = k0[1], keep[2] = k1[0], keep[3] = k1[1];
    }
    float gv[4], dv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (P::kDrop) {
        gv[e] = keep[e] ? coral_gelu(h[e]) * a.scale : 0.f;
        dv[e] = keep[e] ? dg[e] * a.scale * coral_dgelu(h[e]) : 0.f;
      } else {
        gv[e] = coral_gelu(h[e]);
        dv[e] = dg[e] * coral_dgelu(h[e]);
      }
    }
    if (in0) {
      if constexpr (P::kEmitG)
        *reinterpret_cast<uint32_t*>(a.g + r0 * a.N + n0 + col) = pack_bf16(gv[0], gv[1]);
      *reinterpret_cast<uint32_t*>(a.dh + r0 * a.N + n0 + col) = pack_bf16(dv[0], dv[1]);
    }
    if (in1) {
      if constexpr (P::kEmitG)
        *reinterpret_cast<uint32_t*>(a.g + r1 * a.N + n0 + col) = pack_bf16(gv[2], gv[3]);
      *reinterpret_cast<uint32_t*>(a.dh + r1 * a.N + n0 + col) = pack_bf16(dv[2], dv[3]);
    }
    // The column sums: the thread's two rows, then the warp's 16.
    float s0 = (in0 ? dv[0] : 0.f) + (in1 ? dv[2] : 0.f);
    float s1 = (in0 ? dv[1] : 0.f) + (in1 ? dv[3] : 0.f);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (ln.lane < 4) {
      mine[col] = s0;
      mine[col + 1] = s1;
    }
  }
  if constexpr (!P::kDgIn)
    if (ln.lane == 0) hopper::mbar_arrive(L::dg_empty(base));
  // The 8 warps' sums in order: warpgroup 0's warps, then warpgroup 1's.
  hopper::named_barrier(3, 256);
  if (ln.wg == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[128 * w + ln.t];
    a.db1_part[(long long)blockIdx.x * a.N + n0 + ln.t] = s;
  }
  hopper::named_barrier(4, 256);  // red is read before the next tile writes it
}

// dl's epilogue: out rows r0 and r0 + 8 below M, columns n0 + 8 j + 2 quad.
template <class P>
__device__ __forceinline__ void epilogue_dl(const Args& a, const Lane& ln,
                                            const float (&acc)[64], int n0, long long r0) {
  using OutT = typename P::OutT;
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long r = r0 + 8 * half;
    if (r >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float lo = acc[4 * j + 2 * half], hi = acc[4 * j + 2 * half + 1];
      OutT* p = out + r * a.N + n0 + 8 * j + 2 * ln.quad;
      if constexpr (std::is_same<OutT, bf16>::value)
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
      else
        *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
    }
  }
}

// A consumer warpgroup: for each of the block's `tiles` column tiles, its 64
// rows' products over every chunk, then the tile's epilogue.
template <class P>
__device__ __forceinline__ void consume(const Args& a, unsigned char* smem, uint32_t base,
                                        int n_k, long long m0, int c0, int tiles) {
  using L = Layout<P>;
  constexpr int kS = P::kStages;
  constexpr int kAcc1 = P::kFwd || P::kDgIn ? 64 : 1;
  hopper::reg_alloc<kConsumerRegs>();
  const Lane ln;
  const long long r0 = m0 + 64 * ln.wg + ln.row;
  // The dropout mask's row of this thread's Philox calls (keep_pairs).
  uint32_t t_mine = 0u, seed_mine = 0u;
  if constexpr (P::kDrop) {
    const long long mine = r0 + ((ln.quad & 1) ? 8 : 0);
    if (mine < a.M) {
      t_mine = (uint32_t)(mine % a.T);
      seed_mine = (uint32_t)a.seeds[mine / a.T];
    }
  }
  const uint32_t a_rows = L::kA + ln.wg * 64 * 128;  // the warpgroup's rows of A
  const Ring<kS> ring = L::ring(base);
  const float2* stats = reinterpret_cast<const float2*>(smem + L::kStats);
  // kLn: waits for ring iteration j's copy and normalises the warpgroup's
  // rows of its x chunk (k0 its first column, emit: column tile 0).
  const float* gamma = reinterpret_cast<const float*>(smem + L::kGamma);
  auto ln_pass = [&](int j, int k0, bool emit) {
    float ga[8], be[8];
    coral_loadv<8>(gamma + k0 + 8 * (ln.t % 8), ga);
    coral_loadv<8>(gamma + P::D + k0 + 8 * (ln.t % 8), be);
    ring.wait_full(j);
    normalise<P>(a, base + (j % kS) * L::kStage + L::kA, stats, 64 * ln.wg, ln.t, k0, m0, emit,
                 ga, be);
    hopper::fence_proxy_async();
  };
#pragma unroll 1
  for (int tile = 0; tile < tiles; ++tile) {
    const int n0 = (c0 + tile) * P::kN;
    const bool emit = P::kBwd && c0 + tile == 0;  // the backward's ln_out, once
    float acc0[64], acc1[kAcc1];
    if constexpr (P::kLn) {
      ln_pass(tile * n_k, 0, emit);
      hopper::named_barrier(1 + ln.wg, 128);
    }
#pragma unroll 1
    for (int k = 0; k < n_k; ++k) {
      const int i = tile * n_k + k, s = i % kS;
      if constexpr (!P::kLn) ring.wait_full(i);
      const uint32_t st = base + s * L::kStage;
      hopper::fence_regs(acc0);
      if constexpr (kAcc1 > 1) hopper::fence_regs(acc1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int keep_d = (k | kk) != 0;
        const uint64_t da = hopper::smem_desc(st + a_rows + 32 * kk, 1024, 128);
        if constexpr (P::kDl) {
          hopper::wgmma_m64n128k16_ss_tb(
              acc0, da, hopper::smem_desc(st + L::kB + 2048 * kk, 1024, 128, kNTile / 2),
              keep_d);
        } else {
          hopper::wgmma_m64n128k16_ss(acc0, da, hopper::smem_desc(st + L::kB + 32 * kk, 1024, 128),
                                      keep_d);
          if constexpr (P::kFwd)
            hopper::wgmma_m64n128k16_ss(
                acc1, da, hopper::smem_desc(st + L::kB + 128 * 128 + 32 * kk, 1024, 128), keep_d);
          if constexpr (P::kDgIn)
            hopper::wgmma_m64n128k16_ss_tb(
                acc1, hopper::smem_desc(st + L::kA2 + ln.wg * 64 * 128 + 32 * kk, 1024, 128),
                hopper::smem_desc(st + L::kB2 + 2048 * kk, 1024, 128, kNTile / 2), keep_d);
        }
      }
      hopper::wgmma_commit();
      if (k > 0) {
        hopper::wgmma_wait<1>();  // the previous chunk's products are done with its stage
        if (ln.lane == 0) ring.release(i - 1);
      }
      // The next chunk's LayerNorm pass while this chunk's products run; after
      // the release above, so the producer's copies keep the ring full.
      if constexpr (P::kLn) {
        if (k + 1 < n_k) {
          ln_pass(i + 1, (k + 1) * kChunk, emit);
          hopper::named_barrier(1 + ln.wg, 128);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc0);
    if constexpr (kAcc1 > 1) hopper::fence_regs(acc1);
    if (ln.lane == 0) ring.release(tile * n_k + n_k - 1);
    if constexpr (P::kFwd) {
      epilogue_fwd<P>(a, ln, base + L::kStaging + ln.wg * (64 * 512), acc0, acc1, n0, r0,
                      t_mine, seed_mine);
    } else if constexpr (P::kBwd) {
      if constexpr (!P::kDgIn) hopper::mbar_wait(L::dg_full(base), tile & 1);
      epilogue_bwd<P>(a, ln, base, reinterpret_cast<float*>(smem + L::kRed), acc0, acc1, n0,
                      r0, t_mine, seed_mine);
    } else {
      epilogue_dl<P>(a, ln, acc0, n0, r0);
    }
  }
}

// The mainloop of a kernel over (ceil(M / 128), column tiles / tiles)
// blocks of kThreads threads with Layout<P>::kSmem bytes of dynamic shared
// memory.
template <class P>
__device__ __forceinline__ void mainloop(const Maps& m, const Args& a) {
  using L = Layout<P>;
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <=
                    kThreads * (65536 / kThreads / 8 * 8),
                "setmaxnreg's split exceeds the block's registers");
  unsigned char* smem = aligned_smem();
  const uint32_t base = hopper::smem_u32(smem);
  const int n_k = a.K / kChunk;
  const int m0 = blockIdx.x * kRows, c0 = blockIdx.y * a.tiles;
  const int tiles = min(a.tiles, a.col_tiles - c0);
  if (threadIdx.x == 0) {
    L::ring(base).init(8);  // the consumers' warps free a stage
    hopper::mbar_init(L::dg_full(base), 1);
    hopper::mbar_init(L::dg_empty(base), 8);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::prefetch_tensormap(&m.b);
    const int n_first = tiles * n_k < P::kStages ? tiles * n_k : P::kStages;
    for (int i = 0; i < n_first; ++i) load_stage<P>(m, base, i, n_k, m0, c0);
  }
  if constexpr (P::kLn) {
    // The row statistics while the first chunks are in flight, and gamma and
    // beta staged for every chunk's pass (a global load there was exposed).
    float* gb = reinterpret_cast<float*>(smem + L::kGamma);
    for (int i = threadIdx.x; i < P::D / 4; i += kThreads) {
      reinterpret_cast<float4*>(gb)[i] = reinterpret_cast<const float4*>(a.gamma)[i];
      reinterpret_cast<float4*>(gb + P::D)[i] = reinterpret_cast<const float4*>(a.beta)[i];
    }
    row_stats<P::D>(reinterpret_cast<float2*>(smem + L::kStats), a.x, m0, a.M, a.eps);
    __syncthreads();
  }
  if (threadIdx.x < 128)
    produce<P>(m, base, n_k, m0, c0, tiles);
  else
    consume<P>(a, smem, base, n_k, m0, c0, tiles);
}

}  // namespace gemm

template <class P>
__global__ void __launch_bounds__(gemm::kThreads, 1)
    ffn_fwd_kernel(const __grid_constant__ gemm::Maps maps, const gemm::Args args) {
  gemm::mainloop<P>(maps, args);
}

template <class P>
__global__ void __launch_bounds__(gemm::kThreads, 1)
    ffn_bwd_kernel(const __grid_constant__ gemm::Maps maps, const gemm::Args args) {
  gemm::mainloop<P>(maps, args);
}

template <class P>
__global__ void __launch_bounds__(gemm::kThreads, 1)
    dl_kernel(const __grid_constant__ gemm::Maps maps, const gemm::Args args) {
  gemm::mainloop<P>(maps, args);
}

namespace gemm {

// --- host ---------------------------------------------------------------------------

// The maps of the last kCached weights seen, replaced in turn: a map depends
// on nothing but the pointer, the shape and the box, so a kept one is never
// stale, and a layer's weights are read by every call of a step.
constexpr int kCached = 64;

inline int weight_map(CUtensorMap* out, const void* w, long long inner, long long outer,
                      int box_rows) {
  struct Entry {
    const void* w;
    long long inner, outer;
    int box_rows;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[kCached];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.w == w && e.inner == inner && e.outer == outer && e.box_rows == box_rows) {
      *out = e.map;
      return 0;
    }
  }
  Entry& e = cache[next];
  const int err = hopper::encode_2d(&e.map, w, inner, outer, box_rows);
  if (err != 0) {
    e.w = nullptr;  // never matched
    return err;
  }
  e.w = w, e.inner = inner, e.outer = outer, e.box_rows = box_rows;
  next = (next + 1) % kCached;
  if (used < kCached) ++used;
  *out = e.map;
  return 0;
}

// The current card's SMs, found once per process (the port drives one card).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || v <= 0)
      return 132;
    return v;
  }();
  return n;
}

// The column tiles a block takes (1, 2, 4 or 8, dividing col_tiles; with
// any_count any of 1 .. 8, a row's last block taking the rest): the fewest
// block-waves (one block an SM) times a block's work, a tile each plus a
// quarter of one for the row statistics and the ring's fill.
inline int tiles_per_block(long long row_tiles, int col_tiles, bool any_count = false) {
  const long long sms = sm_count();
  int best = 1;
  double best_cost = -1.0;
  for (int n = 1; n <= 8; n += any_count ? 1 : n) {
    if (!any_count && col_tiles % n != 0) continue;
    const long long groups = (col_tiles + n - 1) / n;
    const long long waves = (row_tiles * groups + sms - 1) / sms;
    const double cost = (double)waves * (n + 0.25);
    if (best_cost < 0.0 || cost < best_cost) best = n, best_cost = cost;
  }
  return best;
}

// Launches kKernel (a kernel over this mainloop with policy P) on `s` over M
// rows and col_tiles column tiles (any_count: as tiles_per_block); the
// cudaError_t.
template <class P, auto kKernel>
int launch(const Maps& maps, Args a, int col_tiles, cudaStream_t s, bool any_count = false) {
  // Once per instantiation and process, off every later call's path.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<P>::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const long long row_tiles = (a.M + kRows - 1) / kRows;
  a.tiles = tiles_per_block(row_tiles, col_tiles, any_count);
  a.col_tiles = col_tiles;
  const dim3 grid((unsigned)row_tiles, (unsigned)((col_tiles + a.tiles - 1) / a.tiles));
  kKernel<<<grid, kThreads, Layout<P>::kSmem, s>>>(maps, a);
  return (int)cudaGetLastError();
}

// The forward at width D (kLn: a built width; without it D is 0 and the
// width K a runtime value): g (M, F) = dropout(gelu(A W1^T + b1)), dropout
// where seeds are given; without kGelu y (M, F) = A W1^T + b1 (seeds null).
// F is a multiple of 128: where it is not one of 256 (5760, the packed QKV
// projection at D 1920) the last column tile's second half lies past F, its
// W1 rows TMA's zeros, and nothing of it is stored.
template <int D, bool kLn, bool kGelu = true>
int launch_fwd(const bf16* x, const bf16* w1, const float* b1, const float* gamma,
               const float* beta, const int* seeds, bf16* g, long long M, int K, int F, int T,
               uint32_t threshold, float scale, float eps, cudaStream_t s) {
  Maps maps;
  int err = hopper::encode_2d(&maps.a, x, K, M, kRows);
  if (err == 0) err = weight_map(&maps.b, w1, K, F, 256);
  if (err != 0) return err;
  Args a{};
  a.x = x, a.b1 = b1, a.gamma = gamma, a.beta = beta, a.seeds = seeds, a.g = g;
  a.M = M, a.K = K, a.N = F, a.T = T, a.threshold = threshold, a.scale = scale, a.eps = eps;
  const int col_tiles = (F + 255) / 256;
  if constexpr (kGelu) {
    if (seeds != nullptr)
      return launch<Fwd<D, kLn, true>, ffn_fwd_kernel<Fwd<D, kLn, true>>>(maps, a, col_tiles, s);
  }
  // The bias-only forward (F = 3 D: 12 and 23 column tiles at D 1024 and
  // 1920, where no power of two divides the count usefully) takes any count.
  using Keep = Fwd<D, kLn, false, kGelu>;
  return launch<Keep, ffn_fwd_kernel<Keep>>(maps, a, col_tiles, s, !kGelu);
}

// out (M, N) = dh (M, K) W1 (K, N), in fp32 or bf16.
template <typename OutT>
int launch_dl(const bf16* dh, const bf16* w1, OutT* out, long long M, int N, int K,
              cudaStream_t s) {
  Maps maps;
  int err = hopper::encode_2d(&maps.a, dh, K, M, kRows);
  if (err == 0) err = weight_map(&maps.b, w1, N, K, 64);
  if (err != 0) return err;
  Args a{};
  a.out = out, a.M = M, a.K = K, a.N = N;
  return launch<Dl<OutT>, dl_kernel<Dl<OutT>>>(maps, a, N / 128, s);
}

// The backward's first kernel at width D (as launch_fwd), then out = dh W1.
// dy: (M, D) with kDgIn, else dg (M, F); w2 (D, F) with kDgIn.
template <int D, bool kLn, bool kDgIn, bool kEmitG, typename OutT>
int launch_bwd(const bf16* x, const bf16* w1, const float* b1, const float* gamma,
               const float* beta, const bf16* dy, const bf16* w2, const int* seeds, bf16* g,
               bf16* dh, bf16* ln_out, float* db1_part, OutT* out, long long M, int K, int F,
               int T, uint32_t threshold, float scale, float eps, cudaStream_t s) {
  Maps maps;
  int err = hopper::encode_2d(&maps.a, x, K, M, kRows);
  if (err == 0) err = weight_map(&maps.b, w1, K, F, 128);
  if (kDgIn) {
    if (err == 0) err = hopper::encode_2d(&maps.a2, dy, K, M, kRows);
    if (err == 0) err = weight_map(&maps.b2, w2, F, K, 64);
  } else {
    if (err == 0) err = hopper::encode_2d(&maps.dg, dy, F, M, kRows);
  }
  if (err != 0) return err;
  Args a{};
  a.x = x, a.b1 = b1, a.gamma = gamma, a.beta = beta, a.seeds = seeds, a.g = g, a.dh = dh;
  a.ln_out = ln_out, a.db1_part = db1_part;
  a.M = M, a.K = K, a.N = F, a.T = T, a.threshold = threshold, a.scale = scale, a.eps = eps;
  using Drop = Bwd<D, kLn, true, kDgIn, kEmitG>;
  using Keep = Bwd<D, kLn, false, kDgIn, kEmitG>;
  err = seeds != nullptr ? launch<Drop, ffn_bwd_kernel<Drop>>(maps, a, F / 128, s)
                         : launch<Keep, ffn_bwd_kernel<Keep>>(maps, a, F / 128, s);
  if (err != 0) return err;
  return launch_dl<OutT>(dh, w1, out, M, K, F, s);
}

// --- A^T B over rows ------------------------------------------------------------------
//
// out (M x N) = the sum over rows of A^T B, for A (rows x M) and B (rows x N)
// row-major bf16: a weight gradient, whose reduction runs over every row of a
// batch (K3's dW_j = da^T x_j, csrc/conv_ln_gelu.cu; N6's dW1 = dh^T ln_out
// and dW2 = dy^T g, csrc/ffn_ln_g.cu). A block takes one kMT x kNT tile of
// out (128 x 128, or 256 x 128 and 128 x 256 where one side of the product
// is F) over one range of 64-row chunks and writes it as an fp32 partial;
// the caller sums the ranges' partials in a fixed order, so two calls give
// the same bits (no atomics). A stage holds a chunk's 64 rows of the tile's
// 64-column blocks of A, then of B, as 64 x 64 TMA boxes (128-byte swizzled,
// rows past the data zero); both operands enter wgmma M- and N-major (both
// transpose bits), each consumer warpgroup kMT / 2 of the M rows, as kMT /
// 128 x kNT / 128 products m64n128k16 a k-step (a wider tile re-reads its
// narrow side's operand from L2 half as often).
namespace atb {

constexpr int kBox = 64 * 128;  // 64 rows of one 64-column block: 8 KB

template <int kMT, int kNT>
struct Shape {
  static constexpr int kABoxes = kMT / 64, kBBoxes = kNT / 64;
  static constexpr int kStage = (kABoxes + kBBoxes) * kBox;  // A's boxes, then B's
  static constexpr int kStages = 4;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert(kMT % 128 == 0 && kNT % 128 == 0 && kMT * kNT <= 256 * 128,
                "128 x 128, 256 x 128 or 128 x 256: 128 accumulators a thread at most");
  static_assert(kSmem <= kMaxSmem, "the ring must fit a block");
};
constexpr int kSmem = Shape<128, 128>::kSmem;  // K3's dW tile

// The block's tile: load(i, stage, bar) issues chunk i's boxes (A's kMT / 64
// at stage + a kBox, B's kNT / 64 after them) completing on `bar`; the tile's
// fp32 sum over chunks 0 .. n_chunks - 1 (zero for none) is stored to out
// (rows ld_out floats apart) from row m0 and column n0. A kernel of kThreads
// threads with Shape<kMT, kNT>::kSmem bytes of dynamic shared memory.
template <int kMT = 128, int kNT = 128, class Load>
__device__ __forceinline__ void tile(Load&& load, int n_chunks, float* out, long long ld_out,
                                     int m0, int n0) {
  using S = Shape<kMT, kNT>;
  constexpr int kI = kMT / 128, kJ = kNT / 128;  // a warpgroup's m64 blocks, the n128 blocks
  const uint32_t base = hopper::smem_u32(aligned_smem());
  const Ring<S::kStages> ring{base + S::kBars};
  auto start = [&](int i) {
    const uint32_t bar = ring.full(i % S::kStages);
    hopper::mbar_arrive_expect_tx(bar, S::kStage);
    load(i, base + (i % S::kStages) * S::kStage, bar);
  };
  if (threadIdx.x == 0) {
    ring.init(8);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    for (int i = 0; i < n_chunks && i < S::kStages; ++i) start(i);
    ring.produce(S::kStages, n_chunks, start);
    return;
  }
  hopper::reg_alloc<kConsumerRegs>();
  const Lane ln;
  float acc[kI * kJ][64];
#pragma unroll
  for (int b = 0; b < kI * kJ; ++b)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[b][e] = 0.f;
  if (n_chunks > 0)
    ring.template consume<S::kStage>(base, 0, n_chunks, ln.lane, [&](uint32_t st, bool first) {
#pragma unroll
      for (int b = 0; b < kI * kJ; ++b) hopper::fence_regs(acc[b]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          const uint64_t da =
              hopper::smem_desc(st + (ln.wg * kI + i) * kBox + 2048 * kk, 1024, 128, kBox);
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            hopper::wgmma_m64n128k16_ss_tt(
                acc[i * kJ + j], da,
                hopper::smem_desc(st + (S::kABoxes + 2 * j) * kBox + 2048 * kk, 1024, 128, kBox),
                !first || kk > 0);
        }
    });
#pragma unroll
  for (int b = 0; b < kI * kJ; ++b) hopper::fence_regs(acc[b]);
#pragma unroll
  for (int i = 0; i < kI; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = out + (long long)(m0 + 64 * (ln.wg * kI + i) + ln.row + 8 * h) * ld_out +
                     n0 + 128 * j;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          *reinterpret_cast<float2*>(row + 8 * e + 2 * ln.quad) =
              make_float2(acc[i * kJ + j][4 * e + 2 * h], acc[i * kJ + j][4 * e + 2 * h + 1]);
      }
}

}  // namespace atb

}  // namespace gemm

}  // namespace
