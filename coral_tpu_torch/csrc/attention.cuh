// The attention's Hopper mainloops (TMA copies into mbarrier rings, wgmma,
// setmaxnreg), each a set of pieces that thin kernels instantiate with a
// policy:
// - the forward mainloop (namespace fwd), of every forward of `attention.cu`
//   (K4 and its variants; v1 as its two-sweep policy) and of
//   `flash_attention.cu` (K7, with and without segment ids);
// - the backward mainloop (namespace bwd), a dq and a dkv kernel, of
//   `flash_attention.cu` (K7's backward), `attention.cu` (K4's, the v3
//   backward with and without the q/k/v biases) and `attention_rows.cu` (the
//   K15 routes' backwards, whose dq kernel sweeps the keys twice).
//
// Layout: q, k, v are (B, T, H*d) with strides (stride_b, stride_t, 1), the
// same for all three; head h is the lane slice h*d .. h*d+d-1 of each row,
// read through the row strides by the tensor maps, so no (B, H, T, d) copy is
// made. Every kernel is a template over the head dim d, built for the
// repository's three: 64 (XLS-R-300M, Whisper), 80 (XLS-R-1B) and 120
// (XLS-R-2B). The tiles in shared memory hold a head as one or two swizzled
// column blocks (64 columns, then 16 at d = 80 or 64 at d = 120, whose
// columns 120..127 TMA fills with zeros: exact for every product), and
// nothing is stored past a head's d columns (the next head starts there).
// K4 and K15 add the q/k/v biases (where the kernel has them) and round to
// bf16 once a tile has landed, and multiply q by the bf16 scale and round
// again, in the JAX kernels' order (80**-0.5 and 120**-0.5 are not exact in
// bf16, so the order shows). Padded keys carry the caller's finite -1e30
// bias; keys past T get -inf and contribute exactly 0.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

// Calls f(std::integral_constant<int, D>{}) for a built head dim D (64, 80,
// 120); returns -1 for any other.
template <typename Fn>
int with_head_dim(int D, Fn&& f) {
  switch (D) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 120: return f(std::integral_constant<int, 120>{});
    default: return -1;
  }
}

// --- The forward mainloop (Hopper: TMA, mbarriers, wgmma) ---------------------------
//
// One mainloop for both forward families, `attention_fwd_kernel` (K4 and its
// variants, `attention.cu`) with `attention_fwd_v1_kernel` (v1, K4's
// two-sweep policy V1) and `flash_fwd_kernel` (K7 and K7 with segment ids,
// `flash_attention.cu`), each a thin kernel over it with its policy.
//
// Bound on the H100: the tensor cores and the exponentials. A head makes
// 4 T^2 DP flops and T^2 exponentials from 4 T d bf16 values; at T = 1499 and
// d = 120 that is about 1,500 flops a byte, far above the card's 295, and
// at d = 64 the T^2 exponentials (16 a clock per SM) take about as long as
// the products.
//
// Design: a block takes 64 x kWG query rows of one head of one batch row
// (kWG = 3 consumer warpgroups at d = 64, else 2) and has a
// producer warpgroup before its consumers. The producer's first warp issues
// TMA copies (Q once; K and V a 128-key tile at a time into a ring of
// kStages = 3 stages, each with a `full` and an `empty` mbarrier, so the
// copies of the next tiles run while the current one is multiplied) and
// stages each tile's key vector (the K4 key bias in log2 units, or the
// segment ids); with the q/k/v biases all four of its warps add bk and bv to
// each tile once it landed (below). Each consumer warpgroup takes 64 query
// rows: S = Q K^T by `wgmma` m64n128k16 from shared memory, the online
// softmax in registers (each row's 32 values a thread: the row max over the
// 4 lanes that share a row by two shuffles), and O += P V by `wgmma` with P
// as the register A operand: the accumulator layout of S, packed to bf16
// pairs, is the A fragment layout of the second product, so nothing of S, P
// or P V touches shared memory. Within a warpgroup the product P_i V_i runs
// while the softmax of tile i+1 is computed, and O is rescaled while S of
// the next tile is multiplied (FlashAttention-3's intra-warpgroup overlap);
// across warpgroups named barriers make them take turns to issue their
// products (its ping-pong), so one warpgroup's exponentials run beside
// another's products. `setmaxnreg` splits the registers (producer_regs,
// consumer_regs: 24 and 240 a thread, 56 and 224 with the bias pass, 32 and
// 160 with three consumers).
//
// Layout: the head's DP columns are one or two column blocks, each a
// swizzled tile (128 rows of K or V, 64 x kWG of Q): 64 columns in 128-byte
// rows, then kW1 more (0 at
// d = 64; 16 in 32-byte rows at d = 80, so its products run over 80 and not a
// padded 128; 64 at d = 120, whose columns 120..127 TMA fills with zeros).
// The tensor maps see q, k, v as the 4-D tensor (d, H, T, B) with the row
// strides of the (B, T, H*d) tensor, so views of one packed projection load
// as they lie, and rows past T arrive as zeros. o is stored from registers,
// only columns below d and rows below T: nothing is written past a head.
//
// Rounding, as the TPU kernels (see the top of this file): K4 adds bq, bk,
// bv and rounds to bf16 (a bf16x2 add, single-rounded, which equals the fp32
// add rounded once for two bf16 operands), q then times the bf16 scale
// rounded again; the scores get the key bias (the caller's -1e30 for padded
// keys, -inf past T), the exponentials rounded to bf16 for P V against the
// running max, the sum divided by l at the end, lse = max(m + log l, -1e25).
// K7 scales the fp32 scores by d**-0.5 and masks keys past Tk or of another
// segment with -inf; a row with no key of its segment yet uses m = 0. The
// exponentials are ex2.approx with log2 e folded into one FMA (K4 carries
// its scores and key bias in log2 units, K7 folds it into d**-0.5); the
// stats leave in natural units. Every instantiation of a family runs the
// same arithmetic in the same order, the stats and the biases aside.
//
// Two sweeps (V1, the TPU kernel `_fwd_kernel_stats`): p = e / l is rounded
// to bf16 after it is normalised, so P V needs the final m and l before its
// first product. The ring then runs 2 n_tiles iterations, its stages and
// phases continued from one sweep into the other. Sweep 1 copies K alone
// and runs the scores and the online softmax above (the same arithmetic in
// the same order, so its lse is K4's without biases bit for bit) with no P,
// P V or rescale; sweep 2 copies K and V and computes the scores again, e =
// exp2(s - m) against the final max, p = e r with r = 1 / l formed once a
// row, rounded to bf16 as P, and O += P V with no rescale, the products of
// tile i overlapping those of tile i - 1 as above; o is stored as O.
namespace fwd {

constexpr int kKeys = 128;        // keys of a K/V tile
constexpr int kStages = 3;        // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Consumer warpgroups of a block: three (192 query rows) at d = 64, as
// FlashAttention-3's d = 64 tile: more rows share each K/V tile (a third
// less of the L2 traffic and of the blocks' prologues) and a third
// warpgroup overlaps the exponentials with the products, in 160 registers a
// thread; two (128 rows) at 80 and 120, whose O needs more.
__host__ __device__ constexpr int consumers(int D) { return D == 64 ? 3 : 2; }

// setmaxnreg's split of a block's registers: the producer warpgroup's and
// each consumer thread's. Beside two consumers the bias pass loads 4 rows
// before it stores them (56 registers); beside three it has 32 and goes a
// row at a time.
__host__ __device__ constexpr int producer_regs(int wg, bool bias) {
  return wg == 3 ? 32 : bias ? 56 : 24;
}
__host__ __device__ constexpr int consumer_regs(int wg, bool bias) {
  return wg == 3 ? 160 : bias ? 224 : 240;
}
__host__ __device__ constexpr int pass_group(int wg) { return wg == 3 ? 1 : 4; }

// Shared-memory layout at head dim D with kWG consumers: Q (64 kWG rows),
// then kStages x (K, V) (128 rows each), each a 1024-aligned tile of two
// column blocks; the stages' key vectors; the mbarriers.
template <int D, int kWG>
struct Tile {
  static constexpr int kW1 = D == 64 ? 0 : D == 80 ? 16 : 64;
  static_assert(D == 64 || D == 80 || D == 120, "the head dims of the configs");
  static constexpr int kRows = 64 * kWG;         // query rows of a block
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr int kRB1 = kW1 * 2;           // row bytes of column block 1
  static constexpr int kQBlk0 = kRows * 128;     // Q's column blocks
  static constexpr int kQ = kQBlk0 + kRows * kRB1;
  static constexpr int kBlk0 = kKeys * 128;      // K's and V's
  static constexpr int kOperand = kBlk0 + kKeys * kRB1;
  static_assert(kQBlk0 % 1024 == 0 && kQ % 1024 == 0 && kOperand % 1024 == 0,
                "each tile 1024-aligned");
  static constexpr int kKvec = kQ + 2 * kStages * kOperand;
  static constexpr int kBars = kKvec + kStages * kKeys * 4;
  // Q's barrier, full, empty and (with biases) landed per stage, and 1 KB to
  // align the base.
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "the forward's tiles must fit a block");
  static __host__ __device__ constexpr int k_tile(int s) { return kQ + kOperand * 2 * s; }
  static __host__ __device__ constexpr int v_tile(int s) { return kQ + kOperand * (2 * s + 1); }
};

// K4 (`_fwd_kernel_stats_v2_qb` and its variants): q scaled (and the biases
// added) where the tiles enter shared memory, the key bias added to the
// scores, the lse written with kStats.
template <bool kBias_, bool kLse>
struct K4 {
  static constexpr bool kK4 = true, kBias = kBias_, kSeg = false, kStats = kLse,
                        kTwoSweep = false;
};
// K7 (the stock TPU flash kernel): scores scaled by d**-0.5, keys past Tk
// masked (and, with kSeg, keys of another segment); m and l with kStats.
template <bool kStats_, bool kSeg_>
struct K7 {
  static constexpr bool kK4 = false, kBias = false, kSeg = kSeg_, kStats = kStats_,
                        kTwoSweep = false;
};
// v1 (`_fwd_kernel_stats`): K4 without biases, with the lse, in two sweeps
// over the keys (above).
struct V1 {
  static constexpr bool kK4 = true, kBias = false, kSeg = false, kStats = true,
                        kTwoSweep = true;
};

// One map per operand and column block (block 1's equals block 0's at d =
// 120, where both are 64 wide; unused at d = 64).
struct Maps {
  CUtensorMap q0, q1, k0, k1, v0, v1;
};

struct Args {
  const bf16* bq;        // K4 with biases: (H*D,) bf16 each
  const bf16* bk;
  const bf16* bv;
  const float* key_bias;  // K4: (B, T) fp32, 0 or -1e30
  const int* seg;         // K7 with segments: (B, Tk) int32
  bf16* o;                // (B, T, H*D) bf16 contiguous
  float* stat_a;          // K4 the lse, K7 m: (B, H, T) fp32
  float* stat_l;          // K7 l
  int T, Tk, H;           // keys run to Tk (K4: T)
  float scale;            // K4: the bf16 scale of q; K7: the scores' d**-0.5
};

__device__ __forceinline__ uint32_t bf2_add(uint32_t x, uint32_t y) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t x, uint32_t y) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&x),
                             *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// V1's p = e / l as e times the row's reciprocal r = 1 / l, within 2^-16 of
// a bf16 ulp of p before its rounding. l is for the `divide` variant of
// `tools/fwd_variants.py`, which divides a score at a time (__fdiv_rn):
// 2.8-3.4x v1's time on an H100 at 8 x 1499 rows.
__device__ __forceinline__ float normalise(float e, float r, float l) {
  (void)l;
  return e * r;
}

// One 16-byte chunk of 8 bf16: x = bf16(x + bias) (kBias), then
// bf16(x * scale) (kScale).
template <int kRowBytes, bool kBias, bool kScale>
__device__ __forceinline__ uint4 transform_chunk(uint4 x, uint4 bb, uint32_t scale2) {
  if constexpr (kBias) {
    x.x = bf2_add(x.x, bb.x);
    x.y = bf2_add(x.y, bb.y);
    x.z = bf2_add(x.z, bb.z);
    x.w = bf2_add(x.w, bb.w);
  }
  if constexpr (kScale) {
    x.x = bf2_mul(x.x, scale2);
    x.y = bf2_mul(x.y, scale2);
    x.z = bf2_mul(x.z, scale2);
    x.w = bf2_mul(x.w, scale2);
  }
  return x;
}

// Rows r0 .. r0+rows-1 of a column block with kRowBytes-wide swizzled rows
// at shared address `blk`, in place, by 128 threads (transform_chunk). A
// thread takes one logical chunk of every 128 / kChunks-th row, which the
// swizzle puts at one physical chunk in each (the pattern repeats every 8
// rows). Chunks at or past `cols` (the head's end) stay zero. The loads are
// volatile shared-memory instructions, kept in program order: kGroup rows'
// loads are issued before their stores, so that many are in flight.
template <int kRowBytes, bool kBias, bool kScale, int kGroup>
__device__ __forceinline__ void transform_rows(uint32_t blk, const bf16* bias, uint32_t scale2,
                                               int t, int r0, int rows, int cols) {
  constexpr int kChunks = kRowBytes / 16, kStep = 128 / kChunks;
  const int c = t % kChunks;
  if (c * 8 >= cols) return;
  uint4 bb = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kBias) bb = *reinterpret_cast<const uint4*>(bias + c * 8);
  const int first = r0 + t / kChunks;
  uint32_t addr = blk + first * kRowBytes + hopper::swizzle_chunk(kRowBytes, first, c) * 16;
#pragma unroll 1
  for (int r = first; r < r0 + rows; r += kGroup * kStep, addr += kGroup * kStep * kRowBytes) {
    uint4 x[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (r + g * kStep < r0 + rows) x[g] = hopper::ld_shared_v4(addr + g * kStep * kRowBytes);
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (r + g * kStep < r0 + rows)
        hopper::st_shared_v4(addr + g * kStep * kRowBytes,
                             transform_chunk<kRowBytes, kBias, kScale>(x[g], bb, scale2));
  }
}

// Both column blocks of an operand tile at shared address `tile` (block 1
// at `tile + blk1`), rows r0 .. r0+rows-1, by 128 threads.
template <int D, bool kBias, bool kScale, int kGroup>
__device__ __forceinline__ void transform_tile(uint32_t tile, int blk1, const bf16* bias,
                                               uint32_t scale2, int t, int r0, int rows) {
  constexpr int kW1 = Tile<D, 2>::kW1;
  transform_rows<128, kBias, kScale, kGroup>(tile, bias, scale2, t, r0, rows, D);
  if constexpr (kW1 > 0)
    transform_rows<kW1 * 2, kBias, kScale, kGroup>(tile + blk1, kBias ? bias + 64 : nullptr,
                                                   scale2, t, r0, rows, D - 64);
}

// The producer warpgroup: TMA copies of Q and of each K/V tile into its
// stage once the consumers released it (K alone in the first of two
// sweeps), and the tile's key vector, by its first warp; with kBias all four
// warps then add bk and bv to the tile once it landed (the copy of the next
// tile follows the pass: issuing it before, or from a warp of its own beside
// three pass warps, measured slower).
template <int D, class P>
__device__ __forceinline__ void produce(const Maps& maps, const Args& a, uint32_t base, int q0,
                                        int h, int b, int n_tiles) {
  using L = Tile<D, consumers(D)>;
  constexpr int kProducers = P::kBias ? 128 : 32;
  hopper::reg_dealloc<producer_regs(consumers(D), P::kBias)>();
  const int t = threadIdx.x;
  if (t >= kProducers) return;
  const uint32_t bars = base + L::kBars;
  if (t == 0) {
    hopper::prefetch_tensormap(&maps.k0);
    hopper::prefetch_tensormap(&maps.v0);
    hopper::mbar_arrive_expect_tx(bars, L::kQ);
    hopper::tma_load_4d(base, &maps.q0, bars, 0, h, q0, b);
    if constexpr (L::kW1 > 0) hopper::tma_load_4d(base + L::kQBlk0, &maps.q1, bars, 64, h, q0, b);
  }
  // The ring's iteration i: stage i % kStages, phase (i / kStages) & 1, over
  // both sweeps; tile i % n_tiles.
  for (int i = 0; i < (P::kTwoSweep ? 2 : 1) * n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t full = bars + 8 + 8 * s, landed = bars + 8 + 8 * (2 * kStages + s);
    const int k0 = (i < n_tiles ? i : i - n_tiles) * kKeys;
    const bool with_v = !P::kTwoSweep || i >= n_tiles;
    hopper::mbar_wait(bars + 8 + 8 * (kStages + s), phase ^ 1);
    if (t == 0) {
      const uint32_t tx = P::kBias ? landed : full;
      hopper::mbar_arrive_expect_tx(tx, (with_v ? 2 : 1) * L::kOperand);
      const uint32_t kt = base + L::k_tile(s), vt = base + L::v_tile(s);
      hopper::tma_load_4d(kt, &maps.k0, tx, 0, h, k0, b);
      if (with_v) hopper::tma_load_4d(vt, &maps.v0, tx, 0, h, k0, b);
      if constexpr (L::kW1 > 0) {
        hopper::tma_load_4d(kt + L::kBlk0, &maps.k1, tx, 64, h, k0, b);
        if (with_v) hopper::tma_load_4d(vt + L::kBlk0, &maps.v1, tx, 64, h, k0, b);
      }
    }
    if constexpr (P::kK4 || P::kSeg) {
      const uint32_t kvec = base + L::kKvec + 4 * s * kKeys;
      for (int j = t; j < kKeys; j += kProducers) {
        const int key = k0 + j;
        uint32_t word;
        if constexpr (P::kK4)
          word = __float_as_uint(key < a.T ? a.key_bias[(long long)b * a.T + key] * kLog2e
                                           : -INFINITY);
        else
          word = key < a.Tk ? (uint32_t)a.seg[(long long)b * a.Tk + key] : 0u;
        hopper::st_shared_b32(kvec + 4 * j, word);
      }
    }
    if constexpr (P::kBias) {
      hopper::mbar_wait(landed, phase);
      constexpr int kGroup = pass_group(consumers(D));
      transform_tile<D, true, false, kGroup>(base + L::k_tile(s), L::kBlk0, a.bk + h * D, 0u, t,
                                             0, kKeys);
      transform_tile<D, true, false, kGroup>(base + L::v_tile(s), L::kBlk0, a.bv + h * D, 0u, t,
                                             0, kKeys);
      hopper::fence_proxy_async();
    }
    hopper::mbar_arrive(full);
  }
}

// A consumer warpgroup: 64 query rows against every K/V tile (in two
// sweeps with P::kTwoSweep), then o and the stats of its rows.
template <int D, class P>
__device__ __forceinline__ void consume(const Args& a, unsigned char* smem, uint32_t base, int q0,
                                        int h, int b, int n_tiles) {
  constexpr int kWG = consumers(D);
  using L = Tile<D, kWG>;
  constexpr int kW1 = L::kW1;
  hopper::reg_alloc<consumer_regs(kWG, P::kBias)>();
  const int wg = threadIdx.x / 128 - 1;  // rows 64 wg .. 64 wg + 63 of the block
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = 16 * (t / 32) + lane / 4;  // this thread's rows: row and row + 8
  const int quad = lane % 4;                 // and columns 8 j + 2 quad + {0, 1}
  const int t0 = q0 + 64 * wg + row, t1 = t0 + 8;
  const uint32_t bars = base + L::kBars;
  const float* kvec_all = reinterpret_cast<const float*>(smem + L::kKvec);

  hopper::mbar_wait(bars, 0);
  if constexpr (P::kK4) {
    const __nv_bfloat162 s2 = __float2bfloat162_rn(a.scale);
    transform_tile<D, P::kBias, true, 4>(base, L::kQBlk0, P::kBias ? a.bq + h * D : nullptr,
                                         *reinterpret_cast<const uint32_t*>(&s2), t, 64 * wg,
                                         64);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + wg, 128);
  }
  const uint32_t qa0 = base + wg * 64 * 128;
  const uint32_t qa1 = base + L::kQBlk0 + wg * 64 * L::kRB1;
  int seg0 = 0, seg1 = 0;
  if constexpr (P::kSeg) {
    const int* seg = a.seg + (long long)b * a.Tk;
    seg0 = t0 < a.T ? seg[t0] : 0;
    seg1 = t1 < a.T ? seg[t1] : 0;
  }
  // The exponent's factor: K4's scores are in log2 units already.
  const float ex = P::kK4 ? 1.0f : a.scale * kLog2e;

  float s[64];                                     // S, then its exponentials
  float o0[32], o1[kW1 > 0 ? kW1 / 2 : 1];         // O by column block
  uint32_t p[8][4];                                // P: the A fragments of 8 k-steps
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (kW1 > 0 ? kW1 / 2 : 1); ++i) o1[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row maxima (K4: log2 units; K7: raw q k)
  float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums

  auto qk = [&](int st) {
    const uint32_t kt = base + L::k_tile(st);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::wgmma_m64n128k16_ss(s, hopper::smem_desc(qa0 + 32 * j, 1024, 128),
                                  hopper::smem_desc(kt + 32 * j, 1024, 128), j > 0);
    if constexpr (kW1 == 64) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::wgmma_m64n128k16_ss(s, hopper::smem_desc(qa1 + 32 * j, 1024, 128),
                                    hopper::smem_desc(kt + L::kBlk0 + 32 * j, 1024, 128), 1);
    } else if constexpr (kW1 == 16) {
      hopper::wgmma_m64n128k16_ss(s, hopper::smem_desc(qa1, 256, 32),
                                  hopper::smem_desc(kt + L::kBlk0, 256, 32), 1);
    }
  };
  auto pv = [&](int st) {
    const uint32_t vt = base + L::v_tile(st);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      hopper::wgmma_m64n64k16_rs(o0, p[kk], hopper::smem_desc(vt + kk * 2048, 1024, 128));
      if constexpr (kW1 == 64)
        hopper::wgmma_m64n64k16_rs(o1, p[kk],
                                   hopper::smem_desc(vt + L::kBlk0 + kk * 2048, 1024, 128));
      else if constexpr (kW1 == 16)
        hopper::wgmma_m64n16k16_rs(o1, p[kk],
                                   hopper::smem_desc(vt + L::kBlk0 + kk * 512, 256, 32));
    }
  };
  // The tile of keys k0.. in stage st: masks, the running max, s <- exp2 of
  // the scores against it, the row sums; returns the rows' rescale factors.
  auto softmax = [&](int k0, int st, float& alpha0, float& alpha1) {
    const float* kvec = kvec_all + st * kKeys;
    const int n_valid = a.Tk - k0;  // K7: keys past Tk in a partial last tile
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * quad;
      if constexpr (P::kK4) {
        const float2 kb = *reinterpret_cast<const float2*>(kvec + c);
        s[4 * j] = fmaf(s[4 * j], kLog2e, kb.x);
        s[4 * j + 1] = fmaf(s[4 * j + 1], kLog2e, kb.y);
        s[4 * j + 2] = fmaf(s[4 * j + 2], kLog2e, kb.x);
        s[4 * j + 3] = fmaf(s[4 * j + 3], kLog2e, kb.y);
      } else {
        if constexpr (P::kSeg) {
          const int2 id = *reinterpret_cast<const int2*>(kvec + c);
          if (id.x != seg0) s[4 * j] = -INFINITY;
          if (id.y != seg0) s[4 * j + 1] = -INFINITY;
          if (id.x != seg1) s[4 * j + 2] = -INFINITY;
          if (id.y != seg1) s[4 * j + 3] = -INFINITY;
        }
        if (n_valid < kKeys) {
          if (c >= n_valid) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (c + 1 >= n_valid) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // K4 and unmasked K7: finite, every tile holds a key below T. With
    // segments: -inf while no key of the row's segment was seen, and the
    // update then uses 0 (p = 0 and alpha = 0).
    float mu0 = mn0, mu1 = mn1;
    if constexpr (P::kSeg) {
      mu0 = mn0 == -INFINITY ? 0.0f : mn0;
      mu1 = mn1 == -INFINITY ? 0.0f : mn1;
    }
    alpha0 = fast_exp2((m0 - mu0) * ex);
    alpha1 = fast_exp2((m1 - mu1) * ex);
    const float nm0 = -mu0 * ex, nm1 = -mu1 * ex;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], ex, nm0));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], ex, nm0));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], ex, nm1));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], ex, nm1));
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = fmaf(l0, alpha0, ps0);  // written out: every instantiation contracts alike
    l1 = fmaf(l1, alpha1, ps1);
    m0 = mn0;
    m1 = mn1;
  };
  // V1's second sweep: the tile of stage st, s <- p = exp2(s - m) / l
  // against the rows' final max and sum (K4's log2 units).
  float r0 = 0.0f, r1 = 0.0f;
  auto normalised = [&](int st) {
    static_assert(!P::kTwoSweep || (P::kK4 && !P::kBias),
                  "the two-sweep policy is K4's without biases");
    const float* kvec = kvec_all + st * kKeys;
    const float nm0 = -m0 * ex, nm1 = -m1 * ex;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * quad;
      const float2 kb = *reinterpret_cast<const float2*>(kvec + c);
      s[4 * j] = normalise(fast_exp2(fmaf(fmaf(s[4 * j], kLog2e, kb.x), ex, nm0)), r0, l0);
      s[4 * j + 1] =
          normalise(fast_exp2(fmaf(fmaf(s[4 * j + 1], kLog2e, kb.y), ex, nm0)), r0, l0);
      s[4 * j + 2] =
          normalise(fast_exp2(fmaf(fmaf(s[4 * j + 2], kLog2e, kb.x), ex, nm1)), r1, l1);
      s[4 * j + 3] =
          normalise(fast_exp2(fmaf(fmaf(s[4 * j + 3], kLog2e, kb.y), ex, nm1)), r1, l1);
    }
  };
  // The row sums over the 4 lanes that share each row.
  auto reduce_l = [&]() {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale = [&](float alpha0, float alpha1) {
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      o0[i] *= alpha0;
      o0[i + 1] *= alpha0;
      o0[i + 2] *= alpha1;
      o0[i + 3] *= alpha1;
    }
    if constexpr (kW1 > 0) {
#pragma unroll
      for (int i = 0; i < kW1 / 2; i += 4) {
        o1[i] *= alpha0;
        o1[i + 1] *= alpha0;
        o1[i + 2] *= alpha1;
        o1[i + 3] *= alpha1;
      }
    }
  };
  auto release = [&](int st) {
    if (lane == 0) hopper::mbar_arrive(bars + 8 + 8 * (kStages + st));
  };

  // The warpgroups take turns, in order, to issue their products
  // (FlashAttention-3's ping-pong): named barrier 1 + kWG + wg is this
  // warpgroup's turn, which the one before it grants by arriving on it after
  // issuing its own, so one warpgroup's softmax runs while another's
  // products do. The last warpgroup grants the first turn and skips its last
  // grant, so every barrier phase completes.
  auto my_turn = [&]() { hopper::named_barrier(1 + kWG + wg, 256); };
  auto their_turn = [&](bool last) {
    if (!(last && wg == kWG - 1)) hopper::named_barrier_arrive(1 + kWG + (wg + 1) % kWG, 256);
  };
  if (wg == kWG - 1) hopper::named_barrier_arrive(1 + kWG, 256);

  auto full = [&](int i) {  // waits for the ring's iteration i
    hopper::mbar_wait(bars + 8 + 8 * (i % kStages), (i / kStages) & 1);
  };
  float alpha0, alpha1;
  if constexpr (P::kTwoSweep) {
    // Sweep 1: S of each tile and the running max and sum, the stage
    // released after its softmax.
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      full(i);
      my_turn();
      hopper::fence_regs(s);
      hopper::wgmma_fence();
      qk(st);
      hopper::wgmma_commit();
      their_turn(false);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      softmax(i * kKeys, st, alpha0, alpha1);
      release(st);
    }
    reduce_l();
    r0 = 1.0f / l0;
    r1 = 1.0f / l1;
  }
  // The P V sweep, ring iterations i0 .. i0 + n_tiles - 1; tile j's
  // exponentials (kTwoSweep: normalised; else against the running max).
  const int i0 = P::kTwoSweep ? n_tiles : 0;
  auto exps = [&](int j, int st) {
    if constexpr (P::kTwoSweep)
      normalised(st);
    else
      softmax(j * kKeys, st, alpha0, alpha1);
  };

  // Tile 0: S, its exponentials, P.
  int st = i0 % kStages;
  full(i0);
  my_turn();
  hopper::fence_regs(s);
  hopper::wgmma_fence();
  qk(st);
  hopper::wgmma_commit();
  their_turn(false);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  exps(0, st);
  pack();
  for (int j = 1; j < n_tiles; ++j) {
    const int sn = (i0 + j) % kStages;
    full(i0 + j);
    my_turn();
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    qk(sn);  // S of tile j; meanwhile (one sweep) O is rescaled to tile j - 1's max ...
    hopper::wgmma_commit();
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
    if constexpr (!P::kTwoSweep) rescale(alpha0, alpha1);
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
    hopper::wgmma_fence();
    pv(st);  // ... and O += P V of tile j - 1 follows it
    hopper::wgmma_commit();
    their_turn(false);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    exps(j, sn);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o0);
    hopper::fence_regs(o1);
    hopper::fence_regs(s);
    release(st);
    pack();
    st = sn;
  }
  my_turn();
  hopper::fence_regs(o0);
  hopper::fence_regs(o1);
  if constexpr (!P::kTwoSweep) rescale(alpha0, alpha1);
  hopper::fence_regs(o0);
  hopper::fence_regs(o1);
  hopper::wgmma_fence();
  pv(st);
  hopper::wgmma_commit();
  their_turn(true);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o0);
  hopper::fence_regs(o1);
  release(st);

  // o = O / l (kTwoSweep: O) for rows below T, columns below d; the stats.
  if constexpr (!P::kTwoSweep) reduce_l();
  auto out = [](float x, float l) { return P::kTwoSweep ? x : x / l; };
  const long long HD = (long long)a.H * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tq = half ? t1 : t0;
    if (tq >= a.T) continue;
    const float l = half ? l1 : l0;
    uint32_t* orow = reinterpret_cast<uint32_t*>(a.o + ((long long)b * a.T + tq) * HD + h * D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      orow[4 * j + quad] =
          pack_bf16(out(o0[4 * j + 2 * half], l), out(o0[4 * j + 2 * half + 1], l));
    if constexpr (kW1 > 0) {
#pragma unroll
      for (int j = 0; j < kW1 / 8; ++j)
        if (64 + 8 * j < D)
          orow[32 + 4 * j + quad] =
              pack_bf16(out(o1[4 * j + 2 * half], l), out(o1[4 * j + 2 * half + 1], l));
    }
    if (P::kStats && quad == 0) {
      const long long i = ((long long)b * a.H + h) * a.T + tq;
      const float m = half ? m1 : m0;
      if constexpr (P::kK4) {
        // A fully padded row has m = -1e30; the clamp keeps the backward's
        // exp(s - lse) at 0 for it, as in the JAX kernel.
        a.stat_a[i] = fmaxf(fmaf(m, kLn2, logf(l)), -1e25f);
      } else {
        a.stat_a[i] = m * a.scale;
        a.stat_l[i] = l;
      }
    }
  }
}

// The mainloop of a forward kernel over (ceil(T / kRows), H, B) blocks of
// kThreads threads with kSmem bytes of dynamic shared memory (Tile).
template <int D, class P>
__device__ __forceinline__ void mainloop(const Maps& maps, const Args& a) {
  constexpr int kWG = consumers(D);
  using L = Tile<D, kWG>;
  // The split must fit what the launch gives the block: 65536 registers
  // over its threads, in units of 8 a thread.
  static_assert(128 * producer_regs(kWG, P::kBias) + 128 * kWG * consumer_regs(kWG, P::kBias) <=
                    L::kThreads * (65536 / L::kThreads / 8 * 8),
                "setmaxnreg's split exceeds the block's registers");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle patterns need 1024
  unsigned char* smem = smem_raw + (base - raw);
  const int q0 = blockIdx.x * L::kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.Tk + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    const uint32_t bars = base + L::kBars;
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      // full: the producer threads' arrivals (without the bias pass, also the
      // expect_tx of the copy); empty: the consumers' warps.
      hopper::mbar_init(bars + 8 + 8 * s, P::kBias ? 128 : 33);
      hopper::mbar_init(bars + 8 + 8 * (kStages + s), 4 * consumers(D));
      hopper::mbar_init(bars + 8 + 8 * (2 * kStages + s), 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128)
    produce<D, P>(maps, a, base, q0, h, b, n_tiles);
  else
    consume<D, P>(a, smem, base, q0, h, b, n_tiles);
}

// The tensor maps of q, k and v at head dim D, Q's boxes `q_rows` rows
// tall; 0 or the encoder's error.
template <int D>
int encode(Maps* m, const void* q, const void* k, const void* v, int B, int T, int H,
           long long stride_b, long long stride_t, int q_rows) {
  constexpr int kW1 = Tile<D, 2>::kW1;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* blk0[3] = {&m->q0, &m->k0, &m->v0};
  CUtensorMap* blk1[3] = {&m->q1, &m->k1, &m->v1};
  for (int i = 0; i < 3; ++i) {
    const int rows = i == 0 ? q_rows : kKeys;
    int err = hopper::encode_heads(blk0[i], ptrs[i], D, H, T, B, stride_t, stride_b, 64, rows);
    if (err != 0) return err;
    if (kW1 == 64) {
      *blk1[i] = *blk0[i];
    } else if (kW1 > 0) {
      err = hopper::encode_heads(blk1[i], ptrs[i], D, H, T, B, stride_t, stride_b, kW1, rows);
      if (err != 0) return err;
    }
  }
  return 0;
}

// Encodes the maps and launches `kernel` (a forward over this mainloop with
// policy P) on `s`; the encoder's error or the cudaError_t.
template <int D, class P, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v, const Args& args, int B,
           long long stride_b, long long stride_t, cudaStream_t s) {
  using L = Tile<D, consumers(D)>;
  Maps maps;
  const int enc = encode<D>(&maps, q, k, v, B, args.T, args.H, stride_b, stride_t, L::kRows);
  if (enc != 0) return enc;
  // Once per kernel and process (the port drives one card): on the host
  // path of every launch it showed in the events time of a single call.
  static const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((args.T + L::kRows - 1) / L::kRows), (unsigned)args.H, (unsigned)B);
  kernel<<<grid, L::kThreads, L::kSmem, s>>>(maps, args);
  return (int)cudaGetLastError();
}

}  // namespace fwd

// --- The backward mainloop (Hopper: TMA, mbarriers, wgmma) --------------------------
//
// Two kernels over one set of pieces, a query-major one over dq() and a
// key-major one over dkv(), each a thin kernel with a policy, as the
// forwards are over fwd::mainloop:
// - K7<kSeg>: `flash_bwd_dq_kernel` and `flash_bwd_dkv_kernel` (K7's
//   backward, unmasked and with segment ids, `flash_attention.cu`);
// - K4<kBias>: `attention_bwd_dq_kernel` and `attention_bwd_dkv_kernel` of
//   the v3 backward, with and without the q/k/v biases (`attention.cu`);
// - Stats, Recompute, Ctx: the same pair for the K15 routes' backwards
//   (`attention_rows.cu`).
// Every pair launches its dq kernel first.
//
// Bound on the H100: the tensor cores and the exponentials. Per head the dq
// kernel makes three T x T x DP products (S = Q K^T, dP = dO V^T, dQ = dS K)
// and the dkv kernel four (S^T, dP^T, dV = P^T dO, dK = dS^T Q), each with
// T^2 exponentials, from 5-6 T d bf16 values read or written: 750-1,000 flops
// a byte at T = 1500, far above the card's 295. The K15 routes' dq kernel
// adds a first sweep of one or two products and T^2 exponentials.
//
// Design: a block holds 64 x kWG rows of its own side (kWG = 2 consumer
// warpgroups) in shared memory, copied once by TMA, and a producer warp
// streams tiles of the other side into a ring (two stages for dq, three for
// dkv), each with a `full` and an `empty` mbarrier, as the forward streams K
// and V:
// - dq(): one block per 128 query rows of one head holds Q and dO and walks
//   the key tiles (kN = 128 keys, 64 at d = 120). S = Q K^T and dP = dO V^T
//   by wgmma from shared memory (both K-major); p and dS = p (dP - di) scale
//   in registers; dS, packed to bf16 pairs, is the register A operand of dQ
//   += dS K, K the N-major B operand (the transpose bit, as the forward's
//   V). The block first forms di = rowsum(o do) of its rows in fp32 from o
//   and do, once, and writes it to a (B, H, T) scratch.
// - dkv(): one block per 128 keys holds K and V and walks the query tiles
//   (kN = 64 queries, 32 at d = 120), in the transposed space: S^T = K Q^T
//   and dP^T = V dO^T from shared memory; P^T and dS^T per column (query)
//   from the staged row stats; dV += bf16(P^T) dO and dK += bf16(dS^T) Q, both
//   with the A operand from registers and dO, Q as N-major B operands. The
//   producer stages each query tile's c = m log2 e + log2 l and the dq
//   kernel's di (and, with segments, the ids) beside the tile by plain loads,
//   issued before it waits for the stage: a (B, H, T) fp32 row at T = 499 is
//   1,996 bytes, not the 16-byte multiple a tensor map or bulk copy needs.
// Within a warpgroup a tile's products and its exponentials take turns; the
// two warpgroups' turns interleave on the SM. (Issuing the scores of tile i +
// 1 before the accumulating products of tile i, FlashAttention-3's
// intra-warpgroup overlap, measured slower for dq and no faster for dkv on
// the card, with three stages each; not kept.) Computing S = Q K^T in the
// dkv kernel (FlashAttention-3's choice) would make P and dS the B operands
// of dV and dK, which wgmma reads only from shared memory; in the transposed
// space both accumulating products take them from registers, so nothing of
// S, P, dP or dS passes through shared memory in either kernel. There are no
// atomics: dq is summed in registers over every key tile by the one block
// that owns its rows, so the gradients are the same bits on every run.
//
// The short-T policies (K4, K15; kK4) differ from K7 in five places, each a
// flag of the policy, not a fork of the loop:
// - Operands. q, k, v get their biases added (kBias) and are rounded to
//   bf16; q is then multiplied by the bf16 scale and rounded again, the JAX
//   kernels' order (`coral_tpu/ops/attention_pallas.py:292-296`), and the
//   scores are not scaled again. A resident operand is transformed once by
//   its consumer warpgroup after its copy landed (dq's Q, dkv's K and V); a
//   streamed one by the producer warpgroup's four warps once each tile
//   landed (dq's K and V with kBias, dkv's Q always), as the forward's bias
//   pass (fwd::transform_tile, then the async-proxy fence before wgmma reads
//   the tile).
// - Scores in log2 units: s log2 e + b by one FMA, b the key's bias times
//   log2 e (the caller's finite -1e30 for a padded key, -inf past T), as the
//   forward's K4: the dq tile's staged row vector, the dkv thread's two keys'
//   in registers.
// - p. From the forward's lse (K4, Stats): p = exp2(s - lse log2 e); the
//   forward clamps the lse at -1e25, so a fully masked row gets p = 0 (no
//   gradient). From the row's own max m and sum l (Recompute, Ctx, swept by
//   the dq kernel): p = exp2(s - m) r with r = 1 / l, s - m subtracted first
//   and r applied after the exponential, with no clamp, as the JAX kernels
//   that recompute the softmax. A fully masked row has every s equal to the
//   key bias -1e30 log2 e exactly (the FMA absorbs the score), m equals it,
//   s - m = 0 and p = 1 / T: nonzero gradients ("uniform garbage", as the
//   JAX package calls them), every key's dv the mean of do. That holds only
//   because the score and its key bias are formed by the same FMA in both
//   kernels and both sweeps, and m and l are kept apart: K7's one constant
//   m log2 e + log2 l would lose log2 l at -1.44e30 and its rounding (~1e23)
//   would send p to 0 or inf.
// - dS = p (dP - delta) carries no scale; the dq accumulator is multiplied
//   by the fp32 sm_scale at its store (dK gets it from the scaled q).
// - Stores go through the row stride stride_d, so the lane thirds of one
//   packed dqkv are written in place; with kBias each block writes the
//   column sums of its 128 rows of bf16-rounded dq (or dk, dv) as one
//   partial, summed outside as the JAX package sums its per-batch-row ones.
// delta is rowsum(o do) (K7's di; K4, Ctx) or swept (Stats, Recompute); the
// dq kernel writes it to the (B, H, T) scratch di for the dkv kernel.
// Stats, Recompute and Ctx sweep the key tiles twice in the dq kernel, the
// ring's stages and phases continued from the first sweep into the second
// as in fwd::V1: Ctx's first sweep copies K alone (its expect_tx counts one
// operand) and computes S and the online m and l; Stats' S and dP, and u =
// sum_j p dp against the lse; Recompute's S and dP, the online m, l and u =
// sum_j e dp rescaled with m, delta = u / l. The block writes m (log2
// units), l and delta to the scratch, and its second sweep is K7's loop with
// the policy's p and dS. The dkv producer stages beside each query tile c
// (the lse times log2 e, or m), then 1 / l (Recompute, Ctx), then delta, by
// plain loads as K7's row stats.
//
// Tiles and registers (setmaxnreg): the dq consumer holds dQ (DP / 2
// registers a thread), S and dP (kN) and dS's fragments (kN / 4): 128-key
// tiles at d = 64 and 80, 64 at 120, in 240 registers beside a 24-register
// producer warp (232 beside a 40-register producer warpgroup with the bias
// pass, a row at a time). The dkv consumer holds dK and dV (64, 80, 128
// registers a thread at d = 64, 80, 120), S^T and dP^T (kN) and their
// fragments (kN / 2): 64 queries, 32 at d = 120, in 232 registers; its
// producer keeps a tile's row stats in flight in 40 (at 24 it spilled 20-36
// bytes), in 56 with the pass over Q (224 for the consumers). No
// instantiation spills (ptxas, `chip_smoke.py`).
namespace bwd {

constexpr int kWG = 2;             // consumer warpgroups of a block
constexpr int kRows = 64 * kWG;    // the block's own rows (queries or keys)
constexpr int kThreads = 128 * (kWG + 1);

// Keys of a dq tile and queries of a dkv tile at head dim D.
__host__ __device__ constexpr int dq_tile(int D) { return D == 120 ? 64 : 128; }
__host__ __device__ constexpr int dkv_tile(int D) { return D == 120 ? 32 : 64; }

// A policy's flags: kK4 the short-T family (above); kBias the q/k/v biases;
// kSeg K7's segment ids; kML p from m and 1 / l swept by a first sweep of
// the dq kernel; kSweepU delta = sum_j p dp, swept there too.
template <bool kK4_, bool kBias_, bool kSeg_, bool kML_, bool kSweepU_>
struct Policy {
  static constexpr bool kK4 = kK4_, kBias = kBias_, kSeg = kSeg_, kML = kML_,
                        kSweepU = kSweepU_;
  static constexpr bool kSweep = kML || kSweepU;  // the dq kernel's first sweep
};
// K7 (the stock TPU flash kernel's backward): p rebuilt from the forward's m
// and l, scores scaled by d**-0.5, keys (dq) or queries (dkv) past T masked;
// with kSeg, pairs of different segment ids too.
template <bool kSeg>
struct K7 : Policy<false, false, kSeg, false, false> {};
// K4, the v3 backward (`_bwd_kernel_stats_ctx_qb` and, without biases,
// `_bwd_kernel_stats_ctx`): p from the lse, delta = rowsum(o do).
template <bool kBias>
struct K4 : Policy<true, kBias, false, false, false> {};
// `_bwd_kernel_stats` (mode 0): p from the lse, delta = sum_j p dp swept.
struct Stats : Policy<true, false, false, false, true> {};
// `_bwd_kernel` (mode 1): m and l swept, delta = sum_j p dp swept.
struct Recompute : Policy<true, false, false, true, true> {};
// `_bwd_kernel_ctx` (mode 2): m and l swept, delta = rowsum(o do).
struct Ctx : Policy<true, false, false, true, false> {};

// A kernel's tiles at head dim D: kN-row streamed tiles in a ring of
// kStages, kVecs words per streamed row, and setmaxnreg's split (kProducer
// registers a producer thread, kConsumer a consumer's). kPass: the producer
// warpgroup transforms each streamed tile once it landed (the copy completes
// on a `landed` mbarrier of its own, and the four warps arrive on `full`
// after the pass). kFirstBoth: a first sweep copies both streamed operands,
// else the first alone. kSums: column-sum buffers (8 warps x 128 fp32 each).
// Shared memory: two resident operands (kRows rows: the dq kernel's Q and
// dO, the dkv kernel's K and V), then kStages x two streamed ones (kN rows: K
// and V; Q and dO), each a 1024-aligned tile of the forward's two column
// blocks; the stages' row vectors; the column-sum buffers; the mbarriers (the
// resident copy's, then full and empty, with kPass landed, per stage) and 1
// KB to align the base.
template <int D, int kN_, int kVecs_, int kStages_, int kProducer_, int kConsumer_,
          bool kPass_ = false, bool kFirstBoth_ = true, int kSums_ = 0>
struct Layout {
  static constexpr int kN = kN_, kVecs = kVecs_, kStages = kStages_, kSums = kSums_;
  static constexpr int kProducer = kProducer_, kConsumer = kConsumer_;
  static constexpr bool kPass = kPass_, kFirstBoth = kFirstBoth_;
  // The split must fit what the launch gives the block: 65536 registers over
  // its threads, in units of 8 a thread.
  static_assert(128 * kProducer + 128 * kWG * kConsumer <= kThreads * (65536 / kThreads / 8 * 8),
                "setmaxnreg's split exceeds the block's registers");
  static constexpr int kW1 = fwd::Tile<D, 2>::kW1;
  static constexpr int kRB1 = kW1 * 2;
  static constexpr int kResBlk0 = kRows * 128;
  static constexpr int kRes = kResBlk0 + kRows * kRB1;
  static constexpr int kBlk0 = kN * 128;
  static constexpr int kTile = kBlk0 + kN * kRB1;
  static_assert(kResBlk0 % 1024 == 0 && kRes % 1024 == 0 && kBlk0 % 1024 == 0 &&
                    kTile % 1024 == 0,
                "each tile 1024-aligned");
  static constexpr int kVec = 2 * kRes + 2 * kStages * kTile;
  static constexpr int kSum = kVec + kStages * kVecs * kN * 4;
  static constexpr int kBars = kSum + kSums * 4 * kWG * 128 * 4;
  static constexpr int kSmem = kBars + 8 * (1 + (kPass ? 3 : 2) * kStages) + 1024;
  static_assert(kSmem <= kMaxSmem, "the backward's tiles must fit a block");
  static __host__ __device__ constexpr int res(int i) { return i * kRes; }
  static __host__ __device__ constexpr int tile(int s, int i) { return 2 * kRes + (2 * s + i) * kTile; }
  static __host__ __device__ constexpr int vec(int s, int j) {
    return kVec + (s * kVecs + j) * kN * 4;
  }
  static __host__ __device__ constexpr int sum(int i) { return kSum + i * 4 * kWG * 128 * 4; }
};
// dq: two stages; the key vector (K7 with kSeg: the ids; K4, K15: the key
// bias in log2 units); with the bias pass over K and V, a 40-register
// producer warpgroup (a row at a time: with two in flight it spilled 4
// bytes at d = 80) and 232 for the consumers, and one column-sum buffer; a
// first sweep copies V only to form dP (kSweepU).
template <int D, class P>
using DqLayout = Layout<D, dq_tile(D), P::kK4 || P::kSeg ? 1 : 0, 2, P::kBias ? 40 : 24,
                        P::kBias ? 232 : 240, P::kBias, P::kSweepU, P::kBias ? 1 : 0>;
// dkv: three stages; K7: c, di (and the query ids), 40 producer registers
// for the row stats in flight (at 24 they spilled); K4, K15: c, 1 / l (kML)
// and delta, and the pass over Q in a 56-register producer warpgroup (224
// for the consumers), two column-sum buffers with kBias.
template <int D, class P>
using DkvLayout = Layout<D, dkv_tile(D), P::kK4 ? (P::kML ? 3 : 2) : (P::kSeg ? 3 : 2), 3,
                         P::kK4 ? 56 : 40, P::kK4 ? 224 : 232, P::kK4, true, P::kBias ? 2 : 0>;

// The tensor maps: the resident operands' (boxes of kRows rows) and the
// streamed ones' (boxes of kN rows), [operand][column block].
struct Maps {
  CUtensorMap res[2][2], str[2][2];
};

struct Args {
  const bf16* o;     // dq: (B, T, H*D) bf16 contiguous
  const bf16* dout;  // the same layout
  const float* m;    // K7: (B, H, T) fp32: the forward's row max of the scaled scores
  const float* l;    // and row sum of exp(s - m)
  const int* seg;    // K7 with kSeg: (B, Tk) int32
  float* di;         // (B, H, T) fp32: delta, written by dq, read by dkv
  bf16* out0;        // dq: dq; dkv: dk; (B, T, H*D) bf16, rows `stride_d` apart (K7: H*D)
  bf16* out1;        // dkv: dv
  int T, Tk, H;
  float scale;       // K7: d**-0.5; K4, K15: the bf16 scale q is multiplied by
  // The short-T policies (kK4):
  const float* lse;       // K4, Stats: the forward's (B, H, T) fp32 lse
  const bf16* bq;         // kBias: (H*D,) bf16 each
  const bf16* bk;
  const bf16* bv;
  const float* key_bias;  // (B, T) fp32: 0 or the caller's -1e30
  float* row_m;           // kML: (B, H, T) fp32 scratch, m (log2 units) and l,
  float* row_l;           //   written by dq's first sweep, read by dkv
  float* db_part;         // kBias: (B, ceil(T / kRows), 3, H*D) fp32 column sums
  long long stride_d;     // the outputs' row stride (batch stride T stride_d)
  float sm_scale;         // fp32, dq's accumulator times it at the store
};

// Initialises the mbarriers (thread 0), then a block-wide barrier.
template <class L>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < L::kStages; ++s) {
      // full: the producer warp's 32 arrivals and the copy's expect_tx (with
      // the pass: the producer warpgroup's 128 arrivals, and the expect_tx
      // on landed); empty: the consumers' warps.
      hopper::mbar_init(bars + 8 + 8 * s, L::kPass ? 128 : 33);
      hopper::mbar_init(bars + 8 + 8 * (L::kStages + s), 4 * kWG);
      if (L::kPass) hopper::mbar_init(bars + 8 + 8 * (2 * L::kStages + s), 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The producer: the resident operands once, then n_first + n_tiles streamed
// tiles (a first sweep, then the second, tile i % n_tiles), each into its
// stage once the consumers released it, with its row vectors: vec(row,
// words) gives words[0 .. kVecs) of streamed row `row` (all rows, also those
// past T), by the first warp's 32 lanes, loaded before the wait for the
// stage so that their latency overlaps it. A first sweep without
// L::kFirstBoth copies the first operand alone. With L::kPass the whole
// warpgroup waits for the tile to land and runs pass(stage, both) on it.
template <class L, class Vec, class Pass>
__device__ __forceinline__ void produce(const Maps& maps, uint32_t base, int r0, int h, int b,
                                        int n_first, int n_tiles, Vec&& vec, Pass&& pass) {
  constexpr int kN = L::kN, kVecs = L::kVecs, kStages = L::kStages;
  hopper::reg_dealloc<L::kProducer>();
  const int t = threadIdx.x;
  if (t >= (L::kPass ? 128 : 32)) return;
  const uint32_t bars = base + L::kBars;
  if (t == 0) {
    hopper::prefetch_tensormap(&maps.str[0][0]);
    hopper::prefetch_tensormap(&maps.str[1][0]);
    hopper::mbar_arrive_expect_tx(bars, 2 * L::kRes);
    for (int i = 0; i < 2; ++i) {
      hopper::tma_load_4d(base + L::res(i), &maps.res[i][0], bars, 0, h, r0, b);
      if constexpr (L::kW1 > 0)
        hopper::tma_load_4d(base + L::res(i) + L::kResBlk0, &maps.res[i][1], bars, 64, h, r0, b);
    }
  }
  for (int i = 0; i < n_first + n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t full = bars + 8 + 8 * s, landed = bars + 8 + 8 * (2 * kStages + s);
    const int n0 = (i < n_first ? i : i - n_first) * kN;
    const bool both = L::kFirstBoth || i >= n_first;
    uint32_t words[kN / 32][kVecs > 0 ? kVecs : 1];
    if constexpr (kVecs > 0) {
      if (t < 32) {
#pragma unroll
        for (int r = 0; r < kN / 32; ++r) vec(n0 + t + 32 * r, words[r]);
      }
    }
    hopper::mbar_wait(bars + 8 + 8 * (kStages + s), phase ^ 1);
    if (t == 0) {
      const uint32_t tx = L::kPass ? landed : full;
      hopper::mbar_arrive_expect_tx(tx, (both ? 2 : 1) * L::kTile);
      for (int j = 0; j < (both ? 2 : 1); ++j) {
        const uint32_t dst = base + L::tile(s, j);
        hopper::tma_load_4d(dst, &maps.str[j][0], tx, 0, h, n0, b);
        if constexpr (L::kW1 > 0)
          hopper::tma_load_4d(dst + L::kBlk0, &maps.str[j][1], tx, 64, h, n0, b);
      }
    }
    if constexpr (kVecs > 0) {
      if (t < 32) {
#pragma unroll
        for (int r = 0; r < kN / 32; ++r)
#pragma unroll
          for (int j = 0; j < kVecs; ++j)
            hopper::st_shared_b32(base + L::vec(s, j) + 4 * (t + 32 * r), words[r][j]);
      }
    }
    if constexpr (L::kPass) {
      hopper::mbar_wait(landed, phase);
      pass(s, both);
      hopper::fence_proxy_async();
    }
    hopper::mbar_arrive(full);
  }
}

// A consumer thread's place in its warpgroup's 64 x N accumulators: rows
// `row` and row + 8, columns 8 j + 2 quad + {0, 1}; `warp` of the block's
// 4 kWG consumer warps.
struct Lane {
  int wg, lane, row, quad, warp;
  __device__ Lane() {
    wg = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    lane = t % 32;
    row = 16 * (t / 32) + lane / 4;
    quad = lane % 4;
    warp = 4 * wg + t / 32;
  }
};

// The 64 x kN product A B^T into d (fresh): A the warpgroup's 64 resident rows
// (column blocks at a0, a1), B a streamed tile at bt, both K-major.
template <int D, class L, int kN>
__device__ __forceinline__ void product_abt(float (&d)[kN / 2], uint32_t a0, uint32_t a1,
                                            uint32_t bt) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    hopper::wgmma_ss<kN>(d, hopper::smem_desc(a0 + 32 * j, 1024, 128),
                         hopper::smem_desc(bt + 32 * j, 1024, 128), j > 0);
  if constexpr (L::kW1 == 64) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::wgmma_ss<kN>(d, hopper::smem_desc(a1 + 32 * j, 1024, 128),
                           hopper::smem_desc(bt + L::kBlk0 + 32 * j, 1024, 128), 1);
  } else if constexpr (L::kW1 == 16) {
    hopper::wgmma_ss<kN>(d, hopper::smem_desc(a1, 256, 32),
                         hopper::smem_desc(bt + L::kBlk0, 256, 32), 1);
  }
}

// acc (64 x DP, column blocks acc0 and acc1) += A B: A (64 x kN) the bf16
// register fragments a, B a streamed kN x DP tile at bt, N-major.
template <class L, int kN>
__device__ __forceinline__ void product_ab(float (&acc0)[32], float (&acc1)[L::kW1 > 0 ? L::kW1 / 2 : 1],
                                           const uint32_t (&a)[kN / 16][4], uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    hopper::wgmma_m64n64k16_rs(acc0, a[kk], hopper::smem_desc(bt + kk * 2048, 1024, 128));
    if constexpr (L::kW1 == 64)
      hopper::wgmma_m64n64k16_rs(acc1, a[kk],
                                 hopper::smem_desc(bt + L::kBlk0 + kk * 2048, 1024, 128));
    else if constexpr (L::kW1 == 16)
      hopper::wgmma_m64n16k16_rs(acc1, a[kk], hopper::smem_desc(bt + L::kBlk0 + kk * 512, 256, 32));
  }
}

// The 64 x kN accumulator x as bf16 A fragments of kN / 16 k-steps.
template <int kN>
__device__ __forceinline__ void pack_a(uint32_t (&a)[kN / 16][4], const float (&x)[kN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kN / 16; ++kk) {
    a[kk][0] = fwd::pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = fwd::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = fwd::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = fwd::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

template <int N>
__device__ __forceinline__ void scale_by(float (&x)[N], float f) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] *= f;
}

// Rows t0 and t0 + 8 of a (B, T, ...) bf16 output with row stride `ld` from
// a 64 x DP accumulator (column blocks x0, x1): only rows below T and
// columns below D of head h.
template <int D, class L>
__device__ __forceinline__ void store_rows(bf16* out, long long ld, const float (&x0)[32],
                                           const float (&x1)[L::kW1 > 0 ? L::kW1 / 2 : 1],
                                           int b, int h, int t0, int T, int quad) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + 8 * half;
    if (t >= T) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + ((long long)b * T + t) * ld + h * D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      orow[4 * j + quad] = fwd::pack_bf16(x0[4 * j + 2 * half], x0[4 * j + 2 * half + 1]);
    if constexpr (L::kW1 > 0) {
#pragma unroll
      for (int j = 0; j < L::kW1 / 8; ++j)
        if (64 + 8 * j < D)
          orow[32 + 4 * j + quad] = fwd::pack_bf16(x1[4 * j + 2 * half], x1[4 * j + 2 * half + 1]);
    }
  }
}

// The column sums of a block's rows of bf16-rounded output (rows t0 and t0 +
// 8 of each thread, those below T) into part[0 .. D), by the block's 256
// consumer threads: a thread's two rows, the warp's 16 by shuffles across
// its 8 row groups, then the 8 warps' in order through the buffer `red` (8 x
// 128 fp32) after a named barrier over the consumers. The order is fixed, so
// the sums are the same bits on every run.
template <int D, class L>
__device__ __forceinline__ void column_sums(float* part, float* red, const float (&x0)[32],
                                            const float (&x1)[L::kW1 > 0 ? L::kW1 / 2 : 1],
                                            const Lane& ln, int t0, int T) {
  const bool in0 = t0 < T, in1 = t0 + 8 < T;
  auto col = [&](float lo, float hi) {  // one column's two rows, then the warp's 16
    float s = (in0 ? coral_round_bf16(lo) : 0.0f) + (in1 ? coral_round_bf16(hi) : 0.0f);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    return s;
  };
  float* mine = red + 128 * ln.warp;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float s0 = col(x0[4 * j], x0[4 * j + 2]), s1 = col(x0[4 * j + 1], x0[4 * j + 3]);
    if (ln.lane < 4) {
      mine[8 * j + 2 * ln.quad] = s0;
      mine[8 * j + 2 * ln.quad + 1] = s1;
    }
  }
  if constexpr (L::kW1 > 0) {
#pragma unroll
    for (int j = 0; j < L::kW1 / 8; ++j) {
      const float s0 = col(x1[4 * j], x1[4 * j + 2]), s1 = col(x1[4 * j + 1], x1[4 * j + 3]);
      if (ln.lane < 4) {
        mine[64 + 8 * j + 2 * ln.quad] = s0;
        mine[64 + 8 * j + 2 * ln.quad + 1] = s1;
      }
    }
  }
  hopper::named_barrier(3, 128 * kWG);
  const int c = threadIdx.x - 128;
  if (c < D) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 4 * kWG; ++w) s += red[128 * w + c];
    part[c] = s;
  }
}

// di = rowsum(o do) of query row t (0 past T) in fp32: the four lanes that
// share the row take its 16-byte chunks in turn, then sum across the four.
template <int D>
__device__ __forceinline__ float row_di(const Args& a, int b, int h, int t, int quad) {
  float s = 0.0f;
  if (t < a.T) {
    const long long off = (((long long)b * a.T + t) * a.H + h) * D;
    for (int c = quad; c < D / 8; c += 4) {
      float x[8], y[8];
      coral_load8(a.o + off + 8 * c, x);
      coral_load8(a.dout + off + 8 * c, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += x[e] * y[e];
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// K7: p's offset in log2 units, m log2 e + log2 l, of query row t; +inf past
// T (p = 0).
__device__ __forceinline__ float row_c(const Args& a, int b, int h, int t) {
  if (t >= a.T) return INFINITY;
  const long long i = ((long long)b * a.H + h) * a.T + t;
  return a.m[i] * fwd::kLog2e + log2f(a.l[i]);
}

// K4, Stats: p's offset, the lse of query row t in log2 units; +inf past T
// (p = 0). The forward's -1e25 clamp gives a fully masked row p = 0.
__device__ __forceinline__ float row_lse(const Args& a, int b, int h, int t) {
  if (t >= a.T) return INFINITY;
  return a.lse[((long long)b * a.H + h) * a.T + t] * fwd::kLog2e;
}

// K4, K15: the bias of key `key` in log2 units (-inf past T).
__device__ __forceinline__ float key_bias_log2(const Args& a, int b, int key) {
  return key < a.T ? a.key_bias[(long long)b * a.T + key] * fwd::kLog2e : -INFINITY;
}

// K4, K15: p of a score s in log2 units (the key bias in it) against its
// row's c (the lse in log2 units, or the swept m), with kML times r = 1 / l
// after the exponential.
template <class P>
__device__ __forceinline__ float prob(float s, float c, float r) {
  const float e = fwd::fast_exp2(s - c);
  return P::kML ? e * r : e;
}

// The outputs' row stride: K4's and K15's stride_d, K7's contiguous H*D.
template <int D, class P>
__device__ __forceinline__ long long out_stride(const Args& a) {
  return P::kK4 ? a.stride_d : (long long)a.H * D;
}

// kBias: the partial of output `which` (0 dq, 1 dk, 2 dv) of this block.
template <int D>
__device__ __forceinline__ float* bias_part(const Args& a, int b, int h, int which) {
  return a.db_part + ((long long)(b * gridDim.x + blockIdx.x) * 3 + which) * a.H * D + h * D;
}

// q's bf16 scale as a bf16 pair.
__device__ __forceinline__ uint32_t scale_pair(float scale) {
  const __nv_bfloat162 s2 = __float2bfloat162_rn(scale);
  return *reinterpret_cast<const uint32_t*>(&s2);
}

// The query-major kernel's block: dq of 128 query rows, their delta (and,
// with kML, m and l) for the dkv kernel.
template <int D, class P>
__device__ __forceinline__ void dq(const Maps& maps, const Args& a) {
  using L = DqLayout<D, P>;
  constexpr int kN = L::kN, kVecs = L::kVecs, kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const float* vecs = reinterpret_cast<const float*>(smem + L::kVec);
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.T + kN - 1) / kN;  // keys past T add nothing: k = v = 0 there
  const int n_first = P::kSweep ? n_tiles : 0;  // the first sweep's ring iterations
  const uint32_t bars = base + L::kBars;
  init_bars<L>(bars);
  if (threadIdx.x < 128) {
    produce<L>(
        maps, base, q0, h, b, n_first, n_tiles,
        [&](int key, uint32_t* w) {
          if constexpr (P::kK4)
            w[0] = __float_as_uint(key_bias_log2(a, b, key));
          else
            w[0] = key < a.Tk ? (uint32_t)a.seg[(long long)b * a.Tk + key] : 0u;
        },
        [&](int s, bool both) {  // kBias: K + bk, V + bv, a row at a time
          if constexpr (P::kBias) {
            fwd::transform_tile<D, true, false, 1>(base + L::tile(s, 0), L::kBlk0, a.bk + h * D,
                                                   0u, threadIdx.x, 0, kN);
            if (both)
              fwd::transform_tile<D, true, false, 1>(base + L::tile(s, 1), L::kBlk0,
                                                     a.bv + h * D, 0u, threadIdx.x, 0, kN);
          }
        });
    return;
  }
  hopper::reg_alloc<L::kConsumer>();
  const Lane ln;
  const int t0 = q0 + 64 * ln.wg + ln.row, t1 = t0 + 8;
  const long long stat = ((long long)b * a.H + h) * a.T;
  // delta: rowsum(o do) from o (K7's di), else swept below.
  float d0 = 0.0f, d1 = 0.0f;
  if constexpr (!P::kSweepU) {
    d0 = row_di<D>(a, b, h, t0, ln.quad);
    d1 = row_di<D>(a, b, h, t1, ln.quad);
    if (ln.quad == 0) {
      if (t0 < a.T) a.di[stat + t0] = d0;
      if (t1 < a.T) a.di[stat + t1] = d1;
    }
  }
  // p's offset c (log2 units; with kML the swept m) and r = 1 / l (kML).
  float c0 = 0.0f, c1 = 0.0f, r0 = 1.0f, r1 = 1.0f;
  if constexpr (!P::kK4) {
    c0 = row_c(a, b, h, t0);
    c1 = row_c(a, b, h, t1);
  } else if constexpr (!P::kML) {
    c0 = row_lse(a, b, h, t0);
    c1 = row_lse(a, b, h, t1);
  }
  int seg0 = 0, seg1 = 0;
  if constexpr (P::kSeg) {
    const int* seg = a.seg + (long long)b * a.Tk;
    seg0 = t0 < a.T ? seg[t0] : 0;
    seg1 = t1 < a.T ? seg[t1] : 0;
  }
  const float ex = a.scale * fwd::kLog2e;
  const uint32_t qa0 = base + L::res(0) + ln.wg * 64 * 128;
  const uint32_t qa1 = base + L::res(0) + L::kResBlk0 + ln.wg * 64 * L::kRB1;
  const uint32_t da0 = base + L::res(1) + ln.wg * 64 * 128;
  const uint32_t da1 = base + L::res(1) + L::kResBlk0 + ln.wg * 64 * L::kRB1;

  float dq0[32], dq1[L::kW1 > 0 ? L::kW1 / 2 : 1];
  float sc[kN / 2], dp[kN / 2];  // S and dP of a key tile, then p and dS in place
  uint32_t ds[kN / 16][4];       // dS, the A operand of dQ += dS K
  zero(dq0);
  zero(dq1);
  // S = Q K^T and, with dP, dP = dO V^T of the key tile in stage s, issued
  // as one group.
  auto scores = [&](int s, bool with_dp) {
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
    product_abt<D, L, kN>(sc, qa0, qa1, base + L::tile(s, 0));
    if (with_dp) product_abt<D, L, kN>(dp, da0, da1, base + L::tile(s, 1));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
  };
  // K4, K15: sc <- the scores of the key tile in stage s in log2 units,
  // their key bias added by the same FMA in every sweep and both kernels.
  auto scores_log2 = [&](int s) {
    const float* kb = vecs + s * kVecs * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(kb + 8 * j + 2 * ln.quad);
      sc[4 * j] = fmaf(sc[4 * j], fwd::kLog2e, k2.x);
      sc[4 * j + 1] = fmaf(sc[4 * j + 1], fwd::kLog2e, k2.y);
      sc[4 * j + 2] = fmaf(sc[4 * j + 2], fwd::kLog2e, k2.x);
      sc[4 * j + 3] = fmaf(sc[4 * j + 3], fwd::kLog2e, k2.y);
    }
  };
  // dp <- dS of key tile i in stage s: K7's p (dP - di) scale, p = 0 for
  // keys past T or of another segment; K4's and K15's p (dP - delta).
  auto grads = [&](int i, int s) {
    if constexpr (P::kK4) {
      scores_log2(s);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        dp[4 * j] = (dp[4 * j] - d0) * prob<P>(sc[4 * j], c0, r0);
        dp[4 * j + 1] = (dp[4 * j + 1] - d0) * prob<P>(sc[4 * j + 1], c0, r0);
        dp[4 * j + 2] = (dp[4 * j + 2] - d1) * prob<P>(sc[4 * j + 2], c1, r1);
        dp[4 * j + 3] = (dp[4 * j + 3] - d1) * prob<P>(sc[4 * j + 3], c1, r1);
      }
    } else {
      const int n_valid = a.T - i * kN;
      const float* ids = vecs + s * kVecs * kN;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = 8 * j + 2 * ln.quad;
        bool in00 = c < n_valid, in01 = c + 1 < n_valid;
        bool in10 = in00, in11 = in01;
        if constexpr (P::kSeg) {
          const int2 id = *reinterpret_cast<const int2*>(ids + c);
          in00 = in00 && id.x == seg0;
          in01 = in01 && id.y == seg0;
          in10 = in10 && id.x == seg1;
          in11 = in11 && id.y == seg1;
        }
        const float p00 = in00 ? fwd::fast_exp2(fmaf(sc[4 * j], ex, -c0)) : 0.0f;
        const float p01 = in01 ? fwd::fast_exp2(fmaf(sc[4 * j + 1], ex, -c0)) : 0.0f;
        const float p10 = in10 ? fwd::fast_exp2(fmaf(sc[4 * j + 2], ex, -c1)) : 0.0f;
        const float p11 = in11 ? fwd::fast_exp2(fmaf(sc[4 * j + 3], ex, -c1)) : 0.0f;
        dp[4 * j] = (dp[4 * j] - d0) * p00 * a.scale;
        dp[4 * j + 1] = (dp[4 * j + 1] - d0) * p01 * a.scale;
        dp[4 * j + 2] = (dp[4 * j + 2] - d1) * p10 * a.scale;
        dp[4 * j + 3] = (dp[4 * j + 3] - d1) * p11 * a.scale;
      }
    }
  };
  auto release = [&](int s) {
    if (ln.lane == 0) hopper::mbar_arrive(bars + 8 + 8 * (kStages + s));
  };

  hopper::mbar_wait(bars, 0);
  if constexpr (P::kK4) {  // Q (+ bq) times the scale: this warpgroup's rows
    fwd::transform_tile<D, P::kBias, true, 4>(base + L::res(0), L::kResBlk0,
                                              P::kBias ? a.bq + h * D : nullptr,
                                              scale_pair(a.scale), threadIdx.x % 128,
                                              64 * ln.wg, 64);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + ln.wg, 128);
  }
  if constexpr (P::kSweep) {
    // The first sweep, ring iterations 0 .. n_tiles - 1: the rows' online
    // max m and sum l (kML), u = sum_j p dp against the lse (Stats) or
    // sum_j e dp against the running max, rescaled with it (Recompute).
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
    for (int i = 0; i < n_first; ++i) {
      const int s = i % kStages;
      hopper::mbar_wait(bars + 8 + 8 * s, (i / kStages) & 1);
      scores(s, P::kSweepU);
      scores_log2(s);
      if constexpr (!P::kML) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          u0 += fwd::fast_exp2(sc[4 * j] - c0) * dp[4 * j] +
                fwd::fast_exp2(sc[4 * j + 1] - c0) * dp[4 * j + 1];
          u1 += fwd::fast_exp2(sc[4 * j + 2] - c1) * dp[4 * j + 2] +
                fwd::fast_exp2(sc[4 * j + 3] - c1) * dp[4 * j + 3];
        }
      } else {
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // Finite: every tile holds a key below T, whose bias is 0 or -1e30.
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = fwd::fast_exp2(m0 - mn0), alpha1 = fwd::fast_exp2(m1 - mn1);
        float ps0 = 0.0f, ps1 = 0.0f, us0 = 0.0f, us1 = 0.0f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const float e00 = fwd::fast_exp2(sc[4 * j] - mn0);
          const float e01 = fwd::fast_exp2(sc[4 * j + 1] - mn0);
          const float e10 = fwd::fast_exp2(sc[4 * j + 2] - mn1);
          const float e11 = fwd::fast_exp2(sc[4 * j + 3] - mn1);
          ps0 += e00 + e01;
          ps1 += e10 + e11;
          if constexpr (P::kSweepU) {
            us0 += e00 * dp[4 * j] + e01 * dp[4 * j + 1];
            us1 += e10 * dp[4 * j + 2] + e11 * dp[4 * j + 3];
          }
        }
        l0 = fmaf(l0, alpha0, ps0);
        l1 = fmaf(l1, alpha1, ps1);
        if constexpr (P::kSweepU) {
          u0 = fmaf(u0, alpha0, us0);
          u1 = fmaf(u1, alpha1, us1);
        }
        m0 = mn0;
        m1 = mn1;
      }
      release(s);
    }
    // The row sums over the 4 lanes that share each row.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    u0 += __shfl_xor_sync(0xffffffffu, u0, 1);
    u0 += __shfl_xor_sync(0xffffffffu, u0, 2);
    u1 += __shfl_xor_sync(0xffffffffu, u1, 1);
    u1 += __shfl_xor_sync(0xffffffffu, u1, 2);
    if constexpr (P::kML) {
      c0 = m0;
      c1 = m1;
      r0 = 1.0f / l0;
      r1 = 1.0f / l1;
    }
    if constexpr (P::kSweepU) {
      d0 = P::kML ? u0 / l0 : u0;
      d1 = P::kML ? u1 / l1 : u1;
    }
    if (ln.quad == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? t1 : t0;
        if (t >= a.T) continue;
        if constexpr (P::kSweepU) a.di[stat + t] = half ? d1 : d0;
        if constexpr (P::kML) {
          a.row_m[stat + t] = half ? m1 : m0;
          a.row_l[stat + t] = half ? l1 : l0;
        }
      }
    }
  }
  // The dq sweep, ring iterations n_first .. n_first + n_tiles - 1.
  for (int j = 0; j < n_tiles; ++j) {
    const int i = n_first + j, s = i % kStages;
    hopper::mbar_wait(bars + 8 + 8 * s, (i / kStages) & 1);
    scores(s, true);
    grads(j, s);
    pack_a<kN>(ds, dp);
    hopper::fence_regs(dq0);
    hopper::fence_regs(dq1);
    hopper::wgmma_fence();
    product_ab<L, kN>(dq0, dq1, ds, base + L::tile(s, 0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq0);
    hopper::fence_regs(dq1);
    release(s);
  }
  if constexpr (P::kK4) {
    scale_by(dq0, a.sm_scale);
    scale_by(dq1, a.sm_scale);
  }
  store_rows<D, L>(a.out0, out_stride<D, P>(a), dq0, dq1, b, h, t0, a.T, ln.quad);
  if constexpr (P::kBias)
    column_sums<D, L>(bias_part<D>(a, b, h, 0), reinterpret_cast<float*>(smem + L::sum(0)), dq0,
                      dq1, ln, t0, a.T);
}

// The key-major kernel's block: dk and dv of 128 keys.
template <int D, class P>
__device__ __forceinline__ void dkv(const Maps& maps, const Args& a) {
  using L = DkvLayout<D, P>;
  constexpr int kN = L::kN, kVecs = L::kVecs, kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const float* vecs = reinterpret_cast<const float*>(smem + L::kVec);
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (a.T + kN - 1) / kN;  // queries past T add nothing: do = 0 there
  const uint32_t bars = base + L::kBars;
  init_bars<L>(bars);
  if (threadIdx.x < 128) {
    const long long stat = ((long long)b * a.H + h) * a.T;
    produce<L>(
        maps, base, k0, h, b, 0, n_tiles,
        [&](int q, uint32_t* w) {
          const bool in = q < a.T;
          if constexpr (P::kK4) {  // c, 1 / l (kML), delta
            w[0] = __float_as_uint(P::kML ? (in ? a.row_m[stat + q] : INFINITY)
                                          : row_lse(a, b, h, q));
            if constexpr (P::kML) w[1] = __float_as_uint(in ? 1.0f / a.row_l[stat + q] : 1.0f);
            w[kVecs - 1] = __float_as_uint(in ? a.di[stat + q] : 0.0f);
          } else {
            w[0] = __float_as_uint(row_c(a, b, h, q));
            w[1] = __float_as_uint(in ? a.di[stat + q] : 0.0f);
            if constexpr (P::kSeg) w[2] = in ? (uint32_t)a.seg[(long long)b * a.Tk + q] : 0u;
          }
        },
        [&](int s, bool) {  // K4, K15: Q (+ bq) times the scale
          if constexpr (P::kK4)
            fwd::transform_tile<D, P::kBias, true, 4>(base + L::tile(s, 0), L::kBlk0,
                                                      P::kBias ? a.bq + h * D : nullptr,
                                                      scale_pair(a.scale), threadIdx.x, 0, kN);
        });
    return;
  }
  hopper::reg_alloc<L::kConsumer>();
  const Lane ln;
  const int r0 = k0 + 64 * ln.wg + ln.row, r1 = r0 + 8;  // this thread's keys
  int seg0 = 0, seg1 = 0;
  if constexpr (P::kSeg) {
    const int* seg = a.seg + (long long)b * a.Tk;
    seg0 = r0 < a.T ? seg[r0] : 0;
    seg1 = r1 < a.T ? seg[r1] : 0;
  }
  float kb0 = 0.0f, kb1 = 0.0f;  // K4, K15: the keys' bias in log2 units
  if constexpr (P::kK4) {
    kb0 = key_bias_log2(a, b, r0);
    kb1 = key_bias_log2(a, b, r1);
  }
  const float ex = a.scale * fwd::kLog2e;
  const uint32_t ka0 = base + L::res(0) + ln.wg * 64 * 128;
  const uint32_t ka1 = base + L::res(0) + L::kResBlk0 + ln.wg * 64 * L::kRB1;
  const uint32_t va0 = base + L::res(1) + ln.wg * 64 * 128;
  const uint32_t va1 = base + L::res(1) + L::kResBlk0 + ln.wg * 64 * L::kRB1;

  float dk0[32], dk1[L::kW1 > 0 ? L::kW1 / 2 : 1], dv0[32], dv1[L::kW1 > 0 ? L::kW1 / 2 : 1];
  float st[kN / 2], dpt[kN / 2];  // S^T and dP^T of a query tile, then P^T and dS^T
  uint32_t pa[kN / 16][4], da[kN / 16][4];  // P^T and dS^T as A operands
  zero(dk0);
  zero(dk1);
  zero(dv0);
  zero(dv1);
  // S^T = K Q^T and dP^T = V dO^T of the query tile in stage s, one group.
  auto scores = [&](int s) {
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
    product_abt<D, L, kN>(st, ka0, ka1, base + L::tile(s, 0));
    product_abt<D, L, kN>(dpt, va0, va1, base + L::tile(s, 1));
    hopper::wgmma_commit();
  };
  // st <- P^T and dpt <- dS^T per column (query) of the tile in stage s,
  // from the row stats staged beside it.
  auto grads = [&](int s) {
    const float* cs = vecs + s * kVecs * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = 8 * j + 2 * ln.quad;
      const float2 c = *reinterpret_cast<const float2*>(cs + col);
      float p00, p01, p10, p11;
      float2 di;
      if constexpr (P::kK4) {
        di = *reinterpret_cast<const float2*>(cs + (kVecs - 1) * kN + col);
        float2 r = make_float2(1.0f, 1.0f);
        if constexpr (P::kML) r = *reinterpret_cast<const float2*>(cs + kN + col);
        p00 = prob<P>(fmaf(st[4 * j], fwd::kLog2e, kb0), c.x, r.x);
        p01 = prob<P>(fmaf(st[4 * j + 1], fwd::kLog2e, kb0), c.y, r.y);
        p10 = prob<P>(fmaf(st[4 * j + 2], fwd::kLog2e, kb1), c.x, r.x);
        p11 = prob<P>(fmaf(st[4 * j + 3], fwd::kLog2e, kb1), c.y, r.y);
        dpt[4 * j] = (dpt[4 * j] - di.x) * p00;
        dpt[4 * j + 1] = (dpt[4 * j + 1] - di.y) * p01;
        dpt[4 * j + 2] = (dpt[4 * j + 2] - di.x) * p10;
        dpt[4 * j + 3] = (dpt[4 * j + 3] - di.y) * p11;
      } else {
        di = *reinterpret_cast<const float2*>(cs + kN + col);
        p00 = fwd::fast_exp2(fmaf(st[4 * j], ex, -c.x));
        p01 = fwd::fast_exp2(fmaf(st[4 * j + 1], ex, -c.y));
        p10 = fwd::fast_exp2(fmaf(st[4 * j + 2], ex, -c.x));
        p11 = fwd::fast_exp2(fmaf(st[4 * j + 3], ex, -c.y));
        if constexpr (P::kSeg) {
          const int2 id = *reinterpret_cast<const int2*>(cs + 2 * kN + col);
          if (id.x != seg0) p00 = 0.0f;
          if (id.y != seg0) p01 = 0.0f;
          if (id.x != seg1) p10 = 0.0f;
          if (id.y != seg1) p11 = 0.0f;
        }
        dpt[4 * j] = (dpt[4 * j] - di.x) * p00 * a.scale;
        dpt[4 * j + 1] = (dpt[4 * j + 1] - di.y) * p01 * a.scale;
        dpt[4 * j + 2] = (dpt[4 * j + 2] - di.x) * p10 * a.scale;
        dpt[4 * j + 3] = (dpt[4 * j + 3] - di.y) * p11 * a.scale;
      }
      st[4 * j] = p00;
      st[4 * j + 1] = p01;
      st[4 * j + 2] = p10;
      st[4 * j + 3] = p11;
    }
  };
  hopper::mbar_wait(bars, 0);
  if constexpr (P::kBias) {  // K + bk, V + bv: this warpgroup's rows
    const int t = threadIdx.x % 128;
    fwd::transform_tile<D, true, false, 4>(base + L::res(0), L::kResBlk0, a.bk + h * D, 0u, t,
                                           64 * ln.wg, 64);
    fwd::transform_tile<D, true, false, 4>(base + L::res(1), L::kResBlk0, a.bv + h * D, 0u, t,
                                           64 * ln.wg, 64);
    hopper::fence_proxy_async();
    hopper::named_barrier(1 + ln.wg, 128);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(bars + 8 + 8 * s, (i / kStages) & 1);
    scores(s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    grads(s);
    pack_a<kN>(pa, st);
    pack_a<kN>(da, dpt);
    hopper::fence_regs(dv0);
    hopper::fence_regs(dv1);
    hopper::fence_regs(dk0);
    hopper::fence_regs(dk1);
    hopper::wgmma_fence();
    product_ab<L, kN>(dv0, dv1, pa, base + L::tile(s, 1));
    product_ab<L, kN>(dk0, dk1, da, base + L::tile(s, 0));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv0);
    hopper::fence_regs(dv1);
    hopper::fence_regs(dk0);
    hopper::fence_regs(dk1);
    if (ln.lane == 0) hopper::mbar_arrive(bars + 8 + 8 * (kStages + s));
  }
  const long long ld = out_stride<D, P>(a);
  store_rows<D, L>(a.out0, ld, dk0, dk1, b, h, r0, a.T, ln.quad);
  store_rows<D, L>(a.out1, ld, dv0, dv1, b, h, r0, a.T, ln.quad);
  if constexpr (P::kBias) {
    column_sums<D, L>(bias_part<D>(a, b, h, 1), reinterpret_cast<float*>(smem + L::sum(0)), dk0,
                      dk1, ln, r0, a.T);
    column_sums<D, L>(bias_part<D>(a, b, h, 2), reinterpret_cast<float*>(smem + L::sum(1)), dv0,
                      dv1, ln, r0, a.T);
  }
}

// The maps of one operand (a (B, T, H*D) bf16 tensor with these strides):
// its column blocks with boxes `rows` rows tall; 0 or the encoder's error.
template <int D>
int encode_operand(CUtensorMap (&m)[2], const void* ptr, int B, int T, int H, long long stride_b,
                   long long stride_t, int rows) {
  constexpr int kW1 = fwd::Tile<D, 2>::kW1;
  int err = hopper::encode_heads(&m[0], ptr, D, H, T, B, stride_t, stride_b, 64, rows);
  if (err != 0 || kW1 == 0) return err;
  if (kW1 == 64) {
    m[1] = m[0];
    return 0;
  }
  return hopper::encode_heads(&m[1], ptr, D, H, T, B, stride_t, stride_b, kW1, rows);
}

// The maps of one launch: q, k, v with the given strides, do contiguous; the
// dq kernel holds q, do and streams k, v, the dkv kernel the other way round.
template <int D>
int encode(Maps* m, bool dq_kernel, const void* q, const void* k, const void* v, const void* dout,
           int B, int T, int H, long long stride_b, long long stride_t) {
  struct Operand {
    const void* ptr;
    long long stride_b, stride_t;
  };
  const long long HD = (long long)H * D;
  const Operand qo{q, stride_b, stride_t}, ko{k, stride_b, stride_t}, vo{v, stride_b, stride_t},
      doo{dout, T * HD, HD};
  const Operand own[2] = {dq_kernel ? qo : ko, dq_kernel ? doo : vo};
  const Operand other[2] = {dq_kernel ? ko : qo, dq_kernel ? vo : doo};
  const int n = dq_kernel ? dq_tile(D) : dkv_tile(D);  // the streamed tiles' rows
  for (int i = 0; i < 2; ++i) {
    int err = encode_operand<D>(m->res[i], own[i].ptr, B, T, H, own[i].stride_b,
                                own[i].stride_t, kRows);
    if (err == 0)
      err = encode_operand<D>(m->str[i], other[i].ptr, B, T, H, other[i].stride_b,
                              other[i].stride_t, n);
    if (err != 0) return err;
  }
  return 0;
}

// Encodes the maps and launches `kernel` (the dq kernel over dq() with
// kDq, else the dkv kernel over dkv(), policy P) on `s`; the encoder's error
// or the cudaError_t.
template <int D, class P, bool kDq, typename Kernel>
int launch(Kernel kernel, const void* q, const void* k, const void* v, const Args& args, int B,
           long long stride_b, long long stride_t, cudaStream_t s) {
  constexpr int kSmem = kDq ? DqLayout<D, P>::kSmem : DkvLayout<D, P>::kSmem;
  Maps maps;
  const int enc = encode<D>(&maps, kDq, q, k, v, args.dout, B, args.T, args.H, stride_b,
                            stride_t);
  if (enc != 0) return enc;
  // Once per kernel and process, as the forwards'.
  static const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((args.T + kRows - 1) / kRows), (unsigned)args.H, (unsigned)B);
  kernel<<<grid, kThreads, kSmem, s>>>(maps, args);
  return (int)cudaGetLastError();
}

// The arguments of a short-T pair (K4, K15): q, k, v as the forward took
// them; dout, o (K4, Ctx) (B, T, H*D) bf16 contiguous; lse (K4, Stats) and
// the scratch m, l (Recompute, Ctx) and delta, (B, H, T) fp32; bq, bk, bv
// and db_part with K4's biases; scale the bf16 scale of q, sm_scale dq's.
inline Args short_t_args(const void* dout, const void* o, const void* lse, const void* bq,
                         const void* bk, const void* bv, const void* key_bias, void* m, void* l,
                         void* delta, void* db_part, int T, int H, long long stride_d,
                         float scale, float sm_scale) {
  Args a{};
  a.o = static_cast<const bf16*>(o);
  a.dout = static_cast<const bf16*>(dout);
  a.di = static_cast<float*>(delta);
  a.T = a.Tk = T;
  a.H = H;
  a.scale = scale;
  a.lse = static_cast<const float*>(lse);
  a.bq = static_cast<const bf16*>(bq);
  a.bk = static_cast<const bf16*>(bk);
  a.bv = static_cast<const bf16*>(bv);
  a.key_bias = static_cast<const float*>(key_bias);
  a.row_m = static_cast<float*>(m);
  a.row_l = static_cast<float*>(l);
  a.db_part = static_cast<float*>(db_part);
  a.stride_d = stride_d;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace bwd

// The short-T pair of policy P (bwd::K4<kBias>, Stats, Recompute, Ctx): the
// query-major kernel (dq of 128 query rows, their delta and, with kML, m and
// l) and the key-major kernel (dk, dv of 128 keys, from them).
template <int D, class P>
__global__ void __launch_bounds__(bwd::kThreads, 1)
    attention_bwd_dq_kernel(const __grid_constant__ bwd::Maps maps, const bwd::Args args) {
  bwd::dq<D, P>(maps, args);
}

template <int D, class P>
__global__ void __launch_bounds__(bwd::kThreads, 1)
    attention_bwd_dkv_kernel(const __grid_constant__ bwd::Maps maps, const bwd::Args args) {
  bwd::dkv<D, P>(maps, args);
}

namespace bwd {

// Launches policy P's pair on `s`, the dq kernel first: dq, dk, dv (B, T,
// H*D) bf16 with the row stride args.stride_d. The encoder's error or the
// cudaError_t of the first launch that failed.
template <int D, class P>
int launch_pair(const void* q, const void* k, const void* v, Args args, void* dq, void* dk,
                void* dv, int B, long long stride_b, long long stride_t, cudaStream_t s) {
  args.out0 = static_cast<bf16*>(dq);
  int err = launch<D, P, true>(attention_bwd_dq_kernel<D, P>, q, k, v, args, B, stride_b,
                               stride_t, s);
  if (err != 0) return err;
  args.out0 = static_cast<bf16*>(dk);
  args.out1 = static_cast<bf16*>(dv);
  return launch<D, P, false>(attention_bwd_dkv_kernel<D, P>, q, k, v, args, B, stride_b,
                             stride_t, s);
}

}  // namespace bwd

}  // namespace
