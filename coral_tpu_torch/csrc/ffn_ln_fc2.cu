// The LayerNorm-folded block's forward with fc2 in the kernel (N7), the route
// of `fused_ffn_block_fc2: true`: y = dropout(gelu(bf16(layer_norm(x)) W1^T
// + b1)) W2^T + b2, g never in device memory. Its backward is N5
// (csrc/ffn_ln_g.cu).
//
// Replaces: coral_tpu/ops/ffn_pallas.py `_fwd_pallas_ln_fc2` :924 ->
// `_fwd_kernel_ln_fc2` :451 (rate 0) and `_fwd_kernel_ln_fc2_drop` :467
// (rate > 0). g is rounded to bf16 before fc2, and the fc2 sum is fp32 plus
// b2, rounded once to bf16: the rounding of the composed `_fc2` :1677, bit
// for bit in exact arithmetic.
//
// Bound on the H100: the tensor cores: two products of 2 * D * F flops per
// row (fc1, fc2) against 2 KB of x in and 2 KB of y out at D = 1024 (2.5 KB
// each at 1280), and the weights once.
//
// Design: fc2 contracts over the whole of F, so every y element sums over
// every F tile of h. The TPU kernel holds all of F and D in VMEM; a block
// cannot hold a 128-row y in fp32 (512 KB at 1024), splitting F over
// independent blocks would move fp32 partials of y larger than g, and
// splitting y's columns would recompute h. So the kernel is launched as
// thread-block clusters of C blocks (`cluster_size`: D / 128 up to 1024, 8
// at 1280, 15 at 1920) that share one 128-row tile, each block of csrc/ffn_gemm.cuh's
// mainloop shape (a producer warpgroup, two consumer warpgroups of 64 rows,
// setmaxnreg 40 / 232). First the cluster's LayerNorm, once: block r
// normalises rows r, r + C, .. of the tile with gemm::row_stats' and
// gemm::normalise's arithmetic, rounds them to bf16 into the `ln` scratch
// (M x D, L2-resident) and the cluster meets at a barrier. Then block r:
//  1. fc1: computes the h tiles r, r + C, r + 2C, .. (128 columns each, one a
//     round) from ln and W1 chunks by TMA through the mbarrier ring, the
//     same wgmma m64n128k16 over the same 64-deep chunks of the same bf16
//     operand as gemm::Fwd and N5, so N7's g is N5's bit for bit; + b1, the
//     polynomial GELU, the Philox mask and 1/keep (gemm::stage_half's
//     arithmetic), rounded once to bf16 into one of the block's two g
//     buffers in shared memory, stored in the order of wgmma's register
//     A fragments (16 bytes a thread and k-step);
//  2. fc2: owns y's columns [r NY, (r+1) NY), NY = D / C, in fp32 registers
//     for the whole F loop. After a round's cluster barrier it adds, for each
//     of the round's peers from its own rank on (so that no two blocks read
//     one peer's shared memory at once), g_q W2[own columns, tile of q]^T:
//     the A operand read from peer q's g buffer through distributed shared
//     memory (16-byte ld.shared::cluster into registers, a tile's second
//     64-deep half, or the next tile's first, loaded while the current
//     half's products run), the W2 chunks (NY x 64, K-major, the tensor map
//     on W2 as stored, (D, F)) by TMA through the same ring, wgmma with A
//     from registers (NY = 128, or 160 as pieces of 128 and 32);
//  3. the epilogue: + b2, rounded once to bf16, rows below M stored.
// One cluster barrier a round orders the writes and reads of the two g
// buffers: a block writes buffer j % 2 in round j only after every peer
// passed round j - 1's barrier, so after it read round j - 2's. Every thread
// of the cluster joins each barrier; the producer warp between its copies,
// once the round's first W2 chunks are in flight. Each y column's sum runs in
// a fixed order (round by round, the owner's peer order): two calls give the
// same bits. Each cluster reads W1 and W2 once a 128-row tile (the WMMA
// kernel this replaces read both once a 16-row block), and each block the
// tile's ln rows once an h tile. Timed on an H100 from edited copies
// (coral_tpu_torch/tools/probe_ffn.py, PERF.md §6): every block reading its
// peers in rank order from 0, and the LayerNorm applied to each streamed x
// chunk as the mainloop does (twice the pass's work a flop at 128-column
// tiles), were 1.3x and 1.5x slower; a whole peer tile of A prefetched (64
// registers, not 32) spilled at 1280 and was 1.1x slower there; pushing each
// g tile to every block by bulk copies into two receive slots, for wgmma
// with A from shared memory, was 1.1-1.3x slower.
#include "ffn_gemm.cuh"

namespace {
namespace fc2 {

using gemm::kChunk;
using gemm::kRows;
using gemm::kThreads;

// The blocks of a cluster at width D: each owns NY = D / C of y's columns, a
// multiple of 32 within wgmma's 256, and C divides the F / 128 = D / 32 h
// tiles at F = 4 D: D / 128 up to the portable cluster size 8 (128 columns
// and 4 rounds a block; 160 and 5 at 1280), and 15 at 1920 (128 and 4; a
// non-portable size, timed on an H100 against 8, 10 and 12: PERF.md §6).
__host__ __device__ constexpr int cluster_size(int D) {
  return D == 1920 ? 15 : D / 128 < 8 ? D / 128 : 8;
}

// The instantiation (width, dropout) and its shared memory: the ring (an ln
// chunk and a W1 tile for fc1, a W2 chunk for fc2), two g buffers, the
// mbarriers, and 1 KB to align the base.
template <int D_, bool kDrop_>
struct Shape {
  static constexpr int D = D_;
  static constexpr bool kDrop = kDrop_;
  static constexpr int C = cluster_size(D);
  static constexpr int NY = D / C;
  static constexpr int kStages = 4;
  static constexpr int kATile = kRows * kChunk * 2;    // 16 KB: an ln chunk
  static constexpr int kStage = 2 * kATile;            // ln chunk + W1 tile (128 x 64)
  static constexpr int kGBuf = kRows * 128 * 2;        // 32 KB: a 128 x 128 g tile
  static constexpr int kG = kStages * kStage;
  static constexpr int kBars = kG + 2 * kGBuf;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  static_assert(C * NY == D && NY % 32 == 0 && NY <= 256, "whole wgmma pieces a block");
  static_assert(NY * 128 <= kStage, "a W2 chunk fits a stage");
  static_assert(kSmem <= gemm::kMaxSmem, "the ring and the g buffers must fit a block");
};

struct Maps {
  CUtensorMap ln, w1, w2;  // ln: the normalised rows, a.ln_out
};

struct Args {
  gemm::Args a;      // x, b1, gamma, beta, seeds, ln_out (M, D), M, T, threshold, scale, eps
  const float* b2;   // (D,) fp32
  bf16* y;           // (M, D)
  int n_tiles;       // F / 128 h tiles
};

// Block r's ring iterations, round by round: round j takes h tile r + C j
// (D / 64 chunks of ln and W1) if there is one, then two 64-deep W2 chunks
// for each tile of the round (q + C j < n_tiles, peers q in `peer` order).
// Every round but the last is whole for every block.
struct Sched {
  int r, C, n_tiles, n_k1, rounds, full;
  __device__ Sched(int r_, int C_, int n_tiles_, int n_k1_)
      : r(r_), C(C_), n_tiles(n_tiles_), n_k1(n_k1_) {
    rounds = (n_tiles + C - 1) / C;
    full = n_k1 + 2 * C;
  }
  __device__ bool own(int j) const { return r + C * j < n_tiles; }
  __device__ int peers(int j) const { return min(C, n_tiles - C * j); }
  // The k-th peer whose g tile round j's fc2 reads: rank order from the
  // block's own rank on, so that the C blocks never all read one block's
  // shared memory at once.
  __device__ int peer(int j, int k) const { return (r + k) % peers(j); }
  __device__ int start(int j) const { return j * full; }
  __device__ int fc2_start(int j) const { return start(j) + (own(j) ? n_k1 : 0); }
  __device__ int n_iter() const { return fc2_start(rounds - 1) + 2 * peers(rounds - 1); }
};

// y[Off / 2 ..] += A B^T for the NY - Off columns from Off of the W2 chunk at
// `b` (k-step's 32-byte offset applied), in wgmma pieces of 128 and 32.
template <int Rem, int Off, int NYH>
__device__ __forceinline__ void y_products(float (&y)[NYH], const uint32_t (&a)[4], uint32_t b) {
  if constexpr (Rem > 0) {
    constexpr int N = Rem >= 128 ? 128 : 32;
    hopper::wgmma_rs_k<N>(*reinterpret_cast<float(*)[N / 2]>(y + Off / 2), a,
                          hopper::smem_desc(b + Off * 128, 1024, 128));
    y_products<Rem - N, Off + N, NYH>(y, a, b);
  }
}

// Rows m0 + rr of the cluster's tile, rr = r + C w, r + C (w + 12), .. for the
// block's warp w, normalised to bf16 into a.ln_out with the arithmetic of
// gemm::row_stats and gemm::normalise (the statistics of a row by one warp,
// its lane vectors summed in order, the warp's butterfly, then the centred
// squares; ((x - mean) rstd) gamma + beta rounded once): the bits N5's pass
// gives its A operand, so N7's g is N5's. Rows past M are not written (the
// tensor map gives zeros there).
template <int D>
__device__ __forceinline__ void ln_rows(const gemm::Args& a, long long m0, int r, int C) {
  constexpr int V = coral_row_vec<bf16>(D);
  constexpr int kVecs = D / (32 * V);
  static_assert(kVecs * 32 * V == D, "a lane owns whole vectors of the row");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int rr = r + C * warp; rr < kRows; rr += C * (kThreads / 32)) {
    const long long row = m0 + rr;
    if (row >= a.M) break;  // uniform over the warp
    float v[kVecs * V];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) coral_loadv<V>(a.x + row * D + (i * 32 + lane) * V, v + i * V);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kVecs * V; ++e) s += v[e];
    const float mean = coral_warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < kVecs * V; ++e) {
      v[e] -= mean;
      q += v[e] * v[e];
    }
    const float rstd = rsqrtf(coral_warp_sum(q) / D + a.eps);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int col = (i * 32 + lane) * V;
      float ga[V], be[V], out[V];
      coral_loadv<V>(a.gamma + col, ga);
      coral_loadv<V>(a.beta + col, be);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = (v[i * V + e] * rstd) * ga[e] + be[e];
      coral_storev<V>(a.ln_out + row * D + col, out);
    }
  }
}

template <class S>
__device__ __forceinline__ void consume(const Args& args, uint32_t base, const Sched& sc,
                                        long long m0) {
  using gemm::Lane;
  const gemm::Args& a = args.a;
  constexpr int kS = S::kStages;
  hopper::reg_alloc<gemm::kConsumerRegs>();
  const Lane ln;
  const long long r0 = m0 + 64 * ln.wg + ln.row;
  uint32_t t_mine = 0u, seed_mine = 0u;  // the mask's row of this thread's Philox calls
  if constexpr (S::kDrop) {
    const long long mine = r0 + ((ln.quad & 1) ? 8 : 0);
    if (mine < a.M) {
      t_mine = (uint32_t)(mine % a.T);
      seed_mine = (uint32_t)a.seeds[mine / a.T];
    }
  }
  const gemm::Ring<kS> ring{base + S::kBars};
  const uint32_t a_rows = ln.wg * 64 * 128;  // the warpgroup's rows of the ln chunk
  // This thread's 16 bytes of k-step s of a g buffer: fragment order.
  const uint32_t frag = (uint32_t)((4 * ln.wg + ln.warp) * 8 * 512 + ln.lane * 16);
  float y[S::NY / 2];
#pragma unroll
  for (int e = 0; e < S::NY / 2; ++e) y[e] = 0.f;

#pragma unroll 1
  for (int j = 0; j < sc.rounds; ++j) {
    const uint32_t gbuf = base + S::kG + (j & 1) * S::kGBuf + frag;
    int i = sc.start(j);
    if (sc.own(j)) {
      // fc1: h of tile t (128 columns) over the D / 64 chunks of ln and W1.
      const int n0 = (sc.r + sc.C * j) * 128;
      float h[64];
      ring.template consume<S::kStage>(base, i, sc.n_k1, ln.lane, [&](uint32_t st, bool first) {
        hopper::fence_regs(h);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_m64n128k16_ss(h, hopper::smem_desc(st + a_rows + 32 * kk, 1024, 128),
                                      hopper::smem_desc(st + S::kATile + 32 * kk, 1024, 128),
                                      !first || kk > 0);
      });
      hopper::fence_regs(h);
      i += sc.n_k1;
      // g = dropout(gelu(h + b1)) in bf16, k-step s of the tile: groups 2s and
      // 2s + 1 of the accumulator, the A fragment's four registers.
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        float v[8];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int jj = 2 * s + e2;
          const float2 bb = *reinterpret_cast<const float2*>(a.b1 + n0 + 8 * jj + 2 * ln.quad);
          float* w = v + 4 * e2;
          w[0] = coral_gelu(h[4 * jj] + bb.x), w[1] = coral_gelu(h[4 * jj + 1] + bb.y);
          w[2] = coral_gelu(h[4 * jj + 2] + bb.x), w[3] = coral_gelu(h[4 * jj + 3] + bb.y);
          if constexpr (S::kDrop) {
            bool k0[2], k1[2];
            gemm::keep_pairs((uint32_t)(n0 + 8 * jj) >> 2, ln.quad, t_mine, seed_mine,
                             a.threshold, k0, k1);
            w[0] = k0[0] ? w[0] * a.scale : 0.f;
            w[1] = k0[1] ? w[1] * a.scale : 0.f;
            w[2] = k1[0] ? w[2] * a.scale : 0.f;
            w[3] = k1[1] ? w[3] * a.scale : 0.f;
          }
        }
        hopper::st_shared_v4(gbuf + s * 512,
                             make_uint4(gemm::pack_bf16(v[0], v[1]), gemm::pack_bf16(v[2], v[3]),
                                        gemm::pack_bf16(v[4], v[5]), gemm::pack_bf16(v[6], v[7])));
      }
    }
    hopper::cluster_sync();  // the round's g tiles are written; round j - 1's reads done
    // fc2: y += g_q W2[own columns, tile of q]^T for the round's peers q =
    // sc.peer(j, k), k = 0, 1, .. (rank order from the block's own rank on),
    // each tile in two 64-deep halves, one ring iteration of W2 each, their A
    // fragments in registers (a0: k-steps 0-3, a1: 4-7), the next half
    // loaded while the current one's products run.
    const int n_peers = sc.peers(j);
    uint32_t a0[4][4], a1[4][4];
    auto load_a = [&](uint32_t (&af)[4][4], int q, int half) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint4 v = hopper::ld_cluster_v4(hopper::map_to_rank(gbuf + (4 * half + s) * 512, q));
        af[s][0] = v.x, af[s][1] = v.y, af[s][2] = v.z, af[s][3] = v.w;
      }
    };
    auto products = [&](const uint32_t (&af)[4][4], int it) {
      const uint32_t st = base + (it % kS) * S::kStage;
      ring.wait_full(it);
      hopper::fence_regs(y);
      hopper::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) y_products<S::NY, 0, S::NY / 2>(y, af[s], st + 32 * s);
      hopper::wgmma_commit();
    };
    load_a(a0, sc.peer(j, 0), 0);
#pragma unroll 1
    for (int k = 0; k < n_peers; ++k) {
      products(a0, i);
      if (k > 0) {
        hopper::wgmma_wait<1>();  // the previous half's products: a1 and its stage are free
        if (ln.lane == 0) ring.release(i - 1);
      }
      load_a(a1, sc.peer(j, k), 1);
      products(a1, ++i);
      hopper::wgmma_wait<1>();  // a0 and its stage are free
      if (ln.lane == 0) ring.release(i - 1);
      if (k + 1 < n_peers) load_a(a0, sc.peer(j, k + 1), 0);
      ++i;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(y);
    if (ln.lane == 0) ring.release(i - 1);
  }

  // y + b2, rounded once; rows below M, columns of this block.
  const int c0 = sc.r * S::NY + 2 * ln.quad;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = r0 + 8 * half;
    if (row >= a.M) continue;
#pragma unroll
    for (int J = 0; J < S::NY / 8; ++J) {
      const int col = c0 + 8 * J;
      const float2 bb = *reinterpret_cast<const float2*>(args.b2 + col);
      *reinterpret_cast<uint32_t*>(args.y + row * S::D + col) =
          gemm::pack_bf16(y[4 * J + 2 * half] + bb.x, y[4 * J + 2 * half + 1] + bb.y);
    }
  }
}

// One launch: grid (C, ceil(M / 128)) in clusters of (C, 1, 1), kThreads
// threads, Shape::kSmem bytes of dynamic shared memory.
template <class S>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_ln_fc2_kernel(const __grid_constant__ Maps maps, const Args args) {
  unsigned char* smem = gemm::aligned_smem();
  const uint32_t base = hopper::smem_u32(smem);
  const gemm::Args& a = args.a;
  const Sched sc((int)hopper::cluster_rank(), S::C, args.n_tiles, S::D / kChunk);
  const long long m0 = (long long)blockIdx.y * kRows;
  const gemm::Ring<S::kStages> ring{base + S::kBars};
  const int n_iter = sc.n_iter();
  // Ring iteration i into stage i % kStages: an ln chunk and W1 tile, or a W2
  // chunk.
  auto load = [&](int i) {
    const int j = min(i / sc.full, sc.rounds - 1);
    const int off = i - sc.start(j);
    const uint32_t st = base + (i % S::kStages) * S::kStage, bar = ring.full(i % S::kStages);
    if (sc.own(j) && off < sc.n_k1) {
      hopper::mbar_arrive_expect_tx(bar, S::kStage);
      hopper::tma_load_2d(st, &maps.ln, bar, off * kChunk, (int)m0);
      hopper::tma_load_2d(st + S::kATile, &maps.w1, bar, off * kChunk, (sc.r + sc.C * j) * 128);
    } else {
      const int c = off - (sc.own(j) ? sc.n_k1 : 0);
      hopper::mbar_arrive_expect_tx(bar, S::NY * 128);
      const int t = sc.peer(j, c / 2) + sc.C * j;
      hopper::tma_load_2d(st, &maps.w2, bar, t * 128 + (c % 2) * kChunk, sc.r * S::NY);
    }
  };
  if (threadIdx.x == 0) {
    ring.init(8);  // the consumers' warps free a stage
    hopper::fence_barrier_init();
    hopper::prefetch_tensormap(&maps.w1);
    hopper::prefetch_tensormap(&maps.w2);
  }
  // The LayerNorm of the cluster's tile, once: this block's share of its
  // rows to ln_out, which every block of the cluster streams by TMA after
  // the barrier.
  ln_rows<S::D>(a, m0, sc.r, sc.C);
  hopper::fence_proxy_async_global();
  hopper::cluster_sync();
  if (threadIdx.x == 0) {
    hopper::fence_proxy_async_global();
    for (int i = 0; i < S::kStages && i < n_iter; ++i) load(i);
  }
  if (threadIdx.x < 128) {
    hopper::reg_dealloc<gemm::kProducerRegs>();
    // Every thread joins each round's cluster barrier: warp 0 between its
    // copies, once round j's first kStages W2 chunks are in flight (they need
    // only stages that round j's fc1 chunks freed; the next copy needs a stage
    // that a chunk after the barrier frees), the other warps at once.
    int joined = 0;
    if (threadIdx.x < 32) {
#pragma unroll 1
      for (int i = S::kStages; i < n_iter; ++i) {
        while (joined < sc.rounds && sc.fc2_start(joined) + S::kStages <= i) {
          hopper::cluster_sync();
          ++joined;
        }
        ring.wait_empty(i);
        if (threadIdx.x == 0) load(i);
        __syncwarp();
      }
    }
#pragma unroll 1
    for (; joined < sc.rounds; ++joined) hopper::cluster_sync();
    hopper::cluster_sync_relaxed();  // no block leaves while its peers read its g
    return;
  }
  consume<S>(args, base, sc, m0);
  hopper::cluster_sync_relaxed();
}

template <class S>
constexpr auto kKernel = ffn_ln_fc2_kernel<S>;

// The launch configuration of M rows; the dynamic shared-memory attribute
// (and, for a cluster of more than 8, the non-portable size's) set once per
// instantiation and process.
template <class S>
cudaError_t config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&at)[1], long long M,
                   cudaStream_t s) {
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        kKernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess || S::C <= 8) return e;
    return cudaFuncSetAttribute(kKernel<S>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = S::C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(S::C, (unsigned)((M + kRows - 1) / kRows));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return attr;
}

template <class S>
int launch(const bf16* x, const bf16* w1, const float* b1, const float* gamma,
           const float* beta, const bf16* w2, const float* b2, const int* seeds, bf16* y,
           bf16* ln, long long M, int F, int T, uint32_t threshold, float scale, float eps,
           cudaStream_t s) {
  Maps maps;
  int err = hopper::encode_2d(&maps.ln, ln, S::D, M, kRows);
  if (err == 0) err = gemm::weight_map(&maps.w1, w1, S::D, F, 128);
  if (err == 0) err = gemm::weight_map(&maps.w2, w2, F, S::D, S::NY);
  if (err != 0) return err;
  Args args{};
  gemm::Args& a = args.a;
  a.x = x, a.b1 = b1, a.gamma = gamma, a.beta = beta, a.seeds = seeds, a.ln_out = ln;
  a.M = M, a.K = S::D, a.N = F, a.T = T, a.threshold = threshold, a.scale = scale, a.eps = eps;
  args.b2 = b2, args.y = y, args.n_tiles = F / 128;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  const cudaError_t attr = config<S>(cfg, at, M, s);
  if (attr != cudaSuccess) return (int)attr;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kKernel<S>, maps, args);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace fc2
}  // namespace

// At a built width D (built_width) and F a multiple of 256; seeds: (M / T,)
// int32, or null for rate 0 (threshold and scale are then not read); ln: (M,
// D) bf16 scratch, the normalised rows. Returns the cudaError_t of the launch
// or the encoder's error, or -1 for a shape it was not built for.
extern "C" int coral_ffn_ln_fc2_fwd(const void* x, const void* w1, const void* b1,
                                    const void* gamma, const void* beta, const void* w2,
                                    const void* b2, const void* seeds, void* y, void* ln,
                                    long long M, int D, int F, int T, unsigned int threshold,
                                    float scale, float eps, void* stream) {
  if (!built_width(D) || F % 256 != 0 || (seeds != nullptr && T <= 0)) return -1;
  if (M <= 0) return 0;
  return with_width(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto run = [&](auto shape) {
      return fc2::launch<decltype(shape)>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
          static_cast<const float*>(b1), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<const bf16*>(w2),
          static_cast<const float*>(b2), static_cast<const int*>(seeds), static_cast<bf16*>(y),
          static_cast<bf16*>(ln), M, F, T, threshold, scale, eps,
          static_cast<cudaStream_t>(stream));
    };
    return seeds != nullptr ? run(fc2::Shape<kD, true>{}) : run(fc2::Shape<kD, false>{});
  });
}

// N7's cluster at width D: writes its size C to *cluster and returns the
// clusters of the dropout instantiation the current card can hold at once
// (cudaOccupancyMaxActiveClusters), or -1 for an unbuilt width or a failed
// query. No launch.
extern "C" int coral_ffn_ln_fc2_clusters(int D, int* cluster) {
  return with_width(D, [&](auto d) {
    using S = fc2::Shape<decltype(d)::value, true>;
    *cluster = S::C;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at[1];
    if (fc2::config<S>(cfg, at, 128LL * 1024, nullptr) != cudaSuccess) return -1;
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, fc2::kKernel<S>, &cfg) == cudaSuccess ? n : -1;
  });
}
