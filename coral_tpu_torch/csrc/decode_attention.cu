// One-token attention of a decode step over a stacked flat K/V store: the
// Whisper decoder's self-attention over its cache (with the beam slot mask)
// and its cross-attention over the encoder's K/V.
//
// Replaces: coral_tpu/ops/decode_attention.py `decode_self_attention`
// (`pallas_call` -> `_self_kernel`, K8) and `decode_cross_attention`
// (`pallas_call` -> `_cross_kernel`, K9). Both read layer `layer` of an
// (L, items, n_keys, H*64) store, the TPU kernels through a scalar-prefetch
// block index, these through one coordinate of a tensor map over the whole
// store: no per-layer slice is made, and no map per layer.
//
// Query row b*K + k (batch item b, beam k) attends the n_keys rows of item b:
// for the self-attention the K*T_b cache slots of b's K beams (the (B*K, T_b)
// cache rows of a layer read as (B, K*T_b)), masked by onehot[b, k, slot] > 0
// with the finite -1e30 otherwise; for the cross-attention the S encoder rows
// of item b, unmasked (the K beams share them). Per head: s = (q . k) * scale
// in fp32, softmax, p @ v, the output rounded to bf16 once. Unlike the TPU
// kernels, which round the normalised probabilities to bf16 before p @ v, p
// stays fp32 until the output.
//
// Bound on the H100: device memory. Every key and value is read once, with 1
// flop a byte per beam (no tensor-core shape fits 1-8 query rows): at Whisper
// large-v3's 8 x 1500 encoder rows a cross-attention call reads 61.4 MB (18.4
// us at 3.35 TB/s), the self-attention over a 225-slot cache 9.2 MB (2.8 us).
// A decode step makes 64 of these calls, so each call's launch path counts as
// much as its bytes.
//
// Design: one launch a call, no device scratch.
// - Grid (C, H, B * groups), cluster (C, 1, 1): the C blocks of a cluster
//   split one (item, head, group of up to 8 beams)'s keys into contiguous
//   shares of whole 64-key tiles (rank c takes tiles [c*n/C, (c+1)*n/C)).
//   C = 1, 2, 4 or 8 (`cluster_size` in ops/decode_attention.py) is the
//   largest that leaves each rank a tile and keeps the grid within one wave
//   of at most two blocks an SM (`coral_decode_wave_blocks`): on an H100 a
//   block's fixed costs (its start, the first tile's latency, the combine)
//   outweigh what a second wave of shorter shares gains. K > 8 beams run as
//   ceil(K/8) groups, each streaming the keys again.
// - A block streams its share through a three-stage ring of TMA tensor loads
//   (64 keys x 64 columns of K and of V, 8 KB each, 128-byte swizzled) on
//   mbarriers. A producer warp refills a stage as soon as the four consumer
//   warps have copied it to registers, so up to three tiles fly while one is
//   computed. The map spans the whole 4-D store (H*64, n_keys, items, L),
//   `layer` its last coordinate; keys past n_keys arrive as zeros and score
//   -inf. The maps are encoded once per (pointers, shape) and kept: a store
//   lives for a whole generation.
// - Arithmetic on CUDA cores in fp32, with no block barrier per tile: each
//   consumer warp owns 16 keys of every tile and its own online softmax. Two
//   lanes score a key (32 columns each); the warp's max and sum over its keys
//   are shuffles; p goes through the warp's own shared memory to p @ v, where
//   a lane sums two columns, the running sums rescaled by exp(m_old - m_new).
//   After the last tile the warps' (m, l, o) are combined in warp order.
// - The cluster combines its blocks' (m, l, o) through distributed shared
//   memory in rank order (the same bits on every call): rank r writes
//   columns [r*64/C, (r+1)*64/C) of each beam; at C = 1 the block writes the
//   output itself, with no cluster barrier. A warp or block whose keys are
//   all masked has m = -1e30 and drops out unless every key of the row is
//   masked, where the row averages uniformly, as softmax over -1e30 does; one
//   that holds only keys past n_keys has m = -inf and weight 0.
// - The launch path: the dynamic shared-memory attribute is set once per
//   instantiation and process; a call encodes nothing it has seen, allocates
//   nothing and synchronises nothing, so a CUDA graph can capture it.
#include <math.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 64;                  // head dim
constexpr int kTile = 64;               // keys per tile
constexpr int kStages = 3;              // the TMA ring
constexpr int kWarps = 4;               // consumer warps, 16 keys of each tile apiece
constexpr int kWarpKeys = kTile / kWarps;
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kGroup = 8;               // beams a block takes
constexpr int kMaxBeams = 64;
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kRowBytes = kD * 2;       // a key's 64 bf16 columns: one 128-byte swizzle row
constexpr int kTileBytes = kTile * kRowBytes;
constexpr int kQPitch = 36;             // fp32 pitch of a half q row (32 + 4: halves 4 banks apart)
constexpr float kMasked = -1e30f;

struct Maps {
  CUtensorMap k, v;
};

struct Args {
  const bf16* q;      // (B*K, H*64)
  const float* mask;  // (B, K, n_keys) or null
  bf16* out;          // (B*K, H*64)
  int K;              // beams per item
  int n_keys;
  int H;
  int layer;
  int groups;         // ceil(K / kGroup)
  int tiles;          // ceil(n_keys / kTile)
  float scale;
};

// Byte offsets in shared memory (base 1024-aligned for the swizzle); kB beams
// a block at most (1: greedy, 8: any K).
template <int kB>
struct Layout {
  static constexpr int kStage = 2 * kTileBytes;              // K tile, then V tile
  static constexpr int kQ = kStages * kStage;                // (kB, 2 halves, kQPitch) fp32
  static constexpr int kP = kQ + kB * 2 * kQPitch * 4;       // (kWarps, 2, kB, 16) fp32: each warp's p
  static constexpr int kML = kP + kWarps * 2 * kB * kWarpKeys * 4;  // (2, kWarps + 1, kB) fp32: m, l
  static constexpr int kBars = kML + 2 * (kWarps + 1) * kB * 4;     // full, then empty mbarriers
  // After the last tile, in the ring: the warps' p @ v sums, then the block's.
  static constexpr int kRed = 0;                             // (kWarps, kB, 64) fp32
  static constexpr int kO = kWarps * kB * kD * 4;            // (kB, 64) fp32
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + 1024 to align the base
  static_assert(kO + kB * kD * 4 <= kQ, "the block's sums fit the ring");
  static_assert(kBars % 8 == 0, "mbarriers 8-aligned");
};

// Tile `tile`'s K and V rows into ring stage `stage`.
__device__ __forceinline__ void load_tile(const Maps& maps, uint32_t base, uint32_t bars,
                                          int stage, int tile, int col, int item, int layer) {
  const uint32_t bar = bars + 8 * stage;
  const uint32_t dst = base + stage * 2 * kTileBytes;
  hopper::mbar_arrive_expect_tx(bar, 2 * kTileBytes);
  hopper::tma_load_4d(dst, &maps.k, bar, col, tile * kTile, item, layer);
  hopper::tma_load_4d(dst + kTileBytes, &maps.v, bar, col, tile * kTile, item, layer);
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The mask of `key` for the group's beams (1 where there is no mask, no
// such beam or no such key).
template <int kB>
__device__ __forceinline__ void read_mask(const Args& a, int row0, int kg, int key,
                                          float (&mv)[kB]) {
#pragma unroll
  for (int k = 0; k < kB; ++k)
    mv[k] = a.mask != nullptr && k < kg && key < a.n_keys
                ? a.mask[(long long)(row0 + k) * a.n_keys + key]
                : 1.f;
}

template <int kB>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const __grid_constant__ Maps maps, const Args a) {
  using L = Layout<kB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle pattern needs 1024
  unsigned char* smem = smem_raw + (base - raw);
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* m_s = reinterpret_cast<float*>(smem + L::kML);  // (kWarps + 1, kB): warps', block's
  float* l_s = m_s + (kWarps + 1) * kB;
  const uint32_t full = base + L::kBars;     // a stage's tile has landed
  const uint32_t empty = full + 8 * kStages;  // every consumer warp is done with the stage

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int C = gridDim.x;  // the cluster spans x
  const int rank = (int)hopper::cluster_rank();
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.groups;
  const int row0 = b * a.K + (blockIdx.z - b * a.groups) * kGroup;  // the group's first q row
  const int kg = min(kB, b * a.K + a.K - row0);                    // its beams
  const int t0 = rank * a.tiles / C;
  const int n_t = (rank + 1) * a.tiles / C - t0;                   // >= 1: C <= tiles
  const int col = h * kD;
  const long long HD = (long long)a.H * kD;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kWarps);
    }
    hopper::fence_barrier_init();
    for (int i = 0; i < n_t && i < kStages; ++i)
      load_tile(maps, base, full, i, t0 + i, col, b, a.layer);
  }
  // The group's q rows in fp32, each as two 32-column halves.
  for (int i = tid; i < kg * (kD / 8); i += kThreads) {
    const int k = i >> 3, c8 = (i & 7) * 8;
    float f[8];
    coral_load8(a.q + (row0 + k) * HD + col + c8, f);
    float* dst = q_s + (k * 2 + (c8 >> 5)) * kQPitch + (c8 & 31);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = f[e];
  }
  __syncthreads();

  if (warp == kWarps) {
    // The producer: refills each stage once the four consumer warps are done with it.
    if (lane == 0) {
      for (int i = kStages; i < n_t; ++i) {
        const int stage = i % kStages;
        hopper::mbar_wait(empty + 8 * stage, ((i / kStages) - 1) & 1);
        load_tile(maps, base, full, stage, t0 + i, col, b, a.layer);
      }
    }
  } else {
    // A consumer warp: keys 16 warp .. 16 warp + 15 of every tile, with its
    // own online softmax. Lanes 2j and 2j + 1 score key j (32 columns each);
    // for p @ v lane l sums columns 2l and 2l + 1.
    const int j = lane >> 1;
    const int half = lane & 1;
    const int jr = warp * kWarpKeys + j;  // the key's row in the tile
    float* p_s = reinterpret_cast<float*>(smem + L::kP) + warp * 2 * kB * kWarpKeys;
    float m_run[kB], l_run[kB], acc[kB][2];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      m_run[k] = -INFINITY;
      l_run[k] = 0.f;
      acc[k][0] = acc[k][1] = 0.f;
    }
    // This lane's key's mask per beam, read a tile ahead: the tiles arrive
    // ahead of the arithmetic, so a load issued at the tile itself would wait
    // its whole latency.
    float mv[kB], mv_next[kB];
    read_mask<kB>(a, row0, kg, t0 * kTile + jr, mv_next);
    for (int i = 0; i < n_t; ++i) {
      const int stage = i % kStages;
      const int key = (t0 + i) * kTile + jr;
      float* pb = p_s + (i & 1) * kB * kWarpKeys;
#pragma unroll
      for (int k = 0; k < kB; ++k) mv[k] = mv_next[k];
      if (i + 1 < n_t) read_mask<kB>(a, row0, kg, key + kTile, mv_next);
      hopper::mbar_wait(full + 8 * stage, (i / kStages) & 1);

      // The scores of every beam: four partial sums of the half row, then the
      // pair's. K's row is read before V's, so the two never share registers.
      float sc[kB];
      {
        const unsigned char* kt = smem + stage * L::kStage + jr * kRowBytes;
        float kr[32];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(kt + ((((half << 2) + c) ^ (jr & 7)) << 4));
          const float2 f0 = bf16x2_to_float2(u.x), f1 = bf16x2_to_float2(u.y);
          const float2 f2 = bf16x2_to_float2(u.z), f3 = bf16x2_to_float2(u.w);
          kr[8 * c] = f0.x, kr[8 * c + 1] = f0.y, kr[8 * c + 2] = f1.x, kr[8 * c + 3] = f1.y;
          kr[8 * c + 4] = f2.x, kr[8 * c + 5] = f2.y, kr[8 * c + 6] = f3.x, kr[8 * c + 7] = f3.y;
        }
#pragma unroll
        for (int k = 0; k < kB; ++k) {
          sc[k] = 0.f;
          if (k < kg) {
            const float4* qv = reinterpret_cast<const float4*>(q_s + (k * 2 + half) * kQPitch);
            float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float4 x = qv[c];
              s0 = fmaf(x.x, kr[4 * c], s0);
              s1 = fmaf(x.y, kr[4 * c + 1], s1);
              s2 = fmaf(x.z, kr[4 * c + 2], s2);
              s3 = fmaf(x.w, kr[4 * c + 3], s3);
            }
            float sk = (s0 + s1) + (s2 + s3);
            sk += __shfl_xor_sync(0xffffffffu, sk, 1);
            sk *= a.scale;
            if (key >= a.n_keys) sk = -INFINITY;
            else if (!(mv[k] > 0.f)) sk = kMasked;
            sc[k] = sk;
          }
        }
      }
      const unsigned char* vt = smem + stage * L::kStage + kTileBytes + warp * kWarpKeys * kRowBytes;
      float2 vv[kWarpKeys];
#pragma unroll
      for (int r = 0; r < kWarpKeys; ++r)
        vv[r] = bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(
            vt + r * kRowBytes + ((((lane >> 2) ^ (r & 7)) << 4) | ((lane & 3) << 2))));
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + 8 * stage);  // the stage is read

#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (k < kg) {
          // The warp's max and sum over its 16 keys (each held by a lane pair).
          float mx = sc[k];
#pragma unroll
          for (int o = 2; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m_run[k], mx);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;  // keys past n_keys alone
          const float alpha = expf(m_run[k] - m_use);
          const float p = expf(sc[k] - m_use);
          float sum = p;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          l_run[k] = l_run[k] * alpha + sum;
          m_run[k] = m_new;
          if (half == 0) pb[k * kWarpKeys + j] = p;
          acc[k][0] *= alpha;
          acc[k][1] *= alpha;
        }
      }
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        if (k < kg) {
          const float4* pr = reinterpret_cast<const float4*>(pb + k * kWarpKeys);
          float a0 = acc[k][0], a1 = acc[k][1];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 pv = pr[c];
            a0 = fmaf(pv.x, vv[4 * c].x, a0), a1 = fmaf(pv.x, vv[4 * c].y, a1);
            a0 = fmaf(pv.y, vv[4 * c + 1].x, a0), a1 = fmaf(pv.y, vv[4 * c + 1].y, a1);
            a0 = fmaf(pv.z, vv[4 * c + 2].x, a0), a1 = fmaf(pv.z, vv[4 * c + 2].y, a1);
            a0 = fmaf(pv.w, vv[4 * c + 3].x, a0), a1 = fmaf(pv.w, vv[4 * c + 3].y, a1);
          }
          acc[k][0] = a0;
          acc[k][1] = a1;
        }
      }
    }
    // The warp's (m, l) per beam; its p @ v goes to the ring once every warp is done.
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (k < kg && lane == 0) {
        m_s[warp * kB + k] = m_run[k];
        l_s[warp * kB + k] = l_run[k];
      }
    }
    hopper::named_barrier(1, 32 * kWarps);  // the consumers are done with the ring
    float* red = reinterpret_cast<float*>(smem + L::kRed);
#pragma unroll
    for (int k = 0; k < kB; ++k)
      if (k < kg)
        *reinterpret_cast<float2*>(red + (warp * kB + k) * kD + 2 * lane) =
            make_float2(acc[k][0], acc[k][1]);
  }
  __syncthreads();

  // The block's (m, l, o) per beam: the warps combined in order.
  float* o_s = reinterpret_cast<float*>(smem + L::kO);
  {
    const float* red = reinterpret_cast<const float*>(smem + L::kRed);
    for (int i = tid; i < kg * kD; i += kThreads) {
      const int k = i / kD;
      float M = m_s[k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w * kB + k]);  // finite: a block holds a key
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(m_s[w * kB + k] - M);  // a warp of padding alone: 0
        l += e * l_s[w * kB + k];
        o += e * red[w * kB * kD + i];
      }
      if (C == 1) {  // the block is the cluster: the output, as the combine below gives it
        a.out[(row0 + k) * HD + col + (i - k * kD)] = __float2bfloat16(o / l);
      } else {
        o_s[i] = o;
        if (i - k * kD == 0) {
          m_s[kWarps * kB + k] = M;
          l_s[kWarps * kB + k] = l;
        }
      }
    }
  }
  if (C == 1) return;
  hopper::cluster_sync();

  // The cluster's combine, in rank order: rank r writes columns
  // [r * 64 / C, (r + 1) * 64 / C) of each beam.
  const int n_cols = kD / C;
  const uint32_t m_u = hopper::smem_u32(m_s + kWarps * kB), l_u = hopper::smem_u32(l_s + kWarps * kB);
  const uint32_t o_u = hopper::smem_u32(o_s);
  for (int i = tid; i < kg * n_cols; i += kThreads) {
    const int k = i / n_cols;
    const int d = rank * n_cols + (i - k * n_cols);
    float m[kMaxCluster];
    float M = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < C) {
        m[c] = hopper::ld_cluster_f32(hopper::map_to_rank(m_u + 4 * k, c));
        M = fmaxf(M, m[c]);
      }
    }
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < C) {
        const float w = expf(m[c] - M);
        l += w * hopper::ld_cluster_f32(hopper::map_to_rank(l_u + 4 * k, c));
        o += w * hopper::ld_cluster_f32(hopper::map_to_rank(o_u + 4 * (k * kD + d), c));
      }
    }
    a.out[(row0 + k) * HD + col + d] = __float2bfloat16(o / l);
  }
  hopper::cluster_sync_relaxed();  // no block leaves while the cluster reads its shared memory
}

// The map of one bf16 store (L, items, n_keys, HD) as the 4-D tensor (HD,
// n_keys, items, L): a box is 64 columns by 64 keys of one item and layer,
// 128-byte swizzled; keys past n_keys load as zeros. 0, or the encoder's
// CUresult (-1 without one).
int encode_store(CUtensorMap* map, const void* store, int HD, int n_keys, int items, int L) {
  const hopper::EncodeTiledFn fn = hopper::encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t row = (cuuint64_t)HD * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)n_keys, (cuuint64_t)items,
                              (cuuint64_t)L};
  const cuuint64_t strides[3] = {row, row * n_keys, row * n_keys * items};
  const cuuint32_t box[4] = {kD, kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return (int)fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(store), dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of the last kCached (k, v, shape)s seen, replaced in turn: a map
// depends on nothing but the pointer and the shape, so a kept one is never
// stale, and a store is read by every call of a generation.
constexpr int kCached = 16;

struct CachedMaps {
  const void* k;
  const void* v;
  int HD, n_keys, items, L;
  Maps maps;
};

int find_maps(Maps* out, const void* k, const void* v, int HD, int n_keys, int items, int L) {
  static std::mutex mu;
  static CachedMaps cache[kCached];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const CachedMaps& e = cache[i];
    if (e.k == k && e.v == v && e.HD == HD && e.n_keys == n_keys && e.items == items &&
        e.L == L) {
      *out = e.maps;
      return 0;
    }
  }
  CachedMaps& e = cache[next];
  int err = encode_store(&e.maps.k, k, HD, n_keys, items, L);
  if (err == 0) err = encode_store(&e.maps.v, v, HD, n_keys, items, L);
  if (err != 0) {
    e.k = e.v = nullptr;  // never matched
    return err;
  }
  e.k = k, e.v = v, e.HD = HD, e.n_keys = n_keys, e.items = items, e.L = L;
  next = (next + 1) % kCached;
  if (used < kCached) ++used;
  *out = e.maps;
  return 0;
}

// The dynamic shared-memory attribute of an instantiation: set at its first
// use in the process, off every later call's path.
template <int kB>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<kB>::kSmem);
  return err;
}

constexpr int kWavePerSm = 2;  // blocks of one call an SM takes at most

// The blocks a call's grid may hold on the current card: one wave, the
// instantiation's blocks an SM (by occupancy) times the SMs, and at most
// kWavePerSm an SM; -1 if the runtime cannot say.
template <int kB>
int wave_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  if (prepare<kB>() != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_attention_kernel<kB>,
                                                    kThreads, Layout<kB>::kSmem) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  return sms * (per_sm < kWavePerSm ? per_sm : kWavePerSm);
}

template <int kB>
int launch(const Maps& maps, const Args& a, int B, int C, cudaStream_t stream) {
  const cudaError_t attr = prepare<kB>();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, (unsigned)a.H, (unsigned)(B * a.groups));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<kB>::kSmem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<kB>, maps, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// q: (B*K, H*64) bf16; k, v: (L, B, n_keys, H*64) bf16 stores of which layer
// `layer` is read (the self-attention's (L, B*K, T, H*64) cache is this with
// n_keys = K*T); mask: (B, K, n_keys) fp32 or null; out: (B*K, H*64) bf16;
// C: the cluster size, 1, 2, 4 or 8 and at most ceil(n_keys / 64). One
// launch. Returns its cudaError_t, the encoder's CUresult, or -1 for a shape
// the kernel was not built for.
extern "C" int coral_decode_attention(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int K, int n_keys,
                                      int H, int L, int layer, int C, float scale,
                                      void* stream) {
  const int tiles = n_keys > 0 ? (n_keys + kTile - 1) / kTile : 0;
  const int groups = (K + kGroup - 1) / kGroup;
  if (B <= 0 || K <= 0 || K > kMaxBeams || n_keys <= 0 || H <= 0 || H > 65535 || layer < 0 ||
      layer >= L || (C != 1 && C != 2 && C != 4 && C != kMaxCluster) || C > tiles ||
      (long long)B * groups > 65535)
    return -1;
  Maps maps;
  const int err = find_maps(&maps, k, v, H * kD, n_keys, B, L);
  if (err != 0) return err;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.K = K;
  a.n_keys = n_keys;
  a.H = H;
  a.layer = layer;
  a.groups = groups;
  a.tiles = tiles;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K == 1 ? launch<1>(maps, a, B, C, s) : launch<kGroup>(maps, a, B, C, s);
}

// The blocks a call of K beams (K = 1, else groups of 8) may launch on the
// current card: the wrapper's cluster size keeps the grid within them (it
// asks once per card). -1 if the runtime cannot say.
extern "C" int coral_decode_wave_blocks(int K) {
  return K == 1 ? wave_blocks<1>() : wave_blocks<kGroup>();
}
