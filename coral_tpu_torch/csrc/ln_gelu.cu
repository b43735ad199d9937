// Row LayerNorm (+ polynomial GELU) forward: gelu(layer_norm(x) * gamma + beta).
//
// Replaces: coral_tpu/ops/ln_gelu_pallas.py `_fwd_pallas` / `_fwd_kernel`
// (`ln_gelu` with apply_gelu=True after FE conv 0, `ln_fused` with
// apply_gelu=False before each encoder attention).
//
// Bound on the H100: device memory. Each element is read once and written once
// (2 x 2 bytes in bf16) against ~20 flops, far below the card's ~295 flops per
// byte, so the kernel can at best stream at HBM rate.
//
// Design: one warp owns one row of C channels and keeps it in registers (C /
// 32 values a lane), so the two-pass fp32 statistics of the JAX `_norm`
// (mean, then the mean of squared deviations) cost no second read. Built for
// bf16 C = 512, 768, 1024, 1280 and 1920 (wav2vec2-base's, XLS-R-300M's, -1B's
// and -2B's encoder LNs) and fp32 C = 512, 1024. Loads and stores are 16 bytes a lane where C is a
// multiple of 256 bf16 values, else 8 (1920 = 15 x 128: lane vectors of 4),
// neighbouring lanes on neighbouring addresses. Eight rows (warps) per
// 256-thread block; no shared memory. gamma and beta come in bf16 or fp32
// (TG, the same for both; an instantiation each, so the fp32 one reads them
// as before and no load branches on a flag) and are widened to fp32 in
// registers, as the TPU kernel's `.astype(jnp.float32)` does, so bf16 work
// copies of the weights need no cast kernel.
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "gelu_poly.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// V values of gamma or beta from column col, bf16 (is_bf16) or fp32, as fp32.
template <int V>
__device__ __forceinline__ void load_param(const void* p, int is_bf16, int col, float* f) {
  if (is_bf16) coral_loadv<V>(static_cast<const bf16*>(p) + col, f);
  else coral_loadv<V>(static_cast<const float*>(p) + col, f);
}

template <typename T, typename TG, int C, bool kGelu>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_gelu_kernel(const T* __restrict__ x, const TG* __restrict__ gamma,
                   const TG* __restrict__ beta, T* __restrict__ y, long long rows, float eps) {
  constexpr int V = coral_row_vec<T>(C);
  constexpr int kPerLane = C / 32;
  constexpr int kChunks = kPerLane / V;
  static_assert(kChunks * V * 32 == C, "C must be a multiple of 32 lane vectors");

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[kPerLane];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) coral_loadv<V>(xr + (i * 32 + lane) * V, v + i * V);

  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) s += v[j];
  const float mean = coral_warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    v[j] -= mean;
    q += v[j] * v[j];
  }
  const float rstd = rsqrtf(coral_warp_sum(q) / C + eps);

#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int col = (i * 32 + lane) * V;
    float g[V], b[V], out[V];
    coral_loadv<V>(gamma + col, g);
    coral_loadv<V>(beta + col, b);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float z = (v[i * V + e] * rstd) * g[e] + b[e];
      if (kGelu) z = coral_gelu(z);
      out[e] = z;
    }
    coral_storev<V>(yr + col, out);
  }
}

template <typename T, typename TG, int C>
int launch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
           int apply_gelu, float eps, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const TG* gp = static_cast<const TG*>(gamma);
  const TG* bp = static_cast<const TG*>(beta);
  T* yp = static_cast<T*>(y);
  if (apply_gelu)
    ln_gelu_kernel<T, TG, C, true><<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, gp, bp, yp, rows,
                                                                             eps);
  else
    ln_gelu_kernel<T, TG, C, false><<<grid, kRowsPerBlock * 32, 0, stream>>>(xp, gp, bp, yp, rows,
                                                                              eps);
  return (int)cudaGetLastError();
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/ln_gelu_pallas.py `_bwd_pallas` / `_bwd_kernel` (K1/K2
// bwd: dx and the dgamma/dbeta partials of `ln_gelu` and `ln_fused`) and the
// sum of those partials in `_ln_gelu_bwd`, cast once to gamma's dtype. The
// FFN block's backward reuses it, with apply_gelu=0, an fp32 dy and fp32
// gamma, for the LN step of `_bwd_ln_epilogue` (ffn_pallas.py:212-225), which
// is the same math.
//
// Bound on the H100: device memory, as the forward (read x and dy, write dx).
//
// Design: two kernels launched by one C entry (coral_ln_bwd).
//
// The row kernel: a team of W warps holds a row in registers, K = C / (32 W)
// values a lane in lane vectors of V (W = 1 up to C = 512, 2 up to 1280, 3 at
// 1920, so that K <= 20), and recomputes the fp32 statistics from x, as the
// TPU kernel does. The three row sums (the mean; the variance; mean(dn) and
// mean(dn n) together) are warp shuffles, then, for W > 1, one exchange of
// the team's W warp sums through shared memory at the team's named barrier,
// added in member order so that every warp of the team holds the same bits.
// Each lane keeps the dgamma and dbeta sums of its K columns in registers
// over all the rows its team takes (rows team, team + T gridDim.x, ...), and
// gamma (and, with GELU, beta) in registers from the start. The next row's x
// and dy are loaded into a register double buffer before the current row's
// sums start, so their latency runs under the reductions. A block of T teams
// adds its teams' sums through shared memory once, at its end, in a fixed
// tree ((T / 2) x 2C fp32 of static shared memory, 16-30 KB), and writes one
// (2, C) fp32 partial. Registers, not shared memory, set how many blocks an
// SM holds; the grid is every block the card holds at once (at most 4 an
// SM), found once per instantiation and card by the occupancy query and
// kept (bwd_resident_blocks): no query and no attribute call per launch.
//
// The column kernel adds the blocks' partials column by column in block
// order (16 warps a block, each a fixed stride of blocks, then the warps in
// order) and writes dgamma and dbeta rounded once to gamma's dtype. It is
// launched with programmatic stream serialisation: it waits at
// `griddepcontrol.wait` for the row kernel to finish and flush, and the row
// kernel lets it be scheduled once every block has left its row loop, so
// its launch overlaps the row kernel's tail.
//
// Every sum runs in a fixed order over fixed rows for a given grid, and the
// grid is fixed per instantiation and card: the same bits on every call, no
// floating-point atomics.

// The backward's layout at width C for x of TX and dy of TY.
template <typename TX, typename TY, int C>
struct BwdShape {
  static constexpr int W = C <= 512 ? 1 : C <= 1280 ? 2 : 3;  // warps a row
  static constexpr int K = C / (32 * W);                       // values a lane
  static constexpr int kVecMax =
      coral_row_vec<TX>(C) < coral_row_vec<TY>(C) ? coral_row_vec<TX>(C) : coral_row_vec<TY>(C);
  static constexpr int V = kVecMax == 8 && K % 8 == 0 ? 8 : 4;  // lane vector
  static constexpr int T = W == 1 ? 8 : 4;                      // teams a block
  static constexpr int kThreads = 32 * W * T;
  static_assert(K * 32 * W == C && K % V == 0, "each lane must hold whole lane vectors");
  static_assert((T & (T - 1)) == 0 && T >= 2 && T <= 8, "the block's tree wants 2, 4 or 8 teams");
};

// Blocks resident at once on an SM, at most: more would only add partials.
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxDevices = 64;
constexpr int kColWarps = 16;

// The raw bits of V values of T: one 16- or 8-byte load.
template <typename T, int V>
struct Raw;
template <>
struct Raw<bf16, 8> {
  using type = uint4;
};
template <>
struct Raw<bf16, 4> {
  using type = uint2;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint2& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const float4& u, float* f) {
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <typename TX, typename TY, int C, bool kGelu>
__global__ void __launch_bounds__(BwdShape<TX, TY, C>::kThreads)
    ln_bwd_kernel(const TX* __restrict__ x, const void* __restrict__ gamma,
                  const void* __restrict__ beta, int gb_bf16, const TY* __restrict__ dy,
                  TX* __restrict__ dx, float* __restrict__ part, long long rows, float eps) {
  using S = BwdShape<TX, TY, C>;
  constexpr int V = S::V, W = S::W, T = S::T, K = S::K, kVecs = K / V;
  using RX = typename Raw<TX, V>::type;
  using RY = typename Raw<TY, V>::type;
  __shared__ float xch[T][3][W][2];                  // the teams' exchanges
  __shared__ __align__(16) float red[T / 2][2 * C];  // [team][member][value][lane]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int team = warp / W;
  const int member = warp % W;
  // The column of this lane's vector i: the team's chunks of 32 V columns
  // are dealt to its warps in turn.
  auto col_of = [&](int i) { return ((i * W + member) * 32 + lane) * V; };

  // The team's sum of one or two values a warp (each already the warp's
  // sum), in member order, on every lane of the team.
  auto team_sum = [&](float& a, float& b, int slot) {
    if constexpr (W > 1) {
      if (lane == 0) {
        xch[team][slot][member][0] = a;
        xch[team][slot][member][1] = b;
      }
      named_barrier(1 + team, 32 * W);
      a = b = 0.f;
#pragma unroll
      for (int m = 0; m < W; ++m) {
        a += xch[team][slot][m][0];
        b += xch[team][slot][m][1];
      }
    }
  };

  float ga[K], be[kGelu ? K : 1], acc_gn[K], acc_g[K];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    load_param<V>(gamma, gb_bf16, col_of(i), ga + i * V);
    if constexpr (kGelu) load_param<V>(beta, gb_bf16, col_of(i), be + i * V);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) acc_gn[j] = acc_g[j] = 0.f;

  RX px[kVecs];
  RY py[kVecs];
  auto load_row = [&](long long r) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      px[i] = *reinterpret_cast<const RX*>(x + r * C + col_of(i));
      py[i] = *reinterpret_cast<const RY*>(dy + r * C + col_of(i));
    }
  };

  const long long stride = (long long)gridDim.x * T;
  long long row = (long long)blockIdx.x * T + team;  // uniform over the team
  if (row < rows) load_row(row);
  for (; row < rows; row += stride) {
    float n[K], g[K];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      unpack(px[i], n + i * V);
      unpack(py[i], g + i * V);
    }
    if (row + stride < rows) load_row(row + stride);

    float s = 0.f, unused = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) s += n[j];
    s = coral_warp_sum(s);
    team_sum(s, unused, 0);
    const float mean = s / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      n[j] -= mean;
      q += n[j] * n[j];
    }
    q = coral_warp_sum(q);
    team_sum(q, unused, 1);
    const float rstd = rsqrtf(q / C + eps);
    float sdn = 0.f, sdnn = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      n[j] *= rstd;
      if constexpr (kGelu) g[j] *= coral_dgelu(n[j] * ga[j] + be[j]);
      const float dn = g[j] * ga[j];
      sdn += dn;
      sdnn += dn * n[j];
      acc_gn[j] += g[j] * n[j];
      acc_g[j] += g[j];
    }
    sdn = coral_warp_sum(sdn);
    sdnn = coral_warp_sum(sdnn);
    team_sum(sdn, sdnn, 2);
    const float mdn = sdn / C;
    const float mdnn = sdnn / C;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      float out[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = i * V + e;
        out[e] = (g[j] * ga[j] - mdn - n[j] * mdnn) * rstd;
      }
      coral_storev<V>(dx + row * C + col_of(i), out);
    }
  }
  // The column kernel may be scheduled now; it reads nothing before this
  // grid has finished.
  asm volatile("griddepcontrol.launch_dependents;");

  // The block's teams, added in a fixed tree: the upper half stores, the
  // lower half adds it to its own.
#pragma unroll
  for (int half = T / 2; half >= 1; half /= 2) {
    if (team >= half && team < 2 * half) {
      float* dst = red[team - half] + member * 2 * K * 32 + lane;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        dst[j * 32] = acc_gn[j];
        dst[(K + j) * 32] = acc_g[j];
      }
    }
    __syncthreads();
    if (team < half) {
      const float* src = red[team] + member * 2 * K * 32 + lane;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        acc_gn[j] += src[j * 32];
        acc_g[j] += src[(K + j) * 32];
      }
    }
    __syncthreads();
  }
  if (team == 0) {
    float* pb = part + (long long)blockIdx.x * 2 * C;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      coral_storev<V>(pb + col_of(i), acc_gn + i * V);
      coral_storev<V>(pb + C + col_of(i), acc_g + i * V);
    }
  }
}

// dvec (2, C) in bf16 (out_bf16) or fp32: row 0 dgamma, row 1 dbeta, each the
// sum over `blocks` (2, C) fp32 partials, in block order within each warp's
// stride and in warp order across the block; 0 for no blocks.
__global__ void __launch_bounds__(kColWarps * 32)
    ln_bwd_cols_kernel(const float* __restrict__ part, int blocks, int C,
                       void* __restrict__ dvec, int out_bf16) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ float red[kColWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;  // of 2C, a multiple of 32
  float s = 0.f;
#pragma unroll 4
  for (int b = warp; b < blocks; b += kColWarps) s += part[(long long)b * 2 * C + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) t += red[w][lane];
    if (out_bf16) static_cast<bf16*>(dvec)[col] = __float2bfloat16(t);
    else static_cast<float*>(dvec)[col] = t;
  }
}

// The row kernel's grid on the current card: its SM count times the blocks
// of this instantiation an SM holds (at most kMaxBlocksPerSm), from the
// occupancy query at the first call on that card, then kept; -1 if the
// runtime cannot say.
template <typename TX, typename TY, int C, bool kGelu>
int bwd_resident_blocks() {
  static std::atomic<int> cache[kMaxDevices];  // 0: not found yet
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  int blocks = cache[dev].load(std::memory_order_relaxed);
  if (blocks > 0) return blocks;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_bwd_kernel<TX, TY, C, kGelu>,
                                                    BwdShape<TX, TY, C>::kThreads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    return -1;
  blocks = (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm) * sms;
  cache[dev].store(blocks, std::memory_order_relaxed);
  return blocks;
}

template <typename TX, typename TY, int C, bool kGelu>
int launch_bwd(const void* x, const void* gamma, const void* beta, const void* dy, void* dx,
               float* part, int part_blocks, void* dvec, long long rows, int gb_bf16, float eps,
               cudaStream_t stream) {
  using S = BwdShape<TX, TY, C>;
  const int resident = bwd_resident_blocks<TX, TY, C, kGelu>();
  if (resident < 1) return -1;
  const long long wanted = (rows + S::T - 1) / S::T;
  const int blocks = (int)(wanted < resident ? wanted : resident);
  if (blocks > part_blocks) return -2;
  if (blocks > 0) {
    ln_bwd_kernel<TX, TY, C, kGelu><<<blocks, S::kThreads, 0, stream>>>(
        static_cast<const TX*>(x), gamma, beta, gb_bf16, static_cast<const TY*>(dy),
        static_cast<TX*>(dx), part, rows, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(2 * C / 32));
  cfg.blockDim = dim3(kColWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ln_bwd_cols_kernel,
                                             static_cast<const float*>(part), blocks, C, dvec,
                                             gb_bf16);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int C>
using Width = std::integral_constant<int, C>;

// Calls fn(TX{}, TY{}, Width<C>{}, std::bool_constant<gelu>{}) for a built
// (x, dy, C) combination: every model width for a bf16 x (each LN gradient),
// 512-1280 for an fp32 x, a bf16 dy only with a bf16 x; -1 otherwise.
template <typename Fn>
int with_bwd_instance(int x_bf16, int dy_bf16, int C, int apply_gelu, Fn fn) {
  auto gelu = [&](auto tx, auto ty, auto c) {
    return apply_gelu ? fn(tx, ty, c, std::true_type{}) : fn(tx, ty, c, std::false_type{});
  };
  auto widths = [&](auto tx, auto ty) {
    switch (C) {
      case 512: return gelu(tx, ty, Width<512>{});
      case 1024: return gelu(tx, ty, Width<1024>{});
      case 1280: return gelu(tx, ty, Width<1280>{});
      default: break;
    }
    if constexpr (sizeof(tx) == 2) {
      switch (C) {
        case 384: return gelu(tx, ty, Width<384>{});
        case 768: return gelu(tx, ty, Width<768>{});
        case 1920: return gelu(tx, ty, Width<1920>{});
        default: break;
      }
    }
    return -1;
  };
  if (x_bf16 && dy_bf16) return widths(bf16{}, bf16{});
  if (x_bf16) return widths(bf16{}, float{});
  if (!dy_bf16) return widths(float{}, float{});
  return -1;
}

}  // namespace

// x, dx: (rows, C) bf16 (x_bf16=1) or fp32; dy: (rows, C) bf16 (dy_bf16=1) or
// fp32; gamma, beta: (C,) bf16 (gb_bf16=1) or fp32; part: (part_blocks, 2, C)
// fp32 scratch, part_blocks at least coral_ln_bwd_blocks; dvec: (2, C) in
// gamma's dtype, dgamma (row 0) and dbeta (row 1). Launches the row kernel
// and the column kernel. Returns the cudaError_t of the launches, -1 for a
// combination it was not built for (or a card the runtime cannot size it
// on), -2 for too small a part.
extern "C" int coral_ln_bwd(const void* x, const void* gamma, const void* beta, const void* dy,
                            void* dx, void* part, int part_blocks, void* dvec, long long rows,
                            int C, int x_bf16, int dy_bf16, int gb_bf16, int apply_gelu,
                            float eps, void* stream) {
  if (rows < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_bwd_instance(x_bf16, dy_bf16, C, apply_gelu, [&](auto tx, auto ty, auto c, auto g) {
    return launch_bwd<decltype(tx), decltype(ty), decltype(c)::value, decltype(g)::value>(
        x, gamma, beta, dy, dx, static_cast<float*>(part), part_blocks, dvec, rows, gb_bf16, eps,
        s);
  });
}

// The row kernel's grid on the current card for this combination, at most
// the rows of part coral_ln_bwd needs (bwd_resident_blocks: queried at the
// first call on a card, then kept); -1 for a combination it was not built for.
extern "C" int coral_ln_bwd_blocks(int C, int x_bf16, int dy_bf16, int apply_gelu) {
  return with_bwd_instance(x_bf16, dy_bf16, C, apply_gelu, [&](auto tx, auto ty, auto c, auto g) {
    return bwd_resident_blocks<decltype(tx), decltype(ty), decltype(c)::value,
                               decltype(g)::value>();
  });
}

// x, y: (rows, C) contiguous, bf16 (is_bf16=1) or fp32; gamma, beta: (C,)
// bf16 (gb_bf16=1) or fp32. Returns the cudaError_t of the launch, or -1 for
// a C it was not built for.
extern "C" int coral_ln_gelu(const void* x, const void* gamma, const void* beta, void* y,
                             long long rows, int C, int is_bf16, int gb_bf16, int apply_gelu,
                             float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t, auto c) {
    using T = decltype(t);
    constexpr int kC = decltype(c)::value;
    return gb_bf16 ? launch<T, bf16, kC>(x, gamma, beta, y, rows, apply_gelu, eps, s)
                   : launch<T, float, kC>(x, gamma, beta, y, rows, apply_gelu, eps, s);
  };
  if (is_bf16) {
    switch (C) {
      case 512: return run(bf16{}, Width<512>{});
      case 768: return run(bf16{}, Width<768>{});
      case 1024: return run(bf16{}, Width<1024>{});
      case 1280: return run(bf16{}, Width<1280>{});
      case 1920: return run(bf16{}, Width<1920>{});
      default: return -1;
    }
  }
  switch (C) {
    case 512: return run(0.f, Width<512>{});
    case 1024: return run(0.f, Width<1024>{});
    default: return -1;
  }
}
