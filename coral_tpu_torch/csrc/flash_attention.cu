// Non-causal self-attention over the flat (B, T, H*d) layout: the forward
// o = softmax(q k^T * scale) v per head (with the fp32 row stats m and l for
// training), and the backward's two kernels. Unmasked for the Whisper encoder;
// with segment ids (kSeg) for wav2vec2's `attention_impl: flash` route.
//
// Replaces: coral_tpu/ops/flash_attention.py `_flash` / `_fwd_cp` (JAX's stock
// TPU flash kernel, `flash_attention` with segment ids over T padded to the
// 512/768 grid), behind `flash_self_attention`, and `_flash_res`, the same
// kernel with `save_residuals`, which also returns l and m.
//
// Bound on the H100: the tensor cores and the fp32 softmax between the two
// products: 4 * T^2 * d flops and T^2 exponentials per head, against
// 4 * T * d * 2 bytes of q, k, v and o. At the encoder's T = 1500 that is
// about 750 flops per byte, far above the card's 295.
//
// Design: the forward (`flash_fwd_kernel`) runs on the Hopper mainloop of
// `attention.cuh` (namespace fwd): 128 query rows of one head a block, two
// consumer warpgroups and a producer that copies 128-key tiles of K and V by
// TMA into a three-stage ring, both products on wgmma and the online softmax in
// registers, so nothing of size T x T exists anywhere and S, P and P V never
// touch shared memory. Head h is the lane slice h*d .. h*d+d-1 of each row,
// read through the row strides (the tensor maps' 4-D view): no (B, H, T, d)
// copy is made. Built for head dims 64 (Whisper; XLS-R-300M), 80 (XLS-R-1B,
// products over 80 columns) and 120 (XLS-R-2B, its tiles padded with zero
// columns to 128 by TMA); o is stored only below d, so nothing lands in the
// next head. The scale is the caller's d**-0.5. T need not be a multiple of
// the tile: keys at or past T get -inf in the last tile and contribute
// exactly 0 (the TPU wrapper pads T to its block grid and masks the padding
// with segment ids instead). As in the stock TPU kernel, scores are the bf16
// product accumulated in fp32, then multiplied by the scale (folded into the
// exponent's base-2 factor); the unnormalised probabilities are rounded to
// bf16 for the product with V, and the sum is divided by the fp32 row sum at
// the end. The training launch also writes each row's final max m and its
// sum of exp(s - m), l (the stock kernel's residuals), in fp32 (B, H, T).
// The backward's kernels are on the WMMA tiles of `attention.cuh`.
//
// Segment ids (kSeg): replaces coral_tpu/models/wav2vec2.py `_flash_attention`
// (:440), the same stock kernel over q, k, v padded with zero rows to the
// 128-row grid Tk >= T, with one (B, Tk) int32 segment vector for queries and
// keys (valid frames 1, padded frames and the grid's rows 0). A score is
// masked where the two ids differ, so a padded query attends to every padded
// key, the grid's zero rows included (score 0, v = 0), as the stock kernel
// does. Here the grid's rows are never stored: rows at or past T load as
// zeros and the key loop runs to Tk, so the forward and its stats are those
// of the padded call. A tile can hold no key of a row's segment, so a row's
// running max may still be -inf after a tile, which the update treats as 0.
// Without segments (kSeg false) the code is the unmasked kernel's.
#include "attention.cuh"

namespace {

constexpr int kSegSmem = 64 * 4;  // one tile's segment ids, after the tiles

// Segment ids of rows r0 .. r0+63 (those at or past n: 0); threads 0..63.
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0, int n) {
  if (threadIdx.x < 64) dst[threadIdx.x] = r0 + (int)threadIdx.x < n ? seg[r0 + threadIdx.x] : 0;
}

// acc[j] (16 x 16 each, columns 16j ..) += A (16 x 64, pitch kLdP) times B
// (64 x DP, pitch kLdH).
template <int D>
__device__ __forceinline__ void times_b(FragC (&acc)[Head<D>::kNF], const bf16* A,
                                        const bf16* B) {
  using Hd = Head<D>;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, kLdP);
#pragma unroll
    for (int j = 0; j < Hd::kNF; ++j) {
      FragBr bf;
      wmma::load_matrix_sync(bf, B + kk * Hd::kLdH + j * 16, Hd::kLdH);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
}

// The forward on the Hopper mainloop (`attention.cuh`, namespace fwd): q, k, v
// through the tensor maps; args.o, with kStats m and l (args.stat_a, stat_l),
// with kSeg args.seg (B, Tk) and keys running to Tk (else Tk = T).
template <int D, bool kStats, bool kSeg>
__global__ void __launch_bounds__(fwd::Tile<D, fwd::consumers(D)>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ fwd::Maps maps, const fwd::Args args) {
  fwd::mainloop<D, fwd::K7<kStats, kSeg>>(maps, args);
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/flash_attention.py `_grads`: the stock TPU kernel's
// dkv backward (`_flash_attention_bwd_dkv`) and coral_tpu/ops/_flash_bwd_patch.py
// `flash_attention_bwd_dq_fixed`, from the forward's o, l and m.
//
// Bound on the H100: the tensor cores: the dkv kernel makes four T x T x d
// products per head (s, dp, dv, dk), the dq kernel three (s, dp, dq), plus
// T^2 exponentials in each; the TPU kernels hold (block, block) tiles in VMEM
// that a Hopper SM cannot.
//
// Design: two kernels and no atomics, so the gradients are reproducible, the
// split of the wav2vec2 attention backward (csrc/attention.cu). The key-major
// kernel (one block per 64-key tile, head, batch row) walks the query tiles and
// accumulates dk and dv in registers, in the transposed space S^T = K Q^T; the
// query-major kernel walks the key tiles and accumulates dq. Both rebuild the
// stock kernel's p = exp(s * scale - m) / l from the saved stats and form
// ds = (dp - di) p scale, with di = rowsum(o * do) in fp32 computed per query
// tile in each kernel from o and do (the TPU package computes di once, outside
// its kernels: here each dkv block reads o once more per query tile, 64 x d
// bf16, half again the q and do it reads anyway). p and ds are rounded to bf16
// for the products dv = p^T do, dk = ds^T q and dq = ds k, as the stock kernel
// rounds them to the operands' dtype; sums are fp32. Keys past T are zero rows
// (s = 0), whose dk and dv are never written; queries past T get m = +inf and
// so p = 0; the dq kernel gives keys past T p = 0.
//
// With segment ids (kSeg), p = 0 where the query's and the key's ids differ.
// The padded call's rows at or past T are left out: a query there has do = 0
// (its output is sliced away) and adds nothing to dk or dv, and a key there
// has k = v = 0 and adds nothing to dq; its own dk and dv are sliced away.
// The stats l and m of the forward over Tk keys carry what they did add.

// The shared memory of the two kernels at head dim D: the bf16 tiles (K, V,
// Q, dO at pitch kLdH; P, dS at kLdP), the staged fp32 S, the query rows' m,
// 1/l and di; kSeg launches add one tile's segment ids (kSegSmem) after di.
template <int D>
struct BwdSmem {
  using Hd = Head<D>;
  static constexpr int kDkv = 4 * 64 * Hd::kLdH * 2 + 2 * 64 * kLdP * 2 + 64 * Hd::kLdS * 4 + 3 * 64 * 4;
  static constexpr int kDq = 4 * 64 * Hd::kLdH * 2 + 64 * kLdP * 2 + 64 * Hd::kLdS * 4 + 3 * 64 * 4;
  static_assert(kDkv + kSegSmem <= kMaxSmem && kDq + kSegSmem <= kMaxSmem,
                "each kernel's tiles must fit a block's shared memory");
};

// m, 1/l and di = rowsum(o * do) of query rows q0 .. q0+63 (dOs already in
// shared memory); rows past T get m = +inf, 1/l = 1 and di = 0. Two threads a
// row.
template <int D>
__device__ __forceinline__ void flash_query_stats(float* m_s, float* il_s, float* di_s,
                                                  const float* m_row, const float* l_row,
                                                  const bf16* dOs, const bf16* o_head, int q0,
                                                  int T, long long stride_o) {
  using Hd = Head<D>;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float s = 0.f;
  if (q0 + r < T) {
#pragma unroll
    for (int j = 0; j < Hd::kHalf; j += 8) {
      const int c = half * Hd::kHalf + j;
      if (c >= D) break;
      float a[8], d[8];
      coral_load8(o_head + (long long)(q0 + r) * stride_o + c, a);
      coral_load8(dOs + r * Hd::kLdH + c, d);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += a[e] * d[e];
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0) {
    const bool in = q0 + r < T;
    m_s[r] = in ? m_row[q0 + r] : INFINITY;
    il_s[r] = in ? 1.0f / l_row[q0 + r] : 1.0f;
    di_s[r] = s;
  }
}

// q, k, v as the forward; o, dout: (B, T, H*D) bf16 contiguous; m, l:
// (B, H, T) fp32; dk, dv: (B, T, H*D) bf16 contiguous; with kSeg, seg:
// (B, Tk) int32.
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ m,
                         const float* __restrict__ l, const int* __restrict__ seg,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tk, int H,
                         long long stride_b, long long stride_t, float scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS, kNF = Hd::kNF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Qs = Vs + kBKV * kLdH;
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ps = dOs + kBQ * kLdH;
  bf16* dSs = Ps + kBKV * kLdP;
  float* Ss = reinterpret_cast<float*>(dSs + kBKV * kLdP);
  float* m_s = Ss + kBKV * kLdS;
  float* il_s = m_s + 64;
  float* di_s = il_s + 64;
  int* seg_s = reinterpret_cast<int*>(di_s + 64);  // kSeg: the query tile's ids

  const int k0 = blockIdx.x * kBKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;  // this lane's key row within the warp's 16
  const int half = lane & 1;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * stride_b + h * D;
  const long long ohead = (long long)b * T * HD + h * D;
  const long long stat = ((long long)b * H + h) * T;

  load_rows<D>(Ks, k + head, k0, T, stride_t);
  load_rows<D>(Vs, v + head, k0, T, stride_t);
  int seg_r = 0;  // this lane's key's segment
  if constexpr (kSeg) {
    seg += (long long)b * Tk;
    const int t = k0 + warp * 16 + row;
    seg_r = t < Tk ? seg[t] : 0;
  }

  FragC dk_acc[kNF], dv_acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdP;
  bf16* dSw = dSs + warp * 16 * kLdP;
  const bf16* Kw = Ks + warp * 16 * kLdH;
  const bf16* Vw = Vs + warp * 16 * kLdH;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // the previous query tile is no longer read
    load_rows<D>(Qs, q + head, q0, T, stride_t);
    load_rows<D>(dOs, dout + ohead, q0, T, HD);
    if constexpr (kSeg) load_seg(seg_s, seg, q0, T);
    __syncthreads();
    flash_query_stats<D>(m_s, il_s, di_s, m + stat, l + stat, dOs, o + ohead, q0, T, HD);
    __syncthreads();

    // S^T = K_w Q^T for this warp's 16 keys; p^T.
    product_abt<D>(Sw, Kw, Qs);
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = expf(Sw[row * kLdS + c] * scale - m_s[c]) * il_s[c];
      if constexpr (kSeg) p[j] = seg_s[c] == seg_r ? p[j] : 0.0f;
      Pw[row * kLdP + c] = __float2bfloat16(p[j]);
    }
    __syncwarp();

    // dP^T = V_w dO^T; dS^T.
    product_abt<D>(Sw, Vw, dOs);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdP + c] = __float2bfloat16((Sw[row * kLdS + c] - di_s[c]) * p[j] * scale);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q.
    times_b<D>(dv_acc, Pw, dOs);
    times_b<D>(dk_acc, dSw, Qs);
    __syncwarp();
  }

  store_rows<D, false>(dk_acc, 1.0f, Sw, nullptr, dk + ohead, HD, k0, T, nullptr);
  store_rows<D, false>(dv_acc, 1.0f, Sw, nullptr, dv + ohead, HD, k0, T, nullptr);
}

// As flash_bwd_dkv_kernel, for dq: (B, T, H*D) bf16 contiguous.
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ m,
                        const float* __restrict__ l, const int* __restrict__ seg,
                        bf16* __restrict__ dq, int T, int Tk, int H, long long stride_b,
                        long long stride_t, float scale) {
  using Hd = Head<D>;
  constexpr int kLdH = Hd::kLdH, kLdS = Hd::kLdS, kNF = Hd::kNF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ks = dOs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* dSs = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(dSs + kBQ * kLdP);
  float* m_s = Ss + kBQ * kLdS;
  float* il_s = m_s + 64;
  float* di_s = il_s + 64;
  int* seg_s = reinterpret_cast<int*>(di_s + 64);  // kSeg: the key tile's ids

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
  const long long HD = (long long)H * D;
  const long long head = (long long)b * stride_b + h * D;
  const long long ohead = (long long)b * T * HD + h * D;
  const long long stat = ((long long)b * H + h) * T;

  load_rows<D>(Qs, q + head, q0, T, stride_t);
  load_rows<D>(dOs, dout + ohead, q0, T, HD);
  __syncthreads();
  flash_query_stats<D>(m_s, il_s, di_s, m + stat, l + stat, dOs, o + ohead, q0, T, HD);
  int seg_r = 0;  // this lane's query's segment
  if constexpr (kSeg) {
    seg += (long long)b * Tk;
    const int t = q0 + warp * 16 + row;
    seg_r = t < T ? seg[t] : 0;
  }

  FragC dq_acc[kNF];
#pragma unroll
  for (int j = 0; j < kNF; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* dSw = dSs + warp * 16 * kLdP;
  const bf16* Qw = Qs + warp * 16 * kLdH;
  const bf16* dOw = dOs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous key tile is no longer read
    load_rows<D>(Ks, k + head, k0, T, stride_t);
    load_rows<D>(Vs, v + head, k0, T, stride_t);
    if constexpr (kSeg) load_seg(seg_s, seg, k0, T);
    __syncthreads();
    const float m_r = m_s[warp * 16 + row];
    const float il_r = il_s[warp * 16 + row];
    const float di_r = di_s[warp * 16 + row];

    // S = Q_w K^T; p, 0 for keys past T.
    product_abt<D>(Sw, Qw, Ks);
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      bool in = k0 + c < T;
      if constexpr (kSeg) in = in && seg_s[c] == seg_r;
      p[j] = in ? expf(Sw[row * kLdS + c] * scale - m_r) * il_r : 0.0f;
    }
    __syncwarp();

    // dP = dO_w V^T; dS.
    product_abt<D>(Sw, dOw, Vs);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdP + c] = __float2bfloat16((Sw[row * kLdS + c] - di_r) * p[j] * scale);
    }
    __syncwarp();

    // dQ += dS K.
    times_b<D>(dq_acc, dSw, Ks);
    __syncwarp();
  }

  store_rows<D, false>(dq_acc, 1.0f, Sw, nullptr, dq + ohead, HD, q0, T, nullptr);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool kSeg>
cudaError_t launch_flash_bwd(dim3 grid, cudaStream_t s, const bf16* q, const bf16* k,
                             const bf16* v, const bf16* o, const bf16* dout, const float* m,
                             const float* l, const int* seg, bf16* dq, bf16* dk, bf16* dv, int T,
                             int Tk, int H, long long stride_b, long long stride_t, float scale) {
  const int extra = kSeg ? kSegSmem : 0;
  cudaError_t err;
  if (dq == nullptr) {
    const int smem = BwdSmem<D>::kDkv + extra;
    err = set_smem(flash_bwd_dkv_kernel<D, kSeg>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<D, kSeg><<<grid, kThreads, smem, s>>>(
        q, k, v, o, dout, m, l, seg, dk, dv, T, Tk, H, stride_b, stride_t, scale);
  } else {
    const int smem = BwdSmem<D>::kDq + extra;
    err = set_smem(flash_bwd_dq_kernel<D, kSeg>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D, kSeg><<<grid, kThreads, smem, s>>>(
        q, k, v, o, dout, m, l, seg, dq, T, Tk, H, stride_b, stride_t, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// The forward at head dim D (64, 80 or 120); m and l both null (serving: o
// only) or both (B, H, T) fp32 (training). seg null (unmasked, Tk = T) or
// (B, Tk) int32 segment ids with Tk >= T (the padded call's key count).
// Returns the cudaError_t of the launch, or -1 for a shape it was not built
// for.
extern "C" int coral_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* m, void* l, const void* seg, int B, int T,
                                         int Tk, int H, int D, long long stride_b,
                                         long long stride_t, float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return -1;
  if ((m == nullptr) != (l == nullptr)) return -1;
  if (seg == nullptr ? Tk != T : Tk < T) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const fwd::Args args{nullptr, nullptr, nullptr, nullptr, static_cast<const int*>(seg),
                       static_cast<bf16*>(o), static_cast<float*>(m), static_cast<float*>(l),
                       T, Tk, H, scale};
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto go = [&](auto kernel, auto policy) {
      return fwd::launch<kD, decltype(policy)>(kernel, q, k, v, args, B, stride_b, stride_t, s);
    };
    if (seg == nullptr)
      return m != nullptr ? go(flash_fwd_kernel<kD, true, false>, fwd::K7<true, false>{})
                          : go(flash_fwd_kernel<kD, false, false>, fwd::K7<false, false>{});
    return m != nullptr ? go(flash_fwd_kernel<kD, true, true>, fwd::K7<true, true>{})
                        : go(flash_fwd_kernel<kD, false, true>, fwd::K7<false, true>{});
  });
}

// The backward's key-major kernel (dk, dv) when dq is null, else its
// query-major kernel (dq), at head dim D; the other outputs are then not read.
// seg as the forward's. Returns the cudaError_t of the launch, or -1 for a
// shape it was not built for.
extern "C" int coral_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* m,
                                         const void* l, const void* seg, void* dq, void* dk,
                                         void* dv, int B, int T, int Tk, int H, int D,
                                         long long stride_b, long long stride_t, float scale,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return -1;
  if (seg == nullptr ? Tk != T : Tk < T) return -1;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *op = static_cast<const bf16*>(o),
             *dop = static_cast<const bf16*>(dout);
  const float *mp = static_cast<const float*>(m), *lp = static_cast<const float*>(l);
  const int* sp = static_cast<const int*>(seg);
  bf16 *dqp = static_cast<bf16*>(dq), *dkp = static_cast<bf16*>(dk), *dvp = static_cast<bf16*>(dv);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const cudaError_t err =
        seg == nullptr
            ? launch_flash_bwd<kD, false>(grid, s, qp, kp, vp, op, dop, mp, lp, sp, dqp, dkp, dvp,
                                          T, Tk, H, stride_b, stride_t, scale)
            : launch_flash_bwd<kD, true>(grid, s, qp, kp, vp, op, dop, mp, lp, sp, dqp, dkp, dvp,
                                         T, Tk, H, stride_b, stride_t, scale);
    return (int)err;
  });
}
