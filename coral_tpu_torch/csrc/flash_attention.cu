// Non-causal self-attention over the flat (B, T, H*64) layout: the forward
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
// products: 4 * T^2 * 64 flops and T^2 exponentials per head, against
// 4 * T * 64 * 2 bytes of q, k, v and o. At the encoder's T = 1500 that is
// about 750 flops per byte, far above the card's 295.
//
// Design: one block per (64-query tile, head, batch row), four warps of 16
// query rows each; the block walks 64-key tiles with an online softmax in
// fp32, so nothing of size T x T exists anywhere. Head h is the lane slice
// h*64 .. h*64+63 of each row, read through the row strides: no (B, H, T, d)
// copy is made. T need not be a multiple of the tile: keys at or past T get
// -inf in the last tile and contribute exactly 0 (the TPU wrapper pads T to
// its block grid and masks the padding with segment ids instead). As in the
// stock TPU kernel, scores are the bf16 product accumulated in fp32, then
// multiplied by the scale; the unnormalised probabilities are rounded to bf16
// for the product with V, and the sum is divided by the fp32 row sum at the
// end. Scores and P @ V go through bf16 WMMA fragments staged in shared memory,
// where two lanes share each query row for the softmax and the running output.
// The training launch also writes each row's final max m and its sum of
// exp(s - m), l (the stock kernel's residuals), in fp32 (B, H, T).
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
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kBQ = 64;         // queries per block
constexpr int kBKV = 64;        // keys per tile
constexpr int kThreads = 128;   // 4 warps x 16 query rows
constexpr int kLdH = kD + 8;    // bf16 row pitch of the Q, K, V and P tiles
constexpr int kLdS = kBKV + 4;  // fp32 row pitch of the staged S and P @ V
constexpr int kSmem = 4 * kBQ * kLdH * 2 + kBQ * kLdS * 4;
constexpr int kSegSmem = 64 * 4;  // one tile's segment ids, after the tiles

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Segment ids of rows r0 .. r0+63 (those at or past n: 0); threads 0..63.
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int r0, int n) {
  if (threadIdx.x < 64) dst[threadIdx.x] = r0 + (int)threadIdx.x < n ? seg[r0 + threadIdx.x] : 0;
}

// Rows r0 .. r0+63 of one head into a 64 x 64 tile; rows at or past T are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int T,
                                          long long stride_t) {
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i >> 3;
    const int c = (i & 7) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) u = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride_t + c);
    *reinterpret_cast<uint4*>(dst + r * kLdH + c) = u;
  }
}

// acc[j] (16 x 16 each, columns 16j ..) = A (16 x 64, pitch kLdH) times the
// transpose of B (64 x 64, pitch kLdH): the rows of B are the columns.
__device__ __forceinline__ void times_bt(FragC (&acc)[4], const bf16* A, const bf16* B) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, kLdH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc bt;
      wmma::load_matrix_sync(bt, B + (j * 16) * kLdH + kk, kLdH);
      wmma::mma_sync(acc[j], a, bt, acc[j]);
    }
  }
}

// acc[j] += A (16 x 64, pitch kLdH) times B (64 x 64, pitch kLdH).
__device__ __forceinline__ void times_b(FragC (&acc)[4], const bf16* A, const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, kLdH);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBr bf;
      wmma::load_matrix_sync(bf, B + kk * kLdH + j * 16, kLdH);
      wmma::mma_sync(acc[j], a, bf, acc[j]);
    }
  }
}

__device__ __forceinline__ void stage(float* Sw, FragC (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(Sw + j * 16, acc[j], kLdS, wmma::mem_row_major);
}

// q, k, v: (B, T, H*64) bf16 with strides (stride_b, stride_t, 1), the same for
// all three; o: (B, T, H*64) bf16 contiguous; with kStats, m and l: (B, H, T)
// fp32; with kSeg, seg: (B, Tk) int32 and keys run to Tk (else Tk = T).
template <bool kStats, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, const int* __restrict__ seg, int T, int Tk,
                     int H, long long stride_b, long long stride_t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Ps = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(Ps + kBQ * kLdH);
  int* seg_k = reinterpret_cast<int*>(Ss + kBQ * kLdS);  // kSeg: this tile's key ids

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;  // this lane's query row within the warp's 16
  const int half = lane & 1;  // and which 32 of the 64 columns it handles
  const long long head = (long long)b * stride_b + h * kD;

  load_rows(Qs, q + head, q0, T, stride_t);
  int seg_q = 0;  // this lane's query's segment
  if constexpr (kSeg) {
    seg += (long long)b * Tk;
    const int t = q0 + warp * 16 + row;
    seg_q = t < T ? seg[t] : 0;
  }

  float m = -INFINITY;  // running max of this row's scaled scores
  float l = 0.0f;       // running sum of exp(score - m)
  float acc[32];        // running sum of bf16(p) * v for this lane's 32 columns
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdH;
  const bf16* Qw = Qs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < (kSeg ? Tk : T); k0 += kBKV) {
    __syncthreads();  // the previous tile's K and V are no longer read
    load_rows(Ks, k + head, k0, T, stride_t);
    load_rows(Vs, v + head, k0, T, stride_t);
    if constexpr (kSeg) load_seg(seg_k, seg, k0, Tk);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows.
    FragC s[4];
    times_bt(s, Qw, Ks);
    stage(Sw, s);
    __syncwarp();

    // Online softmax over this tile; two lanes per row. Keys past T (Tk) or
    // of another segment: -inf.
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      bool in;
      if constexpr (kSeg) in = k0 + c < Tk && seg_k[c] == seg_q;
      else in = k0 + c < T;
      sv[j] = in ? Sw[row * kLdS + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    // Unmasked: finite, every tile holds a key < T. Segments: -inf while no
    // key of the row's segment was seen, and the tile's p and alpha are 0.
    const float m_new = fmaxf(m, mx);
    float m_use = m_new;
    if constexpr (kSeg) m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = expf(m - m_use);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_use);
      psum += p;
      Pw[row * kLdH + half * 32 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // P @ V for this warp's 16 rows, staged over S.
    FragC pv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(pv[j], 0.0f);
    times_b(pv, Pw, Vs);
    stage(Sw, pv);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = acc[j] * alpha + Sw[row * kLdS + half * 32 + j];
    __syncwarp();
  }

  const int t = q0 + warp * 16 + row;
  if (t < T) {
    float out[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) out[j] = acc[j] / l;
    bf16* orow = o + ((long long)b * T + t) * ((long long)H * kD) + h * kD + half * 32;
#pragma unroll
    for (int j = 0; j < 32; j += 8) coral_store8(orow + j, out + j);
    if (kStats && half == 0) {
      const long long i = ((long long)b * H + h) * T + t;
      m_out[i] = m;
      l_out[i] = l;
    }
  }
}

// --- Backward ------------------------------------------------------------------
//
// Replaces: coral_tpu/ops/flash_attention.py `_grads`: the stock TPU kernel's
// dkv backward (`_flash_attention_bwd_dkv`) and coral_tpu/ops/_flash_bwd_patch.py
// `flash_attention_bwd_dq_fixed`, from the forward's o, l and m.
//
// Bound on the H100: the tensor cores: the dkv kernel makes four T x T x 64
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
// its kernels: here each dkv block reads o once more per query tile, 64 x 64
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

constexpr int kBwdSmemDkv = 6 * kBQ * kLdH * 2 + kBQ * kLdS * 4 + 3 * 64 * 4;
constexpr int kBwdSmemDq = 5 * kBQ * kLdH * 2 + kBQ * kLdS * 4 + 3 * 64 * 4;
// kSeg launches add one tile's segment ids (kSegSmem) after di.

// m, 1/l and di = rowsum(o * do) of query rows q0 .. q0+63 (dOs already in
// shared memory); rows past T get m = +inf, 1/l = 1 and di = 0. Two threads a
// row.
__device__ __forceinline__ void load_query_stats(float* m_s, float* il_s, float* di_s,
                                                 const float* m_row, const float* l_row,
                                                 const bf16* dOs, const bf16* o_head, int q0,
                                                 int T, long long stride_o) {
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  float s = 0.f;
  if (q0 + r < T) {
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
      float a[8], d[8];
      coral_load8(o_head + (long long)(q0 + r) * stride_o + half * 32 + j, a);
      coral_load8(dOs + r * kLdH + half * 32 + j, d);
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

// A warp's 16 x 64 fp32 accumulators, rounded to bf16, to rows r0 + 16 warp ..
// of dst (rows at or past T are skipped).
__device__ __forceinline__ void store_rows(FragC (&acc)[4], float* Sw, bf16* dst,
                                           long long stride, int r0, int T) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1;
  const int half = lane & 1;
  stage(Sw, acc);
  __syncwarp();
  const int t = r0 + warp * 16 + row;
  if (t < T) {
    float out[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) out[j] = Sw[row * kLdS + half * 32 + j];
#pragma unroll
    for (int j = 0; j < 32; j += 8) coral_store8(dst + (long long)t * stride + half * 32 + j, out + j);
  }
}

// q, k, v as the forward; o, dout: (B, T, H*64) bf16 contiguous; m, l:
// (B, H, T) fp32; dk, dv: (B, T, H*64) bf16 contiguous; with kSeg, seg:
// (B, Tk) int32.
template <bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ m,
                         const float* __restrict__ l, const int* __restrict__ seg,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tk, int H,
                         long long stride_b, long long stride_t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* Qs = Vs + kBKV * kLdH;
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ps = dOs + kBQ * kLdH;
  bf16* dSs = Ps + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(dSs + kBKV * kLdH);
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
  const long long HD = (long long)H * kD;
  const long long head = (long long)b * stride_b + h * kD;
  const long long ohead = (long long)b * T * HD + h * kD;
  const long long stat = ((long long)b * H + h) * T;

  load_rows(Ks, k + head, k0, T, stride_t);
  load_rows(Vs, v + head, k0, T, stride_t);
  int seg_r = 0;  // this lane's key's segment
  if constexpr (kSeg) {
    seg += (long long)b * Tk;
    const int t = k0 + warp * 16 + row;
    seg_r = t < Tk ? seg[t] : 0;
  }

  FragC dk_acc[4], dv_acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* Pw = Ps + warp * 16 * kLdH;
  bf16* dSw = dSs + warp * 16 * kLdH;
  const bf16* Kw = Ks + warp * 16 * kLdH;
  const bf16* Vw = Vs + warp * 16 * kLdH;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // the previous query tile is no longer read
    load_rows(Qs, q + head, q0, T, stride_t);
    load_rows(dOs, dout + ohead, q0, T, HD);
    if constexpr (kSeg) load_seg(seg_s, seg, q0, T);
    __syncthreads();
    load_query_stats(m_s, il_s, di_s, m + stat, l + stat, dOs, o + ohead, q0, T, HD);
    __syncthreads();

    // S^T = K_w Q^T for this warp's 16 keys; p^T.
    FragC s[4];
    times_bt(s, Kw, Qs);
    stage(Sw, s);
    __syncwarp();
    float p[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      p[j] = expf(Sw[row * kLdS + c] * scale - m_s[c]) * il_s[c];
      if constexpr (kSeg) p[j] = seg_s[c] == seg_r ? p[j] : 0.0f;
      Pw[row * kLdH + c] = __float2bfloat16(p[j]);
    }
    __syncwarp();

    // dP^T = V_w dO^T; dS^T.
    times_bt(s, Vw, dOs);
    stage(Sw, s);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdH + c] = __float2bfloat16((Sw[row * kLdS + c] - di_s[c]) * p[j] * scale);
    }
    __syncwarp();

    // dV += P^T dO and dK += dS^T Q.
    times_b(dv_acc, Pw, dOs);
    times_b(dk_acc, dSw, Qs);
    __syncwarp();
  }

  store_rows(dk_acc, Sw, dk + ohead, HD, k0, T);
  __syncwarp();
  store_rows(dv_acc, Sw, dv + ohead, HD, k0, T);
}

// As flash_bwd_dkv_kernel, for dq: (B, T, H*64) bf16 contiguous.
template <bool kSeg>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, const float* __restrict__ m,
                        const float* __restrict__ l, const int* __restrict__ seg,
                        bf16* __restrict__ dq, int T, int Tk, int H, long long stride_b,
                        long long stride_t, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBQ * kLdH;
  bf16* Ks = dOs + kBQ * kLdH;
  bf16* Vs = Ks + kBKV * kLdH;
  bf16* dSs = Vs + kBKV * kLdH;
  float* Ss = reinterpret_cast<float*>(dSs + kBQ * kLdH);
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
  const long long HD = (long long)H * kD;
  const long long head = (long long)b * stride_b + h * kD;
  const long long ohead = (long long)b * T * HD + h * kD;
  const long long stat = ((long long)b * H + h) * T;

  load_rows(Qs, q + head, q0, T, stride_t);
  load_rows(dOs, dout + ohead, q0, T, HD);
  __syncthreads();
  load_query_stats(m_s, il_s, di_s, m + stat, l + stat, dOs, o + ohead, q0, T, HD);
  int seg_r = 0;  // this lane's query's segment
  if constexpr (kSeg) {
    seg += (long long)b * Tk;
    const int t = q0 + warp * 16 + row;
    seg_r = t < T ? seg[t] : 0;
  }

  FragC dq_acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(dq_acc[j], 0.0f);
  float* Sw = Ss + warp * 16 * kLdS;
  bf16* dSw = dSs + warp * 16 * kLdH;
  const bf16* Qw = Qs + warp * 16 * kLdH;
  const bf16* dOw = dOs + warp * 16 * kLdH;

  for (int k0 = 0; k0 < T; k0 += kBKV) {
    __syncthreads();  // the previous key tile is no longer read
    load_rows(Ks, k + head, k0, T, stride_t);
    load_rows(Vs, v + head, k0, T, stride_t);
    if constexpr (kSeg) load_seg(seg_s, seg, k0, T);
    __syncthreads();
    const float m_r = m_s[warp * 16 + row];
    const float il_r = il_s[warp * 16 + row];
    const float di_r = di_s[warp * 16 + row];

    // S = Q_w K^T; p, 0 for keys past T.
    FragC s[4];
    times_bt(s, Qw, Ks);
    stage(Sw, s);
    __syncwarp();
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
    times_bt(s, dOw, Vs);
    stage(Sw, s);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      dSw[row * kLdH + c] = __float2bfloat16((Sw[row * kLdS + c] - di_r) * p[j] * scale);
    }
    __syncwarp();

    // dQ += dS K.
    times_b(dq_acc, dSw, Ks);
    __syncwarp();
  }

  store_rows(dq_acc, Sw, dq + ohead, HD, q0, T);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool kStats, bool kSeg>
cudaError_t launch_fwd(dim3 grid, cudaStream_t s, const bf16* q, const bf16* k, const bf16* v,
                       bf16* o, float* m, float* l, const int* seg, int T, int Tk, int H,
                       long long stride_b, long long stride_t, float scale) {
  const int smem = kSmem + (kSeg ? kSegSmem : 0);
  const cudaError_t err = set_smem(flash_fwd_kernel<kStats, kSeg>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<kStats, kSeg><<<grid, kThreads, smem, s>>>(q, k, v, o, m, l, seg, T, Tk, H,
                                                              stride_b, stride_t, scale);
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t launch_bwd(dim3 grid, cudaStream_t s, const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const bf16* dout, const float* m, const float* l,
                       const int* seg, bf16* dq, bf16* dk, bf16* dv, int T, int Tk, int H,
                       long long stride_b, long long stride_t, float scale) {
  const int extra = kSeg ? kSegSmem : 0;
  cudaError_t err;
  if (dq == nullptr) {
    err = set_smem(flash_bwd_dkv_kernel<kSeg>, kBwdSmemDkv + extra);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_kernel<kSeg><<<grid, kThreads, kBwdSmemDkv + extra, s>>>(
        q, k, v, o, dout, m, l, seg, dk, dv, T, Tk, H, stride_b, stride_t, scale);
  } else {
    err = set_smem(flash_bwd_dq_kernel<kSeg>, kBwdSmemDq + extra);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<kSeg><<<grid, kThreads, kBwdSmemDq + extra, s>>>(
        q, k, v, o, dout, m, l, seg, dq, T, Tk, H, stride_b, stride_t, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// The forward; m and l both null (serving: o only) or both (B, H, T) fp32
// (training). seg null (unmasked, Tk = T) or (B, Tk) int32 segment ids with
// Tk >= T (the padded call's key count). Returns the cudaError_t of the
// launch, or -1 for a shape it was not built for.
extern "C" int coral_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* m, void* l, const void* seg, int B, int T,
                                         int Tk, int H, long long stride_b, long long stride_t,
                                         float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return -1;
  if ((m == nullptr) != (l == nullptr)) return -1;
  if (seg == nullptr ? Tk != T : Tk < T) return -1;
  const dim3 grid((unsigned)((T + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float *mp = static_cast<float*>(m), *lp = static_cast<float*>(l);
  const int* sp = static_cast<const int*>(seg);
  cudaError_t err;
  if (seg == nullptr) {
    err = m != nullptr ? launch_fwd<true, false>(grid, s, qp, kp, vp, op, mp, lp, sp, T, Tk, H,
                                                 stride_b, stride_t, scale)
                       : launch_fwd<false, false>(grid, s, qp, kp, vp, op, mp, lp, sp, T, Tk, H,
                                                  stride_b, stride_t, scale);
  } else {
    err = m != nullptr ? launch_fwd<true, true>(grid, s, qp, kp, vp, op, mp, lp, sp, T, Tk, H,
                                                stride_b, stride_t, scale)
                       : launch_fwd<false, true>(grid, s, qp, kp, vp, op, mp, lp, sp, T, Tk, H,
                                                 stride_b, stride_t, scale);
  }
  return (int)err;
}

// The backward's key-major kernel (dk, dv) when dq is null, else its
// query-major kernel (dq); the other outputs are then not read. seg as the
// forward's. Returns the cudaError_t of the launch, or -1 for a shape it was
// not built for.
extern "C" int coral_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* m,
                                         const void* l, const void* seg, void* dq, void* dk,
                                         void* dv, int B, int T, int Tk, int H,
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
  const cudaError_t err =
      seg == nullptr ? launch_bwd<false>(grid, s, qp, kp, vp, op, dop, mp, lp, sp, dqp, dkp, dvp,
                                         T, Tk, H, stride_b, stride_t, scale)
                     : launch_bwd<true>(grid, s, qp, kp, vp, op, dop, mp, lp, sp, dqp, dkp, dvp,
                                        T, Tk, H, stride_b, stride_t, scale);
  return (int)err;
}
