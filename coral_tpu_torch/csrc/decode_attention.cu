// One-token attention of a decode step over a stacked flat K/V store: the
// Whisper decoder's self-attention over its cache (with the beam slot mask)
// and its cross-attention over the encoder's K/V.
//
// Replaces: coral_tpu/ops/decode_attention.py `decode_self_attention`
// (`pallas_call` -> `_self_kernel`) and `decode_cross_attention`
// (`pallas_call` -> `_cross_kernel`). Both read layer `layer` of an
// (L, rows, HD) store by offset (the TPU kernels' scalar-prefetch block
// index), so no per-layer slice is ever materialised.
//
// Query row b*K + k (batch item b, beam k) attends the n_keys rows of item b:
// for the self-attention the K*T_b cache slots of b's K beams (rows
// b*K*T_b .. b*K*T_b + K*T_b - 1 of the layer, a contiguous block), masked by
// onehot[b, k, slot] > 0 with the finite -1e30 otherwise; for the
// cross-attention the S encoder rows of item b, unmasked (the K beams share
// them). Per head: s = (q . k) * scale in fp32, softmax, p @ v.
//
// Bound on the H100: device memory. A decode step reads every key and value
// once and does 4 flops per element read: at Whisper large-v3's 8 x 1500
// encoder rows a cross-attention launch reads 61 MB (32 layers: 1.97 GB per
// step) for 0.13 GFLOP.
//
// Design (split-S, "flash decoding"): one block per (chunk of 128 keys, head,
// batch item), so a launch over 1500 keys, 20 heads and 8 items has 1920
// blocks in flight across the 132 SMs. A block stages its K and V chunk in
// shared memory with 16-byte loads (eight of each in flight per thread),
// scores it for all K beams of the item, and writes each beam's partial
// softmax (the chunk's max m, sum l and unnormalised p @ v in fp32). A second
// kernel combines the chunks of each (query row, head) with the usual
// rescaling exp(m_c - M). Unlike the TPU kernel, which rounds the normalised
// probabilities to bf16 before p @ v, the products here stay fp32 until the
// output is rounded to bf16 once. A chunk whose keys are all masked has
// m = -1e30 and drops out of the combination unless every key of the row is
// masked, where the row averages uniformly, as softmax over -1e30 does.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kChunk = 128;     // keys per block
constexpr int kThreads = 128;   // one thread per key while scoring
constexpr int kLdH = kD + 8;    // bf16 row pitch of the staged K and V
constexpr int kMaxBeams = 64;   // beams per batch item (shared memory)
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr int smem_bytes(int beams) {
  return 2 * kChunk * kLdH * 2 + beams * (kD + kChunk) * 4 + 2 * kD * 4;
}

// q: (B*K, H*64) bf16; kv_k, kv_v: the layer's (B, n_keys, H*64) bf16 block;
// mask: (B, K, n_keys) fp32 or null; part_o: (B*K, H, n_chunks, 64) fp32;
// part_ml: (B*K, H, n_chunks, 2) fp32.
__global__ void __launch_bounds__(kThreads)
    decode_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv_k,
                          const bf16* __restrict__ kv_v, const float* __restrict__ mask,
                          float* __restrict__ part_o, float* __restrict__ part_ml, int K,
                          int n_keys, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kChunk * kLdH;
  float* qs = reinterpret_cast<float*>(Vs + kChunk * kLdH);  // (K, 64)
  float* ps = qs + K * kD;                                    // (K, kChunk)
  float* red = ps + K * kChunk;                               // (2, 64)

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x;
  const long long HD = (long long)H * kD;
  const int key0 = c * kChunk;
  const long long item = (long long)b * n_keys * HD + h * kD;

  for (int i = tid; i < K * kD; i += kThreads) {
    const int kk = i / kD, d = i % kD;
    qs[i] = __bfloat162float(q[((long long)b * K + kk) * HD + h * kD + d]);
  }
  for (int i = tid; i < kChunk * (kD / 8); i += kThreads) {
    const int r = i >> 3;
    const int col = (i & 7) * 8;
    uint4 uk = make_uint4(0u, 0u, 0u, 0u), uv = uk;
    if (key0 + r < n_keys) {
      const long long off = item + (long long)(key0 + r) * HD + col;
      uk = *reinterpret_cast<const uint4*>(kv_k + off);
      uv = *reinterpret_cast<const uint4*>(kv_v + off);
    }
    *reinterpret_cast<uint4*>(Ks + r * kLdH + col) = uk;
    *reinterpret_cast<uint4*>(Vs + r * kLdH + col) = uv;
  }
  __syncthreads();

  // Scores: thread tid scores key key0 + tid against every beam's query.
  {
    const int key = key0 + tid;
    float kr[kD];
#pragma unroll
    for (int j = 0; j < kD; j += 8) coral_load8(Ks + tid * kLdH + j, kr + j);
    for (int kk = 0; kk < K; ++kk) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kD; ++j) s += qs[kk * kD + j] * kr[j];
      s *= scale;
      if (key >= n_keys) {
        s = -INFINITY;
      } else if (mask != nullptr &&
                 !(mask[((long long)b * K + kk) * n_keys + key] > 0.f)) {
        s = kMasked;
      }
      ps[kk * kChunk + tid] = s;
    }
  }
  __syncthreads();

  // Each beam's chunk max and sum (warp w takes beams w, w + 4, ...); p in place.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int kk = warp; kk < K; kk += kThreads / 32) {
    float* pr = ps + kk * kChunk;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) mx = fmaxf(mx, pr[lane + 32 * i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 32; ++i) {
      const float p = expf(pr[lane + 32 * i] - mx);  // -inf (past n_keys) -> 0
      pr[lane + 32 * i] = p;
      sum += p;
    }
    sum = coral_warp_sum(sum);
    if (lane == 0) {
      const long long slot = (((long long)b * K + kk) * H + h) * n_chunks + c;
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = sum;
    }
  }
  __syncthreads();

  // p @ v for each beam: thread (d, half) sums 64 of the chunk's keys.
  const int d = tid & (kD - 1);
  const int half = tid >> 6;
  for (int kk = 0; kk < K; ++kk) {
    const float* pr = ps + kk * kChunk + half * 64;
    const bf16* vc = Vs + half * 64 * kLdH + d;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < 64; ++r) acc += pr[r] * __bfloat162float(vc[r * kLdH]);
    red[half * kD + d] = acc;
    __syncthreads();
    if (tid < kD) {
      const long long slot = (((long long)b * K + kk) * H + h) * n_chunks + c;
      part_o[slot * kD + tid] = red[tid] + red[kD + tid];
    }
    __syncthreads();
  }
}

// out[row, h*64 + d] = sum_c exp(m_c - M) o_c[d] / sum_c exp(m_c - M) l_c,
// M = max_c m_c. One block of 64 threads per (query row, head).
__global__ void __launch_bounds__(kD)
    decode_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                          bf16* __restrict__ out, int H, int n_chunks) {
  const long long rh = blockIdx.x;  // row * H + h
  const int d = threadIdx.x;
  const float* ml = part_ml + rh * n_chunks * 2;
  float M = -INFINITY;
  for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f, O = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float w = expf(ml[2 * c] - M);
    L += w * ml[2 * c + 1];
    O += w * part_o[(rh * n_chunks + c) * kD + d];
  }
  const long long row = rh / H;
  const int h = (int)(rh % H);
  out[row * H * kD + h * kD + d] = __float2bfloat16(O / L);
}

}  // namespace

// q: (B*K, H*64) bf16; k, v: (L, B, n_keys, H*64) bf16 stores of which layer
// `layer` is read; mask: (B, K, n_keys) fp32 or null; part_o, part_ml: scratch
// of (B*K, H, ceil(n_keys / 128)) x 64 and x 2 fp32; out: (B*K, H*64) bf16.
// Returns the cudaError_t of the launches, or -1 for a shape they were not
// built for.
extern "C" int coral_decode_attention(const void* q, const void* k, const void* v,
                                      const void* mask, void* part_o, void* part_ml,
                                      void* out, int B, int K, int n_keys, int H, int layer,
                                      float scale, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxBeams || n_keys <= 0 || H <= 0 || layer < 0 || B > 65535 ||
      H > 65535)
    return -1;
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  const long long layer_off = (long long)layer * B * n_keys * H * kD;
  const int smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(decode_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes(kMaxBeams));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_partial_kernel<<<dim3((unsigned)n_chunks, (unsigned)H, (unsigned)B), kThreads, smem,
                          s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k) + layer_off,
      static_cast<const bf16*>(v) + layer_off, static_cast<const float*>(mask),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), K, n_keys, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<(unsigned)((long long)B * K * H), kD, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<bf16*>(out), H, n_chunks);
  return (int)cudaGetLastError();
}
