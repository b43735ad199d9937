// CTC alpha (forward) and beta (backward) recursions in log space.
//
// Replaces: coral_tpu/ops/ctc_pallas.py `alpha_recursion` / `_alpha_kernel` and
// `beta_recursion` / `_beta_kernel` (K6), which run the whole time recursion
// inside one Pallas program with the (batch block, S) state in VMEM scratch.
//
// Bound on the H100: latency. Each of the T steps depends on the one before,
// and a step is a few flops on S = 2L+1 states per batch row (S = 257 at
// L = 128), so the card's width cannot be used; the kernel exists to keep the
// T steps inside one launch, as the TPU kernel does.
//
// Design: one block per batch row, one thread per extended-label state (a
// thread loops when S exceeds 1024). The state lives in shared memory, double
// buffered, with one barrier per time step. The arithmetic is the TPU
// kernel's: the finite floor -1e30 for -inf and `_log_add`'s clamp, so no NaN
// can appear and `zero_infinity` finds infeasible rows with the same test.
// Alpha freezes once t reaches a row's length; beta starts at each row's last
// frame from its terminal states (`last`), walking t from T-1 down to 0.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float log_add(float a, float b) {
  const float mx_safe = fmaxf(fmaxf(a, b), kNegInf);
  return mx_safe + log1pf(expf(fminf(a, b) - mx_safe));
}

// emit, out: (T, B, S) fp32; skip, valid, last: (B, S) uint8; lengths: (B,).
template <bool kBeta>
__global__ void ctc_kernel(const float* __restrict__ emit, const uint8_t* __restrict__ skip,
                           const uint8_t* __restrict__ valid, const uint8_t* __restrict__ last,
                           const int* __restrict__ lengths, float* __restrict__ out, int T,
                           int B, int S) {
  extern __shared__ float state[];
  float* cur = state;
  float* nxt = state + S;
  const int b = blockIdx.x;
  const int len = lengths[b];
  const uint8_t* skip_b = skip + (long long)b * S;
  const uint8_t* valid_b = valid + (long long)b * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) cur[s] = kNegInf;
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    const int t = kBeta ? T - 1 - i : i;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const long long idx = ((long long)t * B + b) * S + s;
      const float e = emit[idx];
      const bool ok = valid_b[s] != 0;
      const float here = cur[s];
      float val;
      if (!kBeta) {
        if (t == 0) {
          val = (ok && s <= 1) ? e : kNegInf;
        } else {
          float sum = log_add(here, s >= 1 ? cur[s - 1] : kNegInf);
          if (skip_b[s]) sum = log_add(sum, s >= 2 ? cur[s - 2] : kNegInf);
          val = t < len ? (ok ? sum + e : kNegInf) : here;
        }
      } else {
        float sum = log_add(here, s + 1 < S ? cur[s + 1] : kNegInf);
        if (skip_b[s]) sum = log_add(sum, s + 2 < S ? cur[s + 2] : kNegInf);
        float nv = sum + e;
        if (t == len - 1) nv = last[(long long)b * S + s] ? e : kNegInf;
        if (!ok) nv = kNegInf;
        val = t <= len - 1 ? nv : here;
      }
      nxt[s] = val;
      out[idx] = val;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

int launch(bool beta, const void* emit, const void* skip, const void* valid, const void* last,
           const void* lengths, void* out, int T, int B, int S, void* stream) {
  if (T <= 0 || B <= 0 || S <= 0) return 0;
  const int threads = S >= 1024 ? 1024 : ((S + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)S * sizeof(float);
  if (smem > 48 * 1024) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ep = static_cast<const float*>(emit);
  const uint8_t* sp = static_cast<const uint8_t*>(skip);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const uint8_t* lp = static_cast<const uint8_t*>(last);
  const int* np = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(out);
  if (beta)
    ctc_kernel<true><<<B, threads, smem, s>>>(ep, sp, vp, lp, np, op, T, B, S);
  else
    ctc_kernel<false><<<B, threads, smem, s>>>(ep, sp, vp, lp, np, op, T, B, S);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha_t[s] for every t; skip: s-2 -> s allowed. Returns the cudaError_t of
// the launch, or -1 for an S whose state does not fit 48 KB of shared memory.
extern "C" int coral_ctc_alpha(const void* emit, const void* skip, const void* valid,
                               const void* lengths, void* out, int T, int B, int S,
                               void* stream) {
  return launch(false, emit, skip, valid, nullptr, lengths, out, T, B, S, stream);
}

// beta_t[s] for every t (emission at t included); skip: s -> s+2 allowed; last:
// the terminal states.
extern "C" int coral_ctc_beta(const void* emit, const void* skip, const void* valid,
                              const void* lengths, const void* last, void* out, int T, int B,
                              int S, void* stream) {
  return launch(true, emit, skip, valid, last, lengths, out, T, B, S, stream);
}
