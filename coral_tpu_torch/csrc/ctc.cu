// CTC alpha (forward) and beta (backward) recursions in log space (K6).
//
// Replaces: coral_tpu/ops/ctc_pallas.py `alpha_recursion` :191 -> pallas_call
// :206 -> `_alpha_kernel` :81 and `beta_recursion` :230 -> :249 ->
// `_beta_kernel` :125. The TPU runs the whole time recursion in one Pallas
// program a block of 8 batch rows, the (8, Sp) state in VMEM scratch, the
// emissions streamed in time chunks of up to 128 steps (double-buffered into
// VMEM) and the outputs written back a chunk at a time.
//
// Bound on the H100: latency. Each of the T steps depends on the one before,
// and a step is two dependent log-adds (an exp and a log each) on S = 2L+1
// states a batch row (S = 257 at L = 128): the bytes (the emissions in, the
// outputs out, 0.0025 ms at T 499, B 8, S 257) cannot set the time. What
// does is T times the step's dependent chain: the neighbours' states, the
// two log-adds, and a block barrier. coral_ctc_probe's floor mode runs that
// chain alone (the same recursion, the state in registers, no global
// traffic): the floor the kernel is held to (tools/probe_ctc.py).
//
// Design: one block a batch row, R consecutive states a thread (R = 1 up to
// S = 1024, then 2, 4, 6: S <= 6144 = 1024 threads x 6), so a warp owns 32 R
// consecutive states. Before the time loop each thread reads its states'
// skip, valid and terminal bits and the row's length into registers; the
// state lives in registers. A step takes s-1 and s-2 (beta: s+1 and s+2) from
// the thread's own registers, from its neighbour lane by __shfl_up_sync
// (__shfl_down_sync), and, for the warp's edge lanes, from the neighbouring
// warp's two edge values in a double-buffered shared-memory slot written the
// step before; one __syncthreads a step orders those slots (a flag between
// neighbouring warps instead, spinning on shared memory, was 1.7-2.0x
// slower). No global load or store sits on a step. Warp 0 keeps the
// emissions of the next time chunk (up to 64 steps, 96 KB a stage) in flight
// by bulk copies (cp.async.bulk, one per time step's row of the batch row,
// all on the stage's mbarrier) into a two-stage shared-memory ring while the
// recursion runs the current chunk; a thread waits on a chunk's barrier once,
// at its first step. Each thread writes its new states over the emissions it
// has just read, so a stage holds the chunk's outputs at its end; the block
// then fences the async proxy, meets at a barrier, and warp 0 copies the
// chunk's rows out by bulk copies, which read the stage while the next chunk
// runs (its refill waits for those reads, 8 steps into the next chunk).
// Stored from registers every step instead, the outputs made the kernel
// 1.11-1.14x slower. Beta walks the chunks from the row's last frame down.
// A bulk copy needs 16-byte aligned rows, so the emissions and the outputs
// come in rows of `ld` floats, ld a multiple of 4 at least S (ops/ctc.py
// gathers the emissions into rows of S rounded up to 4 and hands out the
// (T, B, S) views; the padding is never read as a state: states at or past S
// are -inf by their valid bit).
//
// Only the steps the row needs run the recursion: alpha t = 0 .. len - 1 (t
// = 0 always), then the frozen state is stored for the rest; beta t = len - 1
// .. 0, with -inf stored above. The arithmetic is the TPU kernel's and the
// plain versions' in its form, the finite floor -1e30 for -inf and
// `_log_add`'s clamp, so no NaN appears and `zero_infinity` finds infeasible
// rows with the same test; the log-add's exp and log are the hardware's
// approximations (__expf, __logf of 1 + the exp: within a few 1e-7 of
// expf and log1pf on [0, 1]; the floor runs 1.55-1.65x faster on them), held
// to the plain versions at atol 1e-3 and rtol 1e-5 as before. Every value
// has one order of operations, so two calls give the same bits. Timed on an
// H100 from edited copies (tools/probe_ctc.py, PERF.md §6).
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxStates = 6144;  // 1024 threads x 6 states
constexpr int kStages = 2;        // the emission ring
constexpr int kStageBytes = 96 * 1024;
constexpr int kMaxChunk = 64;     // time steps a stage
constexpr int kRefillStep = 8;    // the step of a chunk that refills the stage before it
// The ring, the edge slots of up to 32 warps, the stages' mbarriers.
constexpr int kSmemMax = kStages * kStageBytes + 2 * 33 * 8 + 8 * kStages;

__device__ __forceinline__ float log_add(float a, float b) {
  const float mx_safe = fmaxf(fmaxf(a, b), kNegInf);
  return mx_safe + __logf(1.f + __expf(fminf(a, b) - mx_safe));
}

struct Args {
  const float* emit;     // (T, B, ld) fp32: row (t, b) at (t B + b) ld
  const uint8_t* skip;   // (B, S): alpha s-2 -> s, beta s -> s+2
  const uint8_t* valid;  // (B, S)
  const uint8_t* last;   // (B, S): beta's terminal states
  const int* lengths;    // (B,)
  float* out;            // (T, B, ld): the first S of each row
  int T, B, S, ld;
  int pitch;             // floats a step's row takes in the ring: the block's states
  int chunk;             // steps a ring stage holds
};

// R states a thread: 1 up to 1024 states, then 2, 4, 6.
inline int states_per_thread(int S) {
  return S <= 1024 ? 1 : S <= 2048 ? 2 : S <= 4096 ? 4 : 6;
}

// R consecutive floats of shared memory (8-byte aligned where R is even,
// 16-byte where R is a multiple of 4) to and from registers.
template <int R>
__device__ __forceinline__ void load_states(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x, v[i + 1] = u.y, v[i + 2] = u.z, v[i + 3] = u.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const float2 u = *reinterpret_cast<const float2*>(p + i);
      v[i] = u.x, v[i + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}
template <int R>
__device__ __forceinline__ void store_states(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = v[i];
  }
}

// One block a batch row, 32 R x warps threads. kFloor: the recursion alone
// (no ring, no stores but the last state's): the probe's latency floor.
template <int R, bool kBeta, bool kFloor>
__global__ void __launch_bounds__(1024, 1) ctc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  float* ring = reinterpret_cast<float*>(smem);  // kStages x chunk x pitch
  float2* edge = reinterpret_cast<float2*>(ring + kStages * a.chunk * a.pitch);
  const uint32_t bars = hopper::smem_u32(edge + 2 * (warps + 1));
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int s0 = threadIdx.x * R;
  const int len = a.lengths[b];
  // The steps that run the recursion: alpha i = t, t = 0 .. n - 1; beta t =
  // n - 1 - i. Chunk k holds steps k chunk .. .
  const int n = kBeta ? max(0, min(len, a.T)) : max(1, min(len, a.T));
  const int n_chunks = (n + a.chunk - 1) / a.chunk;
  const int Sc = (a.S + 3) & ~3;  // floats a bulk copy moves: 16-byte multiples
  auto row = [&](int i) { return kBeta ? n - 1 - i : i; };  // step i's time

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) hopper::mbar_init(bars + 8 * i, 1);
    hopper::fence_barrier_init();
  }
  // The edge slots: warp w's for alpha at w + 1 (slot 0 stays -inf), for
  // beta at w (slot `warps` stays -inf), each double-buffered.
  for (int i = threadIdx.x; i < 2 * (warps + 1); i += blockDim.x)
    edge[i] = make_float2(kNegInf, kNegInf);
  // The ring rows past the copied states (no copy writes them) are read as
  // states past S, whose valid bit discards them: keep them finite.
  const int tail = a.pitch - Sc;
  if (tail > 0)
    for (int i = threadIdx.x; i < kStages * a.chunk * tail; i += blockDim.x)
      ring[(i / tail) * a.pitch + Sc + i % tail] = 0.f;
  __syncthreads();

  // Warp 0: chunk k's rows into stage k % kStages, on its barrier, once the
  // copies out of the stage's last chunk have read it.
  auto issue = [&](int k) {
    const int steps = min(a.chunk, n - k * a.chunk);
    const uint32_t bar = bars + 8 * (k % kStages);
    const uint32_t dst = hopper::smem_u32(ring + (k % kStages) * a.chunk * a.pitch);
    hopper::bulk_wait<true>();
    if (lane == 0) hopper::mbar_arrive_expect_tx(bar, (uint32_t)(steps * Sc * 4));
    __syncwarp();
    for (int j = lane; j < steps; j += 32)
      hopper::bulk_load(dst + j * a.pitch * 4,
                        a.emit + ((long long)row(k * a.chunk + j) * a.B + b) * a.ld,
                        (uint32_t)(Sc * 4), bar);
  };
  if constexpr (!kFloor) {
    if (warp == 0)
      for (int k = 0; k < kStages && k < n_chunks; ++k) issue(k);
  }

  // The masks and the terminal bits into registers; states past S invalid.
  uint32_t ok = 0u, skp = 0u, term = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = s0 + r;
    if (s < a.S) {
      const long long at = (long long)b * a.S + s;
      ok |= (a.valid[at] != 0 ? 1u : 0u) << r;
      skp |= (a.skip[at] != 0 ? 1u : 0u) << r;
      if (kBeta) term |= (a.last[at] != 0 ? 1u : 0u) << r;
    }
  }
  float st[R];
#pragma unroll
  for (int r = 0; r < R; ++r) st[r] = kNegInf;
  const long long out_pitch = (long long)a.B * a.ld;  // floats from step t's row to t + 1's
  float* out = a.out + (long long)b * a.ld;
  float e_floor = 0.f;
  if constexpr (kFloor) e_floor = a.emit[(long long)b * a.ld];
  const int rd = warp + (kBeta ? 1 : 0), wr = warp + (kBeta ? 0 : 1);

#pragma unroll 1
  for (int k = 0; k < n_chunks; ++k) {
    const int steps = min(a.chunk, n - k * a.chunk);
    float* stage = ring + (k % kStages) * a.chunk * a.pitch;
    if constexpr (!kFloor)
      hopper::mbar_wait(bars + 8 * (k % kStages), (uint32_t)((k / kStages) & 1));
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      const int i = k * a.chunk + j;
      const int t = row(i);
      if constexpr (!kFloor) {
        // The previous chunk's stage, copied out at its end: the next chunk's
        // emissions.
        if (warp == 0 && k > 0 && k + 1 < n_chunks && j == min(kRefillStep, steps - 1))
          issue(k + 1);
      }
      float e[R];
      if constexpr (kFloor) {
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = e_floor;
      } else {
        load_states<R>(stage + j * a.pitch + s0, e);
      }
      const float2 in = edge[(i & 1) * (warps + 1) + rd];
      float nx[R];
      if (!kBeta && i == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          nx[r] = ((ok >> r) & 1u) && s0 + r <= 1 ? e[r] : kNegInf;
      } else if constexpr (!kBeta) {
        // s-1 and s-2 of the thread's first state: lane - 1's last two (lane
        // - 2's state where R = 1), the warp below's edge for lanes 0 (and 1).
        float lo1 = __shfl_up_sync(0xffffffffu, st[R - 1], 1);
        float lo2 = R == 1 ? __shfl_up_sync(0xffffffffu, st[0], 2)
                           : __shfl_up_sync(0xffffffffu, st[R > 1 ? R - 2 : 0], 1);
        if (lane == 0) lo1 = in.y, lo2 = in.x;
        if (R == 1 && lane == 1) lo2 = in.y;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p1 = r == 0 ? lo1 : st[r > 0 ? r - 1 : 0];
          const float p2 = r == 0 ? lo2 : r == 1 ? lo1 : st[r > 1 ? r - 2 : 0];
          float sum = log_add(st[r], p1);
          const float with_skip = log_add(sum, p2);
          sum = (skp >> r) & 1u ? with_skip : sum;
          nx[r] = (ok >> r) & 1u ? sum + e[r] : kNegInf;
        }
      } else {
        // s+1 and s+2 of the thread's last state: lane + 1's first two (lane
        // + 2's state where R = 1), the warp above's edge for lanes 31 (and 30).
        float hi1 = __shfl_down_sync(0xffffffffu, st[0], 1);
        float hi2 = R == 1 ? __shfl_down_sync(0xffffffffu, st[0], 2)
                           : __shfl_down_sync(0xffffffffu, st[R > 1 ? 1 : 0], 1);
        if (lane == 31) hi1 = in.x, hi2 = in.y;
        if (R == 1 && lane == 30) hi2 = in.x;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float n1 = r == R - 1 ? hi1 : st[r + 1 < R ? r + 1 : 0];
          const float n2 = r == R - 1 ? hi2 : r == R - 2 ? hi1 : st[r + 2 < R ? r + 2 : 0];
          float sum = log_add(st[r], n1);
          const float with_skip = log_add(sum, n2);
          sum = (skp >> r) & 1u ? with_skip : sum;
          float v = sum + e[r];
          if (t == len - 1) v = (term >> r) & 1u ? e[r] : kNegInf;
          nx[r] = (ok >> r) & 1u ? v : kNegInf;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) st[r] = nx[r];
      // The edge values the neighbouring warp reads at the next step.
      float2* slot = edge + ((i + 1) & 1) * (warps + 1) + wr;
      if constexpr (R == 1) {
        if (!kBeta && lane >= 30) reinterpret_cast<float*>(slot)[lane - 30] = st[0];
        if (kBeta && lane <= 1) reinterpret_cast<float*>(slot)[lane] = st[0];
      } else {
        if (!kBeta && lane == 31) *slot = make_float2(st[R - 2], st[R - 1]);
        if (kBeta && lane == 0) *slot = make_float2(st[0], st[1]);
      }
      // The step's outputs over the emissions just read.
      if constexpr (!kFloor) store_states<R>(stage + j * a.pitch + s0, st);
      __syncthreads();
    }
    if constexpr (!kFloor) {
      // The chunk's outputs out of its stage: the copies read it while the
      // next chunk runs.
      hopper::fence_proxy_async();
      __syncthreads();
      if (warp == 0) {
        for (int j = lane; j < steps; j += 32)
          hopper::bulk_store(out + row(k * a.chunk + j) * out_pitch,
                             hopper::smem_u32(stage + j * a.pitch), (uint32_t)(Sc * 4));
        hopper::bulk_commit();
      }
    }
  }
  if constexpr (kFloor) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r < a.S) out[s0 + r] = st[r];
    return;
  }
  // The steps the recursion skipped: alpha's frozen state, beta's -inf.
  for (int t = n; t < a.T; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s0 + r < a.S) out[t * out_pitch + s0 + r] = kBeta ? kNegInf : st[r];
  }
  if (warp == 0) hopper::bulk_wait<false>();
}

template <int R, bool kBeta, bool kFloor>
int launch_r(Args a, cudaStream_t s) {
  // Once per instantiation and process, off every later call's path.
  static const cudaError_t attr = cudaFuncSetAttribute(
      ctc_kernel<R, kBeta, kFloor>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const int warps = (a.S + 32 * R - 1) / (32 * R);
  a.pitch = warps * 32 * R;
  a.chunk = kStageBytes / (a.pitch * 4);
  if (a.chunk > kMaxChunk) a.chunk = kMaxChunk;
  const size_t smem = (size_t)kStages * a.chunk * a.pitch * 4 + 2 * (warps + 1) * 8 + 8 * kStages;
  ctc_kernel<R, kBeta, kFloor><<<a.B, 32 * warps, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kBeta, bool kFloor>
int launch_mode(const Args& a, int R, cudaStream_t s) {
  switch (R) {
    case 1: return launch_r<1, kBeta, kFloor>(a, s);
    case 2: return launch_r<2, kBeta, kFloor>(a, s);
    case 4: return launch_r<4, kBeta, kFloor>(a, s);
    case 6: return launch_r<6, kBeta, kFloor>(a, s);
    default: return -1;
  }
}

// R: states a thread (0: states_per_thread(S)); -1 for a shape the kernel
// does not take (S past 6144, more than 1024 threads, ld not a multiple of 4
// at least S).
int launch(bool beta, bool floor, int R, const void* emit, const void* skip, const void* valid,
           const void* last, const void* lengths, void* out, int T, int B, int S, int ld,
           void* stream) {
  if (S <= 0 || S > kMaxStates || ld % 4 != 0 || ld < S) return -1;
  if (R == 0) R = states_per_thread(S);
  if ((S + R - 1) / R > 1024) return -1;
  if (T <= 0 || B <= 0) return 0;
  Args a{};
  a.emit = static_cast<const float*>(emit);
  a.skip = static_cast<const uint8_t*>(skip);
  a.valid = static_cast<const uint8_t*>(valid);
  a.last = static_cast<const uint8_t*>(last);
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.T = T, a.B = B, a.S = S, a.ld = ld;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (beta)
    return floor ? launch_mode<true, true>(a, R, s) : launch_mode<true, false>(a, R, s);
  return floor ? launch_mode<false, true>(a, R, s) : launch_mode<false, false>(a, R, s);
}

}  // namespace

// alpha_t[s] for every t: emit (T, B, ld) fp32 and out (T, B, ld) fp32 in
// rows of ld floats (ld a multiple of 4, at least S; out's first S of each
// row written); skip (s-2 -> s), valid (B, S) uint8; lengths (B,) int32.
// Returns the cudaError_t of the launch, or -1 for a shape it does not take
// (S > 6144).
extern "C" int coral_ctc_alpha(const void* emit, const void* skip, const void* valid,
                               const void* lengths, void* out, int T, int B, int S, int ld,
                               void* stream) {
  return launch(false, false, 0, emit, skip, valid, nullptr, lengths, out, T, B, S, ld, stream);
}

// beta_t[s] for every t (emission at t included); skip: s -> s+2 allowed; last:
// the terminal states. As coral_ctc_alpha.
extern "C" int coral_ctc_beta(const void* emit, const void* skip, const void* valid,
                              const void* lengths, const void* last, void* out, int T, int B,
                              int S, int ld, void* stream) {
  return launch(true, false, 0, emit, skip, valid, last, lengths, out, T, B, S, ld, stream);
}

// The probe (coral_tpu_torch/tools/probe_ctc.py): mode 0 the kernel, mode 1
// its latency floor (the recursion alone: no emission ring, no stores but the
// last state's, into out's first row); R states a thread (0: as the kernel
// picks); beta: the beta recursion (last its terminal states). As
// coral_ctc_alpha otherwise.
extern "C" int coral_ctc_probe(int mode, int R, int beta, const void* emit, const void* skip,
                               const void* valid, const void* lengths, const void* last,
                               void* out, int T, int B, int S, int ld, void* stream) {
  if (mode != 0 && mode != 1) return -1;
  return launch(beta != 0, mode == 1, R, emit, skip, valid, last, lengths, out, T, B, S, ld,
                stream);
}
