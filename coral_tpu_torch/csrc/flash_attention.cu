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
// The backward's two kernels run on the backward mainloop beside it (below).
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
#include <chrono>

#include "attention.cuh"

namespace {

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
// Replaces: coral_tpu/ops/flash_attention.py `_grads` (:123): the stock TPU
// kernel's dkv backward (`_flash_attention_bwd_dkv`) and coral_tpu/ops/
// _flash_bwd_patch.py `flash_attention_bwd_dq_fixed` (:145), from the
// forward's o, l and m.
//
// Bound on the H100: the tensor cores and the exponentials: the dq kernel
// makes three T x T x d products per head (s, dp, dq), the dkv kernel four
// (s, dp, dv, dk), each with T^2 exponentials; the TPU kernels hold (block,
// block) tiles in VMEM that a Hopper SM cannot.
//
// Design: the two kernels run on the backward mainloop of `attention.cuh`
// (namespace bwd, policy bwd::K7<kSeg>): TMA copies into an mbarrier ring,
// wgmma for all seven products, two consumer warpgroups of 64
// rows and a producer warp, S, P, dP and dS in registers only. The query-major
// kernel (dq, launched first) holds 128 query rows of Q and dO, streams
// 128-key tiles of K and V (64 at d = 120, where S, dP and dQ would not fit
// the registers at 128), and forms di = rowsum(o do) of its rows once,
// writing it to a (B, H, T) fp32 scratch; the key-major kernel (dk, dv) holds
// 128 keys of K and V and streams 64-query tiles of Q and dO (32 at d = 120,
// for dK and dV's 128 registers a thread), with each tile's c = m log2 e +
// log2 l and di staged beside it. Each kernel computes p = exp2(s scale log2
// e - c) and ds = ((dp - di) p) scale as the stock kernel does (with ex2 and
// log2 e folded into one FMA), rounding p and ds to bf16 only as the products'
// operands; sums are fp32, and there are no atomics, so the gradients are the
// same bits on every run. Measured on an H100 at Whisper's (8, 1500, 20 x 64):
// dq at 44% of its bound, dkv at 33% (PERF.md). Keys past T are zero rows (s = 0): the dq kernel masks them by index and
// the dkv kernel never writes their dk and dv; queries past T get c = +inf
// and so p = 0. dq, dk and dv are stored only below T and d.
//
// With segment ids (kSeg), p = 0 where the query's and the key's ids differ.
// The padded call's rows at or past T are left out: a query there has do = 0
// (its output is sliced away) and adds nothing to dk or dv, and a key there
// has k = v = 0 and adds nothing to dq; its own dk and dv are sliced away.
// The stats l and m of the forward over Tk keys carry what they did add.

// The query-major kernel: dq and di of 128 query rows of one head.
template <int D, bool kSeg>
__global__ void __launch_bounds__(bwd::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ bwd::Maps maps, const bwd::Args args) {
  bwd::dq<D, bwd::K7<kSeg>>(maps, args);
}

// The key-major kernel: dk and dv of 128 keys of one head, from the dq
// kernel's di.
template <int D, bool kSeg>
__global__ void __launch_bounds__(bwd::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ bwd::Maps maps, const bwd::Args args) {
  bwd::dkv<D, bwd::K7<kSeg>>(maps, args);
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

// The backward's query-major kernel (dq, and di = rowsum(o do) into the
// (B, H, T) fp32 scratch `di`) when dq is non-null, else its key-major kernel
// (dk, dv, reading di; o is then not read), at head dim D; the dq launch comes
// first. seg as the forward's. Returns the cudaError_t of the launch, the
// tensor-map encoder's error, or -1 for a shape it was not built for.
extern "C" int coral_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* m,
                                         const void* l, const void* seg, void* di, void* dq,
                                         void* dk, void* dv, int B, int T, int Tk, int H, int D,
                                         long long stride_b, long long stride_t, float scale,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return -1;
  if (seg == nullptr ? Tk != T : Tk < T) return -1;
  if (di == nullptr || (dq == nullptr && (dk == nullptr || dv == nullptr))) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool is_dq = dq != nullptr;
  const bwd::Args args{static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                       static_cast<const float*>(m), static_cast<const float*>(l),
                       static_cast<const int*>(seg), static_cast<float*>(di),
                       static_cast<bf16*>(is_dq ? dq : dk), static_cast<bf16*>(dv),
                       T, Tk, H, scale};
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    auto go = [&](auto kernel, auto policy, auto is_dq_kernel) {
      return bwd::launch<kD, decltype(policy), decltype(is_dq_kernel)::value>(
          kernel, q, k, v, args, B, stride_b, stride_t, s);
    };
    using Yes = std::true_type;
    using No = std::false_type;
    if (seg == nullptr)
      return is_dq ? go(flash_bwd_dq_kernel<kD, false>, bwd::K7<false>{}, Yes{})
                   : go(flash_bwd_dkv_kernel<kD, false>, bwd::K7<false>{}, No{});
    return is_dq ? go(flash_bwd_dq_kernel<kD, true>, bwd::K7<true>{}, Yes{})
                 : go(flash_bwd_dkv_kernel<kD, true>, bwd::K7<true>{}, No{});
  });
}

// Host nanoseconds a backward launch spends encoding its tensor maps (four
// operands, two maps each at d = 80), the mean of `reps` encodings of the dq
// kernel's maps; -1 for an unbuilt head dim or a failed encoding.
extern "C" int coral_flash_attention_bwd_map_ns(const void* q, const void* k, const void* v,
                                                const void* dout, int B, int T, int H, int D,
                                                long long stride_b, long long stride_t,
                                                int reps) {
  if (reps <= 0) return -1;
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    bwd::Maps maps;
    const auto start = std::chrono::steady_clock::now();
    for (int i = 0; i < reps; ++i)
      if (bwd::encode<kD>(&maps, true, q, k, v, dout, B, T, H, stride_b, stride_t) != 0)
        return -1;
    const auto ns = std::chrono::duration_cast<std::chrono::nanoseconds>(
                        std::chrono::steady_clock::now() - start)
                        .count();
    return (int)(ns / reps);
  });
}
