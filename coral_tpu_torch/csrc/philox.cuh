// Dropout bits: Philox4x32-10 on (seed, row, column), the CUDA twin of
// coral_tpu_torch/ops/philox.py (see there for why the port does not follow
// the TPU's per-tile PRNG stream). Key (seed, 0), counter (f / 4, t, 0, 0);
// word j of the result is the bits of column 4 (f / 4) + j.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 coral_philox(uint32_t c0, uint32_t c1, uint32_t k0) {
  uint32_t c2 = 0u, c3 = 0u, k1 = 0u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Keep flags of columns col .. col+7 (col a multiple of 8) of row t.
__device__ __forceinline__ void coral_keep8(uint32_t seed, uint32_t t, int col,
                                            uint32_t threshold, bool keep[8]) {
  const uint4 a = coral_philox((uint32_t)col >> 2, t, seed);
  const uint4 b = coral_philox(((uint32_t)col >> 2) + 1u, t, seed);
  keep[0] = a.x >= threshold;
  keep[1] = a.y >= threshold;
  keep[2] = a.z >= threshold;
  keep[3] = a.w >= threshold;
  keep[4] = b.x >= threshold;
  keep[5] = b.y >= threshold;
  keep[6] = b.z >= threshold;
  keep[7] = b.w >= threshold;
}
