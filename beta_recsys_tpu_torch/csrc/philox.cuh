// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC 2011), the counter-based generator of the attention
// dropout mask in flash_attention_fwd.cu and flash_attention_bwd.cu.
//
// The mask is a pure function of (seed, n, row, col), so the backward kernels
// regenerate exactly the forward's mask from the seed alone, as the TPU
// kernels reseed their PRNG with seed + program id
// (beta_recsys_tpu/ops/pallas/flash_attention.py:_dropout_keep). The 64-bit
// seed is the key; the counter is (col / 4, row, n, 0), and word col % 4 of
// the four output words gives the bits of entry (n, row, col), so one
// generator call serves four neighbouring keys. An entry is kept when its
// bits are >= min(floor(rate * 2^32), 2^32 - 1), the TPU kernel's rule.
// ops/kernels/philox.py computes the same function in int64 PyTorch
// arithmetic (its plain version); the two agree bit for bit.

#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

struct Key {
  uint32_t k0, k1;
};

// The seed's key: its low and high 32 bits.
__device__ __forceinline__ Key key_of(const int64_t* seed) {
  const uint64_t s = static_cast<uint64_t>(*seed);
  return {static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)};
}

// Ten rounds, the key bumped between rounds (Random123's philox4x32_R).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, Key key) {
  uint32_t k0 = key.k0, k1 = key.k1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x);
    const uint32_t lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z);
    const uint32_t lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The bits of the four entries (n, row, 4g .. 4g + 3).
__device__ __forceinline__ uint4 bits4(Key key, int n, int row, int g) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(row), static_cast<uint32_t>(n), 0u), key);
}

__device__ __forceinline__ uint32_t word(uint4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

}  // namespace philox
