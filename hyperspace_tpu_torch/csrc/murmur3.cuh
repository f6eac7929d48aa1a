// murmur3-32 over int64 key reps and the remainder by a precomputed
// constant, shared by kernels B1 (murmur3_bucket.cu) and B7
// (bloom_bits.cu), so both hash a rep exactly alike.
//
// Arithmetic: the murmur3_32 body per 32-bit word (c1 0xCC9E2D51,
// c2 0x1B873593, rotl 15/13, h*5 + 0xE6546B64), a rep's words in the
// order lo, hi; fmix with the byte length. The remainder h % d of a
// 32-bit h takes m = floor((2^64 - 1) / d) + 1 (mod 2^64), computed on the
// host (ops/hash.fastmod_m): h % d = floor(((m * h) mod 2^64) * d / 2^64)
// (Lemire, Kaser and Kurz, "Faster Remainder by Direct Computation",
// 2019), exact for every 32-bit h and d in [1, 2^31]; d = 1 gives m = 0
// and 0. Four integer multiplies replace the generic 32-bit division.

#pragma once

#include <cstdint>

namespace hs_murmur3 {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, unsigned r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t mix_rep(uint32_t h, uint64_t u) {
  h = mix_word(h, (uint32_t)u);
  return mix_word(h, (uint32_t)(u >> 32));
}

__device__ __forceinline__ uint32_t fmix(uint32_t h, uint32_t len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// h % d through m = floor((2^64 - 1) / d) + 1 (see the note at the top)
__device__ __forceinline__ uint32_t fastmod(uint32_t h, uint64_t m,
                                            uint32_t d) {
  const uint64_t low = m * (uint64_t)h;  // mod 2^64
  const uint64_t t =
      (uint64_t)(uint32_t)(low >> 32) * d + __umulhi((uint32_t)low, d);
  return (uint32_t)(t >> 32);
}

}  // namespace hs_murmur3
