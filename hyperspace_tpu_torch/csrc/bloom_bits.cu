// Bloom filter bit indices over int64 key reps (kernel B7).
//
// Replaces hyperspace_tpu/ops/bloom.py::_bit_indices (an XLA program at
// bloom.py:34, not a Pallas kernel), which the data-skipping index runs
// at create (build_bloom, one call a source file) and at probe
// (indexes/sketches.py, the literal reps of one conjunct). The reference
// takes [2, n] uint32 key words, the lo and hi halves of each rep, that a
// host split wrote; here each thread reads its row's int64 rep and splits
// it in registers.
//
// Arithmetic (Kirsch-Mitzenmacher double hashing, all in uint32):
//   h1 = murmur3(rep's words, seed 0x9747B28C)
//   h2 = murmur3(rep's words, seed 0x85EBCA6B) | 1
//   idx[j] = (h1 + j * h2 mod 2^32) mod m, j < k
// with murmur3 as kernel B1 computes it (murmur3.cuh) and the remainder
// by m through fastmod's precomputed constant. h1 + j * h2 wraps at 2^32
// before the remainder, as the reference's uint32 arithmetic does, so the
// sum is carried as h += h2 in a uint32 register. Bit-identical to
// ops/bloom.py::bit_indices_torch (the plain PyTorch version).
//
// Two C entries share the row's hashing:
// * hs_bloom_bit_indices writes the [k, n] int32 indices (the probe);
// * hs_bloom_build zeroes the [m / 64] uint64 words of one Bloom filter
//   and ORs bit idx into word idx >> 6 at bit idx & 63 with a 64-bit
//   atomicOr: the packed words of the reference's build_bloom
//   (np.packbits(..., bitorder="little").view(np.uint64) on a
//   little-endian host), so the create copies back m / 8 bytes instead of
//   4kn.
//
// Bound: indices reads 8 bytes and writes 4k a row; build reads 8 bytes
// a row and writes the m / 8 bytes of words once, its k atomics a row
// landing in L2 (the words of one filter, 718,888 bytes at m = 5,751,104,
// stay resident there). chip_smoke.py computes both byte bounds and the
// integer-operation bound for the card it runs on.
//
// Design: one thread a row in a grid-stride loop over at most one
// resident wave of blocks; a warp's rep loads cover 256 contiguous bytes
// and its stores of one index plane 128.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

__device__ __forceinline__ void row_hashes(uint64_t rep, uint32_t& h1,
                                           uint32_t& h2) {
  h1 = hs_murmur3::fmix(hs_murmur3::mix_rep(kSeed1, rep), 8u);
  h2 = hs_murmur3::fmix(hs_murmur3::mix_rep(kSeed2, rep), 8u) | 1u;
}

__global__ void __launch_bounds__(kThreads)
    bit_indices_kernel(const int64_t* __restrict__ reps,
                       int32_t* __restrict__ out, int64_t n, uint64_t fm,
                       uint32_t m, int k) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x; row < n;
       row += stride) {
    uint32_t h, h2;
    row_hashes((uint64_t)__ldg(reps + row), h, h2);
    for (int j = 0; j < k; ++j, h += h2)
      out[j * n + row] = (int32_t)hs_murmur3::fastmod(h, fm, m);
  }
}

__global__ void __launch_bounds__(kThreads)
    build_kernel(const int64_t* __restrict__ reps,
                 unsigned long long* __restrict__ words, int64_t n,
                 uint64_t fm, uint32_t m, int k) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x; row < n;
       row += stride) {
    uint32_t h, h2;
    row_hashes((uint64_t)__ldg(reps + row), h, h2);
    for (int j = 0; j < k; ++j, h += h2) {
      const uint32_t idx = hs_murmur3::fastmod(h, fm, m);
      atomicOr(words + (idx >> 6), 1ull << (idx & 63u));
    }
  }
}

unsigned blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

// floor((2^64 - 1) / m) + 1 mod 2^64: fastmod's constant (murmur3.cuh)
uint64_t fastmod_constant(int64_t m) { return ~0ull / (uint64_t)m + 1ull; }

bool valid(int64_t n, int64_t m, int k) {
  return n >= 0 && m >= 1 && m <= (int64_t(1) << 31) && k >= 1;
}

}  // namespace

// reps: [n] int64, contiguous, on the device; out: [k, n] int32,
// contiguous. 1 <= m <= 2^31, k >= 1. Launches on `stream` (nothing for
// n = 0) and returns a CUDA error code (0 on success;
// cudaErrorInvalidValue for an argument out of range).
extern "C" int hs_bloom_bit_indices(const void* reps, void* out, int64_t n,
                                    int64_t m, int k, void* stream) {
  if (!valid(n, m, k)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  bit_indices_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(reps), static_cast<int32_t*>(out), n,
      fastmod_constant(m), (uint32_t)m, k);
  return (int)cudaGetLastError();
}

// reps: [n] int64, contiguous, on the device; words: [m / 64] 8-byte
// words on the device, zeroed here, then the k bits of every rep set.
// m a multiple of 64 in [64, 2^31], k >= 1. One memset and (for n > 0)
// one launch on `stream`; returns a CUDA error code as above.
extern "C" int hs_bloom_build(const void* reps, void* words, int64_t n,
                              int64_t m, int k, void* stream) {
  if (!valid(n, m, k) || m % 64 != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0, (size_t)(m / 8), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  build_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      static_cast<const int64_t*>(reps),
      static_cast<unsigned long long*>(words), n, fastmod_constant(m),
      (uint32_t)m, k);
  return (int)cudaGetLastError();
}
