// murmur3 bucket ids over int64 key reps (kernel B1).
//
// Replaces the TPU kernel hyperspace_tpu/ops/hash.py::bucket_ids_pallas
// (pl.pallas_call at hash.py:248). That kernel reads interleaved lo/hi
// uint32 word planes [2k, n] that a separate split pass wrote; here each
// thread reads its row's k int64 reps straight from the [k, n] key-rep
// tensor (one coalesced 8-byte load per key plane) and splits lo/hi in
// registers, so the word planes never exist in device memory.
//
// Arithmetic: murmur3_32 body per 32-bit word (c1 0xCC9E2D51,
// c2 0x1B873593, rotl 15/13, h*5 + 0xE6546B64), words in the order
// lo(key0), hi(key0), lo(key1), ... starting from `seed`; fmix with
// length 4 * 2k; then h % num_buckets as int32. Bit-identical to
// ops/hash.py::bucket_ids_torch (the plain PyTorch version).
//
// Bound: it moves 8k + 4 bytes per row (k reps read, one int32 written).
// At 6,001,215 rows and k = 1 that is 72.0 MB, 21.5 us at the 3.35 TB/s
// of an H100 SXM's HBM3 (700 W part). Its integer work is about 50
// operations per row (two word mixes, fmix, the modulo), so memory and
// the integer pipes are of the same order; chip_smoke.py computes the
// bound for the card it runs on and PERF.md records it with the card's
// name and power limit. One thread per row with a grid-stride loop;
// a precomputed divisor for the modulo and 16-byte loads are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void murmur3_bucket_kernel(const int64_t* __restrict__ reps,
                                      int32_t* __restrict__ out, int64_t n,
                                      int k, uint32_t num_buckets,
                                      uint32_t seed) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = seed;
    for (int j = 0; j < k; ++j) {
      const uint64_t u = (uint64_t)__ldg(reps + (int64_t)j * n + i);
      h = mix_word(h, (uint32_t)u);
      h = mix_word(h, (uint32_t)(u >> 32));
    }
    h ^= (uint32_t)(8 * k);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    out[i] = (int32_t)(h % num_buckets);
  }
}

}  // namespace

// reps: [k, n] int64, contiguous, on the device; out: [n] int32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int hs_murmur3_bucket_ids(const void* reps, void* out, int64_t n,
                                     int k, int64_t num_buckets, int64_t seed,
                                     void* stream) {
  if (n > 0) {
    const int threads = 256;
    int64_t blocks = (n + threads - 1) / threads;
    // enough blocks to fill every SM many times over; the grid-stride
    // loop covers the rest
    if (blocks > 132 * 32) blocks = 132 * 32;
    murmur3_bucket_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const int64_t*)reps, (int32_t*)out, n, k, (uint32_t)num_buckets,
        (uint32_t)seed);
  }
  return (int)cudaGetLastError();
}
