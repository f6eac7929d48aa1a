// Two designs of kernel B7's build that were measured against the one the
// package keeps (hyperspace_tpu_torch/csrc/bloom_bits.cu, the binned
// route) and lost; scripts/torch_b7_turns.py builds this file into its
// own library and times both beside the package's build and commit
// 28bd287's, in turns. Not part of the package: nothing imports it.
//
// * hs_bloom_build_dsmem: a thread-block cluster of up to 16 blocks holds
//   one filter, each block a power-of-two slice of its 32-bit words in
//   shared memory; every block hashes rows of a grid-stride loop and ORs
//   each bit into the owning block's slice through distributed shared
//   memory (cluster_group::map_shared_rank), one atomic a bit; then each
//   block ORs its slice's non-zero 64-bit words into the zeroed output.
//   One cluster for each 4,096 rows a block, at most what the card holds.
// * hs_bloom_build_sliced: the filter's indices are split into S = 2^s
//   slices by the top s bits of fastmod's 64-bit product (idx is monotone
//   in it), each small enough for one block's shared memory; a grid of
//   row groups x S blocks, each block hashing its group's rows, setting
//   only its slice's bits with shared-memory atomics, then ORing its
//   slice's non-zero words into the zeroed output. Every row is hashed S
//   times.
//
// Both take the package's former C interface (reps, words, n, m, k,
// stream), zero the words themselves and return a CUDA error code;
// cudaErrorInvalidValue for an m they do not take.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

__device__ __forceinline__ void row_hashes(uint64_t rep, uint32_t& h1,
                                           uint32_t& h2) {
  h1 = hs_murmur3::fmix(hs_murmur3::mix_rep(kSeed1, rep), 8u);
  h2 = hs_murmur3::fmix(hs_murmur3::mix_rep(kSeed2, rep), 8u) | 1u;
}

uint64_t fastmod_constant(int64_t m) { return ~0ull / (uint64_t)m + 1ull; }

constexpr int kDsmemThreads = 512;

__global__ void __launch_bounds__(kDsmemThreads)
    dsmem_kernel(const int64_t* __restrict__ reps,
                 unsigned long long* __restrict__ words, int64_t n,
                 uint64_t fm, uint32_t m, int k, uint32_t shift) {
  extern __shared__ unsigned long long slice64[];
  uint32_t* slice = reinterpret_cast<uint32_t*>(slice64);
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t total = m >> 5, held = 1u << shift;
  const uint32_t base = cluster.block_rank() << shift;
  for (uint32_t i = threadIdx.x; i < held / 2; i += kDsmemThreads)
    slice64[i] = 0ull;
  cluster.sync();
  const uint32_t mask = held - 1u;
  const int64_t stride = (int64_t)gridDim.x * kDsmemThreads;
  for (int64_t row = (int64_t)blockIdx.x * kDsmemThreads + threadIdx.x;
       row < n; row += stride) {
    uint32_t h, h2;
    row_hashes((uint64_t)__ldg(reps + row), h, h2);
    for (int j = 0; j < k; ++j, h += h2) {
      const uint32_t idx = hs_murmur3::fastmod(h, fm, m);
      const uint32_t word = idx >> 5;
      atomicOr(cluster.map_shared_rank(slice + (word & mask), word >> shift),
               1u << (idx & 31u));
    }
  }
  cluster.sync();
  const uint32_t own = min(held, total - base);
  for (uint32_t i = threadIdx.x; i < own / 2; i += kDsmemThreads) {
    const unsigned long long v = slice64[i];
    if (v) atomicOr(words + base / 2 + i, v);
  }
}

constexpr int kSlicedThreads = 1024;
constexpr int kSlicedSmemMax = 227 * 1024;

__global__ void __launch_bounds__(kSlicedThreads)
    sliced_kernel(const int64_t* __restrict__ reps,
                  unsigned long long* __restrict__ words, int64_t n,
                  uint64_t fm, uint32_t m, int k, int log_s, int groups,
                  uint32_t slice_words) {
  extern __shared__ unsigned long long s64[];
  uint32_t* slice = reinterpret_cast<uint32_t*>(s64);
  const uint32_t s = blockIdx.x & ((1u << log_s) - 1u);
  const int g = blockIdx.x >> log_s;
  // slice s: the indices whose product's top log_s bits are s, within
  // [floor(s m / S), ceil((s + 1) m / S)); its words from an even base
  const uint32_t lo_idx = (uint32_t)(((uint64_t)s * m) >> log_s);
  const uint32_t base = (lo_idx >> 5) & ~1u;
  const uint32_t count = min(slice_words, (m >> 5) - base);
  for (uint32_t i = threadIdx.x; i < slice_words / 2; i += kSlicedThreads)
    s64[i] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)groups * kSlicedThreads;
  for (int64_t row = (int64_t)g * kSlicedThreads + threadIdx.x; row < n;
       row += stride) {
    uint32_t h, h2;
    row_hashes((uint64_t)__ldg(reps + row), h, h2);
    for (int j = 0; j < k; ++j, h += h2) {
      const uint64_t low = fm * (uint64_t)h;
      if ((uint32_t)(low >> (64 - log_s)) == s) {
        const uint32_t idx = (uint32_t)(
            ((uint64_t)(uint32_t)(low >> 32) * m + __umulhi((uint32_t)low, m)) >>
            32);
        atomicOr(slice + ((idx >> 5) - base), 1u << (idx & 31u));
      }
    }
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < count / 2; i += kSlicedThreads) {
    const unsigned long long v = s64[i];
    if (v) atomicOr(words + base / 2 + i, v);
  }
}

}  // namespace

extern "C" int hs_bloom_build_dsmem(const void* reps, void* words, int64_t n,
                                    int64_t m, int k, void* stream) {
  if (n < 0 || k < 1 || m < 64 || m % 64 != 0 || m > (int64_t(1) << 24))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t total = m / 32;
  uint32_t shift = 1;
  while (((total + (int64_t(1) << shift) - 1) >> shift) > 16) ++shift;
  if (shift > 15) return (int)cudaErrorInvalidValue;
  const int cluster = (int)((total + (int64_t(1) << shift) - 1) >> shift);
  const size_t smem = (size_t)4 << shift;
  cudaError_t err = cudaFuncSetAttribute(
      dsmem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 << 15);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dsmem_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kDsmemThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int most = 0;
  err = cudaOccupancyMaxActiveClusters(&most, dsmem_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(words, 0, (size_t)(m / 8), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int64_t want = (n + (int64_t)cluster * 4096 - 1) / ((int64_t)cluster * 4096);
  cfg.gridDim = dim3((unsigned)(cluster * (want < most ? want : most)));
  err = cudaLaunchKernelEx(&cfg, dsmem_kernel, static_cast<const int64_t*>(reps),
                           static_cast<unsigned long long*>(words), n,
                           fastmod_constant(m), (uint32_t)m, k, shift);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int hs_bloom_build_sliced(const void* reps, void* words, int64_t n,
                                     int64_t m, int k, void* stream) {
  if (n < 0 || k < 1 || m < 64 || m % 64 != 0 || m > (int64_t(1) << 24))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  // the fewest slices (at least 2) whose words, plus one at each edge,
  // fit a block
  int log_s = 1;
  uint32_t slice_words = 0;
  for (;; ++log_s) {
    slice_words = (uint32_t)(((m >> log_s) + 31) / 32 + 4) & ~1u;
    if (slice_words * 4 <= (uint32_t)kSlicedSmemMax) break;
    if (log_s == 8) return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sliced_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSlicedSmemMax);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sliced_kernel, kSlicedThreads, slice_words * 4);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaMemsetAsync(words, 0, (size_t)(m / 8), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  // one wave: row groups x slices blocks
  const int groups = per_sm * sms >> log_s > 0 ? per_sm * sms >> log_s : 1;
  sliced_kernel<<<(unsigned)(groups << log_s), kSlicedThreads,
                  slice_words * 4, st>>>(
      static_cast<const int64_t*>(reps), static_cast<unsigned long long*>(words),
      n, fastmod_constant(m), (uint32_t)m, k, log_s, groups, slice_words);
  return (int)cudaGetLastError();
}
