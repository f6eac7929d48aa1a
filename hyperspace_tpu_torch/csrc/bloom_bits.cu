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
// * hs_bloom_build writes the [m / 64] uint64 words of one Bloom filter,
//   bit idx in word idx >> 6 at bit idx & 63: the packed words of the
//   reference's build_bloom (np.packbits(..., bitorder="little")
//   .view(np.uint64) on a little-endian host), so the create copies back
//   m / 8 bytes instead of 4kn. As 32-bit little-endian words the same
//   bytes hold bit idx in word idx >> 5 at bit idx & 31.
//
// Bound: indices reads 8 bytes and writes 4k a row; build reads 8 bytes a
// row and writes the m / 8 bytes of words once (718,880 bytes at phase
// 11's m = 5,751,040); its k bit sets a row make it an integer-operation
// bound. chip_smoke.py computes both byte bounds and the
// integer-operation bound for the card it runs on.
//
// Design. The indices: one thread a row in a grid-stride loop over at
// most one resident wave of blocks; a warp's rep loads cover 256
// contiguous bytes and its stores of one index plane 128. The build takes
// one of three routes, chosen by m alone; the first two set the bits in
// shared memory:
// * block (m <= kBlockMaxBits, 128 KiB): a block's shared memory holds
//   the whole filter. Each block hashes rows of a grid-stride loop and
//   ORs their bits into its copy, one partial filter a block, then ORs
//   the copy's non-zero 64-bit words into the zeroed output with
//   coalesced atomics. One block for each kRowsPerBlock rows, at most
//   what the card holds at once, so the merge stays a few copies.
// * binned (m <= kBinnedMaxBits): the filter is cut into slices of
//   2^kSliceShift bits (8 KiB), and one cooperative launch of as many
//   blocks as the card holds at once runs two phases split by a grid
//   barrier. In the first, each block hashes tiles of kTileRows rows,
//   counting-sorts a tile's indices by slice in shared memory and writes
//   them, each as its 16-bit offset in its slice, with the tile's
//   per-slice offsets, to scratch the caller allocates (L2 holds a
//   file's). In the second, each block takes a slice and a share of the
//   tiles, ORs their entries for it into a copy of the slice in shared
//   memory with shared-memory atomics, and ORs the copy's words into the
//   output: a few copies a slice, coalesced. Setting the bits through
//   distributed shared memory one atomic at a time (a cluster holding the
//   filter), or hashing every row once a slice, measured slower
//   (PERF.md; scripts/torch_b7_variants.cu).
// * global (m > kBinnedMaxBits, up to 2^31 bits): one thread a row ORs
//   each bit into the zeroed words with a 64-bit atomicOr in L2.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr uint32_t kSeed1 = 0x9747B28Cu;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

// The build's routes (ops/bloom.py shares these constants).
// block: a block of kBlockThreads threads holds the whole filter, at most
// kBlockMaxBits bits (2^15 32-bit words, 128 KiB of shared memory); one
// block (one partial filter) for each kRowsPerBlock rows.
constexpr int kBlockThreads = 512;
constexpr int64_t kBlockMaxBits = int64_t(1) << 20;
constexpr int kRowsPerBlock = 4096;
// binned: slices of 2^kSliceShift bits; tiles of kTileRows rows (two
// rows a thread of kBinThreads), at most kChunk indices a row a tile (a
// larger k takes ceil(k / kChunk) tiles of the same rows), so a tile
// holds at most kTileEntries entries; at most kMaxSlices slices, so
// filters of at most kBinnedMaxBits bits; kSegThreads threads read a
// tile's entries of a slice.
constexpr int kSliceShift = 16;
constexpr int kSliceWords = 1 << (kSliceShift - 5);
constexpr int kBinThreads = 512;
constexpr int kTileRows = 2 * kBinThreads;
constexpr int kChunk = 8;
constexpr int kTileEntries = kTileRows * kChunk;
constexpr int kMaxSlices = 256;
constexpr int64_t kBinnedMaxBits = int64_t(1) << 24;
constexpr int kSegThreads = 4;
static_assert(kBinnedMaxBits == (int64_t)kMaxSlices << kSliceShift,
              "the binned route's boundary is kMaxSlices slices");
static_assert(kTileEntries <= 65535, "a tile's offsets are 16-bit");

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

// The global route: each bit ORed into the zeroed words in L2.
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

// bit e of 32-bit words in shared memory
__device__ __forceinline__ void set_entry(uint32_t* slice, uint32_t e) {
  atomicOr(slice + (e >> 5), 1u << (e & 31u));
}

// The block route: the filter's m / 32 words in dynamic shared memory.
__global__ void __launch_bounds__(kBlockThreads)
    block_kernel(const int64_t* __restrict__ reps,
                 unsigned long long* __restrict__ words, int64_t n,
                 uint64_t fm, uint32_t m, int k) {
  extern __shared__ unsigned long long filter64[];
  uint32_t* filter = reinterpret_cast<uint32_t*>(filter64);
  const uint32_t nwords = m >> 6;
  for (uint32_t i = threadIdx.x; i < nwords; i += kBlockThreads)
    filter64[i] = 0ull;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kBlockThreads;
  for (int64_t row = (int64_t)blockIdx.x * kBlockThreads + threadIdx.x;
       row < n; row += stride) {
    uint32_t h, h2;
    row_hashes((uint64_t)__ldg(reps + row), h, h2);
    for (int j = 0; j < k; ++j, h += h2)
      set_entry(filter, hs_murmur3::fastmod(h, fm, m));
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < nwords; i += kBlockThreads) {
    const unsigned long long v = filter64[i];
    if (v) atomicOr(words + i, v);
  }
}

// The binned route: one cooperative launch of as many blocks as the card
// holds at once, in two phases split by a grid barrier.
// 1. The output words are zeroed; then tile t covers rows
//    [t / nchunks * kTileRows, + kTileRows) and indices j in [8c, 8c + 8)
//    of them, c = t % nchunks: its entries (idx & (2^kSliceShift - 1), as
//    uint16) go to entries[t * kTileEntries ...] in slice order, slice
//    s's from offsets[t * (S + 1) + s] to offsets[t * (S + 1) + s + 1].
// 2. Work item (s, p), p < parts: slice s's entries of the tiles t = p,
//    p + parts, ..., kSegThreads threads a tile's segment (16-byte loads
//    of 8 entries), ORed into a copy of the slice in shared memory, whose
//    non-zero 64-bit words are then ORed into the output (stored, if the
//    slice has one part).
__global__ void __launch_bounds__(kBinThreads)
    binned_kernel(const int64_t* __restrict__ reps,
                  unsigned long long* __restrict__ words,
                  uint16_t* __restrict__ entries,
                  uint16_t* __restrict__ offsets, int64_t n, uint64_t fm,
                  uint32_t m, int k, uint32_t S, int64_t ntiles,
                  int nchunks) {
  __shared__ uint32_t count[kMaxSlices + 1];
  // phase 1's tile of entries, phase 2's copy of a slice
  __shared__ __align__(16) uint16_t stage[kTileEntries];
  static_assert(kTileEntries * 2 >= kSliceWords * 4, "a slice fits the stage");
  const uint32_t nwords = m >> 6;
  for (uint32_t i = blockIdx.x * kBinThreads + threadIdx.x; i < nwords;
       i += gridDim.x * kBinThreads)
    words[i] = 0ull;

  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t first = t / nchunks * kTileRows;
    const int j0 = (int)(t % nchunks) * kChunk;
    const int kc = min(kChunk, k - j0);
    for (uint32_t i = threadIdx.x; i <= S; i += kBinThreads) count[i] = 0u;
    __syncthreads();
    // each index's rank among its slice's in the tile
    uint32_t idx[2 * kChunk], rank[2 * kChunk];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int64_t row = first + q * kBinThreads + threadIdx.x;
      uint32_t h = 0u, h2 = 0u;
      if (row < n) {
        row_hashes((uint64_t)__ldg(reps + row), h, h2);
        h += (uint32_t)j0 * h2;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (row < n && j < kc) {
          idx[q * kChunk + j] = hs_murmur3::fastmod(h, fm, m);
          rank[q * kChunk + j] =
              atomicAdd(count + (idx[q * kChunk + j] >> kSliceShift), 1u);
          h += h2;
        }
      }
    }
    __syncthreads();
    // exclusive offsets of the S slices, count[S] the tile's entries
    if (threadIdx.x < 32) {
      const uint32_t lane = threadIdx.x;
      uint32_t c[kMaxSlices / 32], sum = 0u;
#pragma unroll
      for (int i = 0; i < kMaxSlices / 32; ++i) {
        const uint32_t s = lane * (kMaxSlices / 32) + i;
        c[i] = s < S ? count[s] : 0u;
        sum += c[i];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t v = __shfl_up_sync(~0u, incl, d);
        if (lane >= (uint32_t)d) incl += v;
      }
      uint32_t run = incl - sum;
#pragma unroll
      for (int i = 0; i < kMaxSlices / 32; ++i) {
        const uint32_t s = lane * (kMaxSlices / 32) + i;
        if (s < S) count[s] = run;
        run += c[i];
      }
      if (lane == 31) count[S] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int64_t row = first + q * kBinThreads + threadIdx.x;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (row < n && j < kc) {
          const uint32_t e = idx[q * kChunk + j];
          stage[count[e >> kSliceShift] + rank[q * kChunk + j]] =
              (uint16_t)(e & ((1u << kSliceShift) - 1u));
        }
    }
    for (uint32_t i = threadIdx.x; i <= S; i += kBinThreads)
      offsets[t * (S + 1) + i] = (uint16_t)count[i];
    __syncthreads();
    const uint32_t total = count[S];
    uint4* dst = reinterpret_cast<uint4*>(entries + t * kTileEntries);
    const uint4* src = reinterpret_cast<const uint4*>(stage);
    for (uint32_t i = threadIdx.x; i < (total + 7u) / 8u; i += kBinThreads)
      dst[i] = src[i];
    __syncthreads();
  }

  // every tile written, and every output word zeroed, before phase 2
  cg::this_grid().sync();

  uint32_t* slice = reinterpret_cast<uint32_t*>(stage);
  const uint32_t parts = gridDim.x >= S ? gridDim.x / S : 1u;
  constexpr uint32_t kGroups = kBinThreads / kSegThreads;
  const uint32_t lane = threadIdx.x % kSegThreads;
  for (uint32_t item = blockIdx.x; item < S * parts; item += gridDim.x) {
    const uint32_t s = item % S, part = item / S;
    for (uint32_t i = threadIdx.x; i < kSliceWords; i += kBinThreads)
      slice[i] = 0u;
    __syncthreads();
    for (int64_t t = part + (int64_t)parts * (threadIdx.x / kSegThreads);
         t < ntiles; t += (int64_t)parts * kGroups) {
      const uint32_t lo = offsets[t * (S + 1) + s];
      const uint32_t hi = offsets[t * (S + 1) + s + 1];
      const uint16_t* e = entries + t * kTileEntries;  // 16-byte aligned
      // [lo, a) and [b, hi) an entry a load, [a, b) 8 a load
      const uint32_t a = min((lo + 7u) & ~7u, hi), b = max(hi & ~7u, a);
      for (uint32_t x = lo + lane; x < a; x += kSegThreads)
        set_entry(slice, e[x]);
      for (uint32_t x = b + lane; x < hi; x += kSegThreads)
        set_entry(slice, e[x]);
      for (uint32_t c = a + 8u * lane; c < b; c += 8u * kSegThreads) {
        const uint4 v = *reinterpret_cast<const uint4*>(e + c);
        const uint32_t pair[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          set_entry(slice, pair[u] & 0xFFFFu);
          set_entry(slice, pair[u] >> 16);
        }
      }
    }
    __syncthreads();
    const uint32_t w0 = s << (kSliceShift - 6);
    const uint32_t nw = min((uint32_t)kSliceWords / 2, nwords - w0);
    const unsigned long long* slice64 =
        reinterpret_cast<const unsigned long long*>(slice);
    for (uint32_t i = threadIdx.x; i < nw; i += kBinThreads) {
      const unsigned long long v = slice64[i];
      if (parts == 1)
        words[w0 + i] = v;
      else if (v)
        atomicOr(words + w0 + i, v);
    }
    __syncthreads();
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

enum Route { kBlock = 0, kBinned = 1, kGlobal = 2 };

// The build's route and launch shape for n reps into m bits, k indices a
// rep (ops/bloom.py's build_plan computes the same).
struct Plan {
  Route route;
  int64_t block_words;    // 32-bit words a block holds
  int64_t partials;       // copies ORed into a word
  int64_t scratch_bytes;  // binned: entries, then offsets
  int64_t resident;       // the route's blocks the card holds at once
  int64_t ntiles;         // binned: tiles
  int nchunks;            // binned: tiles a row tile
  uint32_t slices;        // binned: S
};

int64_t round16(int64_t b) { return (b + 15) / 16 * 16; }

// blocks of `kernel` the card holds at once
template <class K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                            int64_t* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = (int64_t)per_sm * sms;
  return cudaSuccess;
}

cudaError_t plan_for(int64_t n, int64_t m, int k, Plan* p) {
  *p = Plan{};
  if (m > kBinnedMaxBits) {
    p->route = kGlobal;
    return cudaSuccess;
  }
  if (m <= kBlockMaxBits) {
    p->route = kBlock;
    p->block_words = m / 32;
    cudaError_t err = cudaFuncSetAttribute(
        block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(kBlockMaxBits / 8));
    if (err == cudaSuccess)
      err = resident_blocks(block_kernel, kBlockThreads, (size_t)(m / 8),
                            &p->resident);
    if (err != cudaSuccess) return err;
    const int64_t want = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    p->partials = want < p->resident ? want : p->resident;
    return cudaSuccess;
  }
  p->route = kBinned;
  p->block_words = kSliceWords;
  const cudaError_t err =
      resident_blocks(binned_kernel, kBinThreads, 0, &p->resident);
  if (err != cudaSuccess) return err;
  p->slices = (uint32_t)((m + (int64_t(1) << kSliceShift) - 1) >> kSliceShift);
  p->partials = p->resident >= p->slices ? p->resident / p->slices : 1;
  p->nchunks = (k + kChunk - 1) / kChunk;
  p->ntiles = (n + kTileRows - 1) / kTileRows * p->nchunks;
  p->scratch_bytes = p->ntiles * kTileEntries * 2 +
                     round16(p->ntiles * (p->slices + 1) * 2);
  return cudaSuccess;
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

// The build's plan for n reps into m bits, k indices a rep, on the
// current device: out[0] the route (0 block, 1 binned, 2 global), out[1]
// the 32-bit words a block holds, out[2] the copies ORed into a word,
// out[3] the scratch bytes hs_bloom_build needs, out[4] the route's
// blocks the card holds at once (0 on the global route). Returns a CUDA
// error code as hs_bloom_build does.
extern "C" int hs_bloom_build_plan(int64_t n, int64_t m, int k,
                                   int64_t* out) {
  if (!valid(n, m, k) || m % 64 != 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(n, m, k, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.route;
  out[1] = p.block_words;
  out[2] = p.partials;
  out[3] = p.scratch_bytes;
  out[4] = p.resident;
  return (int)cudaSuccess;
}

// reps: [n] int64, contiguous, on the device; words: [m / 64] 8-byte
// words on the device, then the filter of the reps' k bits each; scratch:
// scratch_bytes of device memory, at least what hs_bloom_build_plan
// gives (0 off the binned route), 16-byte aligned. m a multiple of 64 in
// [64, 2^31], k >= 1. On `stream`, by the route m gives: for n = 0 one
// memset; else the block and global routes a memset and one launch, the
// binned route one cooperative launch. Returns a CUDA error code as above
// (cudaErrorInvalidValue also for too little scratch).
extern "C" int hs_bloom_build(const void* reps, void* words, void* scratch,
                              int64_t scratch_bytes, int64_t n, int64_t m,
                              int k, void* stream) {
  if (!valid(n, m, k) || m % 64 != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  Plan p;
  cudaError_t err = plan_for(n, m, k, &p);
  if (err != cudaSuccess) return (int)err;
  const auto r = static_cast<const int64_t*>(reps);
  const auto w = static_cast<unsigned long long*>(words);
  const uint64_t fm = fastmod_constant(m);
  if (n == 0 || p.route != kBinned) {
    err = cudaMemsetAsync(words, 0, (size_t)(m / 8), st);
    if (err != cudaSuccess || n == 0) return (int)err;
  }
  if (p.route == kGlobal) {
    build_kernel<<<blocks_for(n), kThreads, 0, st>>>(r, w, n, fm, (uint32_t)m,
                                                     k);
    return (int)cudaGetLastError();
  }
  if (p.route == kBlock) {
    block_kernel<<<(unsigned)p.partials, kBlockThreads, (size_t)(m / 8), st>>>(
        r, w, n, fm, (uint32_t)m, k);
    return (int)cudaGetLastError();
  }
  if (scratch_bytes < p.scratch_bytes ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto entries = static_cast<uint16_t*>(scratch);
  auto offsets = entries + p.ntiles * kTileEntries;
  uint32_t um = (uint32_t)m;
  void* args[] = {(void*)&r, (void*)&w, (void*)&entries, (void*)&offsets,
                  (void*)&n, (void*)&fm, (void*)&um, (void*)&k,
                  (void*)&p.slices, (void*)&p.ntiles, (void*)&p.nchunks};
  err = cudaLaunchCooperativeKernel((const void*)binned_kernel,
                                    dim3((unsigned)p.resident),
                                    dim3(kBinThreads), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
