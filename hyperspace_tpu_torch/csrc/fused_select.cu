// Fused filter-select (kernel B3b): the passing row indices of a
// range-term conjunction, ascending.
//
// Replaces the JAX package's host kernel hs_fused_filter_select
// (hyperspace_tpu/native/hs_native.cpp:542), driven by
// execution/pipeline_compiler.py::fused_filter_batch (:888). Its plain
// PyTorch version is ops/filter.py::select_torch, torch.nonzero over
// range_mask_torch: out = np.nonzero(mask), exactly.
//
// The predicate is B3a's, from range_terms.cuh: the same terms, bounds
// and validity rules, so B3a, B3b and B5f agree on every row.
//
// Bound: it reads each distinct term column once (8 bytes a row) and
// each validity once (1 byte a row) and writes 8 bytes a passing row;
// the bit words and the per-tile counts it keeps between passes are 1/64
// and 1/256 of that. HBM bandwidth bounds it.
//
// Design, a standard stream compaction in three launches, order by
// construction and no atomics on the output:
// 1. select_count: a block owns a tile of 2,048 rows, a warp 8 words of
//    32 rows. Each lane tests its row of each word and the warp's ballot
//    is the word's bits; lane k keeps word k, stores it, and the block's
//    count of passing rows goes to counts[tile].
// 2. select_scan: one block turns the tile counts into exclusive offsets
//    (warp shuffle scans, a carry across rounds of 1,024 tiles) and
//    writes the total.
// 3. select_emit: each warp reloads its 8 words, scans their bit counts
//    across lanes, offsets them by its tile's offset and the counts of
//    the warps before it, and each lane writes the index of its row in
//    every word where its bit is set.

#include <cstdint>
#include <cuda_runtime.h>

#include "range_terms.cuh"

namespace {

using hs_terms::Args;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kWords = 8;  // 32-row words a warp owns
constexpr long long kTileRows = static_cast<long long>(kThreads) * kWords;
constexpr int kScanThreads = 1024;

__host__ __device__ inline long long num_tiles(long long n) { return (n + kTileRows - 1) / kTileRows; }
__host__ __device__ inline long long num_words(long long n) { return (n + kWarp - 1) / kWarp; }

__global__ void __launch_bounds__(kThreads)
    select_count(const __grid_constant__ Args a, long long n, unsigned* __restrict__ words,
                 long long* __restrict__ counts) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long word0 =
      static_cast<long long>(blockIdx.x) * (kTileRows / kWarp) + static_cast<long long>(warp) * kWords;
  int total = 0;
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const long long row = (word0 + k) * kWarp + lane;
    const bool ok = row < n && hs_terms::row_mask(a, row);
    const unsigned w = __ballot_sync(kFull, ok);
    total += __popc(w);
    if (lane == k) mine = w;
  }
  if (lane < kWords && word0 + lane < num_words(n)) words[word0 + lane] = mine;
  if (lane == 0) warp_total[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_total[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    select_scan(long long* __restrict__ counts, long long tiles, long long* __restrict__ total) {
  __shared__ long long warp_sums[kScanThreads / kWarp];
  __shared__ long long carry;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < tiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long v = i < tiles ? counts[i] : 0;
    long long x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == kWarp - 1) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const long long excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < tiles) counts[i] = excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void __launch_bounds__(kThreads)
    select_emit(const unsigned* __restrict__ words, const long long* __restrict__ offsets,
                long long n, long long* __restrict__ out) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const long long word0 =
      static_cast<long long>(blockIdx.x) * (kTileRows / kWarp) + static_cast<long long>(warp) * kWords;
  const unsigned w = (lane < kWords && word0 + lane < num_words(n)) ? words[word0 + lane] : 0u;
  const int cnt = __popc(w);
  int incl = cnt;  // inclusive scan of the words' counts over lanes 0 .. kWords - 1
#pragma unroll
  for (int d = 1; d < kWords; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int excl = incl - cnt;
  const int warp_count = __shfl_sync(kFull, incl, kWords - 1);
  if (lane == 0) warp_total[warp] = warp_count;
  __syncthreads();
  long long base = offsets[blockIdx.x];
  for (int v = 0; v < warp; ++v) base += warp_total[v];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const unsigned wk = __shfl_sync(kFull, w, k);
    const int before = __shfl_sync(kFull, excl, k);
    if ((wk >> lane) & 1u) out[base + before + __popc(wk & below)] = (word0 + k) * kWarp + lane;
  }
}

}  // namespace

extern "C" {

// Bytes of scratch for n rows: a count a tile, then a 32-bit word a 32 rows.
long long hs_select_scratch_bytes(long long n) {
  return num_tiles(n) * 8 + ((num_words(n) * 4 + 7) / 8) * 8;
}

// cols/valids/term_col/lo_i/hi_i/lo_f/hi_f/flags/nterms: the terms as
// hs_range_mask (range_mask.cu) takes them. out: [n] int64 device
// capacity for the indices; total: one int64 on the device, the number
// written. Launches on `stream`; returns a CUDA error code.
int hs_fused_select(const void* const* cols, const void* const* valids, int ncols,
                    const int* term_col, const int64_t* lo_i, const int64_t* hi_i,
                    const double* lo_f, const double* hi_f, const int* flags, int nterms,
                    long long n, long long* out, long long* total, void* scratch,
                    void* stream) {
  if (n < 0 || out == nullptr || total == nullptr) return (int)cudaErrorInvalidValue;
  Args a;
  const cudaError_t packed = hs_terms::pack_args(a, cols, valids, ncols, term_col, lo_i, hi_i,
                                                 lo_f, hi_f, flags, nterms,
                                                 /*allow_empty=*/false);
  if (packed != cudaSuccess) return (int)packed;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
  const long long tiles = num_tiles(n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* counts = static_cast<long long*>(scratch);
  auto* words = reinterpret_cast<unsigned*>(counts + tiles);
  select_count<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(a, n, words, counts);
  select_scan<<<1, kScanThreads, 0, st>>>(counts, tiles, total);
  select_emit<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(words, counts, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
