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
// the status words it keeps between tiles are 8 bytes a tile. HBM
// bandwidth bounds it.
//
// Design: one launch, a single-pass scan with decoupled look-back
// (Merrill and Garland, 2016, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back").
// * A block takes a tile by a global atomic ticket, not by blockIdx:
//   every tile before it was taken by a block already running, so the
//   look-back below never waits on a block that has not started. Its 256
//   threads read the tile as row pairs, one 16-byte load a pair per
//   column as B3a does (pair_masks in range_terms.cuh), 4 pairs a thread
//   in flight, in rounds of 2,048 rows. Each warp step covers 64 rows;
//   its two ballots (even rows, odd rows) go to shared memory.
// * A tile has as few rounds (1 to 8) as put all tiles in one resident
//   wave of the card: a tile that looks back waits on every predecessor
//   that has not counted yet, so with a second wave every tile of it
//   waits on the first wave's slowest.
// * The block counts its tile (an exclusive scan of its steps' bit
//   counts) and publishes the count in its status word, flag A. Warp 0
//   then reads its predecessors' status words 128 at a time (4 a lane),
//   newest first, with volatile loads, until one holds an inclusive
//   prefix (flag P); the sum is the tile's exclusive offset, and the
//   block publishes its own inclusive prefix. Flag and value share one
//   64-bit word, so a reader never sees a flag without its value; a
//   __threadfence comes before each publication.
// * Each thread writes the tile offsets of its passing rows into shared
//   memory in order (rank = the bits before it in its step), and the
//   block writes the tile's indices out as contiguous 16-byte stores.
//   The last tile writes the total.

#include <cstdint>
#include <cuda_runtime.h>

#include "range_terms.cuh"

namespace {

using hs_terms::Args;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kPairs = 4;                          // row pairs a thread has in flight
constexpr int kMinBlocks = 4;                      // resident blocks an SM
constexpr int kRoundRows = 2 * kThreads * kPairs;  // rows of one round of loads
constexpr int kRoundWords = kRoundRows / 64;       // 64-row warp steps a round
constexpr int kMaxRounds = 8;                      // rounds a tile, at most
constexpr int kMaxTileWords = kRoundWords * kMaxRounds;
constexpr int kLook = 4;  // status words a lane reads a look-back step
constexpr unsigned long long kFlagA = 1ull << 62, kFlagP = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

__host__ __device__ inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

__device__ __forceinline__ void publish(unsigned long long* status, unsigned long long word) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(status) = word;
}

// The exclusive prefix of `tile` (> 0) by decoupled look-back, warp-wide:
// each step reads the kLook * 32 status words before `look`, newest first,
// until one holds an inclusive prefix. While a predecessor has not
// counted, the warp sleeps between reads (from 64 ns, doubling), so the
// spinning tiles' reads do not crowd the L2 that the loading tiles use.
__device__ long long look_back(const unsigned long long* status, long long tile, int lane) {
  long long excl = 0, look = tile - 1;
  unsigned delay = 64;  // ns, doubling up to ~1 us
  while (true) {
    unsigned long long st[kLook];
    bool unset = false;
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      const long long idx = look - (lane * kLook + i);
      st[i] = kFlagP | 0ull;  // before tile 0: an empty prefix
      if (idx >= 0) st[i] = *reinterpret_cast<const volatile unsigned long long*>(status + idx);
      unset |= (st[i] & ~kValue) == 0;
    }
    if (__any_sync(kFull, unset)) {  // a predecessor not yet counted: back off
      __nanosleep(delay);
      delay = delay < 1024 ? 2 * delay : delay;
      continue;
    }
    int first_p = kLook;
#pragma unroll
    for (int i = kLook - 1; i >= 0; --i)
      if ((st[i] & ~kValue) == kFlagP) first_p = i;
    const unsigned pmask = __ballot_sync(kFull, first_p < kLook);
    const int stop_lane = pmask ? __ffs(pmask) - 1 : kWarp;
    long long v = 0;
#pragma unroll
    for (int i = 0; i < kLook; ++i)
      if (lane < stop_lane || (lane == stop_lane && i <= first_p))
        v += static_cast<long long>(st[i] & kValue);
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (pmask) return excl;
    look -= kWarp * kLook;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    select_tiles(const __grid_constant__ Args a, long long n, int rounds,
                 long long* __restrict__ out, long long* __restrict__ total,
                 unsigned* __restrict__ ticket, unsigned long long* __restrict__ status,
                 long long tiles) {
  __shared__ uint2 bits[kMaxTileWords];
  __shared__ int word_off[kMaxTileWords];
  __shared__ unsigned short stage[kMaxTileWords * 64];
  __shared__ int warp_total[kWarps];
  __shared__ long long s_tile, s_excl;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int words = rounds * kRoundWords;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long row0 = tile * words * 64;

  // the predicate, kPairs pairs a thread a round; step word = round * 32 + u * 8 + warp
  for (int round = 0; round < rounds; ++round) {
    bool ok0[kPairs], ok1[kPairs];
    hs_terms::pair_masks<kVec, kPairs>(a, row0 / 2 + round * kThreads * kPairs + threadIdx.x,
                                       kThreads, n, ok0, ok1);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const unsigned b0 = __ballot_sync(kFull, ok0[u]), b1 = __ballot_sync(kFull, ok1[u]);
      if (lane == 0) bits[(round * kPairs + u) * kWarps + warp] = make_uint2(b0, b1);
    }
  }
  __syncthreads();
  // exclusive scan of the steps' counts, a thread a step, in passes of 256
  int count = 0;
  for (int w0 = 0; w0 < words; w0 += kThreads) {
    const int w = w0 + threadIdx.x;
    int c = 0, incl = 0;
    if (w < words) {
      const uint2 b = bits[w];
      c = __popc(b.x) + __popc(b.y);
    }
    incl = c;
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == kWarp - 1) warp_total[warp] = incl;
    __syncthreads();
    int before = count;
    for (int v = 0; v < warp; ++v) before += warp_total[v];
    if (w < words) word_off[w] = before + incl - c;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) count += warp_total[v];
    __syncthreads();
  }

  if (warp == 0) {  // publish, look back, publish
    long long excl = 0;
    if (tile == 0) {
      if (lane == 0) publish(status, kFlagP | static_cast<unsigned long long>(count));
    } else {
      if (lane == 0) publish(status + tile, kFlagA | static_cast<unsigned long long>(count));
      excl = look_back(status, tile, lane);
      if (lane == 0)
        publish(status + tile, kFlagP | static_cast<unsigned long long>(excl + count));
    }
    if (lane == 0) s_excl = excl;
  }

  // the passing rows' tile offsets, in order
  const unsigned below = (1u << lane) - 1u;
  for (int word = warp; word < words; word += kWarps) {
    const uint2 w = bits[word];
    const bool p0 = (w.x >> lane) & 1u, p1 = (w.y >> lane) & 1u;
    const int at = word_off[word] + __popc(w.x & below) + __popc(w.y & below);
    const int off = word * 64 + 2 * lane;
    if (p0) stage[at] = static_cast<unsigned short>(off);
    if (p1) stage[at + (p0 ? 1 : 0)] = static_cast<unsigned short>(off + 1);
  }
  __syncthreads();
  const long long excl = s_excl;
  long long* dst = out + excl;
  const int head = (reinterpret_cast<uintptr_t>(dst) % 16 != 0 && count > 0) ? 1 : 0;
  if (head && threadIdx.x == 0) dst[0] = row0 + stage[0];
  for (int j = head + 2 * threadIdx.x; j + 1 < count; j += 2 * kThreads)
    *reinterpret_cast<longlong2*>(dst + j) = make_longlong2(row0 + stage[j], row0 + stage[j + 1]);
  if (((count - head) & 1) && threadIdx.x == 0) dst[count - 1] = row0 + stage[count - 1];
  if (tile == tiles - 1 && threadIdx.x == 0) *total = excl + count;
}

// Rounds a tile for n rows: as few as put every tile in one resident wave
// of the card (so no tile waits on a tile that waits for an SM), at most
// kMaxRounds.
int rounds_for(long long n) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, select_tiles<true>, kThreads, 0);
    resident = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long r = ceil_div(ceil_div(n, resident), kRoundRows);
  return static_cast<int>(r < 1 ? 1 : (r > kMaxRounds ? kMaxRounds : r));
}

}  // namespace

extern "C" {

// Bytes of scratch for n rows: the tile ticket (8 bytes), then a status
// word a tile (for tiles of one round, the most tiles there can be).
long long hs_select_scratch_bytes(long long n) { return 8 + ceil_div(n, kRoundRows) * 8; }

// cols/valids/term_col/lo_i/hi_i/lo_f/hi_f/flags/nterms: the terms as
// hs_range_mask (range_mask.cu) takes them. out: [n] int64 device
// capacity for the indices (8-byte aligned; NULL for n = 0); total: one int64 on the
// device, the number written; scratch: hs_select_scratch_bytes(n) bytes,
// zeroed here. Launches on `stream` (one kernel, after one memset);
// returns a CUDA error code.
int hs_fused_select(const void* const* cols, const void* const* valids, int ncols,
                    const int* term_col, const int64_t* lo_i, const int64_t* hi_i,
                    const double* lo_f, const double* hi_f, const int* flags, int nterms,
                    long long n, long long* out, long long* total, void* scratch,
                    void* stream) {
  if (n < 0 || (n > 0 && (out == nullptr || scratch == nullptr)) || total == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(total, 0, sizeof(long long), st);
  Args a;
  const cudaError_t packed = hs_terms::pack_args(a, cols, valids, ncols, term_col, lo_i, hi_i,
                                                 lo_f, hi_f, flags, nterms,
                                                 /*allow_empty=*/false);
  if (packed != cudaSuccess) return (int)packed;
  const int rounds = rounds_for(n);
  const long long tiles = ceil_div(n, static_cast<long long>(rounds) * kRoundRows);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, 8 + tiles * 8, st);
  if (err != cudaSuccess) return (int)err;
  auto* ticket = static_cast<unsigned*>(scratch);
  auto* status = reinterpret_cast<unsigned long long*>(static_cast<char*>(scratch) + 8);
  const unsigned blocks = static_cast<unsigned>(tiles);
  if (hs_terms::vec_aligned(a))
    select_tiles<true><<<blocks, kThreads, 0, st>>>(a, n, rounds, out, total, ticket, status,
                                                    tiles);
  else
    select_tiles<false><<<blocks, kThreads, 0, st>>>(a, n, rounds, out, total, ticket, status,
                                                     tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
