// The bucket exchange of the sharded build (kernel B8): pack (B8a) and
// order (B8b).
//
// Replaces the body of the XLA program
// hyperspace_tpu/parallel/shuffle.py::_flat_program (:306-365), the flat
// strategy's shard_map. There each shard argsorts its rows by destination
// shard (bucket % D, invalid rows to a sentinel D), scatters every column
// into a [D, cap] buffer, all_to_all's the buffers, and argsorts the
// D * cap received slots by bucket with invalid slots last. Here the
// exchange between shards is a copy of [D, cap] blocks (a transposition
// on one card, Tensor.to(peer) across cards, parallel/shuffle.py), and
// the two sorts around it are this file:
//
//   B8a hs_exchange_pack   one shard's rows: the stable rank of each valid
//                          row within its destination d = bucket % D, its
//                          slot d * cap + rank, every column scattered into
//                          [D, cap]; invalid rows (the sentinel digit D)
//                          are dropped, a rank that reaches cap sets bit 1
//                          of the error word and is dropped too.
//   B8b hs_exchange_order  one shard's D * cap received slots: the stable
//                          order by bucket with invalid slots last (a
//                          counting sort over num_buckets + 1 digits), and
//                          every column scattered to its ordered position;
//                          starts[num_buckets] is the count of valid rows.
//
// Both are one stable counting sort, in one launch sequence:
//   hist    a warp counts the digits of its tile of kTile rows in shared
//           memory (one counter array a warp) and writes them to
//           hist[tile][digit];
//   scan    a thread a digit turns hist into the exclusive prefix over
//           tiles in tile order (each tile's first rank per digit) and
//           writes the digit's total;
//   starts  (B8b) one thread: each digit's first output position;
//   rank    a warp walks its tile 32 rows at a time, in row order, with
//           its counters seeded from the scanned hist: __match_any_sync
//           groups the lanes of one digit, a lane's rank is the counter
//           plus the lanes of its digit below it, and the group's first
//           lane adds the group's size. Row order within a tile, tile
//           order across tiles: the ranks are the stable ones, so the
//           result is bit-equal to a stable argsort by digit.
//   scatter one launch a column, by element size (1, 2, 4 or 8 bytes):
//           dst[pos[i]] = src[i] where pos[i] >= 0.
// A digit outside [0, digits) (a bucket id out of range) sets bit 2 of
// the error word; the wrapper reads the word and raises.
//
// Bound: the function must read the bucket ids (4 B), the valid mask
// (1 B) and every column once, and write every column once: for the
// lineitem build at D = 4 (6,001,215 rows, a few 8-byte columns a row)
// some hundreds of MB, tens of microseconds at the 3.35 TB/s of an H100
// SXM. The arithmetic is a few integer operations a row. So HBM bytes
// bound it. This first version is simple and correct rather than fast:
// the rank pass reads the ids and the mask a second time, writes and
// reads an int64 position a row, and the scatters write with no
// coalescing across destinations. Making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 32;        // rows a warp takes in one step
constexpr int kSteps = 32;           // steps a tile
constexpr int64_t kTile = kWarpRows * kSteps;  // 1,024 rows a warp tile
constexpr int kMaxWarps = 8;         // warps a block, shared memory allowing
constexpr int kSharedLimit = 227 * 1024;
constexpr int kErrOverflow = 1;
constexpr int kErrDigit = 2;

// The digit of row i: its destination shard (mod > 0) or its bucket
// (mod == 0); invalid rows take the sentinel, the last digit.
__device__ __forceinline__ int digit_of(const int32_t* bucket, const bool* valid, int64_t i,
                                        int mod, int sentinel) {
  if (!valid[i]) return sentinel;
  const int b = bucket[i];
  return mod > 0 ? (b >= 0 ? b % mod : -1) : b;
}

__global__ void hist_kernel(const int32_t* __restrict__ bucket, const bool* __restrict__ valid,
                            int64_t n, int mod, int digits, int64_t tiles,
                            int32_t* __restrict__ hist, int* __restrict__ err) {
  extern __shared__ int32_t counters[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (tile >= tiles) return;
  int32_t* cnt = counters + (int64_t)warp * digits;
  for (int d = lane; d < digits; d += 32) cnt[d] = 0;
  __syncwarp();
  const int64_t base = tile * kTile;
  for (int step = 0; step < kSteps; ++step) {
    const int64_t i = base + step * kWarpRows + lane;
    if (i < n) {
      const int d = digit_of(bucket, valid, i, mod, digits - 1);
      if (d < 0 || d >= digits)
        atomicOr(err, kErrDigit);
      else
        atomicAdd(&cnt[d], 1);
    }
  }
  __syncwarp();
  for (int d = lane; d < digits; d += 32) hist[tile * digits + d] = cnt[d];
}

__global__ void scan_kernel(int32_t* __restrict__ hist, int64_t tiles, int digits,
                            int64_t* __restrict__ totals) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= digits) return;
  int64_t run = 0;
  for (int64_t t = 0; t < tiles; ++t) {
    const int32_t c = hist[t * digits + d];
    hist[t * digits + d] = (int32_t)run;
    run += c;
  }
  totals[d] = run;
}

__global__ void starts_kernel(const int64_t* __restrict__ totals, int digits,
                              int64_t* __restrict__ starts) {
  int64_t run = 0;
  for (int d = 0; d < digits; ++d) {
    starts[d] = run;
    run += totals[d];
  }
  starts[digits] = run;
}

// pos[i]: pack (starts == nullptr) d * cap + rank for a valid row, -1 for
// an invalid one or one past cap; order starts[d] + rank.
__global__ void rank_kernel(const int32_t* __restrict__ bucket, const bool* __restrict__ valid,
                            int64_t n, int mod, int digits, int64_t tiles,
                            const int32_t* __restrict__ hist, const int64_t* __restrict__ starts,
                            int64_t cap, int64_t* __restrict__ pos, int* __restrict__ err) {
  extern __shared__ int32_t counters[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x / 32) + warp;
  if (tile >= tiles) return;
  int32_t* cnt = counters + (int64_t)warp * digits;
  for (int d = lane; d < digits; d += 32) cnt[d] = hist[tile * digits + d];
  __syncwarp();
  const int sentinel = digits - 1;
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = tile * kTile;
  for (int step = 0; step < kSteps; ++step) {
    const int64_t i = base + step * kWarpRows + lane;
    int d = -1;
    if (i < n) {
      d = digit_of(bucket, valid, i, mod, sentinel);
      if (d < 0 || d >= digits) d = -1;  // counted by hist already
    }
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int32_t first = d >= 0 ? cnt[d] : 0;
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) cnt[d] = first + __popc(peers);
    __syncwarp();
    if (i >= n) continue;
    int64_t p = -1;
    if (d >= 0) {
      const int64_t r = (int64_t)first + __popc(peers & below);
      if (starts != nullptr) {
        p = starts[d] + r;
      } else if (d != sentinel) {
        if (r < cap)
          p = (int64_t)d * cap + r;
        else
          atomicOr(err, kErrOverflow);
      }
    }
    pos[i] = p;
  }
}

template <typename T>
__global__ void scatter_kernel(const T* __restrict__ src, const int64_t* __restrict__ pos,
                               int64_t n, T* __restrict__ dst) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t p = pos[i];
    if (p >= 0) dst[p] = src[i];
  }
}

int scatter_columns(int64_t n, const int64_t* pos, int ncols, void* const* srcs,
                    void* const* dsts, const int* sizes, cudaStream_t s) {
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  for (int c = 0; c < ncols; ++c) {
    switch (sizes[c]) {
      case 1:
        scatter_kernel<uint8_t><<<blocks, threads, 0, s>>>(
            static_cast<const uint8_t*>(srcs[c]), pos, n, static_cast<uint8_t*>(dsts[c]));
        break;
      case 2:
        scatter_kernel<uint16_t><<<blocks, threads, 0, s>>>(
            static_cast<const uint16_t*>(srcs[c]), pos, n, static_cast<uint16_t*>(dsts[c]));
        break;
      case 4:
        scatter_kernel<uint32_t><<<blocks, threads, 0, s>>>(
            static_cast<const uint32_t*>(srcs[c]), pos, n, static_cast<uint32_t*>(dsts[c]));
        break;
      case 8:
        scatter_kernel<uint64_t><<<blocks, threads, 0, s>>>(
            static_cast<const uint64_t*>(srcs[c]), pos, n, static_cast<uint64_t*>(dsts[c]));
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// hist, scan, (starts,) rank and the scatters of one counting sort.
int counting_sort(const int32_t* bucket, const bool* valid, int64_t n, int mod, int digits,
                  int64_t cap, int32_t* hist, int64_t* totals, int64_t* starts, int64_t* pos,
                  int* err, int ncols, void* const* srcs, void* const* dsts, const int* sizes,
                  cudaStream_t s) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t per_warp = (int64_t)digits * sizeof(int32_t);
  if (per_warp > kSharedLimit) return (int)cudaErrorInvalidValue;
  int warps = (int)(48 * 1024 / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) warps = 1;
  const int smem = (int)(warps * per_warp);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const int64_t blocks = (tiles + warps - 1) / warps;
  hist_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(bucket, valid, n, mod, digits, tiles,
                                                         hist, err);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<(digits + 255) / 256, 256, 0, s>>>(hist, tiles, digits, totals);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (starts != nullptr) {
    starts_kernel<<<1, 1, 0, s>>>(totals, digits, starts);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  rank_kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(bucket, valid, n, mod, digits, tiles,
                                                         hist, starts, cap, pos, err);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  return scatter_columns(n, pos, ncols, srcs, dsts, sizes, s);
}

}  // namespace

// Rows a warp tile holds: the wrapper sizes hist as [ceil(n / tile), digits].
extern "C" int64_t hs_exchange_tile_rows() { return kTile; }

// B8a. bucket [n] int32 and valid [n] bool on the device; D >= 1 shards;
// cap >= 1 slots a destination; hist [tiles * (D + 1)] int32, totals
// [D + 1] int64 (the count a destination, then the invalid rows), pos [n]
// int64 and err [1] int32 (zeroed by the caller) are scratch and outputs;
// srcs [ncols] device columns of n rows, dsts [ncols] zeroed [D, cap]
// buffers, sizes [ncols] their element sizes; srcs, dsts and sizes are
// host arrays. Launches on `stream`; returns a CUDA error code.
extern "C" int hs_exchange_pack(const void* bucket, const void* valid, int64_t n, int D,
                                int64_t cap, void* hist, void* totals, void* pos, void* err,
                                int ncols, void* const* srcs, void* const* dsts,
                                const int* sizes, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || D < 1 || cap < 1 || ncols < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  return counting_sort(static_cast<const int32_t*>(bucket), static_cast<const bool*>(valid), n,
                       D, D + 1, cap, static_cast<int32_t*>(hist),
                       static_cast<int64_t*>(totals), nullptr, static_cast<int64_t*>(pos),
                       static_cast<int*>(err), ncols, srcs, dsts, sizes,
                       static_cast<cudaStream_t>(stream));
}

// B8b. bucket [n] int32 and valid [n] bool: a shard's received slots;
// num_buckets >= 1; hist [tiles * (num_buckets + 1)] int32, totals
// [num_buckets + 1] int64, starts [num_buckets + 2] int64 (each digit's
// first position, last the row count; starts[num_buckets] is the count of
// valid rows), pos [n] int64, err [1] int32 zeroed; srcs [ncols] columns
// of n rows, dsts [ncols] outputs of n rows. Returns a CUDA error code.
extern "C" int hs_exchange_order(const void* bucket, const void* valid, int64_t n,
                                 int num_buckets, void* hist, void* totals, void* starts,
                                 void* pos, void* err, int ncols, void* const* srcs,
                                 void* const* dsts, const int* sizes, void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || num_buckets < 1 || ncols < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  return counting_sort(static_cast<const int32_t*>(bucket), static_cast<const bool*>(valid), n,
                       0, num_buckets + 1, 0, static_cast<int32_t*>(hist),
                       static_cast<int64_t*>(totals), static_cast<int64_t*>(starts),
                       static_cast<int64_t*>(pos), static_cast<int*>(err), ncols, srcs, dsts,
                       sizes, static_cast<cudaStream_t>(stream));
}
