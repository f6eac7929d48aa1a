// murmur3 bucket ids over int64 key reps (kernel B1).
//
// Replaces the TPU kernel hyperspace_tpu/ops/hash.py::bucket_ids_pallas
// (pl.pallas_call at hash.py:248). That kernel reads interleaved lo/hi
// uint32 word planes [2k, n] that a separate split pass wrote; here each
// lane reads its rows' k int64 reps straight from the [k, n] key-rep
// tensor and splits lo/hi in registers, so the word planes never exist in
// device memory.
//
// Arithmetic (murmur3.cuh, shared with kernel B7): murmur3_32 body per
// 32-bit word, words in the order lo(key0), hi(key0), lo(key1), ...
// starting from `seed`; fmix with length 4 * 2k; then h % num_buckets as
// int32. Bit-identical to ops/hash.py::bucket_ids_torch (the plain
// PyTorch version).
//
// Bound: it moves 8k + 4 bytes per row (k reps read, one int32 written)
// and reuses nothing, so HBM bandwidth bounds it: at 6,001,215 rows and
// k = 1 that is 72.0 MB, 21.5 us at the 3.35 TB/s of an H100 SXM (700 W
// part). The integer work (two word mixes per key, fmix, the remainder)
// is about 12k + 15 operations per row, under half the memory time at
// k = 1; chip_smoke.py computes both for the card it runs on.
//
// Design for that bound:
// * Bytes in flight. A warp owns a tile of 128 rows: lane l holds rows
//   2l, 2l + 1, 64 + 2l and 65 + 2l. Per key plane it issues two 16-byte
//   loads, so every warp load instruction reads 512 contiguous bytes
//   (whole 32-byte sectors) and the two rows' bucket ids leave as two
//   8-byte stores of 256 contiguous bytes each. All loads of a tile go
//   out before any hashing, 32k bytes per lane.
// * Alignment per plane. Plane j starts 8jn bytes after plane 0, so with
//   odd n (or a view with a storage offset) a plane may be only 8-byte
//   aligned. The wrapper passes a bit per plane that is 16-byte aligned;
//   those take 16-byte loads, the others 8-byte loads of the same rows.
//   The host side checks the bits against the pointers before launching.
// * The remainder without a division: the wrapper passes
//   m = floor((2^64 - 1) / d) + 1 (mod 2^64), and murmur3.cuh's fastmod
//   takes four integer multiplies instead of the generic 32-bit division
//   sequence.
// * Specialised on k: k = 1, 2, 3 unroll fully; a runtime loop serves
//   larger k.
// * One resident wave: the grid is the device's SM count times the
//   blocks per SM that the occupancy calculator allows, capped by the
//   work; a grid-stride loop over tiles covers the rest, and the rows
//   after the last whole tile (fewer than 128) take a scalar path.
// * Cache hints: reps are read once, with ld.global.nc and no L1
//   allocation. The output is stored plainly: the sort that follows
//   reads it at once.
//
// On an NVIDIA H100 80GB HBM3 at 700 W it runs at about 92 % of the byte
// bound at k = 1, faster than a device copy of the same bytes; a TMA
// bulk-copy pipeline of the same arithmetic (scripts/torch_b1_tma.cu)
// measured slower, since the loads above already keep enough bytes in
// flight. PERF.md has the times and the script that took them.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 128;  // rows per warp and tile: 4 per lane
constexpr int kMaxDevices = 64;

using hs_murmur3::mix_rep;

// fmix, then h % d through m (murmur3.cuh)
__device__ __forceinline__ int32_t finish(uint32_t h, uint32_t len,
                                          uint64_t m, uint32_t d) {
  return (int32_t)hs_murmur3::fastmod(hs_murmur3::fmix(h, len), m, d);
}

__device__ __forceinline__ void load_pair16(const int64_t* p, uint64_t& a,
                                            uint64_t& b) {
  asm("ld.global.nc.L1::no_allocate.v2.u64 {%0, %1}, [%2];"
      : "=l"(a), "=l"(b)
      : "l"(p));
}

// rows r0, r0 + 1, r0 + 64, r0 + 65 of one plane; p points at row r0
__device__ __forceinline__ void load_rows(const int64_t* p, bool aligned,
                                          uint64_t v[4]) {
  if (aligned) {
    load_pair16(p, v[0], v[1]);
    load_pair16(p + 64, v[2], v[3]);
  } else {
    v[0] = (uint64_t)__ldg(p);
    v[1] = (uint64_t)__ldg(p + 1);
    v[2] = (uint64_t)__ldg(p + 64);
    v[3] = (uint64_t)__ldg(p + 65);
  }
}

// K > 0: exactly K key planes, unrolled; K == 0: k planes, a runtime loop
template <int K>
__global__ void __launch_bounds__(kThreads)
    murmur3_bucket_kernel(const int64_t* __restrict__ reps,
                          int32_t* __restrict__ out, int64_t n, int k,
                          uint32_t aligned_planes, uint64_t m, uint32_t d,
                          uint32_t seed) {
  const int planes = K > 0 ? K : k;
  const uint32_t len = 8u * (uint32_t)planes;
  const int lane = threadIdx.x & 31;
  const int64_t thread = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t tiles = n / kTileRows;
  for (int64_t tile = thread >> 5; tile < tiles; tile += warps) {
    const int64_t r0 = tile * kTileRows + 2 * lane;
    uint32_t h[4] = {seed, seed, seed, seed};
    if constexpr (K > 0) {
      uint64_t v[K][4];
#pragma unroll
      for (int j = 0; j < K; ++j)
        load_rows(reps + j * n + r0, (aligned_planes >> j) & 1u, v[j]);
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) h[r] = mix_rep(h[r], v[j][r]);
    } else {
      for (int j = 0; j < k; ++j) {
        uint64_t v[4];
        load_rows(reps + j * n + r0, j < 32 && ((aligned_planes >> j) & 1u),
                  v);
#pragma unroll
        for (int r = 0; r < 4; ++r) h[r] = mix_rep(h[r], v[r]);
      }
    }
    *reinterpret_cast<int2*>(out + r0) =
        make_int2(finish(h[0], len, m, d), finish(h[1], len, m, d));
    *reinterpret_cast<int2*>(out + r0 + 64) =
        make_int2(finish(h[2], len, m, d), finish(h[3], len, m, d));
  }
  // the ragged tail after the last whole tile, one row per thread
  const int64_t row = tiles * kTileRows + thread;
  if (row < n) {
    uint32_t h = seed;
    for (int j = 0; j < planes; ++j)
      h = mix_rep(h, (uint64_t)__ldg(reps + j * n + row));
    out[row] = finish(h, len, m, d);
  }
}

// blocks of one resident wave on the current device, capped by the work
template <int K>
cudaError_t grid_for(int64_t n, unsigned* blocks) {
  static std::atomic<int> wave[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int full = dev < kMaxDevices ? wave[dev].load(std::memory_order_relaxed) : 0;
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, murmur3_bucket_kernel<K>, kThreads, 0);
    if (err != cudaSuccess) return err;
    full = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) wave[dev].store(full, std::memory_order_relaxed);
  }
  // every tile's warp, and at least one block for the tail
  const int64_t warps_per_block = kThreads / 32;
  int64_t want = (n / kTileRows + warps_per_block - 1) / warps_per_block;
  if (want < 1) want = 1;
  *blocks = (unsigned)(want < full ? want : full);
  return cudaSuccess;
}

template <int K>
cudaError_t launch(const int64_t* reps, int32_t* out, int64_t n, int k,
                   uint32_t aligned_planes, uint64_t m, uint32_t d,
                   uint32_t seed, cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err = grid_for<K>(n, &blocks);
  if (err != cudaSuccess) return err;
  murmur3_bucket_kernel<K><<<blocks, kThreads, 0, stream>>>(
      reps, out, n, k, aligned_planes, m, d, seed);
  return cudaGetLastError();
}

}  // namespace

// reps: [k, n] int64, contiguous, on the device; out: [n] int32, 16-byte
// aligned. aligned_planes: bit j set iff plane j (j < 32) starts 16-byte
// aligned. fastmod_m: floor((2^64 - 1) / num_buckets) + 1 mod 2^64.
// Launches on `stream` and returns a CUDA error code (0 on success):
// cudaErrorInvalidValue for k or num_buckets out of range,
// cudaErrorMisalignedAddress if out or a plane marked aligned is not.
extern "C" int hs_murmur3_bucket_ids(const void* reps, void* out, int64_t n,
                                     int k, int64_t num_buckets,
                                     uint64_t fastmod_m, int64_t seed,
                                     uint32_t aligned_planes, void* stream) {
  if (k < 1 || num_buckets < 1 || num_buckets > (int64_t(1) << 31) || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const auto* r = static_cast<const int64_t*>(reps);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  for (int j = 0; j < k && j < 32; ++j)
    if (((aligned_planes >> j) & 1u) &&
        reinterpret_cast<uintptr_t>(r + j * n) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  auto* o = static_cast<int32_t*>(out);
  const auto d = (uint32_t)num_buckets;
  const auto s = (uint32_t)seed;
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: err = launch<1>(r, o, n, k, aligned_planes, fastmod_m, d, s, st); break;
    case 2: err = launch<2>(r, o, n, k, aligned_planes, fastmod_m, d, s, st); break;
    case 3: err = launch<3>(r, o, n, k, aligned_planes, fastmod_m, d, s, st); break;
    default: err = launch<0>(r, o, n, k, aligned_planes, fastmod_m, d, s, st);
  }
  return (int)err;
}
