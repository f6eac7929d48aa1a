// Per-bucket sort-merge match of a co-bucketed join (kernel B4).
//
// Replaces the XLA program hyperspace_tpu/ops/join.py::_bucket_join
// (vmapped over buckets at join.py:170) together with the host range
// expansion that follows it, ops/join.py::expand_match_ranges. The TPU
// form pads every bucket to the widest, argsorts both sides, searchsorts,
// and hands per-left-row [lo, hi) ranges to the host, which expands them
// into (left row, right row) pairs. Here the B buckets are ragged
// segments with no padding, the caller has already put each segment's
// right keys in ascending order (index buckets are key-sorted on disk;
// other sides are stably sorted on the card first), and the pairs are
// written straight into device memory:
//
//   count pass  one thread per left position i of segment b:
//               lo = lower_bound(r_sorted[rb0:rb1], l_keys[i]),
//               hi = upper_bound(r_sorted[lo:rb1], l_keys[i]),
//               writes lo (absolute) and cnt = hi - lo;
//   scan        the caller's inclusive cumsum of cnt sizes the output;
//   emit pass   pairs (l_row[i], r_row[lo + j]) for j in [0, cnt) at
//               each position's exclusive-scan offset, written by one
//               warp per 32 positions, 32 consecutive pairs at a time.
//
// A null l_row / r_row is the identity. The order of the pairs is segment
// ascending, then left position, then right sorted position: the order of
// the reference's native merge join (hs_merge_join_emit_i64) and of
// expand_match_ranges. Keys compare as signed int64, as numpy's
// searchsorted on int64 does, so INT64_MIN and INT64_MAX are ordinary
// keys; hi never passes the segment's end. Every count, offset and index
// is int64.
//
// Bound: the function reads each left key (8 B) and right key (8 B) once
// and the row maps where they are not the identity, and writes 16 B per
// pair. For orders (1,500,000 rows) joined to lineitem (6,001,215 rows)
// over 200 buckets with identity maps that is 12 + 48 + 96 MB = 156 MB,
// about 47 us at the 3.35 TB/s of an H100 SXM; the binary searches (about
// 15 probes per left row into a 240 KB bucket slice) are a few hundred
// million integer operations, far under that. So HBM bytes bound it.
//
// What the design does about that bound, simply: the probes of one warp
// walk neighbouring keys of one sorted slice, so they hit the same L2
// lines; the pairs, nearly all of the bytes, leave as whole 256-byte
// warp stores (one thread per left row looping over its matches wrote
// 8 bytes per sector per instruction and ran the emit pass at a quarter
// of the HBM rate on an H100), and a skewed row's matches are spread over
// its warp. The count pass's lo/cnt (16 B per left row) and the scan
// are extra traffic that a fused single-pass design would save;
// shared-memory staging of a bucket's right slice and cp.async are later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;

// One thread per left position, capped (a grid-stride loop takes the
// rest).
unsigned blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Read-only load through the non-coherent path (int64_t is long here;
// __ldg's 64-bit overload takes long long).
__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

// The segment b with offs[b] <= i < offs[b + 1], for 0 <= i < offs[B]:
// one before the first of offs[1..B] that exceeds i (empty segments share
// an offset and are skipped over).
__device__ __forceinline__ int64_t segment_of(const int64_t* __restrict__ offs,
                                              int64_t num_segments, int64_t i) {
  int64_t a = 1, e = num_segments;
  while (a < e) {
    const int64_t mid = a + ((e - a) >> 1);
    if (ld(offs + mid) <= i)
      a = mid + 1;
    else
      e = mid;
  }
  return a - 1;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ l_keys, int64_t n,
             const int64_t* __restrict__ l_offs,
             const int64_t* __restrict__ r_offs, int64_t num_segments,
             const int64_t* __restrict__ r_sorted,
             int64_t* __restrict__ lo_out, int64_t* __restrict__ cnt_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t b = segment_of(l_offs, num_segments, i);
    const int64_t rb1 = ld(r_offs + b + 1);
    const int64_t key = ld(l_keys + i);
    int64_t a = ld(r_offs + b), e = rb1;
    while (a < e) {  // lower bound: first position with r >= key
      const int64_t mid = a + ((e - a) >> 1);
      if (ld(r_sorted + mid) < key)
        a = mid + 1;
      else
        e = mid;
    }
    const int64_t lo = a;
    e = rb1;
    while (a < e) {  // upper bound: first position with r > key
      const int64_t mid = a + ((e - a) >> 1);
      if (ld(r_sorted + mid) <= key)
        a = mid + 1;
      else
        e = mid;
    }
    lo_out[i] = lo;
    cnt_out[i] = a - lo;
  }
}

// One warp per 32 consecutive left positions. Their pairs form one
// contiguous output range (the scan is in position order), which the
// warp writes 32 consecutive pairs at a time: lane t takes output p and
// finds the position that owns p by a binary search over the 32 lanes'
// scan ends, exchanged by shuffles. So every store instruction writes
// 256 contiguous bytes, whatever the counts, and a left row with many
// matches is spread over the whole warp.
__global__ void __launch_bounds__(kThreads)
emit_kernel(const int64_t* __restrict__ lo, const int64_t* __restrict__ cnt,
            const int64_t* __restrict__ incl, int64_t n,
            const int64_t* __restrict__ l_row,
            const int64_t* __restrict__ r_row, int64_t* __restrict__ li,
            int64_t* __restrict__ ri) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t w = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       w * 32 < n; w += warps) {
    const int64_t i = w * 32 + lane;
    const bool valid = i < n;
    // lanes past n own nothing: their end never precedes an output
    const int64_t end = valid ? ld(incl + i) : INT64_MAX;
    const int64_t start = valid ? end - ld(cnt + i) : INT64_MAX;
    const int64_t lv = valid ? (l_row ? ld(l_row + i) : i) : 0;
    const int64_t base = valid ? ld(lo + i) : 0;
    const int64_t first = __shfl_sync(0xffffffffu, start, 0);
    const int last_lane = (int)((n - w * 32 < 32) ? n - w * 32 - 1 : 31);
    const int64_t stop = __shfl_sync(0xffffffffu, end, last_lane);
    for (int64_t p0 = first; p0 < stop; p0 += 32) {
      const int64_t p = p0 + lane;
      int a = 0, e = 31;  // the first lane whose end exceeds p
      for (int step = 0; step < 5; ++step) {
        const int mid = (a + e) >> 1;
        if (__shfl_sync(0xffffffffu, end, mid) > p)
          e = mid;
        else
          a = mid + 1;
      }
      const int64_t o_start = __shfl_sync(0xffffffffu, start, a);
      const int64_t o_lv = __shfl_sync(0xffffffffu, lv, a);
      const int64_t o_base = __shfl_sync(0xffffffffu, base, a);
      if (p < stop) {
        const int64_t r = o_base + (p - o_start);
        li[p] = o_lv;
        ri[p] = r_row ? ld(r_row + r) : r;
      }
    }
  }
}

}  // namespace

// Count pass. l_keys [n], r_sorted [m], l_offs / r_offs [num_segments + 1]
// (0 first, n / m last, non-decreasing; the wrapper checks them on the
// host), lo / cnt [n] outputs; all int64 on the device. Launches on
// `stream`; returns a CUDA error code (0 on success). n = 0 launches
// nothing.
extern "C" int hs_bucket_match_count(const void* l_keys, int64_t n,
                                     const void* l_offs, const void* r_offs,
                                     int64_t num_segments, const void* r_sorted,
                                     void* lo, void* cnt, void* stream) {
  if (n < 0 || num_segments < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  count_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(l_keys), n,
      static_cast<const int64_t*>(l_offs), static_cast<const int64_t*>(r_offs),
      num_segments, static_cast<const int64_t*>(r_sorted),
      static_cast<int64_t*>(lo), static_cast<int64_t*>(cnt));
  return (int)cudaGetLastError();
}

// Emit pass. lo / cnt from the count pass, incl = inclusive cumsum of cnt
// (all [n] int64); l_row [n] and r_row [m] int64 or null (identity);
// li / ri [incl[n - 1]] int64 outputs. Returns a CUDA error code.
extern "C" int hs_bucket_match_emit(const void* lo, const void* cnt,
                                    const void* incl, int64_t n,
                                    const void* l_row, const void* r_row,
                                    void* li, void* ri, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  emit_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lo), static_cast<const int64_t*>(cnt),
      static_cast<const int64_t*>(incl), n,
      static_cast<const int64_t*>(l_row), static_cast<const int64_t*>(r_row),
      static_cast<int64_t*>(li), static_cast<int64_t*>(ri));
  return (int)cudaGetLastError();
}
