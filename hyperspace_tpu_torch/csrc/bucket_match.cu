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
// written straight into device memory.
//
// A null l_row / r_row is the identity. The order of the pairs is segment
// ascending, then left position, then right sorted position: the order of
// the reference's native merge join (hs_merge_join_emit_i64) and of
// expand_match_ranges. Keys compare as signed int64, as numpy's
// searchsorted on int64 does, so INT64_MIN and INT64_MAX are ordinary
// keys; no bound passes its segment's end.
//
// Bound: the function reads each left key (8 B) and right key (8 B) once
// and the row maps where they are not the identity, and writes 16 B per
// pair. For orders (1,500,000 rows) joined to lineitem (6,001,215 rows)
// over 200 buckets with identity maps that is 12 + 48 + 96 MB = 156 MB,
// about 47 us at the 3.35 TB/s of an H100 SXM; the searches are a few
// hundred million integer operations, far under that. So HBM bytes bound
// it, and what stands between a simple design and that bound is the
// latency of dependent probes (a binary search per left row is ~15
// dependent loads) and the bytes of intermediates.
//
// The design against that bound. A warp takes 32 left positions at a
// time (a group, g = i / 32) and shares all the work it can between them,
// in three launches:
//
//   count pass  Each warp walks one range of consecutive groups; the
//               ranges split the groups evenly over one resident wave of
//               the pass (hs_bucket_match_ranges asks the occupancy API),
//               so all of them run at once. A lane holds kRows = 2 rows
//               (a unit of 64 positions), whose searches are independent
//               chains. Per unit, segment by segment (most units lie in
//               one):
//               1. the segment is found once, by a 32-ary search of the
//                  whole warp over the offsets (32 probes a round, one
//                  ballot), when the unit starts past the last segment;
//               2. the rows' least and greatest key (a vote that they
//                  ascend, then the first and last row; shuffle
//                  reductions otherwise) say which window of the
//                  segment's right keys serves them. A window is kWindow
//                  keys copied into the warp's shared memory with
//                  cp.async, padded with INT64_MAX and skewed one word in
//                  17 against bank conflicts, and it serves the rows when
//                  the key just past it lies above their greatest key. It
//                  starts at the lower bound of their least key (a 32-ary
//                  warp search, 3 rounds for a 30,000-key bucket; the
//                  key just past the window is read before any copy, so
//                  rows that no window can serve copy nothing), or,
//                  when the rows continue upward from the last rows
//                  matched in the segment (an index bucket; TPC-H orders
//                  in row order), at the lower bound of those rows'
//                  greatest key: no search at all, and the staged window
//                  serves on while it covers the rows (about two units on
//                  TPC-H buckets). A segment that begins in the unit
//                  starts at its first right key;
//               3. every row finds both bounds in the window by binary
//                  lifting (9 steps and a last probe, int indices);
//               4. rows no window serves (keys spread wider than kWindow
//                  right keys: heavy duplicates, left keys in random
//                  order) search global memory on their own: the lower
//                  bounds of a lane's kRows rows by one binary search in
//                  lockstep (independent probes), then galloping from
//                  each (lo, lo + 2, lo + 6, ...) for the upper.
//               The pass writes lo and cnt per position, each group's
//               first output within its range (group_first) and each
//               range's pair total (range_tot).
//   scan        one block scans the range totals (about 2,600) in place,
//               launched as a programmatic dependent of the count pass so
//               that its launch overlaps that pass's end.
//   emit pass   one group per warp: a shuffle inclusive scan of the lanes'
//               cnt from the group's first output gives each position's
//               output range; the warp writes the pairs 32 at a time, each
//               store one aligned 256-byte block of li / ri (lane t takes
//               output p and finds its position by a 5-step search over
//               the lanes' range ends), so a row with many matches is
//               spread over its warp.
//
// lo and cnt are int32 when the right side has fewer than 2^31 rows
// (every lo is below m, every cnt at most a segment's length) and int64
// otherwise (index_bytes = 4 or 8, chosen by the caller): 8 or 16 B per
// left row written by the count pass and read by the emit pass, on top
// of the bound's bytes. Sums, offsets and output positions are int64.
//
// Where the time goes on an H100 (chip_smoke.py, TPC-H SF1 indexed join):
// the emit pass writes at about 75-80 % of the card's fill rate; the
// count pass is half one warp's chain of dependent steps (a unit costs
// about 3,500 cycles alone) and half contention between the warps of an
// SM, so fewer instructions a row would move it, more DRAM parallelism
// would not.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 512;  // right keys a warp stages in shared memory
// shared-memory words of a window: one pad word after every 16 keys
constexpr int kWindowWords = kWindow + kWindow / 16;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// One warp per range of groups in the count pass, per group in the emit
// pass (a grid-stride loop takes any rest).
unsigned blocks_for(int64_t warps) {
  const int64_t b = (warps + kWarps - 1) / kWarps;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// Read-only load through the non-coherent path (int64_t is long here;
// __ldg's 64-bit overload takes long long).
__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int64_t ld(const int32_t* p) { return __ldg(p); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ bool before(int64_t v, int64_t x, bool upper) {
  return v < x || (upper && v == x);
}

// The first position p in [a, e) whose key is >= x (> x when `upper`),
// else e; `key(p)` loads a key. One lane's binary search.
template <typename Key>
__device__ __forceinline__ int64_t bound(Key key, int64_t a, int64_t e,
                                         int64_t x, bool upper) {
  while (a < e) {
    const int64_t mid = a + ((e - a) >> 1);
    if (before(key(mid), x, upper))
      a = mid + 1;
    else
      e = mid;
  }
  return a;
}

// The same bound found by the whole warp for one x: each round the 32
// lanes probe the ends of 32 equal slices of [a, e) at once and a ballot
// keeps the one slice that holds the bound, so a search over L keys takes
// about log_32 L rounds of independent loads instead of log_2 L dependent
// ones (3 rounds for a 30,000-key bucket, 5 for 6,000,000 keys). Every
// lane gets the result.
template <typename Key>
__device__ __forceinline__ int64_t warp_bound(Key key, int64_t a, int64_t e,
                                              int64_t x, bool upper, int lane) {
  while (e - a > 32) {
    const int64_t step = (e - a + 31) >> 5;
    const int64_t p = min64(a + (lane + 1) * step, e) - 1;  // lane 31 probes e - 1
    const int c = __popc(__ballot_sync(kFull, before(key(p), x, upper)));
    if (c == 32) return e;
    const int64_t pc = min64(a + (c + 1) * step, e) - 1;  // the first probe not before x
    a += c * step;
    e = pc;
  }
  const int64_t p = a + lane;
  return a + __popc(__ballot_sync(kFull, p < e && before(key(p), x, upper)));
}

// The upper bound of x in [lo, e), where lo is its lower bound there:
// probes lo, lo + 2, lo + 6, ... (steps 1, 2, 4, ...) until a key above x
// or the end, then a binary search in the last step.
template <typename Key>
__device__ __forceinline__ int64_t gallop_upper(Key key, int64_t lo, int64_t e,
                                                int64_t x) {
  int64_t a = lo, step = 1;  // every key in [lo, a) equals x
  while (true) {
    const int64_t p = a + step - 1;
    if (p >= e) return bound(key, a, e, x, true);
    if (key(p) > x) return bound(key, a, p, x, true);
    a = p + 1;
    step <<= 1;
  }
}

// The warp's sum of the lanes' counts. With int32 counts (each below
// 2^31) two 32-bit reductions of the halves are exact.
template <typename Idx>
__device__ __forceinline__ int64_t warp_sum(int64_t v) {
  if constexpr (sizeof(Idx) == 4) {
    const unsigned u = (unsigned)v;
    return (int64_t)__reduce_add_sync(kFull, u & 0xffffu) +
           ((int64_t)__reduce_add_sync(kFull, u >> 16) << 16);
  } else {
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    return v;
  }
}

// 8 bytes from global to shared memory without a register (cp.async).
__device__ __forceinline__ void copy_async8(int64_t* smem, const int64_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// Key j of a staged window sits at word j + j / 16: the probes of one
// binary-lifting step (positions 15 apart modulo 16 for steps of 16 and
// more) then fall in different banks, where without the pad word they all
// hit one bank, up to 32 ways.
__device__ __forceinline__ int skew(int j) { return j + (j >> 4); }

// A window of a segment's right keys staged in a warp's shared memory:
// r_sorted[s, s + len), len = min(kWindow, rb1 - s), padded with
// INT64_MAX to kWindow; `past` is the key at s + kWindow unless the window
// reaches the segment's end.
struct Window {
  int64_t s = 0, past = 0;
  int len = 0;
  bool to_end = false;
  // every key up to kmax lies inside
  __device__ bool covers(int64_t kmax) const { return to_end || past > kmax; }
};

// Stages the window at s for rows whose greatest key is kmax. With
// `peek` the key past the window is read first and nothing is copied
// unless the window covers kmax (after a fresh search, where rows with
// widely spread keys go on in global memory); otherwise that read
// overlaps the copy.
__device__ __forceinline__ Window stage_window(const int64_t* __restrict__ r_sorted,
                                               int64_t* win, int64_t s, int64_t rb1,
                                               int64_t kmax, bool peek, int lane) {
  Window w;
  w.s = s;
  w.len = (int)(rb1 - s < kWindow ? rb1 - s : kWindow);
  w.to_end = s + kWindow >= rb1;
  const int64_t past = lane == 0 && !w.to_end ? ld(r_sorted + s + kWindow) : 0;
  if (peek) {
    w.past = __shfl_sync(kFull, past, 0);
    if (!w.covers(kmax)) return w;
  }
  __syncwarp();  // the previous window is read
#pragma unroll
  for (int k = 0; k < kWindow / 32; ++k) {
    const int j = lane + 32 * k;
    if (j < w.len)
      copy_async8(win + skew(j), r_sorted + s + j);
    else
      win[skew(j)] = INT64_MAX;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  w.past = __shfl_sync(kFull, past, 0);
  return w;
}

// A unit of the count pass: kRows left positions a lane, 32 * kRows a
// warp (unit u holds groups kRows * u ... kRows * u + kRows - 1, row r of
// lane t at position 32 * (kRows * u + r) + t). The rows' bounds are
// independent chains, so a warp has kRows of them in flight.
constexpr int kRows = 2;

// v[r] for a warp-uniform r, without indexing a register array.
__device__ __forceinline__ int64_t pick(const int64_t (&v)[kRows], int r) {
  int64_t x = v[0];
#pragma unroll
  for (int k = 1; k < kRows; ++k)
    if (r == k) x = v[k];
  return x;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ l_keys, int64_t n,
             const int64_t* __restrict__ l_offs,
             const int64_t* __restrict__ r_offs, int64_t num_segments,
             const int64_t* __restrict__ r_sorted, int64_t range_groups,
             Idx* __restrict__ lo_out, Idx* __restrict__ cnt_out,
             int64_t* __restrict__ group_first, int64_t* __restrict__ range_tot) {
  __shared__ int64_t windows[kWarps][kWindowWords];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  int64_t* win = windows[threadIdx.x >> 5];
  const auto offset = [l_offs](int64_t p) { return ld(l_offs + p); };
  const auto global_key = [r_sorted](int64_t p) { return ld(r_sorted + p); };
  if (blockIdx.x == 0 && threadIdx.x == 0) range_tot[0] = 0;
  constexpr int kUnit = 32 * kRows;
  const int64_t groups = (n + 31) >> 5, units = (n + kUnit - 1) / kUnit;
  const int64_t range_units = range_groups / kRows;
  const int64_t ranges = (units + range_units - 1) / range_units;
  for (int64_t rg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); rg < ranges;
       rg += (int64_t)gridDim.x * kWarps) {
    int64_t u = rg * range_units;
    const int64_t u_end = min64(u + range_units, units);
    // the segment being matched, its end, and its right keys' bounds
    int64_t b = 0, seg_end = 0, rb0 = 0, rb1 = 0;
    // the window staged last, and a start for the next window (or -1):
    // the lower bound of prev_max, the greatest key matched so far in
    // this segment. A next set of keys not below prev_max (left keys
    // ascending, as in an index bucket or TPC-H's orders) needs no
    // search: it continues in the staged window while that covers it,
    // else in a window staged from there.
    Window w;
    int64_t hint = -1, prev_max = 0;
    int64_t range_total = 0;  // the pairs of the range's groups so far
    int64_t key[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = u * kUnit + 32 * r + lane;
      key[r] = i < n ? ld(l_keys + i) : 0;
    }
    for (; u < u_end; ++u) {
      const int64_t i0 = u * kUnit;
      int64_t next_key[kRows];  // the next unit's keys, loaded early
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t i = i0 + kUnit + 32 * r + lane;
        next_key[r] = u + 1 < u_end && i < n ? ld(l_keys + i) : 0;
      }
      int64_t lo[kRows], cnt[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) lo[r] = cnt[r] = 0;
      const int64_t i_end = min64(i0 + kUnit, n);
      // the unit's rows, one segment at a time (most units lie in one)
      for (int64_t p = i0; p < i_end; p = seg_end) {
        if (p >= seg_end) {  // 1. a new segment, found by the warp
          b = warp_bound(offset, b + 1, num_segments, p, true, lane) - 1;
          seg_end = ld(l_offs + b + 1);
          rb0 = ld(r_offs + b);
          rb1 = ld(r_offs + b + 1);
          // from its start, its first window is a guess at rb0
          const bool fresh = p == ld(l_offs + b);
          hint = fresh ? rb0 : -1;
          prev_max = INT64_MIN;
          w.to_end = false;
          w.past = INT64_MIN;  // covers nothing
        }
        const int64_t pe = min64(seg_end, i_end);  // the rows [p, pe) are in
        bool in[kRows], asc = true;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int64_t i = i0 + 32 * r + lane;
          in[r] = i >= p && i < pe;
          // the key of the next row in position order: the next lane's, or
          // lane 0's of the next row
          const int64_t up = __shfl_down_sync(kFull, key[r], 1);
          const int64_t wrap = __shfl_sync(kFull, key[(r + 1) % kRows], 0);
          asc = asc && (!in[r] || i + 1 >= pe || key[r] <= (lane < 31 ? up : wrap));
        }
        // 2. a window of right keys that starts at or before the lower
        // bound of the rows' least key serves them when it holds every
        // key up to their greatest
        int64_t kmin, kmax;
        if (__all_sync(kFull, asc)) {  // ascending: the first and last rows'
          kmin = __shfl_sync(kFull, pick(key, (int)(p - i0) >> 5), (int)(p - i0) & 31);
          kmax = __shfl_sync(kFull, pick(key, (int)(pe - 1 - i0) >> 5), (int)(pe - 1 - i0) & 31);
        } else {
          kmin = INT64_MAX;
          kmax = INT64_MIN;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (in[r] && key[r] < kmin) kmin = key[r];
            if (in[r] && key[r] > kmax) kmax = key[r];
          }
          for (int d = 16; d; d >>= 1) {
            const int64_t x = __shfl_xor_sync(kFull, kmin, d);
            const int64_t y = __shfl_xor_sync(kFull, kmax, d);
            kmin = x < kmin ? x : kmin;
            kmax = y > kmax ? y : kmax;
          }
        }
        const bool onward = hint >= 0 && kmin >= prev_max;
        bool windowed = onward && w.covers(kmax);
        int64_t s = rb0;
        if (!windowed && onward) {  // no search: the window at hint
          s = hint;
          w = stage_window(r_sorted, win, s, rb1, kmax, false, lane);
          windowed = w.covers(kmax);
        }
        if (!windowed) {  // (else keys between prev_max and kmin filled it)
          s = warp_bound(global_key, s, rb1, kmin, false, lane);
          w = stage_window(r_sorted, win, s, rb1, kmax, true, lane);
          windowed = w.covers(kmax);
        }
        if (windowed) {
          // both bounds by binary lifting over the padded window: the
          // count of keys below (lower) or not above (upper) the row's
          // key, kWindow / 2, kWindow / 4, ... 1 at a time; a last probe
          // takes the count to kWindow; padding counts only for INT64_MAX
          // keys, so the upper bound stops at the window's length
          int a[kRows], e[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) a[r] = e[r] = 0;
#pragma unroll
          for (int step = kWindow / 2; step; step >>= 1) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              a[r] += win[skew(a[r] + step - 1)] < key[r] ? step : 0;
              e[r] += win[skew(e[r] + step - 1)] <= key[r] ? step : 0;
            }
          }
          int64_t at_max = -1;  // the lower bound of kmax, from its first row
#pragma unroll
          for (int r = kRows - 1; r >= 0; --r) {
            a[r] += win[skew(a[r])] < key[r];
            e[r] += win[skew(e[r])] <= key[r];
            if (in[r]) {
              lo[r] = w.s + a[r];
              cnt[r] = (e[r] < w.len ? e[r] : w.len) - a[r];
            }
            const unsigned m = __ballot_sync(kFull, in[r] && key[r] == kmax);
            if (m) at_max = __shfl_sync(kFull, w.s + a[r], __ffs(m) - 1);
          }
          hint = at_max;
          prev_max = kmax;
        } else {
          hint = -1;
          // each row on its own in global memory, from s: the rows' lower
          // bounds in lockstep (their probes independent loads), base and
          // len halving as one interval holds the bound
          int64_t base[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) base[r] = s;
          int64_t len = rb1 - s;
          for (; len > 1; len -= len >> 1) {
            const int64_t half = len >> 1;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              base[r] += ld(r_sorted + base[r] + half - 1) < key[r] ? half : 0;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (len == 1) base[r] += ld(r_sorted + base[r]) < key[r];
            if (in[r]) {
              lo[r] = base[r];
              cnt[r] = gallop_upper(global_key, base[r], rb1, key[r]) - base[r];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t i = i0 + 32 * r + lane, gr = u * kRows + r;
        if (i < n) {
          lo_out[i] = (Idx)lo[r];
          cnt_out[i] = (Idx)cnt[r];
        }
        if (gr < groups) {
          if (lane == 0) group_first[gr] = range_total;
          range_total += warp_sum<Idx>(cnt[r]);
        }
        key[r] = next_key[r];
      }
    }
    if (lane == 0) range_tot[rg + 1] = range_total;
  }
}

// In-place inclusive scan of v[0, len) by one block: each thread sums a
// contiguous chunk, the block scans the chunk sums (shuffles, then one
// value per warp through shared memory), and each thread rewrites its
// chunk from its prefix. Sized for the range totals (one per warp of a
// resident wave of the count pass, about 2,600 on an H100): a few values
// per thread.
__global__ void __launch_bounds__(1024) scan_kernel(int64_t* __restrict__ v, int64_t len) {
  // launched as a programmatic dependent of the count pass: it may be
  // resident before that pass ends, and waits here for its results
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ int64_t warp_tot[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t chunk = (len + 1023) / 1024;
  const int64_t a = t * chunk < len ? t * chunk : len;
  const int64_t e = a + chunk < len ? a + chunk : len;
  int64_t sum = 0;
#pragma unroll 8
  for (int64_t j = a; j < e; ++j) sum += v[j];
  int64_t incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t x = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = warp_tot[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t x = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += x;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  int64_t run = incl - sum + (warp ? warp_tot[warp - 1] : 0);
  for (int64_t j = a; j < e; ++j) {
    run += v[j];
    v[j] = run;
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const Idx* __restrict__ lo, const Idx* __restrict__ cnt,
            const int64_t* __restrict__ group_first,
            const int64_t* __restrict__ range_offs, int64_t n, int64_t range_groups,
            const int64_t* __restrict__ l_row,
            const int64_t* __restrict__ r_row, int64_t* __restrict__ li,
            int64_t* __restrict__ ri) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = (n + 31) >> 5;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); g < groups;
       g += (int64_t)gridDim.x * kWarps) {
    const int64_t i = (g << 5) + lane;
    const bool valid = i < n;
    const int64_t c = valid ? (int64_t)ld(cnt + i) : 0;
    const int64_t lo_i = valid ? (int64_t)ld(lo + i) : 0;
    const int64_t lv = valid && l_row ? ld(l_row + i) : i;
    // the group's first output: its range's, plus its own within the range
    const int64_t rg = groups <= UINT32_MAX ? (uint32_t)g / (uint32_t)range_groups
                                            : g / range_groups;
    const int64_t first = ld(range_offs + rg) + ld(group_first + g);
    int64_t incl = c;  // inclusive scan of the lanes' counts
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    const int64_t size = __shfl_sync(kFull, incl, 31);  // the group's pairs
    // output first + q belongs to the first lane whose end (incl) exceeds
    // q; lanes past n own nothing, so their end never precedes an output
    const int64_t end = valid ? incl : INT64_MAX;
    const int end32 = valid ? (int)incl : INT32_MAX;  // when size < 2^31
    const int64_t delta = lo_i - (incl - c);  // output q of this lane reads lo + q - start
    // each store instruction covers one aligned 256-byte block of li / ri
    for (int64_t q0 = -(first & 31); q0 < size; q0 += 32) {
      const int64_t q = q0 + lane;
      int a = 0, e = 31;  // the first lane whose end exceeds q
      if (size <= INT32_MAX) {
        for (int step = 0; step < 5; ++step) {
          const int mid = (a + e) >> 1;
          if (__shfl_sync(kFull, end32, mid) > (int)q)
            e = mid;
          else
            a = mid + 1;
        }
      } else {
        for (int step = 0; step < 5; ++step) {
          const int mid = (a + e) >> 1;
          if (__shfl_sync(kFull, end, mid) > q)
            e = mid;
          else
            a = mid + 1;
        }
      }
      const int64_t o_delta = __shfl_sync(kFull, delta, a);
      const int64_t o_lv = __shfl_sync(kFull, lv, a);
      if (q >= 0 && q < size) {
        const int64_t r = o_delta + q;
        li[first + q] = o_lv;
        ri[first + q] = r_row ? ld(r_row + r) : r;
      }
    }
  }
}

// Groups of 32 positions per range, a multiple of kRows: the count
// pass's units split evenly over the warps of one resident wave of
// count_kernel on the current device (cached per device), so every range
// runs at once and a warp walks consecutive units.
template <typename Idx>
cudaError_t range_groups_for(int64_t n, int64_t* out) {
  static std::atomic<int> wave[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = dev < kMaxDevices ? wave[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_kernel<Idx>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) wave[dev].store(blocks, std::memory_order_relaxed);
  }
  const int64_t warps = (int64_t)blocks * kWarps;
  const int64_t units = (n + 32 * kRows - 1) / (32 * kRows);
  *out = kRows * (units > warps ? (units + warps - 1) / warps : 1);
  return cudaSuccess;
}

template <typename Idx>
void launch_count(const void* l_keys, int64_t n, const void* l_offs,
                  const void* r_offs, int64_t num_segments, const void* r_sorted,
                  int64_t range_groups, void* lo, void* cnt, void* group_first,
                  void* range_tot, cudaStream_t stream) {
  const int64_t ranges = ((n + 31) / 32 + range_groups - 1) / range_groups;
  count_kernel<Idx><<<blocks_for(ranges), kThreads, 0, stream>>>(
      static_cast<const int64_t*>(l_keys), n, static_cast<const int64_t*>(l_offs),
      static_cast<const int64_t*>(r_offs), num_segments,
      static_cast<const int64_t*>(r_sorted), range_groups, static_cast<Idx*>(lo),
      static_cast<Idx*>(cnt), static_cast<int64_t*>(group_first),
      static_cast<int64_t*>(range_tot));
}

template <typename Idx>
void launch_emit(const void* lo, const void* cnt, const void* group_first,
                 const void* range_offs, int64_t n, int64_t range_groups,
                 const void* l_row, const void* r_row, void* li, void* ri,
                 cudaStream_t stream) {
  emit_kernel<Idx><<<blocks_for((n + 31) / 32), kThreads, 0, stream>>>(
      static_cast<const Idx*>(lo), static_cast<const Idx*>(cnt),
      static_cast<const int64_t*>(group_first), static_cast<const int64_t*>(range_offs),
      n, range_groups, static_cast<const int64_t*>(l_row),
      static_cast<const int64_t*>(r_row), static_cast<int64_t*>(li),
      static_cast<int64_t*>(ri));
}

}  // namespace

// Range size of one B4 call: *range_groups groups of 32 left positions
// per range, for n left positions and lo / cnt of index_bytes (4: int32,
// 8: int64); the count and emit passes take it, and range_tot has
// ceil(ceil(n / 32) / *range_groups) + 1 entries. Returns a CUDA error
// code.
extern "C" int hs_bucket_match_ranges(int64_t n, int index_bytes, int64_t* range_groups) {
  if (n < 0 || (index_bytes != 4 && index_bytes != 8)) return (int)cudaErrorInvalidValue;
  return (int)(index_bytes == 4 ? range_groups_for<int32_t>(n, range_groups)
                                : range_groups_for<int64_t>(n, range_groups));
}

// Count pass. l_keys [n], r_sorted [m], l_offs / r_offs [num_segments + 1]
// (0 first, n / m last, non-decreasing; the wrapper checks them on the
// host), all int64 on the device; range_groups from
// hs_bucket_match_ranges (a multiple of kRows); outputs lo / cnt [n] of index_bytes (4: int32,
// only for m < 2^31; 8: int64), group_first [ceil(n / 32)] int64 (each
// group's first output within its range) and range_tot [ranges + 1]
// int64 (0, then each range's pair total). Launches on `stream`; returns
// a CUDA error code (0 on success). n = 0 launches nothing.
extern "C" int hs_bucket_match_count(const void* l_keys, int64_t n,
                                     const void* l_offs, const void* r_offs,
                                     int64_t num_segments, const void* r_sorted,
                                     int64_t range_groups, void* lo, void* cnt,
                                     void* group_first, void* range_tot,
                                     int index_bytes, void* stream) {
  if (n < 0 || num_segments < 1 || range_groups < 1 || range_groups % kRows ||
      (index_bytes != 4 && index_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const auto s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4)
    launch_count<int32_t>(l_keys, n, l_offs, r_offs, num_segments, r_sorted, range_groups,
                          lo, cnt, group_first, range_tot, s);
  else
    launch_count<int64_t>(l_keys, n, l_offs, r_offs, num_segments, r_sorted, range_groups,
                          lo, cnt, group_first, range_tot, s);
  return (int)cudaGetLastError();
}

// Scan of the count pass's range totals: v [len] int64 on the device
// becomes its inclusive cumsum, in place (v[0] = 0, so v[r] is range r's
// first output and v[len - 1] the number of pairs). Returns a CUDA error
// code.
extern "C" int hs_bucket_match_scan(void* v, int64_t len, void* stream) {
  if (len < 0) return (int)cudaErrorInvalidValue;
  if (len == 0) return (int)cudaGetLastError();
  // overlaps its launch with the end of the count pass before it in the
  // stream (programmatic dependent launch)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(1024);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, scan_kernel, static_cast<int64_t*>(v), len);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Emit pass. lo / cnt [n] of index_bytes and group_first from the count
// pass; range_offs its range_tot after the scan; the same range_groups;
// l_row [n] and r_row [m] int64 or null (identity); li / ri
// [range_offs[last]] int64 outputs. Returns a CUDA error code.
extern "C" int hs_bucket_match_emit(const void* lo, const void* cnt,
                                    const void* group_first, const void* range_offs,
                                    int64_t n, int64_t range_groups, const void* l_row,
                                    const void* r_row, void* li, void* ri,
                                    int index_bytes, void* stream) {
  if (n < 0 || range_groups < 1 || (index_bytes != 4 && index_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const auto s = static_cast<cudaStream_t>(stream);
  if (index_bytes == 4)
    launch_emit<int32_t>(lo, cnt, group_first, range_offs, n, range_groups, l_row, r_row,
                         li, ri, s);
  else
    launch_emit<int64_t>(lo, cnt, group_first, range_offs, n, range_groups, l_row, r_row,
                         li, ri, s);
  return (int)cudaGetLastError();
}
