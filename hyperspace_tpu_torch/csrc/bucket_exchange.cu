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
//   B8a (hs_exchange_pack_count, then hs_exchange_pack_move) one shard's
//       rows: the stable rank of each valid row within its destination
//       d = bucket % D, its slot d * cap + rank, every column moved into
//       [D, cap] and each destination's tail [count, cap) zeroed; invalid
//       rows (the sentinel digit D) are dropped; a count past cap sets bit
//       1 of the error word.
//   B8b (hs_exchange_order_count, then hs_exchange_order_move) one
//       shard's received slots: the stable order by bucket with invalid
//       slots last (digits 0..num_buckets, the last the sentinel), every
//       column moved to its ordered position, and the count of valid rows.
//
// Both are one stable counting sort over tiles of kTileRows rows, in three
// launches a pass (one fixed design):
//   tile_hist  a block a tile reads the tile's bucket ids and validity,
//              16 rows a thread (four 16-byte loads of the ids and one of
//              the validity where the addresses allow), and counts its
//              digits in shared memory, a shared-memory atomic add a row
//              (nothing waits on it), one a warp where the warp's 32 rows
//              share a digit (a tile of padding). Writes hist[digit][tile],
//              digit-major.
//   tile_scan  a block a digit, launched as a programmatic dependent of
//              tile_hist: the exclusive scan of the digit's contiguous tile
//              counts (a block-wide scan, 1,024 tiles a step) in place,
//              and the digit's total; B8a's block sets the overflow bit
//              where a destination's total passes cap; B8b's first block
//              writes the count of valid rows. Every error bit is set by
//              here, so the caller copies the error word back while
//              rank_move runs (the C entries come in pairs: _count runs
//              these two launches, _move the third).
//   rank_move  a block a tile reads the digits again as tile_hist does and
//              passes them through shared memory, so that each warp walks
//              its contiguous stretch of kWarpRows rows in row order, its
//              lanes holding each row's stable rank from warp-private
//              16-bit counters in shared memory (the lanes of one digit
//              found by one ballot a digit bit, CUB's MatchAny; the group
//              reads its counter once and its first lane adds the group's
//              size). A scan across the tile's warps a digit and a scan
//              over the digits give each row its place in the tile's digit
//              order (held in shared memory as 16 bits a row, never in
//              device memory). The global position is the digit's base
//              (B8a d * cap; B8b the digit's start, the scan of the
//              totals, which each block takes in shared memory) plus the
//              digit's scanned tile prefix plus the row's place in the
//              digit's run. Then, a column at a time in the same launch
//              (1, 2, 4 or 8 bytes as raw bits): the tile's values are read
//              with 16-byte loads where the column's address allows,
//              staged in shared memory in digit order, and each digit's
//              run leaves as contiguous stores (B8a: at most D + 1 runs a
//              tile; B8b: runs of about kTileRows / 200 rows, one run for
//              a tile of padding). B8a's blocks past the last tile zero
//              the tails [count_d, cap) of the [D, cap] outputs, so the
//              wrapper allocates them with torch.empty.
// More digits than kMaxDigits (B8b over more than 4,095 buckets) take two
// passes of the same three launches: the low kDigitBits bits of the key
// (bucket, or num_buckets for an invalid slot) first, moving the columns
// and the key into scratch, then the high bits over the moved keys. Both
// passes are stable, so the two make the same order (an LSD radix of two
// digits). The route is chosen by the digit count alone.
// A digit outside its range (a bucket id out of range) sets bit 2 of the
// error word and never indexes shared memory (it is taken as the
// sentinel); the wrapper reads the word once a call and raises.
//
// Bound: the function must read the bucket ids (4 B), the valid mask
// (1 B) and every column once, and write every column once: B8a's whole
// [D, cap] outputs, B8b's n rows. At phase 18 of chip_smoke.py that is
// 232,783,904 B (B8a: 2,097,152 rows, 6 columns, D = 4, cap 1,048,576) and
// 306,184,200 B (B8b: 4,194,304 slots, 5 columns), 0.0695 and 0.0914 ms at
// the 3.35 TB/s of an H100 SXM; a few integer operations a row. So HBM
// bytes bound it. This design moves those bytes plus the digits' second
// read (5 B a row) and a hist of 4 B a digit a tile; it moves no position
// a row through device memory and writes no byte of B8a's outputs twice.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int kTileRows = 4096;             // rows a tile, a block of each pass
constexpr int kThreads = 256;               // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kTileRows / kWarps;  // a warp's stretch of a tile
constexpr int kSteps = kWarpRows / 32;      // rows a lane holds
static_assert(kSteps * kThreads == kTileRows && kSteps % 8 == 0, "a thread loads kSteps rows");
constexpr int kDigitBits = 12;
constexpr int kMaxDigits = 1 << kDigitBits;  // digits one pass takes (shared memory)
constexpr int kMaxCols = 16;                // columns one rank_move launch moves
constexpr int kScanItems = 4;               // tile counts a thread a tile_scan step
constexpr int kErrOverflow = 1;
constexpr int kErrDigit = 2;

// What a pass sorts by: B8a's destination, B8b's key in one pass, or the
// key's low and then high kDigitBits bits in two.
enum Mode { kPack = 0, kOrder = 1, kLow = 2, kHigh = 3 };

struct Keys {
  const int32_t* bucket;  // kHigh: the keys the low pass moved
  const uint8_t* valid;   // nullptr for kHigh
  int arg;                // kPack: D; the others: num_buckets
};

struct Cols {
  int n;
  int size[kMaxCols];
  const void* src[kMaxCols];  // nullptr: the key itself (kLow)
  void* dst[kMaxCols];
};

// A row's key from its bucket id b and validity v: kPack its destination
// (D if invalid), kOrder and kLow its bucket (num_buckets if invalid),
// kHigh the key the low pass moved (b). An id out of range sets `bad` and
// takes the sentinel.
template <int M>
__device__ __forceinline__ int key_from(const Keys& k, int b, bool v, bool& bad) {
  if (M == kHigh) return b;
  if (!v) return k.arg;
  if (M == kPack) {
    if (b < 0) {
      bad = true;
      return k.arg;
    }
    return b % k.arg;
  }
  if (b < 0 || b >= k.arg) {
    bad = true;
    return k.arg;
  }
  return b;
}

template <int M>
__device__ __forceinline__ int digit_of(int key) {
  return M == kLow ? (key & (kMaxDigits - 1)) : M == kHigh ? (key >> kDigitBits) : key;
}

// The lanes whose label equals this lane's, among `active`: one ballot a
// label bit.
__device__ __forceinline__ unsigned peers_of(int label, int bits, unsigned active) {
  unsigned m = active;
  for (int b = 0; b < bits; ++b) {
    const bool set = (label >> b) & 1;
    const unsigned v = __ballot_sync(0xffffffffu, set);
    m &= set ? v : ~v;
  }
  return m;
}

// Element v of the 16 bytes x, as a T (v is a constant once unrolled).
template <typename T>
__device__ __forceinline__ T element(const uint4& x, int v) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  if constexpr (sizeof(T) == 8) return (T)((uint64_t)w[2 * v] | ((uint64_t)w[2 * v + 1] << 32));
  else if constexpr (sizeof(T) == 4) return (T)w[v];
  else if constexpr (sizeof(T) == 2) return (T)(w[v >> 1] >> (16 * (v & 1)));
  else return (T)(w[v >> 2] >> (8 * (v & 3)));
}

// The digits of the tile's rows [kSteps t, kSteps (t + 1)), thread t, -1
// past the tile's end: four 16-byte loads of the ids and one of the
// validity a thread where the tile's addresses allow (a warp reads 2 KB
// and 512 B in whole lines). Counts the rows whose key is the sentinel
// num_buckets (kOrder, kLow).
template <int M>
__device__ __forceinline__ void load_digits(const Keys& k, int64_t base, int rows,
                                            int (&d)[kSteps], bool& bad, int& sentinels) {
  const int r0 = threadIdx.x * kSteps;
  const auto digit = [&](int b, bool v) {
    const int key = key_from<M>(k, b, v, bad);
    if ((M == kOrder || M == kLow) && key == k.arg) ++sentinels;
    return digit_of<M>(key);
  };
  if (rows == kTileRows && (reinterpret_cast<uintptr_t>(k.bucket + base) & 15) == 0 &&
      (M == kHigh || (reinterpret_cast<uintptr_t>(k.valid + base) & 15) == 0)) {
    const uint4* b4 = reinterpret_cast<const uint4*>(k.bucket + base + r0);
    uint4 x[kSteps / 4], y = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
    for (int q = 0; q < kSteps / 4; ++q) x[q] = __ldg(b4 + q);
    if (M != kHigh) y = __ldg(reinterpret_cast<const uint4*>(k.valid + base + r0));
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      d[i] = digit((int)element<uint32_t>(x[i >> 2], i & 3), element<uint8_t>(y, i) != 0);
  } else {
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      d[i] = r0 + i < rows ? digit(__ldg(k.bucket + base + r0 + i),
                                   M == kHigh || __ldg(k.valid + base + r0 + i) != 0)
                           : -1;
  }
}

// Stable ranks within the warp's stretch, in row order: ranks[r] of the
// stretch's row r (the lane's row at step j) counts the stretch's earlier
// rows of d[j]'s digit. cnt, this warp's counters (zeroed), ends holding
// the stretch's count a digit. The group of lanes of one digit reads its
// counter once and its first lane adds the group's size.
__device__ __forceinline__ void rank_digits(const int (&d)[kSteps], int bits, uint16_t* cnt,
                                            uint16_t* ranks) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const unsigned active = __ballot_sync(0xffffffffu, d[j] >= 0);
    const unsigned peers = peers_of(d[j], bits, active);
    const int c = d[j] >= 0 ? cnt[d[j]] : 0;
    __syncwarp();
    const int before = __popc(peers & below);
    if (d[j] >= 0) {
      ranks[j * 32 + lane] = (uint16_t)(c + before);
      if (before == 0) cnt[d[j]] = (uint16_t)(c + __popc(peers));
    }
    __syncwarp();
  }
}

// Exclusive sum over the block of one value a thread, in thread order;
// `total` is the block's sum. Every thread calls it.
template <typename T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* sums, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kWarps ? sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  total = sums[kWarps - 1];
  const T out = x - v + (warp > 0 ? sums[warp - 1] : T(0));
  __syncthreads();
  return out;
}

template <int M>
__global__ void __launch_bounds__(kThreads) tile_hist(Keys k, int64_t n, int64_t tiles,
                                                      int digits, int32_t* __restrict__ hist,
                                                      unsigned long long* __restrict__ err) {
  // tile_scan, launched as a programmatic dependent, may be resident
  // before this pass ends; it waits for it
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ int32_t counts[];  // [digits]
  __shared__ int32_t block_sentinels;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < digits; i += kThreads) counts[i] = 0;
  if (threadIdx.x == 0) block_sentinels = 0;
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTileRows;
  const int rows = (int)(n - base < kTileRows ? n - base : kTileRows);
  int d[kSteps];
  bool bad = false;
  int sentinels = 0;
  load_digits<M>(k, base, rows, d, bad, sentinels);
  // a lane adds its row to its digit's count; a warp whose rows share one
  // digit (a tile of padding) adds once
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int first = __shfl_sync(0xffffffffu, d[j], 0);
    if (__all_sync(0xffffffffu, d[j] == first)) {
      if (lane == 0 && first >= 0) atomicAdd(&counts[first], 32);
    } else if (d[j] >= 0) {
      atomicAdd(&counts[d[j]], 1);
    }
  }
  if (__any_sync(0xffffffffu, bad) && lane == 0) atomicOr(err, (unsigned long long)kErrDigit);
  if (M == kOrder || M == kLow) {
    const int sum = __reduce_add_sync(0xffffffffu, sentinels);
    if (lane == 0 && sum > 0) atomicAdd(&block_sentinels, sum);
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < digits; dd += kThreads)
    hist[(int64_t)dd * tiles + tile] = counts[dd];
  if ((M == kOrder || M == kLow) && threadIdx.x == 0 && block_sentinels > 0)
    atomicAdd(err + 1, (unsigned long long)block_sentinels);
}

// checked: B8a's D (a destination's total past cap sets the overflow
// bit), 0 for the others. count: B8b's count of valid rows (n less the
// sentinel rows tile_hist counted), or nullptr.
__global__ void __launch_bounds__(kThreads) tile_scan(int32_t* __restrict__ hist, int64_t tiles,
                                                      int64_t* __restrict__ totals, int checked,
                                                      int64_t cap, int64_t n,
                                                      unsigned long long* __restrict__ err,
                                                      int64_t* __restrict__ count) {
  // a programmatic dependent of tile_hist: its counts are complete past
  // this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ int32_t sums[kWarps];
  int32_t* h = hist + (int64_t)blockIdx.x * tiles;
  int32_t carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads * kScanItems) {
    const int64_t t = t0 + (int64_t)threadIdx.x * kScanItems;
    int32_t v[kScanItems];
    int32_t s = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = t + i < tiles ? h[t + i] : 0;
      s += v[i];
    }
    int32_t total;
    int32_t run = block_exclusive_sum(s, sums, total) + carry;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (t + i < tiles) h[t + i] = run;
      run += v[i];
    }
    carry += total;
  }
  if (threadIdx.x == 0) {
    totals[blockIdx.x] = carry;
    if ((int)blockIdx.x < checked && carry > cap) atomicOr(err, (unsigned long long)kErrOverflow);
    if (count != nullptr && blockIdx.x == 0) count[0] = n - (int64_t)err[1];
  }
}

// One column of one tile: staged in shared memory in digit order, then
// each digit's run stored contiguously.
template <typename T, int M>
__device__ __forceinline__ void move_column(const Keys& k, const T* __restrict__ src,
                                            T* __restrict__ dst, int64_t base, int rows,
                                            const uint16_t* lpos, const uint16_t* dsort,
                                            const int64_t* obase, const int32_t* rbase,
                                            unsigned char* stage_bytes, int64_t cap) {
  T* stage = reinterpret_cast<T*>(stage_bytes);
  if (M == kLow && src == nullptr) {  // the key, for the high pass
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      bool bad = false;
      stage[lpos[r]] = (T)key_from<M>(k, __ldg(k.bucket + base + r),
                                      __ldg(k.valid + base + r) != 0, bad);
    }
  } else if (rows == kTileRows && (reinterpret_cast<uintptr_t>(src + base) & 15) == 0) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kVecs = kTileRows / V / kThreads;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + base);
    uint4 x[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) x[i] = __ldg(s4 + threadIdx.x + i * kThreads);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int r0 = (threadIdx.x + i * kThreads) * V;
#pragma unroll
      for (int v = 0; v < V; ++v) stage[lpos[r0 + v]] = element<T>(x[i], v);
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += kThreads) stage[lpos[r]] = src[base + r];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rows; q += kThreads) {
    const int dg = dsort[q];
    const int64_t rank = (int64_t)rbase[dg] + q;
    if (M == kPack && (dg == k.arg || rank >= cap)) continue;  // invalid, or past cap
    dst[obase[dg] + rank] = stage[q];
  }
  __syncthreads();
}

// B8a's tails: zero len bytes from p, 16 bytes a store between the edges.
__device__ __forceinline__ void zero_bytes(unsigned char* p, int64_t len) {
  int64_t head = (int64_t)((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15);
  if (head > len) head = len;
  const int64_t body = (len - head) / 16;
  for (int64_t i = threadIdx.x; i < head; i += kThreads) p[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = threadIdx.x; i < body; i += kThreads) q[i] = make_uint4(0, 0, 0, 0);
  for (int64_t i = head + body * 16 + threadIdx.x; i < len; i += kThreads) p[i] = 0;
}

template <int M>
__global__ void __launch_bounds__(kThreads, 4) rank_move(Keys k, int64_t n, int64_t tiles,
                                                      int digits, int bits,
                                                      const int32_t* __restrict__ hist,
                                                      const int64_t* __restrict__ totals,
                                                      int64_t cap, Cols cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t sums32[kWarps];
  __shared__ int64_t sums64[kWarps];
  if ((int64_t)blockIdx.x >= tiles) {  // B8a: the zero tails of slots [lo, hi)
    if (M != kPack) return;
    const int64_t slots = (int64_t)k.arg * cap;
    const int64_t lo = ((int64_t)blockIdx.x - tiles) * kTileRows;
    const int64_t hi = lo + kTileRows < slots ? lo + kTileRows : slots;
    for (int c = 0; c < cols.n; ++c) {
      unsigned char* dst = static_cast<unsigned char*>(cols.dst[c]);
      const int size = cols.size[c];
      for (int64_t dd = lo / cap; dd < k.arg && dd * cap < hi; ++dd) {
        const int64_t used = totals[dd] < cap ? totals[dd] : cap;
        const int64_t a = lo > dd * cap + used ? lo : dd * cap + used;
        const int64_t b = hi < (dd + 1) * cap ? hi : (dd + 1) * cap;
        if (a < b) zero_bytes(dst + a * size, (b - a) * size);
      }
    }
    return;
  }
  unsigned char* stage = smem;                                        // [kTileRows] x 8 B
  uint16_t* lpos = reinterpret_cast<uint16_t*>(smem + kTileRows * 8);  // a row's place
  uint16_t* dsort = lpos + kTileRows;                                 // a place's digit
  int64_t* obase = reinterpret_cast<int64_t*>(dsort + kTileRows);     // [digits]
  int32_t* rbase = reinterpret_cast<int32_t*>(obase + digits);        // [digits]
  int32_t* tstart = rbase + digits;                                   // [digits]
  uint16_t* counters = reinterpret_cast<uint16_t*>(tstart + digits);  // [kWarps][digits]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * digits; i += kThreads) counters[i] = 0;
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTileRows;
  const int rows = (int)(n - base < kTileRows ? n - base : kTileRows);
  int d[kSteps];
  bool bad = false;
  int sentinels = 0;
  load_digits<M>(k, base, rows, d, bad, sentinels);
  // each warp ranks its stretch in row order: the digits go through
  // shared memory (lpos, 16 bits a row, 0xffff past the tile's end)
  {
    uint4* out = reinterpret_cast<uint4*>(lpos + threadIdx.x * kSteps);
#pragma unroll
    for (int q = 0; q < kSteps / 8; ++q) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = (uint32_t)(d[8 * q + 2 * i] & 0xffff) | ((uint32_t)d[8 * q + 2 * i + 1] << 16);
      out[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int x = lpos[warp * kWarpRows + j * 32 + lane];
    d[j] = x == 0xffff ? -1 : x;
  }
  // the ranks replace the digits in lpos, row for row
  rank_digits(d, bits, counters + warp * digits, lpos + warp * kWarpRows);
  __syncthreads();
  // a digit's offset for each warp (the scan across the tile's warps) and
  // its count in the tile
  for (int dd = threadIdx.x; dd < digits; dd += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = counters[w * digits + dd];
      counters[w * digits + dd] = (uint16_t)run;
      run += c;
    }
    tstart[dd] = run;
  }
  __syncthreads();
  // the tile's run starts (the scan of its counts over the digits) and
  // each digit's output base: B8a d * cap, the others the digit's first
  // position (the scan of the totals)
  const int per = (digits + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per < digits ? threadIdx.x * per : digits;
  const int hi = lo + per < digits ? lo + per : digits;
  int32_t csum = 0;
  int64_t tsum = 0;
  for (int dd = lo; dd < hi; ++dd) {
    csum += tstart[dd];
    if (M != kPack) tsum += totals[dd];
  }
  int32_t ctotal;
  int64_t ttotal;
  int32_t crun = block_exclusive_sum(csum, sums32, ctotal);
  int64_t trun = M != kPack ? block_exclusive_sum(tsum, sums64, ttotal) : 0;
  for (int dd = lo; dd < hi; ++dd) {
    const int32_t c = tstart[dd];
    tstart[dd] = crun;
    rbase[dd] = hist[(int64_t)dd * tiles + tile] - crun;
    obase[dd] = M == kPack ? (int64_t)dd * cap : trun;
    crun += c;
    if (M != kPack) trun += totals[dd];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    if (d[j] >= 0) {
      const int r = warp * kWarpRows + j * 32 + lane;
      const int p = tstart[d[j]] + counters[warp * digits + d[j]] + lpos[r];
      lpos[r] = (uint16_t)p;
      dsort[p] = (uint16_t)d[j];
    }
  }
  __syncthreads();
  for (int c = 0; c < cols.n; ++c) {
    const void* src = cols.src[c];
    void* dst = cols.dst[c];
    switch (cols.size[c]) {
      case 1:
        move_column<uint8_t, M>(k, static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
                                base, rows, lpos, dsort, obase, rbase, stage, cap);
        break;
      case 2:
        move_column<uint16_t, M>(k, static_cast<const uint16_t*>(src),
                                 static_cast<uint16_t*>(dst), base, rows, lpos, dsort, obase,
                                 rbase, stage, cap);
        break;
      case 4:
        move_column<uint32_t, M>(k, static_cast<const uint32_t*>(src),
                                 static_cast<uint32_t*>(dst), base, rows, lpos, dsort, obase,
                                 rbase, stage, cap);
        break;
      default:
        move_column<uint64_t, M>(k, static_cast<const uint64_t*>(src),
                                 static_cast<uint64_t*>(dst), base, rows, lpos, dsort, obase,
                                 rbase, stage, cap);
        break;
    }
  }
}

size_t move_smem(int digits) {
  return (size_t)kTileRows * (8 + 2 * sizeof(uint16_t)) +
         (size_t)digits * (sizeof(int64_t) + 2 * sizeof(int32_t) + kWarps * sizeof(uint16_t));
}

// A pass's counts: tile_hist, then tile_scan as its programmatic
// dependent. Sets the error word's bits (and, with count, B8b's count).
template <int M>
int count_pass(Keys k, int64_t n, int digits, int checked, int64_t cap, int32_t* hist,
               int64_t* totals, unsigned long long* err, int64_t* count, cudaStream_t s) {
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  cudaError_t e;
  if (tiles > 0) {
    tile_hist<M><<<(unsigned)tiles, kThreads, (size_t)digits * sizeof(int32_t), s>>>(
        k, n, tiles, digits, hist, err);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(digits);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tile_scan, hist, tiles, totals, checked, cap, n, err, count);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// A pass's moves: rank_move, a launch a group of up to kMaxCols columns
// (B8a's grid adds the blocks of the zero tails). Reads the counts of
// the pass's count_pass.
template <int M>
int move_pass(Keys k, int64_t n, int digits, int64_t cap, const int32_t* hist,
              const int64_t* totals, int ncols, const void* const* srcs, void* const* dsts,
              const int* sizes, cudaStream_t s) {
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  const int bits = digits > 1 ? 32 - __builtin_clz((unsigned)(digits - 1)) : 0;
  const int64_t zeros = M == kPack ? ((int64_t)k.arg * cap + kTileRows - 1) / kTileRows : 0;
  if (ncols == 0 || tiles + zeros == 0) return (int)cudaSuccess;
  const size_t smem = move_smem(digits);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(rank_move<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Cols cols;
    cols.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < cols.n; ++c) {
      if (sizes[c0 + c] != 1 && sizes[c0 + c] != 2 && sizes[c0 + c] != 4 && sizes[c0 + c] != 8)
        return (int)cudaErrorInvalidValue;
      cols.size[c] = sizes[c0 + c];
      cols.src[c] = srcs[c0 + c];
      cols.dst[c] = dsts[c0 + c];
    }
    rank_move<M><<<(unsigned)(tiles + zeros), kThreads, smem, s>>>(k, n, tiles, digits, bits,
                                                                   hist, totals, cap, cols);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

bool pack_args_ok(int64_t n, int D, int64_t cap) {
  return n >= 0 && n < (int64_t(1) << 31) && D >= 1 && D + 1 <= kMaxDigits && cap >= 1;
}

bool order_args_ok(int64_t n, int num_buckets) {
  const int64_t digits = (int64_t)num_buckets + 1;
  return n >= 1 && n < (int64_t(1) << 31) && num_buckets >= 1 &&
         ((digits - 1) >> kDigitBits) < kMaxDigits;
}

Keys order_keys(const void* bucket, const void* valid, int num_buckets) {
  return Keys{static_cast<const int32_t*>(bucket), static_cast<const uint8_t*>(valid),
              num_buckets};
}

}  // namespace

// B8a, in two calls on one stream: hs_exchange_pack_count (tile_hist,
// tile_scan), then hs_exchange_pack_move (rank_move), between which the
// caller may copy the error word back. bucket [n] int32 and valid [n]
// bool on the device; 1 <= D < kMaxDigits shards; cap >= 1 slots a
// destination; hist [ceil(n / kTileRows) * (D + 1)] int32 and totals
// [D + 1] int64 (the count a destination, then the invalid rows) are
// scratch and outputs, the same in both calls; err [2] int64 zeroed by
// the caller (word 0: the error bits). srcs [ncols] device columns of n
// rows, dsts [ncols] [D, cap] buffers (any contents: every slot is
// written), sizes [ncols] their element sizes (1, 2, 4 or 8); srcs, dsts
// and sizes are host arrays. Each launches on `stream` and returns a CUDA
// error code.
extern "C" int hs_exchange_pack_count(const void* bucket, const void* valid, int64_t n, int D,
                                      int64_t cap, void* hist, void* totals, void* err,
                                      void* stream) {
  if (!pack_args_ok(n, D, cap)) return (int)cudaErrorInvalidValue;
  const Keys k{static_cast<const int32_t*>(bucket), static_cast<const uint8_t*>(valid), D};
  return count_pass<kPack>(k, n, D + 1, D, cap, static_cast<int32_t*>(hist),
                           static_cast<int64_t*>(totals), static_cast<unsigned long long*>(err),
                           nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int hs_exchange_pack_move(const void* bucket, const void* valid, int64_t n, int D,
                                     int64_t cap, const void* hist, const void* totals,
                                     int ncols, void* const* srcs, void* const* dsts,
                                     const int* sizes, void* stream) {
  if (!pack_args_ok(n, D, cap) || ncols < 0) return (int)cudaErrorInvalidValue;
  const Keys k{static_cast<const int32_t*>(bucket), static_cast<const uint8_t*>(valid), D};
  return move_pass<kPack>(k, n, D + 1, cap, static_cast<const int32_t*>(hist),
                          static_cast<const int64_t*>(totals), ncols, srcs, dsts, sizes,
                          static_cast<cudaStream_t>(stream));
}

// B8b, in two calls on one stream like B8a's. bucket [n] int32 and valid
// [n] bool: a shard's received slots, n >= 1; num_buckets >= 1
// (num_buckets + 1 digits, at most kMaxDigits^2); hist
// [ceil(n / kTileRows) * min(num_buckets + 1, kMaxDigits)] int32, totals
// [min(num_buckets + 1, kMaxDigits)] int64, err [2] int64 zeroed, the same
// in both calls; count [1] int64, the count of valid rows, written by
// hs_exchange_order_count. srcs [ncols] columns of n rows, dsts [ncols]
// outputs of n rows. With more than kMaxDigits digits the count call runs
// the low pass's counts, and the move call its moves (the columns into
// tmps [ncols], columns like dsts, and the keys into keys [n] int32), then
// the high pass over the moved keys; keys and tmps are nullptr otherwise.
extern "C" int hs_exchange_order_count(const void* bucket, const void* valid, int64_t n,
                                       int num_buckets, void* hist, void* totals, void* err,
                                       void* count, void* stream) {
  if (!order_args_ok(n, num_buckets)) return (int)cudaErrorInvalidValue;
  const Keys k = order_keys(bucket, valid, num_buckets);
  const int64_t digits = (int64_t)num_buckets + 1;
  int32_t* h = static_cast<int32_t*>(hist);
  int64_t* t = static_cast<int64_t*>(totals);
  unsigned long long* e = static_cast<unsigned long long*>(err);
  int64_t* c = static_cast<int64_t*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (digits <= kMaxDigits) return count_pass<kOrder>(k, n, (int)digits, 0, 0, h, t, e, c, s);
  return count_pass<kLow>(k, n, kMaxDigits, 0, 0, h, t, e, c, s);
}

extern "C" int hs_exchange_order_move(const void* bucket, const void* valid, int64_t n,
                                      int num_buckets, void* hist, void* totals, void* err,
                                      void* keys, void* const* tmps, int ncols,
                                      void* const* srcs, void* const* dsts, const int* sizes,
                                      void* stream) {
  if (!order_args_ok(n, num_buckets) || ncols < 0) return (int)cudaErrorInvalidValue;
  const Keys k = order_keys(bucket, valid, num_buckets);
  const int64_t digits = (int64_t)num_buckets + 1;
  int32_t* h = static_cast<int32_t*>(hist);
  int64_t* t = static_cast<int64_t*>(totals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (digits <= kMaxDigits)
    return move_pass<kOrder>(k, n, (int)digits, 0, h, t, ncols, srcs, dsts, sizes, s);
  if (keys == nullptr || (ncols > 0 && tmps == nullptr)) return (int)cudaErrorInvalidValue;
  // the low pass moves the columns into tmps and the keys into keys
  std::vector<const void*> srcs1(srcs, srcs + ncols);
  std::vector<void*> dsts1(tmps, tmps + ncols);
  std::vector<int> sizes1(sizes, sizes + ncols);
  srcs1.push_back(nullptr);
  dsts1.push_back(keys);
  sizes1.push_back(4);
  int r = move_pass<kLow>(k, n, kMaxDigits, 0, h, t, ncols + 1, srcs1.data(), dsts1.data(),
                          sizes1.data(), s);
  if (r != 0) return r;
  const Keys k2{static_cast<const int32_t*>(keys), nullptr, num_buckets};
  const int high = (int)(((digits - 1) >> kDigitBits) + 1);
  r = count_pass<kHigh>(k2, n, high, 0, 0, h, t, static_cast<unsigned long long*>(err), nullptr,
                        s);
  if (r != 0) return r;
  std::vector<const void*> srcs2(tmps, tmps + ncols);
  return move_pass<kHigh>(k2, n, high, 0, h, t, ncols, srcs2.data(), dsts, sizes, s);
}
